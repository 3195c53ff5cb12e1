"""Lane-count sweep of the terrain kernels K2 and K3 on the card.

Builds csrc/control_step_terrain.cu with ``-DLHW_G=`` 8, 16 and 32 (under
library names of their own, all at once) and times the K2 (jvrc_step) and
K3 (jvrc_walk_rough) step launch at B=32768 for each lane count and each
``BLOCKS_PER_SM`` of 1-4 that ``launch_plan`` sizes blocks for. It chose
the source's default LHW_G and ``substep_kernel.BLOCKS_PER_SM``; the
correctness of the chosen build is chip_smoke.py's to check, not this
script's. Run from the repository root on a machine with a CUDA device:

    python3 -m learninghumanoidwalking_tpu_torch.ops.lane_sweep

Prints the card's name and power limit, ptxas's registers and spills per
build, one JSON line per (G, blocks an SM, kernel) and the table as a last
JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

LANES = (8, 16, 32)
BLOCKS = (1, 2, 3, 4)
BATCH = 32768


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lane_sweep: no CUDA device", file=sys.stderr)
        return 2

    from learninghumanoidwalking_tpu_torch.envs.registry import make_env
    from learninghumanoidwalking_tpu_torch.ops import build
    from learninghumanoidwalking_tpu_torch.ops import substep_kernel as sk
    from learninghumanoidwalking_tpu_torch.utils.seeding import Draws

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    builds = {g: (f"lhw_control_step_terrain_g{g}", ("control_step_terrain.cu",), (f"-DLHW_G={g}",)) for g in LANES}
    with ThreadPoolExecutor(len(builds)) as pool:
        paths = dict(zip(builds, pool.map(lambda args: build.build_library(*args)[0], builds.values())))
    for g, path in paths.items():
        print(f"G={g} ptxas: " + " | ".join(build.ptxas_report(path)), flush=True)

    def time_ms(fn, reps: int = 3) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    cases = {}
    for name, env_name in (("K2", "jvrc_step"), ("K3", "jvrc_walk_rough")):
        env = make_env(env_name, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(BATCH)
        states = env.reset_batch(BATCH, Draws(gen))
        target = env.neutral_pose + 0.05 * torch.randn((BATCH, env.model.nu), generator=gen, device=dev)
        cases[name] = (env.model, states.dyn, states.physics, target, env.frame_skip, env.sim_dt, env._terrain(states.task))

    rows = []
    default_library, default_blocks = sk.LIBRARIES["terrain"], sk.BLOCKS_PER_SM
    try:
        for g in LANES:
            sk._LIBS.pop("terrain", None)
            sk.LIBRARIES["terrain"] = builds[g]
            for blocks in BLOCKS:
                sk.BLOCKS_PER_SM = blocks
                for name, args in cases.items():
                    hfield = args[6].hfield
                    plan = sk.launch_plan(args[0], BATCH, sk._library("terrain")[1], None if hfield is None else tuple(hfield.shape[1:]))
                    rows.append(dict(G=g, blocks_per_sm=blocks, kernel=name, B=BATCH, ms=time_ms(lambda: sk.pd_substeps_kernel(*args)), plan=plan))
                    print(json.dumps(rows[-1]), flush=True)
    finally:
        sk._LIBS.pop("terrain", None)
        sk.LIBRARIES["terrain"], sk.BLOCKS_PER_SM = default_library, default_blocks
    print(json.dumps({"sweep": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
