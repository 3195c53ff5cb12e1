"""Lane-count sweep of the control-step kernels K1-K4 on the card.

Builds each library of csrc/control_step_lanes.cu ("flat" for K1,
"terrain" for K2 and K3, "motor" for K4) with ``-DLHW_G=`` 8, 16 and 32
(under library names of their own, all nine at once) and times the step
launch at B=32768 of K1 (jvrc_walk, R=5), K2 (jvrc_step), K3
(jvrc_walk_rough) and K4 (jvrc_walk with envs/configs/jvrc_motor.json, the
motor counts set per env to 0, 10, 24, 25, 26, 27, 50, 1001 in turn, as
chip_smoke.py sets them) for each lane count and each blocks-an-SM of 1-4
that ``launch_plan`` sizes blocks for; K4 also with every count 0 ("K4
nets off": the histories warm up through the whole launch and no net
runs), which splits its time into physics and nets. It chose each
library's LHW_G (the source's default, or the library's ``-DLHW_G`` in
``substep_kernel.LIBRARIES``) and ``substep_kernel.BLOCKS_PER_SM``, one
value for every library while no library is faster at another; the
correctness of the chosen builds is chip_smoke.py's to check, not this
script's. Run from the repository root on a machine with a CUDA device:

    python3 -m learninghumanoidwalking_tpu_torch.ops.lane_sweep

Prints the card's name and power limit, ptxas's registers and spills per
build, one JSON line per (library, G, blocks an SM, kernel) and the table
as a last JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

LANES = (8, 16, 32)
BLOCKS = (1, 2, 3, 4)
BATCH = 32768
MOTOR_COUNTS = (0, 10, 24, 25, 26, 27, 50, 1001)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lane_sweep: no CUDA device", file=sys.stderr)
        return 2

    from learninghumanoidwalking_tpu_torch.envs.humanoid import CONFIG_DIR
    from learninghumanoidwalking_tpu_torch.envs.registry import make_env
    from learninghumanoidwalking_tpu_torch.ops import build
    from learninghumanoidwalking_tpu_torch.ops import substep_kernel as sk
    from learninghumanoidwalking_tpu_torch.utils.seeding import Draws

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    builds = {}
    for library, (name, sources, defines) in sk.LIBRARIES.items():
        kept = tuple(d for d in defines if not d.startswith("-DLHW_G="))
        for g in LANES:
            builds[(library, g)] = (f"{name}_g{g}", sources, kept + (f"-DLHW_G={g}",))
    with ThreadPoolExecutor(len(builds)) as pool:
        paths = dict(zip(builds, pool.map(lambda args: build.build_library(*args)[0], builds.values())))
    for (library, g), path in paths.items():
        print(f"{library} G={g} ptxas: " + " | ".join(build.ptxas_report(path)), flush=True)

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

    # (library, kernel) -> (positional args, keyword args) of pd_substeps_kernel
    cases = {}
    for kernel, env_name, library in (("K1", "jvrc_walk", "flat"), ("K2", "jvrc_step", "terrain"),
                                      ("K3", "jvrc_walk_rough", "terrain"), ("K4", "jvrc_walk", "motor")):
        motor_json = os.path.join(CONFIG_DIR, "jvrc_motor.json") if kernel == "K4" else None
        env = make_env(env_name, path_to_json=motor_json, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(BATCH)
        states = env.reset_batch(BATCH, Draws(gen))
        target = env.neutral_pose + 0.05 * torch.randn((BATCH, env.model.nu), generator=gen, device=dev)
        terrain = env._terrain(states.task)
        kw = dict(reuse_interval=sk.kernel_reuse(terrain, env.physics_reuse, motor=kernel == "K4"))
        args = (env.model, states.dyn, states.physics, target, env.frame_skip, env.sim_dt, terrain)
        if kernel == "K4":
            counts = torch.tensor(MOTOR_COUNTS, dtype=torch.int32, device=dev).repeat(BATCH // len(MOTOR_COUNTS) + 1)[:BATCH]
            for name, c in (("K4", counts), ("K4 nets off", torch.zeros_like(counts))):
                cases[(library, name)] = (args, dict(kw, motor=(env.motor_params, dataclasses.replace(states.motor, count=c))))
        else:
            cases[(library, kernel)] = (args, kw)

    rows = []
    default_libraries, default_blocks = dict(sk.LIBRARIES), sk.BLOCKS_PER_SM
    try:
        for library in sk.LIBRARIES:
            for g in LANES:
                sk._LIBS.pop(library, None)
                sk.LIBRARIES[library] = builds[(library, g)]
                for blocks in BLOCKS:
                    sk.BLOCKS_PER_SM = blocks
                    for (lib, kernel), (args, kw) in cases.items():
                        if lib != library:
                            continue
                        hfield = args[6].hfield if args[6] is not None else None
                        plan = sk.launch_plan(args[0], BATCH, sk._library(library)[1], None if hfield is None else tuple(hfield.shape[1:]))
                        ms = time_ms(lambda: sk.pd_substeps_kernel(*args, **kw))
                        rows.append(dict(library=library, G=g, blocks_per_sm=blocks, kernel=kernel, B=BATCH, ms=ms, plan=plan))
                        print(json.dumps(rows[-1]), flush=True)
            sk._LIBS.pop(library, None)
            sk.LIBRARIES[library] = default_libraries[library]
            sk.BLOCKS_PER_SM = default_blocks
    finally:
        for library in default_libraries:
            sk._LIBS.pop(library, None)
        sk.LIBRARIES.update(default_libraries)
        sk.BLOCKS_PER_SM = default_blocks
    print(json.dumps({"sweep": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
