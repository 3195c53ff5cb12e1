"""Timing of the designs tried for the motor nets of K4 and of K5/K6, and of
the float32 contact Gram of K2-K6, on the card.

``--build terrain_motor`` (the default) builds the terrain + motor library
(K5, K6) of csrc/control_step_lanes.cu as it stands ("kept": the motor
histories in device memory, 11 envs a block, the block's nets run once a
substep, a warp a joint, each weight loaded once for all of the block's
envs, in float32 FMAs) and the designs it was chosen over, as diffs against
the lane source:

- ``shared_rings`` (csrc/net_variants/shared_rings.diff): the
  design of its first build, the two history rings in each env's shared
  region (8 envs a block), each env's group running its joints' nets in
  turn (group_motor_net, every weight loaded by every env);
- ``rings_in_device_memory`` (csrc/net_variants/rings_in_device_memory.diff):
  the kept build's rings and envs a block with the nets above, read from
  the rings in device memory;
- ``tensor_cores`` (csrc/net_variants/tensor_cores.diff): the kept build
  with each hidden layer of a joint's nets as a warp's tensor-core product
  over the block's envs (mma.sync m16n8k8 in TF32, three products of the
  operands' high and low TF32 parts for about float32's accuracy);
- ``float32_gram`` (csrc/net_variants/float32_gram.diff): the contact
  basis's Gram G = Y^T Y and its factor formed in float32, as the terrain
  and motor builds formed them before every build took float64 (the diff
  changes the one Gram block of all four builds).

It times K5's (jvrc_step) and K6's (jvrc_walk_rough) step launch, both with
envs/configs/jvrc_motor.json (25 substeps), at B=4096 and 32768 and two
blocks an SM.

``--build motor`` builds the motor library (K4) as it stands ("kept": the
group of lanes on one joint at a time, a lane one unit at a time with one
accumulator, the loop over the unit's inputs unrolled 10 times) and in the
variants of its nets that were tried and rejected:

- ``unroll5``, ``unroll20``, ``unroll25``: the kept design with that loop
  unrolled 5, 20 or 25 times;
- ``units_in_registers`` (csrc/net_variants/units_in_registers.diff): lane
  j accumulates the units j + 16 k of a layer in registers, input by input;
- ``block_staged`` (csrc/net_variants/block_staged.diff): the design above
  reading each joint's weights from shared memory, where the whole block
  stages them with cp.async into two buffers (the next joint's while the
  groups run this one's), at two ``__syncthreads`` a joint; its launch
  plan leaves room for the two buffers beside the env regions;
- ``float32_gram``, as above.

It times K4's step launch (jvrc_walk with jvrc_motor.json) at B=4096 and
32768 for each blocks-an-SM of 1-3 that ``launch_plan`` sizes blocks for.

``--build terrain`` builds the terrain library (K2, K3) as it stands and
with ``float32_gram``, and times K2's (jvrc_step) and K3's
(jvrc_walk_rough) step launch at B=4096 and 32768 and two blocks an SM,
without a motor model.

In the motor builds every launch is timed with the motor counts set per env to 0, 10, 24, 25,
26, 27, 50, 1001 in turn, as lane_sweep.py and chip_smoke.py set them
("nets on"), and with every count 0 ("nets off": the histories warm up
through the whole launch and no net runs). Each variant's qpos and applied
torques at two blocks an SM are held to the kept build's on the same inputs
(the variants sum in another order: within 1e-3 rad and 1e-2 N m; the
float32 Gram's qpos only, as its rounding moves the contact solve's qvel,
and the torques with it, by more on the heightfield); a variant that
differs more makes the script exit 1. Its correctness beyond
that is not this script's to check. Run from the repository root on a
machine with a CUDA device:

    python3 -m learninghumanoidwalking_tpu_torch.ops.net_sweep [--build motor|terrain]

Prints the card's name and power limit, ptxas's report per variant, one
JSON line per (variant, kernel, B, blocks an SM, nets; null in the
terrain build) with the means of
three runs of three launches each, and the table as a last JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BATCHES = (4096, 32768)
UNROLLS = (5, 20, 25)
# per build: the diffs of its rejected designs, the kernels timed (env name,
# motor config), the blocks an SM swept
DIFFS = {"terrain": ("float32_gram",), "motor": ("units_in_registers", "block_staged", "float32_gram"),
         "terrain_motor": ("shared_rings", "rings_in_device_memory", "tensor_cores", "float32_gram")}
KERNELS = {"terrain": {"K2": "jvrc_step", "K3": "jvrc_walk_rough"}, "motor": {"K4": "jvrc_walk"},
           "terrain_motor": {"K5": "jvrc_step", "K6": "jvrc_walk_rough"}}
BLOCKS = {"terrain": (2,), "motor": (1, 2, 3), "terrain_motor": (2,)}
NETS = {"terrain": (None,), "motor": ("on", "off"), "terrain_motor": ("on", "off")}
MOTOR_COUNTS = (0, 10, 24, 25, 26, 27, 50, 1001)
KEPT_LOOP = "#pragma unroll 10\n      for (int i = 0; i < din; ++i) acc +="


def apply_diff(text: str, diff: str) -> str:
    """``text`` with each hunk of the unified ``diff`` applied where its old
    lines (context and removed) occur, which must be exactly once."""
    hunks = re.split(r"^@@[^\n]*@@\n", diff, flags=re.M)[1:]
    for hunk in hunks:
        lines = hunk.splitlines()
        old = "".join(ln[1:] + "\n" for ln in lines if ln[:1] in (" ", "-"))
        new = "".join(ln[1:] + "\n" for ln in lines if ln[:1] in (" ", "+"))
        if text.count(old) != 1:
            raise ValueError(f"a hunk's old lines occur {text.count(old)} times, not once:\n{old}")
        text = text.replace(old, new)
    return text


def variant_sources(csrc: Path, build: str = "motor") -> dict[str, str]:
    """The rejected variants' source texts of ``build``'s nets, from the lane
    source as it stands."""
    kept = (csrc / "control_step_lanes.cu").read_text()
    out = {}
    if build == "motor":
        if kept.count(KEPT_LOOP) != 1:
            raise ValueError("the kept nets' unrolled input loop is not in the lane source")
        out = {f"unroll{u}": kept.replace(KEPT_LOOP, KEPT_LOOP.replace("unroll 10", f"unroll {u}")) for u in UNROLLS}
    for name in DIFFS[build]:
        out[name] = apply_diff(kept, (csrc / "net_variants" / f"{name}.diff").read_text())
    return out


def stage_floats(dims: list[int]) -> int:
    """Floats of block_staged's two buffers of one joint's weights (per layer
    d_l x d_{l+1} weights and d_{l+1} biases, and the skip weight), for nets
    of layer widths ``dims``."""
    return 2 * (1 + sum(a * b + b for a, b in zip(dims[:-1], dims[1:])))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="time the rejected designs of K2/K3 (terrain), K4 (motor) or K5/K6 (terrain_motor)")
    parser.add_argument("--build", choices=sorted(DIFFS), default="terrain_motor")
    build_name = parser.parse_args(argv).build

    import torch

    if not torch.cuda.is_available():
        print("net_sweep: no CUDA device", file=sys.stderr)
        return 2

    from learninghumanoidwalking_tpu_torch.envs.humanoid import CONFIG_DIR
    from learninghumanoidwalking_tpu_torch.envs.registry import make_env
    from learninghumanoidwalking_tpu_torch.ops import build
    from learninghumanoidwalking_tpu_torch.ops import substep_kernel as sk
    from learninghumanoidwalking_tpu_torch.utils.seeding import Draws

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    kept_name, kept_sources, kept_defines = sk.LIBRARIES[build_name]
    src_dir = build.BUILD_DIR / "net_variants"
    src_dir.mkdir(parents=True, exist_ok=True)
    libraries = {"kept": sk.LIBRARIES[build_name]}
    for name, text in variant_sources(build.CSRC, build_name).items():
        path = src_dir / f"{name}.cu"
        path.write_text(text)
        # an absolute source path; the csrc headers on the include path
        libraries[name] = (f"{kept_name}_{name}", (str(path),), kept_defines + (f"-I{build.CSRC}",))
    with ThreadPoolExecutor(len(libraries)) as pool:
        paths = dict(zip(libraries, pool.map(lambda args: build.build_library(*args)[0], libraries.values())))
    for name, path in paths.items():
        print(f"{name} ptxas: " + " | ".join(build.ptxas_report(path)), flush=True)

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

    cases = {}  # (kernel, B, nets) -> (positional args, motor state or None)
    envs = {}
    motor_build = build_name != "terrain"
    for kernel, env_name in KERNELS[build_name].items():
        json_path = os.path.join(CONFIG_DIR, "jvrc_motor.json") if motor_build else None
        env = envs[kernel] = make_env(env_name, path_to_json=json_path, device=dev)
        for batch in BATCHES:
            gen = torch.Generator(device=dev)
            gen.manual_seed(batch)
            states = env.reset_batch(batch, Draws(gen))
            target = env.neutral_pose + 0.05 * torch.randn((batch, env.model.nu), generator=gen, device=dev)
            args = (env.model, states.dyn, states.physics, target, env.frame_skip, env.sim_dt, env._terrain(states.task))
            if not motor_build:
                cases[(kernel, batch, None)] = (args, None)
                continue
            counts = torch.tensor(MOTOR_COUNTS, dtype=torch.int32, device=dev).repeat(batch // len(MOTOR_COUNTS) + 1)[:batch]
            for nets, c in (("on", counts), ("off", torch.zeros_like(counts))):
                cases[(kernel, batch, nets)] = (args, dataclasses.replace(states.motor, count=c))

    def launch(kernel: str, batch: int, nets: str | None):
        """The launch's physics state."""
        args, motor = cases[(kernel, batch, nets)]
        if motor is None:
            return sk.pd_substeps_kernel(*args, reuse_interval=1)
        return sk.pd_substeps_kernel(*args, reuse_interval=1, motor=(envs[kernel].motor_params, motor))[0]

    rows, reference, disagree = [], {}, []
    default_blocks, default_reserved = sk.BLOCKS_PER_SM, sk.SMEM_RESERVED
    try:
        for name, library in libraries.items():
            sk._LIBS.pop(build_name, None)
            sk.LIBRARIES[build_name] = library
            staged = 4 * stage_floats(sk.motor_dims(next(iter(envs.values())).motor_params)) if name == "block_staged" else 0
            sk.SMEM_RESERVED = default_reserved + staged
            for kernel, env in envs.items():
                terrain = cases[(kernel, BATCHES[0], NETS[build_name][0])][0][6]
                hfield_shape = None if terrain is None or terrain.hfield is None else tuple(terrain.hfield.shape[1:])
                for batch in BATCHES:
                    for blocks in BLOCKS[build_name]:
                        sk.BLOCKS_PER_SM = blocks
                        plan = sk.launch_plan(env.model, batch, sk._library(build_name)[1], hfield_shape)
                        for nets in NETS[build_name]:
                            ms = [time_ms(lambda: launch(kernel, batch, nets)) for _ in range(3)]
                            rows.append(dict(variant=name, kernel=kernel, B=batch, blocks_per_sm=blocks, nets=nets, ms=ms,
                                             envs_per_block=plan["envs_per_block"]))
                            print(json.dumps(rows[-1]), flush=True)
                    sk.BLOCKS_PER_SM = 2
                    state = launch(kernel, batch, NETS[build_name][0])
                    torch.cuda.synchronize()
                    if name == "kept":
                        reference[(kernel, batch)] = state
                        continue
                    dq = (state.qpos - reference[(kernel, batch)].qpos).abs().max().item()
                    dtau = (state.act_torque - reference[(kernel, batch)].act_torque).abs().max().item()
                    print(json.dumps(dict(variant=name, kernel=kernel, B=batch, max_abs_dqpos=dq, max_abs_dtorque=dtau)), flush=True)
                    if not (dq <= 1e-3 and (dtau <= 1e-2 or name == "float32_gram")):
                        disagree.append((name, kernel, batch, dq, dtau))
    finally:
        sk._LIBS.pop(build_name, None)
        sk.LIBRARIES[build_name] = (kept_name, kept_sources, kept_defines)
        sk.BLOCKS_PER_SM, sk.SMEM_RESERVED = default_blocks, default_reserved
    print(json.dumps({"net_sweep": rows}), flush=True)
    if disagree:
        print(f"net_sweep: variants that differ from the kept build: {disagree}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
