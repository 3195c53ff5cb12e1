"""Contact behaviour tool (counterpart of scripts/contact_behavior.py).

Settles each humanoid env under zero action on the envs' engine path
(``HumanoidEnv.reset``/``step``: one ``engine_step_b`` at a time, with the
projected Jacobi contact solve) and prints its active contacts, the per-foot
ground reaction forces against the robot's weight, the root height and
done: the golden tool for validating engine changes. With --mujoco it also
runs the same robot in MuJoCo, on the port's own MJCF export, and prints
both.

Usage:
  python -m learninghumanoidwalking_tpu_torch.contact_behavior [--envs jvrc_walk h1] [--seconds 5] [--mujoco] [--device cuda|cpu]

``--device`` defaults to ``cuda``; without a card that raises, as the
port's command line does (pass ``--device cpu``).
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np


def settle_env(name: str, seconds: float, draws=None, device="cuda") -> dict:
    """Reset one env of ``name`` and step it under zero action for
    ``seconds``; print and return the readings. ``draws`` is a Draws source
    for the reset and every control step, or a sequence of them (the
    reset's, then one a control step); by default a HostDraws seeded with
    0, which gives the same numbers on every device."""
    import torch

    from learninghumanoidwalking_tpu_torch.envs.registry import make_env
    from learninghumanoidwalking_tpu_torch.run_experiment import resolve_device
    from learninghumanoidwalking_tpu_torch.utils.seeding import HostDraws

    if draws is None:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(0)
        draws = HostDraws(gen)
    calls = iter(draws) if isinstance(draws, (list, tuple)) else itertools.repeat(draws)
    dev = resolve_device(str(device))
    env = make_env(name, device=dev)
    steps = int(seconds / env.control_dt)
    state = env.reset(1, next(calls))
    zeros = torch.zeros((1, env.action_size), device=dev)
    for _ in range(steps):
        state = env.step(state, zeros, next(calls))
    physics = state.physics
    l_grf, r_grf = env._foot_grf(physics)
    readings = {
        "env": name,
        "seconds": seconds,
        "device": dev.type,
        "active_contacts": int(physics.contact.mask.sum()),
        "ncon": env.model.ncon,
        "grf_left": float(l_grf[0]),
        "grf_right": float(r_grf[0]),
        "mg": env.robot_mass * 9.81,
        "root_z": float(physics.qpos[0, 2]),
        "done": bool(state.done[0]),
    }
    print(f"[{name}] after {seconds}s zero-action ({dev.type}):")
    print(f"  active contacts: {readings['active_contacts']} / {readings['ncon']}")
    print(f"  GRF: left {readings['grf_left']:8.2f} N  right {readings['grf_right']:8.2f} N  (mg = {readings['mg']:.1f})")
    print(f"  root z: {readings['root_z']:.4f}  done: {readings['done']}", flush=True)
    return readings


def settle_mujoco(name: str, seconds: float) -> dict:
    """The same robot from its nominal pose in MuJoCo for ``seconds``, on
    the port's export_mjcf: contacts, total GRF and root z."""
    import mujoco

    from learninghumanoidwalking_tpu_torch.physics.mjcf import export_mjcf

    if name.startswith("jvrc"):
        from learninghumanoidwalking_tpu_torch.models.jvrc import HALF_SITTING_POSE_DEG, NOMINAL_HEIGHT, jvrc_spec

        spec, pose, z0 = jvrc_spec(), np.deg2rad(HALF_SITTING_POSE_DEG), NOMINAL_HEIGHT
    else:
        from learninghumanoidwalking_tpu_torch.models.h1 import HALF_SITTING_POSE, NOMINAL_HEIGHT, h1_spec

        spec, pose, z0 = h1_spec(), np.asarray(HALF_SITTING_POSE), NOMINAL_HEIGHT

    model = mujoco.MjModel.from_xml_string(export_mjcf(spec))
    data = mujoco.MjData(model)
    data.qpos[:] = np.concatenate([[0, 0, z0], [1, 0, 0, 0], pose])
    mujoco.mj_forward(model, data)
    for _ in range(int(seconds / model.opt.timestep)):
        mujoco.mj_step(model, data)
    grf = 0.0
    for ci in range(data.ncon):
        f6 = np.zeros(6)
        mujoco.mj_contactForce(model, data, ci, f6)
        grf += np.linalg.norm(f6[:3])
    print(f"  [mujoco] ncon {data.ncon}  total GRF {grf:.2f} N  root z {data.qpos[2]:.4f}", flush=True)
    return {"ncon": int(data.ncon), "grf": float(grf), "root_z": float(data.qpos[2])}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--envs", nargs="+", default=["jvrc_walk", "h1", "jvrc_step"])
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--mujoco", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu; cuda without a card is an error")
    args = p.parse_args(argv)
    for name in args.envs:
        settle_env(name, args.seconds, device=args.device)
        if args.mujoco:
            try:
                settle_mujoco(name, args.seconds)
            except ImportError:
                print("  [mujoco] not available")


if __name__ == "__main__":
    main()
