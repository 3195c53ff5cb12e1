"""The plain reference of one control-step launch (written for the benchmark).

The model is built here from the robot description that the
configuration's ``reference`` section names (a module of robots/, lowered by
spec.py), the floor from the module of floors/ it names, and the motor nets
from the seed the configuration states (a copy of the port's
init_motor_params); the launch is the frozen plain version, batched.py's
pd_substeps_batched. Its inputs are the program's state as the timed path
handed it to the kernel (qpos, qvel, the PD target, the per-env dynamics
parameters, the terrain and, with the motor hook, the histories and counts).

``precision="float64"`` is the reference; ``precision="float32"`` (TF32
off) is its float32 witness, which shows how far a state amplifies float32
rounding; ``precision="tf32"`` is the control: float32 with TF32 on for
every matmul, the step below the configuration's float32 with TF32 off (and
float32 for its float64 parts).
"""

from __future__ import annotations

import contextlib
import importlib
import types

import torch

from . import motor, spec
from .batched import pd_substeps_batched
from .model import DynParams, tree_map

_MODELS: dict = {}


def robot(name: str):
    return importlib.import_module(f".robots.{name}", __package__)


def floor(name: str):
    return importlib.import_module(f".floors.{name}", __package__)


def model(ref_cfg: dict, device) -> object:
    """The lowered model of the robot ``ref_cfg["robot"]`` (with
    ``ref_cfg.get("robot_args")``), cached per robot, arguments and device."""
    args = ref_cfg.get("robot_args", {})
    key = (ref_cfg["robot"], tuple(sorted(args.items())), str(device))
    if key not in _MODELS:
        _MODELS[key] = spec.lower(robot(ref_cfg["robot"]).spec(**args), device=device)
    return _MODELS[key]


def motor_params(seed: int, nu: int, hidden: list[int], device) -> dict:
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    return motor.init_motor_params(gen, nu, tuple(hidden), device=device)


@contextlib.contextmanager
def _precision(precision: str):
    prev_dtype = torch.get_default_dtype()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if precision == "float64":
        torch.set_default_dtype(torch.float64)
        tf32 = False
    elif precision in ("float32", "tf32"):
        tf32 = precision == "tf32"
    else:
        raise ValueError(f"unknown precision {precision!r}")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield torch.float64 if precision == "float64" else torch.float32
    finally:
        torch.set_default_dtype(prev_dtype)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev_tf32


@torch.no_grad()
def launch(inputs: dict, kernel: dict, physics_cfg: dict, motor_cfg: dict | None, motor_seed: int | None,
           ref_cfg: dict, device, precision: str = "float64") -> dict:
    """One launch of ``kernel`` (substeps, reuse, motor) on ``inputs`` (the
    captured tensors, batch-leading) for the robot and floor ``ref_cfg``
    names. Returns qpos, qvel and, with the motor hook, the two histories,
    as float64 tensors on ``device``."""
    with _precision(precision) as dtype:
        cast = lambda x: x.to(device=device, dtype=dtype) if torch.is_tensor(x) and x.is_floating_point() else (
            x.to(device) if torch.is_tensor(x) else x)
        m = tree_map(cast, model(ref_cfg, device))
        terrain = floor(ref_cfg["floor"]).terrain(
            None if inputs.get("terrain") is None else {k: cast(v) for k, v in inputs["terrain"].items()},
            device, dtype)
        params = DynParams(**{k: cast(v) for k, v in inputs["params"].items()})
        phys = inputs["physics"]
        # the plain version reads the state's qpos, qvel and time only
        state = types.SimpleNamespace(qpos=cast(phys["qpos"]), qvel=cast(phys["qvel"]), time=cast(phys["time"]))
        mot = None
        if kernel["motor"]:
            mp = {k: cast(v) for k, v in motor_params(motor_seed, m.nu, motor_cfg["hidden"], device).items()}
            ms = inputs["motor"][1]  # (the program's nets, which the reference draws itself; the state)
            mstate = motor.MotorState(qdot_hist=cast(ms["qdot_hist"]), ctau_hist=cast(ms["ctau_hist"]),
                                      count=ms["count"].to(device))
            mot = (mp, mstate)
        out = pd_substeps_batched(m, params, state, cast(inputs["target"]), kernel["substeps"], physics_cfg["sim_dt"],
                                  terrain, settle=kernel["kind"] == "settle", reuse_interval=kernel["reuse"], motor=mot)
        res = {}
        if mot is not None:
            out, mout = out
            res.update(qd_hist=mout.qdot_hist.double(), ct_hist=mout.ctau_hist.double())
        res.update(qpos=out.qpos.double(), qvel=out.qvel.double())
        return res
