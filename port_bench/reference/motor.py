"""Frozen copy of learninghumanoidwalking_tpu_torch/robots/motor.py at commit 9e7f4a040c02fdfd29cfe1055f8fc2257b06e82f
(imports made relative), part of the benchmark's plain reference: it does
not follow later changes of the program. The original docstring follows.

Learned motor-dynamics hook for the PD substep loop (counterpart of
learninghumanoidwalking_tpu/robots/motor.py), batch-leading.

Per joint, a small MLP maps a rolling 25-slot history of (joint velocity,
commanded torque) to the torque the motor applies. While the history
fills (the first 25 substeps) the command passes through; after that the
histories take a new slot every second substep, and the net runs every
substep. The parameters are stacked over joints (a leading ``nu`` axis on
every weight), so one batched product serves all joints.

This is the plain version of kernel K4's motor hook
(ops/csrc/control_step_lanes.cu, the ``LHW_MOTOR`` build): physics/batched.py
calls ``motor_substep_torque_b`` on the PD torque of every substep.
``pd_substeps_motor`` is the hook in the engine path's PD loop (the humanoid
envs' ``step``): the same hook, one engine step a substep.
Parameters come from ``init_motor_params`` (an explicit torch.Generator:
JAX's threefry stream cannot be reproduced) or from an ``.npz``; the
reference ships no trained nets.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

HIST_LEN = 25  # history slots, newest last


@dataclasses.dataclass
class MotorState:
    """Rolling (qdot, commanded-torque) history per env, newest last."""

    qdot_hist: torch.Tensor  # (B, HIST_LEN, nu)
    ctau_hist: torch.Tensor  # (B, HIST_LEN, nu)
    count: torch.Tensor  # (B,) int32 substep counter


def init_motor_state(n: int, nu: int, device) -> MotorState:
    return MotorState(
        qdot_hist=torch.zeros((n, HIST_LEN, nu), device=device),
        ctau_hist=torch.zeros((n, HIST_LEN, nu), device=device),
        count=torch.zeros((n,), dtype=torch.int32, device=device),
    )


def init_motor_params(generator: torch.Generator, nu: int, hidden: tuple = (32, 32), device="cpu") -> dict:
    """Per-joint MLP params stacked over joints: ``w{l}`` (nu, d_in, d_out)
    ~ 0.01 N(0, 1), ``b{l}`` (nu, d_out) zeros, ``skip`` (nu,) ones (the
    net starts near the identity on the newest commanded torque), and
    ``n_layers``. The draws come from ``generator`` (on the CPU)."""
    sizes = (2 * HIST_LEN,) + tuple(hidden) + (1,)
    params = {}
    for li in range(len(sizes) - 1):
        w = 0.01 * torch.randn((nu, sizes[li], sizes[li + 1]), generator=generator)
        params[f"w{li}"] = w.to(device)
        params[f"b{li}"] = torch.zeros((nu, sizes[li + 1]), device=device)
    params["skip"] = torch.ones((nu,), device=device)
    params["n_layers"] = len(sizes) - 1
    return params


def motor_forward_b(params: dict, qdot_hist: torch.Tensor, ctau_hist: torch.Tensor) -> torch.Tensor:
    """(B, HIST_LEN, nu) histories -> (B, nu) torques. Each joint's net
    reads all 25 qdot slots, oldest first, then all 25 ctau slots."""
    x = torch.cat([qdot_hist, ctau_hist], dim=1).transpose(1, 2)  # (B, nu, 2H)
    n_layers = int(params["n_layers"])
    for li in range(n_layers):
        x = torch.einsum("bni,nio->bno", x, params[f"w{li}"]) + params[f"b{li}"]
        if li < n_layers - 1:
            x = torch.tanh(x)
    return params["skip"] * ctau_hist[:, -1] + x[..., 0]


def motor_substep_torque_b(
    params: dict,
    qdot_hist: torch.Tensor,  # (B, HIST_LEN, nu)
    ctau_hist: torch.Tensor,  # (B, HIST_LEN, nu)
    count: torch.Tensor,  # (B,) int32
    qdot: torch.Tensor,  # (B, nu)
    cmd_tau: torch.Tensor,  # (B, nu)
):
    """One substep of the hook: push (every substep while warming up, then
    on even counts), then the applied torque (the command while warming
    up, else the net). Returns (torque, qdot_hist, ctau_hist, count + 1)."""
    warm = count < HIST_LEN
    update = (warm | (count % 2 == 0))[:, None, None]

    def push(hist, new):
        return torch.where(update, torch.cat([hist[:, 1:], new[:, None]], dim=1), hist)

    qdot_hist = push(qdot_hist, qdot)
    ctau_hist = push(ctau_hist, cmd_tau)
    act_tau = torch.where(warm[:, None], cmd_tau, motor_forward_b(params, qdot_hist, ctau_hist))
    return act_tau, qdot_hist, ctau_hist, count + 1


def pd_substeps_motor(
    model,
    dyn,
    physics,
    motor_state: MotorState,
    motor_params: dict,
    target: torch.Tensor,  # (B, nu) joint-space position targets
    frame_skip: int,
    sim_dt: float,
    terrain=None,
):
    """robots/pd.py ``pd_substeps`` with the hook in the loop (JAX
    robots/motor.py ``pd_substeps_motor``): each substep the PD torque minus
    the back-EMF term, then the hook on it and on the joint velocities of
    the state before the step, then the applied torque through the gear
    into one ``engine_step_b``. Returns (PhysicsState, MotorState)."""
    from . import batched  # batched.py imports this module

    act_q, act_d = list(model.actuator_qpos), list(model.actuator_dof)
    qdot_hist, ctau_hist, count = motor_state.qdot_hist, motor_state.ctau_hist, motor_state.count
    for _ in range(frame_skip):
        q = physics.qpos[:, act_q]
        v = physics.qvel[:, act_d]
        tau = dyn.kp * (target - q) - dyn.kd * v - dyn.bemf_gain * v
        tau, qdot_hist, ctau_hist, count = motor_substep_torque_b(motor_params, qdot_hist, ctau_hist, count, v, tau)
        physics = batched.engine_step_b(model, dyn, physics, tau / model.actuator_gear, sim_dt, terrain)
    return physics, MotorState(qdot_hist=qdot_hist, ctau_hist=ctau_hist, count=count)


def load_motor_params(path: str, nu: int, device="cpu") -> dict:
    """Stacked per-joint params from an ``.npz`` (keys w{l}, b{l}, skip,
    n_layers)."""
    with np.load(path) as data:
        params = {k: torch.as_tensor(np.asarray(data[k], np.float32), device=device) for k in data.files if k != "n_layers"}
        params["n_layers"] = int(data["n_layers"])
    if params["w0"].shape[0] != nu:
        raise ValueError(f"motor params for {params['w0'].shape[0]} joints, the model has {nu}")
    return params
