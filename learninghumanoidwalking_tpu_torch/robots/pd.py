"""PD-controlled frame-skipped simulation loop over the engine step
(counterpart of learninghumanoidwalking_tpu/robots/pd.py).

Per control step, ``frame_skip`` substeps of the engine step
(physics/batched.py ``engine_step_b``), each applying the joint-level PD
torque toward the target pose, minus the back-EMF damping, divided by the
gear ratios into actuator controls. The humanoid envs' engine path
(``HumanoidEnv.step``) runs it, as the JAX package's single-env humanoid
step does; their training path runs the same loop fused in the
control-step kernel (ops/substep_kernel.py).
"""

from __future__ import annotations

import torch

from learninghumanoidwalking_tpu_torch.physics import batched, engine
from learninghumanoidwalking_tpu_torch.physics.model import DynParams, Model, PhysicsState


def pd_substeps(
    model: Model,
    dyn: DynParams,
    physics: PhysicsState,
    target: torch.Tensor,  # (B, nu) joint-space position targets
    frame_skip: int,
    sim_dt: float,
    terrain: engine.Terrain | None = None,
) -> PhysicsState:
    act_q, act_d = list(model.actuator_qpos), list(model.actuator_dof)
    for _ in range(frame_skip):
        q = physics.qpos[:, act_q]
        v = physics.qvel[:, act_d]
        tau = dyn.kp * (target - q) - dyn.kd * v - dyn.bemf_gain * v
        physics = batched.engine_step_b(model, dyn, physics, tau / model.actuator_gear, sim_dt, terrain)
    return physics
