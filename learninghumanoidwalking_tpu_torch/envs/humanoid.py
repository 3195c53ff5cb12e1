"""Shared machinery for humanoid environments (counterpart of
learninghumanoidwalking_tpu/envs/humanoid.py).

The JAX env vmaps per-env pure functions around a batch-in-lanes physics
call; here every step is written over the batch. The training path
(``reset_batch``/``step_batch``) runs its physics through
ops/substep_kernel.py::pd_substeps_kernel: the CUDA kernels K1 (flat floor),
K2 (terrain boxes), K3 (heightfield), K4 (flat floor with the learned
motor model), K5 or K6 (terrain boxes or heightfield with the motor model)
for CUDA tensors, their plain PyTorch version for CPU tensors.
No batch size routes the card back to the plain version.

The engine path (``reset``/``step``, the JAX env's single-env ``reset``/
``step`` over a batch) runs one engine step at a time: physics/batched.py
``engine_step_b`` with the projected Jacobi contact solve, through
robots/pd.py ``pd_substeps`` or robots/motor.py ``pd_substeps_motor``, plain
PyTorch on the env's device. The JAX engine path reaches no Pallas kernel,
and this one calls no kernel. Both paths share everything around the
physics (``_reset_pre``, ``_reset_post``, ``_pre_step``, ``_post_step``).

Ported: action smoothing and nominal-pose offsets, the PD substep loop,
the learned motor-dynamics hook (``motor_dynamics``), observation history
and per-group observation noise, reset with settle substeps, per-env
terrain from the task (``_terrain`` hook), PD-gain and back-EMF
randomization (``pdrand_k``, ``sim_bemf``), dynamics randomization and
perturbation wrenches (all sampled from a ``Draws`` source), non-finite
termination, the rangefinder array.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.envs.base import Env, EnvState
from learninghumanoidwalking_tpu_torch.ops.substep_kernel import pd_substeps_kernel
from learninghumanoidwalking_tpu_torch.physics import batched, engine, interface
from learninghumanoidwalking_tpu_torch.physics import rangefinder as rangefinder_mod
from learninghumanoidwalking_tpu_torch.physics.model import DynParams, default_dyn_params, tree_map
from learninghumanoidwalking_tpu_torch.robots import motor as motor_mod
from learninghumanoidwalking_tpu_torch.robots import pd
from learninghumanoidwalking_tpu_torch.utils import maths, trace
from learninghumanoidwalking_tpu_torch.utils.config import load_json

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


class HumanoidEnv(Env):
    """Base for humanoid envs. Subclass contract (as in the JAX package):
    __init__ sets model, cfg, kp, kd, nominal_qpos, ROOT/HEAD/foot body
    names and reward_names, then calls _finalize(). Hooks: _task_reset,
    _task_step, _reward, _done, _external_obs."""

    ROOT_BODY = "pelvis"
    HEAD_BODY = "torso_link"
    include_torque_obs = False
    num_external_obs = 0

    def _finalize(self) -> None:
        m = self.model
        cfg = self.cfg
        self.sim_dt = float(cfg.sim_dt)
        self.control_dt = float(cfg.control_dt)
        self.frame_skip = int(round(self.control_dt / self.sim_dt))
        self.history_len = int(cfg.obs_history_len or 1)
        self.action_smoothing = float(cfg.action_smoothing or 0.5)
        self.action_size = m.nu

        # factorization-reuse interval R asked of the physics (JAX
        # envs/humanoid.py:78-80): default 5 where it divides frame_skip;
        # config physics_reuse_interval or the LHW_PHYSICS_REUSE environment
        # variable (tests pin R with it) override. Steps on terrain run at
        # R=1 whatever is asked: ops/substep_kernel.py::kernel_reuse pins it.
        reuse_cfg = os.environ.get("LHW_PHYSICS_REUSE") or cfg.physics_reuse_interval
        reuse = int(reuse_cfg) if reuse_cfg is not None else 5
        self.physics_reuse = reuse if (reuse > 0 and self.frame_skip % reuse == 0) else 1

        # optional learned motor-dynamics hook: per-joint nets over a
        # 25-substep (qdot, commanded torque) history, weights from an .npz
        # or drawn from a generator seeded with motor_dynamics.seed
        md_cfg = cfg.motor_dynamics
        self.motor_enabled = bool(md_cfg and md_cfg.enable)
        if self.motor_enabled:
            if md_cfg.params_path:
                self.motor_params = motor_mod.load_motor_params(str(md_cfg.params_path), m.nu, self.device)
            else:
                gen = torch.Generator()
                gen.manual_seed(int(md_cfg.seed or 0))
                self.motor_params = motor_mod.init_motor_params(gen, m.nu, device=self.device)
        # optional actuator randomizations, every control step: PD gains
        # scaled by U(1-k, 1+k) per env and joint; with probability 1/10 per
        # env a back-EMF gain U(5, 40) per joint
        self.pdrand_k = float(cfg.pdrand_k) if cfg.pdrand_k else 0.0
        self.sim_bemf = bool(cfg.sim_bemf)

        self.root_idx = m.body_names.index(self.ROOT_BODY)
        self.head_idx = m.body_names.index(self.HEAD_BODY)
        self.lfoot_idx = m.body_names.index(self.LFOOT_BODY)
        self.rfoot_idx = m.body_names.index(self.RFOOT_BODY)
        self._lslot = interface.foot_slot_mask(m, set(m.left_foot_geoms))
        self._rslot = interface.foot_slot_mask(m, set(m.right_foot_geoms))

        self.act_qpos = list(m.actuator_qpos)
        self.act_dof = list(m.actuator_dof)
        self.neutral_pose = torch.as_tensor(
            np.asarray(self.nominal_qpos[np.asarray(m.actuator_qpos)], np.float32), device=self.device
        )
        self.robot_mass = float(np.sum(m.np("body_mass")))

        nrobot = 5 + 2 * m.nu + (m.nu if self.include_torque_obs else 0)
        self.robot_state_len = nrobot
        self.base_obs_len = nrobot + self.num_external_obs
        self.obs_size = self.base_obs_len * self.history_len

        dyn_cfg = cfg.dynamics_randomization
        self.dynrand_interval = (
            int(float(dyn_cfg.interval) / self.control_dt) if (dyn_cfg and dyn_cfg.enable) else 0
        )
        pert_cfg = cfg.perturbation
        self.perturb_interval = (
            int(float(pert_cfg.interval) / self.control_dt) if (pert_cfg and pert_cfg.enable) else 0
        )
        if pert_cfg and pert_cfg.enable:
            self.perturb_bodies = tuple(m.body_names.index(b) for b in pert_cfg.bodies if b in m.body_names)
            self.perturb_force = float(pert_cfg.force_magnitude)
            self.perturb_torque = float(pert_cfg.torque_magnitude)
        else:
            self.perturb_bodies = ()
        self.init_noise = float(cfg.init_noise) if cfg.init_noise else 0.0

        # observation noise, per observation group, uniform or gaussian
        noise_cfg = cfg.observation_noise
        self.obs_noise_enabled = bool(noise_cfg and noise_cfg.enabled)
        if self.obs_noise_enabled:
            mult = float(noise_cfg.multiplier or 1.0)
            sc = noise_cfg.scales
            self.noise_type = str(noise_cfg.type or "uniform")
            scale = np.zeros(nrobot, dtype=np.float32)
            scale[0:2] = float(sc.root_orient or 0.0) * mult
            scale[2:5] = float(sc.root_ang_vel or 0.0) * mult
            scale[5 : 5 + m.nu] = float(sc.motor_pos or 0.0) * mult
            scale[5 + m.nu : 5 + 2 * m.nu] = float(sc.motor_vel or 0.0) * mult
            if self.include_torque_obs:
                scale[5 + 2 * m.nu :] = float(sc.motor_tau or 0.0) * mult
            self.obs_noise_scale = torch.as_tensor(scale, device=self.device)

    # --------------------------------------------------------------- gather

    def _foot_grf(self, physics):
        fmag = torch.linalg.vector_norm(physics.contact.force, dim=-1) * physics.contact.mask
        return torch.sum(fmag * self._lslot, dim=-1), torch.sum(fmag * self._rslot, dim=-1)

    def _root_local_vel_xy(self, physics):
        v_world = physics.body_vel_world(self.root_idx)
        return maths.quat_rotate_inv(physics.xquat[:, self.root_idx], v_world)[:, :2]

    def _motor_pos(self, physics):
        return physics.qpos[:, self.act_qpos]

    def _motor_vel(self, physics):
        return physics.qvel[:, self.act_dof]

    def _robot_state(self, physics, draws) -> torch.Tensor:
        """roll, pitch, root angular velocity, motor pos/vel (+ torques), with
        the optional per-group observation noise."""
        rpy = maths.quat_to_rpy(physics.qpos[:, 3:7])
        parts = [rpy[:, :2], physics.qvel[:, 3:6], self._motor_pos(physics), self._motor_vel(physics)]
        if self.include_torque_obs:
            parts.append(physics.act_torque)
        state = torch.cat(parts, dim=-1)
        if self.obs_noise_enabled:
            shape, dev = tuple(state.shape), state.device
            if self.noise_type == "gaussian":
                noise = draws.normal("obs.noise", shape, dev)
            else:
                noise = draws.uniform("obs.noise", shape, -1.0, 1.0, dev)
            state = state + noise * self.obs_noise_scale
        return state

    def _base_obs(self, physics, task, draws) -> torch.Tensor:
        """The robot state followed by the task's external observations."""
        state = self._robot_state(physics, draws)
        if self.num_external_obs == 0:
            return state
        return torch.cat([state, self._external_obs(task)], dim=-1)

    # ------------------------------------------------- domain randomization

    def _sample_dynamics(self, draws, n: int) -> DynParams:
        """Actuated-joint frictionloss ~ U(0,2) and damping ~ U(0.02,2), body
        mass x U(0.95,1.05), CoM ipos +- 1 cm (JAX envs/humanoid.py:215)."""
        m = self.model
        base = default_dyn_params(m, self.kp, self.kd, n)
        if self.dynrand_interval == 0:
            return base
        dev = self.device
        fl = draws.uniform("dyn.frictionloss", (n, m.nv), 0.0, 2.0, dev)
        dp = draws.uniform("dyn.damping", (n, m.nv), 0.02, 2.0, dev)
        mass_scale = draws.uniform("dyn.mass_scale", (n, m.nbody), 0.95, 1.05, dev)
        ipos_off = draws.uniform("dyn.ipos", (n, m.nbody, 3), -0.01, 0.01, dev)
        act_mask = torch.zeros(m.nv, dtype=torch.bool, device=dev)
        act_mask[self.act_dof] = True
        return dataclasses.replace(
            base,
            dof_frictionloss=torch.where(act_mask, fl, base.dof_frictionloss),
            dof_damping=torch.where(act_mask, dp, base.dof_damping),
            body_mass=base.body_mass * mass_scale,
            body_ipos=base.body_ipos + ipos_off * (base.body_mass[..., None] > 0),
        )

    def _sample_perturbation(self, draws, dyn: DynParams) -> DynParams:
        """Random persistent wrench on configured bodies, 50% chance zeroed
        (JAX envs/humanoid.py:238)."""
        if not self.perturb_bodies:
            return dyn
        n, dev = dyn.xfrc.shape[0], dyn.xfrc.device
        xfrc = torch.zeros_like(dyn.xfrc)
        for i, b in enumerate(self.perturb_bodies):
            frc = draws.uniform(f"pert.force{i}", (n, 3), -self.perturb_force, self.perturb_force, dev)
            tau = draws.uniform(f"pert.torque{i}", (n, 3), -self.perturb_torque, self.perturb_torque, dev)
            keep = draws.randint(f"pert.keep{i}", (n,), 0, 2, dev).to(torch.float32)
            xfrc[:, b] = keep[:, None] * torch.cat([frc, tau], dim=-1)
        return dataclasses.replace(dyn, xfrc=xfrc)

    # ----------------------------------------------------------------- reset

    def _reset_pre(self, draws, n: int, iteration):
        """Everything before the settle substeps."""
        m = self.model
        dev = self.device
        dyn = self._sample_dynamics(draws, n)
        qpos = torch.as_tensor(np.asarray(self.nominal_qpos, np.float32), device=dev).expand(n, m.nq).clone()
        if self.init_noise > 0:
            c = self.init_noise * math.pi / 180.0
            qpos[:, 2] += draws.uniform("init.height", (n,), 0.0, 0.02, dev)
            rp = draws.uniform("init.roll_pitch", (n, 2), -c, c, dev)
            qpos[:, 3:7] = maths.rpy_to_quat(torch.cat([rp, torch.zeros((n, 1), device=dev)], dim=-1))
            qpos[:, self.act_qpos] += draws.uniform("init.joints", (n, m.nu), -c, c, dev)
        physics = engine.make_state(m, qpos, torch.zeros((n, m.nv), device=dev))
        task = self._task_reset(draws, n, iteration, physics)
        return physics, dyn, task

    def _reset_post(self, physics, dyn, task, iteration, draws) -> EnvState:
        m = self.model
        n, dev = physics.qpos.shape[0], self.device
        base_obs = self._base_obs(physics, task, draws)
        obs_history = torch.zeros((n, self.history_len, self.base_obs_len), device=dev)
        obs_history[:, 0] = base_obs
        if iteration is None:
            iteration = torch.zeros((n,), dtype=torch.int32, device=dev)
        return EnvState(
            physics=physics,
            dyn=dyn,
            task=task,
            obs=obs_history.reshape(n, -1),
            obs_history=obs_history,
            prev_prediction=torch.zeros((n, m.nu), device=dev),
            prev_action=self.neutral_pose.expand(n, m.nu).clone(),
            prev_torque=torch.zeros((n, m.nu), device=dev),
            reward=torch.zeros((n,), device=dev),
            reward_components=torch.zeros((n, len(self.reward_names)), device=dev),
            done=torch.zeros((n,), dtype=torch.bool, device=dev),
            steps=torch.zeros((n,), dtype=torch.int32, device=dev),
            iteration=torch.as_tensor(iteration, dtype=torch.int32, device=dev).expand(n).clone(),
            motor=motor_mod.init_motor_state(n, m.nu, dev) if self.motor_enabled else None,
        )

    def reset(self, num_envs: int, draws, iteration=None) -> EnvState:
        """The engine path's reset: initial pose and task draws, 3 zero-ctrl
        ``engine_step_b`` substeps on the envs' terrain, observations."""
        physics, dyn, task = self._reset_pre(draws, num_envs, iteration)
        zeros = torch.zeros((num_envs, self.model.nu), device=self.device)
        terrain = self._terrain(task)
        for _ in range(3):
            physics = batched.engine_step_b(self.model, dyn, physics, zeros, self.sim_dt, terrain)
        return self._reset_post(physics, dyn, task, iteration, draws)

    def reset_batch(self, num_envs: int, draws, iteration=None) -> EnvState:
        """Fresh states for ``num_envs`` envs: initial pose and task draws, 3
        zero-torque settle substeps at R=1 (one kernel launch), observations."""
        with trace.span("env.reset"):
            physics, dyn, task = self._reset_pre(draws, num_envs, iteration)
            zeros = torch.zeros((num_envs, self.model.nu), device=self.device)
            terrain = self._terrain(task)
            physics = pd_substeps_kernel(self.model, dyn, physics, zeros, 3, self.sim_dt, terrain, settle=True)
            return self._reset_post(physics, dyn, task, iteration, draws)

    # ------------------------------------------------------------------ step

    def _pre_step(self, states: EnvState, actions: torch.Tensor) -> torch.Tensor:
        """Action smoothing + nominal-pose offsets."""
        targets = self.action_smoothing * actions + (1.0 - self.action_smoothing) * states.prev_prediction
        return targets + self.neutral_pose

    def step(self, states: EnvState, actions: torch.Tensor, draws) -> EnvState:
        """The engine path's control step: ``frame_skip`` PD substeps of
        ``engine_step_b`` (with the motor hook where enabled), then task,
        reward, termination and observations."""
        full_target = self._pre_step(states, actions)
        terrain = self._terrain(states.task)
        if self.motor_enabled:
            physics, new_motor = motor_mod.pd_substeps_motor(
                self.model, states.dyn, states.physics, states.motor, self.motor_params,
                full_target, self.frame_skip, self.sim_dt, terrain,
            )
            states = dataclasses.replace(states, motor=new_motor)
        else:
            physics = pd.pd_substeps(self.model, states.dyn, states.physics, full_target, self.frame_skip, self.sim_dt, terrain)
        return self._post_step(states, physics, actions, full_target, draws)

    def step_batch(self, states: EnvState, actions: torch.Tensor, draws) -> EnvState:
        """One control step of every env: frame_skip substeps in one kernel
        launch, then task, reward, termination and observations."""
        with trace.span("env.step"):
            full_target = self._pre_step(states, actions)
            terrain = self._terrain(states.task)
            motor = (self.motor_params, states.motor) if self.motor_enabled else None
            physics = pd_substeps_kernel(
                self.model, states.dyn, states.physics, full_target, self.frame_skip, self.sim_dt, terrain,
                reuse_interval=self.physics_reuse, motor=motor,
            )
            if motor is not None:  # (PhysicsState, MotorState)
                physics, new_motor = physics
                states = dataclasses.replace(states, motor=new_motor)
            return self._post_step(states, physics, actions, full_target, draws)

    def _post_step(self, state: EnvState, physics, actions, full_target, draws) -> EnvState:
        task = self._task_step(draws, state.task, physics)
        components = self._reward(state, physics, task, full_target)
        # terminate (and reset) any env whose physics went non-finite
        finite = torch.all(torch.isfinite(physics.qpos), dim=-1) & torch.all(torch.isfinite(physics.qvel), dim=-1)
        components = torch.nan_to_num(components)
        done = self._done(physics) | ~finite

        base_obs = torch.nan_to_num(self._base_obs(physics, task, draws))
        obs_history, obs = self.stack_history(state.obs_history, base_obs)

        dyn = state.dyn
        n, dev = actions.shape[0], actions.device
        nu = self.model.nu
        if self.pdrand_k > 0:
            k = self.pdrand_k
            kp = torch.as_tensor(self.kp, device=dev) * draws.uniform("pd.kp_scale", (n, nu), 1 - k, 1 + k, dev)
            kd = torch.as_tensor(self.kd, device=dev) * draws.uniform("pd.kd_scale", (n, nu), 1 - k, 1 + k, dev)
            dyn = dataclasses.replace(dyn, kp=kp, kd=kd)
        if self.sim_bemf:
            hit = draws.randint("bemf.event", (n,), 0, 10, dev) == 0
            gain = draws.uniform("bemf.gain", (n, nu), 5.0, 40.0, dev)
            dyn = dataclasses.replace(dyn, bemf_gain=torch.where(hit[:, None], gain, dyn.bemf_gain))
        if self.dynrand_interval > 0:
            hit = draws.randint("dyn.event", (n,), 0, self.dynrand_interval, dev) == 0
            new_dyn = self._sample_dynamics(draws, n)
            dyn = tree_map(lambda a, b: torch.where(hit.reshape((n,) + (1,) * (a.dim() - 1)), a, b), new_dyn, dyn)
        if self.perturb_interval > 0 and self.perturb_bodies:
            hit = draws.randint("pert.event", (n,), 0, self.perturb_interval, dev) == 0
            new_dyn = self._sample_perturbation(draws, dyn)
            dyn = tree_map(lambda a, b: torch.where(hit.reshape((n,) + (1,) * (a.dim() - 1)), a, b), new_dyn, dyn)

        return dataclasses.replace(
            state,
            physics=physics,
            dyn=dyn,
            task=task,
            obs=obs,
            obs_history=obs_history,
            prev_prediction=actions,
            prev_action=full_target,
            prev_torque=physics.act_torque,
            reward=torch.sum(components, dim=-1),
            reward_components=components,
            done=done,
            steps=state.steps + 1,
        )

    def rangefinder(self, states: EnvState, num_rows: int = 4, num_cols: int = 4, spacing: float = 0.4) -> torch.Tensor:
        """(B, rows x cols) downward ray distances under the root body, -1
        where nothing is hit (physics/rangefinder.py; JAX
        envs/humanoid.py:376-387): the reference's optional rangefinder
        array, which no shipped config reads."""
        sites = rangefinder_mod.site_grid(num_rows, num_cols, spacing)
        physics = states.physics
        return rangefinder_mod.rangefinder(
            physics.xpos[:, self.root_idx], physics.xquat[:, self.root_idx], self._terrain(states.task), sites
        )

    def render_markers(self, states: EnvState, i: int) -> dict | None:
        """Overlay data of env ``i`` for rendering (JAX envs/humanoid.py:389):
        the task envs give their targets, terrain or mode; None is no overlay."""
        return None

    # ----------------------------------------------------- hooks (override)

    def _task_reset(self, draws, n: int, iteration, physics):
        """The task state of ``n`` fresh envs; none by default."""
        return None

    def _task_step(self, draws, task, physics):
        return task

    def _terrain(self, task):
        """The envs' terrain (engine.Terrain) for a task state; flat by default."""
        return None

    def _reward(self, state, physics, task, target) -> torch.Tensor:
        raise NotImplementedError

    def _done(self, physics) -> torch.Tensor:
        raise NotImplementedError


def load_config(name: str, path_to_json: str | None):
    return load_json(path_to_json or os.path.join(CONFIG_DIR, name))
