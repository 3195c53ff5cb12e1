"""Live policy viewer in a MuJoCo passive window (counterpart of
learninghumanoidwalking_tpu/rl/viewer.py).

The physics runs in the port, so the window is a mirror: each control step
one env advances on the device (``PolicyStepper``: the policy, then
``step_batch`` at B=1, through the control-step kernel on the card), its
qpos is written into an MjData of the env's exported MJCF, and a
``mujoco.viewer.launch_passive`` window syncs it, the env's task markers
drawn into ``viewer.user_scn`` as the offscreen renderer draws them
(rl/render_gl.py::_draw_markers). Real-time pacing and pause on space are
``ViewerLoop``'s, which needs no display.

The window needs a display (GLFW): without one ``view_policy`` raises and
points at ``eval --out video.gif``. mujoco is imported only for the window
and its mirror, so ``PolicyStepper`` runs where mujoco is not installed.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.rl.eval import RecurrentPolicy, load_policy
from learninghumanoidwalking_tpu_torch.utils.seeding import EnvDraws


class ViewerLoop:
    """Real-time-paced policy -> sim -> sync loop, decoupled from GLFW.

    ``viewer`` needs is_running() -> bool, sync() and optionally user_scn.
    ``paused`` is flipped from outside (the space key's callback); while
    paused the loop advances no physics but keeps syncing, so the camera
    stays live."""

    def __init__(self, control_dt: float, realtime: bool = True, sleep_fn=time.sleep, clock=time.monotonic):
        self.control_dt = float(control_dt)
        self.realtime = realtime
        self.paused = False
        self._sleep = sleep_fn
        self._clock = clock

    def toggle_pause(self):
        self.paused = not self.paused

    def run_episode(self, viewer, step_fn, sync_state_fn, max_steps: int) -> int:
        """Advance up to max_steps control steps; returns the steps taken.
        ``step_fn() -> done`` advances the env one control step,
        ``sync_state_fn()`` mirrors the new state into the window."""
        t = 0
        while t < max_steps and viewer.is_running():
            if self.paused:
                viewer.sync()
                self._sleep(0.05)
                continue
            start = self._clock()
            done = step_fn()
            sync_state_fn()
            viewer.sync()
            t += 1
            if self.realtime:
                leftover = self.control_dt - (self._clock() - start)
                if leftover > 0:
                    self._sleep(leftover)
            if done:
                break
        return t


class PolicyStepper:
    """One env of a loaded run on ``device``: the deterministic policy (a
    recurrent one with its carry) and ``step_batch`` at B=1. Episode ``ep``
    draws from a generator seeded 1000 + ep, as rl/eval.py's episode ep."""

    def __init__(self, policy, env, device):
        self.policy = policy
        self.env = env
        self.device = torch.device(device)
        self.recurrent = isinstance(policy, RecurrentPolicy)

    def reset(self, episode: int) -> None:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(1000 + episode)
        self.draws = EnvDraws([gen])
        self.state = self.env.reset_batch(1, self.draws)
        self.carry = self.policy.init_carry(1) if self.recurrent else None
        self.total = 0.0

    def step(self) -> bool:
        """One control step; returns whether the episode ended."""
        if self.recurrent:
            self.carry, action = self.policy.apply(self.carry, self.state.obs)
        else:
            action = self.policy(self.state.obs)
        self.state = self.env.step_batch(self.state, action, self.draws)
        self.total += float(self.state.reward[0])
        return bool(self.state.done[0])

    def qpos(self) -> np.ndarray:
        return self.state.physics.qpos[0].cpu().numpy()

    def markers(self) -> dict | None:
        render_markers = getattr(self.env, "render_markers", None)
        return render_markers(self.state, 0) if render_markers is not None else None


_NO_DISPLAY = ("no display for the interactive viewer (headless host?). Use "
               "`python -m learninghumanoidwalking_tpu_torch.run_experiment eval --out video.gif` for offscreen rendering.")


def view_policy(path: str | Path, episodes: int = 3, max_steps: int = 400, realtime: bool = True, launch_fn=None,
                device: str | torch.device = "cuda") -> ViewerLoop:
    """Replay the trained policy of ``path`` in a live window: up to
    ``episodes`` episodes of at most ``max_steps`` steps, paced in real
    time unless ``realtime`` is off, space pausing. ``launch_fn()`` opens
    the window (default: mujoco.viewer.launch_passive on the exported
    model)."""
    import mujoco

    from learninghumanoidwalking_tpu_torch.physics.mjcf import export_mjcf
    from learninghumanoidwalking_tpu_torch.rl.render_gl import _draw_markers

    policy, _, (env, _) = load_policy(path, device=device)
    stepper = PolicyStepper(policy, env, device)
    if launch_fn is None:
        try:
            import glfw

            if not glfw.init():  # pragma: no cover - needs a display
                raise RuntimeError("GLFW failed to initialize")
            import mujoco.viewer as mj_viewer
        except Exception as e:  # no glfw, no display, no viewer module: no window
            raise RuntimeError(_NO_DISPLAY) from e

    m = mujoco.MjModel.from_xml_string(export_mjcf(env.spec, with_floor=True, visual=True))
    d = mujoco.MjData(m)
    loop = ViewerLoop(env.control_dt, realtime=realtime)

    def key_callback(key):  # pragma: no cover - needs GLFW
        if key == 32:  # space
            loop.toggle_pause()

    if launch_fn is None:  # pragma: no cover - needs GLFW
        launch_fn = lambda: mj_viewer.launch_passive(m, d, key_callback=key_callback)  # noqa: E731

    def sync_state(viewer):
        d.qpos[:] = stepper.qpos()
        mujoco.mj_forward(m, d)
        scn = getattr(viewer, "user_scn", None)
        if scn is not None:
            scn.ngeom = 0
            mk = stepper.markers()
            if mk:
                _draw_markers(scn, mk)

    try:
        ctx = launch_fn()
    except Exception as e:  # pragma: no cover - needs GLFW
        raise RuntimeError(_NO_DISPLAY) from e

    with ctx as viewer:
        for ep in range(episodes):
            if not viewer.is_running():
                break
            stepper.reset(ep)
            n = loop.run_episode(viewer, stepper.step, lambda: sync_state(viewer), max_steps)
            print(f"episode {ep}: reward {stepper.total:.2f}  length {n}", flush=True)
    return loop
