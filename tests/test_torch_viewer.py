"""The port's live viewer (rl/viewer.py) on the CPU, with the window
replaced by a fake, as the JAX package's tests hold its viewer
(tests/test_evaluation.py): ViewerLoop's pacing and pause; view_policy on
small CPU-trained runs of cartpole, h1 and jvrc_step, whose fake viewer
holds a real MjvScene as its user_scn: one sync a step, the task markers
drawn into it (jvrc_step's targets, plan and boxes; none for cartpole and
h1), and the qpos mirrored into MjData at each step equal to
evaluate_policy's episode 0 from the same seed (1e-5: the same plain
physics at B=1 and B=2).
"""

import contextlib

import numpy as np
import pytest

from learninghumanoidwalking_tpu_torch import run_experiment as cli
from learninghumanoidwalking_tpu_torch.rl import viewer
from learninghumanoidwalking_tpu_torch.rl.eval import evaluate_policy

SMALL = ["--device", "cpu", "--n-itr", "1", "--num-envs", "4", "--rollout-len", "1", "--minibatch-size", "4",
         "--epochs", "1", "--max-traj-len", "2"]


class FakeViewer:
    def __init__(self, scene=None):
        self.syncs = 0
        self.user_scn = scene
        self.ngeoms = []

    def is_running(self):
        return True

    def sync(self):
        self.syncs += 1
        if self.user_scn is not None:
            self.ngeoms.append(self.user_scn.ngeom)


def test_viewer_loop_pacing_and_pause():
    """Real-time pacing with the leftover of control_dt, pause (syncing
    without stepping) and an episode ended by done, on an injected clock."""
    sleeps, t = [], [0.0]

    def sleep(s):
        sleeps.append(s)
        t[0] += s

    loop = viewer.ViewerLoop(control_dt=0.05, realtime=True, sleep_fn=sleep, clock=lambda: t[0])
    v = FakeViewer()

    def step_fn():
        t[0] += 0.01  # the step costs 10 ms of the 50 ms period
        return False

    assert loop.run_episode(v, step_fn, lambda: None, max_steps=4) == 4 and v.syncs == 4
    np.testing.assert_allclose(sleeps, [0.04] * 4, atol=1e-9)

    loop2 = viewer.ViewerLoop(control_dt=0.05, realtime=False, sleep_fn=sleep, clock=lambda: t[0])
    loop2.paused = True
    v2, stepped, calls = FakeViewer(), [0], [0]

    def step2():
        stepped[0] += 1
        return False

    def unpause_after_3(s):
        calls[0] += 1
        if calls[0] == 3:
            loop2.toggle_pause()
        sleep(s)

    loop2._sleep = unpause_after_3
    assert loop2.run_episode(v2, step2, lambda: None, max_steps=2) == 2 and stepped[0] == 2
    assert v2.syncs >= 5  # 3 paused syncs, then 2 live ones

    loop3 = viewer.ViewerLoop(control_dt=0.05, realtime=False, sleep_fn=sleep, clock=lambda: t[0])
    assert loop3.run_episode(FakeViewer(), lambda: True, lambda: None, max_steps=10) == 1


@pytest.mark.parametrize("env_name", ["cartpole", "h1", "jvrc_step"])
def test_view_policy_with_a_fake_viewer(env_name, tmp_path, monkeypatch):
    import mujoco

    cli.train(["--env", env_name, "--logdir", str(tmp_path), *SMALL])
    episodes, steps = 2, 2
    model = mujoco.MjModel.from_xml_string("<mujoco/>")
    fake = FakeViewer(mujoco.MjvScene(model, maxgeom=1000))
    mirrored = []
    mj_forward = mujoco.mj_forward

    def recording_forward(m, d):
        mirrored.append(d.qpos.copy())
        mj_forward(m, d)

    monkeypatch.setattr(mujoco, "mj_forward", recording_forward)

    @contextlib.contextmanager
    def launch():
        yield fake

    loop = viewer.view_policy(tmp_path, episodes=episodes, max_steps=steps, realtime=False, launch_fn=launch, device="cpu")
    monkeypatch.undo()
    ev = evaluate_policy(tmp_path, episodes=episodes, max_steps=steps, device="cpu")
    lengths = ev["lengths"]
    assert fake.syncs == sum(lengths) and loop.control_dt > 0
    np.testing.assert_allclose(np.stack(mirrored[: lengths[0]]), ev["trajectories"][0], rtol=0, atol=1e-5)
    if env_name == "jvrc_step":
        assert min(fake.ngeoms) > 4  # boxes, plan, both targets and their ticks
    else:
        assert max(fake.ngeoms) == 0


def test_view_policy_without_a_display_points_at_the_video(tmp_path, monkeypatch):
    cli.train(["--env", "cartpole", "--logdir", str(tmp_path), *SMALL])
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.raises(RuntimeError, match="eval --out"):
        viewer.view_policy(tmp_path, episodes=1, max_steps=1, device="cpu")
