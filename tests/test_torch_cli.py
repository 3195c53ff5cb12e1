"""The port's command line (learninghumanoidwalking_tpu_torch/run_experiment.py)
on the CPU: train writes a run directory (experiment.json, checkpoints at
each evaluation, best.pt, the log), --continued resumes at the saved
iteration, eval replays a run into an .npz, --imitate distils an h1_walk
expert with a finite imitation loss; the same for a recurrent cartpole run,
whose policy is no imitation expert; cartpole runs its observation-norm
warmup; --device cuda without a card raises; --n-devices, --view and an
--out of .mp4 / .gif (refused until the port had them) as they run now."""

import json
import math

import numpy as np
import pytest
import torch

from learninghumanoidwalking_tpu_torch import run_experiment as cli
from learninghumanoidwalking_tpu_torch.rl.logger import read_log

SMALL = ["--device", "cpu", "--n-itr", "2", "--num-envs", "4", "--rollout-len", "1", "--minibatch-size", "4",
         "--epochs", "1", "--max-traj-len", "2"]


def test_train_continue_and_eval_a_run(tmp_path):
    """One run, then what a user does with it: train writes the run
    directory, --continued resumes at the saved iteration, eval replays it
    into an .npz."""
    logdir = tmp_path / "h1"
    first = cli.train(["--env", "h1", "--logdir", str(logdir), *SMALL])
    run = first["run_dir"]
    assert run.parent == logdir and run.name.startswith("h1-")
    meta = json.loads((run / "experiment.json").read_text())
    assert meta["env"] == "h1" and meta["obs_size"] == 35 and meta["action_size"] == 10 and meta["device"] == "cpu"
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["0.pt", "1.pt", "metrics_0.json", "metrics_1.json"]
    assert (run / "best.pt").exists()
    tags = {r["tag"] for r in read_log(run / "log.jsonl")}
    assert {"Loss/actor", "Train/mean_reward", "Eval/mean_reward", "Time/fps"} <= tags
    assert first["ts"].iteration == 2 and len(first["history"]) == 2
    assert all(math.isfinite(m["actor_loss"]) and math.isfinite(m["eval_mean_reward"]) for m in first["history"])

    out = cli.train(["--env", "h1", "--logdir", str(tmp_path / "cont"), "--continued", str(logdir), *SMALL[:2], "--n-itr", "1",
                     *SMALL[4:]])
    assert out["resumed_from"] == run and out["resumed_at"] == 2
    assert out["ts"].iteration == 3
    assert torch.load(run / "checkpoints" / "1.pt", weights_only=True)["iteration"] == 2

    npz = tmp_path / "traj.npz"
    ev = cli.evaluate(["--path", str(logdir), "--episodes", "2", "--max-steps", "3", "--out", str(npz), "--device", "cpu"])
    data = np.load(npz)
    assert sorted(data.files) == ["episode_0", "episode_1"]
    for i in range(2):
        assert data[f"episode_{i}"].shape == (ev["lengths"][i], 17) and 1 <= ev["lengths"][i] <= 3
        assert np.isfinite(data[f"episode_{i}"]).all()


def test_imitate_logs_a_finite_imitation_loss(tmp_path):
    expert = cli.train(["--env", "h1_walk", "--logdir", str(tmp_path / "expert"), *SMALL[:2], "--n-itr", "1", *SMALL[4:]])
    out = cli.train(["--env", "h1_walk", "--logdir", str(tmp_path / "student"), "--imitate", str(tmp_path / "expert"),
                     "--seed", "1", *SMALL[:2], "--n-itr", "1", *SMALL[4:]])
    assert expert["run_dir"] != out["run_dir"]
    imit = [r["value"] for r in read_log(out["run_dir"] / "log.jsonl") if r["tag"] == "Loss/imitation"]
    assert len(imit) == 1 and math.isfinite(imit[0]) and imit[0] > 0


def test_recurrent_train_continue_and_eval_a_run(tmp_path):
    """train --recurrent on cartpole, --continued on it, eval --path on it;
    load_policy gives a RecurrentPolicy and load_expert refuses it."""
    from learninghumanoidwalking_tpu_torch.rl import eval as rl_eval

    logdir = tmp_path / "rec"
    first = cli.train(["--env", "cartpole", "--recurrent", "--logdir", str(logdir), *SMALL])
    run = first["run_dir"]
    meta = json.loads((run / "experiment.json").read_text())
    assert meta["recurrent"] is True and meta["env"] == "cartpole" and meta["obs_size"] == 5
    ts = first["ts"]
    assert ts.iteration == 2 and ts.actor_carry is not None and ts.actor_carry[0][0].shape == (4, 256)
    assert all(math.isfinite(m["actor_loss"]) and math.isfinite(m["eval_mean_reward"]) for m in first["history"])
    saved = torch.load(run / "checkpoints" / "1.pt", weights_only=True)
    assert "core.cells.1.hh.weight" in saved["actor"] and "actor_carry" not in saved

    out = cli.train(["--env", "cartpole", "--recurrent", "--logdir", str(tmp_path / "cont"), "--continued", str(logdir),
                     *SMALL[:2], "--n-itr", "1", *SMALL[4:]])
    assert out["resumed_from"] == run and out["resumed_at"] == 2 and out["ts"].iteration == 3

    ev = cli.evaluate(["--path", str(logdir), "--episodes", "2", "--max-steps", "3", "--out", str(tmp_path / "t.npz"),
                       "--device", "cpu"])
    assert all(1 <= n <= 3 for n in ev["lengths"]) and all(math.isfinite(r) for r in ev["rewards"])
    policy, _, _ = rl_eval.load_policy(logdir, device="cpu")
    assert isinstance(policy, rl_eval.RecurrentPolicy)
    carry, mean = policy.apply(policy.init_carry(3), torch.zeros(3, 5))
    assert mean.shape == (3, 1) and float(carry[0][1].abs().max()) > 0
    with pytest.raises(ValueError, match="recurrent"):
        rl_eval.load_expert(logdir, device="cpu")


def test_cartpole_runs_the_norm_warmup(tmp_path):
    """Cartpole has no fixed observation statistics: train runs the 5
    warmup iterations first (4 envs x 1 step each into the running norm),
    and the norm stays as it is through training."""
    out = cli.train(["--env", "cartpole", "--logdir", str(tmp_path), *SMALL])
    assert out["ts"].iteration == 2
    assert float(out["ts"].norm.count) == pytest.approx(1e-4 + 5 * 4, rel=1e-6)
    assert all(math.isfinite(m["critic_loss"]) for m in out["history"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where no CUDA device exists")
def test_cuda_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.train(["--env", "h1", "--logdir", str(tmp_path), "--n-itr", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.evaluate(["--path", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # nothing ran


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    """A small jvrc_step run on the CPU, for the eval flags below."""
    logdir = tmp_path_factory.mktemp("step")
    cli.train(["--env", "jvrc_step", "--logdir", str(logdir), *SMALL[:2], "--n-itr", "1", *SMALL[4:]])
    return logdir


@pytest.mark.parametrize("flag", ["n-devices", "view", "mp4", "gif"])
def test_flags_not_ported_raise(flag, step_run, tmp_path, monkeypatch):
    """The four flags the CLI refused before the port had them, as they
    run now: --n-devices 2 trains on two gloo ranks (rank 0 alone writes
    the run: one checkpoint for one iteration), --view hands the run to
    view_policy (its window faked), an .mp4 without an ffmpeg writer raises
    a clear error before anything runs, a .gif holds episode 0's frames."""
    if flag == "n-devices":
        out = cli.train(["--env", "jvrc_walk", "--logdir", str(tmp_path), "--n-devices", "2", *SMALL[:2], "--n-itr", "1",
                         *SMALL[4:]])
        run = out["run_dir"]
        assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["0.pt", "metrics_0.json"]
        assert out["iteration"] == 1 and len(out["history"]) == 1 and math.isfinite(out["history"][0]["eval_mean_reward"])
        assert torch.load(run / "checkpoints" / "0.pt", weights_only=True)["iteration"] == 1
        assert json.loads((run / "experiment.json").read_text())["n_devices"] == 2
        with pytest.raises(ValueError, match="split evenly"):
            cli.train(["--env", "jvrc_walk", "--logdir", str(tmp_path), "--n-devices", "3", *SMALL])
    elif flag == "view":
        from learninghumanoidwalking_tpu_torch.rl import viewer

        seen = {}

        def fake_view(path, episodes, max_steps, realtime, device):
            seen.update(path=path, episodes=episodes, max_steps=max_steps, realtime=realtime, device=str(device))
            return "loop"

        monkeypatch.setattr(viewer, "view_policy", fake_view)
        out = cli.evaluate(["--path", str(step_run), "--view", "--no-realtime", "--episodes", "2", "--max-steps", "5",
                            "--device", "cpu"])
        assert out == {"loop": "loop"}
        assert seen == dict(path=step_run, episodes=2, max_steps=5, realtime=False, device="cpu")
    elif flag == "mp4":
        import importlib.util

        find_spec = importlib.util.find_spec
        monkeypatch.setattr(importlib.util, "find_spec",
                            lambda name, *a: None if name in ("imageio_ffmpeg", "av") else find_spec(name, *a))
        with pytest.raises(RuntimeError, match="no .mp4 writer"):
            cli.evaluate(["--path", str(step_run), "--out", str(tmp_path / "x.mp4"), "--device", "cpu"])
        assert not (tmp_path / "x.mp4").exists()
    else:
        import imageio

        out = cli.evaluate(["--path", str(step_run), "--episodes", "2", "--max-steps", "2", "--out", str(tmp_path / "x.gif"),
                            "--device", "cpu"])
        frames = imageio.mimread(tmp_path / "x.gif")
        assert 1 <= len(frames) <= out["lengths"][0] and len(out["markers"]) == out["lengths"][0]
        assert frames[0].shape[:2] in ((400, 800), (480, 640))  # the stick figure, or the GL renderer's default
        assert out["renderer"] in ("stick figure", "gl")
        assert {"targets", "sequence", "terrain_pos", "floor_z"} <= set(out["markers"][0])


def test_main_usage():
    assert cli.main([]) == 2 and cli.main(["serve"]) == 2
