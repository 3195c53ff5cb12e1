"""The port's command line (learninghumanoidwalking_tpu_torch/run_experiment.py)
on the CPU: train writes a run directory (experiment.json, checkpoints at
each evaluation, best.pt, the log), --continued resumes at the saved
iteration, eval replays a run into an .npz, --imitate distils an h1_walk
expert with a finite imitation loss; --device cuda without a card and the
flags that are not ported raise."""

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


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where no CUDA device exists")
def test_cuda_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.train(["--env", "h1", "--logdir", str(tmp_path), "--n-itr", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.evaluate(["--path", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # nothing ran


@pytest.mark.parametrize("argv", [
    ["train", "--env", "h1", "--recurrent"],
    ["train", "--env", "h1", "--n-devices", "2"],
    ["eval", "--path", "x", "--view"],
    ["eval", "--path", "x", "--out", "x.mp4"],
    ["eval", "--path", "x", "--out", "x.gif"],
], ids=["recurrent", "n-devices", "view", "mp4", "gif"])
def test_flags_not_ported_raise(argv, tmp_path):
    fn = cli.train if argv[0] == "train" else cli.evaluate
    rest = argv[1:] + (["--logdir", str(tmp_path)] if argv[0] == "train" else [])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fn(rest + ["--device", "cpu"])


def test_main_usage():
    assert cli.main([]) == 2 and cli.main(["serve"]) == 2
