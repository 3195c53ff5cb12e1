"""Training logger (counterpart of learninghumanoidwalking_tpu/rl/logger.py).

The same tag inventory as the JAX logger (Loss/*, Train/*, Eval/*, Time/*),
written as scalar records in JSON lines under the run directory
(``log.jsonl``, one ``{"step", "tag", "value", "wall_time"}`` object a
line). The JAX package writes TensorBoard event files through
tensorboardX, which the port does not use.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

# metrics key -> tag, as the JAX logger's tag_map
TRAINING_TAGS = {
    "actor_loss": "Loss/actor",
    "critic_loss": "Loss/critic",
    "mirror_loss": "Loss/mirror",
    "imitation_loss": "Loss/imitation",
    "entropy": "Loss/entropy",
    "approx_kl": "Loss/approx_kl",
    "clip_fraction": "Loss/clip_fraction",
    "mean_reward": "Train/mean_reward",
    "episode_reward": "Train/mean_episode_reward",
    "mean_episode_length": "Train/mean_episode_length",
    "mean_noise_std": "Train/mean_noise_std",
    "episodes_finished": "Train/episodes_finished",
}
EVAL_TAGS = {"eval_mean_reward": "Eval/mean_reward", "eval_mean_episode_length": "Eval/mean_episode_length"}
TIMING_TAGS = ("Time/fps", "Time/sample_time", "Time/optimize_time", "Time/total_elapsed")


class TrainingLogger:
    def __init__(self, logdir: str | Path):
        self.path = Path(logdir) / "log.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(self.path, "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        record = dict(step=int(step), tag=tag, value=float(value), wall_time=time.time())
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def log_training(self, itr: int, metrics: dict) -> None:
        for key, tag in TRAINING_TAGS.items():
            if key in metrics:
                self.add_scalar(tag, metrics[key], itr)

    def log_eval(self, itr: int, metrics: dict) -> None:
        for key, tag in EVAL_TAGS.items():
            self.add_scalar(tag, metrics[key], itr)

    def log_timing(self, itr: int, fps: float, sample_time: float, optimize_time: float, total_elapsed: float) -> None:
        for tag, value in zip(TIMING_TAGS, (fps, sample_time, optimize_time, total_elapsed)):
            self.add_scalar(tag, value, itr)

    def close(self) -> None:
        self._file.close()


def read_log(path: str | Path) -> list[dict]:
    """The records of a log.jsonl as dicts (step, tag, value, wall_time)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
