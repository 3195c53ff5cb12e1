"""Running observation normalization with the Welford parallel merge
(counterpart of learninghumanoidwalking_tpu/rl/normalize.py)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RunningNorm:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # ()

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(torch.clamp_min(self.var, 1e-8))

    def normalize(self, obs: torch.Tensor) -> torch.Tensor:
        return (obs - self.mean) / self.std


def init_norm(shape, mean=None, std=None, device="cuda") -> RunningNorm:
    if mean is not None:
        std_t = torch.as_tensor(std, dtype=torch.float32, device=device)
        return RunningNorm(
            mean=torch.as_tensor(mean, dtype=torch.float32, device=device),
            var=torch.square(std_t),
            count=torch.tensor(1e8, device=device),  # effectively frozen
        )
    return RunningNorm(
        mean=torch.zeros(shape, device=device),
        var=torch.ones(shape, device=device),
        count=torch.tensor(1e-4, device=device),
    )


def update_norm(norm: RunningNorm, batch: torch.Tensor) -> RunningNorm:
    """Welford parallel merge of the batch moments into the running ones."""
    batch = batch.reshape(-1, batch.shape[-1])
    b_mean = torch.mean(batch, dim=0)
    b_var = torch.var(batch, dim=0, unbiased=False)
    b_count = batch.shape[0]

    delta = b_mean - norm.mean
    tot = norm.count + b_count
    new_mean = norm.mean + delta * b_count / tot
    m_a = norm.var * norm.count
    m_b = b_var * b_count
    m2 = m_a + m_b + torch.square(delta) * norm.count * b_count / tot
    return RunningNorm(mean=new_mean, var=m2 / tot, count=tot)
