"""Actor / critic networks as nn.Modules (counterpart of learninghumanoidwalking_tpu/rl/networks.py).

Feed-forward path only: a ReLU trunk (2x256 by default) with a Gaussian mean
head (fixed or learned log-std, init std 0.223) and a scalar value head,
column-normalized gaussian init with output layers scaled x0.01. ``dtype``
sets the compute precision of the hidden matmuls (bfloat16 on the card);
parameters and the output heads stay float32.

Weight layout: nn.Linear.weight is (out, in); the JAX package's flax Dense
kernel is (in, out). rl/convert.py carries weights across.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def normc_(weight: torch.Tensor, scale: float, gen: torch.Generator | None) -> None:
    """Column-normalized gaussian init: each output unit's input weights
    have norm ``scale`` (flax kernel columns = torch weight rows)."""
    with torch.no_grad():
        w = torch.randn(weight.shape, generator=gen, device=weight.device)
        w = w / torch.sqrt(torch.sum(w * w, dim=1, keepdim=True))
        weight.copy_(w * scale)


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class MLPTrunk(nn.Module):
    """ReLU trunk; hidden matmuls run in ``dtype``."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (256, 256), dtype=torch.float32, gen=None):
        super().__init__()
        dims = [in_dim, *hidden]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.dtype = dtype
        for layer in self.layers:
            normc_(layer.weight, 1.0, gen)
            nn.init.zeros_(layer.bias)

    def forward(self, x):
        for layer in self.layers:
            x = torch.relu(_linear(layer, x, self.dtype))
        return x


class GaussianActor(nn.Module):
    """FF Gaussian actor: (mean, log_std), each (..., action_dim)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(256, 256), init_std: float = 0.223,
                 learn_std: bool = False, dtype=torch.float32, gen=None):
        super().__init__()
        self.trunk = MLPTrunk(obs_dim, hidden, dtype, gen)
        self.mean = nn.Linear(hidden[-1], action_dim)
        normc_(self.mean.weight, 0.01, gen)
        nn.init.zeros_(self.mean.bias)
        log_std = torch.full((action_dim,), math.log(init_std))
        if learn_std:
            self.log_std = nn.Parameter(log_std)
        else:
            self.register_buffer("log_std", log_std)

    def forward(self, obs):
        x = self.trunk(obs)
        mean = _linear(self.mean, x, torch.float32)
        return mean, self.log_std.expand(mean.shape)


class Critic(nn.Module):
    """FF value function: (...,) values."""

    def __init__(self, obs_dim: int, hidden=(256, 256), dtype=torch.float32, gen=None):
        super().__init__()
        self.trunk = MLPTrunk(obs_dim, hidden, dtype, gen)
        self.value = nn.Linear(hidden[-1], 1)
        normc_(self.value.weight, 0.01, gen)
        nn.init.zeros_(self.value.bias)

    def forward(self, obs):
        return _linear(self.value, self.trunk(obs), torch.float32)[..., 0]


def gaussian_logp(mean, log_std, action):
    std = torch.exp(log_std)
    z = (action - mean) / std
    return torch.sum(-0.5 * z**2 - log_std - 0.5 * math.log(2 * math.pi), dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)
