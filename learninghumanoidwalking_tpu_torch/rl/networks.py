"""Actor / critic networks as nn.Modules (counterpart of learninghumanoidwalking_tpu/rl/networks.py).

Feed-forward: a ReLU trunk (2x256 by default) with a Gaussian mean head
(fixed or learned log-std, init std 0.223) and a scalar value head,
column-normalized gaussian init with output layers scaled x0.01. ``dtype``
sets the compute precision of the hidden matmuls (bfloat16 on the card);
parameters and the output heads stay float32.

Recurrent: a stack of LSTM cells (2x256 by default) with an explicit carry,
a tuple of (c, h) per layer, under the same heads. The cell is flax's
OptimizedLSTMCell: gates i, f, g, o from input kernels without bias and
hidden kernels with bias, c' = sigmoid(f) c + sigmoid(i) tanh(g),
h' = sigmoid(o) tanh(c'); input kernels lecun-normal, hidden kernels
orthogonal, biases zero. It runs in float32 (the JAX LSTM has no dtype).

Weight layout: nn.Linear.weight is (out, in); the JAX package's flax Dense
kernel is (in, out). The LSTM cell keeps its four gates' kernels stacked
(i, f, g, o) in one input and one hidden weight of 4 x hidden rows.
rl/convert.py carries weights across.
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


def _lecun_normal_(weight: torch.Tensor, gen: torch.Generator | None) -> None:
    """flax's lecun_normal: truncated normal (2 std) of variance 1 / fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class LSTMCell(nn.Module):
    """One LSTM layer; ``forward(carry, x) -> (carry, h)`` with carry (c, h)."""

    def __init__(self, in_dim: int, hidden: int, gen=None):
        super().__init__()
        self.ih = nn.Linear(in_dim, 4 * hidden, bias=False)
        self.hh = nn.Linear(hidden, 4 * hidden)
        for k in range(4):  # each gate's kernel is drawn on its own, as in flax
            _lecun_normal_(self.ih.weight[k * hidden : (k + 1) * hidden], gen)
            with torch.no_grad():
                nn.init.orthogonal_(self.hh.weight[k * hidden : (k + 1) * hidden], generator=gen)
        nn.init.zeros_(self.hh.bias)

    def forward(self, carry, x):
        c, h = carry
        gates = F.linear(h, self.hh.weight, self.hh.bias) + F.linear(x, self.ih.weight)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class LSTMCore(nn.Module):
    """Stacked LSTM cells with an explicit carry: a tuple of (c, h) per layer."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (256, 256), gen=None):
        super().__init__()
        dims = [in_dim, *hidden]
        self.cells = nn.ModuleList(LSTMCell(a, b, gen) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, carry, x):
        new_carry = []
        for cell, layer_carry in zip(self.cells, carry):
            layer_carry, x = cell(layer_carry, x)
            new_carry.append(layer_carry)
        return tuple(new_carry), x

    @staticmethod
    def initial_carry(hidden: Sequence[int], batch_shape: tuple = (), device=None):
        return tuple(
            (torch.zeros(batch_shape + (h,), device=device), torch.zeros(batch_shape + (h,), device=device))
            for h in hidden
        )


class GaussianLSTMActor(nn.Module):
    """Recurrent Gaussian actor: ``forward(carry, obs) -> (carry, (mean, log_std))``."""

    def __init__(self, obs_dim: int, action_dim: int, hidden=(256, 256), init_std: float = 0.223,
                 learn_std: bool = False, gen=None):
        super().__init__()
        self.core = LSTMCore(obs_dim, hidden, gen)
        self.mean = nn.Linear(hidden[-1], action_dim)
        normc_(self.mean.weight, 0.01, gen)
        nn.init.zeros_(self.mean.bias)
        log_std = torch.full((action_dim,), math.log(init_std))
        if learn_std:
            self.log_std = nn.Parameter(log_std)
        else:
            self.register_buffer("log_std", log_std)

    def forward(self, carry, obs):
        carry, x = self.core(carry, obs)
        mean = self.mean(x)
        return carry, (mean, self.log_std.expand(mean.shape))


class LSTMCritic(nn.Module):
    """Recurrent value function: ``forward(carry, obs) -> (carry, values)``."""

    def __init__(self, obs_dim: int, hidden=(256, 256), gen=None):
        super().__init__()
        self.core = LSTMCore(obs_dim, hidden, gen)
        self.value = nn.Linear(hidden[-1], 1)
        normc_(self.value.weight, 0.01, gen)
        nn.init.zeros_(self.value.bias)

    def forward(self, carry, obs):
        carry, x = self.core(carry, obs)
        return carry, self.value(x)[..., 0]


def gaussian_logp(mean, log_std, action):
    std = torch.exp(log_std)
    z = (action - mean) / std
    return torch.sum(-0.5 * z**2 - log_std - 0.5 * math.log(2 * math.pi), dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)
