"""Standalone action distributions (counterpart of learninghumanoidwalking_tpu/rl/distributions.py).

Kept, as in the JAX package, for experimentation: the shipped actors inline
their own Gaussian (rl/networks.py). Samples come from an explicit
``torch.Generator``; the JAX streams cannot be reproduced, so tests compare
samples by distribution.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class DiagonalGaussian:
    """Fixed-std diagonal Gaussian over unbounded actions."""

    def __init__(self, mean: torch.Tensor, std: torch.Tensor):
        self.mean = mean
        self.std = torch.as_tensor(std, dtype=mean.dtype, device=mean.device).expand(mean.shape)

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        return self.mean + self.std * torch.randn(self.mean.shape, generator=gen, device=self.mean.device)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.mean) / self.std
        return torch.sum(-0.5 * z**2 - torch.log(self.std) - 0.5 * math.log(2 * math.pi), dim=-1)

    def entropy(self) -> torch.Tensor:
        return torch.sum(torch.log(self.std) + 0.5 * math.log(2 * math.pi * math.e), dim=-1)


def _standard_gamma(alpha: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Gamma(alpha, 1) draws by Marsaglia and Tsang's rejection method, with
    alpha < 1 boosted through Gamma(alpha + 1) U^(1 / alpha)."""
    small = alpha < 1.0
    a = torch.where(small, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    pending = torch.ones_like(a, dtype=torch.bool)
    while bool(pending.any()):
        x = torch.randn(a.shape, generator=gen, device=a.device, dtype=a.dtype)
        u = torch.rand(a.shape, generator=gen, device=a.device, dtype=a.dtype)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(torch.clamp_min(v, 1e-30)))
        take = pending & ok
        out = torch.where(take, d * v, out)
        pending = pending & ~ok
    u = torch.rand(a.shape, generator=gen, device=a.device, dtype=a.dtype)
    return torch.where(small, out * u ** (1.0 / alpha), out)


class Beta:
    """Beta(alpha, beta) over (0, 1); ``from_logits`` takes softplus(logits) + 1."""

    def __init__(self, alpha: torch.Tensor, beta: torch.Tensor):
        self.alpha = alpha
        self.beta = beta

    @staticmethod
    def from_logits(alpha_logits, beta_logits) -> "Beta":
        return Beta(F.softplus(alpha_logits) + 1.0, F.softplus(beta_logits) + 1.0)

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        alpha, beta = torch.broadcast_tensors(self.alpha, self.beta)
        x = _standard_gamma(alpha, gen)
        y = _standard_gamma(beta, gen)
        return x / (x + y)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.clamp(x, 1e-6, 1 - 1e-6)
        betaln = torch.lgamma(self.alpha) + torch.lgamma(self.beta) - torch.lgamma(self.alpha + self.beta)
        lp = (self.alpha - 1) * torch.log(x) + (self.beta - 1) * torch.log1p(-x) - betaln
        return torch.sum(lp, dim=-1)

    def mean(self) -> torch.Tensor:
        return self.alpha / (self.alpha + self.beta)


class BoundedBeta(Beta):
    """Beta rescaled to [-1, 1]."""

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        return 2.0 * super().sample(gen) - 1.0

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return super().log_prob((x + 1.0) / 2.0)

    def mean(self) -> torch.Tensor:
        return 2.0 * super().mean() - 1.0
