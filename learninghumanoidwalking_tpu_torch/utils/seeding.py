"""Seeding utilities (counterpart of learninghumanoidwalking_tpu/utils/seeding.py).

JAX threads randomness through explicit PRNG keys; the port threads it
through explicit ``torch.Generator`` objects. The two streams differ, so
parity tests inject the same draws into both packages instead.
"""

from __future__ import annotations

import numpy as np
import torch


class Draws:
    """Source of every random number an env or the trainer consumes.

    Each draw is named (e.g. ``"task.phase"``), so a caller can replace the
    generator with fixed values: ``InjectedDraws`` returns the values it was
    given by name. Parity tests use that to feed the port the same draws the
    JAX package derives from its PRNG keys."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def uniform(self, name: str, shape, lo: float, hi: float, device) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(shape, generator=self.gen, device=device)

    def randint(self, name: str, shape, lo: int, hi: int, device) -> torch.Tensor:
        return torch.randint(lo, hi, shape, generator=self.gen, device=device)

    def normal(self, name: str, shape, device) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=device)

    def choice(self, name: str, shape, values, p, device) -> torch.Tensor:
        probs = torch.as_tensor(p, dtype=torch.float32, device=device)
        idx = torch.multinomial(probs, int(np.prod(shape)), replacement=True, generator=self.gen)
        return torch.as_tensor(values, device=device)[idx].reshape(shape)

    def permutation(self, name: str, n: int, device) -> torch.Tensor:
        return torch.randperm(n, generator=self.gen, device=device)


class HostDraws(Draws):
    """Draws from a generator on the CPU, moved to the device asked for: a
    seed gives the same numbers on the card as on the CPU (a CUDA
    generator's stream is another), as a JAX key does on any backend.
    Checks of the card against the CPU draw so."""

    def uniform(self, name, shape, lo, hi, device):
        return super().uniform(name, shape, lo, hi, "cpu").to(device)

    def randint(self, name, shape, lo, hi, device):
        return super().randint(name, shape, lo, hi, "cpu").to(device)

    def normal(self, name, shape, device):
        return super().normal(name, shape, "cpu").to(device)

    def choice(self, name, shape, values, p, device):
        return super().choice(name, shape, values, p, "cpu").to(device)

    def permutation(self, name, n, device):
        return super().permutation(name, n, "cpu").to(device)


class InjectedDraws(Draws):
    """Draws fixed in advance, looked up by name (shape-checked)."""

    def __init__(self, values: dict):
        self.values = values

    def _get(self, name: str, shape, device) -> torch.Tensor:
        if name not in self.values:
            raise KeyError(f"no injected draw named {name!r}")
        x = torch.as_tensor(np.array(self.values[name]), device=device)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"injected draw {name!r} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        return x

    def uniform(self, name, shape, lo, hi, device):
        return self._get(name, shape, device).to(torch.float32)

    def randint(self, name, shape, lo, hi, device):
        return self._get(name, shape, device).to(torch.int64)

    def normal(self, name, shape, device):
        return self._get(name, shape, device).to(torch.float32)

    def choice(self, name, shape, values, p, device):
        return self._get(name, shape, device).to(torch.int64)

    def permutation(self, name, n, device):
        return self._get(name, (n,), device).to(torch.int64)


class EnvDraws(Draws):
    """One generator per env: row i of every draw (leading axis the batch)
    comes from generator i, so that env i's numbers do not depend on the
    batch it runs in (rl/eval.py seeds episode i with 1000 + i)."""

    def __init__(self, gens: list):
        self.gens = gens

    def _rows(self, shape, fn) -> torch.Tensor:
        if shape[0] != len(self.gens):
            raise ValueError(f"a draw of shape {tuple(shape)} for {len(self.gens)} envs")
        return torch.stack([fn(tuple(shape[1:]), g) for g in self.gens])

    def uniform(self, name, shape, lo, hi, device):
        return self._rows(shape, lambda s, g: lo + (hi - lo) * torch.rand(s, generator=g, device=device))

    def randint(self, name, shape, lo, hi, device):
        return self._rows(shape, lambda s, g: torch.randint(lo, hi, s, generator=g, device=device))

    def normal(self, name, shape, device):
        return self._rows(shape, lambda s, g: torch.randn(s, generator=g, device=device))

    def choice(self, name, shape, values, p, device):
        probs = torch.as_tensor(p, dtype=torch.float32, device=device)
        vals = torch.as_tensor(values, device=device)
        return self._rows(shape, lambda s, g: vals[torch.multinomial(probs, max(1, int(np.prod(s))), replacement=True, generator=g)].reshape(s))

    def permutation(self, name, n, device):
        raise NotImplementedError("EnvDraws draws per env; a permutation is not per env")
