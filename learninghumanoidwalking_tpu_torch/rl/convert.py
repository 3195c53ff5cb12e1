"""Carry the JAX package's actor / critic parameters, RunningNorm
statistics and motor-net parameters into the port.

The JAX params arrive as numpy arrays flattened from flax's nested dict,
keyed by "/"-joined paths such as ``params/MLPTrunk_0/Dense_1/kernel``.
Flax Dense stores ``kernel`` as (in, out); nn.Linear.weight is (out, in), so
every kernel is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.rl.normalize import RunningNorm


def flatten_params(tree, prefix: str = "") -> dict:
    """Nested dict of arrays -> {"a/b/c": np.ndarray}."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(flatten_params(value, path))
        else:
            out[path] = np.array(value)
    return out


def _dense(flat: dict, path: str, prefix: str) -> dict:
    return {
        f"{prefix}.weight": torch.as_tensor(np.ascontiguousarray(flat[f"{path}/kernel"].T), dtype=torch.float32),
        f"{prefix}.bias": torch.as_tensor(flat[f"{path}/bias"], dtype=torch.float32),
    }


def _trunk(flat: dict, n_hidden: int) -> dict:
    out = {}
    for i in range(n_hidden):
        out.update(_dense(flat, f"params/MLPTrunk_0/Dense_{i}", f"trunk.layers.{i}"))
    return out


def _n_hidden(flat: dict) -> int:
    return len({k.split("/")[2] for k in flat if k.startswith("params/MLPTrunk_0/")})


def actor_state_dict(flat: dict, action_dim: int, init_std: float = 0.223) -> dict:
    """State dict for networks.GaussianActor from flattened flax params."""
    out = _trunk(flat, _n_hidden(flat))
    out.update(_dense(flat, "params/Dense_0", "mean"))
    if "params/log_std" in flat:
        out["log_std"] = torch.as_tensor(flat["params/log_std"], dtype=torch.float32)
    else:
        out["log_std"] = torch.full((action_dim,), float(np.log(np.float32(init_std))), dtype=torch.float32)
    return out


def critic_state_dict(flat: dict) -> dict:
    """State dict for networks.Critic from flattened flax params."""
    out = _trunk(flat, _n_hidden(flat))
    out.update(_dense(flat, "params/Dense_0", "value"))
    return out


def running_norm(mean, var, count, device="cpu") -> RunningNorm:
    """RunningNorm from the JAX package's (mean, var, count) statistics."""
    as_t = lambda x: torch.as_tensor(np.array(x, np.float32), device=device)
    return RunningNorm(mean=as_t(mean), var=as_t(var), count=as_t(count))


def motor_params(np_params: dict, device="cpu") -> dict:
    """The JAX package's motor-net params (robots/motor.py init_motor_params
    or an .npz: w{l} (nu, d_in, d_out), b{l} (nu, d_out), skip (nu,),
    n_layers), as numpy arrays, -> the port's robots/motor.py params. The
    layouts are the same, so nothing is transposed."""
    out = {k: torch.as_tensor(np.array(v, np.float32), device=device) for k, v in np_params.items() if k != "n_layers"}
    out["n_layers"] = int(np_params["n_layers"])
    return out
