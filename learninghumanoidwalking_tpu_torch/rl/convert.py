"""Carry the JAX package's actor / critic parameters (feed-forward and
LSTM), RunningNorm statistics, motor-net parameters and whole checkpoints
into the port.

The JAX params arrive as numpy arrays flattened from flax's nested dict,
keyed by "/"-joined paths such as ``params/MLPTrunk_0/Dense_1/kernel``.
Flax Dense stores ``kernel`` as (in, out); nn.Linear.weight is (out, in), so
every kernel is transposed (Adam's moments too, which have the params'
layout). A flax OptimizedLSTMCell keeps one kernel per gate
(``LSTMCore_0/lstm<i>/{ii,if,ig,io}`` on the input, without bias,
``{hi,hf,hg,ho}`` on the hidden state, with bias); the port stacks them in
gate order i, f, g, o.
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


_GATES = "ifgo"
_LSTM = "params/LSTMCore_0/"


def _is_lstm(flat: dict) -> bool:
    return any(k.startswith(_LSTM) for k in flat)


def _lstm_core(flat: dict) -> dict:
    """networks.LSTMCore's weights, prefixed ``core.``, from flax's per-gate kernels."""
    out = {}
    n_layers = len({k.split("/")[2] for k in flat if k.startswith(_LSTM)})
    for i in range(n_layers):
        cell = f"{_LSTM}lstm{i}/"
        stack = lambda kind, leaf: np.concatenate([flat[f"{cell}{kind}{g}/{leaf}"] for g in _GATES], axis=-1)
        out[f"core.cells.{i}.ih.weight"] = torch.as_tensor(np.ascontiguousarray(stack("i", "kernel").T), dtype=torch.float32)
        out[f"core.cells.{i}.hh.weight"] = torch.as_tensor(np.ascontiguousarray(stack("h", "kernel").T), dtype=torch.float32)
        out[f"core.cells.{i}.hh.bias"] = torch.as_tensor(stack("h", "bias"), dtype=torch.float32)
    return out


def actor_state_dict(flat: dict, action_dim: int, init_std: float = 0.223) -> dict:
    """State dict for networks.GaussianActor, or networks.GaussianLSTMActor
    where the flax params hold an LSTM core, from flattened flax params."""
    out = _lstm_core(flat) if _is_lstm(flat) else _trunk(flat, _n_hidden(flat))
    out.update(_dense(flat, "params/Dense_0", "mean"))
    if "params/log_std" in flat:
        out["log_std"] = torch.as_tensor(flat["params/log_std"], dtype=torch.float32)
    else:
        out["log_std"] = torch.full((action_dim,), float(np.log(np.float32(init_std))), dtype=torch.float32)
    return out


def critic_state_dict(flat: dict) -> dict:
    """State dict for networks.Critic, or networks.LSTMCritic where the
    flax params hold an LSTM core, from flattened flax params."""
    out = _lstm_core(flat) if _is_lstm(flat) else _trunk(flat, _n_hidden(flat))
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


def _adam_from_optax(opt_state, to_state_dict) -> dict:
    """An Adam state for rl/checkpoint.py from an optax state built as the
    JAX trainer builds it, apply_if_finite(chain(clip_by_global_norm,
    adam)): its Adam moments (keyed and laid out as the state_dict),
    count and notfinite_count."""
    adam = opt_state.inner_state[1][0]
    flat_mu, flat_nu = flatten_params(adam.mu), flatten_params(adam.nu)
    # a fixed log_std (no params/log_std) is a buffer, with no moments
    keep = lambda sd, flat: {k: v for k, v in sd.items() if k != "log_std" or "params/log_std" in flat}
    return dict(
        mu=keep(to_state_dict(flat_mu), flat_mu),
        nu=keep(to_state_dict(flat_nu), flat_nu),
        count=torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32),
        notfinite_count=torch.tensor(int(np.asarray(opt_state.notfinite_count)), dtype=torch.int32),
    )


def checkpoint_from_jax(tree: dict, action_dim: int, init_std: float = 0.223) -> dict:
    """A port checkpoint (rl/checkpoint.py's persisted state) from the JAX
    Checkpointer's persisted tree, fetched as numpy by the caller:
    ``actor_params`` / ``critic_params`` (flax), ``actor_opt`` /
    ``critic_opt`` (optax apply_if_finite states: Adam's mu, nu and count,
    and notfinite_count), ``norm`` (mean, var, count) and ``iteration``.
    The JAX PRNG key has no torch counterpart: the checkpoint keeps no
    generator state, and a trainer restoring it keeps its own generator.
    A recurrent run's tree converts the same way (its LSTM params and their
    Adam moments); its carries are not in it, as in the JAX package."""
    to_actor = lambda flat: actor_state_dict(flat, action_dim, init_std)
    norm = tree["norm"]
    return dict(
        actor=to_actor(flatten_params(tree["actor_params"])),
        critic=critic_state_dict(flatten_params(tree["critic_params"])),
        actor_opt=_adam_from_optax(tree["actor_opt"], to_actor),
        critic_opt=_adam_from_optax(tree["critic_opt"], critic_state_dict),
        norm={k: torch.as_tensor(np.array(getattr(norm, k), np.float32)) for k in ("mean", "var", "count")},
        generator=None,
        iteration=int(np.asarray(tree["iteration"])),
    )
