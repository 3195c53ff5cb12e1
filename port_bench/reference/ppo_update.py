"""Plain reference of the PPO nets, their loss and Adam (written for the benchmark).

It follows the reference's rl/ppo.py and rl/policies as the port states them:
a ReLU trunk, a Gaussian mean head with a fixed log-std and a scalar value
head; the clipped surrogate, the value MSE, the entropy bonus and the mirror
loss; per net, global-norm clipping then Adam. Every product runs in float32
with TF32 off (``precision="float32"``). ``precision="fp8"`` is the control:
the hidden matmuls' operands rounded to float8 (e4m3, one scale per tensor),
the step below the configuration's bfloat16. ``half_batch`` is a planted
fault: each loss term a mean over the first half of the minibatch only.

Parameters are plain tensors in a dict per net: ``w{i}``/``b{i}`` for the
trunk's layers and ``head_w``/``head_b`` for the output layer (weights
(out, in), as torch.nn.Linear keeps them).

A configuration names its nets' reference module (``reference.nets``);
each such module gives ``leaf_name``, ``init_weights``, ``run_steps``,
``rollout_outputs`` and ``gae`` as this one does.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def leaf_name(param: str) -> str:
    """The program's parameter name (trunk.layers.{i}.weight, mean.bias,
    value.weight, ...) -> the leaf name here (w{i}, b{i}, head_w, head_b)."""
    parts = param.split(".")
    if parts[0] == "trunk":
        return ("w" if parts[3] == "weight" else "b") + parts[2]
    return "head_w" if parts[1] == "weight" else "head_b"


def init_weights(obs: int, act: int, hidden: list[int], gen: torch.Generator, device) -> dict:
    """Both nets' weights drawn from ``gen`` on ``device`` in one call:
    row-normalized gaussian rows (norm 1 in the trunk, 0.01 in the heads),
    zero biases. {"actor": leaves, "critic": leaves}."""
    shapes = {}
    for net, out in (("actor", act), ("critic", 1)):
        dims = [obs, *hidden]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            shapes[(net, f"w{i}")] = (b, a)
        shapes[(net, "head_w")] = (out, hidden[-1])
    flat = torch.randn(sum(r * c for r, c in shapes.values()), generator=gen, device=device)
    out, at = {"actor": {}, "critic": {}}, 0
    for (net, leaf), (r, c) in shapes.items():
        w = flat[at: at + r * c].reshape(r, c)
        at += r * c
        scale = 0.01 if leaf == "head_w" else 1.0
        out[net][leaf] = w / torch.sqrt(torch.sum(w * w, dim=1, keepdim=True)) * scale
        bias = "head_b" if leaf == "head_w" else "b" + leaf[1:]
        out[net][bias] = torch.zeros(r, device=device)
    return out


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()  # rounded forward value, plain gradient


def _matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        x, w = _round_fp8(x), _round_fp8(w)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w.t() + b


def forward(params: dict, obs: torch.Tensor, n_hidden: int, precision: str = "float32") -> torch.Tensor:
    x = obs
    for i in range(n_hidden):
        x = torch.relu(_matmul(x, params[f"w{i}"], params[f"b{i}"], precision))
    return x @ params["head_w"].t() + params["head_b"]


def gaussian_logp(mean, log_std, action):
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z**2 - log_std - 0.5 * math.log(2 * math.pi), dim=-1)


def normalize(obs: torch.Tensor, norm: dict) -> torch.Tensor:
    return (obs - norm["mean"]) / norm["std"]


def loss(actor: dict, critic: dict, mb: tuple, setup: dict, precision: str = "float32",
         half_batch: bool = False) -> tuple[torch.Tensor, dict]:
    """The minibatch loss and its terms. ``mb``: (obs, actions, old log
    probs, advantages, returns); ``setup``: n_hidden, log_std, norm, obs and
    action mirror matrices, and the ppo coefficients."""
    obs, actions, old_logp, adv, returns = mb
    if half_batch:
        half = obs.shape[0] // 2
        obs, actions, old_logp, adv, returns = obs[:half], actions[:half], old_logp[:half], adv[:half], returns[:half]
    n_hidden, ppo = setup["n_hidden"], setup["ppo"]
    log_std = setup["log_std"].expand(obs.shape[0], -1)
    nobs = normalize(obs, setup["norm"])
    mean = forward(actor, nobs, n_hidden, precision)
    values = forward(critic, nobs, n_hidden, precision)[:, 0]
    logp = gaussian_logp(mean, log_std, actions)
    ratio = torch.exp(logp - old_logp)
    surr = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - ppo["clip"], 1 + ppo["clip"]) * adv)
    terms = {"actor_loss": -surr.mean(), "critic_loss": torch.square(returns - values).mean(),
             "entropy": torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1).mean()}
    total = terms["actor_loss"] + terms["critic_loss"] - ppo["entropy_coeff"] * terms["entropy"]
    if ppo["use_mirror"]:
        mir = forward(actor, normalize(obs @ setup["obs_mirror"].t(), setup["norm"]), n_hidden, precision)
        terms["mirror_loss"] = torch.square(mean - mir @ setup["act_mirror"].t()).mean()
        total = total + ppo["mirror_coeff"] * terms["mirror_loss"]
    return total, terms


class Adam:
    """Global-norm clipping then Adam over one net's leaves (b1 0.9, b2 0.999),
    from ``state`` (moments ``mu``, ``nu`` by leaf and the step ``count``)
    or, without it, from zero moments at step 0."""

    def __init__(self, params: dict, lr: float, eps: float, max_norm: float, state: dict | None = None):
        self.lr, self.eps, self.max_norm = lr, eps, max_norm
        if state is None:
            self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.count = 0
        else:
            self.mu, self.nu, self.count = dict(state["mu"]), dict(state["nu"]), int(state["count"])
        self.clipped = None  # the last gradient as Adam used it, after clipping

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        self.clipped = {k: g * scale for k, g in grads.items()}
        self.count += 1
        bc1, bc2 = 1 - 0.9**self.count, 1 - 0.999**self.count
        out = {}
        for k, g in self.clipped.items():
            self.mu[k] = 0.9 * self.mu[k] + 0.1 * g
            self.nu[k] = 0.999 * self.nu[k] + 0.001 * g * g
            out[k] = params[k] - self.lr * (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
        return out


def run_steps(actor0: dict, critic0: dict, minibatches: list, setup: dict, precision: str = "float32",
              half_batch: bool = False, adam: dict | None = None) -> dict:
    """Gradient steps of both nets from (actor0, critic0) and their Adam
    states ``adam`` ({"actor": state, "critic": state}; None: fresh), one
    per minibatch.
    Returns each step's loss (a float), the first step's clipped gradient
    (leaf name -> tensor, names prefixed ``actor.`` / ``critic.``) and the
    leaves after the last step."""
    ppo = setup["ppo"]
    actor = {k: v.clone() for k, v in actor0.items()}
    critic = {k: v.clone() for k, v in critic0.items()}
    adam = adam or {}
    opt_a = Adam(actor, ppo["lr"], ppo["eps"], ppo["max_grad_norm"], adam.get("actor"))
    opt_c = Adam(critic, ppo["lr"], ppo["eps"], ppo["max_grad_norm"], adam.get("critic"))
    losses, first_grad = [], None
    for mb in minibatches:
        a_leaves = {k: v.detach().requires_grad_(True) for k, v in actor.items()}
        c_leaves = {k: v.detach().requires_grad_(True) for k, v in critic.items()}
        total, _ = loss(a_leaves, c_leaves, mb, setup, precision, half_batch)
        grads = torch.autograd.grad(total, list(a_leaves.values()) + list(c_leaves.values()))
        ga = dict(zip(a_leaves, grads[: len(a_leaves)]))
        gc = dict(zip(c_leaves, grads[len(a_leaves):]))
        actor = opt_a.step(actor, ga)
        critic = opt_c.step(critic, gc)
        losses.append(float(total.detach()))
        if first_grad is None:
            first_grad = {**{f"actor.{k}": v for k, v in opt_a.clipped.items()},
                          **{f"critic.{k}": v for k, v in opt_c.clipped.items()}}
    last = {**{f"actor.{k}": v for k, v in actor.items()}, **{f"critic.{k}": v for k, v in critic.items()}}
    return {"losses": losses, "first_grad": first_grad, "params": last}


@torch.no_grad()
def rollout_outputs(actor: dict, critic: dict, rollout: dict, setup: dict,
                    precision: str = "float32") -> tuple[torch.Tensor, torch.Tensor]:
    """(log prob of the rollout's actions, value) of every observation
    (``rollout["obs"]``, (T, B, O))."""
    actions = rollout["action"]
    nobs = normalize(rollout["obs"], setup["norm"])
    mean = forward(actor, nobs, setup["n_hidden"], precision)
    value = forward(critic, nobs, setup["n_hidden"], precision)[..., 0]
    return gaussian_logp(mean, setup["log_std"], actions), value


def gae(rewards, values, next_values, terminated, done, gamma: float, lam: float):
    """(advantages, returns), each (T, B): GAE cut at every episode end,
    bootstrapped except at true terminations."""
    adv = torch.zeros_like(rewards[0])
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_values[t] * (1.0 - terminated[t]) - values[t]
        adv = delta + gamma * lam * (1.0 - done[t]) * adv
        out.append(adv)
    advantages = torch.stack(out[::-1])
    return advantages, advantages + values
