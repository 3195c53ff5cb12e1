"""What the check compares, captured from the timed path.

A ``Tap`` wraps the env module's kernel entry and three of the trainer's
methods on this trainer only, for set-up and the whole window. Unarmed, each
hook passes its call through. Armed with a ``Capture``, it records that
capture's iteration, from its first rollout to its ``update_steps``-th
gradient step, then disarms itself:

- the trainer's state at the iteration's start: both nets' parameters and
  their Adam moments and step counts;
- two control-step kernel launches of the iteration, the reset pool's settle
  and the rollout's step number ``step_at`` (drawn from the seed): every
  argument the program handed the kernel (the state, the PD target, the
  per-env dynamics, the terrain, the motor state; rows of the sampled envs
  for what is batch-leading) and the outputs the env reads;
- the rollout: observations, actions, log probs and values of the sampled
  envs (with a recurrent policy's carries at its start), and for every env
  the rewards, values, next values and episode ends;
- the batch's advantages and returns, as the update was given them;
- the first ``update_steps`` gradient steps: each minibatch, the loss terms
  the step added up, Adam's first moments after the first step and the
  parameters after the last.

Every record is an asynchronous copy into pinned host memory, queued on the
device's stream behind the work that made it: no hook adds a host
synchronization or device memory that the window keeps. PPO.train reads its
metrics on the host at the end of every iteration, so a capture's copies have
landed when ``on_iteration`` sees the iteration; ``settled`` waits for them
all the same.
"""

from __future__ import annotations

import dataclasses
import inspect

import torch

LOSS_TERMS = ("actor_loss", "critic_loss", "entropy", "mirror_loss", "imitation_loss")
KERNEL_ARGS_SKIPPED = ("model",)  # the reference builds its own model


def to_host(x):
    """``x`` copied into host memory: from the device, asynchronously into
    pinned memory (valid once the stream has reached the copy)."""
    if not torch.is_tensor(x):
        return x
    x = x.detach()
    if x.device.type == "cpu":
        return x.clone()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x, non_blocking=True)
    return out


def take(x, idx: torch.Tensor | None = None, n: int = 0):
    """``x`` with its batch-leading tensors (leading size ``n``) cut to the
    rows ``idx`` (None: whole), copied to the host; dataclasses become dicts
    of their fields, tuples lists, other values stay as they are."""
    if torch.is_tensor(x):
        if idx is not None and x.dim() >= 1 and x.shape[0] == n:
            return to_host(x[idx.to(x.device)])
        return to_host(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: take(getattr(x, f.name), idx, n) for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return [take(v, idx, n) for v in x]
    if isinstance(x, dict):
        return {k: take(v, idx, n) for k, v in x.items()}
    return x


def _net_state(ts, leaf_name) -> dict:
    """Both nets' parameters and Adam state, by the reference's leaf names."""
    out = {}
    for net, opt in (("actor", ts.actor_opt), ("critic", ts.critic_opt)):
        names = [leaf_name(n) for n, _ in getattr(ts, net).named_parameters()]
        out[net] = {"params": {k: to_host(p) for k, (_, p) in zip(names, getattr(ts, net).named_parameters())},
                    "mu": {k: to_host(m) for k, m in zip(names, opt.mu)},
                    "nu": {k: to_host(v) for k, v in zip(names, opt.nu)},
                    "count": to_host(opt.count)}
    return out


class Capture:
    """The record of one iteration: ``iteration`` is its index in the loop
    it runs in (set-up's warm-up or the window), drawn from the seed for the
    window."""

    def __init__(self, cell, seed: int, where: str, salt: int, iterations: int = 1):
        tr, chk = cell.traffic, cell.traffic["check"]
        gen = torch.Generator()
        gen.manual_seed(int(seed) ^ salt)
        n = tr["num_envs"]
        pick = lambda k: torch.sort(torch.randperm(n, generator=gen)[: min(k, n)]).values  # noqa: E731
        self.where = where
        self.phys_idx = pick(chk["physics_envs"])
        self.roll_idx = pick(chk["rollout_envs"])
        self.step_at = int(torch.randint(tr["rollout_len"], (1,), generator=gen))
        self.iteration = int(torch.randint(iterations, (1,), generator=gen))
        self.steps_wanted = int(chk["update_steps"])
        self.num_envs = n
        self.data = {"where": where, "iteration": self.iteration, "step_at": self.step_at, "launches": {},
                     "steps": []}

    @property
    def complete(self) -> bool:
        return len(self.data["steps"]) == self.steps_wanted

    def settled(self) -> dict:
        """The record, once every queued copy has landed."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return self.data


class Tap:
    """The hooks on the timed path; see the module's docstring."""

    def __init__(self, ppo, leaf_name):
        self.ppo, self.leaf_name = ppo, leaf_name
        self.capture: Capture | None = None
        self._sampling = False
        self._step_calls = 0
        self._originals = None

    def arm(self, capture: Capture) -> None:
        self.capture = capture

    # ------------------------------------------------------------ hooks

    def _launch(self, orig):
        sig = inspect.signature(orig)

        def wrapped(*args, **kwargs):
            if not self._sampling:
                return orig(*args, **kwargs)
            cap = self.capture
            call = sig.bind(*args, **kwargs)
            call.apply_defaults()
            kind = "settle" if call.arguments["settle"] else "step"
            want = kind not in cap.data["launches"]
            if kind == "step":
                want = want and self._step_calls == cap.step_at
                self._step_calls += 1
            if not want:
                return orig(*args, **kwargs)
            # the inputs first: queued before the kernel runs
            inputs = {k: take(v, cap.phys_idx, cap.num_envs) for k, v in call.arguments.items()
                      if k not in KERNEL_ARGS_SKIPPED}
            out = orig(*args, **kwargs)
            state, mstate = out if isinstance(out, tuple) else (out, None)
            outputs = {"qpos": state.qpos, "qvel": state.qvel}
            if mstate is not None:
                outputs.update(qd_hist=mstate.qdot_hist, ct_hist=mstate.ctau_hist)
            cap.data["launches"][kind] = {"inputs": inputs,
                                          "outputs": take(outputs, cap.phys_idx, cap.num_envs)}
            return out
        return wrapped

    def _rollout(self, orig):
        def wrapped(ts, deterministic):
            cap = self.capture
            if cap is None or "rollout" in cap.data:
                return orig(ts, deterministic)
            cap.data["state"] = _net_state(ts, self.leaf_name)
            self._sampling, self._step_calls = True, 0
            try:
                env_state, traj = orig(ts, deterministic)
            finally:
                self._sampling = False
            r = cap.roll_idx.to(traj["obs"].device)
            cap.data["rollout"] = {
                "obs": to_host(traj["obs"][:, r]), "action": to_host(traj["action"][:, r]),
                "log_prob": to_host(traj["log_prob"][:, r]), "value_sampled": to_host(traj["value"][:, r]),
                **{k: to_host(traj[k]) for k in ("reward", "value", "next_value")},
                "terminated": to_host(traj["terminated"].float()), "done": to_host(traj["done"].float()),
                # a recurrent policy's carries at the rollout's start (None for feed-forward nets)
                "carry0": take([ts.actor_carry, ts.critic_carry], cap.roll_idx, cap.num_envs),
            }
            return env_state, traj
        return wrapped

    def _sample_iteration(self, orig):
        def wrapped(ts):
            ts2, batch, roll = orig(ts)
            cap = self.capture
            if cap is not None and "batch" not in cap.data:
                cap.data["batch"] = {"advantages": to_host(batch.advantages), "returns": to_host(batch.returns)}
            return ts2, batch, roll
        return wrapped

    def _minibatch_step(self, orig):
        def wrapped(ts, loss_fn, mb, sums, count=None):
            cap = self.capture
            if cap is None or "batch" not in cap.data:
                return orig(ts, loss_fn, mb, sums, count)
            k = len(cap.data["steps"])
            before = dict(sums)  # the step adds new tensors; these stay as they were
            orig(ts, loss_fn, mb, sums, count)
            terms = {t: sums[t] - before[t] if t in before else sums[t] for t in LOSS_TERMS if t in sums}
            rec = {"mb": take(mb), "terms": {t: to_host(v) for t, v in terms.items()}}
            if k == 0:
                rec["first_moments"] = {
                    net: {self.leaf_name(n): to_host(m) for (n, _), m in zip(getattr(ts, net).named_parameters(), opt.mu)}
                    for net, opt in (("actor", ts.actor_opt), ("critic", ts.critic_opt))}
            if k == cap.steps_wanted - 1:
                rec["params"] = {net: {self.leaf_name(n): to_host(p) for n, p in getattr(ts, net).named_parameters()}
                                 for net in ("actor", "critic")}
            cap.data["steps"].append(rec)
            if cap.complete:
                self.capture = None
        return wrapped

    # ------------------------------------------------------------ install

    def install(self) -> None:
        from learninghumanoidwalking_tpu_torch.envs import humanoid

        self._originals = humanoid.pd_substeps_kernel
        humanoid.pd_substeps_kernel = self._launch(self._originals)
        for name in ("_rollout", "_sample_iteration", "_minibatch_step"):
            setattr(self.ppo, name, getattr(self, name)(getattr(self.ppo, name)))

    def remove(self) -> None:
        from learninghumanoidwalking_tpu_torch.envs import humanoid

        if self._originals is None:
            return
        humanoid.pd_substeps_kernel = self._originals
        self._originals = None
        for name in ("_rollout", "_sample_iteration", "_minibatch_step"):
            delattr(self.ppo, name)
        self.capture = None
