"""PPO (clip objective), feed-forward path (counterpart of learninghumanoidwalking_tpu/rl/ppo.py).

Same iteration as the JAX trainer: a rollout of ``rollout_len`` steps over
the persistent env batch with a rotated per-iteration reset pool and a
carried V(s_t), GAE, batch-normalized advantages, then ``epochs`` passes of
minibatched updates (clipped surrogate, value MSE, entropy bonus, mirror
loss, and the imitation loss through a frozen expert), each network with
its own Adam after global-norm clipping and a skip on non-finite gradients
(optax's apply_if_finite, 100 consecutive skips at most). ``train``
evaluates the deterministic policy every ``eval_freq`` iterations and at
the last one, checkpoints each evaluation (marking the best), logs, and can
trace iterations 2-4 with torch.profiler. The JAX ``scan``s are Python
loops; the trainer state lives on ``device``.

With ``recurrent``, the actor and critic are LSTMs whose carries ride along
the persistent env batch (zeroed where an env finishes) and the update
replays each minibatch of env sequences from the rollout's first carries
(BPTT over the rollout window), as the JAX trainer's recurrent branch does.

With a ``DataParallel`` (parallel/mesh.py), the trainer is one rank of a
data-parallel run: it steps its rows of the env batch and takes part in
the global statistics, minibatches and gradient sums, so that n ranks
compute what one does on the whole batch. Every loss and statistic is a
sum over samples divided by the global count, on one rank as on many.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Callable

import torch

from learninghumanoidwalking_tpu_torch.envs.base import Env, EnvState
from learninghumanoidwalking_tpu_torch.physics.model import tree_map
from learninghumanoidwalking_tpu_torch.rl import networks
from learninghumanoidwalking_tpu_torch.rl.gae import compute_gae
from learninghumanoidwalking_tpu_torch.rl.imitation import imitation_loss
from learninghumanoidwalking_tpu_torch.rl.mirror import obs_symmetry_matrix, symmetry_matrix
from learninghumanoidwalking_tpu_torch.rl.normalize import RunningNorm, init_norm, update_norm
from learninghumanoidwalking_tpu_torch.utils import trace
from learninghumanoidwalking_tpu_torch.utils.seeding import Draws

# consecutive non-finite steps Adam skips before it applies one all the same
# (the JAX trainer's apply_if_finite, learninghumanoidwalking_tpu/rl/ppo.py:171)
MAX_CONSECUTIVE_ERRORS = 100


@dataclasses.dataclass
class PPOConfig:
    """Hyperparameters; defaults are the JAX PPOConfig's."""

    n_itr: int = 20000
    lr: float = 3e-4
    eps: float = 1e-5  # Adam epsilon
    gamma: float = 0.99
    lam: float = 0.95
    std_dev: float = 0.223
    learn_std: bool = False
    entropy_coeff: float = 0.0
    clip: float = 0.2
    minibatch_size: int = 4096
    epochs: int = 3
    num_envs: int = 512
    rollout_len: int = 64
    max_traj_len: int = 400
    max_grad_norm: float = 0.5
    mirror_coeff: float = 0.4
    use_mirror: bool = True
    imitate_coeff: float = 0.3
    eval_freq: int = 100
    input_norm_iters: int = 5
    seed: int = 0
    # LSTM actor and critic (float32; net_dtype applies to the FF nets only)
    recurrent: bool = False
    # "slice": contiguous minibatches of the (time-major, env-minor) batch
    # visited in a random order (the JAX default); "shuffle": a random
    # permutation of all samples per epoch
    minibatch_scheme: str = "slice"
    # compute precision of the hidden matmuls ("bfloat16" on the card, the
    # JAX default; "float32" for parity runs)
    net_dtype: str = "bfloat16"
    hidden: tuple = (256, 256)

    @property
    def batch_size(self) -> int:
        return self.num_envs * self.rollout_len


class Adam:
    """Adam over a parameter list, preceded by global-norm clipping and
    skipped (state untouched) when a gradient is not finite — optax's
    apply_if_finite(chain(clip_by_global_norm, adam), MAX_CONSECUTIVE_ERRORS)
    as the JAX trainer builds it. Written out so the skip needs no host
    synchronization.

    As optax does: every gradient is tested for finiteness (not their norm,
    which may overflow to inf while every entry is finite: the clip then
    gives zero gradients, and the moments and ``count`` still advance);
    ``notfinite_count`` counts consecutive non-finite steps, and once it
    exceeds ``MAX_CONSECUTIVE_ERRORS`` the step is applied all the same.
    ``nonfinite_total`` counts every non-finite step since this Adam was
    built (a diagnostic of long runs; checkpoints do not keep it)."""

    def __init__(self, params: list, lr: float, eps: float, max_grad_norm: float, b1=0.9, b2=0.999):
        self.params = params
        self.lr, self.eps, self.max_norm, self.b1, self.b2 = lr, eps, max_grad_norm, b1, b2
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = torch.zeros((), device=params[0].device)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=params[0].device)
        self.nonfinite_total = torch.zeros((), dtype=torch.int32, device=params[0].device)

    @torch.no_grad()
    def step(self, grads: list) -> None:
        with trace.span("ppo.adam"):
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            self.notfinite_count = torch.where(finite, 0, self.notfinite_count + 1).to(torch.int32)
            self.nonfinite_total = self.nonfinite_total + (~finite).to(torch.int32)
            apply = finite | (self.notfinite_count > MAX_CONSECUTIVE_ERRORS)
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            trigger = g_norm < self.max_norm
            grads = [torch.where(trigger, g, (g / g_norm) * self.max_norm) for g in grads]
            count = torch.where(apply, self.count + 1, self.count)
            bc1 = 1 - self.b1**count
            bc2 = 1 - self.b2**count
            for i, (p, g) in enumerate(zip(self.params, grads)):
                mu = self.b1 * self.mu[i] + (1 - self.b1) * g
                nu = self.b2 * self.nu[i] + (1 - self.b2) * (g * g)
                update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                p.copy_(torch.where(apply, p - self.lr * update, p))
                self.mu[i] = torch.where(apply, mu, self.mu[i])
                self.nu[i] = torch.where(apply, nu, self.nu[i])
            self.count = count


@dataclasses.dataclass
class TrainState:
    actor: networks.GaussianActor | networks.GaussianLSTMActor
    critic: networks.Critic | networks.LSTMCritic
    actor_opt: Adam
    critic_opt: Adam
    norm: RunningNorm
    env_state: EnvState  # batched (num_envs leading)
    iteration: int
    # recurrent policies' carries, a tuple of (c, h) per layer, each
    # (num_envs, hidden); None for FF policies
    actor_carry: tuple | None = None
    critic_carry: tuple | None = None


@dataclasses.dataclass
class Batch:
    obs: torch.Tensor  # (T, B, O)
    actions: torch.Tensor  # (T, B, A)
    log_probs: torch.Tensor  # (T, B)
    advantages: torch.Tensor  # (T, B)
    returns: torch.Tensor  # (T, B)
    # recurrent extras (None for FF): episode ends and the rollout's first
    # carries, from which the update replays the sequences
    done: torch.Tensor | None = None  # (T, B)
    actor_carry0: tuple | None = None
    critic_carry0: tuple | None = None


def _tree_where(pred: torch.Tensor, a, b):
    """Select tree a where pred (B,) else b; leaves are (B, ...)."""

    def sel(x, y):
        if not torch.is_tensor(x):
            return x
        return torch.where(pred.reshape(pred.shape + (1,) * (x.dim() - 1)), x, y)

    return tree_map(sel, a, b)


def mask_carry(carry: tuple, done: torch.Tensor) -> tuple:
    """Zero the carry rows of finished envs (a fresh hidden state per episode)."""
    return tree_map(lambda x: torch.where(done[:, None], torch.zeros_like(x), x), carry)


class PPO:
    """PPO trainer bound to one env, on ``device``; randomness from ``draws``.
    With ``imitation_projector`` (an env's imitation_projector()) and
    ``expert`` (a frozen policy: observations -> action means, as
    rl/eval.py::load_expert gives), the loss adds the imitation term."""

    def __init__(self, env: Env, config: PPOConfig, device: str | torch.device = "cuda", draws: Draws | None = None,
                 imitation_projector: Callable | None = None, expert: Callable | None = None, shard=None):
        self.env = env
        self.cfg = config
        self.device = torch.device(device)
        if draws is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            draws = Draws(gen)
        # a rank of a data-parallel run (parallel/mesh.py DataParallel): its
        # rows of every per-env draw
        self.shard = shard
        self.draws = draws if shard is None else shard.row_draws(draws)
        self.net_dtype = getattr(torch, config.net_dtype)
        self.obs_mirror = None
        self.act_mirror = None
        if config.use_mirror and env.mirrored_obs is not None:
            self.obs_mirror = torch.as_tensor(
                obs_symmetry_matrix(env.mirrored_obs, env.clock_inds, env.history_len), device=self.device
            )
            self.act_mirror = torch.as_tensor(symmetry_matrix(env.mirrored_acts), device=self.device)
        if (imitation_projector is None) != (expert is None):
            raise ValueError("imitation needs both an imitation projector and an expert")
        self.imitation_projector = imitation_projector
        self.expert = expert

    @property
    def n_local(self) -> int:
        """The envs this trainer steps: the batch, or a rank's rows of it."""
        return self.cfg.num_envs if self.shard is None else self.shard.local_envs

    @property
    def lead(self) -> bool:
        """Whether this trainer evaluates, logs and checkpoints (rank 0)."""
        return self.shard is None or self.shard.rank == 0

    def _sums(self, *xs) -> list:
        """Each tensor's sum, over every rank's samples."""
        sums = [torch.sum(x) for x in xs]
        return sums if self.shard is None else self.shard.all_reduce(sums)

    def _local(self, idx: torch.Tensor | slice, samples: bool = False):
        """This rank's share of the global env rows ``idx`` or, with
        ``samples``, of the flat (time-major, env-minor) samples ``idx``,
        as local indices; ``idx`` itself without a shard."""
        if self.shard is None:
            return idx
        if isinstance(idx, slice):
            idx = torch.arange(idx.start, idx.stop, device=self.device)
        idx = idx.to(self.device)
        return self.shard.local_samples(idx) if samples else self.shard.local_rows(idx)

    # ------------------------------------------------------------------ init

    def init_state(self, gen: torch.Generator | None = None) -> TrainState:
        """Networks, optimizers and norm (init_networks) and a fresh env batch."""
        ts = self.init_networks(gen)
        return dataclasses.replace(ts, env_state=self.env.reset_batch(self.n_local, self.draws))

    def init_networks(self, gen: torch.Generator | None = None) -> TrainState:
        """A TrainState without an env batch (``env_state`` None): the
        networks from ``gen`` (default: a CPU generator seeded with the
        config's seed), their optimizers and the observation norm."""
        cfg = self.cfg
        if gen is None:
            gen = torch.Generator(device="cpu")
            gen.manual_seed(cfg.seed)
        if cfg.recurrent:
            actor = networks.GaussianLSTMActor(
                self.env.obs_size, self.env.action_size, cfg.hidden, cfg.std_dev, cfg.learn_std, gen
            ).to(self.device)
            critic = networks.LSTMCritic(self.env.obs_size, cfg.hidden, gen).to(self.device)
        else:
            actor = networks.GaussianActor(
                self.env.obs_size, self.env.action_size, cfg.hidden, cfg.std_dev, cfg.learn_std, self.net_dtype, gen
            ).to(self.device)
            critic = networks.Critic(self.env.obs_size, cfg.hidden, self.net_dtype, gen).to(self.device)
        if self.env.obs_mean is not None:
            norm = init_norm(None, self.env.obs_mean, self.env.obs_std, device=self.device)
        else:
            norm = init_norm((self.env.obs_size,), device=self.device)
        return TrainState(
            actor=actor,
            critic=critic,
            actor_opt=Adam(list(actor.parameters()), cfg.lr, cfg.eps, cfg.max_grad_norm),
            critic_opt=Adam(list(critic.parameters()), cfg.lr, cfg.eps, cfg.max_grad_norm),
            norm=norm,
            env_state=None,
            iteration=0,
            actor_carry=self.initial_carry(self.n_local) if cfg.recurrent else None,
            critic_carry=self.initial_carry(self.n_local) if cfg.recurrent else None,
        )

    def initial_carry(self, batch: int) -> tuple:
        """Zero LSTM carries for ``batch`` envs."""
        return networks.LSTMCore.initial_carry(self.cfg.hidden, (batch,), self.device)

    # --------------------------------------------------------------- rollout

    def _policy(self, actor, norm, obs):
        return actor(norm.normalize(obs))

    def _value(self, critic, norm, obs):
        return critic(norm.normalize(obs))

    def _reset_pool(self, ts: TrainState) -> EnvState:
        """The iteration's reset pool, rotated across the batch by the iteration index."""
        shift = ts.iteration
        if self.shard is not None:  # this rank's rows of the rotated pool
            return self.env.reset_batch(self.n_local, self.draws.shifted(shift), ts.iteration)
        pool = self.env.reset_batch(self.cfg.num_envs, self.draws, ts.iteration)
        return tree_map(lambda x: torch.roll(x, shift, dims=0) if torch.is_tensor(x) else x, pool)

    def _sample_action(self, mean, log_std, deterministic: bool):
        if deterministic:
            return mean
        return mean + torch.exp(log_std) * self.draws.normal("action", tuple(mean.shape), self.device)

    @torch.no_grad()
    def _rollout(self, ts: TrainState, deterministic: bool):
        """rollout_len steps over the persistent env batch. Envs that finish
        are replaced from a reset pool made once per iteration and rotated
        across the batch by the iteration index; V(s_t) is carried."""
        if self.cfg.recurrent:
            return self._rollout_recurrent(ts, deterministic)
        cfg = self.cfg
        n = self.n_local
        pool = self._reset_pool(ts)
        pool_values = self._value(ts.critic, ts.norm, pool.obs)
        value = self._value(ts.critic, ts.norm, ts.env_state.obs)

        env_state = ts.env_state
        ep_ret = torch.zeros(n, device=self.device)
        keys = ("obs", "action", "log_prob", "value", "next_value", "reward", "terminated", "done", "ep_steps", "ep_return")
        traj = {k: [] for k in keys}
        for _ in range(cfg.rollout_len):
            obs = env_state.obs
            mean, log_std = self._policy(ts.actor, ts.norm, obs)
            action = self._sample_action(mean, log_std, deterministic)
            log_prob = networks.gaussian_logp(mean, log_std, action)

            stepped = self.env.step_batch(env_state, action, self.draws)
            next_value = self._value(ts.critic, ts.norm, stepped.obs)

            terminated = stepped.done
            truncated = (stepped.steps >= cfg.max_traj_len) & ~terminated
            done = terminated | truncated

            reset_state = dataclasses.replace(pool, iteration=stepped.iteration)
            env_state = _tree_where(done, reset_state, stepped)
            ep_ret = ep_ret + stepped.reward
            for k, x in zip(keys, (obs, action, log_prob, value, next_value, stepped.reward, terminated, done,
                                   stepped.steps, torch.where(done, ep_ret, torch.zeros_like(ep_ret)))):
                traj[k].append(x)
            ep_ret = torch.where(done, torch.zeros_like(ep_ret), ep_ret)
            value = torch.where(done, pool_values, next_value)
        return env_state, {k: torch.stack(v) for k, v in traj.items()}

    @torch.no_grad()
    def _rollout_recurrent(self, ts: TrainState, deterministic: bool):
        """The recurrent rollout: both carries ride along and are zeroed where
        an env finishes. The bootstrap value of the pre-reset observation
        comes from the critic on the stepped carry, which is then thrown
        away (so the critic runs twice a step; V is not carried). The
        trajectory keeps the rollout's first carries for the update and
        its last ones (``final_carries``) for the next iteration."""
        cfg = self.cfg
        pool = self._reset_pool(ts)
        env_state, a_carry, c_carry = ts.env_state, ts.actor_carry, ts.critic_carry
        keys = ("obs", "action", "log_prob", "value", "next_value", "reward", "terminated", "done", "ep_steps")
        traj = {k: [] for k in keys}
        for _ in range(cfg.rollout_len):
            obs = env_state.obs
            nobs = ts.norm.normalize(obs)
            a_carry2, (mean, log_std) = ts.actor(a_carry, nobs)
            action = self._sample_action(mean, log_std, deterministic)
            log_prob = networks.gaussian_logp(mean, log_std, action)
            c_carry2, value = ts.critic(c_carry, nobs)

            stepped = self.env.step_batch(env_state, action, self.draws)
            _, next_value = ts.critic(c_carry2, ts.norm.normalize(stepped.obs))

            terminated = stepped.done
            truncated = (stepped.steps >= cfg.max_traj_len) & ~terminated
            done = terminated | truncated

            env_state = _tree_where(done, dataclasses.replace(pool, iteration=stepped.iteration), stepped)
            a_carry, c_carry = mask_carry(a_carry2, done), mask_carry(c_carry2, done)
            for k, x in zip(keys, (obs, action, log_prob, value, next_value, stepped.reward, terminated, done,
                                   stepped.steps)):
                traj[k].append(x)
        traj = {k: torch.stack(v) for k, v in traj.items()}
        traj.update(actor_carry0=ts.actor_carry, critic_carry0=ts.critic_carry, final_carries=(a_carry, c_carry))
        return env_state, traj

    def _sample_iteration(self, ts: TrainState):
        env_state, traj = self._rollout(ts, deterministic=False)
        advantages, returns = compute_gae(
            traj["reward"], traj["value"], traj["next_value"], traj["terminated"], traj["done"],
            self.cfg.gamma, self.cfg.lam,
        )
        count = self.cfg.batch_size  # samples over every rank
        (adv_sum,) = self._sums(advantages)
        adv_mean = adv_sum / count
        (sq_sum,) = self._sums(torch.square(advantages - adv_mean))
        advantages = (advantages - adv_mean) / (torch.sqrt(sq_sum / count) + 1e-5)
        recurrent = self.cfg.recurrent
        batch = Batch(
            obs=traj["obs"], actions=traj["action"], log_probs=traj["log_prob"],
            advantages=advantages, returns=returns, done=traj["done"] if recurrent else None,
            actor_carry0=traj.get("actor_carry0"), critic_carry0=traj.get("critic_carry0"),
        )
        env_state = dataclasses.replace(env_state, iteration=env_state.iteration + 1)
        ts = dataclasses.replace(ts, env_state=env_state, iteration=ts.iteration + 1)
        if recurrent:
            a_carry, c_carry = traj["final_carries"]
            ts = dataclasses.replace(ts, actor_carry=a_carry, critic_carry=c_carry)

        done_f = traj["done"].to(torch.float32)
        # the recurrent trajectory keeps no episode returns: its episode
        # reward is every reward over the episodes finished (as in JAX)
        reward_sum, len_sum, n_done, ep_sum = self._sums(
            traj["reward"], done_f * traj["ep_steps"], done_f, traj["reward"] if recurrent else traj["ep_return"]
        )
        roll_metrics = dict(
            mean_reward=reward_sum / count,
            mean_episode_length=len_sum / torch.clamp_min(n_done, 1.0),
            episodes_finished=n_done,
            episode_reward=ep_sum / torch.clamp_min(n_done, 1.0),
        )
        return ts, batch, roll_metrics

    # ---------------------------------------------------------------- update

    def _loss_fn(self, actor, critic, norm, mb, count: int | None = None):
        """The loss over a minibatch of flat samples; ``count``: the global
        minibatch's size (default: these samples)."""
        obs, actions, old_log_probs, advantages, returns = mb
        mean, log_std = self._policy(actor, norm, obs)
        values = critic(norm.normalize(obs))
        if self.obs_mirror is not None:
            mir_mean, _ = self._policy(actor, norm, obs @ self.obs_mirror.T)
        else:
            mir_mean = None
        return self._loss_terms(obs, actions, old_log_probs, advantages, returns, mean, log_std, values, mir_mean, count)

    def _replay_sequences(self, actor, critic, nobs, done_prev, a_c, c_c):
        """Run the nets over a (T, b, O) window of normalized observations
        from carries (a_c, c_c), zeroing a row's carries after the step at
        which its episode ended (``done_prev``). Returns (means, log_stds,
        values); without ``critic`` (None), values is None."""
        means, log_stds, values = [], [], []
        for t in range(nobs.shape[0]):
            a_c = mask_carry(a_c, done_prev[t])
            a_c, (mean, log_std) = actor(a_c, nobs[t])
            means.append(mean)
            log_stds.append(log_std)
            if critic is not None:
                c_c = mask_carry(c_c, done_prev[t])
                c_c, value = critic(c_c, nobs[t])
                values.append(value)
        return torch.stack(means), torch.stack(log_stds), torch.stack(values) if critic is not None else None

    def _loss_recurrent(self, actor, critic, norm, mb, count: int | None = None):
        """The loss over a minibatch of env sequences (T, b): the nets
        replayed from the rollout's first carries. The mirror replay starts
        from zero carries, as in the JAX trainer. ``count``: the global
        minibatch's samples (default: these, T x b)."""
        obs, actions, old_log_probs, advantages, returns, done, a_c0, c_c0 = mb
        done_prev = torch.cat([torch.zeros_like(done[:1]), done[:-1]], dim=0)
        means, log_stds, values = self._replay_sequences(actor, critic, norm.normalize(obs), done_prev, a_c0, c_c0)
        if self.obs_mirror is not None:
            zero = tree_map(torch.zeros_like, a_c0)
            mir_means, _, _ = self._replay_sequences(actor, None, norm.normalize(obs @ self.obs_mirror.T), done_prev,
                                                     zero, None)
        else:
            mir_means = None
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
        return self._loss_terms(flat(obs), flat(actions), flat(old_log_probs), flat(advantages), flat(returns),
                                flat(means), flat(log_stds), flat(values), None if mir_means is None else flat(mir_means),
                                count)

    def _loss_terms(self, obs, actions, old_log_probs, advantages, returns, mean, log_std, values, mir_mean, count=None):
        """Clipped surrogate, value MSE, entropy, mirror and imitation terms
        over flat samples, from the nets' outputs (mir_mean: the policy on
        mirrored observations, None without a mirror). Each mean is the sum
        over these samples divided by ``count`` samples (default: these),
        so that the ranks' terms add up to the global minibatch's."""
        cfg = self.cfg
        count = obs.shape[0] if count is None else count

        def mean_of(x):
            return torch.sum(x) / (count * math.prod(x.shape[1:]))

        log_probs = networks.gaussian_logp(mean, log_std, actions)
        ratio = torch.exp(log_probs - old_log_probs)

        surr1 = ratio * advantages
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip, 1.0 + cfg.clip) * advantages
        actor_loss = -mean_of(torch.minimum(surr1, surr2))
        clip_fraction = mean_of((torch.abs(ratio - 1.0) > cfg.clip).to(torch.float32))

        critic_loss = mean_of(torch.square(returns - values))
        entropy = mean_of(networks.gaussian_entropy(log_std))

        if mir_mean is not None:
            mirror_loss = mean_of(torch.square(mean - mir_mean @ self.act_mirror.T))
        else:
            mirror_loss = torch.zeros((), device=obs.device)

        # imitation through the frozen expert (JAX rl/ppo.py:444-450)
        if self.imitation_projector is not None:
            query = self.imitation_projector(obs)
            with torch.no_grad():
                expert_mean = self.expert(query.expert_obs)
            (mask_total,) = self._sums(query.sample_mask.to(torch.float32))
            imit_loss = imitation_loss(query, mean, expert_mean, mask_total)
        else:
            imit_loss = torch.zeros((), device=obs.device)

        log_ratio = log_probs - old_log_probs
        approx_kl = mean_of((ratio - 1.0) - log_ratio)

        total = (actor_loss + cfg.mirror_coeff * mirror_loss + cfg.imitate_coeff * imit_loss
                 - cfg.entropy_coeff * entropy + critic_loss)
        aux = dict(
            actor_loss=actor_loss, critic_loss=critic_loss, entropy=entropy, mirror_loss=mirror_loss,
            imitation_loss=imit_loss, approx_kl=approx_kl, clip_fraction=clip_fraction,
        )
        return total, aux

    def _update(self, ts: TrainState, batch: Batch, perms: list | None = None):
        """``epochs`` passes of minibatched updates. ``perms`` (one per
        epoch) fixes the minibatch order: for "slice", a permutation of the
        minibatch indices; for "shuffle", of all samples."""
        if self.cfg.recurrent:
            return self._update_recurrent(ts, batch, perms)
        cfg = self.cfg
        n = cfg.batch_size
        mb_size = min(cfg.minibatch_size, n)
        n_mb = max(n // mb_size, 1)
        flat = [x.reshape((-1,) + tuple(x.shape[2:])) for x in
                (batch.obs, batch.actions, batch.log_probs, batch.advantages, batch.returns)]
        sums: dict[str, torch.Tensor] = {}
        for epoch in range(cfg.epochs):
            if cfg.minibatch_scheme == "slice":
                perm = perms[epoch] if perms is not None else self.draws.permutation("minibatch", n_mb, self.device)
                with trace.span("host.read"):
                    order = perm.tolist()
                index_sets = [slice(int(i) * mb_size, int(i) * mb_size + mb_size) for i in order]
            else:
                perm = perms[epoch] if perms is not None else self.draws.permutation("minibatch", n, self.device)
                index_sets = list(perm[: n_mb * mb_size].reshape(n_mb, mb_size))
            for idx in index_sets:
                self._minibatch_step(ts, self._loss_fn, tuple(x[self._local(idx, samples=True)] for x in flat), sums, mb_size)
        return ts, self._mean_metrics(sums, cfg.epochs * n_mb)

    def _mean_metrics(self, sums: dict, count: int) -> dict:
        """The loss terms summed over minibatches (and ranks), per minibatch."""
        return {k: v / count for k, v in zip(sums, self._sums(*sums.values()))}

    def _minibatch_step(self, ts: TrainState, loss_fn, mb, sums: dict, count: int | None = None) -> None:
        """One gradient step of both nets on ``mb`` (of a global minibatch of
        ``count`` samples); adds the loss terms to ``sums``. Over ranks the
        gradients are summed before the step, so every rank steps alike."""
        with trace.span("ppo.grad_step"):
            a_params = list(ts.actor.parameters())
            c_params = list(ts.critic.parameters())
            total, aux = loss_fn(ts.actor, ts.critic, ts.norm, mb, count)
            grads = list(torch.autograd.grad(total, a_params + c_params))
            if self.shard is not None:
                grads = self.shard.all_reduce(grads)
            ts.actor_opt.step(grads[: len(a_params)])
            ts.critic_opt.step(grads[len(a_params) :])
            for k, v in aux.items():
                sums[k] = sums.get(k, 0.0) + v.detach()

    def _update_recurrent(self, ts: TrainState, batch: Batch, perms: list | None = None):
        """``epochs`` passes over minibatches of env sequences (T, seq_mb),
        each replayed from its envs' first carries. "slice": contiguous env
        ranges in the order of ``perms[epoch]``, a permutation of the
        ``n_mb`` ranges; "shuffle": ``perms[epoch]`` permutes the envs."""
        cfg = self.cfg
        n_envs = cfg.num_envs
        seq_mb = max(min(cfg.minibatch_size // cfg.rollout_len, n_envs), 1)
        n_mb = max(n_envs // seq_mb, 1)
        seqs = (batch.obs, batch.actions, batch.log_probs, batch.advantages, batch.returns, batch.done)
        sums: dict[str, torch.Tensor] = {}
        for epoch in range(cfg.epochs):
            if cfg.minibatch_scheme == "slice":
                perm = perms[epoch] if perms is not None else self.draws.permutation("minibatch", n_mb, self.device)
                index_sets = [slice(int(i) * seq_mb, int(i) * seq_mb + seq_mb) for i in perm.tolist()]
            else:
                perm = perms[epoch] if perms is not None else self.draws.permutation("minibatch", n_envs, self.device)
                index_sets = list(perm[: n_mb * seq_mb].reshape(n_mb, seq_mb))
            for idx in index_sets:
                idx = self._local(idx)
                take = lambda x: x[idx]  # noqa: E731
                mb = (*(x[:, idx] for x in seqs), tree_map(take, batch.actor_carry0), tree_map(take, batch.critic_carry0))
                self._minibatch_step(ts, self._loss_recurrent, mb, sums, seq_mb * cfg.rollout_len)
        return ts, self._mean_metrics(sums, cfg.epochs * n_mb)

    def _optimize_iteration(self, ts: TrainState, batch: Batch, perms: list | None = None):
        ts, metrics = self._update(ts, batch, perms)
        with torch.no_grad():
            if self.cfg.recurrent:  # from a fresh carry of one env, as in JAX
                _, (_, log_std) = ts.actor(self.initial_carry(1), ts.norm.normalize(batch.obs[0, :1]))
            else:
                _, log_std = self._policy(ts.actor, ts.norm, batch.obs[0, :1])
        metrics["mean_noise_std"] = torch.mean(torch.exp(log_std))
        return ts, metrics

    def _train_iter(self, ts: TrainState):
        """One PPO iteration, sampling then optimization, with the two
        parts' metrics merged (the JAX trainer's ``_train_iter``); the
        metrics stay on the device."""
        ts, batch, roll = self._sample_iteration(ts)
        ts, aux = self._optimize_iteration(ts, batch)
        return ts, {**roll, **aux}

    def _warmup_iteration(self, ts: TrainState) -> TrainState:
        """Obs-norm warmup: rollout + Welford update, no learning. A
        recurrent warmup leaves the TrainState's carries as they were."""
        env_state, traj = self._rollout(ts, deterministic=False)
        all_reduce = None if self.shard is None else self.shard.all_reduce
        return dataclasses.replace(ts, env_state=env_state, norm=update_norm(ts.norm, traj["obs"], all_reduce))

    @torch.no_grad()
    def _eval_rollout(self, ts: TrainState, draws: Draws) -> dict:
        """Deterministic evaluation from fresh resets: ``num_envs`` envs with
        their own reset pool for ``max_traj_len`` steps, episodes truncated
        at ``max_traj_len``, unfinished ones counted. Mean episode reward and
        length (0-d tensors). A recurrent actor starts from zero carries,
        zeroed again where an episode ends."""
        cfg = self.cfg
        n, dev = cfg.num_envs, self.device
        env_state = self.env.reset_batch(n, draws, ts.iteration)
        pool = self.env.reset_batch(n, draws, ts.iteration)
        ep_ret = torch.zeros(n, device=dev)
        ep_len = torch.zeros(n, device=dev)
        ret_acc, len_acc, cnt = (torch.zeros((), device=dev) for _ in range(3))
        a_carry = self.initial_carry(n) if cfg.recurrent else None
        for _ in range(cfg.max_traj_len):
            if cfg.recurrent:
                a_carry, (mean, _) = ts.actor(a_carry, ts.norm.normalize(env_state.obs))
            else:
                mean, _ = self._policy(ts.actor, ts.norm, env_state.obs)
            stepped = self.env.step_batch(env_state, mean, draws)
            terminated = stepped.done
            done = terminated | ((stepped.steps >= cfg.max_traj_len) & ~terminated)
            ep_ret = ep_ret + stepped.reward
            ep_len = ep_len + 1.0
            ret_acc = ret_acc + torch.sum(torch.where(done, ep_ret, 0.0))
            len_acc = len_acc + torch.sum(torch.where(done, ep_len, 0.0))
            cnt = cnt + torch.sum(done.to(torch.float32))
            ep_ret = torch.where(done, 0.0, ep_ret)
            ep_len = torch.where(done, 0.0, ep_len)
            env_state = _tree_where(done, dataclasses.replace(pool, iteration=stepped.iteration), stepped)
            if cfg.recurrent:
                a_carry = mask_carry(a_carry, done)
        ret_acc = ret_acc + torch.sum(ep_ret)
        len_acc = len_acc + torch.sum(ep_len)
        cnt = cnt + torch.sum((ep_len > 0).to(torch.float32))
        return dict(eval_mean_reward=ret_acc / torch.clamp_min(cnt, 1.0),
                    eval_mean_episode_length=len_acc / torch.clamp_min(cnt, 1.0))

    def eval_draws(self, itr: int) -> Draws:
        """The draws of the evaluation at loop iteration ``itr``: a generator
        of its own (the JAX trainer folds ``itr`` into its key), so that
        evaluating leaves the training stream as it was."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.cfg.seed + 1) * 1_000_003 + itr)
        return Draws(gen)

    # ----------------------------------------------------------------- train

    def warmup_iterations(self) -> int:
        """Obs-norm warmup iterations ``train`` runs (running-norm envs only)."""
        return self.cfg.input_norm_iters if self.env.obs_mean is None else 0

    def train(self, n_itr: int | None = None, ts: TrainState | None = None, verbose: bool = True, on_iteration=None,
              logger=None, checkpointer=None, profile_dir: str | Path | None = None, evaluate: bool = True):
        """Warmup, then ``n_itr`` iterations of sampling + optimization.
        Every ``eval_freq`` iterations and at the last one, a deterministic
        evaluation (_eval_rollout), logged and, with a ``checkpointer``,
        saved as checkpoint ``itr`` (the best by eval reward also as
        best.pt), as in the JAX trainer; ``evaluate=False`` turns the
        evaluations off (they do not change the training). With
        ``profile_dir``, torch.profiler traces iterations 2-4
        (or 2 to the last) on the CPU and the card and writes a Chrome trace
        there (trace.json). Returns (final TrainState, per-iteration
        metrics); ``on_iteration(itr, metrics)`` sees each iteration's.
        Times (``time.perf_counter``) are taken after a device
        synchronization; the iteration's parts are utils/trace.py spans,
        recorded while a profiler runs. On a data-parallel
        rank other than 0, nothing is printed, evaluated, logged, saved or
        traced: it waits at a barrier while rank 0 evaluates and saves."""
        cfg = self.cfg
        n_itr = cfg.n_itr if n_itr is None else n_itr
        verbose = verbose and self.lead
        if not self.lead:
            logger = checkpointer = profile_dir = None
        ts = self.init_state() if ts is None else ts
        try:
            for _ in range(self.warmup_iterations()):
                ts = self._warmup_iteration(ts)
            history = []
            start = time.perf_counter()
            best_eval = -float("inf")
            prof = None
            for itr in range(n_itr):
                if profile_dir is not None and itr == 2:
                    prof = _start_profiler(self.device)
                with trace.span("ppo.iteration"):
                    t0 = time.perf_counter()
                    with trace.span("ppo.sample"):
                        ts, batch, roll = self._sample_iteration(ts)
                        with trace.span("host.read"):
                            roll = {k: float(v) for k, v in roll.items()}
                    t1 = time.perf_counter()
                    with trace.span("ppo.optimize"):
                        ts, aux = self._optimize_iteration(ts, batch)
                        with trace.span("host.read"):
                            aux = {k: float(v) for k, v in aux.items()}
                    t2 = time.perf_counter()
                    del batch
                    with trace.span("host.read"):
                        nonfinite = int(ts.actor_opt.nonfinite_total + ts.critic_opt.nonfinite_total)
                    fps = cfg.batch_size / max(t2 - t0, 1e-9)
                    metrics = {**roll, **aux, "sample_time": t1 - t0, "optimize_time": t2 - t1,
                               "sample_env_steps_per_s": cfg.batch_size / max(t1 - t0, 1e-9), "fps": fps,
                               "nonfinite_steps": nonfinite}
                    if verbose:
                        print(
                            f"itr {itr:5d} | reward/step {metrics['mean_reward']:.3f} | "
                            f"ep_len {metrics['mean_episode_length']:.1f} | actor {metrics['actor_loss']:.4f} | "
                            f"critic {metrics['critic_loss']:.4f} | kl {metrics['approx_kl']:.4f} | "
                            f"sample {metrics['sample_env_steps_per_s']:,.0f} env-steps/s | optimize {t2 - t1:.2f} s",
                            flush=True,
                        )
                    if logger is not None:
                        logger.log_training(itr, metrics)
                        logger.log_timing(itr, fps=fps, sample_time=t1 - t0, optimize_time=t2 - t1,
                                          total_elapsed=time.perf_counter() - start)
                    if evaluate and (itr % cfg.eval_freq == 0 or itr == n_itr - 1):
                        if self.lead:
                            with trace.span("ppo.eval"):
                                t3 = time.perf_counter()
                                evals = {k: float(v) for k, v in self._eval_rollout(ts, self.eval_draws(itr)).items()}
                                metrics.update(evals, eval_time=time.perf_counter() - t3)
                            if verbose:
                                print(f"  eval @ {itr}: reward {evals['eval_mean_reward']:.2f} "
                                      f"len {evals['eval_mean_episode_length']:.1f}", flush=True)
                            if logger is not None:
                                logger.log_eval(itr, evals)
                            if checkpointer is not None:
                                t4 = time.perf_counter()
                                is_best = evals["eval_mean_reward"] > best_eval
                                best_eval = max(best_eval, evals["eval_mean_reward"])
                                checkpointer.save(itr, ts, self.draws, metrics=evals, is_best=is_best)
                                metrics["checkpoint_time"] = time.perf_counter() - t4
                        if self.shard is not None:
                            self.shard.barrier()
                history.append(metrics)
                if on_iteration is not None:
                    on_iteration(itr, metrics)
                if prof is not None and (itr == 4 or itr == n_itr - 1):
                    path = _stop_profiler(prof, profile_dir, self.device)
                    prof = None
                    if verbose:
                        print(f"profiler trace (iterations 2-{itr}) written to {path}", flush=True)
        finally:
            trace.stop()
        return ts, history


def _start_profiler(device: torch.device):
    """torch.profiler over the CPU and, on the card, CUDA activity."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir, device: torch.device) -> Path:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    path = Path(profile_dir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return path
