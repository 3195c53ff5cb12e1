"""What the port keeps of a training run, on the CPU: the deterministic
evaluation rollout against the JAX trainer's (feed-forward on h1, recurrent
on cartpole), checkpoints (save, restore, resume; a recurrent run's too),
run discovery and the logger's tags.

Tolerances: evaluation metrics 1e-3 relative on h1 (episode sums of O(1)
rewards over a few control steps with contacts from the same injected
draws), 1e-5 relative on cartpole (smooth dynamics); a checkpoint's round
trip and a resumed run exactly (the same float32 operations in the same
order on the CPU); run discovery and tags exactly.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learninghumanoidwalking_tpu.envs.cartpole import CartpoleEnv as JaxCartpoleEnv
from learninghumanoidwalking_tpu.envs.h1_stand import H1StandEnv as JaxH1StandEnv
from learninghumanoidwalking_tpu.rl import checkpoint as jcheckpoint
from learninghumanoidwalking_tpu.rl import logger as jlogger
from learninghumanoidwalking_tpu.rl import networks as jnets
from learninghumanoidwalking_tpu.rl import normalize as jnorm
from learninghumanoidwalking_tpu.rl import ppo as jppo
from learninghumanoidwalking_tpu_torch.envs.cartpole import CartpoleEnv
from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from learninghumanoidwalking_tpu_torch.rl import checkpoint, convert, logger, networks, ppo
from learninghumanoidwalking_tpu_torch.rl.normalize import RunningNorm
from learninghumanoidwalking_tpu_torch.utils.seeding import InjectedDraws
from test_torch_h1 import h1_reset_draws, h1_step_draws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)


class QueuedDraws(InjectedDraws):
    """Injected draws served in order: each name holds a list of values,
    one per call (a reset and a pool draw the same names in turn)."""

    def __init__(self, queues: dict):
        self.queues = {k: list(v) for k, v in queues.items()}

    def _get(self, name, shape, device):
        x = torch.as_tensor(np.array(self.queues[name].pop(0)), device=device)
        assert tuple(x.shape) == tuple(shape), (name, tuple(x.shape), tuple(shape))
        return x


def _queue(*dicts) -> dict:
    out = {}
    for d in dicts:
        for k, v in d.items():
            out.setdefault(k, []).append(v)
    return out


def test_eval_rollout_matches_jax():
    """PPO._eval_rollout on h1 (4 envs, max_traj_len 8: every episode is
    truncated, so the unfinished-episode count is not needed, but the
    truncation and the reset pool are) with the JAX actor carried over and
    every draw of the JAX evaluation injected: the initial reset, the reset
    pool, then each step's from the env key chain."""
    jenv, tenv = JaxH1StandEnv(), make_env("h1", device="cpu")
    n, horizon = 4, 8
    kw = dict(num_envs=n, rollout_len=2, max_traj_len=horizon, net_dtype="float32")
    j = jppo.PPO(jenv, jppo.PPOConfig(**kw))
    t = ppo.PPO(tenv, ppo.PPOConfig(**kw), device="cpu")
    ka, kc = jax.random.split(jax.random.PRNGKey(3))
    a_params = j.actor_def.init(ka, jnp.zeros((1, jenv.obs_size)))
    c_params = j.critic_def.init(kc, jnp.zeros((1, jenv.obs_size)))
    jn = jnorm.init_norm(None, jenv.obs_mean, jenv.obs_std)
    jts = jppo.TrainState(actor_params=a_params, critic_params=c_params, actor_opt=None, critic_opt=None, norm=jn,
                          env_state=None, key=jax.random.PRNGKey(0), iteration=jnp.asarray(7, jnp.int32))
    key = jax.random.PRNGKey(9)
    jenv.reset_batch = jax.jit(jenv.reset_batch)  # one compile for the reset and the pool
    ref = {k: float(v) for k, v in j._eval_rollout(jts, key).items()}

    actor = networks.GaussianActor(tenv.obs_size, tenv.action_size)
    actor.load_state_dict(convert.actor_state_dict(convert.flatten_params(a_params), tenv.action_size))
    tts = ppo.TrainState(actor=actor, critic=None, actor_opt=None, critic_opt=None,
                         norm=convert.running_norm(jn.mean, jn.var, jn.count), env_state=None, iteration=7)
    k_env, _, k_pool = jax.random.split(key, 3)
    env_keys, pool_keys = jax.random.split(k_env, n), jax.random.split(k_pool, n)
    chain = jnp.stack([jax.random.split(k, 5)[4] for k in env_keys])
    steps = []
    for _ in range(horizon):
        steps.append(h1_step_draws(jenv, chain))
        chain = jnp.stack([jax.random.split(k, 6)[5] for k in chain])
    draws = QueuedDraws(_queue(h1_reset_draws(jenv, env_keys), h1_reset_draws(jenv, pool_keys), *steps))
    got = {k: float(v) for k, v in t._eval_rollout(tts, draws).items()}
    assert ref["eval_mean_episode_length"] == got["eval_mean_episode_length"] == horizon
    np.testing.assert_allclose(got["eval_mean_reward"], ref["eval_mean_reward"], rtol=1e-3)
    assert all(len(v) == 0 for v in draws.queues.values())  # every injected draw was used


class _JaxCartpoleEndsEvery3(JaxCartpoleEnv):
    """Cartpole whose episodes also end every 3 steps (the evaluation's
    carries are then zeroed mid-rollout)."""

    def step(self, state, action):
        s = super().step(state, action)
        return s.replace(done=s.done | (s.steps % 3 == 0))


class _CartpoleEndsEvery3(CartpoleEnv):
    def step_batch(self, states, actions, draws=None):
        s = super().step_batch(states, actions, draws)
        return dataclasses.replace(s, done=s.done | (s.steps % 3 == 0))


def test_recurrent_eval_rollout_matches_jax():
    """PPO._eval_rollout of a recurrent policy (LSTM 2x8) on cartpole, 4
    envs over 8 steps, episodes ending at steps 3 and 6 and truncated at 8:
    the actor's carry starts at zero and is zeroed at each episode end, as
    the JAX trainer's; the JAX evaluation's reset draws injected."""
    from test_torch_cartpole import cartpole_reset_draws
    from test_torch_recurrent import jax_recurrent_ppo, port_nets

    hidden, n, horizon = (8, 8), 4, 8
    jenv = _JaxCartpoleEndsEvery3()
    kw = dict(num_envs=n, rollout_len=2, max_traj_len=horizon)
    j = jax_recurrent_ppo(jenv, hidden, **kw)
    t = ppo.PPO(_CartpoleEndsEvery3(device="cpu"), ppo.PPOConfig(recurrent=True, hidden=hidden, **kw), device="cpu")
    ka, kc = jax.random.split(jax.random.PRNGKey(4))
    zero = jnets.LSTMCore.initial_carry(hidden, (1,))
    a_params = j.actor_def.init(ka, zero, jnp.zeros((1, 5)))
    c_params = j.critic_def.init(kc, zero, jnp.zeros((1, 5)))
    rng = np.random.default_rng(5)
    jn = jnorm.RunningNorm(mean=jnp.asarray(rng.standard_normal(5).astype(np.float32) * 0.2),
                           var=jnp.asarray(rng.uniform(0.3, 2, 5).astype(np.float32)), count=jnp.asarray(50.0))
    jts = jppo.TrainState(actor_params=a_params, critic_params=c_params, actor_opt=None, critic_opt=None, norm=jn,
                          env_state=None, key=jax.random.PRNGKey(0), iteration=jnp.asarray(3, jnp.int32))
    key = jax.random.PRNGKey(8)
    ref = {k: float(v) for k, v in jax.jit(j._eval_rollout)(jts, key).items()}

    actor, _ = port_nets(a_params, c_params, 5, 1, hidden)
    tts = ppo.TrainState(actor=actor, critic=None, actor_opt=None, critic_opt=None,
                         norm=convert.running_norm(jn.mean, jn.var, jn.count), env_state=None, iteration=3)
    k_env, _, k_pool = jax.random.split(key, 3)
    draws = QueuedDraws(_queue(cartpole_reset_draws(jax.random.split(k_env, n)), cartpole_reset_draws(jax.random.split(k_pool, n))))
    got = {k: float(v) for k, v in t._eval_rollout(tts, draws).items()}
    assert ref["eval_mean_episode_length"] == got["eval_mean_episode_length"] == np.float32(8 / 3)  # 3 + 3 + 2 steps an env
    np.testing.assert_allclose(got["eval_mean_reward"], ref["eval_mean_reward"], rtol=1e-5)
    assert all(len(v) == 0 for v in draws.queues.values())


def _small_trainer(seed: int = 0, **kw):
    env = make_env("h1", device="cpu")
    cfg = ppo.PPOConfig(**{**dict(num_envs=4, rollout_len=1, minibatch_size=2, epochs=1, net_dtype="float32", hidden=(16, 16),
                                  max_traj_len=2, eval_freq=1, seed=seed), **kw})
    return ppo.PPO(env, cfg, device="cpu")


def _assert_states_equal(a, b):
    for m in ("actor", "critic"):
        sa, sb = getattr(a, m).state_dict(), getattr(b, m).state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (m, k)
        oa, ob = getattr(a, m + "_opt"), getattr(b, m + "_opt")
        for x, y in zip(oa.mu + oa.nu, ob.mu + ob.nu):
            assert torch.equal(x, y), m
        assert torch.equal(oa.count, ob.count) and torch.equal(oa.notfinite_count, ob.notfinite_count), m
    for f in ("mean", "var", "count"):
        assert torch.equal(getattr(a.norm, f), getattr(b.norm, f)), f
    assert a.iteration == b.iteration


def test_checkpoint_round_trip_is_exact(tmp_path):
    """Params, Adam moments and counts (one non-finite step counted), the
    norm, the generator state and the iteration come back bit for bit, into
    a trainer built from another seed; the env batch's iteration follows."""
    trainer = _small_trainer(seed=0)
    ts = trainer.init_networks()
    gen = torch.Generator().manual_seed(5)
    for i in range(3):
        grads = [torch.randn(p.shape, generator=gen) for p in ts.actor.parameters()]
        if i == 2:
            grads[0][0, 0] = float("nan")
        ts.actor_opt.step(grads)
        ts.critic_opt.step([torch.randn(p.shape, generator=gen) for p in ts.critic.parameters()])
    ts = dataclasses.replace(ts, iteration=12, norm=RunningNorm(torch.rand(35, generator=gen), torch.rand(35, generator=gen),
                                                                      torch.tensor(42.0)))
    trainer.draws.gen.manual_seed(77)
    torch.rand(3, generator=trainer.draws.gen)
    ck = checkpoint.Checkpointer(tmp_path)
    ck.save(3, ts, trainer.draws, metrics={"eval_mean_reward": 1.5}, is_best=True)
    assert int(ts.actor_opt.notfinite_count) == 1 and float(ts.actor_opt.count) == 2.0

    other = _small_trainer(seed=1)
    target = other.init_state()
    assert not torch.equal(target.actor.trunk.layers[0].weight, ts.actor.trunk.layers[0].weight)
    restored = ck.restore(target, other.draws)
    _assert_states_equal(restored, ts)
    assert torch.equal(other.draws.gen.get_state(), trainer.draws.gen.get_state())
    assert restored.env_state.iteration.tolist() == [12] * 4
    # the restored Adam still steps the module's own parameters
    assert restored.actor_opt.params[0] is next(restored.actor.parameters())
    for best in (False, True):
        again = ck.restore(_small_trainer(seed=2).init_networks(), best=best)
        _assert_states_equal(again, ts)
    assert json.loads((tmp_path / "checkpoints" / "metrics_3.json").read_text()) == {"eval_mean_reward": 1.5}
    assert ck.latest_iteration() == 3


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """2 iterations, checkpointed at each evaluation, restored into a fresh
    trainer (another seed), 1 more iteration: the same trainer state as 3
    iterations in a row, exactly. The env batch is not in a checkpoint (as
    in the JAX package, a resumed run starts from fresh envs), so it is
    handed over here: what the checkpoint keeps must be all the rest."""
    a = _small_trainer()
    ts_a, hist_a = a.train(3, verbose=False, evaluate=False)

    b = _small_trainer()
    ck = checkpoint.Checkpointer(tmp_path)
    ts_b, hist_b = b.train(2, verbose=False, checkpointer=ck)
    assert ck.latest_iteration() == 1 and (tmp_path / "best.pt").exists()
    assert all("eval_mean_reward" in m for m in hist_b)

    c = _small_trainer(seed=3)
    target = dataclasses.replace(c.init_networks(), env_state=ts_b.env_state)
    ts_c, hist_c = c.train(1, ts=ck.restore(target, c.draws), verbose=False, evaluate=False)
    _assert_states_equal(ts_c, ts_a)
    assert ts_c.iteration == 3
    assert torch.equal(ts_c.env_state.obs, ts_a.env_state.obs)
    for k in ("actor_loss", "critic_loss", "mean_reward"):
        assert hist_c[0][k] == hist_a[2][k], k


def test_recurrent_checkpoint_round_trip_and_resume(tmp_path):
    """A recurrent run (cartpole, LSTM 2x8, no warmup): 2 iterations
    checkpointed at each evaluation, restored into a fresh trainer's
    init_state (another seed): params, both Adams, norm and iteration bit
    for bit, the carries zero. With the env batch and the carries handed
    over, 1 more iteration equals 3 in a row, exactly."""
    kw = dict(num_envs=4, rollout_len=3, minibatch_size=6, epochs=1, hidden=(8, 8), max_traj_len=4, eval_freq=1,
              input_norm_iters=0, recurrent=True)
    trainer = lambda seed: ppo.PPO(make_env("cartpole", device="cpu"), ppo.PPOConfig(seed=seed, **kw), device="cpu")
    ts_a, hist_a = trainer(0).train(3, verbose=False, evaluate=False)
    b = trainer(0)
    ck = checkpoint.Checkpointer(tmp_path)
    ts_b, _ = b.train(2, verbose=False, checkpointer=ck)
    assert ck.latest_iteration() == 1 and (tmp_path / "best.pt").exists()
    assert all(float(x.abs().max()) > 0 for pair in ts_b.actor_carry + ts_b.critic_carry for x in pair)

    c = trainer(3)
    restored = ck.restore(c.init_state(), c.draws)
    _assert_states_equal(restored, ts_b)
    assert all(float(x.abs().max()) == 0 for pair in restored.actor_carry + restored.critic_carry for x in pair)
    handed = dataclasses.replace(restored, env_state=ts_b.env_state, actor_carry=ts_b.actor_carry,
                                 critic_carry=ts_b.critic_carry)
    ts_c, hist_c = c.train(1, ts=handed, verbose=False, evaluate=False)
    _assert_states_equal(ts_c, ts_a)
    for x, y in zip(ts_c.actor_carry + ts_c.critic_carry, ts_a.actor_carry + ts_a.critic_carry):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    for k in ("actor_loss", "critic_loss", "mean_reward", "episode_reward"):
        assert hist_c[0][k] == hist_a[2][k], k


def test_find_latest_run_matches_jax(tmp_path):
    """Empty, crashed (an empty checkpoints/) and complete runs, a run
    directory given itself, and a path that does not exist."""
    base = tmp_path / "logs"
    cases = [base, tmp_path / "missing"]
    assert checkpoint.find_latest_run(base) is jcheckpoint.find_latest_run(base) is None
    (base / "h1-a" / "checkpoints").mkdir(parents=True)
    (base / "h1-b" / "checkpoints").mkdir(parents=True)
    (base / "h1-b" / "checkpoints" / "0.pt").write_bytes(b"")
    (base / "h1-c" / "checkpoints").mkdir(parents=True)  # crashed, newest
    cases += [base / "h1-a", base / "h1-b"]
    for path in cases:
        assert checkpoint.find_latest_run(path) == jcheckpoint.find_latest_run(path), path
    assert checkpoint.find_latest_run(base) == base / "h1-b"
    (base / "h1-d" / "checkpoints").mkdir(parents=True)
    (base / "h1-d" / "checkpoints" / "metrics_0.json").write_text("{}")
    assert checkpoint.find_latest_run(base) == jcheckpoint.find_latest_run(base) == base / "h1-d"


class _Recorder:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((int(step), tag, float(value)))


def test_logger_writes_the_jax_tags(tmp_path):
    """The same calls give the JAX logger's (tag, value, step) records, tag
    for tag."""
    metrics = {k: 0.5 + i for i, k in enumerate(
        ["actor_loss", "critic_loss", "mirror_loss", "imitation_loss", "entropy", "approx_kl", "clip_fraction",
         "mean_reward", "episode_reward", "mean_episode_length", "mean_noise_std", "episodes_finished", "sample_time"])}
    evals = {"eval_mean_reward": 3.25, "eval_mean_episode_length": 7.0}
    ref = object.__new__(jlogger.TrainingLogger)
    ref.writer = _Recorder()
    got = logger.TrainingLogger(tmp_path)
    for lg in (ref, got):
        lg.log_training(4, metrics)
        lg.log_timing(4, fps=1000.0, sample_time=0.25, optimize_time=0.125, total_elapsed=9.0)
        lg.log_eval(4, evals)
    got.close()
    rows = [(r["step"], r["tag"], r["value"]) for r in logger.read_log(tmp_path / "log.jsonl")]
    assert rows == ref.writer.rows
    assert len({tag for _, tag, _ in rows}) == 18


def test_profiler_hook_writes_a_trace(tmp_path, monkeypatch):
    """train(profile_dir=...) traces iterations 2 to the last (here 2) with
    torch.profiler and writes a Chrome trace whose annotated spans
    rl/trace.py reads back (on the CPU there is no device activity: every
    span is idle). The plain physics is replaced by the identity here: its
    thousands of small ops a step would make the trace hundreds of MB, and
    the hook does not depend on them. The traced iteration's spans
    (utils/trace.py) are all in it: its env steps and resets, each with its
    physics launch, the evaluation's among them (2 steps, 2 resets), its 2
    gradient steps with 2 Adam steps each and its 4 host reads."""
    from learninghumanoidwalking_tpu_torch.ops import substep_kernel
    from learninghumanoidwalking_tpu_torch.rl.trace import summarize_trace

    monkeypatch.setattr(substep_kernel, "pd_substeps_batched", lambda model, dyn, physics, *args, **kw: physics)
    trainer = _small_trainer(eval_freq=100)
    _, history = trainer.train(3, verbose=False, profile_dir=tmp_path)
    assert [("eval_time" in m) for m in history] == [True, False, True]
    summary = summarize_trace(tmp_path / "trace.json")
    assert summary["spans"]["ppo.iteration"]["count"] == 1
    assert summary["spans"]["ppo.sample"]["count"] == summary["spans"]["ppo.optimize"]["count"] == 1
    assert summary["spans"]["ppo.eval"]["count"] == 1  # the last iteration evaluates
    counts = {name: v["count"] for name, v in summary["spans"].items()}
    assert counts == {"ppo.iteration": 1, "ppo.sample": 1, "ppo.optimize": 1, "ppo.eval": 1, "ppo.grad_step": 2,
                      "ppo.adam": 4, "env.step": 3, "env.reset": 3, "physics.launch": 6, "host.read": 4}
    assert summary["top_kernels"] == [] and summary["spans"]["ppo.iteration"]["idle_share"] == 1.0
    assert (tmp_path / "trace.json").stat().st_size < 50e6
