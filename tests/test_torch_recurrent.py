"""Recurrent (LSTM) PPO in the port against the JAX trainer, on the CPU:
the LSTM actor and critic against flax's OptimizedLSTMCell stacks (weights
carried by rl/convert.py), ``_loss_recurrent`` and one Adam step, a whole
recurrent PPO iteration on cartpole with the JAX draws injected (reset
draws, action noise, minibatch order), a recurrent iteration on jvrc_walk
in the port alone, and the standalone distributions.

Inputs are numpy arrays from fixed seeds; networks run in float32 on both
sides (TF32 off). Tolerances, each relative to the largest magnitude of the
quantity: LSTM means, values and carries 1e-5; the loss, its terms and the
parameters after one Adam step 1e-5. The PPO iteration: trajectory,
carries and values 1e-5; advantages and returns 1e-4 (GAE over 6 steps
and a batch normalization); metrics and the parameters after the update
1e-4, as the feed-forward update in test_torch_ppo.py, a metric below 1e-3
to 1e-7 absolute (approx_kl after one step is ~1e-6, a difference of
nearly equal log-ratios). Distributions:
log-probabilities, entropies and means 1e-5; samples by their moments.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learninghumanoidwalking_tpu.envs.cartpole import CartpoleEnv as JaxCartpoleEnv
from learninghumanoidwalking_tpu.envs.jvrc_walk import JvrcWalkEnv as JaxJvrcWalkEnv
from learninghumanoidwalking_tpu.rl import distributions as jdist
from learninghumanoidwalking_tpu.rl import networks as jnets
from learninghumanoidwalking_tpu.rl import normalize as jnorm
from learninghumanoidwalking_tpu.rl import ppo as jppo
from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from learninghumanoidwalking_tpu_torch.rl import convert, distributions, networks, ppo
from test_torch_cartpole import cartpole_reset_draws
from test_torch_keep import QueuedDraws, _queue
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)


def rel_close(mine, theirs, rel, what="", floor=1e-8):
    mine = mine.detach().numpy() if torch.is_tensor(mine) else np.asarray(mine)
    theirs = np.asarray(theirs)
    assert mine.shape == theirs.shape, (what, mine.shape, theirs.shape)
    scale = max(float(np.max(np.abs(theirs))), floor)
    err = float(np.max(np.abs(mine - theirs)))
    assert err <= rel * scale, (what, err, scale)


def jax_recurrent_ppo(jenv, hidden, **kw):
    """The JAX trainer with recurrent nets of ``hidden`` (its default is 2x256)."""
    j = jppo.PPO(jenv, jppo.PPOConfig(recurrent=True, net_dtype="float32", **kw))
    j.actor_def = jnets.GaussianLSTMActor(action_dim=jenv.action_size, hidden=hidden)
    j.critic_def = jnets.LSTMCritic(hidden=hidden)
    j.hidden_sizes = hidden
    return j


def port_nets(a_params, c_params, obs_dim, act_dim, hidden):
    actor = networks.GaussianLSTMActor(obs_dim, act_dim, hidden)
    critic = networks.LSTMCritic(obs_dim, hidden)
    actor.load_state_dict(convert.actor_state_dict(convert.flatten_params(a_params), act_dim))
    critic.load_state_dict(convert.critic_state_dict(convert.flatten_params(c_params)))
    return actor, critic


def to_torch_carry(carry):
    return tuple((torch.as_tensor(np.asarray(c)), torch.as_tensor(np.asarray(h))) for c, h in carry)


def seeded_carry(rng, hidden, n):
    return tuple(tuple((0.3 * rng.standard_normal((n, h))).astype(np.float32) for _ in range(2)) for h in hidden)


@pytest.fixture(autouse=True, scope="module")
def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("obs_dim, hidden", [(5, (8, 8)), (37, (16, 16))])
def test_lstm_nets_match_flax(obs_dim, hidden):
    """6 steps from seeded carries, a done mask zeroing some rows' carries
    mid-sequence: means, log-stds, values and every carry; the conversion
    keeps every flax kernel (stacked gates read back exactly); the port's
    own init draws flax's distributions."""
    n, act = 7, 3
    ka, kc = jax.random.split(jax.random.PRNGKey(obs_dim))
    jactor, jcritic = jnets.GaussianLSTMActor(action_dim=act, hidden=hidden), jnets.LSTMCritic(hidden=hidden)
    zero = jnets.LSTMCore.initial_carry(hidden, (1,))
    a_params = jactor.init(ka, zero, jnp.zeros((1, obs_dim)))
    c_params = jcritic.init(kc, zero, jnp.zeros((1, obs_dim)))
    actor, critic = port_nets(a_params, c_params, obs_dim, act, hidden)

    flat = convert.flatten_params(a_params)
    sd = actor.state_dict()
    assert sd.keys() == convert.actor_state_dict(flat, act).keys()
    for i, h in enumerate(hidden):
        for k, g in enumerate("ifgo"):
            rows = slice(k * h, (k + 1) * h)
            assert np.array_equal(sd[f"core.cells.{i}.ih.weight"][rows].numpy().T, flat[f"params/LSTMCore_0/lstm{i}/i{g}/kernel"])
            assert np.array_equal(sd[f"core.cells.{i}.hh.weight"][rows].numpy().T, flat[f"params/LSTMCore_0/lstm{i}/h{g}/kernel"])
            assert np.array_equal(sd[f"core.cells.{i}.hh.bias"][rows].numpy(), flat[f"params/LSTMCore_0/lstm{i}/h{g}/bias"])

    rng = np.random.default_rng(obs_dim)
    obs = rng.standard_normal((6, n, obs_dim)).astype(np.float32)
    done = rng.random((6, n)) < 0.3
    ja = jc = seeded_carry(rng, hidden, n)
    ta, tc = to_torch_carry(ja), to_torch_carry(jc)
    mask_j = lambda carry, d: jax.tree.map(lambda x: jnp.where(d[:, None], 0.0, x), carry)
    apply_a, apply_c = jax.jit(jactor.apply), jax.jit(jcritic.apply)
    for t in range(6):
        ja, jc = mask_j(ja, done[t]), mask_j(jc, done[t])
        ta, tc = ppo.mask_carry(ta, torch.as_tensor(done[t])), ppo.mask_carry(tc, torch.as_tensor(done[t]))
        ja, (jm, jls) = apply_a(a_params, ja, jnp.asarray(obs[t]))
        jc, jv = apply_c(c_params, jc, jnp.asarray(obs[t]))
        with torch.no_grad():
            ta, (tm, tls) = actor(ta, torch.as_tensor(obs[t]))
            tc, tv = critic(tc, torch.as_tensor(obs[t]))
        rel_close(tm, jm, 1e-5, "mean")
        rel_close(tls, jls, 1e-5, "log_std")
        rel_close(tv, jv, 1e-5, "value")
        for (c0, h0), (c1, h1) in zip(ta + tc, ja + jc):
            rel_close(c0, c1, 1e-5, "c")
            rel_close(h0, h1, 1e-5, "h")
    assert done.any() and not done.all()

    gen = torch.Generator().manual_seed(0)
    own = networks.GaussianLSTMActor(obs_dim, act, (64, 64), gen=gen)
    fan_ins = (obs_dim, 64)
    for i, cell in enumerate(own.core.cells):
        std = math.sqrt(1.0 / fan_ins[i])
        w = cell.ih.weight.detach()
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6 and abs(float(w.std()) / std - 1) < 0.1
        for k in range(4):
            blk = cell.hh.weight.detach()[k * 64 : (k + 1) * 64]
            assert torch.allclose(blk @ blk.T, torch.eye(64), atol=1e-5)
        assert float(cell.hh.bias.detach().abs().max()) == 0.0


def _loss_case(name):
    if name == "jvrc_walk":
        return JaxJvrcWalkEnv(), make_env("jvrc_walk", device="cpu")
    return JaxCartpoleEnv(), make_env("cartpole", device="cpu")


@pytest.mark.parametrize("name", ["jvrc_walk", "cartpole"])
def test_loss_recurrent_and_adam_step_match_jax(name):
    """_loss_recurrent on one minibatch of 3 env sequences of 4 steps with
    episodes ending mid-sequence and seeded first carries (jvrc_walk with
    its mirror matrices, cartpole without), then one Adam step of each net."""
    jenv, tenv = _loss_case(name)
    hidden, T, b = (16, 16), 4, 3
    kw = dict(num_envs=b, rollout_len=T, minibatch_size=T * b, epochs=1)
    j = jax_recurrent_ppo(jenv, hidden, **kw)
    t = ppo.PPO(tenv, ppo.PPOConfig(recurrent=True, hidden=hidden, **kw), device="cpu")
    assert (t.obs_mirror is None) == (name == "cartpole") == (j.obs_mirror is None)
    ka, kc = jax.random.split(jax.random.PRNGKey(11))
    zero = jnets.LSTMCore.initial_carry(hidden, (1,))
    o = jenv.obs_size
    a_params = j.actor_def.init(ka, zero, jnp.zeros((1, o)))
    c_params = j.critic_def.init(kc, zero, jnp.zeros((1, o)))
    actor, critic = port_nets(a_params, c_params, o, jenv.action_size, hidden)

    rng = np.random.default_rng(12)
    if jenv.obs_mean is not None:
        jn = jnorm.init_norm(None, jenv.obs_mean, jenv.obs_std)
    else:
        jn = jnorm.RunningNorm(mean=jnp.asarray(rng.standard_normal(o).astype(np.float32) * 0.1),
                               var=jnp.asarray(rng.uniform(0.5, 2, o).astype(np.float32)), count=jnp.asarray(100.0))
    tn = convert.running_norm(jn.mean, jn.var, jn.count)
    obs = (rng.standard_normal((T, b, o)) * 0.5).astype(np.float32)
    actions = (0.3 * rng.standard_normal((T, b, jenv.action_size))).astype(np.float32)
    old_lp = (rng.standard_normal((T, b)) * 0.5 + 2.0).astype(np.float32)
    adv, ret = rng.standard_normal((T, b)).astype(np.float32), rng.standard_normal((T, b)).astype(np.float32)
    done = np.zeros((T, b), bool)
    done[1, 0] = done[2, 2] = True
    a_c0, c_c0 = seeded_carry(rng, hidden, b), seeded_carry(rng, hidden, b)
    seqs = (obs, actions, old_lp, adv, ret, done)

    grad_fn = jax.jit(jax.value_and_grad(j._loss_recurrent, argnums=(0, 1), has_aux=True))
    jmb = (*map(jnp.asarray, seqs), jax.tree.map(jnp.asarray, a_c0), jax.tree.map(jnp.asarray, c_c0))
    (jtotal, jaux), (jga, jgc) = grad_fn(a_params, c_params, jn, jmb)
    tmb = (*map(torch.as_tensor, seqs), to_torch_carry(a_c0), to_torch_carry(c_c0))
    total, aux = t._loss_recurrent(actor, critic, tn, tmb)
    rel_close(total, jtotal, 1e-5, "total")
    for k in ("actor_loss", "critic_loss", "entropy", "mirror_loss", "imitation_loss", "approx_kl", "clip_fraction"):
        rel_close(aux[k], jaux[k], 1e-5, k)
    assert (float(jaux["mirror_loss"]) > 0) == (name == "jvrc_walk")

    a_opt, c_opt = j.actor_tx.init(a_params), j.critic_tx.init(c_params)
    ua, _ = j.actor_tx.update(jga, a_opt, a_params)
    uc, _ = j.critic_tx.update(jgc, c_opt, c_params)
    import optax

    want_a = convert.actor_state_dict(convert.flatten_params(optax.apply_updates(a_params, ua)), jenv.action_size)
    want_c = convert.critic_state_dict(convert.flatten_params(optax.apply_updates(c_params, uc)))
    a_list, c_list = list(actor.parameters()), list(critic.parameters())
    grads = torch.autograd.grad(total, a_list + c_list)
    ppo.Adam(a_list, 3e-4, 1e-5, 0.5).step(list(grads[: len(a_list)]))
    ppo.Adam(c_list, 3e-4, 1e-5, 0.5).step(list(grads[len(a_list):]))
    for net, want in ((actor, want_a), (critic, want_c)):
        for pname, p in net.named_parameters():
            rel_close(p, want[pname], 1e-5, pname)


@pytest.fixture(scope="module")
def cartpole_iteration():
    """One recurrent PPO iteration of the JAX trainer on cartpole (4 envs,
    rollout 6, 2 sequence minibatches, 1 epoch), from its init_state."""
    hidden, n, T = (8, 8), 4, 6
    kw = dict(num_envs=n, rollout_len=T, minibatch_size=2 * T, epochs=1, max_traj_len=4)
    jenv = JaxCartpoleEnv()
    j = jax_recurrent_ppo(jenv, hidden, **kw)
    key = jax.random.PRNGKey(5)
    jts0 = j.init_state(key)
    jts1, batch, k_upd, roll = jax.jit(j._sample_iteration)(jts0)
    jts2, aux = jax.jit(j._optimize_iteration)(jts1, batch, k_upd)
    # the draws the JAX trainer made: the env batch, the reset pool, each
    # step's action noise, the minibatch order
    _, _, k_env, _ = jax.random.split(key, 4)
    _, k_roll, _ = jax.random.split(jts0.key, 3)
    k_chain, k_pool = jax.random.split(k_roll)
    noise = []
    for _ in range(T):
        k_chain, k_act = jax.random.split(k_chain)
        noise.append(np.asarray(jax.random.normal(k_act, (n, 1))))
    perms = [torch.as_tensor(np.array(jax.random.permutation(k, 2))) for k in jax.random.split(k_upd, 1)]
    draws = dict(env=cartpole_reset_draws(jax.random.split(k_env, n)), pool=cartpole_reset_draws(jax.random.split(k_pool, n)),
                 noise=noise, perms=perms)
    return j, jts0, jts1, jts2, batch, roll, aux, draws, dict(hidden=hidden, **kw)


def test_recurrent_iteration_on_cartpole_matches_jax(cartpole_iteration):
    """Sampling (rollout with the carries, bootstrap values from the
    stepped carries, masks at episode ends, GAE) and the update (BPTT over
    sequence minibatches from the rollout's first carries), against the
    JAX trainer with its draws injected: the trajectory, advantages,
    returns, carries after the rollout, the metrics and the parameters."""
    j, jts0, jts1, jts2, jbatch, jroll, jaux, draws, kw = cartpole_iteration
    tenv = make_env("cartpole", device="cpu")
    t = ppo.PPO(tenv, ppo.PPOConfig(recurrent=True, net_dtype="float32", **kw), device="cpu",
                draws=QueuedDraws(_queue(draws["env"], draws["pool"], *({"action": x} for x in draws["noise"]))))
    ts = t.init_networks()
    ts.actor.load_state_dict(convert.actor_state_dict(convert.flatten_params(jts0.actor_params), 1))
    ts.critic.load_state_dict(convert.critic_state_dict(convert.flatten_params(jts0.critic_params)))
    ts = ppo.dataclasses.replace(ts, env_state=tenv.reset_batch(kw["num_envs"], t.draws),
                                 norm=convert.running_norm(jts0.norm.mean, jts0.norm.var, jts0.norm.count))
    assert all(float(x.abs().max()) == 0 for pair in ts.actor_carry + ts.critic_carry for x in pair)

    ts1, batch, roll = t._sample_iteration(ts)
    assert all(len(v) == 0 for v in t.draws.queues.values())  # every injected draw was used
    for name in ("obs", "actions", "log_probs"):
        rel_close(getattr(batch, name), getattr(jbatch, name), 1e-5, name)
    assert batch.done.tolist() == np.asarray(jbatch.done).tolist() and bool(batch.done.any())
    for name in ("advantages", "returns"):
        rel_close(getattr(batch, name), getattr(jbatch, name), 1e-4, name)
    for mine, ref in ((ts1.actor_carry, jts1.actor_carry), (ts1.critic_carry, jts1.critic_carry)):
        for (c0, h0), (c1, h1) in zip(mine, ref):
            rel_close(c0, c1, 1e-5, "c")
            rel_close(h0, h1, 1e-5, "h")
    rel_close(ts1.env_state.obs, jts1.env_state.obs, 1e-5, "env obs")
    assert ts1.iteration == int(jts1.iteration) == 1
    for k, v in roll.items():
        rel_close(v, jroll[k], 1e-4, k, floor=1e-3)

    ts2, aux = t._optimize_iteration(ts1, batch, draws["perms"])
    for k, v in aux.items():
        rel_close(v, jaux[k], 1e-4, k, floor=1e-3)
    want_a = convert.actor_state_dict(convert.flatten_params(jts2.actor_params), 1)
    want_c = convert.critic_state_dict(convert.flatten_params(jts2.critic_params))
    for net, want in ((ts2.actor, want_a), (ts2.critic, want_c)):
        for pname, p in net.named_parameters():
            rel_close(p, want[pname], 1e-4, pname)


def test_recurrent_iteration_on_jvrc_walk():
    """The port alone (the JAX package's test_recurrent_humanoid_iteration
    is the reference case): 4 envs, rollout 4, env 0 made to finish at
    every step. Finite losses; after the rollout the carries are zero in
    env 0's rows and non-zero in the others'."""
    tenv = make_env("jvrc_walk", device="cpu")
    cfg = ppo.PPOConfig(recurrent=True, num_envs=4, rollout_len=4, minibatch_size=8, epochs=1, hidden=(16, 16), seed=0)
    t = ppo.PPO(tenv, cfg, device="cpu")
    done = tenv._done
    tenv._done = lambda physics: done(physics) | (torch.arange(4) == 0)
    ts, batch, roll = t._sample_iteration(t.init_state())
    assert bool(batch.done[:, 0].all()) and batch.actor_carry0 is not None
    for c, h in ts.actor_carry + ts.critic_carry:
        assert float(c[0].abs().max()) == float(h[0].abs().max()) == 0.0
        assert bool((c[1:].abs().amax(1) > 0).all()) and bool((h[1:].abs().amax(1) > 0).all())
    ts, aux = t._optimize_iteration(ts, batch)
    for k in ("actor_loss", "critic_loss", "mirror_loss", "approx_kl", "mean_noise_std"):
        assert math.isfinite(float(aux[k])), (k, aux[k])
    assert float(aux["mirror_loss"]) > 0 and math.isfinite(float(roll["episode_reward"]))
    assert ts.iteration == 1


def test_distributions_match_jax():
    """DiagonalGaussian, Beta and BoundedBeta: log-probabilities,
    entropies and means against the JAX classes on the same inputs; the
    samples from a torch.Generator by their moments against the exact ones
    (20000 draws each: 5 standard errors)."""
    rng = np.random.default_rng(7)
    mean = rng.standard_normal((4, 3)).astype(np.float32)
    std = rng.uniform(0.2, 1.5, (4, 3)).astype(np.float32)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    jg, tg = jdist.DiagonalGaussian(jnp.asarray(mean), jnp.asarray(std)), distributions.DiagonalGaussian(torch.as_tensor(mean), torch.as_tensor(std))
    rel_close(tg.log_prob(torch.as_tensor(x)), jg.log_prob(jnp.asarray(x)), 1e-5, "gaussian log_prob")
    rel_close(tg.entropy(), jg.entropy(), 1e-5, "gaussian entropy")
    gen = torch.Generator().manual_seed(0)
    g = distributions.DiagonalGaussian(torch.zeros(20000, 2), torch.tensor([0.5, 2.0]))
    s = g.sample(gen)
    assert torch.allclose(s.mean(0), torch.zeros(2), atol=5 * 2.0 / math.sqrt(20000))
    assert torch.allclose(s.std(0), torch.tensor([0.5, 2.0]), rtol=0.05)

    la, lb = rng.standard_normal((4, 3)).astype(np.float32), rng.standard_normal((4, 3)).astype(np.float32)
    u = rng.uniform(0.01, 0.99, (4, 3)).astype(np.float32)
    for jcls, tcls, xs in ((jdist.Beta, distributions.Beta, u), (jdist.BoundedBeta, distributions.BoundedBeta, 2 * u - 1)):
        jb = jcls.from_logits(jnp.asarray(la), jnp.asarray(lb))
        tb = tcls.from_logits(torch.as_tensor(la), torch.as_tensor(lb))
        assert type(tb) is distributions.Beta  # from_logits builds a Beta, as in JAX
        tb = tcls(tb.alpha, tb.beta)
        jb = jcls(jb.alpha, jb.beta)
        rel_close(tb.alpha, jb.alpha, 1e-6, "alpha")
        rel_close(tb.log_prob(torch.as_tensor(xs)), jb.log_prob(jnp.asarray(xs)), 1e-5, f"{tcls.__name__} log_prob")
        rel_close(tb.mean(), jb.mean(), 1e-6, f"{tcls.__name__} mean")
    for a_, b_ in ((2.5, 1.5), (1.0, 4.0), (0.5, 0.7)):
        beta = distributions.BoundedBeta(torch.full((20000,), a_), torch.full((20000,), b_))
        s = beta.sample(gen)
        m = a_ / (a_ + b_)
        var = 4 * a_ * b_ / ((a_ + b_) ** 2 * (a_ + b_ + 1))
        assert float(s.min()) >= -1 and float(s.max()) <= 1
        assert abs(float(s.mean()) - (2 * m - 1)) < 5 * math.sqrt(var / 20000), (a_, b_)
        assert abs(float(s.var()) / var - 1) < 0.05, (a_, b_)


def test_convert_carries_a_recurrent_jax_checkpoint(tmp_path):
    """The JAX Checkpointer's persisted tree of a recurrent run (LSTM
    params, optax Adam states after two steps, norm, iteration; no
    carries), carried over by rl/convert.py::checkpoint_from_jax, restores
    into a recurrent port trainer: the same policy (1e-5) and the same
    next Adam step as optax (1e-5), its carries zero."""
    import optax

    from learninghumanoidwalking_tpu.rl.checkpoint import Checkpointer as JaxCheckpointer
    from learninghumanoidwalking_tpu_torch.rl.checkpoint import Checkpointer

    hidden = (8, 8)
    jenv, tenv = JaxCartpoleEnv(), make_env("cartpole", device="cpu")
    j = jax_recurrent_ppo(jenv, hidden, num_envs=2, rollout_len=2)
    zero = jnets.LSTMCore.initial_carry(hidden, (1,))
    ka, kc = jax.random.split(jax.random.PRNGKey(21))
    a_params = j.actor_def.init(ka, zero, jnp.zeros((1, 5)))
    c_params = j.critic_def.init(kc, zero, jnp.zeros((1, 5)))
    a_opt, c_opt = j.actor_tx.init(a_params), j.critic_tx.init(c_params)
    rng = np.random.default_rng(22)
    rand_like = lambda tree: jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)), tree)
    step_a = jax.jit(lambda g, o, p: (lambda u, o: (optax.apply_updates(p, u), o))(*j.actor_tx.update(g, o, p)))
    step_c = jax.jit(lambda g, o, p: (lambda u, o: (optax.apply_updates(p, u), o))(*j.critic_tx.update(g, o, p)))
    for _ in range(2):
        a_params, a_opt = step_a(rand_like(a_params), a_opt, a_params)
        c_params, c_opt = step_c(rand_like(c_params), c_opt, c_params)
    norm = jnorm.RunningNorm(mean=jnp.asarray(rng.standard_normal(5).astype(np.float32)),
                             var=jnp.asarray(rng.uniform(0.5, 2, 5).astype(np.float32)), count=jnp.asarray(64.0))
    jts = jppo.TrainState(actor_params=a_params, critic_params=c_params, actor_opt=a_opt, critic_opt=c_opt, norm=norm,
                          env_state=None, key=jax.random.PRNGKey(0), iteration=jnp.asarray(9, jnp.int32))
    tree = jax.device_get(JaxCheckpointer._persistable(jts))
    Checkpointer(tmp_path).save_state(0, convert.checkpoint_from_jax(tree, action_dim=1))
    t = ppo.PPO(tenv, ppo.PPOConfig(recurrent=True, hidden=hidden, num_envs=2, rollout_len=2), device="cpu")
    ts = Checkpointer(tmp_path).restore(t.init_networks())
    assert ts.iteration == 9 and float(ts.actor_opt.count) == 2.0
    assert all(float(x.abs().max()) == 0 for pair in ts.actor_carry + ts.critic_carry for x in pair)

    obs = rng.standard_normal((3, 5)).astype(np.float32)
    carry = seeded_carry(rng, hidden, 3)
    _, (jm, _) = j.actor_def.apply(a_params, jax.tree.map(jnp.asarray, carry), norm.normalize(jnp.asarray(obs)))
    with torch.no_grad():
        _, (tm, _) = ts.actor(to_torch_carry(carry), ts.norm.normalize(torch.as_tensor(obs)))
    rel_close(tm, jm, 1e-5, "mean")

    g = rand_like(c_params)
    c_params2, c_opt2 = step_c(g, c_opt, c_params)
    want = convert.critic_state_dict(convert.flatten_params(c_params2))
    tg = convert.critic_state_dict(convert.flatten_params(g))
    ts.critic_opt.step([tg[n] for n, _ in ts.critic.named_parameters()])
    for name, p in ts.critic.named_parameters():
        rel_close(p, want[name], 1e-5, name)
    assert float(ts.critic_opt.count) == int(c_opt2.inner_state[1][0].count) == 3
