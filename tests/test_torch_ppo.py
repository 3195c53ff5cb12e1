"""The port's networks, losses, GAE, Welford merge and update step against
the JAX trainer, with weights carried over by rl/convert.py.

All inputs are numpy arrays from a fixed seed; the minibatch order of the
update is replayed from the JAX key schedule. Networks run in float32 on
both sides (TF32 off). Tolerances: GAE and the Welford merge 1e-6 (same
f32 recurrences); network outputs 1e-5 absolute; loss components and
gradients 1e-4 relative to each quantity's largest magnitude; parameters
after one update 1e-4 relative (two Adam steps on those gradients). The
imitation loss 1e-6 (the same masked MSE on the same float32 inputs); a
converted JAX checkpoint's policy 1e-5 absolute and its next Adam step
1e-6 relative, as the Adam test.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from learninghumanoidwalking_tpu.envs.jvrc_walk import JvrcWalkEnv as JaxJvrcWalkEnv
from learninghumanoidwalking_tpu.rl import gae as jgae
from learninghumanoidwalking_tpu.rl import normalize as jnorm
from learninghumanoidwalking_tpu.rl import ppo as jppo
from learninghumanoidwalking_tpu_torch.envs.jvrc_walk import JvrcWalkEnv
from learninghumanoidwalking_tpu_torch.rl import convert, networks, normalize, ppo
from learninghumanoidwalking_tpu_torch.rl.gae import compute_gae
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)

N_MB = 64  # samples per loss evaluation


@pytest.fixture(scope="module")
def setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jenv = JaxJvrcWalkEnv()
    tenv = JvrcWalkEnv(device="cpu")
    kw = dict(num_envs=8, rollout_len=4, minibatch_size=16, epochs=1, net_dtype="float32")
    j = jppo.PPO(jenv, jppo.PPOConfig(**kw))
    t = ppo.PPO(tenv, ppo.PPOConfig(**kw), device="cpu")
    ka, kc = jax.random.split(jax.random.PRNGKey(0))
    dummy = jnp.zeros((1, jenv.obs_size))
    a_params = j.actor_def.init(ka, dummy)
    c_params = j.critic_def.init(kc, dummy)
    actor = networks.GaussianActor(tenv.obs_size, tenv.action_size)
    critic = networks.Critic(tenv.obs_size)
    actor.load_state_dict(convert.actor_state_dict(convert.flatten_params(a_params), tenv.action_size))
    critic.load_state_dict(convert.critic_state_dict(convert.flatten_params(c_params)))
    jn = jnorm.init_norm(None, jenv.obs_mean, jenv.obs_std)
    tn = convert.running_norm(jn.mean, jn.var, jn.count)
    return j, t, a_params, c_params, actor, critic, jn, tn


def _minibatch(seed, n=N_MB):
    rng = np.random.default_rng(seed)
    obs = (rng.standard_normal((n, 37)) * 0.5).astype(np.float32)
    obs[:, 29:31] = np.clip(obs[:, 29:31], -1, 1)
    actions = (0.3 * rng.standard_normal((n, 12))).astype(np.float32)
    old_lp = (rng.standard_normal(n) * 0.5 + 8.0).astype(np.float32)
    adv = rng.standard_normal(n).astype(np.float32)
    ret = rng.standard_normal(n).astype(np.float32)
    return obs, actions, old_lp, adv, ret


def _rel_close(mine, theirs, rel):
    mine, theirs = np.asarray(mine), np.asarray(theirs)
    scale = max(float(np.max(np.abs(theirs))), 1e-8)
    assert mine.shape == theirs.shape
    assert float(np.max(np.abs(mine - theirs))) <= rel * scale, (np.max(np.abs(mine - theirs)), scale)


def test_gae_matches_jax():
    rng = np.random.default_rng(0)
    T, B = 6, 9
    r, v, nv = (rng.standard_normal((T, B)).astype(np.float32) for _ in range(3))
    term = rng.random((T, B)) < 0.2
    done = term | (rng.random((T, B)) < 0.1)
    ja, jr = jgae.compute_gae(*map(jnp.asarray, (r, v, nv, term, done)), 0.99, 0.95)
    ta, tr = compute_gae(*map(torch.as_tensor, (r, v, nv, term, done)), 0.99, 0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)


def test_welford_merge_matches_jax():
    rng = np.random.default_rng(1)
    mean, std = rng.standard_normal(5).astype(np.float32), rng.uniform(0.5, 2, 5).astype(np.float32)
    batch = (rng.standard_normal((3, 7, 5)) * 2 + 1).astype(np.float32)
    j = jnorm.update_norm(jnorm.RunningNorm(mean=jnp.asarray(mean), var=jnp.asarray(std**2), count=jnp.asarray(30.0)), jnp.asarray(batch))
    j = jnorm.update_norm(j, jnp.asarray(batch[:, :3] * 0.5))
    t = normalize.update_norm(convert.running_norm(mean, std**2, 30.0), torch.as_tensor(batch))
    t = normalize.update_norm(t, torch.as_tensor(batch[:, :3] * 0.5))
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)), rtol=1e-6, atol=1e-6)


def test_convert_transposes_flax_kernels(setup):
    _, _, a_params, c_params, actor, critic, _, _ = setup
    k0 = np.asarray(a_params["params"]["MLPTrunk_0"]["Dense_0"]["kernel"])  # (in, out)
    assert k0.shape == (37, 256)
    assert tuple(actor.trunk.layers[0].weight.shape) == (256, 37)
    np.testing.assert_array_equal(actor.trunk.layers[0].weight.detach().numpy(), k0.T)
    head = np.asarray(c_params["params"]["Dense_0"]["kernel"])
    np.testing.assert_array_equal(critic.value.weight.detach().numpy(), head.T)


def test_convert_matches_jax_policy_on_jvrc_step():
    """Flax parameters for jvrc_step's 39-D observations, carried over by
    rl/convert.py, give the port the JAX policy and value (1e-5 absolute),
    with jvrc_step's fixed observation normalization on both sides."""
    from learninghumanoidwalking_tpu.envs.jvrc_step import JvrcStepEnv as JaxJvrcStepEnv
    from learninghumanoidwalking_tpu_torch.envs.jvrc_step import JvrcStepEnv

    torch.backends.cuda.matmul.allow_tf32 = False
    jenv, tenv = JaxJvrcStepEnv(), JvrcStepEnv(device="cpu")
    assert jenv.obs_size == tenv.obs_size == 39
    kw = dict(num_envs=8, rollout_len=4, minibatch_size=16, epochs=1, net_dtype="float32")
    j = jppo.PPO(jenv, jppo.PPOConfig(**kw))
    t = ppo.PPO(tenv, ppo.PPOConfig(**kw), device="cpu")
    ka, kc = jax.random.split(jax.random.PRNGKey(1))
    a_params = j.actor_def.init(ka, jnp.zeros((1, 39)))
    c_params = j.critic_def.init(kc, jnp.zeros((1, 39)))
    actor = networks.GaussianActor(39, tenv.action_size)
    critic = networks.Critic(39)
    actor.load_state_dict(convert.actor_state_dict(convert.flatten_params(a_params), tenv.action_size))
    critic.load_state_dict(convert.critic_state_dict(convert.flatten_params(c_params)))
    jn = jnorm.init_norm(None, jenv.obs_mean, jenv.obs_std)
    tn = convert.running_norm(jn.mean, jn.var, jn.count)
    obs = (np.random.default_rng(4).standard_normal((N_MB, 39)) * 0.5).astype(np.float32)
    jm, jls = j._policy(a_params, jn, jnp.asarray(obs))
    tm, tls = t._policy(actor, tn, torch.as_tensor(obs))
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tls.detach().numpy(), np.asarray(jls), rtol=0, atol=1e-5)
    tv = t._value(critic, tn, torch.as_tensor(obs))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(j._value(c_params, jn, jnp.asarray(obs))), rtol=0, atol=1e-5)


def test_networks_match_jax(setup):
    j, t, a_params, c_params, actor, critic, jn, tn = setup
    obs = _minibatch(2)[0]
    jm, jls = j._policy(a_params, jn, jnp.asarray(obs))
    tm, tls = t._policy(actor, tn, torch.as_tensor(obs))
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tls.detach().numpy(), np.asarray(jls), rtol=0, atol=1e-5)
    jv = j._value(c_params, jn, jnp.asarray(obs))
    tv = t._value(critic, tn, torch.as_tensor(obs))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=0, atol=1e-5)


def test_loss_and_gradients_match_jax(setup):
    j, t, a_params, c_params, actor, critic, jn, tn = setup
    mb = _minibatch(3)
    grad_fn = jax.value_and_grad(j._loss_fn, argnums=(0, 1), has_aux=True)
    (jtotal, jaux), (jga, jgc) = grad_fn(a_params, c_params, jn, tuple(map(jnp.asarray, mb)))
    total, aux = t._loss_fn(actor, critic, tn, tuple(map(torch.as_tensor, mb)))
    params = list(actor.named_parameters()) + list(critic.named_parameters())
    grads = torch.autograd.grad(total, [p for _, p in params])
    _rel_close(total.item(), float(jtotal), 1e-4)
    for k in ("actor_loss", "critic_loss", "entropy", "mirror_loss", "approx_kl", "clip_fraction"):
        _rel_close(aux[k].item(), float(jaux[k]), 1e-4)
    want = {**{"a." + k: v for k, v in convert.actor_state_dict(convert.flatten_params(jga), 12).items()},
            **{"c." + k: v for k, v in convert.critic_state_dict(convert.flatten_params(jgc)).items()}}
    n_actor = len(list(actor.parameters()))
    for i, ((name, _), g) in enumerate(zip(params, grads)):
        key = ("a." if i < n_actor else "c.") + name
        _rel_close(g.numpy(), want[key].numpy(), 1e-4)


def test_update_step_matches_jax(setup):
    j, t, a_params, c_params, actor, critic, jn, tn = setup
    T, B = 4, 8
    obs, actions, old_lp, adv, ret = _minibatch(4, T * B)
    shape = lambda x: x.reshape((T, B) + x.shape[1:])
    jbatch = jppo.Batch(*(jnp.asarray(shape(x)) for x in (obs, actions, old_lp, adv, ret)))
    jts = jppo.TrainState(
        actor_params=a_params, critic_params=c_params, actor_opt=j.actor_tx.init(a_params),
        critic_opt=j.critic_tx.init(c_params), norm=jn, env_state=None, key=jax.random.PRNGKey(0),
        iteration=jnp.zeros((), jnp.int32),
    )
    key = jax.random.PRNGKey(7)
    jts2, _ = j._update(jts, jbatch, key)
    # the minibatch order JAX drew: one permutation of the 2 minibatches per epoch
    perms = [torch.as_tensor(np.array(jax.random.permutation(k, 2))) for k in jax.random.split(key, 1)]

    actor2 = networks.GaussianActor(37, 12)
    critic2 = networks.Critic(37)
    actor2.load_state_dict(actor.state_dict())
    critic2.load_state_dict(critic.state_dict())
    tts = ppo.TrainState(
        actor=actor2, critic=critic2,
        actor_opt=ppo.Adam(list(actor2.parameters()), 3e-4, 1e-5, 0.5),
        critic_opt=ppo.Adam(list(critic2.parameters()), 3e-4, 1e-5, 0.5),
        norm=tn, env_state=None, iteration=0,
    )
    tbatch = ppo.Batch(*(torch.as_tensor(shape(x)) for x in (obs, actions, old_lp, adv, ret)))
    tts2, _ = t._update(tts, tbatch, perms)
    want_a = convert.actor_state_dict(convert.flatten_params(jts2.actor_params), 12)
    want_c = convert.critic_state_dict(convert.flatten_params(jts2.critic_params))
    moved = 0.0
    for name, p in tts2.actor.named_parameters():
        _rel_close(p.detach().numpy(), want_a[name].numpy(), 1e-4)
        moved = max(moved, float((p.detach() - actor.state_dict()[name]).abs().max()))
    for name, p in tts2.critic.named_parameters():
        _rel_close(p.detach().numpy(), want_c[name].numpy(), 1e-4)
    assert moved > 1e-5  # the update did change the weights


def test_adam_skips_nonfinite_steps_as_optax_does():
    """The port's Adam against optax.apply_if_finite(chain(clip_by_global_norm,
    adam), max_consecutive_errors=100), as the JAX trainer builds it (lr
    3e-4, eps 1e-5, max_norm 0.5), over one gradient sequence: finite
    steps; one finite gradient of entries 1e20, whose squared norm
    overflows float32 (applied: clipped to zero, the moments and the count
    advance); 101 consecutive gradients holding a NaN (100 skipped, the
    101st applied, which makes everything NaN); finite steps again.
    Parameters, both moments and the count are compared after every step,
    1e-6 relative to each quantity's largest magnitude, NaN where NaN."""
    import optax

    rng = np.random.default_rng(11)
    shapes = [(3, 4), (4,), (2,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4, eps=1e-5)), max_consecutive_errors=100
    )
    j_params = [jnp.asarray(p) for p in p0]
    j_state = tx.init(j_params)
    j_step = jax.jit(lambda g, s, p: tx.update(g, s, p))
    t_params = [torch.tensor(p) for p in p0]
    opt = ppo.Adam(t_params, 3e-4, 1e-5, 0.5)

    def grads(kind):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        if kind == "huge":
            g = [np.full(s, 1e20, np.float32) for s in shapes]
        elif kind == "nan":
            g[1][2] = np.nan
        return g

    seq = ["finite"] * 4 + ["huge"] + ["finite"] * 2 + ["nan"] * 101 + ["finite"] * 3

    def close(mine, theirs, what):
        mine, theirs = np.asarray(mine, np.float64), np.asarray(theirs, np.float64)
        np.testing.assert_array_equal(np.isnan(mine), np.isnan(theirs), err_msg=what)
        ok = ~np.isnan(theirs)
        scale = max(float(np.max(np.abs(theirs[ok]), initial=0.0)), 1e-30)
        assert float(np.max(np.abs(mine[ok] - theirs[ok]), initial=0.0)) <= 1e-6 * scale, what

    for i, kind in enumerate(seq):
        g = grads(kind)
        updates, j_state = j_step([jnp.asarray(x) for x in g], j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.step([torch.tensor(x) for x in g])
        adam = j_state.inner_state[1][0]
        where = f"step {i} ({kind})"
        assert float(opt.count) == int(adam.count), where
        for k in range(len(shapes)):
            close(t_params[k].numpy(), j_params[k], f"{where} param {k}")
            close(opt.mu[k].numpy(), adam.mu[k], f"{where} mu {k}")
            close(opt.nu[k].numpy(), adam.nu[k], f"{where} nu {k}")
        assert int(opt.notfinite_count) == int(j_state.notfinite_count), where
    # the overflow step was applied, the 101st NaN step too
    assert int(adam.count) == 4 + 1 + 2 + 1 + 3
    assert np.isnan(np.asarray(j_params[0])).all()


def test_imitation_loss_matches_jax():
    from learninghumanoidwalking_tpu.rl import imitation as jimitation
    from learninghumanoidwalking_tpu_torch.rl import imitation

    rng = np.random.default_rng(8)
    n = 40
    student = rng.standard_normal((n, 10)).astype(np.float32)
    expert = rng.standard_normal((n, 6)).astype(np.float32)
    mask = (rng.random(n) < 0.6).astype(np.float32)
    idx = (0, 2, 3, 5, 7, 9)
    ref = jimitation.imitation_loss(jimitation.ImitationQuery(jnp.zeros((n, 3)), jnp.asarray(mask), idx),
                                    jnp.asarray(student), jnp.asarray(expert))
    got = imitation.imitation_loss(imitation.ImitationQuery(torch.zeros((n, 3)), torch.as_tensor(mask), idx),
                                   torch.as_tensor(student), torch.as_tensor(expert))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    empty = imitation.imitation_loss(imitation.ImitationQuery(None, torch.zeros(n), idx), torch.as_tensor(student),
                                     torch.as_tensor(expert))
    assert empty.item() == 0.0


def test_loss_with_an_h1_walk_expert_matches_jax():
    """_loss_fn on h1_walk with a frozen expert (its own parameters and
    observation norm) through the env's identity projector: the loss, its
    imitation term and the gradients, as test_loss_and_gradients_match_jax."""
    from learninghumanoidwalking_tpu.envs.h1_walk import H1WalkEnv as JaxH1WalkEnv
    from learninghumanoidwalking_tpu_torch.envs.h1_walk import H1WalkEnv
    from learninghumanoidwalking_tpu_torch.rl.eval import DeterministicPolicy

    torch.backends.cuda.matmul.allow_tf32 = False
    jenv, tenv = JaxH1WalkEnv(), H1WalkEnv(device="cpu")
    assert jenv.obs_size == tenv.obs_size == 43
    ka, kc, ke = jax.random.split(jax.random.PRNGKey(6), 3)
    a_params, e_params = (networks_init(jenv, k) for k in (ka, ke))
    kw = dict(num_envs=8, rollout_len=4, minibatch_size=16, epochs=1, net_dtype="float32")
    jtmp = jppo.PPO(jenv, jppo.PPOConfig(**kw))
    c_params = jtmp.critic_def.init(kc, jnp.zeros((1, 43)))
    rng = np.random.default_rng(9)
    e_mean, e_std = rng.standard_normal(43).astype(np.float32) * 0.1, rng.uniform(0.5, 2.0, 43).astype(np.float32)
    enorm = jnorm.init_norm(None, e_mean, e_std)
    expert_apply = lambda p, o: jtmp.actor_def.apply(p, enorm.normalize(o))[0]
    j = jppo.PPO(jenv, jppo.PPOConfig(**kw), imitation_projector=jenv.imitation_projector(),
                 expert_apply=expert_apply, expert_params=e_params)
    actor, expert_actor = (networks.GaussianActor(43, 10) for _ in range(2))
    critic = networks.Critic(43)
    actor.load_state_dict(convert.actor_state_dict(convert.flatten_params(a_params), 10))
    expert_actor.load_state_dict(convert.actor_state_dict(convert.flatten_params(e_params), 10))
    critic.load_state_dict(convert.critic_state_dict(convert.flatten_params(c_params)))
    expert = DeterministicPolicy(expert_actor, convert.running_norm(enorm.mean, enorm.var, enorm.count))
    t = ppo.PPO(tenv, ppo.PPOConfig(**kw), device="cpu", imitation_projector=tenv.imitation_projector(), expert=expert)
    jn = jnorm.init_norm(None, jenv.obs_mean, jenv.obs_std)
    tn = convert.running_norm(jn.mean, jn.var, jn.count)

    obs = (rng.standard_normal((N_MB, 43)) * 0.5).astype(np.float32)
    obs[:, 35:37] = np.clip(obs[:, 35:37], -1, 1)
    mb = (obs, (0.3 * rng.standard_normal((N_MB, 10))).astype(np.float32), (rng.standard_normal(N_MB) * 0.5 + 8.0).astype(np.float32),
          rng.standard_normal(N_MB).astype(np.float32), rng.standard_normal(N_MB).astype(np.float32))
    grad_fn = jax.value_and_grad(j._loss_fn, argnums=(0, 1), has_aux=True)
    (jtotal, jaux), (jga, jgc) = grad_fn(a_params, c_params, jn, tuple(map(jnp.asarray, mb)))
    total, aux = t._loss_fn(actor, critic, tn, tuple(map(torch.as_tensor, mb)))
    assert float(jaux["imitation_loss"]) > 1e-6  # the term is on (output heads start at 0.01 scale)
    np.testing.assert_allclose(aux["imitation_loss"].item(), float(jaux["imitation_loss"]), rtol=1e-6)
    _rel_close(total.item(), float(jtotal), 1e-4)
    for k in ("actor_loss", "critic_loss", "mirror_loss", "approx_kl"):
        _rel_close(aux[k].item(), float(jaux[k]), 1e-4)
    params = list(actor.named_parameters()) + list(critic.named_parameters())
    grads = torch.autograd.grad(total, [p for _, p in params])
    want = {**{"a." + k: v for k, v in convert.actor_state_dict(convert.flatten_params(jga), 10).items()},
            **{"c." + k: v for k, v in convert.critic_state_dict(convert.flatten_params(jgc)).items()}}
    n_actor = len(list(actor.parameters()))
    for i, ((name, _), g) in enumerate(zip(params, grads)):
        _rel_close(g.numpy(), want[("a." if i < n_actor else "c.") + name].numpy(), 1e-4)
    assert all(p.grad is None for p in expert_actor.parameters())  # the expert stays frozen


def networks_init(jenv, key):
    j = jppo.PPO(jenv, jppo.PPOConfig(net_dtype="float32"))
    return j.actor_def.init(key, jnp.zeros((1, jenv.obs_size)))


def test_convert_carries_a_jax_checkpoint(tmp_path):
    """The JAX Checkpointer's persisted tree (params, optax
    apply_if_finite Adam states after a few steps, one of them non-finite,
    norm, iteration), fetched as numpy and carried over by
    rl/convert.py::checkpoint_from_jax, restores into a port trainer: the
    JAX policy's actions (1e-5) and the same next Adam step as optax (1e-6
    relative: parameters, both moments, count, notfinite_count)."""
    import optax

    from learninghumanoidwalking_tpu.envs.h1_stand import H1StandEnv as JaxH1StandEnv
    from learninghumanoidwalking_tpu.rl.checkpoint import Checkpointer as JaxCheckpointer
    from learninghumanoidwalking_tpu_torch.envs.h1_stand import H1StandEnv
    from learninghumanoidwalking_tpu_torch.rl.checkpoint import Checkpointer

    jenv, tenv = JaxH1StandEnv(), H1StandEnv(device="cpu")
    kw = dict(num_envs=4, rollout_len=2, minibatch_size=4, epochs=1, net_dtype="float32")
    j = jppo.PPO(jenv, jppo.PPOConfig(**kw))
    ka, kc = jax.random.split(jax.random.PRNGKey(12))
    a_params = j.actor_def.init(ka, jnp.zeros((1, 35)))
    c_params = j.critic_def.init(kc, jnp.zeros((1, 35)))
    a_opt, c_opt = j.actor_tx.init(a_params), j.critic_tx.init(c_params)
    rng = np.random.default_rng(13)
    rand_like = lambda tree, nan=False: jax.tree.map(
        lambda x: jnp.asarray(np.where(nan, np.nan, rng.standard_normal(x.shape)).astype(np.float32)), tree)
    for nan in (False, False, True):
        ua, a_opt = j.actor_tx.update(rand_like(a_params, nan), a_opt, a_params)
        a_params = optax.apply_updates(a_params, ua)
        uc, c_opt = j.critic_tx.update(rand_like(c_params), c_opt, c_params)
        c_params = optax.apply_updates(c_params, uc)
    norm = jnorm.RunningNorm(mean=jnp.asarray(rng.standard_normal(35).astype(np.float32)),
                             var=jnp.asarray(rng.uniform(0.5, 2, 35).astype(np.float32)), count=jnp.asarray(321.0))
    jts = jppo.TrainState(actor_params=a_params, critic_params=c_params, actor_opt=a_opt, critic_opt=c_opt, norm=norm,
                          env_state=None, key=jax.random.PRNGKey(0), iteration=jnp.asarray(17, jnp.int32))
    tree = jax.device_get(JaxCheckpointer._persistable(jts))
    assert int(tree["actor_opt"].notfinite_count) == 1

    state = convert.checkpoint_from_jax(tree, action_dim=10)
    Checkpointer(tmp_path).save_state(0, state)
    t = ppo.PPO(tenv, ppo.PPOConfig(**kw), device="cpu")
    ts = Checkpointer(tmp_path).restore(t.init_networks())
    assert ts.iteration == 17 and int(ts.actor_opt.notfinite_count) == 1 and float(ts.actor_opt.count) == 2.0
    obs = (rng.standard_normal((N_MB, 35)) * 0.5).astype(np.float32)
    jm, _ = j._policy(a_params, norm, jnp.asarray(obs))
    tm, _ = t._policy(ts.actor, ts.norm, torch.as_tensor(obs))
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm), rtol=0, atol=1e-5)

    # one more step on the same gradients
    g = rand_like(a_params)
    ua, a_opt2 = j.actor_tx.update(g, a_opt, a_params)
    a_params2 = optax.apply_updates(a_params, ua)
    tg = convert.actor_state_dict(convert.flatten_params(g), 10)
    names = [n for n, _ in ts.actor.named_parameters()]
    ts.actor_opt.step([tg[n] for n in names])
    want = convert.actor_state_dict(convert.flatten_params(a_params2), 10)
    adam = a_opt2.inner_state[1][0]
    want_mu = convert.actor_state_dict(convert.flatten_params(adam.mu), 10)
    want_nu = convert.actor_state_dict(convert.flatten_params(adam.nu), 10)
    for i, (name, p) in enumerate(ts.actor.named_parameters()):
        _rel_close(p.detach().numpy(), want[name].numpy(), 1e-6)
        _rel_close(ts.actor_opt.mu[i].numpy(), want_mu[name].numpy(), 1e-6)
        _rel_close(ts.actor_opt.nu[i].numpy(), want_nu[name].numpy(), 1e-6)
    assert float(ts.actor_opt.count) == int(adam.count) == 3
    assert int(ts.actor_opt.notfinite_count) == int(a_opt2.notfinite_count) == 0
