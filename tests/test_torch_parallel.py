"""Data-parallel PPO in the port (parallel/mesh.py over torch.distributed,
gloo ranks on the CPU) against the JAX trainer on a 2-device virtual mesh
and against the port's own one-rank run.

- Two ranks run one feed-forward and one recurrent cartpole iteration with
  the JAX trainer's draws injected (each rank keeps its rows of every
  per-env draw), held to the JAX iteration on a mesh of 2 virtual CPU
  devices (shard_train_state) at test_torch_recurrent.py's tolerances: the
  trajectory and carries 1e-5, advantages, returns, metrics and the
  parameters after the update 1e-4, each relative to the quantity's
  largest magnitude (a metric below 1e-3 to 1e-7). Every rank ends with
  the same parameters, bit for bit.
- Two ranks against one rank of the port on jvrc_walk (4 envs, rollout 2,
  2 iterations, so that the reset pool rotates; the trainer's own seeded
  draws): parameters, Adam moments, norm and final observations 1e-5
  relative; the metrics 1e-5 of max(1, |metric|), since the losses are
  means of O(1) terms (normalized advantages) whose float32 rounding,
  summed per rank and then over ranks, is absolute.
- The refusals, and the dry run on 2 CPU ranks.

The ranks run in spawned processes, which import this module by name to
find their functions: its top level imports no JAX (the JAX side is
imported inside the fixtures).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from learninghumanoidwalking_tpu_torch.parallel import mesh
from learninghumanoidwalking_tpu_torch.parallel.dryrun import dryrun_multichip
from learninghumanoidwalking_tpu_torch.rl import convert, ppo
from learninghumanoidwalking_tpu_torch.utils.seeding import Draws, InjectedDraws

N_RANKS = 2


def rel_close(mine, theirs, rel, what="", floor=1e-8):
    mine = mine.detach().numpy() if torch.is_tensor(mine) else np.asarray(mine)
    theirs = np.asarray(theirs)
    assert mine.shape == theirs.shape, (what, mine.shape, theirs.shape)
    scale = max(float(np.max(np.abs(theirs))), floor)
    err = float(np.max(np.abs(mine - theirs))) if mine.size else 0.0
    assert err <= rel * scale, (what, err, scale)


class QueuedDraws(InjectedDraws):
    """Injected draws served in order, one value per call of a name."""

    def __init__(self, queues: dict):
        self.queues = {k: list(v) for k, v in queues.items()}

    def _get(self, name, shape, device):
        x = torch.as_tensor(np.array(self.queues[name].pop(0)), device=device)
        assert tuple(x.shape) == tuple(shape), (name, tuple(x.shape), tuple(shape))
        return x


def _gather(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _flat_params(ts) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in list(ts.actor.parameters()) + list(ts.critic.parameters())])


# ---------------------------------------------------------------------------
# two ranks against the JAX trainer on a 2-device mesh (cartpole)
# ---------------------------------------------------------------------------


def _cartpole_rank(shard, case: dict) -> dict:
    """One cartpole iteration on this rank with the JAX draws injected."""
    tenv = make_env("cartpole", device="cpu")
    t = ppo.PPO(tenv, ppo.PPOConfig(net_dtype="float32", **case["kw"]), device="cpu", draws=QueuedDraws(case["queues"]),
                shard=shard)
    ts = t.init_networks()
    ts.actor.load_state_dict(case["actor"])
    ts.critic.load_state_dict(case["critic"])
    ts = dataclasses.replace(ts, env_state=tenv.reset_batch(t.n_local, t.draws), norm=convert.running_norm(*case["norm"]))
    ts1, batch, roll = t._sample_iteration(ts)
    local = dict(obs=batch.obs, actions=batch.actions, log_probs=batch.log_probs, advantages=batch.advantages,
                 returns=batch.returns, env_obs=ts1.env_state.obs, carries=ts1.actor_carry, critic_carries=ts1.critic_carry,
                 draws_left=sum(len(v) for v in t.draws.base.queues.values()))
    ts2, aux = t._optimize_iteration(ts1, batch, case["perms"])
    params = _gather(_flat_params(ts2))
    return dict(local=_gather(local), roll={k: float(v) for k, v in roll.items()}, aux={k: float(v) for k, v in aux.items()},
                actor=ts2.actor.state_dict(), critic=ts2.critic.state_dict(),
                same_params=all(torch.equal(params[0], p) for p in params))


def _jax_cartpole_case(recurrent: bool):
    """The JAX iteration on a 2-device mesh and the case the ranks replay."""
    import jax

    from learninghumanoidwalking_tpu.envs.cartpole import CartpoleEnv as JaxCartpoleEnv
    from learninghumanoidwalking_tpu.parallel.mesh import make_mesh, shard_train_state
    from learninghumanoidwalking_tpu.rl import networks as jnets
    from learninghumanoidwalking_tpu.rl import ppo as jppo
    from test_torch_cartpole import cartpole_reset_draws

    n, T = 4, 6
    if recurrent:
        kw = dict(num_envs=n, rollout_len=T, minibatch_size=2 * T, epochs=1, max_traj_len=4, recurrent=True, hidden=(8, 8))
    else:
        kw = dict(num_envs=n, rollout_len=T, minibatch_size=12, epochs=1, max_traj_len=4)
    jenv = JaxCartpoleEnv()
    jkw = {k: v for k, v in kw.items() if k != "hidden"}
    j = jppo.PPO(jenv, jppo.PPOConfig(net_dtype="float32", **jkw))
    if recurrent:  # the JAX trainer's LSTMs are 2x256 whatever its config says
        j.actor_def = jnets.GaussianLSTMActor(action_dim=jenv.action_size, hidden=kw["hidden"])
        j.critic_def = jnets.LSTMCritic(hidden=kw["hidden"])
        j.hidden_sizes = kw["hidden"]
    key = jax.random.PRNGKey(5)
    jts0 = j.init_state(key)
    jts_mesh = shard_train_state(jts0, make_mesh(N_RANKS), n)
    jts1, batch, k_upd, roll = jax.jit(j._sample_iteration)(jts_mesh)
    jts2, aux = jax.jit(j._optimize_iteration)(jts1, batch, k_upd)
    # the JAX trainer's draws: the env batch, the reset pool, each step's
    # action noise, the minibatch order
    _, _, k_env, _ = jax.random.split(key, 4)
    _, k_roll, _ = jax.random.split(jts0.key, 3)
    k_chain, k_pool = jax.random.split(k_roll)
    noise = []
    for _ in range(T):
        k_chain, k_act = jax.random.split(k_chain)
        noise.append(np.asarray(jax.random.normal(k_act, (n, 1))))
    perms = [torch.as_tensor(np.array(jax.random.permutation(k, 2))) for k in jax.random.split(k_upd, 1)]
    queues = {}
    for d in (cartpole_reset_draws(jax.random.split(k_env, n)), cartpole_reset_draws(jax.random.split(k_pool, n)),
              *({"action": x} for x in noise)):
        for k, v in d.items():
            queues.setdefault(k, []).append(v)
    case = dict(kw=kw, queues=queues, perms=perms, norm=tuple(np.asarray(x) for x in (jts0.norm.mean, jts0.norm.var, jts0.norm.count)),
                actor=convert.actor_state_dict(convert.flatten_params(jts0.actor_params), 1),
                critic=convert.critic_state_dict(convert.flatten_params(jts0.critic_params)))
    return case, (jts1, batch, roll, jts2, aux)


@pytest.mark.parametrize("recurrent", [False, True], ids=["feedforward", "recurrent"])
def test_two_ranks_match_jax_on_a_mesh(recurrent):
    case, (jts1, jbatch, jroll, jts2, jaux) = _jax_cartpole_case(recurrent)
    out = mesh.launch(_cartpole_rank, N_RANKS, "cpu", case["kw"]["num_envs"], case)
    local = out["local"]
    assert all(part["draws_left"] == 0 for part in local)  # every injected draw was used, on every rank
    cat = lambda name, dim=1: torch.cat([part[name] for part in local], dim=dim)  # noqa: E731
    for name in ("obs", "actions", "log_probs"):
        rel_close(cat(name), getattr(jbatch, name), 1e-5, name)
    for name in ("advantages", "returns"):
        rel_close(cat(name), getattr(jbatch, name), 1e-4, name)
    rel_close(cat("env_obs", 0), jts1.env_state.obs, 1e-5, "env obs")
    if recurrent:
        for key, ref in (("carries", jts1.actor_carry), ("critic_carries", jts1.critic_carry)):
            for layer, (c1, h1) in enumerate(ref):
                rel_close(torch.cat([part[key][layer][0] for part in local]), c1, 1e-5, "c")
                rel_close(torch.cat([part[key][layer][1] for part in local]), h1, 1e-5, "h")
    for k, v in out["roll"].items():
        rel_close(v, jroll[k], 1e-4, k, floor=1e-3)
    for k, v in out["aux"].items():
        rel_close(v, jaux[k], 1e-4, k, floor=1e-3)
    assert out["same_params"]
    want_a = convert.actor_state_dict(convert.flatten_params(jts2.actor_params), 1)
    want_c = convert.critic_state_dict(convert.flatten_params(jts2.critic_params))
    for got, want in ((out["actor"], want_a), (out["critic"], want_c)):
        for pname, p in got.items():
            rel_close(p, want[pname], 1e-4, pname)


# ---------------------------------------------------------------------------
# two ranks against one rank of the port (jvrc_walk)
# ---------------------------------------------------------------------------

WALK = dict(num_envs=4, rollout_len=2, minibatch_size=4, epochs=1, max_traj_len=2, net_dtype="float32", hidden=(32, 32), seed=3)


def _walk_run(shard=None) -> dict:
    """Two iterations of jvrc_walk from the config's seed (the second
    rotates the reset pool; every episode is cut at 2 steps)."""
    env = make_env("jvrc_walk", device="cpu")
    t = ppo.PPO(env, ppo.PPOConfig(**WALK), device="cpu", shard=shard)
    ts = t.init_state()
    history = []
    for _ in range(2):
        ts, batch, roll = t._sample_iteration(ts)
        ts, aux = t._optimize_iteration(ts, batch)
        history.append({k: float(v) for k, v in {**roll, **aux}.items()})
    opt = [torch.cat([x.reshape(-1) for x in o.mu + o.nu]) for o in (ts.actor_opt, ts.critic_opt)]
    return dict(params=_flat_params(ts), opt=opt, norm=(ts.norm.mean, ts.norm.var, ts.norm.count), history=history,
                env_obs=ts.env_state.obs)


def _walk_rank(shard) -> dict:
    out = _walk_run(shard)
    out["env_obs"] = torch.cat(_gather(out["env_obs"]))
    return out


def test_two_ranks_match_one_rank_on_jvrc_walk():
    one = _walk_run()
    two = mesh.launch(_walk_rank, N_RANKS, "cpu", WALK["num_envs"])
    rel_close(two["env_obs"], one["env_obs"].numpy(), 1e-5, "env obs")
    rel_close(two["params"], one["params"].numpy(), 1e-5, "params")
    for a, b in zip(two["opt"], one["opt"]):
        rel_close(a, b.numpy(), 1e-5, "adam moments")
    for a, b in zip(two["norm"], one["norm"]):
        rel_close(a, b.numpy(), 1e-5, "norm")
    for m2, m1 in zip(two["history"], one["history"]):
        assert m2.keys() == m1.keys()
        for k in m1:
            rel_close(m2[k], m1[k], 1e-5, k, floor=1.0)


def test_row_draws_are_the_rows_of_the_whole_batch():
    """A rank's per-env draws are its rows of the one-rank draw, the
    rotated reset pool's rows included; a permutation is every rank's."""
    gens = [torch.Generator().manual_seed(9) for _ in range(3)]
    whole = Draws(gens[0])
    shard = mesh.DataParallel(rank=1, world=2, num_envs=6, device=torch.device("cpu"))
    rows = shard.row_draws(Draws(gens[1]))
    full = whole.uniform("x", (6, 2), 0.0, 1.0, "cpu")
    assert torch.equal(rows.uniform("x", (3, 2), 0.0, 1.0, "cpu"), full[3:])
    full = torch.roll(whole.normal("y", (6,), "cpu"), 2, dims=0)
    assert torch.equal(rows.shifted(2).normal("y", (3,), "cpu"), full[3:])
    assert torch.equal(rows.permutation("p", 5, "cpu"), whole.permutation("p", 5, "cpu"))
    assert rows.gen is gens[1]
    with pytest.raises(ValueError, match="per-env draw"):
        rows.uniform("x", (6, 2), 0.0, 1.0, "cpu")


def test_layouts_that_do_not_split_raise():
    with pytest.raises(ValueError, match="split evenly"):
        mesh.check_layout(5, 2, "cpu")
    mesh.check_layout(4, 2, "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        mesh.check_layout(4, torch.cuda.device_count() + 1, "cuda")


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    metrics = dryrun_multichip(2, "cpu")["metrics"]
    assert np.isfinite(list(metrics.values())).all() and metrics["mean_reward"] != 0.0
    assert "dryrun_multichip(2): full PPO iteration OK (16 envs sharded over 2 devices)" in capsys.readouterr().out
