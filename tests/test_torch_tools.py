"""The port's user tools against the JAX package's scripts, on the CPU: the
training A/B harness (training_ab.py, scripts/benchmark_training.py) and the
walk-mode probe (probe_walk_modes.py, scripts/probe_walk_modes.py), and the
long-run watch (train_watch.py).

* The harness's ``run`` on cartpole (8 envs, rollout 4, minibatch 32, 2
  iterations): the JAX script's JSON keys; each iteration's mean reward
  equal to PPO.train's on the same config and seed (the same draws, so
  exactly); the running norm's warmup run where ``obs_mean`` is None.
* ``compare``: the JAX script's text, character for character.
* The probe: a JAX jvrc_walk run with a feed-forward policy (from
  ``init_state``, its output layer scaled up so that its actions move the
  robot), written by the JAX Checkpointer and carried over with
  rl/convert.py::checkpoint_from_jax; both probes for 2 steps with the JAX
  key schedule's draws of PRNGKey(7) injected into the port: every number
  printed within one unit of its last printed digit, the text equal. The
  3-row batch against the modes run in turn: the same lines.
"""

import importlib.util
import json
import re
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from learninghumanoidwalking_tpu.envs.jvrc_walk import JvrcWalkEnv as JaxJvrcWalkEnv
from learninghumanoidwalking_tpu.rl import ppo as jppo
from learninghumanoidwalking_tpu.rl.checkpoint import Checkpointer as JaxCheckpointer
from learninghumanoidwalking_tpu.rl.normalize import init_norm
from learninghumanoidwalking_tpu_torch import probe_walk_modes, train_watch, training_ab
from learninghumanoidwalking_tpu_torch.rl import convert
from learninghumanoidwalking_tpu_torch.rl import ppo as tppo
from learninghumanoidwalking_tpu_torch.rl.checkpoint import Checkpointer
from learninghumanoidwalking_tpu_torch.utils.seeding import InjectedDraws
from test_torch_engine_path import _reset_draws, _step_draws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
AB_ARGS = ["--device", "cpu", "--num-envs", "8", "--rollout-len", "4", "--minibatch-size", "32", "--n-itr", "2"]
PROBE_STEPS = 2


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_training_ab_run_matches_the_trainer(tmp_path, monkeypatch, capsys):
    """The JSON's keys, its mean rewards against PPO.train's, the warmup."""
    warmups = []
    warmup = tppo.PPO._warmup_iteration
    monkeypatch.setattr(tppo.PPO, "_warmup_iteration", lambda self, ts: warmups.append(1) or warmup(self, ts))
    out = tmp_path / "a.json"
    result = training_ab.main(["run", *AB_ARGS, "--out", str(out)])
    saved = json.loads(out.read_text())
    assert set(saved) == {"env", "config", "total_time", "avg_fps", "final_reward", "records"}
    assert saved["env"] == "cartpole" and saved["config"]["n_itr"] == 2 and saved["config"]["device"] == "cpu"
    assert [set(r) for r in saved["records"]] == [{"itr", "fps", "mean_reward", "iter_time"}] * 2
    assert saved["avg_fps"] == saved["records"][1]["fps"]  # iteration 0 left out
    assert saved["final_reward"] == saved["records"][-1]["mean_reward"] == result["final_reward"]
    assert len(warmups) == 2  # cartpole has no fixed observation statistics
    assert "itr 0: fps" in capsys.readouterr().out

    from learninghumanoidwalking_tpu_torch.envs.registry import make_env

    env = make_env("cartpole", device="cpu")
    assert env.obs_mean is None
    cfg = tppo.PPOConfig(num_envs=8, rollout_len=4, minibatch_size=32, max_traj_len=300, seed=0, input_norm_iters=2)
    _, history = tppo.PPO(env, cfg, device="cpu").train(2, verbose=False, evaluate=False)
    assert [r["mean_reward"] for r in saved["records"]] == [h["mean_reward"] for h in history]
    assert len(warmups) == 4


def test_training_ab_compare_prints_the_jax_scripts_text(tmp_path, capsys):
    """compare on two result files (one with a zero, for the nan ratio):
    the JAX script's compare, whose module imports no JAX, prints the same."""
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps({"avg_fps": 123456.789, "final_reward": 0.0, "total_time": 12.5}))
    b.write_text(json.dumps({"avg_fps": 130001.25, "final_reward": -0.4321, "total_time": 11.75}))
    training_ab.main(["compare", str(a), str(b)])
    mine = capsys.readouterr().out
    _jax_script("benchmark_training").compare(str(a), str(b))
    assert mine == capsys.readouterr().out
    assert len(mine.splitlines()) == 4 and "nan" in mine


def test_tools_run_on_the_card_unless_asked(tmp_path):
    """Both tools default to cuda and raise where there is no card."""
    assert training_ab.build_parser().parse_args(["run"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            training_ab.main(["run", "--n-itr", "1", "--out", str(tmp_path / "x.json")])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe_walk_modes.main(["--path", str(tmp_path)])


@pytest.fixture(scope="module")
def walk_runs(tmp_path_factory):
    """(JAX run dir, port run dir, JAX env) of one jvrc_walk feed-forward policy."""
    root = tmp_path_factory.mktemp("walk_runs")
    jenv = JaxJvrcWalkEnv()
    j = jppo.PPO(jenv, jppo.PPOConfig(num_envs=1, rollout_len=1))
    # init_state's networks (its keys), without its env batch: an eager
    # reset on the CPU, which the JAX probe's load_policy runs anyway
    k_actor, k_critic, _, key = jax.random.split(jax.random.PRNGKey(3), 4)
    dummy = jnp.zeros((1, jenv.obs_size))
    actor_params = j.actor_def.init(k_actor, dummy)
    # an output layer 30x the initial one: actions of ~0.1-0.3 rad, which move the robot
    actor_params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 30.0 if "MLPTrunk" not in jax.tree_util.keystr(path) else x, actor_params
    )
    critic_params = j.critic_def.init(k_critic, dummy)
    ts = jppo.TrainState(
        actor_params=actor_params, critic_params=critic_params, actor_opt=j.actor_tx.init(actor_params),
        critic_opt=j.critic_tx.init(critic_params), norm=init_norm(None, jenv.obs_mean, jenv.obs_std),
        env_state=None, key=key, iteration=jnp.zeros((), dtype=jnp.int32),
    )
    meta = {"env": "jvrc_walk", "seed": 0, "std_dev": 0.223, "learn_std": False, "recurrent": False}
    jck = JaxCheckpointer(root / "jax")
    jck.save_experiment(meta)
    jck.save(0, ts, is_best=True)
    tck = Checkpointer(root / "port")
    tck.save_experiment(meta)
    tree = jax.device_get(JaxCheckpointer._persistable(ts))
    tck.save_state(0, convert.checkpoint_from_jax(tree, action_dim=jenv.action_size), is_best=True)
    return root / "jax", root / "port", jenv


def _probe_draws(jenv):
    """The reset's and each step's draws of one env reset from PRNGKey(7),
    by the JAX key schedule (reset: the 5th of 5 splits; step: the 6th of 6)."""
    keys = jax.random.PRNGKey(7)[None]
    draws = [InjectedDraws(_reset_draws("jvrc_walk", jenv, keys))]
    key = jax.random.split(keys[0], 5)[4]
    for _ in range(PROBE_STEPS):
        draws.append(InjectedDraws(_step_draws("jvrc_walk", jenv, key[None])))
        key = jax.random.split(key, 6)[5]
    return draws


NUMBER = re.compile(r"[+-]?\d+\.\d+")


def _assert_lines_close(mine: list, ref: list):
    """Each line's text equal and each number within one unit of its last printed digit."""
    assert len(mine) == len(ref), (mine, ref)
    for a, b in zip(mine, ref):
        assert NUMBER.sub("#", a) == NUMBER.sub("#", b), (a, b)
        for x, y in zip(NUMBER.findall(a), NUMBER.findall(b)):
            unit = 10.0 ** -len(y.split(".")[1])
            assert abs(float(x) - float(y)) <= unit * 1.001, (a, b)


def test_probe_matches_the_jax_probe(walk_runs, monkeypatch, capsys):
    """Both probes for 2 steps on the same policy and draws."""
    jax_dir, port_dir, jenv = walk_runs
    import learninghumanoidwalking_tpu.utils.cache as jax_cache

    monkeypatch.setattr(jax_cache, "enable_compile_cache", lambda *a, **k: None)
    # what the JAX script computes is unchanged; two costs it does not read
    # are cut: load_policy's init_state resets a batch of envs eagerly (its
    # env batch is never used), and the script compiles env.reset once a mode
    monkeypatch.setattr(JaxJvrcWalkEnv, "reset_batch", lambda self, keys, iteration=None: None)
    compiled = {}

    def jit_once(fn):
        key = (getattr(fn, "__func__", fn), getattr(fn, "__self__", None))
        return compiled.setdefault(key, jax.jit(fn))

    monkeypatch.setattr(sys, "argv", ["probe_walk_modes.py", "--path", str(jax_dir), "--steps", str(PROBE_STEPS)])
    script = _jax_script("probe_walk_modes")
    script.jax = types.SimpleNamespace(jit=jit_once, random=jax.random)
    script.main()
    ref = [line for line in capsys.readouterr().out.splitlines() if line]
    mine = probe_walk_modes.probe(port_dir, PROBE_STEPS, device="cpu", draws=_probe_draws(jenv))
    assert [line for line in capsys.readouterr().out.splitlines() if line] == mine
    assert [line.split()[0] for line in ref] == ["FORWARD", "INPLACE", "STANDING"]
    _assert_lines_close(mine, ref)
    speeds = [float(re.search(r"v=\(([+-]\d+\.\d+)", line).group(1)) for line in mine]
    assert max(abs(v) for v in speeds) >= 0.01, mine  # the policy moves the robot


def test_probe_batch_equals_the_modes_in_turn(walk_runs, capsys):
    """The 3-row batch (HostDraws seeded 7, broadcast) prints what each
    mode run alone prints, and main prints the batch's lines."""
    _, port_dir, _ = walk_runs
    batch = probe_walk_modes.main(["--path", str(port_dir), "--steps", str(PROBE_STEPS), "--device", "cpu"])
    in_turn = [line for mode in ("FORWARD", "INPLACE", "STANDING")
               for line in probe_walk_modes.probe(port_dir, PROBE_STEPS, device="cpu", modes=(mode,))]
    assert batch == in_turn and len(batch) == 3
    assert capsys.readouterr().out.splitlines() == batch + in_turn


def test_probe_refuses_a_recurrent_run(tmp_path):
    """A recurrent run is refused with the JAX script's message."""
    from learninghumanoidwalking_tpu_torch.envs.registry import make_env

    cfg = tppo.PPOConfig(num_envs=1, rollout_len=1, recurrent=True, hidden=(8,))
    ck = Checkpointer(tmp_path)
    ck.save_experiment({"env": "cartpole", "recurrent": True, "hidden": [8], "net_dtype": "float32"})
    ck.save(0, tppo.PPO(make_env("cartpole", device="cpu"), cfg, device="cpu").init_networks())
    with pytest.raises(SystemExit, match="recurrent probe not supported; use a FF run"):
        probe_walk_modes.probe(tmp_path, 1, device="cpu")


def test_broadcast_draws_repeat_one_row():
    """BroadcastDraws gives every row the numbers of one row of its source."""
    gen = torch.Generator()
    gen.manual_seed(7)
    ref = torch.Generator()
    ref.manual_seed(7)
    from learninghumanoidwalking_tpu_torch.utils.seeding import Draws

    draws = probe_walk_modes.BroadcastDraws(Draws(gen), 3)
    x = draws.uniform("u", (3, 4), -1.0, 1.0, "cpu")
    assert torch.equal(x, (-1.0 + 2.0 * torch.rand((1, 4), generator=ref)).expand(3, 4))
    assert draws.randint("r", (3,), 0, 100, "cpu").unique().numel() == 1
    with pytest.raises(ValueError):
        draws.normal("n", (2, 4), "cpu")


def test_adam_counts_every_nonfinite_step():
    """Adam.nonfinite_total counts the non-finite steps, also those that
    notfinite_count forgets after a finite one; the optimize metrics carry
    both Adams' totals."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = tppo.Adam([p], lr=1e-3, eps=1e-5, max_grad_norm=0.5)
    for g in ([1.0, 2.0, 3.0], [float("nan"), 0.0, 0.0], [1.0, 1.0, 1.0], [float("inf"), 0.0, 0.0], [0.0, 0.0, float("nan")]):
        opt.step([torch.tensor(g)])
    assert int(opt.nonfinite_total) == 3 and int(opt.notfinite_count) == 2 and float(opt.count) == 2.0


def test_train_watch_records_a_cli_run(tmp_path, capsys):
    """The watch over the command line's train (cartpole, 2 iterations,
    evaluations at both): a record per iteration, the evaluations, the
    wall time to the target, no non-finite steps, and the summary."""
    out = tmp_path / "w.json"
    train_watch.main(["--target=-1e9", "--out", str(out), "--", "train", "--env", "cartpole", "--device", "cpu",
                      "--n-itr", "2", "--num-envs", "8", "--rollout-len", "4", "--minibatch-size", "16",
                      "--max-traj-len", "5", "--eval-freq", "1", "--logdir", str(tmp_path / "runs")])
    saved = json.loads(out.read_text())
    assert [r["itr"] for r in saved["records"]] == [0, 1] and Path(saved["run_dir"]).is_dir()
    summary = saved["summary"]
    assert [e["itr"] for e in summary["evals"]] == [0, 1] and summary["first_at_target"]["itr"] == 0
    assert summary["nonfinite_steps"] == 0 and summary["peak_alloc_gib_end"] is None and summary["host_rss_gib_end"] > 0
    assert "watch: " in capsys.readouterr().out
    assert train_watch.summarize(saved["records"], 1e9)["first_at_target"] is None
