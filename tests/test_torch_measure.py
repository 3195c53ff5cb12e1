"""The port's measuring tools against the JAX package's scripts, on the CPU:
the kernel throughput tool (bench_kernel.py, scripts/bench_kernel.py) and
the iteration's stage probe (perf_probe.py, scripts/perf_probe.py).

The JAX scripts are not run (they time the Pallas kernel on a TPU); their
source is read instead:

* perf_probe prints its workload's line with R, then one JSON line whose
  keys are the ``out["..."]`` keys of scripts/perf_probe.py, each a finite
  positive number at 4 envs x 1 step on the CPU;
* bench_kernel prints its line with R, then per batch size the line of
  scripts/bench_kernel.py's f-string, finite and positive;
* the inputs of perf_probe's kernel stage (tiled ``nominal_qpos`` at rest,
  the model's default dynamics, ``neutral_pose`` targets, the state's
  forward kinematics) equal the JAX script's construction, done here in jnp
  (float32; the FK within 1e-6);
* both tools ask for a card by default and raise where there is none, and
  neither imports JAX or the JAX package.
"""

import ast
import contextlib
import importlib
import io
import json
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learninghumanoidwalking_tpu.envs import make_env as jax_make_env
from learninghumanoidwalking_tpu.physics import engine as jax_eng
from learninghumanoidwalking_tpu.physics.model import default_dyn_params as jax_default_dyn_params
from learninghumanoidwalking_tpu_torch import bench_kernel, perf_probe
from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from test_torch_imports import FORBIDDEN, _imported_roots
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
NUM_ENVS = 4


def _printed(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def probe_out() -> dict:
    text = _printed(perf_probe.main, ["--device", "cpu", "--num-envs", str(NUM_ENVS), "--rollout-len", "1"])
    lines = text.strip().splitlines()
    assert len(lines) == 2 and lines[0] == (f"perf_probe: jvrc_walk, {NUM_ENVS} envs x 1 steps, minibatch 32768, kernel stage "
                                            "at factorization reuse R=1 (scripts/perf_probe.py: R=1)")
    return json.loads(lines[1])


def _jax_out_keys() -> set:
    """The keys that scripts/perf_probe.py assigns into ``out``."""
    tree = ast.parse((SCRIPTS / "perf_probe.py").read_text())
    return {
        t.slice.value
        for node in ast.walk(tree) if isinstance(node, ast.Assign)
        for t in node.targets
        if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) and t.value.id == "out"
    }


def test_perf_probe_prints_the_jax_scripts_keys(probe_out):
    keys = _jax_out_keys()
    assert len(keys) == 11 and set(probe_out) == keys
    assert all(isinstance(v, float) and math.isfinite(v) and v > 0 for v in probe_out.values()), probe_out


def _jax_line_format():
    """The f-string of scripts/bench_kernel.py's printed line, compiled."""
    tree = ast.parse((SCRIPTS / "bench_kernel.py").read_text())
    (fstr,) = [node.args[0] for node in ast.walk(tree)
               if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "print"]
    return compile(ast.Expression(fstr), "bench_kernel_line", "eval")


def test_bench_kernel_prints_the_jax_scripts_line():
    text = _printed(bench_kernel.main, [str(NUM_ENVS), "3", "--steps", "1", "--device", "cpu"])
    header, *lines = text.strip().splitlines()
    assert header == "bench_kernel: jvrc_walk, 1 control steps of 25 substeps, factorization reuse R=1 (scripts/bench_kernel.py: R=1)"
    assert len(lines) == 2
    fmt = _jax_line_format()
    for line, batch in zip(lines, (NUM_ENVS, 3)):
        m = re.fullmatch(r"B=\s*(\d+):\s*([\d,]+) env steps/s\s+([\d.]+) ns/env-substep", line)
        assert m, line
        sps, ns_sub = float(m.group(2).replace(",", "")), float(m.group(3))
        assert int(m.group(1)) == batch and sps > 0 and ns_sub > 0 and math.isfinite(ns_sub)
        assert eval(fmt, {}, dict(B=batch, sps=sps, ns_sub=ns_sub)) == line


def test_kernel_stage_inputs_match_the_jax_scripts():
    env = make_env("jvrc_walk", device="cpu")
    dyn, state, target = perf_probe.kernel_inputs(env, NUM_ENVS)
    jenv = jax_make_env("jvrc_walk")
    model = jenv.model
    # scripts/perf_probe.py:89-97, in jnp on the CPU
    qpos = jnp.asarray(np.tile(np.asarray(jenv.nominal_qpos, np.float32)[None], (NUM_ENVS, 1)))
    qvel = jnp.zeros((NUM_ENVS, model.nv))
    tgt = jnp.asarray(np.tile(np.asarray(jenv.neutral_pose, np.float32)[None], (NUM_ENVS, 1)))
    p1 = jax_default_dyn_params(model, jenv.kp, jenv.kd)
    params = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (NUM_ENVS,) + x.shape), p1)
    state0 = jax.vmap(lambda q, v: jax_eng.make_state(model, q, v))(qpos, qvel)
    np.testing.assert_array_equal(target.numpy(), np.asarray(tgt))
    for field in ("dof_damping", "dof_frictionloss", "body_mass", "body_ipos", "xfrc", "kp", "kd", "bemf_gain"):
        np.testing.assert_array_equal(getattr(dyn, field).numpy(), np.asarray(getattr(params, field)), err_msg=field)
    np.testing.assert_array_equal(state.qpos.numpy(), np.asarray(state0.qpos))
    np.testing.assert_array_equal(state.qvel.numpy(), np.asarray(state0.qvel))
    for field in ("xpos", "xquat", "cvel"):
        np.testing.assert_allclose(getattr(state, field).numpy(), np.asarray(getattr(state0, field)), atol=1e-6, err_msg=field)


@pytest.mark.parametrize("tool, argv", [(bench_kernel, ["4", "--steps", "1"]), (perf_probe, ["--num-envs", "4", "--rollout-len", "1"])],
                         ids=["bench_kernel", "perf_probe"])
def test_tools_ask_for_a_card(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


@pytest.mark.parametrize("name", ["bench_kernel", "perf_probe"])
def test_tools_import_no_jax(name):
    module = importlib.import_module(f"learninghumanoidwalking_tpu_torch.{name}")
    assert not _imported_roots(Path(module.__file__)) & FORBIDDEN
