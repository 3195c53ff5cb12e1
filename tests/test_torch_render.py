"""Evaluation rendering in the port (rl/render.py, rl/render_gl.py and the
envs' render_markers) against the JAX package's, on the CPU.

- Markers: render_markers(states, i) of the port against the JAX
  render_markers of env i, on task states built from the same injected
  draws (the JAX task functions vmapped over per-env keys, their draws
  handed to the port as test_torch_env.py does): jvrc_walk and h1_walk
  (mode), jvrc_step (targets, plan, terrain boxes at stair height) and
  jvrc_walk_rough (the heightfield, re-jittered mid-episode in some envs).
  Floats 1e-6, strings, shapes and dtypes exactly.
- Stick figure: _fk_points against the JAX per-frame FK points on
  perturbed jvrc and h1 frames (1e-5 m), and the stick-figure .gif of a
  3-frame jvrc_step trajectory with markers from both packages, GL turned
  off in both by a test-side patch: equal frame count and size, mean
  absolute pixel difference under 1 grey level (9.5e-5 when last measured:
  a few pixels of a line drawn a float32 rounding apart).
- The GL path without a GL context: both packages' _draw_markers into two
  MjvScenes (equal geoms to 1e-6) and the replay's MJCF with the episode
  heightfield equal to the JAX text.
- An .mp4 where no writer exists raises; one real EGL render where a GL
  stack exists.
"""

import dataclasses
import importlib.util
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learninghumanoidwalking_tpu.envs.h1_walk import H1WalkEnv as JaxH1WalkEnv
from learninghumanoidwalking_tpu.envs.jvrc_step import JvrcStepEnv as JaxJvrcStepEnv
from learninghumanoidwalking_tpu.envs.jvrc_walk import JvrcWalkEnv as JaxJvrcWalkEnv
from learninghumanoidwalking_tpu.envs.jvrc_walk_rough import JvrcWalkRoughEnv as JaxJvrcWalkRoughEnv
from learninghumanoidwalking_tpu.rl import render as jrender
from learninghumanoidwalking_tpu.rl import render_gl as jrender_gl
from learninghumanoidwalking_tpu.tasks import stepping as jstepping
from learninghumanoidwalking_tpu.tasks import walking as jwalking
from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from learninghumanoidwalking_tpu_torch.rl import render, render_gl
from learninghumanoidwalking_tpu_torch.tasks import stepping, walking
from learninghumanoidwalking_tpu_torch.utils.seeding import InjectedDraws
from test_torch_env import _stepping_reset_draws, _walking_reset_draws, _walking_step_draws
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)

N = 8


def _env_i(tree, i):
    return types.SimpleNamespace(task=jax.tree.map(lambda x: x[i], tree))


def assert_markers_equal(mine: dict, ref: dict, what: str) -> None:
    assert mine.keys() == ref.keys(), (what, sorted(mine), sorted(ref))
    for k, r in ref.items():
        m = mine[k]
        if isinstance(r, str):
            assert m == r, (what, k, m, r)
        elif isinstance(r, float):
            assert isinstance(m, float) and abs(m - r) <= 1e-6, (what, k, m, r)
        else:
            assert isinstance(m, np.ndarray) and m.shape == r.shape and m.dtype == r.dtype, (what, k, m, r)
            np.testing.assert_allclose(m, r, rtol=0, atol=1e-6, err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", ["jvrc_walk", "h1_walk"])
def test_walking_markers_match_jax(name):
    jenv = {"jvrc_walk": JaxJvrcWalkEnv, "h1_walk": JaxH1WalkEnv}[name]()
    tenv = make_env(name, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(2), N)
    jtask = jax.vmap(lambda k: jwalking.reset(k, jenv.period))(keys)
    ttask = walking.reset(InjectedDraws(_walking_reset_draws(keys, tenv.period)), N, tenv.period, "cpu")
    for i in range(N):
        assert_markers_equal(tenv.render_markers(types.SimpleNamespace(task=ttask), i),
                             jenv.render_markers(_env_i(jtask, i)), f"{name} env {i}")
    assert len({tenv.render_markers(types.SimpleNamespace(task=ttask), i)["mode"] for i in range(N)}) >= 2


def test_stepping_markers_match_jax():
    """jvrc_step at full stair height, the targets moved along the plan."""
    jenv, tenv = JaxJvrcStepEnv(), make_env("jvrc_step", device="cpu")
    n, itr = 12, 11000
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    rng = np.random.default_rng(0)
    lfoot = np.tile([0.0, 0.1, 0.0], (n, 1)).astype(np.float32)
    rfoot = np.tile([0.0, -0.1, 0.0], (n, 1)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    root_pos = np.tile([0.0, 0.0, 0.8], (n, 1)).astype(np.float32)
    root_quat = np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    jtask = jax.vmap(lambda k, lf, rf, y, p, q: jstepping.reset(k, jenv.period, jnp.int32(itr), jenv.plans, jenv.plan_lengths,
                                                               lf, rf, y, p, q))(keys, lfoot, rfoot, yaw, root_pos, root_quat)
    ttask = stepping.reset(InjectedDraws(_stepping_reset_draws(keys, jenv.plans.shape[0])), tenv.period,
                           torch.full((n,), itr), tenv.plans, tenv.plan_lengths, *map(torch.as_tensor, (lfoot, rfoot, yaw, root_pos, root_quat)))
    t1 = np.minimum(np.arange(n) % 5, np.asarray(jtask.seq_len) - 2).astype(np.int32)
    jtask = jtask.replace(t1=jnp.asarray(t1), t2=jnp.asarray(t1 + 1))
    ttask = dataclasses.replace(ttask, t1=torch.as_tensor(t1, dtype=torch.int64), t2=torch.as_tensor(t1 + 1, dtype=torch.int64))
    modes = set()
    for i in range(n):
        mine = tenv.render_markers(types.SimpleNamespace(task=ttask), i)
        assert_markers_equal(mine, jenv.render_markers(_env_i(jtask, i)), f"jvrc_step env {i}")
        modes.add(mine["mode"])
        np.testing.assert_array_equal(mine["targets"], mine["sequence"][[t1[i], t1[i] + 1]])
    assert len(modes) >= 3


def test_rough_markers_follow_the_rejittered_field():
    """jvrc_walk_rough over 3 task steps of 512 envs: an env whose field
    was drawn anew mid-episode shows the new field in its next frame."""
    jenv, tenv = JaxJvrcWalkRoughEnv(), make_env("jvrc_walk_rough", device="cpu")
    n = 512
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    k1, k2 = (jnp.stack(x) for x in zip(*[jax.random.split(k) for k in keys]))
    jtask = jax.vmap(lambda k: jenv._task_reset(k, None, None))(keys)
    hf = lambda ks: np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (16, 16), minval=0.0, maxval=0.035))(ks))  # noqa: E731
    ttask = tenv._task_reset(InjectedDraws({**_walking_reset_draws(k1, jenv.period), "hfield": hf(k2)}), n, None, None)
    jstep = jax.jit(jax.vmap(lambda k, t: jenv._task_step(k, t, None)))
    rejittered = set()
    for s in range(3):
        skeys = jax.random.split(jax.random.PRNGKey(10 + s), n)
        a, b, c = (jnp.stack(x) for x in zip(*[jax.random.split(k, 3) for k in skeys]))
        draws = {**_walking_step_draws(a), "hfield": hf(c),
                 "hfield.rejitter": np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, 200))(b))}
        before = np.asarray(jtask.terrain.hfield)
        jtask, ttask = jstep(skeys, jtask), tenv._task_step(InjectedDraws(draws), ttask, None)
        changed = np.flatnonzero(np.any(np.asarray(jtask.terrain.hfield) != before, axis=(1, 2)))
        rejittered.update(changed.tolist())
        for i in [0, *changed.tolist()]:
            assert_markers_equal(tenv.render_markers(types.SimpleNamespace(task=ttask), i),
                                 jenv.render_markers(_env_i(jtask, i)), f"jvrc_walk_rough step {s} env {i}")
    assert rejittered


# ---------------------------------------------------------------------------
# stick figure
# ---------------------------------------------------------------------------


def _frames(env, t: int, seed: int) -> np.ndarray:
    """Perturbed copies of the env's nominal pose, moving forward."""
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(env.nominal_qpos, np.float32), (t, 1))
    q[:, 0] += np.linspace(0.0, 0.1, t)
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + 0.1 * rng.standard_normal((t, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] += 0.2 * rng.standard_normal((t, q.shape[1] - 7))
    return q.astype(np.float32)


@pytest.mark.parametrize("name", ["jvrc_walk", "h1"])
def test_fk_points_match_jax(name):
    from learninghumanoidwalking_tpu.envs import make_env as make_jax_env

    jenv, tenv = make_jax_env(name), make_env(name, device="cpu")
    q = _frames(tenv, 3, 1)
    xpos, corners = render._fk_points(tenv, q)
    assert xpos.shape == (3, tenv.model.nbody, 3) and corners.shape == (3, len(tenv.model.foot_geoms), 5, 3)
    for t in range(3):
        jx, jc = jrender._fk_points(jenv, q[t])
        np.testing.assert_allclose(xpos[t], jx, rtol=0, atol=1e-5)
        np.testing.assert_allclose(corners[t], np.stack(jc), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def step_markers():
    """Three frames of a jvrc_step trajectory and env 0's markers."""
    jenv, tenv = JaxJvrcStepEnv(), make_env("jvrc_step", device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(1), 1)
    z = lambda v: np.asarray([v], np.float32)  # noqa: E731
    ttask = stepping.reset(InjectedDraws({**_stepping_reset_draws(keys, jenv.plans.shape[0]),
                                          "step.mode": np.array([stepping.FORWARD])}), tenv.period, torch.full((1,), 11000),
                           tenv.plans, tenv.plan_lengths, *map(torch.as_tensor, (z([0, 0.1, 0]), z([0, -0.1, 0]), z(0.0),
                                                                                 z([0, 0, 0.8]), z([1, 0, 0, 0]))))
    mk = tenv.render_markers(types.SimpleNamespace(task=ttask), 0)
    return jenv, tenv, _frames(tenv, 3, 2), [mk] * 3


def test_stick_figure_gif_matches_jax(step_markers, tmp_path, monkeypatch):
    import imageio

    jenv, tenv, q, markers = step_markers
    monkeypatch.setattr(jrender_gl, "gl_available", lambda: False)
    monkeypatch.setattr(render_gl, "gl_available", lambda: False)
    ref = jrender.render_trajectory(jenv, q, tmp_path / "jax.gif", markers=markers)
    mine, renderer = render.render_trajectory(tenv, q, tmp_path / "port.gif", markers=markers)
    assert renderer == "stick figure"
    a, b = imageio.mimread(mine), imageio.mimread(ref)
    assert len(a) == len(b) == 3 and a[0].shape == b[0].shape and a[0].shape[:2] == (400, 800)
    diff = np.mean([np.abs(x[..., :3].astype(float) - y[..., :3].astype(float)).mean() for x, y in zip(a, b)])
    assert diff < 1.0, diff


# ---------------------------------------------------------------------------
# the GL path, without a GL context
# ---------------------------------------------------------------------------


def test_scene_markers_match_jax(step_markers):
    import mujoco

    _, tenv, _, markers = step_markers
    model = mujoco.MjModel.from_xml_string(render_gl.scene_xml(tenv, markers))
    scenes = []
    for draw in (jrender_gl._draw_markers, render_gl._draw_markers):
        scn = mujoco.MjvScene(model, maxgeom=1000)
        draw(scn, markers[0])
        scenes.append(scn)
    ref, mine = scenes
    active = sum(abs(p[0]) <= 20 and abs(p[1]) <= 20 for p in markers[0]["terrain_pos"])
    assert mine.ngeom == ref.ngeom == active + len(markers[0]["sequence"]) + 4  # boxes, plan, 2 targets + 2 ticks
    for g in range(ref.ngeom):
        gm, gr = mine.geoms[g], ref.geoms[g]
        assert gm.type == gr.type
        for f in ("size", "pos", "mat", "rgba"):
            np.testing.assert_allclose(np.asarray(getattr(gm, f)), np.asarray(getattr(gr, f)), rtol=0, atol=1e-6, err_msg=f)


def test_replay_xml_with_the_heightfield_matches_jax(monkeypatch):
    """The replay's MJCF for a jvrc_walk_rough episode whose field was
    re-jittered: the hfield asset sized to every frame's field."""
    from learninghumanoidwalking_tpu.physics import mjcf as jmjcf

    jenv, tenv = JaxJvrcWalkRoughEnv(), make_env("jvrc_walk_rough", device="cpu")
    rng = np.random.default_rng(5)
    base = dict(mode="FORWARD", mode_ref=np.zeros(3, np.float32), hfield_x0y0=np.array([-1.2, -1.875], np.float32),
                hfield_cell=np.array([0.25, 0.25], np.float32))
    markers = [dict(base, hfield=rng.uniform(0, 0.03, (16, 16)).astype(np.float32)),
               dict(base, hfield=rng.uniform(0, 0.035, (16, 16)).astype(np.float32))]
    seen = []

    class Stop(Exception):
        pass

    export_mjcf = jmjcf.export_mjcf

    def export(*args, **kw):  # the JAX renderer's text, then stop before any GL call
        seen.append(export_mjcf(*args, **kw))
        raise Stop

    monkeypatch.setattr(jmjcf, "export_mjcf", export)
    with pytest.raises(Stop):
        jrender_gl.render_trajectory_gl(jenv, np.zeros((2, 19)), "unused.gif", markers=markers)
    assert render_gl.scene_xml(tenv, markers) == seen[0] and "hfield" in seen[0]
    assert render_gl.hfield_spec(markers)[2] == max(float(m["hfield"].max()) for m in markers)


def test_mp4_without_a_writer_raises(step_markers, tmp_path, monkeypatch):
    _, tenv, q, markers = step_markers
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name in ("imageio_ffmpeg", "av") else find_spec(name, *a))
    with pytest.raises(RuntimeError, match="no .mp4 writer"):
        render.render_trajectory(tenv, q, tmp_path / "clip.mp4", markers=markers)
    assert not (tmp_path / "clip.mp4").exists()


_EGL_SCRIPT = """
import json, sys
import numpy as np
from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from learninghumanoidwalking_tpu_torch.rl import render, render_gl
if not render_gl.gl_available():
    print(json.dumps(dict(gl=False)))
    sys.exit(0)
import imageio
env = make_env("jvrc_walk", device="cpu")
q = np.tile(env.nominal_qpos[None], (3, 1)).astype(np.float64)
q[:, 2] += np.linspace(0.0, 0.05, 3)  # distinct frames (a GIF merges equal ones)
markers = [dict(mode="FORWARD", targets=np.array([[0.3, 0.1, 0.0, 0.0], [0.6, -0.1, 0.0, 0.3]]),
                sequence=np.array([[0.3, 0.1, 0, 0], [0.6, -0.1, 0, 0.3]]), terrain_pos=np.array([[0.5, 0.0, -0.05]]),
                terrain_size=np.array([[0.2, 0.2, 0.05]]), terrain_yaw=np.array([0.2]), floor_z=0.0)] * 3
out = render_gl.render_trajectory_gl(env, q, sys.argv[1], markers=markers, width=160, height=120)
frames = imageio.mimread(out)
_, renderer = render.render_trajectory(env, q[:2], sys.argv[2])
print(json.dumps(dict(gl=True, n=len(frames), shape=list(frames[0].shape[:2]), std=float(np.asarray(frames[0]).std()),
                      renderer=renderer, default_shape=list(imageio.mimread(sys.argv[2])[0].shape[:2]))))
"""


def test_render_gl_jvrc_walk(tmp_path):
    """One real EGL render, as the JAX package's test of the same name, and
    render_trajectory's choice of it, in a fresh interpreter: mujoco picks
    its GL backend when first imported, and in a test process another
    module may have imported it before MUJOCO_GL was set."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    repo = str(pathlib.Path(__file__).resolve().parents[1])
    env = dict(os.environ, MUJOCO_GL="egl", PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _EGL_SCRIPT, str(tmp_path / "clip.gif"), str(tmp_path / "default.gif")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    if not got["gl"]:
        pytest.skip("no EGL/GL stack")
    assert got["n"] == 3 and got["shape"] == [120, 160]
    assert got["std"] > 10.0  # floor and robot: not an empty scene
    assert got["renderer"] == "gl" and got["default_shape"] == [480, 640]  # GL first, at its default size
