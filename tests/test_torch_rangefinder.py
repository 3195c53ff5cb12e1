"""The port's rangefinder array (physics/rangefinder.py, over a batch of
envs) against the JAX function (one env), on the CPU: the five cases of
tests/test_rangefinder.py and a heightfield terrain, each env of a batch
held to the JAX function on that env's pose and terrain.

Tolerance: distances 1e-6 m absolute (the same float32 ray arithmetic in
another order), the -1 of a ray that hits nothing exactly. The JAX function
casts against the floor plane and the terrain boxes; it raises on a terrain
with no boxes (a reduction over zero boxes), which jvrc_walk_rough's
heightfield terrain is: there it is given the same terrain and one box far
away, which no ray reaches, and both see the floor plane at floor_z.
"""

import numpy as np
import torch
import jax.numpy as jnp

from learninghumanoidwalking_tpu.physics import rangefinder as jrf
from learninghumanoidwalking_tpu.physics.engine import Terrain as JaxTerrain
from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from learninghumanoidwalking_tpu_torch.physics import rangefinder as rf
from learninghumanoidwalking_tpu_torch.physics.engine import Terrain
from learninghumanoidwalking_tpu_torch.utils.seeding import Draws

UPRIGHT = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
PITCHED = np.array([np.cos(0.1), 0.0, np.sin(0.1), 0.0], np.float32)  # 0.2 rad about y
FLIPPED = np.array([0.0, 1.0, 0.0, 0.0], np.float32)  # rays point up


def _jax(pos, quat, terrain, sites):
    return np.asarray(jrf.rangefinder(jnp.asarray(pos), jnp.asarray(quat), terrain, sites))


def _batch_terrain(arrays, batch):
    return Terrain(**{k: torch.tensor(np.broadcast_to(v, (batch,) + np.shape(v)).copy()) for k, v in arrays.items()})


def test_site_grid_matches_jax():
    for shape in ((4, 4, 0.4), (3, 3, 0.25), (2, 5, 0.1)):
        np.testing.assert_array_equal(rf.site_grid(*shape), jrf.site_grid(*shape))
    assert rf.site_grid().shape == (16, 3)


def test_flat_tilted_and_flipped_match_jax():
    """Upright (every ray reads the root height), pitched (front and rear
    rays differ) and flipped (no hit: -1), one env each, no terrain."""
    sites = rf.site_grid()
    pos = np.array([[0.0, 0.0, 0.98], [0.3, -0.2, 0.98], [0.0, 0.0, 0.98]], np.float32)
    quat = np.stack([UPRIGHT, PITCHED, FLIPPED])
    d = rf.rangefinder(torch.tensor(pos), torch.tensor(quat), None, sites).numpy()
    assert d.shape == (3, 16)
    for i in range(3):
        np.testing.assert_allclose(d[i], _jax(pos[i], quat[i], None, sites), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d[0], 0.98, atol=1e-6)
    xs = sites[:, 0]
    assert np.all(d[1] > 0) and d[1][xs > 0.1].mean() != d[1][xs < -0.1].mean()
    np.testing.assert_array_equal(d[2], -1.0)


def test_boxes_shorten_rays_as_in_jax():
    """A box (top at z = 0.3) under the +x,-y quadrant of the grid and one
    far away, for an upright and a yawed env, over the floor and a raised one."""
    sites = rf.site_grid()
    arrays = dict(pos=np.array([[0.6, -0.6, 0.15], [50.0, 50.0, -1.0]], np.float32),
                  size=np.array([[0.3, 0.3, 0.15], [0.1, 0.1, 0.1]], np.float32),
                  yaw=np.array([0.0, 0.3], np.float32), floor_z=np.float32(0.0))
    yawed = np.array([np.cos(0.2), 0.0, 0.0, np.sin(0.2)], np.float32)  # 0.4 rad about z
    quat = np.stack([UPRIGHT, yawed])
    pos = np.array([[0.0, 0.0, 0.98], [0.1, -0.1, 0.9]], np.float32)
    for floor in (0.0, 0.05):
        arrays["floor_z"] = np.float32(floor)
        d = rf.rangefinder(torch.tensor(pos), torch.tensor(quat), _batch_terrain(arrays, 2), sites).numpy()
        jter = JaxTerrain(**{k: jnp.asarray(v) for k, v in arrays.items()})
        for i in range(2):
            np.testing.assert_allclose(d[i], _jax(pos[i], quat[i], jter, sites), rtol=0, atol=1e-6)
    over_box = (np.abs(sites[:, 0] - 0.6) <= 0.3) & (np.abs(sites[:, 1] + 0.6) <= 0.3)
    arrays["floor_z"] = np.float32(0.0)
    d0 = rf.rangefinder(torch.tensor(pos[:1]), torch.tensor(quat[:1]), _batch_terrain(arrays, 1), sites).numpy()[0]
    assert over_box.any()
    np.testing.assert_allclose(d0[over_box], 0.98 - 0.3, atol=1e-6)
    np.testing.assert_allclose(d0[~over_box], 0.98, atol=1e-6)


def test_heightfield_terrain_reads_its_floor_plane_as_jax():
    """jvrc_walk_rough's terrain (a 16x16 heightfield, no boxes) over a
    floor at 0.1: the rays end on the floor plane, as the JAX function's do
    (given one unreachable box besides)."""
    sites = rf.site_grid()
    rng = np.random.default_rng(0)
    hf = dict(hfield=rng.uniform(0.0, 0.035, (16, 16)).astype(np.float32), hfield_x0y0=np.array([-1.2, -1.875], np.float32),
              hfield_cell=np.array([0.25, 0.25], np.float32), floor_z=np.float32(0.1))
    mine = dict(hf, pos=np.zeros((0, 3), np.float32), size=np.zeros((0, 3), np.float32), yaw=np.zeros((0,), np.float32))
    theirs = dict(hf, pos=np.array([[50.0, 50.0, -1.0]], np.float32), size=np.array([[0.1, 0.1, 0.1]], np.float32),
                  yaw=np.zeros((1,), np.float32))
    pos = np.array([[0.0, 0.0, 0.9], [0.2, 0.1, 0.95]], np.float32)
    quat = np.stack([UPRIGHT, PITCHED])
    d = rf.rangefinder(torch.tensor(pos), torch.tensor(quat), _batch_terrain(mine, 2), sites).numpy()
    jter = JaxTerrain(**{k: jnp.asarray(v) for k, v in theirs.items()})
    for i in range(2):
        np.testing.assert_allclose(d[i], _jax(pos[i], quat[i], jter, sites), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d[0], 0.8, atol=1e-6)


def test_env_accessor_matches_the_function():
    """HumanoidEnv.rangefinder on h1 standing over the flat floor and on
    jvrc_step's stepping stones: (B, 16) distances, each env as the JAX
    function gives them for its root pose and terrain."""
    for name in ("h1", "jvrc_step"):
        env = make_env(name, device="cpu")
        st = env.reset_batch(3, Draws(torch.Generator().manual_seed(1)))
        d = env.rangefinder(st).numpy()
        assert d.shape == (3, 16)
        terrain = env._terrain(st.task)
        root_pos, root_quat = st.physics.xpos[:, env.root_idx].numpy(), st.physics.xquat[:, env.root_idx].numpy()
        for i in range(3):
            jter = None if terrain is None else JaxTerrain(pos=jnp.asarray(terrain.pos[i].numpy()), size=jnp.asarray(terrain.size[i].numpy()),
                                                          yaw=jnp.asarray(terrain.yaw[i].numpy()), floor_z=jnp.asarray(terrain.floor_z[i].numpy()))
            np.testing.assert_allclose(d[i], _jax(root_pos[i], root_quat[i], jter, rf.site_grid()), rtol=0, atol=1e-6)
        if name == "h1":
            assert np.all(d > 0.5) and np.all(d < 1.2)  # standing over a flat floor
