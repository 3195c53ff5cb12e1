"""The work count behind the kernels' roofline bound
(ops/substep_kernel.py::flops_per_env_substep) against bench.py's count of
the Pallas kernel (bench.py:53), which traces one Pallas substep group and
counts its elementwise operations; and the wrapper's model check.

The port counts the least work of a step: the Woodbury contact solve of the
Pallas kernel, with triangular factorizations and solves at their
triangular size and reductions counted. bench.py counts the Pallas kernel's
triangular updates at full row length and no reductions, so the port's
count may not exceed bench.py's and stays within 25% below it. A count of
the dense 3nc x 3nc contact solve of the plain version (more than 1.5x
bench.py's) fails, so the bound cannot be inflated by a denser algorithm.
The terrain-box model (jvrc_step: 20 boxes, 16 slots) is counted at R=1, as
the reference and K2 run it.

The motor term of the count (K4) is held to the widths of the default
motor nets (50 -> 32 -> 32 -> 1 per joint, 12 joints): bench.py traces no
motor kernel, so there is no traced count to compare it with.

Every build (K1 flat, K2/K3 terrain, K4 motor, K5/K6 terrain + motor)
launches a group of lanes
per env with its working set in shared memory: its launch plan must give
every env exactly one group and stay within a block's 232,448 B of shared
memory (the motor builds' regions holding the motor histories), and its
tree tables must order every body after its parent. Every kernel's library
builds from a source that exists. The layouts these tests plan with are
held to what the source's builds report (run through the C++
preprocessor), and the rejected designs of K4's nets that ops/net_sweep.py
times still apply to the source and change only the motor builds.

The terrain + motor build (K5: jvrc_step's boxes, K6: jvrc_walk_rough's
heightfield, each with the motor hook) is counted as the terrain build's
work plus the motor term, and checked like the others. Every build forms
the contact basis's Gram in float64 in one block of the source, so every
build takes Unitree H1's 5-dof legs.
"""

import dataclasses
import importlib.util
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from learninghumanoidwalking_tpu.models import h1 as jax_h1
from learninghumanoidwalking_tpu.models import jvrc as jax_jvrc
from learninghumanoidwalking_tpu.physics.spec import lower as jax_lower
from learninghumanoidwalking_tpu_torch.models import h1, jvrc
from learninghumanoidwalking_tpu_torch.ops import net_sweep
from learninghumanoidwalking_tpu_torch.ops import substep_kernel as sk
from learninghumanoidwalking_tpu_torch.physics.spec import lower
from learninghumanoidwalking_tpu_torch.robots.motor import init_motor_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: torch at one intra-op thread)


def _bench():
    spec = importlib.util.spec_from_file_location("bench", Path(__file__).resolve().parents[1] / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "nterrain, reuse", [pytest.param(0, 1, id="1"), pytest.param(0, 5, id="5"), pytest.param(20, 1, id="boxes-1")]
)
def test_flop_count_is_the_woodbury_form(nterrain, reuse):
    traced = _bench()._kernel_flops_per_env_substep(jax_lower(jax_jvrc.jvrc_spec(nterrain=nterrain)), reuse)
    counted = sk.flops_per_env_substep(lower(jvrc.jvrc_spec(nterrain=nterrain), device="cpu"), reuse)
    assert 0.75 * traced <= counted <= traced, (counted, traced)


@pytest.mark.parametrize("reuse", [1, 5])
def test_h1_flop_count_is_the_woodbury_form(reuse):
    """H1 (nv 16, 8 slots): the same bracket as JVRC-1's."""
    traced = _bench()._kernel_flops_per_env_substep(jax_lower(jax_h1.h1_spec()), reuse)
    counted = sk.flops_per_env_substep(lower(h1.h1_spec(), device="cpu"), reuse)
    assert 0.75 * traced <= counted <= traced, (counted, traced)


def _motor(nu=12, hidden=(32, 32)):
    gen = torch.Generator()
    gen.manual_seed(0)
    return init_motor_params(gen, nu, hidden)


def test_motor_work_count():
    """K4's motor term: per joint 50*32 + 32*32 + 32 = 2656 FMAs (2 flops
    each), 65 bias adds, 64 tanh (8 each, as sin and cos) and 2 for the
    skip term, for 12 joints; bytes: the two histories (12 x 25 floats
    each) and the int32 count in and out per env, and the weights once."""
    flat = lower(jvrc.jvrc_spec(), device="cpu")
    params = _motor()
    per_joint = 2 * 2656 + 65 + 8 * 64 + 2
    assert sk.motor_flops_per_net(params) == 12 * per_joint == 70692
    assert sk.flops_per_env_substep(flat, 1, motor=params) - sk.flops_per_env_substep(flat, 1) == 12 * per_joint
    n_weights = 12 * (50 * 32 + 32 + 32 * 32 + 32 + 32 + 1 + 1)
    assert n_weights == 32664
    for batch in (1, 4096, 32768):
        extra = sk.bytes_per_launch(flat, batch, motor=params) - sk.bytes_per_launch(flat, batch)
        assert extra == batch * (2 * 2 * 12 * 25 * 4 + 2 * 4) + 4 * n_weights
    assert sk.bytes_per_launch(flat, 1) == 2484
    # the least time of a 25-substep step launch at B=32768 is set by operations
    flops = sk.flops_per_env_substep(flat, 1, motor=params) * 25 * 32768
    assert flops / 67e12 > 10 * sk.bytes_per_launch(flat, 32768, motor=params) / 3.35e12


def test_motor_blocks_layout():
    """K4's motor inputs from a batch-leading MotorState: joint-major
    trailing-batch history rows n * 25 + slot (oldest first), the count as
    int32 (1, B), the weights in the kernel's order (per layer w then b,
    then skip), the layer count and hidden widths (0 past the last)."""
    from learninghumanoidwalking_tpu_torch.robots.motor import MotorState

    gen = torch.Generator()
    gen.manual_seed(1)
    b, h, nu = 3, 25, 12
    state = MotorState(qdot_hist=torch.randn((b, h, nu), generator=gen), ctau_hist=torch.randn((b, h, nu), generator=gen),
                       count=torch.tensor([0, 24, 1001], dtype=torch.int32))
    for hidden in ((32, 32), (64,)):
        params = _motor(hidden=hidden)
        blk = sk.motor_blocks(params, state, torch.device("cpu"))
        assert (blk["layers"], blk["hid0"], blk["hid1"]) == (len(hidden) + 1, hidden[0], hidden[1] if len(hidden) > 1 else 0)
        for name, hist in (("qd_hist", state.qdot_hist), ("ct_hist", state.ctau_hist)):
            assert blk[name].shape == (nu * h, b) and blk[name].is_contiguous()
            for n, slot, env in ((0, 0, 0), (5, 24, 2), (11, 13, 1)):
                assert blk[name][n * h + slot, env] == hist[env, slot, n]
        assert blk["count"].dtype == torch.int32 and blk["count"].tolist() == [[0, 24, 1001]]
        order = [params[f"{k}{li}"].reshape(-1) for li in range(params["n_layers"]) for k in ("w", "b")] + [params["skip"]]
        assert torch.equal(blk["weights"], torch.cat(order))


# the caps and launch layout the builds report (csrc/control_step_lanes.cu:
# LHW_TERRAIN 0 / 1, LHW_MOTOR 1; lanes per env, most threads a block, table
# sizes, the floats of an env's fixed shared region, the motor histories'
# offsets in it)
CAPS = dict(MAX_B=16, MAX_V=20, MAX_Q=21, MAX_U=16, MAX_F=2)
FLAT = dict(CAPS, LHW_TERRAIN=0, MAX_C=8, MAX_T=0, MAX_HF=0, LHW_G=16, LHW_TPB=192, N_FTAB=620, N_ITAB=596, SM_FIXED=1940)
TERRAIN = dict(CAPS, LHW_TERRAIN=1, MAX_C=16, MAX_T=32, MAX_HF=1024)
MOTOR = dict(FLAT, LHW_MOTOR=1, MAX_H=25, MAX_HID=64, MAX_LAYERS=3, SM_FIXED=2740, E_QDH=1940, E_CTH=2340)


def test_check_model_takes_terrain_and_refuses_motor_models():
    """The K1 and terrain builds take no motor model; the motor build (K4)
    takes one on the flat floor within its caps, and none on terrain; the
    terrain + motor build (K5, K6) takes one on terrain boxes or a
    heightfield within the same caps, and refuses H1's 5-dof legs."""
    flat, boxes = lower(jvrc.jvrc_spec(), device="cpu"), lower(jvrc.jvrc_spec(nterrain=20), device="cpu")
    sk.check_model(flat, FLAT)
    sk.check_model(boxes, TERRAIN)  # K2
    sk.check_model(flat, TERRAIN, hfield_shape=(16, 16))  # K3
    with pytest.raises(ValueError, match="terrain build"):
        sk.check_model(boxes, FLAT)
    with pytest.raises(ValueError, match="terrain build"):
        sk.check_model(flat, FLAT, hfield_shape=(16, 16))
    with pytest.raises(ValueError, match="heightfield"):
        sk.check_model(flat, TERRAIN, hfield_shape=(64, 64))
    with pytest.raises(ValueError, match="terrain boxes exceed"):
        sk.check_model(lower(jvrc.jvrc_spec(nterrain=40), device="cpu"), TERRAIN)
    with pytest.raises(ValueError, match="K4"):
        sk.check_model(boxes, TERRAIN, motor=object())
    assert [sk.variant(flat, False), sk.variant(boxes, False), sk.variant(flat, True)] == ["K1", "K2", "K3"]

    motor = _motor()
    sk.check_model(flat, MOTOR, motor=motor)  # K4
    sk.check_model(flat, MOTOR, motor=_motor(hidden=(64,)))
    assert sk.variant(flat, False, motor=True) == "K4"
    for lay in (FLAT, TERRAIN):
        with pytest.raises(ValueError, match="motor build"):
            sk.check_model(flat, lay, motor=motor)
    with pytest.raises(ValueError, match="terrain \\+ motor build"):
        sk.check_model(boxes, MOTOR, motor=motor)
    with pytest.raises(ValueError, match="terrain \\+ motor build"):
        sk.check_model(flat, TERRAIN, hfield_shape=(16, 16), motor=motor)
    # K5 and K6: the terrain + motor build, with the same net checks
    sk.check_model(boxes, TERRAIN_MOTOR, motor=motor)
    sk.check_model(flat, TERRAIN_MOTOR, hfield_shape=(16, 16), motor=motor)
    assert [sk.variant(boxes, False, motor=True), sk.variant(flat, True, motor=True)] == ["K5", "K6"]
    with pytest.raises(ValueError, match="exceed 3 layers of width 64"):
        sk.check_model(boxes, TERRAIN_MOTOR, motor=_motor(hidden=(128,)))
    with pytest.raises(ValueError, match="12 joints"):
        sk.check_model(flat, TERRAIN_MOTOR, hfield_shape=(16, 16), motor=_motor(nu=10))
    # Unitree H1's 5-dof legs: every build forms the basis Gram in float64
    h1m = lower(h1.h1_spec(), device="cpu")
    sk.check_model(h1m, TERRAIN, hfield_shape=(16, 16))  # K3
    sk.check_model(h1m, MOTOR, motor=_motor(nu=10))  # K4
    sk.check_model(h1m, TERRAIN_MOTOR, hfield_shape=(16, 16), motor=_motor(nu=10))  # K6
    with pytest.raises(ValueError, match="exceed 3 layers of width 64"):
        sk.check_model(flat, MOTOR, motor=_motor(hidden=(32, 32, 32)))
    with pytest.raises(ValueError, match="exceed 3 layers of width 64"):
        sk.check_model(flat, MOTOR, motor=_motor(hidden=(128,)))
    with pytest.raises(ValueError, match="12 joints"):
        sk.check_model(flat, MOTOR, motor=_motor(nu=10))
    # the wrapper pins R=1 for motor steps, as for terrain
    assert [sk.kernel_reuse(None, 5), sk.kernel_reuse(None, 5, motor=True)] == [5, 1]


def test_terrain_motor_work_count(terrain_models):
    """K5's and K6's work: the terrain build's count (boxes, heightfield)
    plus the motor term of K4; their bytes the terrain inputs plus the two
    histories, the count and the weights; bound by operations at B=32768."""
    params = _motor()
    for terrain in ("boxes", "hfield"):
        model, hfield = terrain_models[terrain]
        hf = hfield is not None
        assert sk.flops_per_env_substep(model, 1, hfield=hf, motor=params) == (
            sk.flops_per_env_substep(model, 1, hfield=hf) + sk.motor_flops_per_net(params))
        flat = lower(jvrc.jvrc_spec(), device="cpu")
        extra = sk.bytes_per_launch(model, 32768, hfield, motor=params) - sk.bytes_per_launch(model, 32768, hfield)
        assert extra == sk.bytes_per_launch(flat, 32768, motor=params) - sk.bytes_per_launch(flat, 32768)
        flops = sk.flops_per_env_substep(model, 1, hfield=hf, motor=params) * 25 * 32768
        assert flops / 67e12 > 10 * sk.bytes_per_launch(model, 32768, hfield, motor=params) / 3.35e12


# the terrain build's launch layout (csrc/control_step_terrain.cu: lanes per
# env, most threads a block, the table sizes, the floats of an env's fixed
# shared region)
SM_FIXED = 2188
TERRAIN_PLAN = dict(TERRAIN, LHW_G=16, LHW_TPB=192, N_FTAB=748, N_ITAB=620, SM_FIXED=SM_FIXED)
# the terrain + motor build: the terrain build's region (the motor histories
# live in device memory); the nets' torques at W_MTAU of the scratch union,
# past the joints' windows; at most NET_ENVS envs a block
TERRAIN_MOTOR = dict(TERRAIN_PLAN, LHW_MOTOR=1, MAX_H=25, MAX_HID=64, MAX_LAYERS=3, W_MTAU=942, NET_ENVS=12)


@pytest.fixture(scope="module")
def terrain_models():
    """jvrc_step's model (20 boxes) and jvrc_walk_rough's (a 16x16 heightfield)."""
    return {"boxes": (lower(jvrc.jvrc_spec(nterrain=20), device="cpu"), None), "hfield": (lower(jvrc.jvrc_spec(), device="cpu"), (16, 16))}


@pytest.mark.parametrize("batch", [1, 37, 4096, 32768])
@pytest.mark.parametrize("terrain", ["boxes", "hfield"])
def test_terrain_launch_plan_covers_every_env_once(terrain_models, terrain, batch):
    """Block k runs envs k * envs_per_block + group: every env exactly once,
    no block without an env, within the block's threads and shared memory,
    and with room for two blocks an SM where a block holds more than one env."""
    model, hfield = terrain_models[terrain]
    floats = {"boxes": 8 * 20 + 1, "hfield": 16 * 16 + 4 + 1}[terrain]
    assert sk.terrain_floats(model, hfield) == floats
    for lanes in (1, 8, 16, 32):
        plan = sk.launch_plan(model, batch, dict(TERRAIN_PLAN, LHW_G=lanes), hfield)
        epb = plan["envs_per_block"]
        envs = [blk * epb + grp for blk in range(plan["grid"]) for grp in range(epb)]
        assert [e for e in envs if e < batch] == list(range(batch))
        assert (plan["grid"] - 1) * epb < batch
        assert plan["lanes"] == lanes and plan["threads"] == epb * lanes <= 192
        assert plan["env_floats"] % 2 == 0 and plan["env_floats"] % 32 != 0
        assert SM_FIXED + floats <= plan["env_floats"] <= SM_FIXED + floats + 3
        assert plan["smem_bytes"] == 4 * epb * plan["env_floats"]
        assert plan["static_bytes"] == 4 * (748 + 620)
        assert plan["static_bytes"] + plan["smem_bytes"] <= 232448
        if epb > 1:
            assert sk.BLOCKS_PER_SM * (plan["static_bytes"] + plan["smem_bytes"] + 1024) <= 233472


@pytest.mark.parametrize("batch", [1, 3, 4096, 32768])
@pytest.mark.parametrize("terrain", ["boxes", "hfield"])
def test_terrain_motor_launch_plan_covers_every_env_once(terrain_models, terrain, batch):
    """K5 and K6 launch like K2 and K3, whose region theirs is (the motor
    histories live in device memory): every env exactly once, no block
    without an env, within the block's threads and shared memory, two
    blocks an SM: K2/K3's envs a block, 11 at the training batch, the block
    rounded up to whole warps (the nets run a warp a joint), and the 12
    joints' windows of the default nets within the scratch union."""
    model, hfield = terrain_models[terrain]
    floats = sk.terrain_floats(model, hfield)
    lay = TERRAIN_MOTOR
    assert lay["SM_FIXED"] == SM_FIXED and 12 * sk.net_window_floats(sk.motor_dims(_motor())) <= lay["W_MTAU"]
    plan = sk.launch_plan(model, batch, lay, hfield)
    epb = plan["envs_per_block"]
    assert epb == sk.launch_plan(model, batch, TERRAIN_PLAN, hfield)["envs_per_block"] == min(11, batch)
    envs = [blk * epb + grp for blk in range(plan["grid"]) for grp in range(epb)]
    assert [e for e in envs if e < batch] == list(range(batch))
    assert (plan["grid"] - 1) * epb < batch
    assert plan["threads"] == -(-epb * 16 // 32) * 32 <= 192
    assert plan["env_floats"] % 2 == 0 and plan["env_floats"] % 32 != 0
    assert lay["SM_FIXED"] + floats <= plan["env_floats"] <= lay["SM_FIXED"] + floats + 3
    assert plan["static_bytes"] + plan["smem_bytes"] <= 232448
    if epb > 1:
        assert sk.BLOCKS_PER_SM * (plan["static_bytes"] + plan["smem_bytes"] + 1024) <= 233472


def test_terrain_motor_nets_fit_the_scratch_union(terrain_models):
    """K5's and K6's nets stage each joint's window (its 50 inputs, or a
    wider hidden layer written over them) in the scratch union before
    W_MTAU: jvrc's 12 joints fit at hidden widths 32 and 64 (600 and 768
    floats of 942); where they would not fit, check_model refuses the nets."""
    model, _ = terrain_models["boxes"]
    assert [sk.net_window_floats(sk.motor_dims(_motor(hidden=h))) for h in ((32, 32), (64,), (20, 33), (51,))] == [50, 64, 50, 52]
    sk.check_model(model, TERRAIN_MOTOR, motor=_motor(hidden=(64, 64)))
    with pytest.raises(ValueError, match="windows exceed"):
        sk.check_model(model, dict(TERRAIN_MOTOR, W_MTAU=12 * 64 - 2), motor=_motor(hidden=(64, 64)))
    sk.check_model(model, dict(TERRAIN_MOTOR, W_MTAU=12 * 64 - 2), motor=_motor())


def test_terrain_launch_plan_refuses_oversized_terrain(terrain_models):
    """Past the caps (boxes, heightfield nodes), or where one env's region
    and the tables pass 232,448 B, the plan raises."""
    boxes, flat = terrain_models["boxes"][0], terrain_models["hfield"][0]
    with pytest.raises(ValueError, match="heightfield"):
        sk.launch_plan(flat, 4096, TERRAIN_PLAN, (64, 64))
    with pytest.raises(ValueError, match="terrain boxes exceed"):
        sk.launch_plan(dataclasses.replace(boxes, nterrain=40), 4096, TERRAIN_PLAN)
    # a build whose cap allowed a 256 x 256 heightfield: 262 KB an env
    with pytest.raises(ValueError, match="exceed 232448 B a block"):
        sk.launch_plan(flat, 4096, dict(TERRAIN_PLAN, MAX_HF=1 << 16), (256, 256))
    # the largest heightfield within the cap fits, one env a block at least
    assert sk.launch_plan(flat, 4096, TERRAIN_PLAN, (32, 32))["envs_per_block"] >= 1


def test_terrain_tree_tables(terrain_models):
    """The FK levels hold every body but the world once, each after its
    parent's level; the ancestor masks hold a body and its ancestors."""
    model = terrain_models["boxes"][0]
    banc, levels, order = sk.tree_tables(model)
    nb, parent = model.nbody, model.body_parent
    assert sorted(order) == list(range(1, nb)) and levels[0] == 0 and levels[-1] == nb - 1
    level_of = {order[k]: lv for lv in range(len(levels) - 1) for k in range(levels[lv], levels[lv + 1])}
    for i in range(1, nb):
        assert parent[i] == 0 or level_of[parent[i]] < level_of[i]
        chain, j = {i, 0}, i
        while j > 0:
            j = parent[j]
            chain.add(j)
        assert {b for b in range(nb) if (banc[i] >> b) & 1} == chain
    # JVRC-1: the pelvis, then the waist and the two 6-body leg chains
    assert len(levels) - 1 == 7


@pytest.mark.parametrize("batch", [1, 37, 4096, 32768])
@pytest.mark.parametrize("build", ["flat", "motor"])
def test_flat_and_motor_launch_plan_covers_every_env_once(build, batch):
    """K1 and K4 launch like the terrain build, with no terrain in the
    region: every env exactly once, no block without an env, within the
    block's threads and shared memory, and two blocks an SM (or
    BLOCKS_PER_SM) where a block holds more than one env, on jvrc_walk's
    model; the motor build's region holds its two histories."""
    model = lower(jvrc.jvrc_spec(), device="cpu")
    lay = {"flat": FLAT, "motor": MOTOR}[build]
    if build == "motor":
        assert lay["E_QDH"] + 25 * 16 == lay["E_CTH"] and lay["E_CTH"] + 25 * 16 <= lay["SM_FIXED"]
    for lanes in (1, 2, 4, 8, 16, 32):
        plan = sk.launch_plan(model, batch, dict(lay, LHW_G=lanes))
        epb = plan["envs_per_block"]
        envs = [blk * epb + grp for blk in range(plan["grid"]) for grp in range(epb)]
        assert [e for e in envs if e < batch] == list(range(batch))
        assert (plan["grid"] - 1) * epb < batch
        assert plan["lanes"] == lanes and plan["threads"] == epb * lanes <= 192
        assert plan["env_floats"] % 2 == 0 and plan["env_floats"] % 32 != 0
        assert lay["SM_FIXED"] <= plan["env_floats"] <= lay["SM_FIXED"] + 3
        assert plan["smem_bytes"] == 4 * epb * plan["env_floats"]
        assert plan["static_bytes"] == 4 * (620 + 596)
        assert plan["static_bytes"] + plan["smem_bytes"] <= 232448
        if epb > 1:
            assert max(2, sk.BLOCKS_PER_SM) * (plan["static_bytes"] + plan["smem_bytes"] + 1024) <= 233472


def test_every_kernel_library_source_exists():
    """Every kernel routes to a library, and every library builds from
    sources in ops/csrc/ (all from the one lane source)."""
    csrc = Path(sk.__file__).resolve().parent / "csrc"
    assert set(sk.LIBRARY_OF) == {"K1", "K2", "K3", "K4", "K5", "K6"} and set(sk.LIBRARY_OF.values()) == set(sk.LIBRARIES)
    assert set(sk.counters) == set(sk.LIBRARY_OF)
    for kernel, library in sk.LIBRARY_OF.items():
        _, sources, defines = sk.LIBRARIES[library]
        assert sources and all((csrc / src).is_file() for src in sources), (kernel, sources)
        assert ("-DLHW_TERRAIN=0" in defines) == (library in ("flat", "motor"))
        assert ("-DLHW_MOTOR=1" in defines) == (library in ("motor", "terrain_motor"))
    assert {src for _, sources, _ in sk.LIBRARIES.values() for src in sources} == {"control_step_lanes.cu"}


CSRC = Path(sk.__file__).resolve().parent / "csrc"


def _preprocess(source: Path, defines: tuple, tmp_path: Path) -> str:
    """``source`` through the C++ preprocessor with ``defines``, the csrc
    headers and an empty cuda_runtime.h on the include path."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ preprocessor on PATH")
    (tmp_path / "cuda_runtime.h").write_text("")
    cmd = [cxx, "-x", "c++", "-std=c++20", "-E", "-P", *defines, f"-I{tmp_path}", f"-I{CSRC}", str(source)]
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout


@pytest.mark.parametrize("build", ["flat", "terrain", "motor", "terrain_motor"])
def test_layout_dicts_match_the_source(build, tmp_path):
    """The hand-written layouts above (FLAT, TERRAIN_PLAN, MOTOR,
    TERRAIN_MOTOR) are what
    each build of csrc/control_step_lanes.cu reports through
    lhw_control_step_layout: the source is run through the C++ preprocessor
    with its library's defines (cuda_runtime.h an empty stub) and the
    layout's names and integer expressions read from the result, so an edit
    of the source's regions cannot leave the tests' numbers behind."""
    _, sources, defines = sk.LIBRARIES[build]
    text = _preprocess(CSRC / sources[0], defines, tmp_path)
    names = re.findall(r'"(\w+)"', re.search(r"keys\[\] = \{(.*?)\};", text).group(1))
    exprs = re.search(r"vals\[\] = \{(.*?)\};", text).group(1).split(",")[:-1]
    assert len(names) == len(exprs) and all(re.fullmatch(r"[\d\s+*/()&~-]+", e) for e in exprs)
    layout = dict(zip(names, (eval(e.replace("/", "//")) for e in exprs)))  # non-negative C integer arithmetic
    expected = {"flat": FLAT, "terrain": TERRAIN_PLAN, "motor": MOTOR, "terrain_motor": TERRAIN_MOTOR}[build]
    assert {k: layout.get(k) for k in expected} == expected


@pytest.mark.parametrize("build", ["flat", "terrain", "motor", "terrain_motor"])
def test_every_build_forms_the_gram_in_float64(build, tmp_path):
    """The lane source forms the contact basis's Gram G = Y^T Y and its
    factor in one block, and every build compiles that block with G summed
    and factorized in double (a 5-dof leg leaves G near singular, below a
    float32 pivot's resolution), LG rounded to float32 after."""
    source = CSRC / "control_step_lanes.cu"
    assert source.read_text().count("gram[p] =") == 1
    text = _preprocess(source, sk.LIBRARIES[build][2], tmp_path)
    block = re.findall(
        r"double acc = 0\.0;.*?acc \+= \(double\)ya\[d\] \* yb\[d\];\s*gram\[p\] = \(float\)acc;"
        r".*?group_cholesky\(gwd, lgd, \(double\*\)\(work \+ ",
        text, re.S)
    assert len(block) == 1 and text.count("gram[p] =") == 1
    assert re.search(r"lg\[p\] = \(float\)lgd\[p\];", text)


@pytest.mark.parametrize(
    "build, name",
    [("motor", n) for n in ("unroll5", "unroll20", "unroll25", "units_in_registers", "block_staged")]
    + [("terrain_motor", n) for n in ("shared_rings", "rings_in_device_memory", "tensor_cores")]
    + [(b, "float32_gram") for b in ("terrain", "motor", "terrain_motor")],
)
def test_net_variants_apply_to_the_lane_source(build, name, tmp_path):
    """ops/net_sweep.py's rejected designs of the motor nets still apply to
    the lane source (each hunk of their diffs found exactly once). K4's
    change the motor builds only (K4; K5 and K6, which compile its net
    function too): the flat and terrain builds preprocess to the same text
    as the kept source's. K5's and K6's other designs (the rings in each
    env's shared region; the rings in device memory with the per-group nets;
    the nets' hidden layers on tensor cores) change the terrain + motor build only, so K1-K4
    are the same in all four. The float32 Gram changes the one Gram block,
    so every build."""
    variants = net_sweep.variant_sources(CSRC, build)
    assert set(variants) == {"terrain": {"float32_gram"},
                             "motor": {"unroll5", "unroll20", "unroll25", "units_in_registers", "block_staged", "float32_gram"},
                             "terrain_motor": {"shared_rings", "rings_in_device_memory", "tensor_cores", "float32_gram"}}[build]
    kept_path = CSRC / "control_step_lanes.cu"
    text = variants[name]
    assert text != kept_path.read_text()
    marker = {"units_in_registers": "float acc[HPL];", "block_staged": "stage_joint_weights(wbuf",
              "shared_rings": "#define E_QDH (E_WORK + W_SIZE)",
              "rings_in_device_memory": "group_motor_net(motor_w, nu, motor_layers, m_dims, n, ring + n * MAX_H",
              "tensor_cores": "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
              "float32_gram": "group_cholesky(gw, lg, work + W_LK, nk, lane);"}
    assert marker.get(name, f"#pragma unroll {name[6:]}\n") in text
    path = tmp_path / "variant.cu"
    path.write_text(text)
    changed = {"motor": ("motor", "terrain_motor"), "terrain_motor": ("terrain_motor",)}[build] if name != "float32_gram" else tuple(sk.LIBRARIES)
    for lib in sk.LIBRARIES:
        defines = sk.LIBRARIES[lib][2]
        same = _preprocess(path, defines, tmp_path) == _preprocess(kept_path, defines, tmp_path)
        assert same == (lib not in changed), lib
    # block_staged's two buffers of one joint's weights: 2 x 2722 floats at the default widths
    assert net_sweep.stage_floats(sk.motor_dims(_motor())) == 2 * (1 + 50 * 32 + 32 + 32 * 32 + 32 + 32 + 1)


@pytest.mark.parametrize("batch", [1, 3, 4096, 32768])
def test_h1_runs_in_the_flat_build(batch):
    """H1 fits K1's caps (nbody 13, nv 16, nq 17, nu 10, 8 slots on 2 foot
    bodies) with no new build: check_model takes it, the launch plan covers
    every env once with 12 envs a block (2731 blocks at B=32768), and its
    bytes per env are 2204."""
    model = lower(h1.h1_spec(), device="cpu")
    assert (model.nbody, model.nv, model.nq, model.nu, model.ncon) == (13, 16, 17, 10, 8)
    sk.check_model(model, FLAT)
    plan = sk.launch_plan(model, batch, FLAT)
    epb = plan["envs_per_block"]
    assert epb == min(12, batch) and plan["grid"] == -(-batch // epb)
    envs = [blk * epb + grp for blk in range(plan["grid"]) for grp in range(epb)]
    assert [e for e in envs if e < batch] == list(range(batch))
    assert plan["static_bytes"] + plan["smem_bytes"] <= 232448
    assert sk.bytes_per_launch(model, 1) == 2204
    if batch == 32768:
        assert plan["grid"] == 2731
        flops = sk.flops_per_env_substep(model, 5) * 25 * batch
        assert abs(1e3 * max(flops / 67e12, sk.bytes_per_launch(model, batch) / 3.35e12) - 0.324) < 0.001
