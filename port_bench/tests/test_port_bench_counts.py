"""The frozen counts against values worked by hand from JVRC-1's shapes."""

import pytest

from port_bench.counts import kernel_counts, net_counts
from port_bench.reference import physics as ref_physics

REF = {"robot": "jvrc", "floor": "flat"}
MODEL = ref_physics.model(REF, "cpu")
FLAT = ref_physics.floor("flat")


def test_model_shapes():
    # JVRC-1's lower body: a free root and 12 hinges; 2 feet x 4 corners
    assert (MODEL.nq, MODEL.nv, MODEL.nu, MODEL.nbody, MODEL.ncon) == (19, 18, 12, 15, 8)


def test_bytes_per_launch_by_hand():
    # in: qpos 19 + qvel 18 + target, kp, kd, bemf 4 x 12 + damping, frictionloss
    # 2 x 18 + mass 15 + ipos 45 + xfrc 90 = 271 rows; out: qpos 19 + qvel, qacc
    # 36 + torque 12 + cforce 24 + cdist, cmask 16 + cpos, cnormal 48 + xpos 45 +
    # xquat 60 + cvel 90 = 350 rows; 4 bytes each
    assert kernel_counts.bytes_per_launch(MODEL, FLAT, 1) == 4 * (271 + 350) == 2484
    motor = ref_physics.motor_params(0, 12, [32, 32], "cpu")
    weights = 12 * (50 * 32 + 32 + 32 * 32 + 32 + 32 * 1 + 1)
    # two histories of 12 x 25 and the count, in and out, per env; the weights and skip once
    assert kernel_counts.bytes_per_launch(MODEL, FLAT, 1000, motor) == 1000 * 2484 + 4 * 1000 * 2 * 601 + 4 * (weights + 12)


def test_motor_net_ops_by_hand():
    motor = ref_physics.motor_params(0, 12, [32, 32], "cpu")
    # per joint: FMAs 50*32 + 32*32 + 32*1 = 2656 (2 each), 65 bias adds,
    # 64 tanh (8 each), the skip term 2
    assert kernel_counts.motor_flops_per_net(motor) == 12 * (2 * 2656 + 65 + 8 * 64 + 2) == 70692


@pytest.mark.parametrize("reuse, total_k", [(5, 28.7), (1, 39.4)])
def test_split_adds_up_to_the_recorded_totals(reuse, total_k):
    """f32 + f64 is the count the port's tables give (PERF.md: K1 28.7k an
    env-substep at R=5, 39.4k at R=1), and the float64 part is the contact
    system's Gram, K and sweeps only."""
    ops = kernel_counts.ops_per_env_substep(MODEL, FLAT, reuse)
    assert round((ops["f32"] + ops["f64"]) / 100) / 10 == total_k
    assert 0.1 < ops["f64"] / (ops["f32"] + ops["f64"]) < 0.6


def test_refresh_is_amortized_over_r():
    r1, r5 = kernel_counts.ops_per_env_substep(MODEL, FLAT, 1), kernel_counts.ops_per_env_substep(MODEL, FLAT, 5)
    assert r5["f32"] < r1["f32"] and r5["f64"] < r1["f64"]


def test_least_seconds_takes_the_larger_bound():
    peaks = {"f32_flops": 1.0, "f64_flops": 0.5, "hbm_bytes_per_s": 10.0}
    assert kernel_counts.least_seconds({"f32": 2.0, "f64": 1.0, "bytes": 10.0}, peaks) == 4.0
    assert kernel_counts.least_seconds({"f32": 0.0, "f64": 0.0, "bytes": 50.0}, peaks) == 5.0


def test_net_ops_by_hand():
    # actor 37 -> 256 -> 256 -> 12, critic 37 -> 256 -> 256 -> 1
    actor = 2 * (37 * 256 + 256 * 256 + 256 * 12)
    critic = 2 * (37 * 256 + 256 * 256 + 256 * 1)
    assert net_counts.forward_ops(37, [256, 256], 12) == actor == 156160
    assert net_counts.forward_ops(37, [256, 256], 1) == critic == 150528
    train_a = 2 * 37 * 256 * 2 + 2 * 256 * 256 * 3 + 2 * 256 * 12 * 3
    ops = net_counts.iteration_ops(37, 12, [256, 256], 32768, 16, 32768, 3, mirror=True)
    assert ops["rollout"] == 16 * 32768 * (actor + critic) + 2 * 32768 * critic
    per_sample = train_a + (2 * 37 * 256 * 2 + 2 * 256 * 256 * 3 + 2 * 256 * 1 * 3) + train_a + 2 * 37 * 37 + 4 * 12 * 12
    assert ops["update"] == 48 * 32768 * per_sample


def _ctx(cell_name, iterations, per_iter_events):
    from port_bench.core import cells
    from port_bench.tests.conftest import ROOT

    cell = cells.resolve(cells.load_benchmark(ROOT), cell_name, ROOT)
    return {"cell": cell, "counts": {"obs_size": 37, "action_size": 12},
            "iterations": [{"episodes_finished": 1000.0}] * iterations,
            "trace": {"lo": 0.0, "hi": 1e6 * iterations, "iterations": per_iter_events}}


def test_rooflines_classify_settle_and_step():
    """Walk: the first flat launch of an iteration is the settle (3 substeps,
    R=1), the next 16 are steps (25 substeps, R=5); the roofline is the summed
    bound over the summed time, so 1 s a launch gives bound / 17 s."""
    from port_bench.core import launches

    flat = ["control_step_flat_kernel", "kernel", 0.0, 1e6]
    ctx = _ctx("jvrc_walk.train32k", 1, [[flat] * 17 + [["other", "kernel", 0.0, 5.0]]])
    found = launches.launches(ctx)
    assert [x["kind"] for x in found] == ["settle"] + ["step"] * 16
    p = launches.peaks()
    bound = sum(kernel_counts.least_seconds(x["work"], p) for x in found)
    assert launches.roofline(ctx, "control_step_flat_kernel") == pytest.approx(100 * bound / 17)
    assert launches.roofline(ctx, "control_step_motor_kernel") is None  # nothing to read: no value
    step = kernel_counts.launch_work(MODEL, FLAT, 32768, 25, 5)
    assert found[1]["work"] == step


def test_motor_steps_count_nets_past_warm_up():
    """Motor: settles in the flat build, steps in the motor build; the nets
    count in every env-substep but the restarted envs' (1000 an iteration)."""
    from port_bench.core import launches

    ev = lambda sym: [sym, "kernel", 0.0, 1e6]  # noqa: E731
    ctx = _ctx("jvrc_walk_motor.train32k", 1, [[ev("control_step_flat_kernel")] + [ev("control_step_motor_kernel")] * 16])
    found = launches.launches(ctx)
    assert [x["kind"] for x in found] == ["settle"] + ["step"] * 16
    motor = ref_physics.motor_params(0, 12, [32, 32], "cpu")
    base = kernel_counts.launch_work(MODEL, FLAT, 32768, 25, 1, motor)
    nets = found[1]["work"]["f32"] - base["f32"]
    assert nets == pytest.approx(kernel_counts.motor_flops_per_net(motor) * 25 * (32768 * 16 - 1000) / 16)
    assert launches.roofline(ctx, "control_step_flat_kernel") is not None
