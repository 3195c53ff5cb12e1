"""A whole run of a cell on the CPU at a small size, and the faults it must refuse.

The harness's look for a card is skipped (harness.run is called with
device="cpu", where the env runs the kernels' plain version); everything
else of a run happens: set-up with the capture, the window through
PPO.train's on_iteration, the reference's judgement. A sound run is correct;
each fault planted under the timed path makes ``correct`` false.

The limits are the card's, set at the cells' own sizes (PERF.md). The CPU
has no bfloat16 GEMM that rounds as the card's does, and at this size a
minibatch averages that rounding over 1024 samples, not 32768; so the nets
run in float32 here (the trainer's parity option, ``net_dtype``), and a
sound run sits far inside every limit while a fault shows alone.
"""

import dataclasses
import functools

import pytest
import torch

from port_bench.core import cells, check, harness
from port_bench.tests.conftest import ROOT

SMALL = dict(num_envs=512, rollout_len=2, minibatch_size=1024, epochs=3, warm_iterations=1,
             check={"physics_envs": 32, "rollout_envs": 32, "update_steps": 3, "window_iterations": 2})
SEED = 2**31 + 12345
WINDOW_S = 8.0


def cell(name="jvrc_walk.train32k"):
    """The cell at the small size, its nets in float32."""
    c = cells.resolve(cells.load_benchmark(ROOT), name, ROOT)
    return dataclasses.replace(c, config={**c.config, "policy": {**c.config["policy"], "net_dtype": "float32"}},
                               traffic={**c.traffic, **SMALL})


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def failing(out):
    return sorted(k for k, c in out["checks"].items() if not c["value"] <= c["limit"])


@pytest.mark.parametrize("name", ["jvrc_walk.train32k", "jvrc_walk_motor.train32k"])
def test_sound_run_is_correct(name):
    out = harness.run(cell(name), SEED, WINDOW_S, False, "cpu")
    assert out["correct"], failing(out)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert {"train_env_steps_per_s", "setup_s"} <= set(out["metrics"])


def test_state_left_unchanged_is_refused(monkeypatch):
    from learninghumanoidwalking_tpu_torch.rl import ppo

    monkeypatch.setattr(ppo.Adam, "step", lambda self, grads: None)
    out = harness.run(cell(), SEED, WINDOW_S, False, "cpu")
    assert not out["correct"]
    assert "update_delta" in failing(out)


def test_half_the_batch_left_out_is_refused(monkeypatch):
    from learninghumanoidwalking_tpu_torch.rl import ppo

    orig = ppo.PPO._loss_fn

    def half(self, actor, critic, norm, mb, count=None):
        n = mb[0].shape[0] // 2
        return orig(self, actor, critic, norm, tuple(x[:n] for x in mb), None)

    monkeypatch.setattr(ppo.PPO, "_loss_fn", half)
    out = harness.run(cell(), SEED, WINDOW_S, False, "cpu")
    assert not out["correct"], out["checks"]


def test_an_answer_altered_where_produced_is_refused(monkeypatch):
    from learninghumanoidwalking_tpu_torch.envs import humanoid

    orig = humanoid.pd_substeps_kernel

    @functools.wraps(orig)
    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        state = out[0] if isinstance(out, tuple) else out
        state.qpos[:, 7:] += 1e-3  # every joint angle a milliradian off
        return out

    monkeypatch.setattr(humanoid, "pd_substeps_kernel", altered)
    out = harness.run(cell(), SEED, WINDOW_S, False, "cpu")
    assert not out["correct"]
    assert {"settle_ratio", "step_ratio"} <= set(failing(out))


def test_half_the_envs_left_unchanged_is_refused(monkeypatch):
    """A kernel that steps only half of the batch: the other half's states
    come back as they went in. The median env passes; the tail does not."""
    from learninghumanoidwalking_tpu_torch.envs import humanoid

    orig = humanoid.pd_substeps_kernel

    @functools.wraps(orig)
    def half(model, params, physics, *args, **kwargs):
        out = orig(model, params, physics, *args, **kwargs)
        state = out[0] if isinstance(out, tuple) else out
        state.qpos[1::2] = physics.qpos[1::2]
        state.qvel[1::2] = physics.qvel[1::2]
        return out

    monkeypatch.setattr(humanoid, "pd_substeps_kernel", half)
    out = harness.run(cell(), SEED, WINDOW_S, False, "cpu")
    assert not out["correct"]
    assert {"settle_tail", "step_tail"} <= set(failing(out))


def _control_fails(device):
    c = cell()
    ppo, ts, warm, tap, captures = harness.setup(c, SEED, torch.device(device))
    try:
        harness.window(ppo, ts, None, tap, captures[1])
    finally:
        tap.remove()
    chk = c.config["check"]
    fails = set()
    for k, rec in enumerate(cap.settled() for cap in captures):
        got = check.capture_numbers(c, rec, torch.device(device))
        limits = {**chk["limits"], **(chk["start_limits"] if k == 0 else {})}
        assert all(got["program"][n] <= limits[n] for n in limits), got["program"]
        fails |= {n for n in limits if got["control"][n] > limits[n]}
    return sorted(fails)


def test_control_fails_on_the_cpu():
    """The reference one precision down (float8 hidden matmuls, bfloat16 GAE;
    TF32 does not exist on the CPU) fails one of the numbers at least."""
    assert _control_fails("cpu")


@pytest.mark.card
def test_control_fails_on_the_card(card):
    assert _control_fails(card)
