"""The span recorder (utils/trace.py) on the trainer's iteration.

The CPU tests train the small H1 trainer of test_torch_keep.py with the
plain physics replaced by the identity (the recorder does not depend on it,
and a profiled iteration of the plain version's thousands of small ops is
slow). Tests marked ``card`` need an NVIDIA GPU and skip without one; on a
machine with one (which has no JAX): ``python -m pytest --noconftest -m card
tests/test_torch_trace.py``.
"""

import numpy as np
import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread here)

from learninghumanoidwalking_tpu_torch.envs.registry import make_env
from learninghumanoidwalking_tpu_torch.ops import substep_kernel
from learninghumanoidwalking_tpu_torch.rl import ppo
from learninghumanoidwalking_tpu_torch.utils import trace

ROLLOUT, EPOCHS, ENVS, MB = 3, 2, 4, 4
N_MB = ENVS * ROLLOUT // MB


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder for the test (the module's is shared by the process)."""
    rec = trace.Recorder()
    monkeypatch.setattr(trace, "RECORDER", rec)
    yield rec
    rec.stop()


@pytest.fixture
def trainer(monkeypatch):
    """The small H1 trainer with the identity as its physics, and its state."""
    monkeypatch.setattr(substep_kernel, "pd_substeps_batched", lambda model, dyn, physics, *args, **kw: physics)
    env = make_env("h1", device="cpu")
    cfg = ppo.PPOConfig(num_envs=ENVS, rollout_len=ROLLOUT, minibatch_size=MB, epochs=EPOCHS, net_dtype="float32",
                        hidden=(16, 16), max_traj_len=2, eval_freq=100)
    tr = ppo.PPO(env, cfg, device="cpu")
    assert tr.warmup_iterations() == 0
    return tr, tr.init_state()


def _raise(*args, **kwargs):
    raise AssertionError("called with no profiler running")


def test_no_profiler_records_nothing(recorder, trainer, monkeypatch):
    """With no profiler running a span enters no record_function, records
    nothing and never touches torch.cuda's sync debug mode; the trainer's
    times read no wall clock."""
    tr, ts = trainer
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", _raise)
    monkeypatch.setattr(ppo.time, "time", _raise)
    _, history = tr.train(2, ts=ts, verbose=False, evaluate=False)
    assert len(history) == 2 and all(m["sample_time"] > 0 and m["optimize_time"] > 0 for m in history)
    assert trace.recorded() == [] and not recorder.on and recorder.recordings == 0


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def test_profiled_iterations_record_every_span(recorder, trainer):
    """Under a CPU profiler each iteration records its parts, its env steps
    and reset pool with their physics launches, its gradient steps with two
    Adam steps each and its host reads, each inside its parent."""
    tr, ts = trainer
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tr.train(2, ts=ts, verbose=False, evaluate=False)
    spans = trace.recorded()
    assert recorder.dropped == 0 and all(s.end_ns is not None for s in spans)
    tops = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in tops] == ["ppo.iteration"] * 2
    for top in tops:
        parts = _children(spans, top)
        assert [s.name for s in parts] == ["ppo.sample", "ppo.optimize", "host.read"]
        sample, optimize = (spans.index(s) for s in parts[:2])
        assert [s.name for s in _children(spans, sample)] == ["env.reset"] + ["env.step"] * ROLLOUT + ["host.read"]
        for env_span in _children(spans, sample)[:-1]:
            assert [s.name for s in _children(spans, spans.index(env_span))] == ["physics.launch"]
        steps = _children(spans, optimize)
        assert [s.name for s in steps] == (["host.read"] + ["ppo.grad_step"] * N_MB) * EPOCHS + ["host.read"]
        for step in steps:
            if step.name == "ppo.grad_step":
                assert [s.name for s in _children(spans, spans.index(step))] == ["ppo.adam"] * 2
    for s in spans:
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
    assert sum(s.syncs for s in spans) == 0 and recorder.syncs_outside == 0  # no CUDA here: nothing counted


def test_each_training_under_a_profiler_is_one_recording(recorder, trainer):
    """A recording starts with an empty list at the first span under a
    profiler and ends when PPO.train returns, its list kept."""
    tr, ts = trainer
    for n in (1, 2):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            ts, _ = tr.train(1, ts=ts, verbose=False, evaluate=False)
        assert not recorder.on and recorder.recordings == n
        assert sum(s.name == "ppo.iteration" for s in trace.recorded()) == 1


def test_a_span_with_the_profiler_stopped_ends_the_recording(recorder):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("ppo.iteration"):
            pass
        assert recorder.on
    with trace.span("env.step"):
        pass
    assert not recorder.on and [s.name for s in trace.recorded()] == ["ppo.iteration"]


def test_recording_is_bounded(recorder, monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("ppo.iteration"):
            for _ in range(4):
                with trace.span("env.step"):
                    pass
    assert [s.name for s in trace.recorded()] == ["ppo.iteration", "env.step", "env.step"]
    assert recorder.dropped == 2 and recorder.stack == []


def test_train_ends_the_recording_when_it_raises(recorder, trainer):
    tr, ts = trainer

    def stop(itr, metrics):
        raise KeyboardInterrupt

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(KeyboardInterrupt):
            tr.train(2, ts=ts, verbose=False, evaluate=False, on_iteration=stop)
        assert not recorder.on and sum(s.name == "ppo.iteration" for s in trace.recorded()) == 1


# ---------------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on a machine with one")
    return torch.device("cuda")


def _cuda_profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


@pytest.mark.card
def test_no_profiler_leaves_sync_debug_mode_off(recorder, card):
    x = torch.ones(4, device=card)
    with trace.span("host.read"):
        float(x.sum())
    assert torch.cuda.get_sync_debug_mode() == 0 and trace.recorded() == []


@pytest.mark.card
def test_each_sync_kind_is_counted_once_on_its_span(recorder, card):
    """Under a CUDA-only profiler (as the benchmark's window runs it) the
    recorder records, and each kind of blocking synchronization is counted
    once and charged to the innermost open span; none is shown."""
    x = torch.arange(1.0, 5.0, device=card)
    host = np.ones(3, np.float32)
    with _no_warning():
        with _cuda_profiler():
            assert torch.autograd._profiler_enabled()
            with trace.span("ppo.iteration"):
                with trace.span("host.read"):
                    float(x.sum())
                with trace.span("ppo.sample"):
                    x.tolist()
                with trace.span("env.step"):
                    torch.as_tensor(host, device=card)
                with trace.span("physics.launch"):
                    x[x > 2.0]
                x + 1.0  # no sync
            assert torch.cuda.get_sync_debug_mode() == 1
            trace.stop()
            assert torch.cuda.get_sync_debug_mode() == 0
    syncs = {s.name: s.syncs for s in trace.recorded()}
    assert syncs == {"ppo.iteration": 0, "host.read": 1, "ppo.sample": 1, "env.step": 1, "physics.launch": 1}
    assert recorder.syncs_outside == 0


class _no_warning:
    """Fails if a warning reaches the warnings module's log."""

    def __enter__(self):
        import warnings

        self._ctx = warnings.catch_warnings(record=True)
        self.log = self._ctx.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        assert not [str(w.message) for w in self.log if trace.SYNC_WARNING in str(w.message)]
        return False
