"""The program's spans on the device timeline (core/spans.py) and the seven
readers of them, on a synthetic run: device events in trace microseconds,
spans in host nanoseconds at a known offset from them."""

import sys

import pytest

from port_bench.core import cells, spans
from port_bench.tests.conftest import ROOT

READERS = ("rollout_idle_share.train", "update_idle_share.train", "env_ms.train", "physics_launch_ms.train",
           "grad_step_ms.train", "adam_ms.train", "host_syncs_per_iter.train")
OFFSET_US = 7_654_321_987.25  # host microseconds less device microseconds, iteration 0
DRIFT_US = 3.5  # iteration 1's offset is this much larger
PERIOD_US = 2000.0  # device microseconds from one iteration to the next

# (name, parent's position in this list, device start, end, syncs) of one iteration, in start order
ITERATION = [
    ("ppo.iteration", None, 0, 1000, 0),
    ("ppo.sample", 0, 10, 500, 0),
    ("env.reset", 1, 20, 100, 0),
    ("physics.launch", 2, 30, 60, 2),
    ("env.step", 1, 100, 200, 3),
    ("physics.launch", 4, 120, 150, 2),
    ("host.read", 1, 400, 485, 4),  # the sample's read: 5 us after its copy
    ("ppo.optimize", 0, 500, 950, 0),
    ("host.read", 7, 505, 520, 1),
    ("ppo.grad_step", 7, 520, 700, 0),
    ("ppo.adam", 9, 600, 640, 0),
    ("ppo.adam", 9, 640, 690, 0),
    ("host.read", 7, 900, 945, 5),
    ("host.read", 0, 960, 975, 1),  # the last read ends with its copy
]
EVENTS = [("k", "kernel", 50, 300), ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 470, 480),
          ("k", "kernel", 505, 515), ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 515, 516),
          ("k", "kernel", 600, 800), ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 810, 812),
          ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 940, 941),
          ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 970, 975)]


def _ctx(iterations=3, counted=2):
    program = []
    for k in range(iterations):
        base, off = k * PERIOD_US, OFFSET_US + k * DRIFT_US
        first = len(program)
        for name, parent, a, b, syncs in ITERATION:
            program.append((name, round((base + a + off) * 1e3), round((base + b + off) * 1e3),
                            None if parent is None else first + parent, syncs))
    events = [[[n, c, k * PERIOD_US + a, k * PERIOD_US + b] for n, c, a, b in EVENTS] for k in range(counted)]
    tw = {"lo": 0.0, "hi": counted * PERIOD_US, "iterations": events}
    return {"iterations": [{} for _ in range(counted)], "trace": tw, "program_spans": program}


def test_alignment_recovers_the_offset_and_checks_the_sample_read():
    al = spans.alignment(_ctx())
    assert al["offsets_us"] == pytest.approx([OFFSET_US, OFFSET_US + DRIFT_US], abs=1.0)
    assert al["sample_read_lags_us"] == pytest.approx([5.0, 5.0], abs=1.0)


def test_readers_equal_the_hand_computed_values():
    ctx = _ctx()
    got = {name: cells.read_metric(cells.reader_path(name, ROOT), ctx) for name in READERS}
    assert got == pytest.approx({
        "rollout_idle_share.train": 1 - (250 + 10) / 490,  # in [10, 500]: the kernel 50-300, the copy 470-480
        "update_idle_share.train": 1 - (10 + 1 + 200 + 2 + 1) / 450,  # in [500, 950]
        "env_ms.train": ((80 - 30) + (100 - 30)) / 1e3,
        "physics_launch_ms.train": 60 / 1e3,
        "grad_step_ms.train": 180 / 1e3,
        "adam_ms.train": 90 / 1e3,
        "host_syncs_per_iter.train": 2 + 3 + 2 + 4 + 1 + 5 + 1,
    }, rel=1e-6)


def _read_all(ctx):
    return {name: cells.read_metric(cells.reader_path(name, ROOT), ctx) for name in READERS}


def test_every_reader_reads_none_with_no_recorded_spans():
    assert set(_read_all(_ctx(iterations=0)).values()) == {None}
    assert set(_read_all(_ctx(iterations=1)).values()) == {None}  # fewer recorded than counted


def test_a_program_without_the_recorder_gives_none(monkeypatch):
    import learninghumanoidwalking_tpu_torch.utils as utils

    ctx = _ctx()
    del ctx["program_spans"]
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "learninghumanoidwalking_tpu_torch.utils.trace", None)  # the import fails
    assert set(_read_all(ctx).values()) == {None} and ctx["program_spans"] == []


def test_without_a_device_trace_only_the_host_readers_read():
    ctx = _ctx()
    ctx["trace"] = None
    got = _read_all(ctx)
    assert got["rollout_idle_share.train"] is None and got["update_idle_share.train"] is None
    assert got["grad_step_ms.train"] == pytest.approx(0.18)


def test_span_report_splits_the_idle_time_by_innermost_span():
    from port_bench import span_report

    union = span_report.merged([(0, 2), (1, 3), (5, 6), (8, 10)])
    assert union == [[0, 3], [5, 6], [8, 10]]
    prefix = [0, 3, 4, 6]
    for a, b in [(0, 10), (1, 9), (3, 5), (2.5, 5.5), (6, 8), (-1, 0.5), (9.5, 20), (4, 4)]:
        want = sum(max(0.0, min(y, b) - max(x, a)) for x, y in union)
        assert span_report.busy_within(union, prefix, a, b) == pytest.approx(want), (a, b)
    ctx = _ctx()
    idle = span_report.idle_by_innermost_span(ctx)
    busy = sum(b - a for it in ctx["trace"]["iterations"] for a, b in span_report.merged([(e[2], e[3]) for e in it]))
    assert sum(idle.values()) == pytest.approx((ctx["trace"]["hi"] - busy) / 1e6)
    # iteration 0's sample read (400-485 on the device) idles but for the copy 470-480
    assert idle["host.read"] > 2 * 75e-6 and idle["ppo.adam"] == pytest.approx(0.0)
