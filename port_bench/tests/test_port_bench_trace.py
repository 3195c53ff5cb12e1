"""The trace arithmetic on synthetic device timelines."""

import pytest
from torch.autograd import DeviceType

from port_bench.core import trace


def test_union_counts_overlap_once_and_clips():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 50)]
    assert trace.union_within(iv, 0, 100) == 15 + 11 + 10
    assert trace.union_within(iv, 8, 25) == 7 + 5
    assert trace.union_within([], 0, 10) == 0.0


def _ev(name, start, end, cat="kernel"):
    return [name, cat, float(start), float(end)]


def test_window_splits_iterations_at_the_markers():
    m = "void at::cuda::spin_kernel(long)"
    dev = [_ev(m, 0, 1), _ev("a", 2, 5), _ev("b", 6, 8, "gpu_memcpy"), _ev(m, 10, 11),
           _ev("c", 12, 20), _ev(m, 21, 22), _ev("late", 23, 30)]
    w = trace.window(dev, 2)
    assert (w["lo"], w["hi"]) == (1.0, 21.0)
    assert [[e[0] for e in it] for it in w["iterations"]] == [["a", "b"], ["c"]]
    assert trace.window(dev, 3) is None  # too few markers: nothing to read


class _OlderEvent:
    """A stand-in for the profiler's in-memory event, as builds of torch
    without ``activity_type`` give it."""

    def __init__(self, name, cat, start_ns, dur_ns):
        self._v = name, cat, start_ns, dur_ns

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def device_type(self):
        return DeviceType.CPU if self._v[1] in ("cuda_runtime", "cpu_op") else DeviceType.CUDA

    def is_user_annotation(self):
        return self._v[1] == "gpu_user_annotation"


class _Event(_OlderEvent):
    """The same, as builds with ``activity_type`` give it."""

    def activity_type(self):
        return self._v[1]


@pytest.mark.parametrize("event", [_Event, _OlderEvent])
def test_device_events_keep_device_categories_only(event):
    t0 = 1_792_371_998_974_476_396  # an absolute time: microseconds kept to the nanosecond
    events = [event("k", "kernel", t0 + 5000, 2001), event("cudaLaunchKernel", "cuda_runtime", t0 + 1000, 1000),
              event("Memset (Device)", "gpu_memset", t0 + 3000, 1000),
              event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", t0 + 4000, 500),
              event("ppo.sample", "gpu_user_annotation", t0 + 2000, 9000)]
    assert trace.kineto_device_events(events) == [["Memset (Device)", "gpu_memset", 0.0, 1.0],
                                                  ["Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1.0, 1.5],
                                                  ["k", "kernel", 2.0, 4.001]]
    assert trace.kineto_device_events([]) == []
