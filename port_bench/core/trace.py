"""Read the window's device activity from torch.profiler's results.

``union_within`` is a frozen copy of ``_union_within`` of
learninghumanoidwalking_tpu_torch/rl/trace.py at commit
9e7f4a040c02fdfd29cfe1055f8fc2257b06e82f: the device's busy time is the
union of its activity intervals (kernels, memory copies and sets), so
overlapping work counts once. The rest is the benchmark's own.

The harness traces the CUDA activity only (host ops are not recorded, which
keeps a window's trace to device events) and marks the window on the device
timeline with one short ``torch.cuda._sleep`` kernel (its symbol contains
``MARKER``) at the window's start and after each completed iteration, the
host having synchronized there. Iteration k spans the device time from
marker k to marker k + 1.
"""

from __future__ import annotations

from torch.autograd import DeviceType

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"


def union_within(intervals: list, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    total, cur_a, cur_b = 0.0, None, None
    for a, b in clipped:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def _category(e) -> str | None:
    """An in-memory event's activity category, or None for a host event.
    Builds of torch without ``activity_type`` on the event: a device event
    that is not a user annotation is a copy, a set or a kernel by its name,
    as the Chrome trace names them."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
        return None
    name = e.name()
    return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"


def kineto_device_events(events) -> list:
    """[name, cat, start us, end us] of every device activity (kernels,
    memory copies and sets) among the profiler's in-memory events
    (``profile.profiler.kineto_results.events()``), in start order; times
    from the first of them, so that a float keeps a nanosecond."""
    raw = [(e.name(), cat, e.start_ns(), e.duration_ns()) for e in events if (cat := _category(e)) in DEVICE_CATS]
    base = min((r[2] for r in raw), default=0)
    out = [[name, cat, (t - base) / 1e3, (t - base + d) / 1e3] for name, cat, t, d in raw]
    return sorted(out, key=lambda e: e[2])


def window(dev: list, iterations: int) -> dict | None:
    """Split the device events at the markers: ``iterations`` lists, per
    counted iteration, its events without the markers; ``lo`` and ``hi`` the
    window in trace microseconds (marker 0's end to marker ``iterations``'s
    start). None where the trace holds fewer markers than that."""
    marks = [e for e in dev if MARKER in e[0]]
    if len(marks) < iterations + 1:
        return None
    lo, hi = marks[0][3], marks[iterations][2]
    work = [e for e in dev if MARKER not in e[0] and e[2] >= lo and e[2] < hi]
    bounds = [m[2] for m in marks[1: iterations + 1]]
    per_iter, k = [[] for _ in range(iterations)], 0
    for e in work:
        while k < iterations - 1 and e[2] >= bounds[k]:
            k += 1
        per_iter[k].append(e)
    return {"lo": lo, "hi": hi, "iterations": per_iter}
