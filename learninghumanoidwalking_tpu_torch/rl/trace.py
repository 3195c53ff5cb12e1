"""Read back a Chrome trace that PPO.train's profiler hook wrote
(torch.profiler's export_chrome_trace): the CUDA kernels with the most
device time, and the device's idle share within the program's annotated
spans (utils/trace.py's ``SPANS``: ``ppo.iteration``, ``ppo.sample``,
``ppo.optimize``, ``ppo.eval``, ``env.step``, ``physics.launch``, ...).

The idle share of a span is 1 - (the union of device activity, kernels and
memory copies and sets, inside the span's host interval) / (its length).
``ppo.sample`` and ``ppo.optimize`` end in a host read of their metrics, so
their device work ends inside them; the work queued in a span without such
a read (``env.step``, ``physics.launch``, ...) runs on past its end.
"""

from __future__ import annotations

import json
from pathlib import Path

from learninghumanoidwalking_tpu_torch.utils.trace import SPANS

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_within(intervals: list, lo: float, hi: float) -> float:
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


def summarize_trace(path: str | Path, top: int = 5) -> dict:
    """``top_kernels``: [name, device ms, launches] by device time over the
    whole trace; ``device_ms``: all device activity; per annotated span
    name: its count, host ms and the device's idle share inside it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels: dict = {}
    for e in device:
        if e["cat"] == "kernel":
            ms, n = kernels.get(e["name"], (0.0, 0))
            kernels[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    busy = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    spans = {}
    for name in SPANS:
        found = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == name]
        if not found:
            continue
        length = sum(e["dur"] for e in found)
        active = sum(_union_within(busy, e["ts"], e["ts"] + e["dur"]) for e in found)
        spans[name] = dict(count=len(found), host_ms=length / 1e3, idle_share=1.0 - active / length if length else None)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(top_kernels=[[name, ms, n] for name, (ms, n) in ranked],
                device_ms=sum(e["dur"] for e in device) / 1e3, spans=spans)
