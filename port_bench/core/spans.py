"""The program's spans of a traced window, per counted iteration and on the
device trace's timeline.

While a torch profiler runs, the program records named spans of its host
work (learninghumanoidwalking_tpu_torch/utils/trace.py: ``ppo.iteration``,
``ppo.sample``, ``env.step``, ``physics.launch``, ``host.read``, ...), each
with its start and end on the host's monotonic clock in nanoseconds, its
enclosing span and the blocking host-device synchronizations charged to
it. The harness's window runs under its profiler, so after the window the
program holds that window's spans; a program without the recorder holds
none, and every reader of them then reads None.

The counted iterations are the first ``len(ctx["iterations"])`` top-level
``ppo.iteration`` spans (the window's last iteration, which closed the
window, is not counted). Iteration k's spans are that span and everything
inside it.

Placing a span on the device timeline (trace.py's microseconds): each
iteration ends in one host read (its last ``host.read`` span, the
``nonfinite_steps`` count), whose device-to-host copy is the last one of
the trace's iteration k in stream order: the harness's marker follows it.
The offset of iteration k maps the end of that span onto the end of that
copy, and a span of iteration k lies on the device timeline at its host
interval less the offset. The check of the alignment
(``sample_read_lags_us``) places the end of ``ppo.sample``'s own read the
same way and measures how long after the end of the nearest earlier
device-to-host copy it lands.

Both are computed once per run and kept in ``ctx``, as launches.py keeps
``ctx["launches"]``; ``ctx["program_spans"]``, where a caller has set it,
stands for the program's spans.
"""

from __future__ import annotations

from port_bench.core import trace

NAME, START, END, PARENT, SYNCS = range(5)  # fields of a span tuple


def program_spans(ctx: dict) -> list:
    """[(name, start ns, end ns, parent index, syncs)] of the program's last
    recording, in start order; [] where the program has no recorder."""
    if "program_spans" not in ctx:
        try:
            from learninghumanoidwalking_tpu_torch.utils import trace as recorder
        except ImportError:
            ctx["program_spans"] = []
        else:
            ctx["program_spans"] = [(s.name, s.start_ns, s.end_ns, s.parent, s.syncs) for s in recorder.recorded()]
    return ctx["program_spans"]


def iterations(ctx: dict) -> list | None:
    """Per counted iteration, the indices in ``program_spans`` of its closed
    spans (its ``ppo.iteration`` span first); None where fewer iterations
    were recorded than counted."""
    if "span_iterations" in ctx:
        return ctx["span_iterations"]
    spans, n = program_spans(ctx), len(ctx["iterations"])
    root = []
    for i, s in enumerate(spans):
        root.append(i if s[PARENT] is None else root[s[PARENT]])
    tops = [i for i, s in enumerate(spans) if s[PARENT] is None and s[NAME] == "ppo.iteration"][:n]
    out = None
    if n and len(tops) == n:
        where = {top: k for k, top in enumerate(tops)}
        out = [[] for _ in range(n)]
        for i, s in enumerate(spans):
            if root[i] in where and s[END] is not None:
                out[where[root[i]]].append(i)
    ctx["span_iterations"] = out
    return out


def _named(ctx: dict, it: list, name: str) -> list:
    spans = program_spans(ctx)
    return [i for i in it if spans[i][NAME] == name]


def _is_read_copy(e) -> bool:
    return e[1] == "gpu_memcpy" and e[0].startswith("Memcpy DtoH")


def alignment(ctx: dict) -> dict | None:
    """``offsets_us``: per counted iteration, host microseconds less device
    trace microseconds; ``sample_read_lags_us``: per counted iteration, how
    long after the end of the nearest earlier device-to-host copy the end of
    ``ppo.sample``'s read lands (None where no copy precedes it). None
    without a device trace or recorded iterations."""
    if "span_alignment" in ctx:
        return ctx["span_alignment"]
    its, tw, spans = iterations(ctx), ctx["trace"], program_spans(ctx)
    out = None
    if its is not None and tw is not None and len(tw["iterations"]) == len(its):
        offsets, lags = [], []
        for it, events in zip(its, tw["iterations"]):
            reads = _named(ctx, it, "host.read")
            copy_ends = sorted(e[3] for e in events if _is_read_copy(e))
            if not reads or not copy_ends:
                break
            off = spans[reads[-1]][END] / 1e3 - copy_ends[-1]
            offsets.append(off)
            sample = _named(ctx, it, "ppo.sample")
            own = [i for i in reads if sample and spans[i][PARENT] == sample[0]]
            t = spans[own[-1]][END] / 1e3 - off if own else None
            before = [c for c in copy_ends if t is not None and c <= t]
            lags.append(t - before[-1] if before else None)
        else:
            out = {"offsets_us": offsets, "sample_read_lags_us": lags}
    ctx["span_alignment"] = out
    return out


def idle_share(ctx: dict, name: str) -> float | None:
    """1 - the union of device activity inside the spans ``name``, placed on
    the device timeline, over their summed length."""
    al = alignment(ctx)
    if al is None:
        return None
    spans, length, busy = program_spans(ctx), 0.0, 0.0
    for it, off, events in zip(iterations(ctx), al["offsets_us"], ctx["trace"]["iterations"]):
        activity = [(e[2], e[3]) for e in events]
        for i in _named(ctx, it, name):
            a, b = spans[i][START] / 1e3 - off, spans[i][END] / 1e3 - off
            length += b - a
            busy += trace.union_within(activity, a, b)
    return 1.0 - busy / length if length > 0 else None


def _ms(s) -> float:
    return (s[END] - s[START]) / 1e6


def ms_per_iteration(ctx: dict, names: tuple, less: str | None = None) -> float | None:
    """Host ms per counted iteration in the spans ``names``, less the time
    of their direct children named ``less``; None where none was recorded."""
    its = iterations(ctx)
    if its is None:
        return None
    spans = program_spans(ctx)
    total, found = 0.0, False
    for i in (i for it in its for i in it):
        s = spans[i]
        if s[NAME] in names:
            total += _ms(s)
            found = True
        elif s[NAME] == less and s[PARENT] is not None and spans[s[PARENT]][NAME] in names:
            total -= _ms(s)
    return total / len(its) if found else None


def ms_per_span(ctx: dict, name: str, per: str | None = None) -> float | None:
    """Host ms in the spans ``name`` of the counted iterations over the
    count of the spans ``per`` (default: ``name``): a mean span's ms, or the
    ms of ``name`` per ``per``."""
    its = iterations(ctx)
    if its is None:
        return None
    spans = program_spans(ctx)
    flat = [spans[i] for it in its for i in it]
    count = sum(1 for s in flat if s[NAME] == (per or name))
    total = sum(_ms(s) for s in flat if s[NAME] == name)
    return total / count if count else None


def syncs_per_iteration(ctx: dict) -> float | None:
    """Blocking host-device synchronizations counted in the spans of the
    counted iterations, per iteration."""
    its = iterations(ctx)
    if its is None:
        return None
    spans = program_spans(ctx)
    return sum(spans[i][SYNCS] for it in its for i in it) / len(its)
