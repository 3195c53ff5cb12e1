"""One traced run of a cell, and where its device idles by the program's spans.

    python3 port_bench/span_report.py --workload <cell> --seed <n> --seconds <s> [--out report.json]

From the root of a checkout, on a machine with an NVIDIA GPU. Runs the cell
once as ``run.py --trace 1`` does (harness.run) and prints one JSON object:
the run's metrics; the alignment of the program's spans with the device
trace (core/spans.py: each counted iteration's offset less the first one's,
and how long after the nearest earlier device-to-host copy ``ppo.sample``'s
read lands); per span name, the device's idle seconds in the window while it
was the innermost open span, its count, host ms and the blocking syncs
charged to it per iteration; and the idle shares the harness's breakdown
implies (a phase's idle seconds over its summed host time).
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def merged(intervals: list) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_within(union: list, prefix: list, a: float, b: float) -> float:
    """Length of the disjoint sorted intervals ``union`` inside [a, b];
    ``prefix``: the running sum of their lengths, from 0."""
    i = bisect.bisect_right(union, a, key=lambda u: u[1])  # the first that ends after a
    j = bisect.bisect_left(union, b, key=lambda u: u[0])  # the first that starts at or after b
    if j <= i:
        return 0.0
    return prefix[j] - prefix[i] - max(0.0, a - union[i][0]) - max(0.0, union[j - 1][1] - b)


def idle_by_innermost_span(ctx: dict) -> dict:
    """Device idle seconds in the counted iterations by the innermost open
    span (``(outside)``: no span of the iteration open, as between two
    iterations), placed on the device timeline."""
    from port_bench.core import spans as sp

    program, al, tw = sp.program_spans(ctx), sp.alignment(ctx), ctx["trace"]
    idle: dict = {}
    bounds = [it[0][2] for it in tw["iterations"][1:] if it] + [tw["hi"]]
    lo = tw["lo"]
    for k, (it, off, events) in enumerate(zip(sp.iterations(ctx), al["offsets_us"], tw["iterations"])):
        hi = bounds[k] if k < len(bounds) else tw["hi"]
        union = merged([(max(e[2], lo), min(e[3], hi)) for e in events if e[3] > lo and e[2] < hi])
        prefix = [0.0]
        for a, b in union:
            prefix.append(prefix[-1] + b - a)
        placed = [(program[i][sp.START] / 1e3 - off, program[i][sp.END] / 1e3 - off, program[i][sp.NAME]) for i in it]
        cuts = sorted({lo, hi, *(min(max(t, lo), hi) for a, b, _ in placed for t in (a, b))})
        for a, b in zip(cuts, cuts[1:]):
            inner = [p for p in placed if p[0] <= a and p[1] >= b]
            name = max(inner, key=lambda p: p[0])[2] if inner else "(outside)"
            idle[name] = idle.get(name, 0.0) + (b - a - busy_within(union, prefix, a, b)) / 1e6
        lo = hi
    return idle


def quartiles(values: list) -> list:
    return statistics.quantiles(values, n=4) if len(values) > 1 else values * 3


def report(ctx: dict, out: dict) -> dict:
    from port_bench.core import spans as sp

    its, al = sp.iterations(ctx), sp.alignment(ctx)
    if its is None or al is None:
        return {"metrics": out["metrics"], "spans": None}
    program, n = sp.program_spans(ctx), len(its)
    by_name: dict = {}
    for i in (i for it in its for i in it):
        s = program[i]
        d = by_name.setdefault(s[sp.NAME], {"count": 0, "host_ms": 0.0, "syncs": 0})
        d["count"] += 1
        d["host_ms"] += (s[sp.END] - s[sp.START]) / 1e6
        d["syncs"] += s[sp.SYNCS]
    idle = idle_by_innermost_span(ctx)
    per_span = {name: {"per_iteration": d["count"] / n, "host_ms_per_iteration": d["host_ms"] / n,
                       "syncs_per_iteration": d["syncs"] / n, "idle_s_innermost": idle.get(name, 0.0)}
                for name, d in sorted(by_name.items())}
    lags = [x for x in al["sample_read_lags_us"] if x is not None]
    drift = [o - al["offsets_us"][0] for o in al["offsets_us"]]
    phases = {}
    for phase, key in (("sample", "sample_time"), ("optimize", "optimize_time")):
        gaps = [s for name, s in out.get("breakdown", {}).get("idle_gaps", []) if name == f"all gaps, {phase}"]
        host_s = sum(m[key] for m in ctx["iterations"])
        phases[phase] = gaps[0] / host_s if gaps else None
    return {
        "metrics": out["metrics"], "device": out["device"], "iterations": n,
        "alignment": {"offset_drift_us": drift,
                      "sample_read_lag_us": {"n": len(al["sample_read_lags_us"]), "placed": len(lags),
                                             "min": min(lags, default=None), "quartiles": quartiles(lags),
                                             "max": max(lags, default=None),
                                             "share_0_100": sum(0 <= x <= 100 for x in lags) / n, "all": lags}},
        "spans": per_span, "idle_s_outside_spans": idle.get("(outside)", 0.0),
        "breakdown_idle_share": phases,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="also write the report here")
    args = ap.parse_args(argv)

    import torch

    from port_bench.core import cells, harness

    cell = cells.resolve(cells.load_benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA device", file=sys.stderr)
        return 2
    seen = {}
    read_metric = cells.read_metric

    def keep_ctx(path, ctx):
        seen["ctx"] = ctx
        return read_metric(path, ctx)

    cells.read_metric = keep_ctx
    try:
        out = harness.run(cell, args.seed, args.seconds, True, "cuda", T_START)
    finally:
        cells.read_metric = read_metric
    rep = report(seen["ctx"], out)
    rep.update(workload=args.workload, seed=args.seed, correct=out["correct"])
    text = json.dumps(rep)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
