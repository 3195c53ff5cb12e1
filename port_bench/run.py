"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json and the
learninghumanoidwalking_tpu_torch package, on a machine with an NVIDIA GPU.
The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the compared
numbers with their limits); standard error ends with those numbers too.
Without a card, or with fewer cards than the cell asks for, it prints no
result and exits 2; a run that loads the JAX stack or the JAX package
exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root; the port builds its kernels under build/kernels there
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench.core import cells, harness

    cell = cells.resolve(cells.load_benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: cell {cell.name} needs {cell.chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    try:
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    except harness.ForbiddenModules as err:
        print(f"port_bench: {err}", file=sys.stderr)
        return 3
    diag = out.pop("diagnostics")
    print(f"clocks (sm, power, temperature) at the window's start and end: {diag['clocks']}", file=sys.stderr)
    print(f"seconds after the window: trace {diag['trace_s']}, check {diag['check_s']:.1f}", file=sys.stderr)
    print(f"captured iterations (of set-up, of the window): {diag['captured']}", file=sys.stderr)
    for k, (sample, optimize) in enumerate(diag["iteration_s"]):
        print(f"iteration {k}: sample {sample:.4f} s, optimize {optimize:.4f} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
