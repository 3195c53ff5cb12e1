"""Readings for setting the check's limits: the program's, the control's and the faults'.

    python3 port_bench/calibrate.py --workload <cell> --seeds <n> [<n> ...] [--out <file.jsonl>]

For each seed, in one process: the cell's set-up and its window up to the
window's captured iteration (harness.py's run at the cell's own sizes, with
no time limit), then every number of port_bench/core/check.py on both
captures for the program, for the control (the reference one precision
down) and for the planted faults (the update on half of each minibatch; a
state left unchanged; the kernel leaving a half or a tenth of the envs
unchanged), and the spread of the envs' ratios. One JSON line a seed on
standard output (and appended to ``--out``).
Needs the card, as run.py does.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from port_bench.core import cells, check, harness

    cell = cells.resolve(cells.load_benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available():
        print("port_bench: calibrate needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        ppo, ts, warm, tap, captures = harness.setup(cell, seed, dev)
        t1 = time.perf_counter()
        try:
            harness.window(ppo, ts, None, tap, captures[1])
        finally:
            tap.remove()
        records = [c.settled() for c in captures]
        del ppo, ts, warm, tap, captures
        gc.collect()
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        got = {r["where"]: {"iteration": r["iteration"], "step_at": r["step_at"],
                            **check.capture_numbers(cell, r, dev)} for r in records}
        line = {"workload": cell.name, "seed": seed, "setup_s": t1 - t0, "window_s": t2 - t1,
                "check_s": time.perf_counter() - t2, **got}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
