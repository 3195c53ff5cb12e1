"""Watch a long training run of the port's command line.

Runs ``run_experiment train <flags>`` in this process, through its
``on_iteration`` hook, and records at every iteration: the iteration's
sample and optimize seconds (PPO.train times them after a device
synchronization) and its wall seconds with the evaluation and the
checkpoint, the evaluation return where there was one, the device memory
allocated now and at its peak so far, the host's resident memory, and the
non-finite gradient steps both Adams have met so far. It rewrites the
``--out`` JSON after every iteration (a run cut short keeps what it
reached) and ends with a summary: the evaluation returns, the
wall seconds until the return first reached ``--target`` (from the start
of the command, the env build and the kernel's compile included), the
iteration times at the start and at the end, and peak memory at iteration
10 and at the end.

  python -m learninghumanoidwalking_tpu_torch.train_watch --target 350 --out h1_watch.json -- train --env h1 --num-envs 4096 --n-itr 300 --eval-freq 25

Every flag after ``--`` is the command line's (``--continued`` too).
"""

from __future__ import annotations

import argparse
import json
import resource
import time
from pathlib import Path

GIB = 2.0**30


def _host_rss_gib() -> float:
    """This process's resident memory now (Linux), or its peak elsewhere."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * resource.getpagesize() / GIB
    except OSError:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / GIB


def _mean(xs: list) -> float | None:
    return sum(xs) / len(xs) if xs else None


def summarize(records: list, target: float, window: int = 10) -> dict:
    """Evaluation returns by iteration, the first wall time at ``target``,
    the mean iteration seconds (sample + optimize) over the first
    ``window`` iterations after iteration 0 and over the last ``window``,
    peak device memory at iteration 10 and at the end, and the non-finite
    steps at the end."""
    evals = [(r["itr"], r["eval_return"], r["wall_s"]) for r in records if r.get("eval_return") is not None]
    reached = next(((itr, wall) for itr, ret, wall in evals if ret >= target), None)
    times = [r["sample_s"] + r["optimize_s"] for r in records]
    at10 = next((r for r in records if r["itr"] == 10), None)
    last = records[-1] if records else {}
    return dict(
        evals=[dict(itr=i, eval_return=ret, wall_s=w) for i, ret, w in evals],
        target=target,
        first_at_target=None if reached is None else dict(itr=reached[0], wall_s=reached[1]),
        iterations=len(records),
        iter_s_start=_mean(times[1 : 1 + window]),
        iter_s_end=_mean(times[-window:]),
        peak_alloc_gib_at_10=None if at10 is None else at10["peak_alloc_gib"],
        peak_alloc_gib_end=last.get("peak_alloc_gib"),
        host_rss_gib_at_10=None if at10 is None else at10["host_rss_gib"],
        host_rss_gib_end=last.get("host_rss_gib"),
        nonfinite_steps=last.get("nonfinite_steps"),
    )


def watch(train_argv: list, target: float, out_path: str | Path) -> dict:
    """Run the command line's train with ``train_argv`` under the watch,
    rewriting ``out_path`` each iteration; returns the summary, the run
    directory and the records."""
    import torch

    from learninghumanoidwalking_tpu_torch.run_experiment import build_train_parser, resolve_device, train

    device = resolve_device(build_train_parser().parse_args(train_argv).device)
    cuda = device.type == "cuda"
    t_start = time.time()
    records: list[dict] = []
    out: dict = {"argv": train_argv, "device": torch.cuda.get_device_name(device) if cuda else "cpu"}
    out_path = Path(out_path)
    t_prev = [None]

    def on_iteration(itr, metrics):
        now = time.time()
        records.append(dict(
            itr=itr,
            sample_s=metrics["sample_time"],
            optimize_s=metrics["optimize_time"],
            iter_wall_s=None if t_prev[0] is None else now - t_prev[0],
            mean_reward=metrics["mean_reward"],
            eval_return=metrics.get("eval_mean_reward"),
            eval_len=metrics.get("eval_mean_episode_length"),
            wall_s=now - t_start,
            alloc_gib=torch.cuda.memory_allocated(device) / GIB if cuda else None,
            peak_alloc_gib=torch.cuda.max_memory_allocated(device) / GIB if cuda else None,
            reserved_gib=torch.cuda.memory_reserved(device) / GIB if cuda else None,
            host_rss_gib=_host_rss_gib(),
            nonfinite_steps=int(metrics["nonfinite_steps"]),
        ))
        t_prev[0] = now
        out.update(records=records, summary=summarize(records, target))
        out_path.write_text(json.dumps(out, indent=1))

    result = train(train_argv, on_iteration=on_iteration)
    out["run_dir"] = str(result["run_dir"])
    out_path.write_text(json.dumps(out, indent=1))
    summary = summarize(records, target)
    print("watch: " + json.dumps(summary), flush=True)
    return dict(summary=summary, run_dir=result["run_dir"], records=records)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--target", type=float, default=350.0, help="the evaluation return whose first wall time is reported")
    p.add_argument("--out", type=Path, default=Path("watch.json"), help="the records and summary (JSON), rewritten every iteration")
    p.add_argument("train_argv", nargs=argparse.REMAINDER, help="-- train <the command line's train flags>")
    args = p.parse_args(argv)
    rest = args.train_argv[1:] if args.train_argv[:1] == ["--"] else args.train_argv
    if rest[:1] != ["train"]:
        p.error("expected: -- train <flags>")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    watch(rest[1:], args.target, args.out)


if __name__ == "__main__":
    main()
