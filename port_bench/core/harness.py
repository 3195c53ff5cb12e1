"""One run of one cell: set-up, the measured window, the check, the result line.

Set-up builds the env (``envs.registry.make_env``) from the configuration's
env settings, the trainer (``rl.ppo.PPO``) from its PPO settings and the
traffic mix, draws the actor's and critic's weights on the device from the
seed, resets the env batch, installs the capture's hooks (capture.py) and
runs ``warm_iterations`` iterations of ``PPO.train`` (evaluation off),
capturing the first. The window then runs ``PPO.train`` again on the same
trainer state, iteration after iteration, captures the iteration the seed
draws among its first ``check.window_iterations``, and closes through
``on_iteration`` once ``seconds`` have passed; only iterations completed
inside it count. With ``trace`` the whole window runs under torch.profiler
(CUDA activity) and the per-layer readers read that trace. After the window
the hooks go, the program's state is freed and the reference judges both
captures.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from port_bench.core import capture as cap_mod
from port_bench.core import cells, check, trace

# top-level module names a run may not hold (the JAX stack and the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "learninghumanoidwalking_tpu")


class ForbiddenModules(RuntimeError):
    """The run's process holds a module of the JAX stack or the JAX package."""


class WindowClosed(Exception):
    """Raised from on_iteration to end PPO.train when the window closes."""


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({name for name in names if name.split(".", 1)[0] in FORBIDDEN})


def ppo_config(cell: cells.Cell, seed: int):
    from learninghumanoidwalking_tpu_torch.rl.ppo import PPOConfig

    pol, ppo, tr = cell.config["policy"], cell.config["ppo"], cell.traffic
    return PPOConfig(
        n_itr=10**9, lr=ppo["lr"], eps=ppo["eps"], gamma=ppo["gamma"], lam=ppo["lam"], std_dev=pol["init_std"],
        learn_std=pol["learn_std"], entropy_coeff=ppo["entropy_coeff"], clip=ppo["clip"],
        minibatch_size=tr["minibatch_size"], epochs=tr["epochs"], num_envs=tr["num_envs"],
        rollout_len=tr["rollout_len"], max_traj_len=tr["max_traj_len"], max_grad_norm=ppo["max_grad_norm"],
        mirror_coeff=ppo["mirror_coeff"], use_mirror=ppo["use_mirror"], seed=seed,
        minibatch_scheme=tr["minibatch_scheme"], net_dtype=pol["net_dtype"], hidden=tuple(pol["hidden"]),
    )


@torch.no_grad()
def load_weights(module: torch.nn.Module, leaves: dict, leaf_name) -> None:
    for name, p in module.named_parameters():
        p.copy_(leaves[leaf_name(name)])


def write_env_config(cfg: dict) -> str:
    """The configuration's env settings as the JSON file the env reads."""
    fd, path = tempfile.mkstemp(prefix="port_bench_env_", suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(cfg, f)
    return path


def card_info(device) -> dict:
    """The card's name, count and (nvidia-smi, where it answers) power limit."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(smi.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def setup(cell: cells.Cell, seed: int, device):
    """Everything before the window: env, trainer, weights from ``seed``, the
    env batch, the capture's hooks, ``warm_iterations`` iterations of
    PPO.train, the first of them captured. Returns (ppo, train state, the
    warm iterations' metrics, the tap, [the set-up's capture, the window's])."""
    from learninghumanoidwalking_tpu_torch.envs.registry import make_env
    from learninghumanoidwalking_tpu_torch.rl.ppo import PPO

    cfg_path = write_env_config(cell.config["env_config"])
    try:
        env = make_env(cell.config["env"], path_to_json=cfg_path, device=device)
    finally:
        os.unlink(cfg_path)
    ppo = PPO(env, ppo_config(cell, seed), device=device)
    ts = ppo.init_state()
    ref = check.nets(cell)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED)
    weights = ref.init_weights(env.obs_size, env.action_size, cell.config["policy"]["hidden"], gen, device)
    load_weights(ts.actor, weights["actor"], ref.leaf_name)
    load_weights(ts.critic, weights["critic"], ref.leaf_name)
    captures = [cap_mod.Capture(cell, seed, "set-up", 0xC4EC),
                cap_mod.Capture(cell, seed, "window", 0xC4ED, cell.traffic["check"]["window_iterations"])]
    tap = cap_mod.Tap(ppo, ref.leaf_name)
    tap.install()
    tap.arm(captures[0])
    ts, warm = ppo.train(n_itr=cell.traffic["warm_iterations"], ts=ts, verbose=False, evaluate=False)
    return ppo, ts, warm, tap, captures


def window(ppo, ts, seconds: float | None, tap, capture, tracer=None):
    """PPO.train (evaluation off) for ``seconds`` (None: until ``capture``
    is complete), arming ``capture`` for its iteration. Returns (the
    window's start, each counted iteration's end and metrics)."""
    ends, iters = [], []

    def on_iteration(itr, metrics):
        now = time.perf_counter()
        if seconds is not None and now - w0 > seconds:
            raise WindowClosed
        ends.append(now)
        iters.append(metrics)
        if tracer is not None:
            tracer.iteration_done()
        if itr + 1 == capture.iteration:
            tap.arm(capture)
        if seconds is None and capture.complete:
            raise WindowClosed

    if capture.iteration == 0:
        tap.arm(capture)
    if tracer is not None:
        tracer.start()
    w0 = time.perf_counter()
    try:
        ppo.train(ts=ts, verbose=False, evaluate=False, on_iteration=on_iteration)
    except WindowClosed:
        pass
    if tracer is not None:
        tracer.stop()
    return w0, ends, iters


class Tracer:
    """torch.profiler over the whole window, CUDA activity only, with a
    ``torch.cuda._sleep`` marker kernel at the start and after each counted
    iteration (trace.py splits the timeline there). The device events are
    read from the profiler's results in memory, not through a Chrome trace
    file."""

    def __init__(self):
        self.prof, self.events, self.iterations, self.seconds = None, None, 0, {}

    def start(self) -> None:
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda._sleep(1000)

    def iteration_done(self) -> None:
        torch.cuda._sleep(1000)
        self.iterations += 1

    def stop(self) -> None:
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        self.prof.stop()
        t1 = time.perf_counter()
        self.events = trace.kineto_device_events(self.prof.profiler.kineto_results.events())
        self.prof = None
        self.seconds.update(stop=t1 - t0, read=time.perf_counter() - t1)

    def timeline(self) -> dict | None:
        """The counted iterations' device timeline (trace.window)."""
        return trace.window(self.events, self.iterations) if self.iterations else None


def sm_clock() -> str | None:
    """nvidia-smi's SM clock, power draw and temperature, as one line."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return smi.stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        return None


def run(cell: cells.Cell, seed: int, seconds: float, trace_on: bool, device: str = "cuda", t_start=None) -> dict:
    """Run ``cell`` once; returns the result line's object (metrics,
    device, correct, ...)."""
    t0 = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    ppo, ts, warm, tap, captures = setup(cell, seed, dev)
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"set-up loaded {found}")

    # ---- the window ----
    tracer = Tracer() if (trace_on and on_card) else None
    clocks = [sm_clock()] if on_card else []
    try:
        w0, ends, iters = window(ppo, ts, seconds, tap, captures[1], tracer)
    finally:
        tap.remove()
    if on_card:
        clocks.append(sm_clock())
    if not iters:
        raise RuntimeError(f"no iteration completed within the {seconds} s window")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    ctx = dict(cell=cell, seed=seed, setup_s=setup_s, window_s=ends[-1] - w0, iterations=iters,
               env_steps_per_iteration=cell.traffic["num_envs"] * cell.traffic["rollout_len"], peak_bytes=peak,
               device=dev, trace=None, counts={"obs_size": ppo.env.obs_size, "action_size": ppo.env.action_size})
    trace_s = {}
    if tracer is not None:
        ctx["trace"], trace_s = tracer.timeline(), tracer.seconds
    t_metrics = time.perf_counter()
    metric_list = cell.per_layer if trace_on else cell.end_to_end
    metrics = {}
    for m in metric_list:
        value = cells.read_metric(cell.readers[m["name"]], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = card_info(dev) if on_card else {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(peak)
    if trace_on and ctx["trace"] is not None:
        tw = ctx["trace"]
        window_us = tw["hi"] - tw["lo"]
        busy_us = trace.union_within([(e[2], e[3]) for it in tw["iterations"] for e in it], tw["lo"], tw["hi"])
        info.update(busy_s=busy_us / 1e6, window_s=window_us / 1e6)
    breakdown = breakdown_of(ctx) if trace_on else None
    trace_s["metrics_and_breakdown"] = time.perf_counter() - t_metrics
    failed = sum(1 for a, b in zip([warm[-1]] + iters[:-1], iters) if b["nonfinite_steps"] > a["nonfinite_steps"])

    # ---- free the program, then judge what was captured ----
    records = [c.settled() for c in captures]
    del ts, ppo, tap, captures, ctx, warm, tracer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check.judge(cell, records, dev)
    check_s = time.perf_counter() - t_check
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"the run loaded {found}")
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()), "attempted": len(iters),
           "failed": failed, "metrics": metrics, "device": info,
           "diagnostics": {"iteration_s": [[m["sample_time"], m["optimize_time"]] for m in iters],
                           "captured": [r["iteration"] for r in records],
                           "clocks": clocks, "trace_s": trace_s, "check_s": check_s}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def short(name: str) -> str:
    """A kernel's symbol without return type, namespaces' templates and arguments."""
    name = name.removeprefix("void ")
    for stop in ("<", "("):
        name = name.split(stop, 1)[0]
    return name[-60:]


def breakdown_of(ctx: dict) -> dict | None:
    """The device operations that took most time, and the device's idle
    time by what the host was doing: in all, per phase of the iteration
    (sample or optimize, split at the program's own sample time; the
    boundary between iterations, where the host reads the metrics), then
    the longest single gaps with the operations on either side."""
    tw = ctx["trace"]
    if tw is None:
        return None
    by_name: dict = {}
    for it in tw["iterations"]:
        for e in it:
            by_name[e[0]] = by_name.get(e[0], 0.0) + (e[3] - e[2]) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    totals = {"sample": 0.0, "optimize": 0.0, "iteration boundary": 0.0}
    gaps = []
    iters = tw["iterations"]
    if iters[0]:
        totals["iteration boundary"] += (iters[0][0][2] - tw["lo"]) / 1e6
    for k, it in enumerate(iters):
        if not it:
            continue
        split = it[0][2] + 1e6 * ctx["iterations"][k]["sample_time"]
        cursor, prev = it[0][3], it[0][0]
        for e in it[1:]:
            if e[2] > cursor:
                phase = "sample" if cursor < split else "optimize"
                totals[phase] += (e[2] - cursor) / 1e6
                gaps.append((f"{phase}: {short(prev)} -> {short(e[0])}", (e[2] - cursor) / 1e6))
            if e[3] > cursor:
                cursor, prev = e[3], e[0]
        nxt = iters[k + 1][0][2] if k + 1 < len(iters) and iters[k + 1] else tw["hi"]
        totals["iteration boundary"] += max(nxt - cursor, 0.0) / 1e6
    gaps.sort(key=lambda g: -g[1])
    idle = [[f"all gaps, {phase}", sec] for phase, sec in totals.items()] + [[n, s] for n, s in gaps[:7]]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}
