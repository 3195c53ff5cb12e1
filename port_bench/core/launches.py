"""The control-step kernel launches of a traced window and their least times.

Each iteration of the window launches, in order, the reset pool's settle and
then ``rollout_len`` steps; the configuration names each one's kernel
symbol, build, substeps and reuse interval. Where settle and step share a
symbol (the flat build runs both in jvrc_walk), the first launch of that
symbol in an iteration is the settle. The work of a launch comes from the
frozen counts (port_bench/counts) on the benchmark's own model of the
robot and floor the configuration's ``reference`` section names; a motor
step counts its nets in the env-substeps past the history's warm-up: all but
those of the envs that restarted in that iteration (its
``episodes_finished``), spread evenly over its steps.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

from port_bench.counts import kernel_counts, net_counts
from port_bench.reference import physics as ref_physics

PEAKS = Path(__file__).resolve().parents[1] / "counts" / "peaks.json"


@lru_cache(maxsize=1)
def peaks() -> dict:
    with open(PEAKS) as f:
        return {k: v for k, v in json.load(f).items() if not k.startswith("_")}


def launches(ctx: dict) -> list[dict] | None:
    """[{symbol, kind, seconds, work}] of every control-step launch in the
    window; None without a trace."""
    tw = ctx["trace"]
    if tw is None:
        return None
    if "launches" in ctx:
        return ctx["launches"]
    cell = ctx["cell"]
    kernels = cell.config["kernels"]
    tr = cell.traffic
    batch, steps = tr["num_envs"], tr["rollout_len"]
    ref = cell.config["reference"]
    model, floor = ref_physics.model(ref, "cpu"), ref_physics.floor(ref["floor"])
    motor = None
    if "motor_nets" in cell.config:
        seed = cell.config["env_config"]["motor_dynamics"]["seed"]
        motor = ref_physics.motor_params(seed, model.nu, cell.config["motor_nets"]["hidden"], "cpu")
    symbols = {spec["symbol"] for spec in kernels.values()}
    # each kind's work without the motor nets, counted once
    base = {kind: kernel_counts.launch_work(model, floor, batch, spec["substeps"], spec["reuse"],
                                            motor if spec["motor"] else None)
            for kind, spec in kernels.items()}
    net_ops = kernel_counts.motor_flops_per_net(motor) if motor is not None else 0.0
    out = []
    for k, events in enumerate(tw["iterations"]):
        restarted = float(ctx["iterations"][k]["episodes_finished"])
        settled = False
        for e in events:
            sym = next((s for s in symbols if s in e[0]), None)
            if sym is None or e[1] != "kernel":
                continue
            if kernels["settle"]["symbol"] == sym and (not settled or kernels["step"]["symbol"] != sym):
                kind, settled = "settle", True
            else:
                kind = "step"
            spec, work = kernels[kind], dict(base[kind])
            if spec["motor"]:
                work["f32"] += net_ops * spec["substeps"] * max(batch * steps - restarted, 0.0) / steps
            out.append({"symbol": sym, "kind": kind, "seconds": (e[3] - e[2]) / 1e6, "work": work})
    ctx["launches"] = out
    return out


def roofline(ctx: dict, symbol: str) -> float | None:
    """Percent: the launches' summed least time over their summed device
    time, for the launches of ``symbol``; None where there are none."""
    found = [x for x in (launches(ctx) or []) if x["symbol"] == symbol]
    if not found:
        return None
    bound = sum(kernel_counts.least_seconds(x["work"], peaks()) for x in found)
    return 100.0 * bound / sum(x["seconds"] for x in found)


def step_mfu(ctx: dict) -> float | None:
    """Percent: the least time the published peaks need for the window's
    counted work (kernel operations at the float32 and float64 rates, the
    nets' matmuls at the bfloat16 rate) over the window's device length."""
    found = launches(ctx)
    if not found:
        return None
    p = peaks()
    kernel_s = sum(x["work"]["f32"] / p["f32_flops"] + x["work"]["f64"] / p["f64_flops"] for x in found)
    cell, facts, tr = ctx["cell"], ctx["counts"], ctx["cell"].traffic
    nets = net_counts.iteration_ops(facts["obs_size"], facts["action_size"], cell.config["policy"]["hidden"],
                                    tr["num_envs"], tr["rollout_len"], tr["minibatch_size"], tr["epochs"],
                                    cell.config["ppo"]["use_mirror"])
    net_s = len(ctx["iterations"]) * (nets["rollout"] + nets["update"]) / p["bf16_flops"]
    window_s = (ctx["trace"]["hi"] - ctx["trace"]["lo"]) / 1e6
    return 100.0 * (kernel_s + net_s) / window_s
