"""Decide ``correct``: the captured outputs of the timed path against the plain reference.

A run captures two iterations (capture.py): the first warm-up iteration of
set-up, which starts from the seed's weights and fresh Adam moments, and one
iteration of the window drawn from the seed, which starts from the
program's own state. Each number is taken on each capture; the run's number
is the larger, but for the numbers the configuration lists under
``start_limits``, which are taken on the set-up capture alone (PERF.md says
why). A number is a gap, so lower is better:

- ``settle_ratio``, ``step_ratio``: the kernel's outputs of the two captured
  launches (qpos, qvel and, with the motor hook, the commanded-torque
  history) against the frozen plain version in float64. Per env and field
  the gap e = max |x - x64| / (1 + |x64|) over the field's entries, over the
  same gap of the plain version in float32 (TF32 off), floored at 4 float32
  ulps: how much more the kernel strays than float32 rounding of this very
  state does (contacts amplify rounding, so the float32 witness is the
  scale). The env's ratio is its worst field's; the number is the median
  env's ratio among the sampled envs;
- ``settle_tail``, ``step_tail``: the share of the sampled envs whose ratio
  is over ``TAIL_RATIO``: a kernel that gets some of the envs wrong, or
  leaves them unchanged, moves the tail and not the median;
- ``rollout_logp``: the widest gap of the rollout's log probs, and
  ``rollout_value`` of its values (over the values' RMS), against the
  reference nets on the same observations and actions;
- ``gae_adv`` (normalized advantages) and ``gae_return`` (returns, over their
  RMS): the batch the update was given against GAE recomputed from the
  rollout's rewards, values and episode ends;
- ``update_loss``: the largest relative gap of the captured gradient steps'
  losses; ``update_grad``: the first gradient as Adam took it (from its first
  moments before and after the step), ``update_delta``: the parameters'
  change over the captured steps, each as the gap of the leaf's norm to the
  reference's, over the larger of the reference leaf's norm and the median
  leaf's, worst leaf; ``update_grad_dir``: 1 - the cosine between the
  program's and the reference's first gradient, worst leaf. The reference
  steps from the captured parameters and Adam state. ``update_delta`` and
  ``update_grad_dir`` leave out the leaves whose reference gradient is under
  a thousandth of the median leaf's (round-off moves them).

``capture_numbers`` also gives the same numbers for the control (the reference in
the precision below the configuration's: TF32 physics, float8 hidden
matmuls, bfloat16 GAE) and for planted faults that need no program run (the
update on half of each minibatch; a step that leaves the state unchanged;
the kernel leaving a half or a tenth of the envs unchanged), each against
the clean reference, for setting the limits; and the spread of the envs'
ratios.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from port_bench.reference import physics as ref_physics

ULP4 = 4 * 2.0**-23  # the floor of a witness's gap
GRAD_FLOOR = 1e-3  # leaves whose reference gradient is under this share of the median leaf's
TAIL_RATIO = 8.0  # an env whose ratio is over this counts in the tail
SPREAD_RATIOS = (2.0, 4.0, 8.0, 16.0, 64.0)  # tail shares reported for setting TAIL_RATIO
B1 = 0.9


def nets(cell):
    """The nets' reference module the configuration names (``reference.nets``)."""
    return importlib.import_module(f"port_bench.reference.{cell.config['reference']['nets']}")


def to_device(tree, device):
    """Every tensor of ``tree`` (lists and dicts) on ``device``."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, (list, tuple)):
        return [to_device(x, device) for x in tree]
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree


def symmetry_matrix(signed_indices, clock_inds=()) -> torch.Tensor:
    """Signed permutation: row i takes sign(j) x[|j|] (+-0.1 encodes index
    0); clock entries negated (a half-period phase shift)."""
    n = len(signed_indices)
    mat = torch.zeros((n, n))
    for i, idx in enumerate(signed_indices):
        src = 0 if abs(abs(idx) - 0.1) < 1e-6 else int(round(abs(idx)))
        mat[i, src] = 1.0 if idx >= 0 else -1.0
    for c in clock_inds:
        mat[c, :] = 0.0
        mat[c, c] = -1.0
    return mat


def reference_setup(cell, device) -> dict:
    cfg = cell.config
    mir = cfg["mirror"]
    n_act = len(mir["mirrored_acts"])
    return {
        "n_hidden": len(cfg["policy"]["hidden"]),
        "log_std": torch.full((n_act,), math.log(cfg["policy"]["init_std"]), device=device),
        "norm": {"mean": torch.tensor(cfg["obs_norm"]["mean"], dtype=torch.float32, device=device),
                 "std": torch.tensor(cfg["obs_norm"]["std"], dtype=torch.float32, device=device)},
        "obs_mirror": symmetry_matrix(mir["mirrored_obs"], mir["clock_inds"]).to(device),
        "act_mirror": symmetry_matrix(mir["mirrored_acts"]).to(device),
        "ppo": cfg["ppo"],
    }


def _rel_gap(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per env (leading axis): max over entries of |x - r| / (1 + |r|)."""
    x, r = x.double().reshape(x.shape[0], -1), r.double().reshape(r.shape[0], -1)
    return ((x - r).abs() / (1.0 + r.abs())).amax(1).nan_to_num(nan=math.inf)


def _kernel_spec(cell, kind: str) -> dict:
    return {**cell.config["kernels"][kind], "kind": kind}


def _unchanged(rec: dict, every: int) -> dict:
    """The fault "the kernel left these envs unchanged": the program's
    outputs with every ``every``-th sampled env's replaced by its inputs."""
    ins = rec["inputs"]
    before = {"qpos": ins["physics"]["qpos"], "qvel": ins["physics"]["qvel"]}
    if ins.get("motor") is not None:
        before.update(qd_hist=ins["motor"][1]["qdot_hist"], ct_hist=ins["motor"][1]["ctau_hist"])
    out = {}
    for f, x in rec["outputs"].items():
        x = x.clone()
        x[::every] = before[f][::every]
        out[f] = x
    return out


def env_ratios(cell, data: dict, device, variants=("program",)) -> dict:
    """{variant: {launch kind: per-env ratio}}: the outputs of each variant
    ("program"; "control", the TF32 reference; "half_unchanged",
    "tenth_unchanged", the program with those envs left unchanged) against
    the float64 reference, in units of the float32 witness's gap."""
    cfg = cell.config
    motor_seed = cfg["env_config"].get("motor_dynamics", {}).get("seed") if "motor_nets" in cfg else None
    out = {v: {} for v in variants}
    for kind, rec in data["launches"].items():
        spec = _kernel_spec(cell, kind)
        args = (rec["inputs"], spec, cfg["physics"], cfg.get("motor_nets"), motor_seed, cfg["reference"], device)
        r64 = ref_physics.launch(*args, precision="float64")
        w32 = ref_physics.launch(*args, precision="float32")
        fields = ("qpos", "qvel", "ct_hist") if spec["motor"] else ("qpos", "qvel")
        for variant in variants:
            if variant == "control":
                got = ref_physics.launch(*args, precision="tf32")
            elif variant == "half_unchanged":
                got = _unchanged(rec, 2)
            elif variant == "tenth_unchanged":
                got = _unchanged(rec, 10)
            else:
                got = rec["outputs"]
            out[variant][kind] = torch.stack([
                _rel_gap(got[f].to(device), r64[f]) / _rel_gap(w32[f], r64[f]).clamp_min(ULP4) for f in fields]).amax(0)
        del r64, w32
    return out


def physics_numbers(ratios: dict) -> dict:
    """``<kind>_ratio`` (the median env's) and ``<kind>_tail`` per launch."""
    out = {}
    for kind, r in ratios.items():
        out[f"{kind}_ratio"] = float(r.median())
        out[f"{kind}_tail"] = float((r > TAIL_RATIO).double().mean())
    return out


def ratio_spread(ratios: dict) -> dict:
    """Quantiles of the envs' ratios and the tail shares at SPREAD_RATIOS."""
    out = {}
    for kind, r in ratios.items():
        r = r.double().cpu()
        q = torch.quantile(r.nan_to_num(posinf=1e300), torch.tensor([0.5, 0.9, 0.99, 0.999, 1.0], dtype=torch.float64))
        out[kind] = {"q50_90_99_999_max": [float(x) for x in q],
                     "share_over": {str(k): float((r > k).double().mean()) for k in SPREAD_RATIOS}}
    return out


def _leaf_norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def _worst_leaf(prog: dict, refn: dict, keep=None) -> float:
    keys = [k for k in refn if keep is None or k in keep]
    med = float(np.median([refn[k] for k in keys]))
    return max(abs(prog[k] - refn[k]) / max(refn[k], med) for k in keys)


def _worst_direction(prog: dict, refl: dict, keep) -> float:
    worst = 0.0
    for k in keep:
        a, b = prog[k].double().flatten(), refl[k].double().flatten()
        cos = float(a @ b) / max(float(torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)), 1e-300)
        worst = max(worst, 1.0 - cos)
    return worst


def _flat_leaves(nets: dict) -> dict:
    return {f"{net}.{k}": v for net, leaves in nets.items() for k, v in leaves.items()}


def _start(data: dict, device) -> tuple[dict, dict]:
    """The captured iteration's parameters and Adam states, on ``device``."""
    st = data["state"]
    to = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
    params = {net: to(st[net]["params"]) for net in ("actor", "critic")}
    adam = {net: {"mu": to(st[net]["mu"]), "nu": to(st[net]["nu"]), "count": float(st[net]["count"])}
            for net in ("actor", "critic")}
    return params, adam


def update_numbers(cell, data: dict, device, precision: str = "float32", half_batch: bool = False,
                   as_program: bool = True) -> dict:
    """update_loss, update_grad, update_grad_dir, update_delta of the
    program (``as_program``) or of the reference run at ``precision`` / with
    ``half_batch``, each against the float32 reference."""
    setup, ref = reference_setup(cell, device), nets(cell)
    w0, adam = _start(data, device)
    mbs = [tuple(to_device(s["mb"], device)) for s in data["steps"]]
    clean = ref.run_steps(w0["actor"], w0["critic"], mbs, setup, "float32", adam=adam)
    ppo = cell.config["ppo"]
    if as_program:
        losses = []
        for s in data["steps"]:
            t = {k: float(v) for k, v in s["terms"].items()}
            losses.append(t["actor_loss"] + t["critic_loss"] - ppo["entropy_coeff"] * t.get("entropy", 0.0)
                          + ppo["mirror_coeff"] * t.get("mirror_loss", 0.0))
        mu0 = _flat_leaves({net: adam[net]["mu"] for net in adam})
        first = {k: (v.to(device) - B1 * mu0[k]) / (1 - B1)
                 for k, v in _flat_leaves(data["steps"][0]["first_moments"]).items()}
        last = _flat_leaves(data["steps"][-1]["params"])
    else:
        other = ref.run_steps(w0["actor"], w0["critic"], mbs, setup, precision, half_batch, adam=adam)
        losses, first, last = other["losses"], other["first_grad"], other["params"]
    flat0 = _flat_leaves(w0)
    g_ref = _leaf_norms(clean["first_grad"])
    med = float(np.median(list(g_ref.values())))
    keep = {k for k, g in g_ref.items() if g >= GRAD_FLOOR * med}
    d_ref = _leaf_norms({k: clean["params"][k] - flat0[k] for k in clean["params"]})
    d_prog = _leaf_norms({k: last[k].to(device) - flat0[k] for k in clean["params"]})
    return {
        "update_loss": max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses, clean["losses"])),
        "update_grad": _worst_leaf(_leaf_norms(first), g_ref),
        "update_grad_dir": _worst_direction(first, clean["first_grad"], keep),
        "update_delta": _worst_leaf(d_prog, d_ref, keep),
    }


def rollout_numbers(cell, data: dict, device, control: bool = False) -> dict:
    """rollout_logp, rollout_value, gae_adv, gae_return of the program (or
    the control: float8 nets, bfloat16 GAE) against the reference."""
    setup, ref = reference_setup(cell, device), nets(cell)
    w0, _ = _start(data, device)
    ro = to_device(data["rollout"], device)
    logp_r, value_r = ref.rollout_outputs(w0["actor"], w0["critic"], ro, setup, "float32")
    if control:
        logp_p, value_p = ref.rollout_outputs(w0["actor"], w0["critic"], ro, setup, "fp8")
    else:
        logp_p, value_p = ro["log_prob"], ro["value_sampled"]
    ppo = cell.config["ppo"]

    def gae(dtype):
        args = [ro[k].to(dtype) for k in ("reward", "value", "next_value", "terminated", "done")]
        adv, ret = ref.gae(*args, ppo["gamma"], ppo["lam"])
        adv, ret = adv.float(), ret.float()
        mean = adv.mean()
        return (adv - mean) / (torch.sqrt(torch.square(adv - mean).mean()) + 1e-5), ret

    adv_r, ret_r = gae(torch.float32)
    if control:
        adv_p, ret_p = gae(torch.bfloat16)
    else:
        adv_p, ret_p = data["batch"]["advantages"].to(device), data["batch"]["returns"].to(device)
    rms = lambda x: float(torch.sqrt(torch.square(x.double()).mean()))  # noqa: E731
    return {
        "rollout_logp": float((logp_p - logp_r).abs().max()),
        "rollout_value": float((value_p - value_r).abs().max()) / max(rms(value_r), 1e-12),
        "gae_adv": float((adv_p - adv_r).abs().max()),
        "gae_return": float((ret_p - ret_r).abs().max()) / max(rms(ret_r), 1e-12),
    }


def _matmul_precision():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return prev


def capture_numbers(cell, data: dict, device, control: bool = True, faults: bool = True) -> dict:
    """Every number of one capture for the program and (for setting limits)
    the control and the faults: {"program", "control", "faults", "spread"}."""
    prev = _matmul_precision()
    try:
        variants = ("program",) + (("control",) if control else ()) + (
            ("half_unchanged", "tenth_unchanged") if faults else ())
        ratios = env_ratios(cell, data, device, variants)
        out = {"program": {**physics_numbers(ratios["program"]), **rollout_numbers(cell, data, device),
                           **update_numbers(cell, data, device)}}
        if control:
            out["control"] = {**physics_numbers(ratios["control"]), **rollout_numbers(cell, data, device, control=True),
                              **update_numbers(cell, data, device, precision="fp8", as_program=False)}
            out["spread"] = {"program": ratio_spread(ratios["program"]), "control": ratio_spread(ratios["control"])}
        if faults:
            out["faults"] = {
                "half_batch": update_numbers(cell, data, device, half_batch=True, as_program=False),
                "unchanged_state": {"update_delta": 1.0},
                **{name: physics_numbers(ratios[name]) for name in ("half_unchanged", "tenth_unchanged")},
            }
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def judge(cell, captures: list, device) -> dict:
    """{number: {"value", "limit"}}: each number of the configuration's
    ``check.limits`` the largest over the ``captures`` (settled records,
    set-up's first; a capture whose iteration never ran, or ran short,
    fails every number), and each of ``check.start_limits`` the set-up
    capture's alone."""
    wanted = cell.traffic["check"]["update_steps"]
    got = [capture_numbers(cell, data, device, control=False, faults=False)["program"]
           if data is not None and len(data["steps"]) == wanted else None for data in captures]
    chk = cell.config["check"]
    out = {}
    for name, limit in chk["limits"].items():
        values = [math.inf if g is None else g[name] for g in got]
        out[name] = {"value": max(values), "limit": limit}
    for name, limit in chk.get("start_limits", {}).items():
        out[name] = {"value": math.inf if got[0] is None else got[0][name], "limit": limit}
    for c in out.values():
        c["value"] = c["value"] if math.isfinite(c["value"]) else 1e300
    return out
