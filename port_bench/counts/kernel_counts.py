"""Operations and bytes of one control-step kernel launch, for the roofline bound.

Frozen copy of ``flops_per_env_substep``, ``motor_flops_per_net`` and
``bytes_per_launch`` of learninghumanoidwalking_tpu_torch/ops/substep_kernel.py
at commit 9e7f4a040c02fdfd29cfe1055f8fc2257b06e82f, with two changes: the
operations are split by precision, and the contact slots' kinds and the
floor's bytes come from the floor's module (port_bench/reference/floors/).
The kernels (ops/csrc/control_step_lanes.cu at that commit) run the
contact Gram of the foot basis and its Cholesky factor, D^-1, K = I + Chat^T
D^-1 Chat and its factor, and the Woodbury sweeps of the projected
refinement (A^-1 r and the residual b - A f) in float64; everything else in
float32. The yardstick reads only the shapes of
the benchmark's own model (port_bench/reference), so it does not follow later
changes of the program.

An FMA counts 2, a divide or square root 4, a sine or cosine 8. The contact
solve is counted in the Woodbury form, the least work of the step.
"""

from __future__ import annotations

import numpy as np

from port_bench.reference import engine as eng
from port_bench.reference.engine import _tables

# projected refinement passes of the contact solve (physics/batched.py's
# PROJ_REFINE_ITERS at the commit above)
PROJ_REFINE_ITERS = 4
HIST_LEN = 25


def motor_dims(params: dict) -> list[int]:
    n_layers = int(params["n_layers"])
    return [int(params["w0"].shape[1])] + [int(params[f"w{li}"].shape[2]) for li in range(n_layers)]


def motor_flops_per_net(params: dict) -> float:
    """Float32 operations of one env-substep's motor nets (all joints) once
    the history is warm: per joint and layer d_in x d_out FMAs and d_out
    bias adds, a tanh (8) per hidden unit, and the skip term."""
    dims, nu = motor_dims(params), int(params["skip"].shape[0])
    fma = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return float(nu * (2 * fma + sum(dims[1:]) + 8 * sum(dims[1:-1]) + 2))


def ops_per_env_substep(model, floor, reuse: int) -> dict:
    """{"f32": ..., "f64": ...}: operations one env-substep needs on
    ``floor`` (a module of reference/floors), the refresh work amortized
    over the reuse group R, without the motor nets (motor_flops_per_net adds
    them where they run)."""
    nb, nv, nu, nc = model.nbody, model.nv, model.nu, model.ncon
    anc = _tables(model)["anc"] > 0.5
    npairs = sum(1 for d in range(nv) for e in range(d + 1) if anc[model.dof_body[d], e])
    feet = list(dict.fromkeys(model.geom_body[g] for g in model.foot_geoms))
    nk, n3 = 6 * len(feet), 3 * nc

    def chol(n):  # Cholesky: (n^3 - n)/6 FMAs, n sqrt, n(n-1)/2 divides
        return (n**3 - n) / 3 + 4 * n + 2 * n * (n - 1)

    def fwd(n):  # one triangular solve
        return n * (n - 1) + 4 * n

    f32 = f64 = 0.0
    # common body: PD torque, FK, motion subspace, body velocities, world
    # inertias with mass/CoM randomization, RNE bias and applied wrenches
    f32 += nu * 12
    f32 += nb * (2 * 30 + 28 + 16 + 60 + 12 + 4 * 4 + 30) + nv * (40 + 12)
    f32 += nb * (54 + 54 + 18 + 27 + 8) + nb * (36 + 2 * 36 + 24 + 12) + nv * (12 + 2 + 8 + 4)
    # refresh: CRBA + armature + damping, Cholesky, Y = L^-1 B (float32);
    # the Gram of Y and its Cholesky (float64)
    r = max(reuse, 1)
    f32 += (nb * 13 + nv * 36 + npairs * 12 + 2 * nv + chol(nv) + nk * fwd(nv)) / r
    f64 += (nk * (nk + 1) / 2 * 2 * nv + chol(nk)) / r
    f32 += 2 * fwd(nv)  # smooth qacc
    kinds = floor.slot_kinds(model)
    row_keys = []
    slot_foot = [feet.index(model.geom_body[g]) for g in eng.slot_geoms(model)]
    for c in range(nc):
        base = 6 * slot_foot[c]
        if kinds[c] in ("flat", "floor"):
            row_keys += [[base + 5, base + 1, base], [base + 3, base + 2, base + 1], [base + 4, base, base + 2]]
        else:
            row_keys += [list(range(base, base + 6))] * 3
    terms = np.array([[sum(rk >= k for rk in keys) for k in range(nk)] for keys in row_keys])
    nz = terms > 0
    nnz = int(nz.sum())
    f32 += nc * (38 + 10) + 2 * nk * (2 * nv - 1) + n3 * 47  # corners, u_vel/u_acc, aref, R, b, D
    f32 += int(2 * terms.sum())  # Chat
    f64 += 4 * n3  # D^-1
    f64 += nnz + 2 * sum(int((nz[:, a] & nz[:, b]).sum()) for a in range(nk) for b in range(a, nk)) + nk
    f64 += chol(nk)  # K and its Cholesky
    iters = PROJ_REFINE_ITERS
    apply_ainv = 4 * nnz + 3 * n3 + 2 * fwd(nk)
    apply_a = 4 * nnz + n3
    f64 += iters * apply_ainv + (iters - 1) * (apply_a + 2 * n3)
    f32 += iters * nc * 20  # the friction-cone projection
    f32 += 6 * n3 + nk * 2 * nv + 2 * fwd(nv) + nv  # J^T f through the basis, constraint qacc
    f32 += nv * 4 + 60  # semi-implicit Euler, quaternion integration
    return {"f32": float(f32), "f64": float(f64)}


def bytes_per_launch(model, floor, batch: int, motor: dict | None = None) -> int:
    """Bytes one launch must move on ``floor``: each input read once, each
    output written once, and what the floor adds; with the motor-net params
    ``motor`` the two histories and the count in and out per env, and the
    weights once."""
    nb, nv, nq, nu, nc = model.nbody, model.nv, model.nq, model.nu, model.ncon
    rows_in = nq + nv + 4 * nu + 2 * nv + nb + 3 * nb + 6 * nb
    rows_out = nq + 2 * nv + nu + 3 * nc + 2 * nc + 6 * nc + 3 * nb + 4 * nb + 6 * nb
    motor_bytes = 0
    if motor is not None:
        weights = sum(int(motor[f"{k}{li}"].numel()) for li in range(int(motor["n_layers"])) for k in ("w", "b"))
        motor_bytes = 4 * batch * 2 * (2 * nu * HIST_LEN + 1) + 4 * (weights + nu)
    return 4 * batch * (rows_in + rows_out) + motor_bytes + floor.extra_bytes(model, batch)


def launch_work(model, floor, batch: int, substeps: int, reuse: int, motor: dict | None = None,
                net_env_substeps: float = 0.0) -> dict:
    """One launch's work: f32 and f64 operations and bytes, for ``batch``
    envs of ``substeps`` substeps at reuse R, plus the motor nets in
    ``net_env_substeps`` env-substeps (those past the history's warm-up)."""
    per = ops_per_env_substep(model, floor, reuse)
    f32 = per["f32"] * batch * substeps
    if motor is not None:
        f32 += motor_flops_per_net(motor) * net_env_substeps
    return {"f32": f32, "f64": per["f64"] * batch * substeps, "bytes": float(bytes_per_launch(model, floor, batch, motor))}


def least_seconds(work: dict, peaks: dict) -> float:
    """The roofline bound of one launch: the larger of its operations at the
    non-tensor float32 and float64 peaks and its bytes at the memory peak."""
    ops = work["f32"] / peaks["f32_flops"] + work["f64"] / peaks["f64_flops"]
    return max(ops, work["bytes"] / peaks["hbm_bytes_per_s"])
