"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing one line with the seconds elapsed:

1. device: the card's name and power limit (nvidia-smi);
2. build: kernel K1 (learninghumanoidwalking_tpu_torch/ops/csrc/control_step.cu)
   built with nvcc into a ctypes-loaded library;
3. K1 against its plain PyTorch version (physics/batched.py) on the card,
   on seeded states after a reset: the step launch (25 substeps, R=5) and
   the settle launch (3 zero-gain substeps, R=1), at B=4096 and at the
   training batch size. Every output the env reads is held to the plain
   version env by env, measured from a float64 run of the plain version
   (see compare_fields), and both launches are held to bench.py's two-part
   cross-compiler gate (part 2, 20 settled steps, at B=4096 and for the
   step launch only: it measures PD statics). Both launches are timed;
4. the slice: 3 PPO iterations on jvrc_walk at bench.py's workload (32768
   envs, rollout 16, minibatch 32768) through make_env -> PPO -> train, with
   the K1 launch count checked against the rollout and every loss finite;
5. the kernel table.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. The second-to-last line is the kernels JSON,
the last line the device JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

T0 = time.time()


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f} s] {msg}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 2

    import numpy as np

    from learninghumanoidwalking_tpu_torch.envs.registry import make_env
    from learninghumanoidwalking_tpu_torch.ops import substep_kernel as sk
    from learninghumanoidwalking_tpu_torch.physics import batched
    from learninghumanoidwalking_tpu_torch.physics import engine as eng
    from learninghumanoidwalking_tpu_torch.physics.model import tree_map
    from learninghumanoidwalking_tpu_torch.rl.ppo import PPO, PPOConfig
    from learninghumanoidwalking_tpu_torch.utils.seeding import Draws

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 1: device -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {torch.cuda.device_count()} device(s)")
    print(smi, flush=True)

    # ---- phase 2: build --------------------------------------------------
    build_s, lib_path = sk.build_seconds_and_path()
    log(f"phase 2 build: nvcc {build_s:.1f} s -> {lib_path}")

    # ---- phase 3: K1 against its plain version ---------------------------
    env = make_env("jvrc_walk", device=dev)
    model = env.model
    reuse = env.physics_reuse
    F32_PEAK, HBM_BPS = 67e12, 3.35e12  # H100 SXM: f32 non-tensor FLOP/s, HBM bytes/s

    def seeded_reset(batch: int, seed: int):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        draws = Draws(gen)
        physics, dyn, _ = env._reset_pre(draws, batch, None)
        return env.reset_batch(batch, draws), physics, dyn

    def total_grf(out):
        return torch.sum(torch.linalg.vector_norm(out.contact.force, dim=-1) * out.contact.mask, dim=1)

    def part1(out_k, out_p):
        q_err = float((out_k.qpos - out_p.qpos).abs().max())
        rel = (total_grf(out_k) - total_grf(out_p)).abs() / (total_grf(out_p).abs() + 50.0)
        return q_err, float(torch.quantile(rel, 0.95))

    def time_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    # Every output of a launch that the env reads (obs, rewards, done), and
    # the contact rows. Each is held to the plain version env by env: the
    # kernel's distance from the plain version run in float64 may not exceed
    # RTOL (1 + |x64|) plus SENS times the float32 plain version's own distance
    # from it (max over the env's elements of the field). The first term is
    # a max-abs limit of 1e-4 on O(1) fields, relative on torques, velocities,
    # accelerations and forces, whose f32 rounding scales with their size;
    # the second admits an env only as far as the state itself amplifies f32
    # rounding (a contact on its friction-cone boundary, a stiff contact
    # acceleration), which a kernel fault (a wrong row, a stale value) does
    # not. A slot's mask may differ only where its float64 distance lies
    # within RTOL of the contact margin.
    fields = {
        "qpos": lambda s: s.qpos, "qvel": lambda s: s.qvel, "qacc": lambda s: s.qacc,
        "act_torque": lambda s: s.act_torque, "xpos": lambda s: s.xpos, "xquat": lambda s: s.xquat,
        "cvel": lambda s: s.cvel, "cpos": lambda s: s.contact.pos, "cdist": lambda s: s.contact.dist,
        "cforce": lambda s: s.contact.force, "cmask": lambda s: s.contact.mask,
    }
    abs_fields = ("qpos", "xpos", "xquat", "act_torque", "cpos", "cdist", "cmask")  # max_abs_err reports these
    RTOL, SENS = 1e-4, 10.0
    mu = torch.as_tensor(model.np("geom_friction")[eng.slot_geoms(model)], dtype=torch.float64, device=dev)

    def plain_f64(args, **kw):
        to64 = lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x
        prev = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            return batched.pd_substeps_batched(*[tree_map(to64, a) for a in args], **kw)
        finally:
            torch.set_default_dtype(prev)

    def compare_fields(out_k, out_p, out_64):
        res = {}
        for name, get in fields.items():
            k, p, x = (get(o).reshape(o.qpos.shape[0], -1).double() for o in (out_k, out_p, out_64))
            e_k, e_p = (k - x).abs(), (p - x).abs().amax(1, keepdim=True)
            tight = RTOL * (1.0 + x.abs().amax(1, keepdim=True))
            limit = tight + SENS * e_p
            if name == "cmask":
                near_margin = (out_64.contact.dist - eng.CONTACT_MARGIN).abs() <= RTOL
                limit = torch.where(near_margin, torch.inf, limit)
            ok = e_k <= limit
            res[name] = dict(
                max_abs_err=float((k - p).abs().max()),
                max_abs_err_vs_f64=float(e_k.max()),
                envs_failing=int((~ok.all(1)).sum()),
                envs_past_rtol=int((e_k > tight).any(1).sum()),
                worst_share_of_limit=float((e_k / limit).max()),  # < 1 passes
            )
        return res

    def worst_env(out_k, out_p, out_64):
        """The env of the largest qpos error, with what can explain it."""
        err = (out_k.qpos - out_p.qpos).abs().amax(1)
        i = int(torch.argmax(err))

        def cone_margin(o):  # 1 - |f_t| / (mu f_n) per active slot at the last substep; 0 = on the cone
            f = o.contact.force[i].double()
            m = 1.0 - torch.linalg.vector_norm(f[:, 1:], dim=-1) / (mu * f[:, 0]).clamp_min(1e-9)
            return [round(float(v), 6) if float(a) > 0 else None for v, a in zip(m, o.contact.mask[i])]

        return dict(
            env=i, qpos_err=float(err[i]),
            kernel_vs_f64=float((out_k.qpos[i].double() - out_64.qpos[i]).abs().max()),
            plain_vs_f64=float((out_p.qpos[i].double() - out_64.qpos[i]).abs().max()),
            mask_kernel=out_k.contact.mask[i].tolist(), mask_plain=out_p.contact.mask[i].tolist(),
            cone_margin_kernel=cone_margin(out_k), cone_margin_plain=cone_margin(out_p),
        )

    def check_launches(batch: int, seed: int, full_gate: bool, reps_kernel: int, reps_plain: int):
        states, pre_physics, pre_dyn = seeded_reset(batch, seed)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        target = env.neutral_pose + 0.05 * torch.randn((batch, model.nu), generator=gen, device=dev)
        zeros = torch.zeros((batch, model.nu), device=dev)
        launches = {
            "step": ((model, states.dyn, states.physics, target, env.frame_skip, env.sim_dt), dict(reuse_interval=reuse)),
            "settle": ((model, pre_dyn, pre_physics, zeros, 3, env.sim_dt), dict(settle=True)),
        }
        res, ok = {}, True
        for name, (args, kw) in launches.items():
            out_k = sk.pd_substeps_kernel(*args, **kw)
            torch.cuda.synchronize()
            out_p = batched.pd_substeps_batched(*args, **kw)
            torch.cuda.synchronize()
            out_64 = plain_f64(args, **kw)
            torch.cuda.synchronize()
            q_err, grf_p95 = part1(out_k, out_p)
            cmp = compare_fields(out_k, out_p, out_64)
            res[name] = dict(qpos_maxerr=q_err, grf_relerr_p95=grf_p95, fields=cmp, worst_env=worst_env(out_k, out_p, out_64))
            ok = (
                ok and bool(torch.isfinite(out_k.qpos).all()) and q_err < 5e-3 and grf_p95 < 0.04
                and all(c["envs_failing"] == 0 for c in cmp.values())
            )
            if name == "step" and full_gate:
                s_k, s_p = out_k, out_p
                for _ in range(20):
                    s_k = sk.pd_substeps_kernel(model, states.dyn, s_k, env.neutral_pose.expand(batch, -1), env.frame_skip, env.sim_dt, reuse_interval=reuse)
                    torch.cuda.synchronize()
                    s_p = batched.pd_substeps_batched(model, states.dyn, s_p, env.neutral_pose.expand(batch, -1), env.frame_skip, env.sim_dt, reuse_interval=reuse)
                    torch.cuda.synchronize()
                dz = float((s_k.qpos[:, 2] - s_p.qpos[:, 2]).abs().max())
                sq_err = float((s_k.qpos - s_p.qpos).abs().max())
                fn_k = torch.sum(s_k.contact.force[..., 0] * s_k.contact.mask, dim=1)
                fn_p = torch.sum(s_p.contact.force[..., 0] * s_p.contact.mask, dim=1)
                fn_rel = float(((fn_k - fn_p).abs() / (fn_p.abs() + 1.0)).max())
                weight = float(np.sum(model.np("body_mass")) * 9.81)
                vs_weight = abs(float(fn_k.mean()) - weight) / weight
                res[name].update(settled_dz=dz, settled_qpos_maxerr=sq_err, settled_grf_relerr=fn_rel, grf_vs_weight=vs_weight)
                ok = ok and dz < 2e-3 and sq_err < 8e-3 and fn_rel < 0.02 and vs_weight < 0.03
        # times (CUDA events; the plain version repeats the kernel's arithmetic in torch ops)
        for name, (args, kw) in launches.items():
            res[name]["ms"] = time_ms(lambda: sk.pd_substeps_kernel(*args, **kw), reps_kernel)
            res[name]["plain_ms"] = time_ms(lambda: batched.pd_substeps_batched(*args, **kw), reps_plain)
        for name, fs, r in (("step", env.frame_skip, reuse), ("settle", 3, 1)):
            flops = sk.flops_per_env_substep(model, r) * fs * batch
            nbytes = sk.bytes_per_launch(model, batch)
            res[name].update(flops=flops, bytes=nbytes, bound_ms=1e3 * max(flops / F32_PEAK, nbytes / HBM_BPS),
                             bound_by="operations" if flops / F32_PEAK >= nbytes / HBM_BPS else "bytes")
        res["max_abs_err"] = max(res[n]["fields"][f]["max_abs_err"] for n in launches for f in abs_fields)
        return ok, res

    sk.counter.reset()  # the comparisons' launches are not the main path's
    ok4k, res4k = check_launches(4096, seed=0, full_gate=True, reps_kernel=10, reps_plain=2)
    log(f"phase 3 K1 vs plain, B=4096: {'PASS' if ok4k else 'FAIL'} {json.dumps(res4k)}")
    if not ok4k:
        raise RuntimeError("K1 disagrees with its plain version at B=4096")

    # ---- phase 4: the slice ----------------------------------------------
    n_itr, num_envs, rollout = 3, 32768, 16
    okb, resb = check_launches(num_envs, seed=10, full_gate=False, reps_kernel=5, reps_plain=1)
    log(f"phase 3 K1 vs plain, B={num_envs}: {'PASS' if okb else 'FAIL'} {json.dumps(resb)}")
    if not okb:
        raise RuntimeError(f"K1 disagrees with its plain version at B={num_envs}")

    cfg = PPOConfig(num_envs=num_envs, rollout_len=rollout, minibatch_size=32768, seed=0, net_dtype="bfloat16")
    trainer = PPO(env, cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()

    def on_iteration(itr, m):
        log(
            f"phase 4 itr {itr}: sampling {m['sample_env_steps_per_s']:,.0f} env-steps/s "
            f"({m['sample_time']:.2f} s) | optimize {m['optimize_time']:.2f} s | mean reward {m['mean_reward']:.4f} | "
            f"actor {m['actor_loss']:.4f} critic {m['critic_loss']:.4f} mirror {m['mirror_loss']:.5f} | "
            f"K1 launches so far {sk.counter.launches}"
        )

    sk.counter.reset()
    ts0 = trainer.init_state()  # initial reset_batch: one settle launch
    init_launches = sk.counter.launches
    sk.counter.reset()
    ts, history = trainer.train(n_itr, ts=ts0, verbose=False, on_iteration=on_iteration)
    torch.cuda.synchronize()
    launches = sk.counter.launches
    expected = (trainer.warmup_iterations() + n_itr) * (rollout + 1)
    losses = [m[k] for m in history for k in ("actor_loss", "critic_loss", "mirror_loss", "approx_kl")]
    obs = ts.env_state.obs
    ok_slice = (
        init_launches == 1
        and launches == expected
        and all(np.isfinite(losses))
        and tuple(obs.shape) == (num_envs, env.obs_size)
        and bool(torch.isfinite(obs).all())
    )
    log(
        f"phase 4 slice: {'PASS' if ok_slice else 'FAIL'} | K1 launches: init_state {init_launches} (expected 1), "
        f"train {launches} (expected ({trainer.warmup_iterations()} warmup + {n_itr} iterations) x "
        f"({rollout} steps + 1 reset-pool settle) = {expected}) | "
        f"losses finite {all(np.isfinite(losses))} | peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    if not ok_slice:
        raise RuntimeError("the slice failed its checks")

    # ---- phase 5: kernels --------------------------------------------------
    step = resb["step"]
    kernels = [
        {
            "name": "K1 control_step (flat floor)",
            "route": "cuda",
            "source": "learninghumanoidwalking_tpu_torch/ops/csrc/control_step.cu",
            "replaces": "learninghumanoidwalking_tpu/ops/substep_kernel.py:1296",
            "launches": launches,
            "max_abs_err": max(res4k["max_abs_err"], resb["max_abs_err"]),
            "ms": step["ms"],
            "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"],
            "bound_by": step["bound_by"],
            "library_ms": None,
        }
    ]
    log("phase 5 kernels: [K1]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
