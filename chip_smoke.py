"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing one line with the seconds elapsed since the start and
the phase's own seconds:

1. device: the card's name and power limit (nvidia-smi);
2. build: the four kernel libraries of learninghumanoidwalking_tpu_torch/
   ops/csrc/control_step_lanes.cu (a group of lanes per env, its working set
   in shared memory, the Woodbury contact solve), built at once with nvcc
   into ctypes-loaded libraries: the flat build (K1, flat floor, the
   factorization reused over R substeps), the terrain build that K2 (terrain
   boxes) and K3 (heightfield) share, the motor build (K4: the flat
   floor at R=1 plus the learned motor hook) and the terrain + motor build
   that K5 (terrain boxes) and K6 (heightfield) share, each with the motor
   hook; ptxas's registers, stack frame and spill bytes of every library;
3. each kernel against its plain PyTorch version (physics/batched.py) on the
   card, on seeded states and terrain after an env reset: K1 on jvrc_walk,
   K2 on jvrc_step (20 stepping-stone boxes), K3 on jvrc_walk_rough (16x16
   heightfield). The step launch (25 substeps; R=5 for K1, R=1 for K2/K3)
   and the settle launch (3 zero-gain substeps, R=1), at B=4096 and at the
   training batch size. Every output the env reads, contact normals and
   frames included, is held to the plain version env by env, measured from
   a float64 run of the plain version (see compare_fields): every env of K1
   must pass; K2 and K3 may admit a few chaotic envs, each with a second
   witness and a substep-by-substep replay (see admit_chaotic). Both
   launches go to bench.py's two-part cross-compiler gate (part 2, 20 settled
   steps, at B=4096 and for the step launch only: it measures PD statics).
   K2 must show active box-slot contacts and K3 active heightfield contacts
   with tilted normals in every launch. Both launches are timed.
   K4 on jvrc_walk with the motor config (envs/configs/jvrc_motor.json):
   the step launch (R=1) from the state of two plain control steps after a
   seeded reset, with the motor counts set per env to 0, 10, 24, 25, 26,
   27, 50, 1001 in turn (warmup, warmup ending inside the launch, both push
   parities, a large count), so that the net runs in most env-substeps.
   The same rule holds the env outputs and the motor histories (a few
   chaotic envs admitted as for K3), and the counts must be equal; the
   gate as above; timed, with the layout transposes of the motor
   histories timed apart. Then once more with seeded nets of std 0.3, whose
   MLP term is O(10%) of the torque (the config's nets leave it near 1e-4),
   held by the same rule, without the gate.
   K5 on jvrc_step and K6 on jvrc_walk_rough, both with the motor config:
   at B=4096 as K4 (the same counts, both sets of nets, rule, admission
   and gate, the states two plain control steps on the env's terrain after
   a reset); at B=32768 with the config's nets, part 1 of the gate alone
   (an env whose kernel and plain qpos part by 5e-3 or more passes only
   where the plain version is the one that left float64), the rule's
   counts reported, and timed. Each launch must show active terrain
   contacts as K2's and K3's. The float64 references run on the card (TF32
   off); the seconds phase 3 spends on each kind of reference are printed
   at its end. The plain version is timed on one run of inputs it has
   just run. A failing launch's inputs (the refused envs and the env of
   the largest qpos error) go to <LHW_SMOKE_OUT>/failing_*.pt.
   K1 on Unitree H1 (h1, envs/configs/h1_base.json: a second robot's model
   tables): the step launch (R=5) and the settle with the config's dynamics
   randomization and perturbation wrenches drawn into the state (xfrc
   non-zero in at least half of the envs), at B=4096 and 32768, and for the
   evaluation replay's small batches B=1 and 3; the same at B=4096 with
   every joint's frictionloss at 0; once more at B=4096 with the model's
   default dynamics and no wrench (randomization off). The same rule. With
   the config's frictionloss, whose explicit tanh(v / 0.02) term makes
   some envs chaotic, an env may be admitted (admit_chaotic) only with its
   second witness and replay, both with velocity-scale samples (vel_ulp),
   each such env listed, at most twice as many as the plain version fails
   the rule against the kernel (see check_launches); without the
   frictionloss or the randomization, as for K2 and K3. Part 1 of the gate
   on every launch. Part 2 on the launch with randomization off, held to
   float64 (H1 does not come to rest under its PD gains, so bench.py's
   statics limits, reported, do not apply): each of its 20 steps is
   launched from the plain version's float64 trajectory and held by the
   same rule, env by env, a bistable env admitted only where float32 runs
   of the plain version from one-ulp moves of its input land as the
   kernel does (settle_vs_f64). Then K1 launched on jvrc_walk,
   H1 and jvrc_walk again: the two jvrc_walk outputs equal bit for bit
   (each launch reads its own model tables);
4. the training paths: PPO on jvrc_walk (3 iterations), jvrc_step,
   jvrc_walk_rough and jvrc_walk with the motor config (2 each) at
   bench.py's workload (32768 envs, rollout 16, minibatch 32768) through
   make_env -> PPO -> train, with the launches of every kernel counted over
   each path (1 initial reset, then 16 steps + 1 reset-pool settle per
   iteration, all in the path's own kernel; on the motor path the steps in
   K4 and the settles in K1; evaluations off) and every loss finite. Then the H1 paths through the port's command line
   (learninghumanoidwalking_tpu_torch/run_experiment.py, called in this
   process): h1 at the same workload for 2 iterations with an evaluation
   (100 steps) at each and its checkpoints; --continued on that run for 1
   iteration (the restored state equal to the saved one bit for bit);
   eval --path for 2 episodes into an .npz; h1_walk for 2 iterations, then
   --imitate of that run for 1 iteration (a finite imitation loss > 0);
   every launch in K1 and counted exactly. jvrc_step and jvrc_walk_rough
   with --json jvrc_motor.json through the command line, 2 iterations with
   evaluations of 20 steps: steps in K5 / K6, settles in K2 / K3, counted
   exactly, the motor nets warm in most envs at the end. The mjcf: env:
   JVRC-1 written by the port's export_mjcf into the output directory with
   a robot file of jvrc_walk's gains, pose, feet and mirror lists; its
   model tables equal jvrc_walk's bit for bit and one K1 launch on each
   model from one state gives equal outputs; train --env mjcf:<xml> --json
   <robot.json> (5 observation-norm warmup iterations, then 2; the norm's
   count as the warmup leaves it, mirror losses > 0), eval --path (2
   episodes), every launch in K1 and counted exactly. The rangefinder on
   jvrc_step states (B=4096, 4x4 rays) against the same function on the
   CPU (1e-5 m), with rays ending on boxes. Recurrent PPO (LSTM 2x256
   actor and critic, float32) through the same command line: jvrc_walk
   --recurrent at the same workload (16 sequence minibatches of 2048 envs,
   3 epochs) for 2 iterations with an evaluation at each and its
   checkpoints, every launch in K1 and counted exactly, finite losses, and
   after the last rollout the carry rows exactly zero for the envs that
   finished at its last step (the trajectory's done mask) and non-zero for
   every other env; --continued for 1 iteration (the restored state equal
   to the saved one bit for bit, the carries its first rollout starts from
   zero); eval --path for 2 episodes. The LSTM actor and critic on the
   card against the CPU (16 steps of 2048 envs with resets, float32, TF32
   off, 1e-5 relative). Cartpole through the command line, feed-forward
   and --recurrent, at 4096 envs and rollout 16 (5 observation-norm warmup
   iterations, then 2): no kernel launch, the norm's count as the warmup
   leaves it, finite losses; one cartpole control step of engine_step_b
   (4 substeps) on the card held to a float64 run of the same function on
   the CPU (1e-5). Then h1 with --profile-dir for 3
   iterations: the 5 CUDA kernels with the most device time in the trace
   and the device's idle share over the traced iteration. Then eval's task
   markers: eval --path --out .gif (2 episodes of at most 20 steps) on the
   jvrc_step and jvrc_walk_rough runs with the motor config (steps in K5 /
   K6, the reset in K2 / K3) and on the h1_walk run (K1), each launch
   counted: one marker dict per frame of episode 0 with the env kind's
   keys, jvrc_step's targets rows of the shown plan and its boxes the env's
   terrain row of env 0, jvrc_walk_rough's 16x16 field. The card machine
   has no matplotlib or imageio, so the drawing call is replaced by a
   recorder there and no .gif is written. The live viewer's stepper
   (rl/viewer.py PolicyStepper, ViewerLoop with a fake window): episode 0
   of the h1_walk run at B=1 through K1, its qpos held step by step to
   eval's episode 0 at B=2 (bit for bit, else 1e-4). Data parallel: one
   PPO iteration of jvrc_walk at the workload on one NCCL rank
   (parallel/mesh.py) against the plain trainer from the same seed:
   parameters, Adam moments, norm and metrics bit for bit, else 1e-6
   relative; the NCCL all-reduce's share of the optimize time (one GPU:
   more ranks are checked by the CPU tests only);
5. the kernel table (K1-K6).

It exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. The second-to-last line is the kernels JSON,
the last line the device JSON. Every phase 3 and phase 4 result, in full,
goes to <LHW_SMOKE_OUT, default smoke_out>/chip_smoke_results.json as well
(the log lines of phase 3 are long; a caller may see only the end of the
output).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

T0 = time.time()
_LAST = [T0]


def log(msg: str) -> None:
    now = time.time()
    print(f"[{now - T0:7.1f} s | +{now - _LAST[0]:6.1f} s] {msg}", flush=True)
    _LAST[0] = now


MARK_STEPS = 20  # the marker and viewer phases' episodes: at most 20 steps
MARKER_KEYS = {
    "jvrc_step": {"mode", "targets", "sequence", "terrain_pos", "terrain_size", "terrain_yaw", "floor_z"},
    "jvrc_walk_rough": {"mode", "mode_ref", "hfield", "hfield_x0y0", "hfield_cell"},
    "h1_walk": {"mode", "mode_ref"},
}


def markers_viewer_data_parallel(dev, logroot, runs, cli_path, jvrc_env, num_envs, rollout, smi, path_launches, results):
    """Phase 4's last paths on the card: eval's task markers (K5, K6, K1),
    the live viewer's stepper (K1 at B=1) and the data-parallel trainer on
    one NCCL rank (K1), each checked; raises on a failed check. ``runs``:
    the run directories of the jvrc_step and jvrc_walk_rough runs with the
    motor config and of the h1_walk run."""
    import os
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    import torch.distributed as dist

    from learninghumanoidwalking_tpu_torch import run_experiment as cli
    from learninghumanoidwalking_tpu_torch.envs.jvrc_step import JvrcStepEnv
    from learninghumanoidwalking_tpu_torch.ops import substep_kernel as sk
    from learninghumanoidwalking_tpu_torch.parallel import mesh
    from learninghumanoidwalking_tpu_torch.rl import render as render_mod
    from learninghumanoidwalking_tpu_torch.rl.eval import load_policy
    from learninghumanoidwalking_tpu_torch.rl.ppo import PPO, PPOConfig
    from learninghumanoidwalking_tpu_torch.rl.viewer import PolicyStepper, ViewerLoop

    # -- the markers: eval --out .gif records render_markers(state, 0) at
    # each step of episode 0 from the card's states. matplotlib and imageio
    # do not import on the card machine (PERF.md), so the drawing call is
    # replaced by a recorder of what eval hands it: the markers and the
    # trajectory. jvrc_step's render_markers is wrapped to read the full
    # batch's terrain row of env 0 beside it.
    drawn, terrain_rows = [], []

    def recorder(env, qpos_traj, out_path, fps=40, markers=None):
        drawn.append(dict(traj=qpos_traj, markers=markers))
        return Path(out_path), "none: recorded, no matplotlib or imageio on this machine"

    step_markers = JvrcStepEnv.render_markers

    def recording_step_markers(self, states, i):
        terrain_rows.append(self._terrain(states.task).pos[i].cpu().numpy())
        return step_markers(self, states, i)

    render_trajectory = render_mod.render_trajectory
    render_mod.render_trajectory, JvrcStepEnv.render_markers = recorder, recording_step_markers
    evals = {}
    try:
        for env_name, step_k, settle_k in (("jvrc_step", "K5", "K2"), ("jvrc_walk_rough", "K6", "K3"), ("h1_walk", "K1", "K1")):
            drawn.clear()
            terrain_rows.clear()
            if step_k == "K1":
                expected = lambda out: 1 + out["steps"]  # noqa: E731
            else:
                expected = lambda out, a=step_k, b=settle_k: {a: out["steps"], b: 1}  # noqa: E731
            ev = cli_path(f"{env_name} eval --out .gif (markers; 2 episodes, {MARK_STEPS} steps)", cli.evaluate,
                          ["--path", runs[env_name], "--episodes", "2", "--max-steps", str(MARK_STEPS), "--out",
                           os.path.join(logroot, env_name + "_markers.gif"), "--device", "cuda"], expected)
            evals[env_name] = ev
            markers, n0 = ev["markers"], ev["lengths"][0]
            ok = (len(drawn) == 1 and drawn[0]["markers"] is markers and len(markers) == n0
                  and drawn[0]["traj"].shape == (n0, ev["trajectories"][0].shape[1])
                  and all(set(m) == MARKER_KEYS[env_name] for m in markers))
            note = ""
            if env_name == "jvrc_step":
                targets_in_plan = all(bool(np.all(np.any(np.all(m["sequence"][None] == m["targets"][:, None], axis=-1), axis=1)))
                                      for m in markers)
                boxes_equal = len(terrain_rows) == n0 and all(np.array_equal(m["terrain_pos"], r) for m, r in zip(markers, terrain_rows))
                ok = ok and targets_in_plan and boxes_equal
                note = (f"both targets rows of the shown plan in every frame {targets_in_plan}, terrain boxes equal the env's "
                        f"terrain row of env 0 {boxes_equal} ({markers[0]['terrain_pos'].shape[0]} boxes, plan "
                        f"{markers[0]['sequence'].shape[0]} steps, mode {markers[0]['mode']})")
            elif env_name == "jvrc_walk_rough":
                fields = all(m["hfield"].shape == (16, 16) and m["hfield"].dtype == np.float32 for m in markers)
                ok = ok and fields
                note = f"field 16x16 float32 in every frame {fields}, modes {sorted({m['mode'] for m in markers})}"
            else:
                note = f"modes {sorted({m['mode'] for m in markers})}"
            results[f"phase 4 markers {env_name}"] = dict(frames=len(markers), episode_length=n0, renderer=ev["renderer"])
            log(f"phase 4 markers {env_name}: {'PASS' if ok else 'FAIL'} | one marker dict per frame of episode 0 "
                f"({len(markers)} of {n0}), keys {sorted(MARKER_KEYS[env_name])} | {note} | renderer: {ev['renderer']}")
            if not ok:
                raise RuntimeError(f"eval's task markers on {env_name} are not as expected")
    finally:
        render_mod.render_trajectory, JvrcStepEnv.render_markers = render_trajectory, step_markers

    # -- the viewer's stepper: episode 0 of the h1_walk run at B=1 through
    # K1, driven by ViewerLoop with a fake window (no mujoco there), held
    # step by step to eval's episode 0 at B=2 from the same seed
    class FakeViewer:
        syncs = 0

        def is_running(self):
            return True

        def sync(self):
            self.syncs += 1

    policy, _, (env, _) = load_policy(runs["h1_walk"], device=dev)
    stepper = PolicyStepper(policy, env, dev)
    for c in sk.counters.values():
        c.reset()
    t0 = time.time()
    stepper.reset(0)
    fake, qs = FakeViewer(), []
    n = ViewerLoop(env.control_dt, realtime=False).run_episode(fake, stepper.step, lambda: qs.append(stepper.qpos()), MARK_STEPS)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {k: c.launches for k, c in sk.counters.items()}
    for k, v in launches.items():
        path_launches[k] = path_launches.get(k, 0) + v
    ref = evals["h1_walk"]["trajectories"][0]
    m = min(n, len(ref))
    diff = float(np.abs(np.stack(qs[:m]) - ref[:m]).max())
    want = dict.fromkeys(sk.counters, 0)
    want["K1"] = 1 + n
    ok = n == len(ref) and fake.syncs == n and diff <= 1e-4 and launches == want
    results["phase 4 viewer stepper"] = dict(steps=n, eval_length=len(ref), max_abs_qpos_diff=diff, launches=launches, seconds=seconds)
    log(f"phase 4 viewer stepper (h1_walk, episode 0, B=1, ViewerLoop with a fake window): {'PASS' if ok else 'FAIL'} | "
        f"{n} steps ({fake.syncs} syncs), eval's episode 0 at B=2 {len(ref)} | qpos "
        f"{'equal bit for bit' if diff == 0 else f'max abs difference {diff:.3g} (limit 1e-4)'} | launches {launches} "
        f"(expected {want}) | {seconds:.2f} s")
    if not ok:
        raise RuntimeError("the viewer's stepper left eval's episode 0")

    # -- data parallel: one NCCL rank at full width against the plain trainer
    cfg = PPOConfig(num_envs=num_envs, rollout_len=rollout, minibatch_size=32768, seed=0)
    for c in sk.counters.values():
        c.reset()
    out = {}
    for mode in ("plain", "nccl"):
        shard = None
        if mode == "nccl":
            t0 = time.time()
            shard = mesh.init_rank(0, 1, "cuda", os.path.join(tempfile.mkdtemp(dir=logroot), "store"), num_envs)
            shard.all_reduce([torch.zeros(1, device=dev)])  # NCCL builds its communicator at the first collective
            torch.cuda.synchronize()
            init_s = time.time() - t0
        try:
            trainer = PPO(jvrc_env, cfg, device=dev, shard=shard)
            ts = trainer.init_state()
            t0 = time.time()
            ts, batch, roll = trainer._sample_iteration(ts)
            torch.cuda.synchronize()
            t1 = time.time()
            if shard is not None:
                shard.timed = True
            ts, aux = trainer._optimize_iteration(ts, batch)
            torch.cuda.synchronize()
            t2 = time.time()
            out[mode] = dict(ts=ts, metrics={k: float(v) for k, v in {**roll, **aux}.items()}, sample_s=t1 - t0, optimize_s=t2 - t1,
                             reduce_s=shard.reduce_seconds if shard is not None else 0.0)
            del batch
        finally:
            if shard is not None:
                dist.destroy_process_group()
    launches = {k: c.launches for k, c in sk.counters.items()}
    for k, v in launches.items():
        path_launches[k] = path_launches.get(k, 0) + v
    a, b = out["nccl"]["ts"], out["plain"]["ts"]
    pairs = [(f"actor.{k}", x, a.actor.state_dict()[k]) for k, x in b.actor.state_dict().items()]
    pairs += [(f"critic.{k}", x, a.critic.state_dict()[k]) for k, x in b.critic.state_dict().items()]
    for name, oa, ob in (("actor_opt", a.actor_opt, b.actor_opt), ("critic_opt", a.critic_opt, b.critic_opt)):
        pairs += [(f"{name}.mu{i}", y, x) for i, (x, y) in enumerate(zip(oa.mu, ob.mu))]
        pairs += [(f"{name}.nu{i}", y, x) for i, (x, y) in enumerate(zip(oa.nu, ob.nu))]
        pairs += [(f"{name}.count", ob.count, oa.count), (f"{name}.notfinite", ob.notfinite_count, oa.notfinite_count)]
    pairs += [(f"norm.{f}", getattr(b.norm, f), getattr(a.norm, f)) for f in ("mean", "var", "count")]
    same = all(torch.equal(x, y) for _, x, y in pairs)
    same_metrics = out["nccl"]["metrics"] == out["plain"]["metrics"]

    def rel(x, y):
        return float((x.double() - y.double()).abs().max()) / max(float(x.double().abs().max()), 1e-30)

    worst = max(max(rel(x, y) for _, x, y in pairs),
                max(abs(out["nccl"]["metrics"][k] - v) / max(abs(v), 1e-30) for k, v in out["plain"]["metrics"].items()))
    want = dict.fromkeys(sk.counters, 0)
    want["K1"] = 2 * (1 + rollout + 1)
    finite = all(np.isfinite(v) for v in out["nccl"]["metrics"].values())
    ok = (same and same_metrics or worst <= 1e-6) and finite and launches == want
    share = out["nccl"]["reduce_s"] / out["nccl"]["optimize_s"]
    results["phase 4 data parallel"] = dict(bit_for_bit=same and same_metrics, worst_rel=worst, launches=launches,
                                            **{f"{k}_{m}": v for k in out for m, v in out[k].items() if m != "ts" and m != "metrics"},
                                            nccl_share_of_optimize=share, nccl_init_s=init_s, metrics=out["nccl"]["metrics"])
    log(f"phase 4 data parallel (jvrc_walk, {num_envs} envs, rollout {rollout}, minibatch 32768, 1 iteration; one NCCL rank "
        f"against the plain trainer from the same seed; the card machine has one GPU, so only the CPU test with 2 gloo ranks "
        f"checks more than one rank): {'PASS' if ok else 'FAIL'} | params, Adam moments, norm "
        f"{'and metrics equal bit for bit' if same and same_metrics else f'worst relative difference {worst:.3g} (limit 1e-6)'} | "
        f"sample {out['plain']['sample_s']:.2f} / {out['nccl']['sample_s']:.2f} s, optimize {out['plain']['optimize_s']:.2f} / "
        f"{out['nccl']['optimize_s']:.2f} s (plain / NCCL; the process group and its first all-reduce before, {init_s:.2f} s), NCCL all-reduce {1e3 * out['nccl']['reduce_s']:.1f} ms = "
        f"{share:.4f} of the NCCL run's optimize (each all-reduce synchronized) | launches {launches} (expected {want}) | {smi}")
    if not ok:
        raise RuntimeError("the one-rank NCCL iteration left the plain trainer's")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 2

    import copy
    import dataclasses
    import os
    import shutil
    import tempfile
    import types

    import numpy as np

    from learninghumanoidwalking_tpu_torch.envs.humanoid import CONFIG_DIR
    from learninghumanoidwalking_tpu_torch.envs.registry import make_env
    from learninghumanoidwalking_tpu_torch.ops import substep_kernel as sk
    from learninghumanoidwalking_tpu_torch.models import jvrc as jvrc_model
    from learninghumanoidwalking_tpu_torch.physics import batched, rangefinder
    from learninghumanoidwalking_tpu_torch.physics import engine as eng
    from learninghumanoidwalking_tpu_torch.physics.mjcf import export_mjcf
    from learninghumanoidwalking_tpu_torch import run_experiment as cli
    from learninghumanoidwalking_tpu_torch.physics.model import default_dyn_params, tree_map
    from learninghumanoidwalking_tpu_torch.robots import motor as motor_mod
    from learninghumanoidwalking_tpu_torch.rl import networks
    from learninghumanoidwalking_tpu_torch.rl.checkpoint import Checkpointer, find_latest_run
    from learninghumanoidwalking_tpu_torch.rl.ppo import PPO, PPOConfig
    from learninghumanoidwalking_tpu_torch.rl.ppo import mask_carry
    from learninghumanoidwalking_tpu_torch.rl.trace import summarize_trace
    from learninghumanoidwalking_tpu_torch.utils import maths
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
    built = sk.build_all()
    log("phase 2 build: " + " | ".join(f"nvcc {name} {s:.1f} s -> {path}" for name, (s, path, _) in built.items()))
    for name, (_, _, ptxas) in built.items():
        log(f"phase 2 ptxas {name}: " + " | ".join(ptxas))

    # ---- phase 3: each kernel against its plain version -------------------
    F32_PEAK, HBM_BPS = 67e12, 3.35e12  # H100 SXM: f32 non-tensor FLOP/s, HBM bytes/s
    motor_json = os.path.join(CONFIG_DIR, "jvrc_motor.json")
    paths = {"K1": "jvrc_walk", "K2": "jvrc_step", "K3": "jvrc_walk_rough", "K4": "jvrc_walk (jvrc_motor.json)",
             "K5": "jvrc_step (jvrc_motor.json)", "K6": "jvrc_walk_rough (jvrc_motor.json)"}
    MOTOR_KERNELS = ("K4", "K5", "K6")
    envs = {name: make_env(env_name.split()[0], path_to_json=motor_json if name in MOTOR_KERNELS else None, device=dev)
            for name, env_name in paths.items()}
    model_cpu = {name: tree_map(lambda x: x.cpu() if torch.is_tensor(x) else x, env.model) for name, env in envs.items()}

    def seeded_reset(env, batch: int, seed: int):
        """Reset states, and the pre-settle physics, dynamics and terrain of a
        second draw (the settle launch's inputs)."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        draws = Draws(gen)
        physics, dyn, task = env._reset_pre(draws, batch, None)
        return env.reset_batch(batch, draws), physics, dyn, env._terrain(task)

    def total_grf(out):
        return torch.sum(torch.linalg.vector_norm(out.contact.force, dim=-1) * out.contact.mask, dim=1)

    def part1(out_k, out_p):
        q_err = float((out_k.qpos - out_p.qpos).abs().max())
        rel = (total_grf(out_k) - total_grf(out_p)).abs() / (total_grf(out_p).abs() + 50.0)
        return q_err, float(torch.quantile(rel, 0.95))

    def time_ms(fn, reps: int, warm: bool = True) -> float:
        """Mean ms of ``reps`` calls (CUDA events), after one untimed call
        where ``warm``."""
        if warm:
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
    # RTOL (1 + |x64|) plus SENS times a float32 witness's own distance from
    # it, by default the plain version's (max over the env's elements of the
    # field). The first term is a max-abs limit of 1e-4 on O(1) fields,
    # relative on torques, velocities, accelerations and forces, whose f32
    # rounding scales with their size; the second admits an env only as far
    # as the state itself amplifies f32 rounding (a contact on its
    # friction-cone boundary, a stiff contact acceleration), which a kernel
    # fault (a wrong row, a stale value) does not. A slot's mask may differ
    # only where its float64 distance lies within RTOL of the contact margin,
    # and there its force with it.
    fields = {
        "qpos": lambda s: s.qpos, "qvel": lambda s: s.qvel, "qacc": lambda s: s.qacc,
        "act_torque": lambda s: s.act_torque, "xpos": lambda s: s.xpos, "xquat": lambda s: s.xquat,
        "cvel": lambda s: s.cvel, "cpos": lambda s: s.contact.pos, "cdist": lambda s: s.contact.dist,
        "cforce": lambda s: s.contact.force, "cmask": lambda s: s.contact.mask,
        "cnormal": lambda s: s.contact.frame[..., 0, :], "cframe": lambda s: s.contact.frame,
    }
    # K4 adds the motor histories (the count is compared exactly, apart), on
    # (PhysicsState, MotorState) pairs seen as one object (joined)
    motor_fields = {**fields, "qdot_hist": lambda s: s.motor.qdot_hist, "ctau_hist": lambda s: s.motor.ctau_hist}

    def joined(out):
        """A kernel or plain-version output; a (PhysicsState, MotorState)
        pair as one object with the state's fields and ``motor``."""
        if not isinstance(out, tuple):
            return out
        state, motor = out
        return types.SimpleNamespace(**{f.name: getattr(state, f.name) for f in dataclasses.fields(state)}, motor=motor)

    # max_abs_err reports these
    abs_fields = ("qpos", "xpos", "xquat", "act_torque", "cpos", "cdist", "cmask", "cnormal")
    RTOL, SENS = 1e-4, 10.0
    # K1 must pass that rule in every env (step at R=5 and settle), though it
    # runs the Woodbury contact solve too. K2 (jvrc_step: its Woodbury
    # contact solve rounds otherwise than the plain version's dense one, so
    # a bistable env lands elsewhere), K3 (jvrc_walk_rough: dynamics
    # randomization, soft contacts on a heightfield) and K4 (the motor path,
    # from states two control steps after a reset) have envs whose state
    # amplifies rounding so strongly that one float32 witness underestimates
    # it. Such an env is admitted (admit_chaotic) only if
    #  - at most ADMIT_SHARE of the launch's envs need it;
    #  - a second witness shows the chaos: the env passes the same rule with
    #    the largest distance from float64 of ENSEMBLE + 1 other float32
    #    runs of the plain version, one on the CPU and ENSEMBLE on the card
    #    (one launch) from the input state changed by one ulp (qpos, qvel x
    #    (1 +- 2^-23), random signs): a bistable env lands on the kernel's
    #    branch in some of them (with three, the witness missed two K4 envs
    #    whose replay passed: PERF.md);
    #  - the kernel's own arithmetic is as good there as elsewhere: replayed
    #    one reuse group at a time, each group started from the float64
    #    state rounded to float32, the kernel's error against float64 from
    #    that same input stays within SENS times the larger error of the
    #    plain version on the card and on the CPU, plus ULP4 (1 + |x64|)
    #    (4 float32 ulps), in every field and group. The one exception is a
    #    contact switch: at most one group per env may have the kernel's mask
    #    differ from float64's, and only at a slot whose float64 distance
    #    lies within FLIP_DIST of the margin (that group's other fields then
    #    follow the switch and are not compared).
    ADMIT_SHARE, ULP4, FLIP_DIST = 1e-3, 4 * 2.0**-23, 1e-6
    VEL_SAMPLES = 6  # velocity-scale samples a replay group adds where the joint friction is chaotic
    ENSEMBLE = 16  # float32 runs of the plain version from one-ulp moves of an input, in one launch

    to64 = lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x
    to32 = lambda x: x.float() if torch.is_tensor(x) and x.is_floating_point() else x
    to_cpu = lambda x: x.cpu() if torch.is_tensor(x) else x
    to_dev = lambda x: x.to(dev) if torch.is_tensor(x) else x

    # seconds of phase 3 by kind of work (each call synchronized), printed
    # at its end: where the script's time goes
    spent: dict = {}

    def timed(kind: str, fn):
        def run(*a, **k):
            t0 = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[kind] = spent.get(kind, 0.0) + time.time() - t0
            return out
        return run

    plain32 = timed("plain float32 on the card", batched.pd_substeps_batched)

    def _plain_f64(args, **kw):
        prev = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            return batched.pd_substeps_batched(*[tree_map(to64, a) for a in args], **{k: tree_map(to64, v) for k, v in kw.items()})
        finally:
            torch.set_default_dtype(prev)

    # The plain version in float64 on the card (TF32 off; the motor weights
    # and histories cast too): the reference of every rule below
    plain_f64 = timed("plain float64 on the card", _plain_f64)

    def _plain_cpu(args, **kw):
        out = batched.pd_substeps_batched(*[tree_map(to_cpu, a) for a in args], **{k: tree_map(to_cpu, v) for k, v in kw.items()})
        return tree_map(to_dev, out)

    # The plain float32 version on the CPU, its outputs back on the card
    # (a witness of another machine's rounding)
    plain_cpu = timed("plain float32 on the CPU", _plain_cpu)

    def take(tree, idx, batch: int):
        """Envs idx of a batch-leading tree (or joined output)."""
        if isinstance(tree, types.SimpleNamespace):
            return types.SimpleNamespace(**{k: take(v, idx, batch) for k, v in vars(tree).items()})
        return tree_map(lambda x: x[idx] if torch.is_tensor(x) and x.dim() > 0 and x.shape[0] == batch else x, tree)

    def take_kw(kw, idx, batch: int):
        """The keyword arguments of a launch for envs idx (the MotorState of
        ``motor``; the motor weights are not batched)."""
        return kw if "motor" not in kw else {**kw, "motor": (kw["motor"][0], take(kw["motor"][1], idx, batch))}

    def dist_f64(out, out_64, flds=fields) -> dict:
        """Per field, |out - float64| as (B, n) float64."""
        n = out_64.qpos.shape[0]
        return {name: (get(out).reshape(n, -1).double() - get(out_64).reshape(n, -1).double()).abs() for name, get in flds.items()}

    def compare_fields(out_k, out_p, out_64, e_w=None, flds=fields):
        """(per-field results, per-env failure of any field, per field the
        share of its limit per env); the witness's distance from float64 is
        the plain version's, or ``e_w``."""
        e_all, e_w = dist_f64(out_k, out_64, flds), e_w or dist_f64(out_p, out_64, flds)
        res, shares, failing = {}, {}, torch.zeros(out_k.qpos.shape[0], dtype=torch.bool, device=dev)
        for name, get in flds.items():
            k, p, x = (get(o).reshape(o.qpos.shape[0], -1).double() for o in (out_k, out_p, out_64))
            e_k = e_all[name]
            tight = RTOL * (1.0 + x.abs().amax(1, keepdim=True))
            limit = tight + SENS * e_w[name].amax(1, keepdim=True)
            near_margin = (out_64.contact.dist - eng.CONTACT_MARGIN).abs() <= RTOL
            if name == "cmask":
                limit = torch.where(near_margin, torch.inf, limit)
            elif name == "cforce":  # a slot that switched there: its force follows the switch
                switched = near_margin & (out_k.contact.mask != out_64.contact.mask)
                limit = torch.where(switched.repeat_interleave(3, dim=1), torch.inf, limit)
            share = e_k / limit
            ok = share <= 1.0
            failing |= ~ok.all(1)
            res[name] = dict(
                max_abs_err=float((k - p).abs().max()),
                max_abs_err_vs_f64=float(e_k.max()),
                envs_failing=int((~ok.all(1)).sum()),
                envs_past_rtol=int((e_k > tight).any(1).sum()),
                worst_share_of_limit=float(share.nan_to_num(0.0).max()),  # <= 1 passes
            )
            shares[name] = share.nan_to_num(0.0).amax(1)
        return res, failing, shares

    def worst_share(shares, j) -> list:
        """[share of the limit, field] of env j's worst field."""
        return max([float(sh[j]), name] for name, sh in shares.items())

    def vel_ulp(qvel, gen):
        """qvel moved by one float32 ulp of (1 + |qvel|), random signs: the
        scale of the rounding of a velocity's increments, not of the
        velocity (near zero a relative ulp moves nothing)."""
        return qvel + 2.0**-23 * (1.0 + qvel.abs()) * torch.sign(torch.randn(qvel.shape, generator=gen, device=dev))

    def replay(args, kw, model_cpu, flds, vel_witness: bool = False):
        """Per env of a (small) batch: the kernel's worst ratio, over fields
        and reuse groups started from the float64 states, of its error
        against float64 to SENS x the plain versions' + ULP4 (1 + |x64|)
        (share of the limit, <= 1 passes, with its group and field), and its
        contact switches (near the margin; anywhere else). With a motor, its
        state is carried from group to group like the physics."""
        model, dyn, physics, target, n, dt, terrain = args
        group = batched.valid_reuse(n, kw.get("reuse_interval", 1))
        batch = physics.qpos.shape[0]
        worst = torch.zeros(batch, dtype=torch.float64, device=dev)
        where = [None] * batch
        near_switch = torch.zeros(batch, dtype=torch.int64, device=dev)
        far_switch = torch.zeros(batch, dtype=torch.bool, device=dev)
        s_64 = tree_map(to64, physics)
        m_64 = tree_map(to64, kw["motor"][1]) if "motor" in kw else None
        group_kw = lambda m: kw if m is None else {**kw, "motor": (kw["motor"][0], m)}
        for g in range(n // group):
            g_args, g_kw = (model, dyn, tree_map(to32, s_64), target, group, dt, terrain), group_kw(tree_map(to32, m_64))
            k = joined(sk.pd_substeps_kernel(*g_args, **g_kw))
            x_64 = joined(plain_f64(g_args, **g_kw))  # float64 from the same input
            e_k = dist_f64(k, x_64, flds)
            e_p = dist_f64(joined(plain32(*g_args, **g_kw)), x_64, flds)
            e_c = dist_f64(joined(plain_cpu((model_cpu, *g_args[1:]), **g_kw)), x_64, flds)
            if vel_witness:  # VEL_SAMPLES more float32 samples of the group's rounding
                gen = torch.Generator(device=dev)
                gen.manual_seed(1000 + g)
                for _ in range(VEL_SAMPLES):
                    s_32 = g_args[2]
                    moved = dataclasses.replace(s_32, qvel=vel_ulp(s_32.qvel, gen))
                    e_v = dist_f64(joined(plain32(*g_args[:2], moved, *g_args[3:], **g_kw)), x_64, flds)
                    e_c = {f: torch.maximum(e_c[f], e_v[f]) for f in flds}
            flip = k.contact.mask != x_64.contact.mask
            near = (x_64.contact.dist - eng.CONTACT_MARGIN).abs() <= FLIP_DIST
            switched = flip.any(1)
            near_switch += (switched & ~(flip & ~near).any(1)).long()
            far_switch |= (flip & ~near).any(1)
            for name, get in flds.items():
                if name == "cmask":
                    continue
                x = get(x_64).reshape(batch, -1).double().abs().amax(1)
                limit = SENS * torch.maximum(e_p[name].amax(1), e_c[name].amax(1)) + ULP4 * (1.0 + x)
                share = torch.where(switched, 0.0, (e_k[name].amax(1) / limit).nan_to_num(torch.inf))
                for j in torch.nonzero(share > worst).flatten().tolist():
                    where[j] = (g, name)
                worst = torch.maximum(worst, share)
            nxt = plain_f64((model, dyn, s_64, target, group, dt, terrain), **group_kw(m_64))
            s_64, m_64 = nxt if m_64 is not None else (nxt, None)
        return worst, where, near_switch, far_switch

    def admit_chaotic(args, kw, failing, out_k, out_p, out_64, model_cpu, batch: int, flds=fields,
                      cap: int | None = None, vel_witness: bool = False) -> tuple[torch.Tensor, dict]:
        """(failing envs not admitted, report): see ADMIT_SHARE above (or
        ``cap`` envs at most). The replay also runs on 32 passing envs, whose
        ratios show what the kernel's arithmetic gives where nothing is
        chaotic. ``vel_witness``: the second witness adds three runs from
        the input with qvel moved by vel_ulp, and each replay group
        VEL_SAMPLES (float32 samples of a state whose joint friction is
        chaotic, see check_launches: there a reuse group of 5 substeps
        amplifies rounding by up to ~1e4, and the limit needs the spread of
        its float32 samples, not one or two of them)."""
        bad = torch.nonzero(failing).flatten()
        cap = int(ADMIT_SHARE * batch) if cap is None else cap
        if len(bad) > cap:
            return bad, dict(envs_failing_rule=len(bad), cap=cap)
        gen = torch.Generator(device=dev)
        gen.manual_seed(123)
        pool = torch.nonzero(~failing).flatten()
        idx = torch.cat([bad, pool[torch.randperm(len(pool), generator=gen, device=dev)[:32]]])
        sub_args = (args[0], *take(args[1:], idx, batch))  # the model is not batched
        sub_kw = take_kw(kw, idx, batch)
        o_k, o_p, o_64 = (take(o, idx, batch) for o in (out_k, out_p, out_64))
        # the second witness: the plain version on the CPU, and ENSEMBLE
        # copies on the card, in one launch, from the input changed by one ulp
        e_2 = dist_f64(joined(plain_cpu((model_cpu, *sub_args[1:]), **sub_kw)), o_64, flds)
        model, dyn, physics, *rest = sub_args
        ulp = lambda x: x * (1.0 + 2.0**-23 * torch.sign(torch.randn(x.shape, generator=gen, device=dev)))
        n_sub = len(idx)
        rep = torch.arange(n_sub, device=dev).repeat(ENSEMBLE)
        e_args = take(sub_args[1:], rep, n_sub)
        moved = dataclasses.replace(e_args[1], qpos=ulp(e_args[1].qpos), qvel=ulp(e_args[1].qvel))
        out_e = joined(plain32(model, e_args[0], moved, *e_args[2:], **take_kw(sub_kw, rep, n_sub)))
        for f, e in dist_f64(out_e, take(o_64, rep, n_sub), flds).items():
            e_2[f] = torch.maximum(e_2[f], e.reshape(ENSEMBLE, n_sub, -1).amax(0))
        for _ in range(3 if vel_witness else 0):
            moved = dataclasses.replace(physics, qvel=vel_ulp(physics.qvel, gen))
            e_vel = dist_f64(joined(plain32(model, dyn, moved, *rest, **sub_kw)), o_64, flds)
            e_2 = {f: torch.maximum(e_2[f], e_vel[f]) for f in flds}
        _, _, sh_card = compare_fields(o_k, o_p, o_64, flds=flds)
        _, fail_2, sh_2 = compare_fields(o_k, o_p, o_64, e_w=e_2, flds=flds)
        e_k, e_p = dist_f64(o_k, o_64, flds), dist_f64(o_p, o_64, flds)

        def from_f64(j):  # env j's distances from float64 in the field it fails most
            f = worst_share(sh_card, j)[1]
            return dict(field=f, kernel=float(e_k[f][j].max()), plain=float(e_p[f][j].max()), second_witness=float(e_2[f][j].max()))

        worst, where, near_switch, far_switch = replay(sub_args, sub_kw, model_cpu, flds, vel_witness)
        nb = len(bad)
        ok_env = ~fail_2[:nb] & (worst[:nb] <= 1.0) & (near_switch[:nb] <= 1) & ~far_switch[:nb]
        sample = worst[nb:]
        report = dict(
            envs_failing_rule=nb, cap=cap,
            admitted=[
                dict(env=int(bad[j]), vs_plain=worst_share(sh_card, j), vs_second_witness=worst_share(sh_2, j), from_f64=from_f64(j),
                     replay_share=float(worst[j]), replay_worst_at=where[j], contact_switches=int(near_switch[j]),
                     switch_off_margin=bool(far_switch[j]), admitted=bool(ok_env[j]))
                for j in range(nb)
            ],
            replay_share_passing_envs=dict(n=len(sample), median=float(sample.median()), max=float(sample.max())) if len(sample) else None,
        )
        return bad[~ok_env], report

    def dump_inputs(tag: str, args, kw, idx) -> str:
        """The launch inputs of envs ``idx`` (state, dynamics, target,
        terrain, motor state and nets), on the CPU, to
        <LHW_SMOKE_OUT>/failing_<tag>.pt: what an offline replay of a
        failing launch needs besides the env's model."""
        batch = args[2].qpos.shape[0]
        path = os.path.join(out_dir, f"failing_{tag}.pt")
        os.makedirs(out_dir, exist_ok=True)
        torch.save(dict(envs=idx.tolist(), args=tree_map(to_cpu, take(args[1:], idx, batch)), kw=tree_map(to_cpu, take_kw(kw, idx, batch))), path)
        return path

    def worst_env(model, out_k, out_p, out_64):
        """The env of the largest qpos error, with what can explain it."""
        mu = torch.as_tensor(model.np("geom_friction")[eng.slot_geoms(model)], dtype=torch.float64, device=dev)
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

    def terrain_contacts(name, model, out) -> int:
        """Active terrain contacts of a kernel output: box-slot contacts (K2,
        K5), heightfield contacts whose normal tilts by more than 1e-3 (K3,
        K6)."""
        active = out.contact.mask > 0
        if name in ("K2", "K5"):
            kinds = sk.slot_kinds(model, hfield=False)
            box = torch.tensor([k == "box" for k in kinds], device=dev)
            return int((active & box).sum())
        if name in ("K3", "K6"):
            tilt = torch.linalg.vector_norm(out.contact.frame[..., 0, :2], dim=-1)
            return int((active & (tilt > 1e-3)).sum())
        return int(active.sum())

    def settle_vs_f64(env, dyn, terrain, reuse: int, out_64, s_k, s_p):
        """Part 2 held to float64, for a robot that does not come to rest
        under its PD gains (H1), where bench.py's statics limits do not
        apply. The plain version in float64 runs part 2's 20 steps from the
        step launch's float64 output, each launch from its state rounded to
        float32 (the kernel's input); the kernel and the plain version in
        float32 launch each step again from that same input, and each step
        is held by the rule of compare_fields, env by env. So every state
        the settling robot passes through is a launch held as in phase 3,
        with no amplification of rounding across steps. A collapsing robot
        has bistable envs (a corner at the contact margin, a contact at
        stick and slip): from its input moved by one float32 ulp the plain
        version lands on either branch (PERF.md). So an env that fails the
        rule is admitted only if it passes it with the largest distance from
        float64 of 2 ENSEMBLE float32 runs of the plain version as the
        witness: from the input moved by one ulp (qpos relative, qvel by
        vel_ulp), and from the floating base moved by FLIP_DIST (a contact
        within FLIP_DIST of the margin, which the kernel's rounding of the
        kinematics may switch: the replay's tolerance); at most ADMIT_SHARE
        of the env-launches of the 20 steps may be admitted; a faulty kernel
        lands where no such run does. Where they miss, an env whose only
        failing rows are its contacts' (its state, accelerations and
        torques pass the rule with those runs as the witness) is admitted
        if its replay (admit_chaotic)
        passes with at most one contact switch within FLIP_DIST of the
        margin. (The replay alone does not refuse the float32 Gram's
        breakdown, itself a matter of rounding: from the float64 states it
        did not recur in 5 of 14 env-launches; their accelerations fail.)
        The free-running 20-step runs of the kernel
        and the plain version (s_k, s_p) are measured against that float64
        run, the plain version's distance beside the kernel's, and
        reported. Returns (every step passes, report)."""
        model = env.model
        batch = s_k.qpos.shape[0]
        m_cpu = tree_map(to_cpu, model)
        body_fields = {f: fields[f] for f in ("qpos", "qvel", "qacc", "act_torque", "xpos", "xquat", "cvel")}
        neutral = env.neutral_pose.expand(batch, -1)
        kw = dict(reuse_interval=reuse)
        gen = torch.Generator(device=dev)
        gen.manual_seed(77)
        s_64, refused, admitted, steps = out_64, 0, 0, []
        for i in range(20):
            args = (model, dyn, tree_map(to32, s_64), neutral, env.frame_skip, env.sim_dt, terrain)
            o_k = sk.pd_substeps_kernel(*args, **kw)
            o_p = plain32(*args, **kw)
            s_64 = plain_f64(args, **kw)
            torch.cuda.synchronize()
            _, failing, shares = compare_fields(o_k, o_p, s_64)
            bad = torch.nonzero(failing).flatten()
            entry = dict(step=i, envs_failing_rule=len(bad), worst_share=max(float(sh.max()) for sh in shares.values()),
                         active_contacts=int((o_k.contact.mask > 0).sum()), admitted=[], refused=[])
            refused += int((~torch.isfinite(o_k.qpos).all(1)).sum())
            if len(bad):
                # 2 ENSEMBLE moved copies of each failing env, in one launch: one
                # ulp, then the floating base's position (qpos 0-2) by FLIP_DIST
                n = len(bad)
                rep = bad.repeat(2 * ENSEMBLE)
                sub = take(args[2], rep, batch)
                sign = lambda x: torch.sign(torch.randn(x.shape, generator=gen, device=dev))
                qpos = sub.qpos * (1.0 + 2.0**-23 * sign(sub.qpos))
                qpos[ENSEMBLE * n:, :3] = sub.qpos[ENSEMBLE * n:, :3] + FLIP_DIST * sign(sub.qpos[ENSEMBLE * n:, :3])
                moved = dataclasses.replace(sub, qpos=qpos, qvel=vel_ulp(sub.qvel, gen))
                o_e = plain32(model, take(dyn, rep, batch), moved, neutral[rep], *args[4:], **kw)
                x_64 = take(s_64, rep, batch)
                e_w = dist_f64(take(o_p, bad, batch), take(s_64, bad, batch))
                for name, e in dist_f64(o_e, x_64).items():
                    e_w[name] = torch.maximum(e_w[name], e.reshape(2 * ENSEMBLE, n, -1).amax(0))
                o_kb, o_pb, x_b = (take(o, bad, batch) for o in (o_k, o_p, s_64))
                _, _, sh_plain = compare_fields(o_kb, o_pb, x_b)
                _, fail_e, sh_e = compare_fields(o_kb, o_pb, x_b, e_w=e_w)
                # an env the ensemble misses: admitted where only its contact
                # rows fail (its state and accelerations pass the rule with
                # the ensemble as the witness) and its replay passes with at
                # most one switch at the margin
                ok_e = ~fail_e
                left = torch.nonzero(fail_e).flatten()
                extra = {}
                if len(left):
                    sel = lambda o: take(o, bad[left], batch)
                    _, fail_body, _ = compare_fields(sel(o_k), sel(o_p), sel(s_64), e_w={f: e_w[f][left] for f in body_fields},
                                                     flds=body_fields)
                    worst, _, near_switch, far_switch = replay((model, *take(args[1:], bad[left], batch)), kw, m_cpu, fields)
                    ok_e[left] = ~fail_body & (worst <= 1.0) & (near_switch <= 1) & ~far_switch
                    extra = {int(j): dict(body_fails=bool(fb), replay_share=float(w), contact_switches=int(ns))
                             for j, fb, w, ns in zip(left.tolist(), fail_body, worst, near_switch)}
                for j, env_j in enumerate(bad.tolist()):
                    row = dict(env=env_j, vs_plain=worst_share(sh_plain, j), vs_ensemble=worst_share(sh_e, j), **extra.get(j, {}))
                    entry["admitted" if bool(ok_e[j]) else "refused"].append(row)
                refused += int((~ok_e).sum())
                admitted += int(ok_e.sum())
            steps.append(entry)
        cap = int(ADMIT_SHARE * 20 * batch)
        ok = refused == 0 and admitted <= cap
        # the free-running runs against the float64 one: per env, qpos's
        # largest distance and the total normal contact force's relative
        # distance, as (median, 99th percentile, max) over the envs
        fn = lambda o: torch.sum(o.contact.force[..., 0].double() * o.contact.mask.double(), dim=1)
        fn_64 = fn(s_64)
        qs = torch.tensor([0.5, 0.99, 1.0], dtype=torch.float64, device=dev)
        weight = float(np.sum(model.np("body_mass")) * 9.81)
        free = {}
        for who, o in (("kernel", s_k), ("plain", s_p)):
            e_q = (o.qpos.double() - s_64.qpos).abs().amax(1)
            e_f = (fn(o) - fn_64).abs() / (fn_64.abs() + 1.0)
            free[who] = dict(qpos_vs_f64=torch.quantile(e_q, qs).tolist(), grf_vs_f64=torch.quantile(e_f, qs).tolist(),
                             grf_vs_weight=abs(float(fn(o).mean()) - weight) / weight)
        free["f64_grf_vs_weight"] = abs(float(fn_64.mean()) - weight) / weight
        free["envs_failing_rule"] = int(compare_fields(s_k, s_p, s_64)[1].sum())
        free["envs_failing_mirrored"] = int(compare_fields(s_p, s_k, s_64)[1].sum())
        return ok, dict(steps=steps, free_running=free, refused=refused, admitted=admitted, cap=cap,
                        envs_failing_rule=sum(e["envs_failing_rule"] for e in steps))

    def check_launches(name: str, batch: int, seed: int, full_gate: bool, reps_kernel: int, reps_plain: int,
                       env=None, dyn_mode: str = "reset", admit: bool | None = None, mirrored_cap: bool = False,
                       vel_witness: bool = False, part2_vs_f64: bool = False):
        """The step and settle launches of ``name``'s kernel on ``env``
        (default envs[name]) against the plain version. ``dyn_mode``: the
        reset's dynamics ("reset"), those with perturbation wrenches drawn
        into them as a step's perturbation event would ("perturbed"), the
        same with every joint's frictionloss set to 0 ("no friction"), or the
        model's defaults ("off"). The H1 config's frictionloss, U(0, 2) N m
        under tanh(v / 0.02) and integrated explicitly, makes the joint
        velocity of a light link a chaotic map near v = 0 (the step's gain
        dt f / (0.02 I) reaches 6-7 at the ankle): float32 runs of the plain
        version part from float64 and from each other there, and with the
        frictionloss at 0 they do not (PERF.md). ``vel_witness``: see
        admit_chaotic. ``part2_vs_f64``: part 2 (with ``full_gate``) is
        held to float64 (settle_vs_f64) and bench.py's statics limits are
        reported only, with the settled height range and tilt. ``admit``:
        whether chaotic envs may be admitted (default for K2 and K3);
        ``mirrored_cap``: the admission cap is the larger of ADMIT_SHARE of
        the launch and twice the count of envs where the plain version
        fails the same rule against the kernel (the roles swapped). With the
        config's frictionloss both float32 versions leave float64 in about
        as many envs (H1: 7 and 9 of 4096, 95 and 91 of 32768), so
        ADMIT_SHARE alone would refuse chaos that the plain version shows
        as often as the kernel. The cap refuses only a fault that reaches
        many envs: a wrong kernel fails in more envs, and the swapped count
        does not grow with the kernel's error. A fault confined to fewer
        envs than the cap is left to each env's second witness and replay,
        which every admitted env must pass; PERF.md lists the frictionloss
        faults planted to show that they still fail."""
        env = envs[name] if env is None else env
        admit = name in ("K2", "K3") if admit is None else admit
        model = env.model
        states, pre_physics, pre_dyn, pre_terrain = seeded_reset(env, batch, seed)
        if dyn_mode == "perturbed":
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed + 2)
            states = dataclasses.replace(states, dyn=env._sample_perturbation(Draws(gen), states.dyn))
            pre_dyn = env._sample_perturbation(Draws(gen), pre_dyn)
        elif dyn_mode == "no friction":
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed + 2)
            no_fric = lambda d: dataclasses.replace(d, dof_frictionloss=torch.zeros_like(d.dof_frictionloss))
            states = dataclasses.replace(states, dyn=no_fric(env._sample_perturbation(Draws(gen), states.dyn)))
            pre_dyn = no_fric(env._sample_perturbation(Draws(gen), pre_dyn))
        elif dyn_mode == "off":
            states = dataclasses.replace(states, dyn=default_dyn_params(model, env.kp, env.kd, batch))
            pre_dyn = default_dyn_params(model, env.kp, env.kd, batch)
        terrain = env._terrain(states.task)
        reuse = sk.kernel_reuse(terrain, env.physics_reuse)
        hfield_shape = tuple(terrain.hfield.shape[1:]) if terrain is not None and terrain.hfield is not None else None
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        target = env.neutral_pose + 0.05 * torch.randn((batch, model.nu), generator=gen, device=dev)
        zeros = torch.zeros((batch, model.nu), device=dev)
        launches = {
            "step": ((model, states.dyn, states.physics, target, env.frame_skip, env.sim_dt, terrain), dict(reuse_interval=reuse)),
            "settle": ((model, pre_dyn, pre_physics, zeros, 3, env.sim_dt, pre_terrain), dict(settle=True)),
        }
        res, ok = {}, True
        dyn_of = {"step": states.dyn, "settle": pre_dyn}
        for launch, (args, kw) in launches.items():
            out_k = sk.pd_substeps_kernel(*args, **kw)
            torch.cuda.synchronize()
            out_p = plain32(*args, **kw)
            torch.cuda.synchronize()
            out_64 = plain_f64(args, **kw)
            torch.cuda.synchronize()
            q_err, grf_p95 = part1(out_k, out_p)
            cmp, failing, _ = compare_fields(out_k, out_p, out_64)
            n_terrain = terrain_contacts(name, model, out_k)
            res[launch] = dict(qpos_maxerr=q_err, grf_relerr_p95=grf_p95, terrain_contacts=n_terrain, fields=cmp,
                               worst_env=worst_env(model, out_k, out_p, out_64),
                               # the same rule with the roles swapped: envs where the plain version
                               # leaves float64 by more than the kernel's distance allows
                               envs_failing_mirrored=int(compare_fields(out_p, out_k, out_64)[1].sum()))
            unexplained = torch.nonzero(failing).flatten()
            res[launch]["envs_failing_rule"] = len(unexplained)
            d = dyn_of[launch]
            res[launch]["dyn"] = dict(
                xfrc_env_share=float((d.xfrc.abs().amax((1, 2)) > 0).float().mean()),
                randomized_mass_env_share=float(((d.body_mass - model.body_mass).abs().amax(1) > 0).float().mean()),
                frictionloss_max=float(d.dof_frictionloss.max()),
            )
            if admit and len(unexplained):
                m_cpu = tree_map(lambda x: x.cpu() if torch.is_tensor(x) else x, model)
                cap = max(int(ADMIT_SHARE * batch), 2 * res[launch]["envs_failing_mirrored"]) if mirrored_cap else None
                unexplained, res[launch]["admission"] = admit_chaotic(args, kw, failing, out_k, out_p, out_64, m_cpu, batch, cap=cap,
                                                                      vel_witness=vel_witness)
            res[launch]["envs_failing"] = len(unexplained)
            # a launch must show active contacts (terrain contacts for K2, K3),
            # but for the evaluation replay's batches of 1-3 envs, whose feet
            # may all be in the air at the launch's end
            ok_launch = (bool(torch.isfinite(out_k.qpos).all()) and q_err < 5e-3 and grf_p95 < 0.04
                         and len(unexplained) == 0 and (n_terrain > 0 or batch < 64))
            if not ok_launch:  # the refused envs and the env of the largest qpos error
                idx = torch.cat([unexplained, torch.tensor([res[launch]["worst_env"]["env"]], device=dev)])
                res[launch]["inputs_saved"] = dump_inputs(f"{name}_{launch}_B{batch}", args, kw, idx)
            ok = ok and ok_launch
            if launch == "step" and full_gate:
                neutral = env.neutral_pose.expand(batch, -1)
                s_k, s_p = out_k, out_p
                for _ in range(20):
                    s_k = sk.pd_substeps_kernel(model, states.dyn, s_k, neutral, env.frame_skip, env.sim_dt, terrain, reuse_interval=reuse)
                    torch.cuda.synchronize()
                    s_p = plain32(model, states.dyn, s_p, neutral, env.frame_skip, env.sim_dt, terrain, reuse_interval=reuse)
                    torch.cuda.synchronize()
                dz = float((s_k.qpos[:, 2] - s_p.qpos[:, 2]).abs().max())
                sq_err = float((s_k.qpos - s_p.qpos).abs().max())
                fn_k = torch.sum(s_k.contact.force[..., 0] * s_k.contact.mask, dim=1)
                fn_p = torch.sum(s_p.contact.force[..., 0] * s_p.contact.mask, dim=1)
                fn_rel = float(((fn_k - fn_p).abs() / (fn_p.abs() + 1.0)).max())
                weight = float(np.sum(model.np("body_mass")) * 9.81)
                vs_weight = abs(float(fn_k.mean()) - weight) / weight
                tilt = maths.quat_to_rpy(s_k.qpos[:, 3:7])[:, :2].abs().amax()
                res[launch].update(settled_dz=dz, settled_qpos_maxerr=sq_err, settled_grf_relerr=fn_rel, grf_vs_weight=vs_weight,
                                   settled_z=[float(s_k.qpos[:, 2].min()), float(s_k.qpos[:, 2].max())],
                                   settled_tilt_max_deg=float(torch.rad2deg(tilt)))
                if part2_vs_f64:
                    ok_64, res[launch]["part2_vs_f64"] = settle_vs_f64(env, states.dyn, terrain, reuse, out_64, s_k, s_p)
                    ok = ok and ok_64
                else:
                    ok = ok and dz < 2e-3 and sq_err < 8e-3 and fn_rel < 0.02 and vs_weight < 0.03
        # times (CUDA events; the plain version repeats the kernel's arithmetic in torch ops)
        t0 = time.time()
        for launch, (args, kw) in launches.items():
            res[launch]["ms"] = time_ms(lambda: sk.pd_substeps_kernel(*args, **kw), reps_kernel)
            # the plain version ran on these inputs already (no warm-up call)
            res[launch]["plain_ms"] = time_ms(lambda: batched.pd_substeps_batched(*args, **kw), reps_plain, warm=False)
        spent["timing"] = spent.get("timing", 0.0) + time.time() - t0
        for launch, fs, r in (("step", env.frame_skip, reuse), ("settle", 3, 1)):
            flops = sk.flops_per_env_substep(model, r, hfield=hfield_shape is not None) * fs * batch
            nbytes = sk.bytes_per_launch(model, batch, hfield_shape)
            res[launch].update(flops=flops, bytes=nbytes, bound_ms=1e3 * max(flops / F32_PEAK, nbytes / HBM_BPS),
                               bound_by="operations" if flops / F32_PEAK >= nbytes / HBM_BPS else "bytes")
        res["max_abs_err"] = max(res[n]["fields"][f]["max_abs_err"] for n in launches for f in abs_fields)
        return ok, res

    # K4's (K5's, K6's) launch input: motor counts per env, in turn
    K4_COUNTS = (0, 10, 24, 25, 26, 27, 50, 1001)

    def plain_step(env, st, actions, draws):
        """HumanoidEnv.step_batch with the motor physics of the plain version
        (on the env's terrain, if any)."""
        target = env._pre_step(st, actions)
        physics, motor = plain32(
            env.model, st.dyn, st.physics, target, env.frame_skip, env.sim_dt, env._terrain(st.task), reuse_interval=1,
            motor=(env.motor_params, st.motor),
        )
        return env._post_step(dataclasses.replace(st, motor=motor), physics, actions, target, draws)

    # K4 is held with two sets of nets. The config's (init_motor_params:
    # 0.01-std weights, zero biases, skip 1) leave the MLP term near 1e-4 of
    # the torque, below the rule's limit on act_torque; seeded nets of std
    # NET_STD (weights and biases; skip 1 + NET_STD / 3 N(0, 1), distinct per
    # joint) make it O(10%), so that a fault in the MLP (a transposed weight,
    # a dropped tanh, a misindexed bias or skip) shows in the torque and the
    # state. Both print the MLP term's share of the torque (net_tau_share).
    NET_STD = 0.3

    def scaled_nets(seed: int) -> dict:
        gen = torch.Generator()
        gen.manual_seed(seed)
        params = {k: (NET_STD * torch.randn(v.shape, generator=gen)).to(dev) if torch.is_tensor(v) else v
                  for k, v in envs["K4"].motor_params.items()}  # K4's, K5's and K6's nets are of one shape
        params["skip"] = 1.0 + params["skip"] / 3
        return params

    def net_tau_share(params, mstate) -> float:
        """The MLP term's share of the applied torque, sum |MLP| / sum
        |skip * newest ctau + MLP| over the joints of the envs whose net ran
        in the launch's last substep, from the histories it ended with."""
        ran = mstate.count > sk.HIST_LEN
        tau = motor_mod.motor_forward_b(params, mstate.qdot_hist[ran], mstate.ctau_hist[ran])
        mlp = tau - params["skip"] * mstate.ctau_hist[ran][:, -1]
        return float(mlp.abs().sum() / tau.abs().sum())

    launch_states = {}

    def motor_launch_state(name: str, batch: int, seed: int):
        """(env states, step target) of K4's, K5's or K6's launch: a seeded
        reset, then two plain control steps with the env's nets (they fill
        the histories: count 50). The same for the config nets' and the
        scaled nets' launches of one seed, so made once (the last kept)."""
        key = (name, batch, seed)
        if key not in launch_states:
            launch_states.clear()
            env = envs[name]
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            draws = Draws(gen)
            st = env.reset_batch(batch, draws)
            for _ in range(2):
                st = plain_step(env, st, 0.1 * torch.randn((batch, env.model.nu), generator=gen, device=dev), draws)
            launch_states[key] = (st, env.neutral_pose + 0.05 * torch.randn((batch, env.model.nu), generator=gen, device=dev))
        return launch_states[key]

    def check_motor_launch(name: str, batch: int, seed: int, full_gate: bool, reps_kernel: int, reps_plain: int, params=None,
                           per_env_rule: bool = True):
        """K4 (flat floor), K5 (terrain boxes) or K6 (heightfield) against its
        plain version with the env's nets, or ``params``. On terrain the
        launch must also show active terrain contacts, as K2's and K3's.
        Without ``per_env_rule`` (K5 and K6 at the training batch) the launch
        is held to part 1 of the gate alone and the float64-anchored rule's
        counts are reported: an env whose kernel and plain qpos part by 5e-3
        or more fails part 1 unless the plain version is the one that left
        float64 (the kernel nearer to it)."""
        env = envs[name]
        model, params = env.model, env.motor_params if params is None else params
        st, target = motor_launch_state(name, batch, seed)
        counts = torch.tensor(K4_COUNTS, dtype=torch.int32, device=dev).repeat(batch // len(K4_COUNTS) + 1)[:batch]
        mstate = dataclasses.replace(st.motor, count=counts)
        terrain = env._terrain(st.task)
        hfield_shape = tuple(terrain.hfield.shape[1:]) if terrain is not None and terrain.hfield is not None else None
        reuse = sk.kernel_reuse(terrain, env.physics_reuse, motor=True)
        args, kw = (model, st.dyn, st.physics, target, env.frame_skip, env.sim_dt, terrain), dict(reuse_interval=reuse, motor=(params, mstate))
        out_k = sk.pd_substeps_kernel(*args, **kw)
        torch.cuda.synchronize()
        out_p = plain32(*args, **kw)
        out_64 = plain_f64(args, **kw)
        torch.cuda.synchronize()
        o_k, o_p, o_64 = joined(out_k), joined(out_p), joined(out_64)
        q_err, grf_p95 = part1(o_k, o_p)
        cmp, failing, _ = compare_fields(o_k, o_p, o_64, flds=motor_fields)
        counts_equal = bool((out_k[1].count == out_p[1].count).all() and (out_k[1].count == out_64[1].count).all()
                            and (out_k[1].count == counts + env.frame_skip).all())
        # env-substeps of this launch in which the net ran (count >= 25 after the push)
        runs = sum(int((counts.long() + j >= sk.HIST_LEN).sum()) for j in range(env.frame_skip))
        net_share = runs / (env.frame_skip * batch)
        n_terrain = terrain_contacts(name, model, o_k)
        res = dict(qpos_maxerr=q_err, grf_relerr_p95=grf_p95, terrain_contacts=n_terrain, fields=cmp, counts_equal=counts_equal, net_share=net_share,
                   net_tau_share=net_tau_share(params, out_p[1]),
                   worst_env=worst_env(model, o_k, o_p, o_64),
                   envs_failing_mirrored=int(compare_fields(o_p, o_k, o_64, flds=motor_fields)[1].sum()),
                   envs_failing_rule=int(failing.sum()))
        unexplained = torch.nonzero(failing).flatten()
        q_ok = q_err < 5e-3
        if per_env_rule and len(unexplained):
            unexplained, res["admission"] = admit_chaotic(args, kw, failing, o_k, o_p, o_64, model_cpu[name], batch, motor_fields)
        elif not per_env_rule:
            apart = (o_k.qpos - o_p.qpos).abs().amax(1) >= 5e-3
            d_k, d_p = ((o.qpos.double() - o_64.qpos).abs().amax(1) for o in (o_k, o_p))
            q_ok = not bool((apart & (d_k > d_p)).any())
            res["part1_envs_apart"] = [dict(env=int(j), kernel_vs_f64=float(d_k[j]), plain_vs_f64=float(d_p[j]))
                                       for j in torch.nonzero(apart).flatten().tolist()]
            unexplained = unexplained[:0]
        res["envs_failing"] = len(unexplained)
        ok = (bool(torch.isfinite(o_k.qpos).all()) and q_ok and grf_p95 < 0.04 and len(unexplained) == 0
              and counts_equal and net_share > 0.5 and (n_terrain > 0 or terrain is None))
        if not ok:  # the refused envs and the env of the largest qpos error
            res["inputs_saved"] = dump_inputs(f"{name}_B{batch}_nets{'' if params is env.motor_params else '_scaled'}", args, kw, torch.cat([unexplained, torch.tensor([res["worst_env"]["env"]], device=dev)]))
        if full_gate:
            neutral = env.neutral_pose.expand(batch, -1)
            (s_k, m_k), (s_p, m_p) = out_k, out_p
            for _ in range(20):
                s_k, m_k = sk.pd_substeps_kernel(model, st.dyn, s_k, neutral, env.frame_skip, env.sim_dt, terrain, reuse_interval=reuse,
                                                 motor=(params, m_k))
                torch.cuda.synchronize()
                s_p, m_p = plain32(model, st.dyn, s_p, neutral, env.frame_skip, env.sim_dt, terrain, reuse_interval=reuse,
                                                       motor=(params, m_p))
                torch.cuda.synchronize()
            fn_k = torch.sum(s_k.contact.force[..., 0] * s_k.contact.mask, dim=1)
            fn_p = torch.sum(s_p.contact.force[..., 0] * s_p.contact.mask, dim=1)
            weight = float(np.sum(model.np("body_mass")) * 9.81)
            res.update(settled_dz=float((s_k.qpos[:, 2] - s_p.qpos[:, 2]).abs().max()), settled_qpos_maxerr=float((s_k.qpos - s_p.qpos).abs().max()),
                       settled_grf_relerr=float(((fn_k - fn_p).abs() / (fn_p.abs() + 1.0)).max()),
                       grf_vs_weight=abs(float(fn_k.mean()) - weight) / weight, settled_counts_equal=bool((m_k.count == m_p.count).all()))
            ok = (ok and res["settled_dz"] < 2e-3 and res["settled_qpos_maxerr"] < 8e-3 and res["settled_grf_relerr"] < 0.02
                  and res["grf_vs_weight"] < 0.03 and res["settled_counts_equal"])
        t0 = time.time()
        res["ms"] = time_ms(lambda: sk.pd_substeps_kernel(*args, **kw), reps_kernel)
        res["plain_ms"] = time_ms(lambda: batched.pd_substeps_batched(*args, **kw), reps_plain, warm=False)
        # the layout transposes of the wrapper, timed apart (they are part of
        # "ms"): batch-leading histories into the kernel's joint-major
        # blocks, and the kernel's output views back into batch-leading
        # tensors (what the rollout's auto-reset select writes)
        res["transpose_in_ms"] = time_ms(lambda: sk.motor_blocks(params, mstate, dev), reps_kernel)
        res["transpose_out_ms"] = time_ms(lambda: (out_k[1].qdot_hist.contiguous(), out_k[1].ctau_hist.contiguous()), reps_kernel)
        spent["timing"] = spent.get("timing", 0.0) + time.time() - t0
        flops = (sk.flops_per_env_substep(model, reuse, hfield=hfield_shape is not None) * env.frame_skip * batch
                 + sk.motor_flops_per_net(params) * runs)
        nbytes = sk.bytes_per_launch(model, batch, hfield_shape, motor=params)
        res.update(flops=flops, bytes=nbytes, bound_ms=1e3 * max(flops / F32_PEAK, nbytes / HBM_BPS),
                   bound_by="operations" if flops / F32_PEAK >= nbytes / HBM_BPS else "bytes")
        res["max_abs_err"] = max(cmp[f]["max_abs_err"] for f in abs_fields)
        return ok, res

    for c in sk.counters.values():  # the comparisons' launches are not the main paths'
        c.reset()
    num_envs, rollout = 32768, 16
    cmp_results = {}
    results = {}  # every phase 3 and phase 4 result, for chip_smoke_results.json
    out_dir = os.environ.get("LHW_SMOKE_OUT", "smoke_out")

    def save_results():
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_results.json"), "w") as f:
            json.dump(results, f, indent=1, default=str)

    for name in paths:
        for batch, seed, full_gate, reps_kernel, reps_plain in ((4096, 0, True, 10, 1), (num_envs, 10, False, 5, 1)):
            if name in MOTOR_KERNELS:
                # the env's nets (timed), then the scaled nets (a correctness check only)
                for nets, params, gate, reps in (("config nets", None, full_gate, (reps_kernel, reps_plain)),
                                                 (f"std {NET_STD} nets", scaled_nets(seed + 1), False, (1, 1))):
                    if params is not None and name != "K4" and batch == num_envs:
                        continue  # K5 and K6 take the scaled nets at B=4096
                    ok, res = check_motor_launch(name, batch, seed, gate, *reps, params=params,
                                                 per_env_rule=name == "K4" or batch < num_envs)
                    key = name if params is None else f"{name} scaled"
                    cmp_results[(key, batch)] = dict(step=res, max_abs_err=res["max_abs_err"])
                    results[f"phase 3 {key} B={batch}"] = res
                    save_results()
                    log(f"phase 3 {name} ({paths[name]}, {nets}) vs plain, B={batch}: {'PASS' if ok else 'FAIL'} {json.dumps(res)}")
                    log(f"phase 3 {name} {nets} B={batch} step {res['ms']:.1f} ms (bound {res['bound_ms']:.4f} ms, {res['bound_by']}; plain "
                        f"{res['plain_ms']:.1f} ms; history transposes in {res['transpose_in_ms']:.2f} ms, out {res['transpose_out_ms']:.2f} ms) | "
                        f"net ran in {res['net_share']:.3f} of env-substeps, MLP share of the torque {res['net_tau_share']:.3g} | terrain "
                        f"contacts {res['terrain_contacts']} | envs failing the rule {res['envs_failing_rule']}, with the roles swapped "
                        f"{res['envs_failing_mirrored']}, not admitted {res['envs_failing']} | counts equal {res['counts_equal']}"
                        + (f" | part 1 alone (the rule reported): envs apart by 5e-3 or more {json.dumps(res['part1_envs_apart'])}"
                           if "part1_envs_apart" in res else "")
                        + (f" | {name} admission {json.dumps(res['admission'])}" if "admission" in res else ""))
                    if not ok:
                        raise RuntimeError(f"{name} disagrees with its plain version at B={batch} ({nets})")
                continue
            ok, res = check_launches(name, batch, seed, full_gate, reps_kernel, reps_plain)
            cmp_results[(name, batch)] = res
            results[f"phase 3 {name} B={batch}"] = res
            log(f"phase 3 {name} ({paths[name]}) vs plain, B={batch}: {'PASS' if ok else 'FAIL'} {json.dumps(res)}")
            summary = " | ".join(
                f"{launch} {res[launch]['ms']:.1f} ms (bound {res[launch]['bound_ms']:.4f} ms, {res[launch]['bound_by']}; "
                f"plain {res[launch]['plain_ms']:.1f} ms; terrain contacts {res[launch]['terrain_contacts']})"
                for launch in ("step", "settle")
            )
            log(f"phase 3 {name} B={batch} times: {summary}")
            for launch in ("step", "settle"):
                r = res[launch]
                log(f"phase 3 {name} B={batch} {launch}: envs failing the rule {r['envs_failing_rule']}, "
                    f"with the roles swapped {r['envs_failing_mirrored']}, not admitted {r['envs_failing']}"
                    + (f" | {name} admission {json.dumps(r['admission'])}" if "admission" in r else ""))
            if not ok:
                raise RuntimeError(f"{name} disagrees with its plain version at B={batch}")

    # ---- phase 3: K1 on Unitree H1 ------------------------------------------
    h1_env = make_env("h1", device=dev)
    # part 2 of the gate (20 steps holding the neutral pose) runs on the
    # launch with randomization off, held to float64 (settle_vs_f64): under
    # its config's PD gains (ankle kp 20) H1 does not stand but sinks and
    # tips over within the 0.5 s (the settled height range and tilt are
    # printed), so bench.py's statics limits, for a robot at rest, are
    # reported only. The config's frictionloss makes some envs chaotic (check_launches):
    # there an env may be admitted with the velocity witnesses, at most
    # twice as many as the plain version fails against the kernel. With the
    # frictionloss at 0 (every other randomization and the wrenches kept)
    # and with the randomization off, the admission is K2's and K3's.
    for batch, seed, dyn_mode, full_gate, reps_kernel, reps_plain in (
        (4096, 20, "perturbed", False, 10, 1), (num_envs, 30, "perturbed", False, 5, 1),
        (4096, 20, "no friction", False, 10, 1), (4096, 40, "off", True, 10, 1),
        (1, 50, "perturbed", False, 10, 1), (3, 60, "perturbed", False, 10, 1),
    ):
        chaotic = dyn_mode == "perturbed"
        ok, res = check_launches("K1", batch, seed, full_gate, reps_kernel, reps_plain, env=h1_env, dyn_mode=dyn_mode, admit=True,
                                 mirrored_cap=chaotic, vel_witness=chaotic, part2_vs_f64=True)
        key = f"K1 h1 {dyn_mode.replace(' ', '-')}"
        cmp_results[(key, batch)] = res
        results[f"phase 3 {key} B={batch}"] = res
        save_results()
        brief = {launch: {f: (r["envs_failing"], round(r["worst_share_of_limit"], 3)) for f, r in res[launch]["fields"].items()}
                 for launch in ("step", "settle")}
        log(f"phase 3 K1 (h1, dynamics {dyn_mode}) vs plain, B={batch}: {'PASS' if ok else 'FAIL'} | qpos max err "
            f"{res['step']['qpos_maxerr']:.3g}, GRF p95 {res['step']['grf_relerr_p95']:.3g} | per field (envs failing the rule, "
            f"worst share of its limit): {json.dumps(brief)}"
            + (" | part 2, bench.py's statics limits (reported): " + json.dumps({k: res["step"][k] for k in (
                "settled_dz", "settled_qpos_maxerr", "settled_grf_relerr", "grf_vs_weight", "settled_z", "settled_tilt_max_deg")})
               if full_gate else ""))
        if full_gate:
            p2 = res["step"]["part2_vs_f64"]
            log(f"phase 3 K1 h1 {dyn_mode} B={batch} part 2 held to float64: {'PASS' if ok else 'FAIL'} | env-launches failing "
                f"the rule {p2['envs_failing_rule']}, admitted {p2['admitted']} (cap {p2['cap']}), refused {p2['refused']} | per step "
                f"(step, envs failing the rule, worst share of the limit, active contacts): "
                + json.dumps([(e["step"], e["envs_failing_rule"], round(e["worst_share"], 3), e["active_contacts"]) for e in p2["steps"]])
                + " | failing envs (step, env, [share vs plain, field], [share vs ensemble, field], admitted): "
                + json.dumps([(e["step"], r["env"], [round(r["vs_plain"][0], 2), r["vs_plain"][1]],
                               [round(r["vs_ensemble"][0], 3), r["vs_ensemble"][1]], k == "admitted")
                              for e in p2["steps"] for k in ("admitted", "refused") for r in e[k]])
                + " | free-running 20 steps vs float64 (qpos max abs, total normal GRF relative: median, p99, max over envs): "
                + json.dumps(p2["free_running"]))
        log(f"phase 3 K1 h1 {dyn_mode} B={batch} times: " + " | ".join(
            f"{launch} {res[launch]['ms']:.2f} ms (bound {res[launch]['bound_ms']:.4f} ms, {res[launch]['bound_by']}; "
            f"plain {res[launch]['plain_ms']:.1f} ms; active contacts {res[launch]['terrain_contacts']}; "
            f"xfrc in {res[launch]['dyn']['xfrc_env_share']:.3f} of envs, masses randomized in {res[launch]['dyn']['randomized_mass_env_share']:.3f})"
            for launch in ("step", "settle")))
        for launch in ("step", "settle"):
            r = res[launch]
            adm = r.get("admission", {})
            rows = [(a["env"], a["vs_plain"][1], round(a["vs_plain"][0], 2), round(a["vs_second_witness"][0], 3),
                     round(a["replay_share"], 3), a["contact_switches"], a["admitted"]) for a in adm.get("admitted", [])]
            log(f"phase 3 K1 h1 {dyn_mode} B={batch} {launch}: envs failing the rule {r['envs_failing_rule']}, "
                f"with the roles swapped {r['envs_failing_mirrored']}, not admitted {r['envs_failing']}, worst act_torque "
                f"distance from float64 {r['fields']['act_torque']['max_abs_err_vs_f64']:.3g} N m"
                + (f" | admission cap {adm['cap']}; (env, field, share vs plain, vs second witness, replay share, contact "
                   f"switches, admitted): {json.dumps(rows)}; replay of passing envs {json.dumps(adm.get('replay_share_passing_envs'))}"
                   if adm else ""))
        if dyn_mode != "off" and batch >= 4096:
            ok = ok and res["step"]["dyn"]["xfrc_env_share"] >= 0.5 and res["step"]["dyn"]["randomized_mass_env_share"] > 0.99
        if not ok:
            raise RuntimeError(f"K1 disagrees with its plain version on h1 at B={batch} (dynamics {dyn_mode})")

    # the model-table cache holds both robots: jvrc_walk, h1, jvrc_walk again
    def k1_step(env, batch, seed):
        st, *_ = seeded_reset(env, batch, seed)
        target = env.neutral_pose.expand(batch, -1)
        return sk.pd_substeps_kernel(env.model, st.dyn, st.physics, target, env.frame_skip, env.sim_dt, reuse_interval=env.physics_reuse)

    first = k1_step(envs["K1"], 4096, 70)
    other = k1_step(h1_env, 4096, 71)
    again = k1_step(envs["K1"], 4096, 70)
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(first, f), getattr(again, f)) for f in ("qpos", "qvel", "qacc", "act_torque", "xpos"))
    flat_tables = sum(1 for (_, d) in sk._DEVICE_TABLES if d.startswith("cuda"))
    log(f"phase 3 model tables: jvrc_walk, h1, jvrc_walk launches in turn: the two jvrc_walk outputs equal {same}, "
        f"h1 output shape {tuple(other.qpos.shape)}, device table sets cached {flat_tables}")
    if not same or other.qpos.shape[1] != h1_env.model.nq:
        raise RuntimeError("K1 launches of two robots in turn did not each read their own model tables")

    results["phase 3 seconds by kind"] = spent
    log("phase 3 seconds by kind of work: " + json.dumps({k: round(v, 1) for k, v in spent.items()}))

    # ---- phase 4: the training paths --------------------------------------
    path_launches, ok_all = {}, True
    for name, n_itr in (("K1", 3), ("K2", 2), ("K3", 2), ("K4", 2)):
        env = envs[name]
        cfg = PPOConfig(num_envs=num_envs, rollout_len=rollout, minibatch_size=32768, seed=0, net_dtype="bfloat16")
        trainer = PPO(env, cfg, device=dev)
        torch.cuda.reset_peak_memory_stats()

        def on_iteration(itr, m, name=name):
            log(
                f"phase 4 {paths[name]} itr {itr}: sampling {m['sample_env_steps_per_s']:,.0f} env-steps/s "
                f"({m['sample_time']:.2f} s) | optimize {m['optimize_time']:.2f} s | mean reward {m['mean_reward']:.4f} | "
                f"actor {m['actor_loss']:.4f} critic {m['critic_loss']:.4f} mirror {m['mirror_loss']:.5f} | "
                f"{name} launches so far {sk.counters[name].launches}"
            )

        for c in sk.counters.values():
            c.reset()
        ts0 = trainer.init_state()  # initial reset_batch: one settle launch
        init_launches = {k: c.launches for k, c in sk.counters.items()}
        ts, history = trainer.train(n_itr, ts=ts0, verbose=False, on_iteration=on_iteration, evaluate=False)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in sk.counters.items()}
        # every settle (the initial reset, one reset pool per iteration) runs
        # in the path's kernel, K1 on the motor path, whose steps run in K4
        itrs = trainer.warmup_iterations() + n_itr
        settle_kernel = "K1" if name == "K4" else name
        expected = dict.fromkeys(sk.counters, 0)
        expected[name] += itrs * rollout
        expected[settle_kernel] += 1 + itrs
        losses = [m[k] for m in history for k in ("actor_loss", "critic_loss", "mirror_loss", "approx_kl")]
        obs = ts.env_state.obs
        ok_path = (
            init_launches == {k: int(k == settle_kernel) for k in sk.counters}
            and launches == expected
            and all(np.isfinite(losses))
            and tuple(obs.shape) == (num_envs, env.obs_size)
            and bool(torch.isfinite(obs).all())
        )
        motor_note = ""
        if name == "K4":
            warm = float((ts.env_state.motor.count > sk.HIST_LEN).float().mean())
            ok_path = ok_path and warm > 0.5
            motor_note = f" | share of envs with motor count > 25 at the end {warm:.4f} (expected > 0.5)"
        for k, v in launches.items():
            path_launches[k] = path_launches.get(k, 0) + v
        log(
            f"phase 4 {paths[name]}: {'PASS' if ok_path else 'FAIL'} | launches: init_state {init_launches}, in all {launches} "
            f"(expected {expected}: ({trainer.warmup_iterations()} warmup + {n_itr} iterations) x {rollout} steps in {name}, "
            f"1 + {itrs} settles in {settle_kernel}) | losses finite {all(np.isfinite(losses))} | "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB{motor_note}"
        )
        ok_all = ok_all and ok_path
        del trainer, ts, ts0
    if not ok_all:
        raise RuntimeError("a training path failed its checks")

    # ---- phase 4: the H1 paths through the port's command line --------------
    H1_TRAJ = 100  # evaluations of the H1 paths: 2 settles + 100 steps each
    logroot = tempfile.mkdtemp(prefix="lhw_chip_smoke_")
    workload = ["--num-envs", str(num_envs), "--rollout-len", str(rollout), "--minibatch-size", "32768",
                "--max-traj-len", str(H1_TRAJ), "--device", "cuda"]

    def cli_path(title: str, fn, argv, expected):
        """Run one command of the CLI with the counters at 0; check that each
        kernel launched as many times as ``expected(result)`` says: a count
        of K1's launches, or a dict of counts per kernel (every other kernel
        none)."""
        for c in sk.counters.values():
            c.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = fn(argv)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = {k: c.launches for k, c in sk.counters.items()}
        want = dict.fromkeys(sk.counters, 0)
        counted = expected(out)
        want.update({"K1": counted} if isinstance(counted, int) else counted)
        for k, v in launches.items():
            path_launches[k] = path_launches.get(k, 0) + v
        hist = out.get("history", []) if isinstance(out, dict) else []
        losses = [m[k] for m in hist for k in ("actor_loss", "critic_loss", "mirror_loss", "imitation_loss", "approx_kl")]
        ok = launches == want and all(np.isfinite(losses))
        parts = [f"{seconds:.1f} s in all", f"launches {launches} (expected {want})", f"losses finite {all(np.isfinite(losses))}",
                 f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", smi]
        for i, m in enumerate(hist):
            parts.append(
                f"itr {i}: sampling {m['sample_env_steps_per_s']:,.0f} env-steps/s ({m['sample_time']:.2f} s), optimize "
                f"{m['optimize_time']:.2f} s, eval {m.get('eval_time', 0.0):.2f} s (reward {m.get('eval_mean_reward', float('nan')):.3f}, "
                f"length {m.get('eval_mean_episode_length', float('nan')):.1f}), checkpoint save {m.get('checkpoint_time', 0.0):.3f} s, "
                f"imitation loss {m['imitation_loss']:.3g}")
        log(f"phase 4 {title}: {'PASS' if ok else 'FAIL'} | " + " | ".join(parts))
        results[f"phase 4 {title}"] = dict(seconds=seconds, launches=launches, expected=want, history=hist,
                                           peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        save_results()
        if not ok:
            raise RuntimeError(f"the command-line path {title} failed its checks")
        return out

    def train_launches(n_itr, evals, traj=H1_TRAJ):
        return 1 + n_itr * (rollout + 1) + evals * (2 + traj)

    h1_logs = os.path.join(logroot, "h1")
    h1_run = cli_path("h1 (train, 2 iterations)", cli.train, ["--env", "h1", "--logdir", h1_logs, "--n-itr", "2", *workload],
                      lambda out: train_launches(2, 2))
    saved = Checkpointer(h1_run["run_dir"])
    if sorted(p.name for p in saved.ckpt_dir.iterdir()) != ["0.pt", "1.pt", "metrics_0.json", "metrics_1.json"] or not saved.best_path.exists():
        raise RuntimeError(f"the h1 run's checkpoints are not as expected: {sorted(p.name for p in saved.ckpt_dir.iterdir())}")
    cont = cli_path("h1 --continued (1 iteration)", cli.train,
                    ["--env", "h1", "--logdir", os.path.join(logroot, "h1_cont"), "--continued", h1_logs, "--n-itr", "1", *workload],
                    lambda out: train_launches(1, 1))
    def restores_saved_state(env, saved, ref_ts, recurrent=False):
        """What --continued restores is the saved state, bit for bit: the
        latest checkpoint restored into a fresh trainer (no env batch: no
        launch), its networks drawn from another seed first, held to the
        state the saved run ended with; a recurrent run's carries zero."""
        cfg = PPOConfig(num_envs=num_envs, rollout_len=rollout, minibatch_size=32768, seed=5, recurrent=recurrent)
        restored = saved.restore(PPO(env, cfg, device=dev).init_networks())
        same = (all(torch.equal(a, b) for a, b in zip(restored.actor.state_dict().values(), ref_ts.actor.state_dict().values()))
                and all(torch.equal(a, b) for a, b in zip(restored.critic.state_dict().values(), ref_ts.critic.state_dict().values()))
                and all(torch.equal(a, b) for o, r in ((restored.actor_opt, ref_ts.actor_opt), (restored.critic_opt, ref_ts.critic_opt))
                        for a, b in zip(o.mu + o.nu + [o.count, o.notfinite_count], r.mu + r.nu + [r.count, r.notfinite_count]))
                and all(torch.equal(getattr(restored.norm, f), getattr(ref_ts.norm, f)) for f in ("mean", "var", "count"))
                and restored.iteration == ref_ts.iteration)
        if recurrent:
            same = same and all(float(x.abs().max()) == 0 for pair in restored.actor_carry + restored.critic_carry for x in pair)
        return same, restored.iteration

    ref_ts = h1_run["ts"]
    same, restored_itr = restores_saved_state(h1_env, saved, ref_ts)
    same = same and restored_itr == cont["resumed_at"] == 2 and cont["ts"].iteration == 3
    log(f"phase 4 h1 resume: restored params, Adam states, norm and iteration equal the saved ones {same} "
        f"(iteration {restored_itr}, resumed at {cont['resumed_at']}, ended at {cont['ts'].iteration})")
    if not same:
        raise RuntimeError("--continued did not restore the saved state")
    del cont
    npz = os.path.join(logroot, "h1_eval.npz")
    ev = cli_path("h1 eval --path (2 episodes)", cli.evaluate, ["--path", str(h1_run["run_dir"]), "--episodes", "2",
                  "--max-steps", str(H1_TRAJ), "--out", npz, "--device", "cuda"], lambda out: 1 + out["steps"])
    data = np.load(npz)
    shapes = {k: data[k].shape for k in data.files}
    if shapes != {f"episode_{i}": (ev["lengths"][i], h1_env.model.nq) for i in range(2)} or not all(np.isfinite(data[k]).all() for k in data.files):
        raise RuntimeError(f"eval wrote {shapes}, lengths {ev['lengths']}")
    log(f"phase 4 h1 eval: .npz {shapes}, episode rewards {ev['rewards']}, lengths {ev['lengths']}")
    del h1_run
    walk_logs = os.path.join(logroot, "h1_walk")
    cli_path("h1_walk (train, 2 iterations)", cli.train, ["--env", "h1_walk", "--logdir", walk_logs, "--n-itr", "2", *workload],
             lambda out: train_launches(2, 2))
    imit = cli_path("h1_walk --imitate (1 iteration)", cli.train,
                    ["--env", "h1_walk", "--logdir", os.path.join(logroot, "h1_walk_imitate"), "--imitate", walk_logs,
                     "--seed", "1", "--n-itr", "1", *workload], lambda out: train_launches(1, 1))
    imit_loss = imit["history"][0]["imitation_loss"]
    if not (np.isfinite(imit_loss) and imit_loss > 0):
        raise RuntimeError(f"--imitate gave an imitation loss of {imit_loss}")
    del imit

    # ---- phase 4: the terrain + motor paths and the mjcf: env through the command line
    # jvrc_step and jvrc_walk_rough with the motor config: steps (training
    # and evaluation) in K5 / K6, every settle (initial reset, reset pools,
    # evaluation resets) in K2 / K3
    NEW_TRAJ = 20  # evaluations of the paths below: 2 settles + 20 steps each
    jvrc_env = envs["K1"]
    new_workload = [*workload[:-4], "--max-traj-len", str(NEW_TRAJ), "--device", "cuda"]
    for env_name, step_kernel, settle_kernel in (("jvrc_step", "K5", "K2"), ("jvrc_walk_rough", "K6", "K3")):
        run = cli_path(f"{env_name} --json jvrc_motor.json (train, 2 iterations)", cli.train,
                       ["--env", env_name, "--json", motor_json, "--logdir", os.path.join(logroot, env_name + "_motor"), "--n-itr", "2",
                        *new_workload],
                       lambda out, sk_=step_kernel, st_=settle_kernel: {sk_: 2 * rollout + 2 * NEW_TRAJ, st_: 1 + 2 + 2 * 2, "K1": 0})
        warm = float((run["ts"].env_state.motor.count > sk.HIST_LEN).float().mean())
        log(f"phase 4 {env_name} + motor: share of envs with motor count > 25 at the end {warm:.4f} (expected > 0.5)")
        if not warm > 0.5:
            raise RuntimeError(f"{env_name} with the motor config: the motor nets ran in too few envs")
        del run

    # the mjcf: env on JVRC-1 exported by the port's own export_mjcf, with a
    # robot file holding jvrc_walk's gains, pose, feet and mirror lists: its
    # tables equal jvrc_walk's bit for bit, one K1 launch on each model from
    # one state gives equal outputs, and it trains through K1 after the
    # running norm's warmup
    os.makedirs(out_dir, exist_ok=True)
    robot_xml = os.path.abspath(os.path.join(out_dir, "jvrc_export.xml"))
    robot_json = os.path.abspath(os.path.join(out_dir, "jvrc_robot.json"))
    with open(robot_xml, "w") as f:
        f.write(export_mjcf(jvrc_model.jvrc_spec()))
    jvrc_cfg = jvrc_env.cfg
    with open(robot_json, "w") as f:
        json.dump(dict(kp=list(jvrc_cfg.kp), kd=list(jvrc_cfg.kd), half_sitting_pose=list(jvrc_cfg.half_sitting_pose),
                       robot=dict(left_foot_geoms=["L_foot"], right_foot_geoms=["R_foot"], root_body=jvrc_env.ROOT_BODY,
                                  head_body=jvrc_env.HEAD_BODY, lfoot_body=jvrc_env.LFOOT_BODY, rfoot_body=jvrc_env.RFOOT_BODY,
                                  nominal_height=jvrc_model.NOMINAL_HEIGHT, mirrored_obs=jvrc_env.mirrored_obs[:jvrc_env.robot_state_len],
                                  mirrored_acts=jvrc_env.mirrored_acts)), f)
    mjcf_env = make_env(f"mjcf:{robot_xml}", robot_json, device=dev)
    flat_lay = sk._library("flat")[1]
    tables_equal = all(np.array_equal(a, b) for a, b in zip(sk.build_tables(mjcf_env.model, flat_lay), sk.build_tables(jvrc_env.model, flat_lay)))
    st_m, *_ = seeded_reset(jvrc_env, 4096, 80)
    target_m = jvrc_env.neutral_pose + 0.05 * torch.randn((4096, jvrc_env.model.nu), generator=torch.Generator(device=dev).manual_seed(81),
                                                          device=dev)
    one = [sk.pd_substeps_kernel(e.model, st_m.dyn, st_m.physics, target_m, e.frame_skip, e.sim_dt, reuse_interval=e.physics_reuse)
           for e in (jvrc_env, mjcf_env)]
    torch.cuda.synchronize()
    launch_equal = all(torch.equal(getattr(one[0], f), getattr(one[1], f)) for f in ("qpos", "qvel", "qacc", "act_torque", "xpos", "xquat", "cvel"))
    launch_equal = launch_equal and all(torch.equal(getattr(one[0].contact, f), getattr(one[1].contact, f)) for f in ("force", "mask", "dist", "pos"))
    ok_mjcf = (tables_equal and launch_equal and mjcf_env.obs_mean is None and mjcf_env.obs_size == jvrc_env.obs_size
               and mjcf_env.mirrored_obs == jvrc_env.mirrored_obs and mjcf_env.physics_reuse == jvrc_env.physics_reuse)
    log(f"phase 4 mjcf: env (JVRC-1 from {robot_xml}): {'PASS' if ok_mjcf else 'FAIL'} | model tables equal jvrc_walk's bit for bit "
        f"{tables_equal} | one K1 launch from one state, outputs equal {launch_equal} | running norm {mjcf_env.obs_mean is None}, "
        f"obs {mjcf_env.obs_size}, mirror lists as jvrc_walk's {mjcf_env.mirrored_obs == jvrc_env.mirrored_obs}")
    if not ok_mjcf:
        raise RuntimeError("the mjcf: env does not rebuild jvrc_walk's model")
    del one, st_m, mjcf_env
    warm_iters = PPOConfig().input_norm_iters
    mjcf_run = cli_path(f"mjcf: jvrc (train, {warm_iters} warmup + 2 iterations)", cli.train,
                        ["--env", f"mjcf:{robot_xml}", "--json", robot_json, "--logdir", os.path.join(logroot, "mjcf"), "--n-itr", "2",
                         *new_workload], lambda out: 1 + (warm_iters + 2) * (rollout + 1) + 2 * (2 + NEW_TRAJ))
    count, warm_count = float(mjcf_run["ts"].norm.count), 1e-4 + warm_iters * rollout * num_envs
    mirror = [m["mirror_loss"] for m in mjcf_run["history"]]
    ok_norm = abs(count - warm_count) <= 1.0 and bool(torch.isfinite(mjcf_run["ts"].norm.var).all()) and all(m > 0 for m in mirror)
    log(f"phase 4 mjcf: jvrc: norm count {count:.1f} (expected {warm_count:.1f} after the warmup), mirror losses {mirror} "
        f"{'PASS' if ok_norm else 'FAIL'}")
    if not ok_norm:
        raise RuntimeError("the mjcf: env's observation-norm warmup or mirror loss did not run as expected")
    mjcf_meta = Checkpointer.load_experiment(mjcf_run["run_dir"])
    mjcf_ev = cli_path("mjcf: jvrc eval --path (2 episodes)", cli.evaluate,
                       ["--path", str(mjcf_run["run_dir"]), "--episodes", "2", "--max-steps", str(NEW_TRAJ), "--device", "cuda"],
                       lambda out: 1 + out["steps"])
    log(f"phase 4 mjcf: jvrc eval: experiment.json env {mjcf_meta['env']}, json {mjcf_meta['json']} | episode rewards "
        f"{mjcf_ev['rewards']}, lengths {mjcf_ev['lengths']}")
    del mjcf_run

    # the rangefinder on the card, on jvrc_step states (stepping stones under
    # the pelvis), against the same function on the CPU
    st_r, *_ = seeded_reset(envs["K2"], 4096, 90)
    rays = envs["K2"].rangefinder(st_r)
    rays_cpu = rangefinder.rangefinder(*(x.cpu() for x in (st_r.physics.xpos[:, envs["K2"].root_idx], st_r.physics.xquat[:, envs["K2"].root_idx])),
                                       tree_map(to_cpu, envs["K2"]._terrain(st_r.task)), rangefinder.site_grid())
    # the same rays against the floor plane alone: a ray that ends on a box is shorter
    terrain_r = envs["K2"]._terrain(st_r.task)
    floor_only = dataclasses.replace(terrain_r, pos=terrain_r.pos[:, :0], size=terrain_r.size[:, :0], yaw=terrain_r.yaw[:, :0])
    rays_floor = rangefinder.rangefinder(st_r.physics.xpos[:, envs["K2"].root_idx], st_r.physics.xquat[:, envs["K2"].root_idx], floor_only,
                                         rangefinder.site_grid())
    ray_err = float((rays.cpu() - rays_cpu).abs().max())
    on_stones = int((rays < rays_floor - 1e-3).sum())
    ok_rays = tuple(rays.shape) == (4096, 16) and bool(torch.isfinite(rays).all()) and ray_err <= 1e-5 and on_stones > 0
    results["phase 4 rangefinder"] = dict(max_abs_err_vs_cpu=ray_err, rays_shortened_by_boxes=on_stones)
    log(f"phase 4 rangefinder (jvrc_step, B=4096, 4x4 rays): {'PASS' if ok_rays else 'FAIL'} | shape {tuple(rays.shape)}, card vs CPU "
        f"max abs {ray_err:.3g} m (limit 1e-5), rays ending on a box before the floor {on_stones}, distances "
        f"{float(rays.min()):.3f} .. {float(rays.max()):.3f} m")
    if not ok_rays:
        raise RuntimeError("the rangefinder on the card is not as on the CPU")
    del st_r, rays

    # ---- phase 4: recurrent PPO on jvrc_walk through the command line -------
    # each recurrent rollout of the runs below records whether the carries
    # it starts from are all zero and the done mask of its last step
    rollouts = []
    rollout_recurrent = PPO._rollout_recurrent

    def recording_rollout(self, ts, deterministic):
        env_state, traj = rollout_recurrent(self, ts, deterministic)
        start_zero = all(float(x.abs().max()) == 0 for pair in ts.actor_carry + ts.critic_carry for x in pair)
        rollouts.append(dict(start_zero=start_zero, done_last=traj["done"][-1]))
        return env_state, traj

    PPO._rollout_recurrent = recording_rollout
    rec_logs = os.path.join(logroot, "jvrc_walk_rec")
    try:
        rec_run = cli_path("jvrc_walk --recurrent (train, 2 iterations)", cli.train,
                           ["--env", "jvrc_walk", "--recurrent", "--logdir", rec_logs, "--n-itr", "2", *workload],
                           lambda out: train_launches(2, 2))
        rec_ts, done_last = rec_run["ts"], rollouts[-1]["done_last"]
        # after the last rollout the carry rows of the envs that finished at
        # its last step are exactly zero (zeroed, as at every episode end),
        # and those of every other env are not
        zero_done = all(bool((x[done_last] == 0).all()) for pair in rec_ts.actor_carry + rec_ts.critic_carry for x in pair)
        nonzero_rest = all(bool((x[~done_last].abs().amax(1) > 0).all())
                           for pair in rec_ts.actor_carry + rec_ts.critic_carry for x in pair)
        finite = all(bool(torch.isfinite(x).all()) for pair in rec_ts.actor_carry + rec_ts.critic_carry for x in pair)
        ok_carry = len(rollouts) == 2 and rollouts[0]["start_zero"] and zero_done and nonzero_rest and finite
        log(f"phase 4 jvrc_walk --recurrent carries: {'PASS' if ok_carry else 'FAIL'} | {len(rollouts)} rollouts, the first from "
            f"zero carries {rollouts[0]['start_zero']} | after the last, {int(done_last.sum())} envs done at its last step: their "
            f"rows zero {zero_done}, every other env's row non-zero {nonzero_rest} | finite {finite} | layers "
            f"{[tuple(c.shape) for c, _ in rec_ts.actor_carry]}")
        if not ok_carry:
            raise RuntimeError("the recurrent rollout's carries are not masked at episode ends as expected")
        rec_saved = Checkpointer(rec_run["run_dir"])
        rollouts.clear()
        rec_cont = cli_path("jvrc_walk --recurrent --continued (1 iteration)", cli.train,
                            ["--env", "jvrc_walk", "--recurrent", "--logdir", os.path.join(logroot, "jvrc_walk_rec_cont"),
                             "--continued", rec_logs, "--n-itr", "1", *workload], lambda out: train_launches(1, 1))
    finally:
        PPO._rollout_recurrent = rollout_recurrent
    same, restored_itr = restores_saved_state(jvrc_env, rec_saved, rec_ts, recurrent=True)
    start_zero = len(rollouts) == 1 and rollouts[0]["start_zero"]
    same = same and start_zero and restored_itr == rec_cont["resumed_at"] == 2 and rec_cont["ts"].iteration == 3
    log(f"phase 4 jvrc_walk --recurrent resume: restored params, Adam states, norm and iteration equal the saved ones and "
        f"the resumed run's rollout started from zero carries: {same} ({len(rollouts)} rollouts, from zero carries {start_zero}; "
        f"resumed at {rec_cont['resumed_at']}, ended at {rec_cont['ts'].iteration})")
    if not same:
        raise RuntimeError("--continued did not restore the recurrent run's saved state")
    del rec_cont
    rec_npz = os.path.join(logroot, "jvrc_walk_rec_eval.npz")
    rec_ev = cli_path("jvrc_walk --recurrent eval --path (2 episodes)", cli.evaluate,
                      ["--path", str(rec_run["run_dir"]), "--episodes", "2", "--max-steps", str(H1_TRAJ), "--out", rec_npz,
                       "--device", "cuda"], lambda out: 1 + out["steps"])
    data = np.load(rec_npz)
    if sorted(data.files) != ["episode_0", "episode_1"] or not all(np.isfinite(data[k]).all() for k in data.files):
        raise RuntimeError(f"recurrent eval wrote {data.files}")
    log(f"phase 4 jvrc_walk --recurrent eval: episode rewards {rec_ev['rewards']}, lengths {rec_ev['lengths']}")
    del rec_run, rec_ts

    # ---- phase 4: the LSTM nets on the card against the CPU ----------------
    LSTM_B, LSTM_T = 2048, 16
    gen = torch.Generator().manual_seed(7)
    nets_cpu = (networks.GaussianLSTMActor(jvrc_env.obs_size, jvrc_env.action_size, gen=gen),
                networks.LSTMCritic(jvrc_env.obs_size, gen=gen))
    nets_dev = tuple(copy.deepcopy(net).to(dev) for net in nets_cpu)
    rng = np.random.default_rng(8)
    obs = torch.as_tensor(rng.standard_normal((LSTM_T, LSTM_B, jvrc_env.obs_size)).astype(np.float32))
    done = torch.as_tensor(rng.random((LSTM_T, LSTM_B)) < 0.05)
    hidden = tuple(c.hh.weight.shape[1] for c in nets_cpu[0].core.cells)
    carries_cpu = [networks.LSTMCore.initial_carry(hidden, (LSTM_B,)) for _ in nets_cpu]
    carries_dev = [networks.LSTMCore.initial_carry(hidden, (LSTM_B,), dev) for _ in nets_cpu]
    worst = {}

    def rel_err(a, b) -> float:
        return float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    with torch.no_grad():
        for t in range(LSTM_T):
            for k, net in enumerate(nets_cpu):
                carries_cpu[k], out_c = net(mask_carry(carries_cpu[k], done[t]), obs[t])
                carries_dev[k], out_d = nets_dev[k](mask_carry(carries_dev[k], done[t].to(dev)), obs[t].to(dev))
                outs = zip(out_d, out_c) if k == 0 else [(out_d, out_c)]
                for j, (a, b) in enumerate(outs):
                    key = ("mean", "log_std")[j] if k == 0 else "value"
                    worst[key] = max(worst.get(key, 0.0), rel_err(a, b))
                for (cd, hd), (cc, hc) in zip(carries_dev[k], carries_cpu[k]):
                    worst["carries"] = max(worst.get("carries", 0.0), rel_err(cd, cc), rel_err(hd, hc))
    ok_lstm = all(v <= 1e-5 for v in worst.values())
    results["phase 4 LSTM card vs CPU"] = worst
    log(f"phase 4 LSTM 2x{hidden[0]} actor and critic, {LSTM_T} steps of {LSTM_B} envs with resets, float32 (TF32 off), "
        f"card vs CPU: {'PASS' if ok_lstm else 'FAIL'} | worst error relative to each quantity's largest magnitude "
        f"{json.dumps(worst)} (limit 1e-5)")
    if not ok_lstm:
        raise RuntimeError("the LSTM nets on the card left the CPU's by more than 1e-5")
    del nets_cpu, nets_dev, carries_cpu, carries_dev

    # ---- phase 4: cartpole through the command line (no kernel) -------------
    CART_B = 4096
    cart_workload = ["--num-envs", str(CART_B), "--rollout-len", str(rollout), "--minibatch-size", "32768",
                     "--max-traj-len", str(H1_TRAJ), "--device", "cuda"]
    warm_count = 1e-4 + 5 * rollout * CART_B  # 5 warmup iterations of the running norm
    for flag in ([], ["--recurrent"]):
        title = "cartpole" + (" --recurrent" if flag else "") + " (train, 5 warmup + 2 iterations)"
        out = cli_path(title, cli.train, ["--env", "cartpole", *flag, "--logdir", os.path.join(logroot, "cartpole" + "".join(flag)),
                                          "--n-itr", "2", *cart_workload], lambda out: 0)
        count = float(out["ts"].norm.count)
        ok_norm = abs(count - warm_count) <= 1.0 and bool(torch.isfinite(out["ts"].norm.var).all())
        log(f"phase 4 {title}: norm count {count:.1f} (expected {warm_count:.1f} after the warmup) {'PASS' if ok_norm else 'FAIL'}")
        if not ok_norm:
            raise RuntimeError(f"{title}: the observation-norm warmup did not run as expected")
        del out

    # one control step of cartpole (4 substeps of engine_step_b) on the card,
    # held to a float64 run of the same function on the CPU
    cart = make_env("cartpole", device=dev)
    cgen = torch.Generator(device=dev)
    cgen.manual_seed(11)
    cstate = cart.reset_batch(CART_B, Draws(cgen))
    caction = 0.5 * torch.randn((CART_B, 1), generator=cgen, device=dev)
    cout = cart.step_batch(cstate, caction)
    to64 = lambda x: x.detach().cpu().double() if torch.is_tensor(x) and x.is_floating_point() else (x.cpu() if torch.is_tensor(x) else x)
    prev_dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        cart64 = make_env("cartpole", device="cpu")
        cart64.model = tree_map(to64, cart64.model)
        cout64 = cart64.step_batch(tree_map(to64, cstate), to64(caction))
    finally:
        torch.set_default_dtype(prev_dtype)
    cart_err = {}
    for name, a, b in (("qpos", cout.physics.qpos, cout64.physics.qpos), ("qvel", cout.physics.qvel, cout64.physics.qvel),
                       ("qacc", cout.physics.qacc, cout64.physics.qacc), ("obs", cout.obs, cout64.obs),
                       ("reward_components", cout.reward_components, cout64.reward_components)):
        cart_err[name] = float((a.cpu().double() - b).abs().max()) / max(float(b.abs().max()), 1.0)
    ok_cart = all(v <= 1e-5 for v in cart_err.values()) and cout.done.cpu().tolist() == cout64.done.tolist()
    results["phase 4 cartpole engine_step_b vs float64"] = cart_err
    log(f"phase 4 cartpole engine_step_b, one control step at B={CART_B}, card float32 vs CPU float64: "
        f"{'PASS' if ok_cart else 'FAIL'} | worst error over max(1, largest magnitude) {json.dumps(cart_err)} (limit 1e-5)")
    if not ok_cart:
        raise RuntimeError("cartpole's engine_step_b on the card left float64")
    save_results()

    # ---- phase 4: the profiler hook on h1 ------------------------------------
    prof_dir = os.path.join(logroot, "h1_profile")
    PROF_TRAJ = 20
    cli_path("h1 --profile-dir (3 iterations)", cli.train,
             ["--env", "h1", "--logdir", os.path.join(logroot, "h1_prof_run"), "--n-itr", "3", "--profile-dir", prof_dir,
              *workload[:-4], "--max-traj-len", str(PROF_TRAJ), "--device", "cuda"], lambda out: train_launches(3, 2, PROF_TRAJ))
    trace = summarize_trace(os.path.join(prof_dir, "trace.json"))
    spans = trace["spans"]
    log("phase 4 profiler (iteration 2 of h1, its evaluation included): top CUDA kernels by device time "
        + json.dumps([[name[:90], ms, n] for name, ms, n in trace["top_kernels"]]) + f" | device busy {trace['device_ms']:.1f} ms | "
        + " | ".join(f"{k}: {v['count']} span(s), {v['host_ms']:.1f} ms, device idle share {v['idle_share']:.4f}" for k, v in spans.items()))
    if "ppo.iteration" not in spans or not trace["top_kernels"] or not any("control_step" in k[0] for k in trace["top_kernels"]):
        raise RuntimeError("the profiler trace holds no traced iteration or no control-step kernel")

    # ---- phase 4: eval's task markers, the viewer's stepper, data parallel ----
    runs = {name: str(find_latest_run(os.path.join(logroot, d)))
            for name, d in (("jvrc_step", "jvrc_step_motor"), ("jvrc_walk_rough", "jvrc_walk_rough_motor"), ("h1_walk", "h1_walk"))}
    markers_viewer_data_parallel(dev, logroot, runs, cli_path, jvrc_env, num_envs, rollout, smi, path_launches, results)
    save_results()
    shutil.rmtree(logroot)

    results["profiler"] = trace
    save_results()

    # ---- phase 5: kernels --------------------------------------------------
    titles = {"K1": "K1 control_step (flat floor)", "K2": "K2 control_step (terrain boxes)", "K3": "K3 control_step (heightfield)",
              "K4": "K4 control_step (motor hook, substep_kernel.py:1036)",
              "K5": "K5 control_step (terrain boxes + motor hook)", "K6": "K6 control_step (heightfield + motor hook)"}
    kernels = []
    for name in paths:
        step = cmp_results[(name, num_envs)]["step"]
        kernels.append(
            {
                "name": titles[name],
                "route": "cuda",
                "source": "learninghumanoidwalking_tpu_torch/ops/csrc/" + sk.LIBRARIES[sk.LIBRARY_OF[name]][1][0],
                "replaces": "learninghumanoidwalking_tpu/ops/substep_kernel.py:1296",
                "launches": path_launches[name],
                "max_abs_err": max(r["max_abs_err"] for (n, b), r in cmp_results.items() if n.startswith(name)),
                "ms": step["ms"],
                "plain_ms": step["plain_ms"],
                "bound_ms": step["bound_ms"],
                "bound_by": step["bound_by"],
                "library_ms": None,
            }
        )
    log(f"phase 5 kernels: {list(paths)}, launches on every path {path_launches}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
