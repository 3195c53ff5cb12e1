"""Offline trajectory rendering for evaluation videos (counterpart of
learninghumanoidwalking_tpu/rl/render.py).

The preferred path is real 3D offscreen rendering through MuJoCo + EGL on
the exported MJCF (rl/render_gl.py). Where no GL stack exists, the video
is made of matplotlib stick figures of the recorded qpos: FK gives every
body frame, segments join parent and child bodies, the foot boxes are drawn
as their sole outlines, and the task's markers are overlaid. This is the
JAX package's host-side choice of renderer; the physics is not involved.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from learninghumanoidwalking_tpu_torch.physics.batched import fk_b
from learninghumanoidwalking_tpu_torch.physics.model import tree_map
from learninghumanoidwalking_tpu_torch.physics.spec import _quat_to_mat_np
from learninghumanoidwalking_tpu_torch.rl import render_gl
from learninghumanoidwalking_tpu_torch.utils import maths

_SOLE_LOOP = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1], [-1, -1]], dtype=np.float64)


def _fk_points(env, qpos_traj: np.ndarray):
    """Body world positions (T, nbody, 3) and the foot soles' outlines
    (T, nfoot, 5, 3) of a (T, nq) trajectory: FK of all frames at once on
    the CPU, float32 as the env's model."""
    model = tree_map(lambda x: x.cpu() if torch.is_tensor(x) else x, env.model)
    xpos, xquat = fk_b(model, torch.as_tensor(np.asarray(qpos_traj), dtype=torch.float32))
    rmats = maths.quat_to_mat(xquat).numpy()
    xpos = xpos.numpy()
    geom_pos, geom_quat, geom_size = model.np("geom_pos"), model.np("geom_quat"), model.np("geom_size")
    corners = []
    for gi in model.foot_geoms:
        bi = model.geom_body[gi]
        rot = rmats[:, bi]
        gpos = xpos[:, bi] + rot @ geom_pos[gi]
        grot = rot @ _quat_to_mat_np(geom_quat[gi])
        size = geom_size[gi]
        local = np.stack([[sx * size[0], sy * size[1], -size[2]] for sx, sy in _SOLE_LOOP])
        corners.append(gpos[:, None, :] + np.einsum("tij,kj->tki", grot, local))
    corners = np.stack(corners, axis=1) if corners else np.zeros((xpos.shape[0], 0, 5, 3))
    return xpos, corners


def _draw_markers(ax, a, b, m: dict):
    """Task markers on one projection panel (a, b: axis indices): footstep
    targets as circles (t1 filled), the remaining plan as dots, terrain
    boxes as rectangles."""
    if "terrain_pos" in m:
        for p, s in zip(m["terrain_pos"], m["terrain_size"]):
            if abs(p[0]) > 20 or abs(p[1]) > 20:
                continue  # parked (inactive) boxes
            lo_a, hi_a = p[a] - s[a], p[a] + s[a]
            lo_b, hi_b = p[b] - s[b], p[b] + s[b]
            ax.fill([lo_a, hi_a, hi_a, lo_a], [lo_b, lo_b, hi_b, hi_b], color="tab:gray", alpha=0.4, lw=0.5, edgecolor="k")
    if "sequence" in m:
        seq = m["sequence"]
        ax.plot(seq[:, a], seq[:, b], ".", color="tab:green", ms=3, alpha=0.5)
    if "targets" in m:
        tgt = m["targets"]
        for k, (style, fill) in enumerate([("tab:orange", True), ("tab:green", False)]):
            ax.plot(tgt[k][a], tgt[k][b], "o", ms=8, mfc=style if fill else "none", mec=style, mew=1.5)


def render_trajectory(env, qpos_traj: np.ndarray, out_path: str | Path, fps: int = 40, markers=None) -> tuple[Path, str]:
    """Render a (T, nq) qpos trajectory to a .gif (or .mp4 where an ffmpeg
    writer exists): MuJoCo's EGL renderer where a GL stack is present and
    the env has a robot spec, else matplotlib stick figures (two panels,
    x-z and y-z). ``markers``: per-frame dicts from ``env.render_markers``
    (or None). Returns the path and the renderer that drew it ("gl" or
    "stick figure")."""
    out_path = Path(out_path)
    render_gl.check_writer(out_path)
    if render_gl.gl_available() and getattr(env, "spec", None) is not None:
        try:
            return render_gl.render_trajectory_gl(env, qpos_traj, out_path, fps=fps, markers=markers), "gl"
        except Exception as e:  # any failure of the GL stack: the stick figure still draws the episode
            print(f"GL rendering failed ({e!r}); falling back to stick-figure render", flush=True)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    parent = env.model.body_parent
    xpos_all, corners_all = _fk_points(env, qpos_traj)
    frames = []
    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    try:
        for t in range(qpos_traj.shape[0]):
            xpos, corners = xpos_all[t], corners_all[t]
            m = markers[t] if markers is not None and t < len(markers) and markers[t] else None
            for ax, (a, b, alabel, blabel) in zip(axes, [(0, 2, "x [m]", "z [m]"), (1, 2, "y [m]", "z [m]")]):
                ax.clear()
                if m is not None:
                    _draw_markers(ax, a, b, m)
                for i in range(1, env.model.nbody):
                    p = parent[i]
                    if p == 0:
                        continue
                    ax.plot([xpos[p, a], xpos[i, a]], [xpos[p, b], xpos[i, b]], "o-", color="tab:blue", ms=2, lw=1.5)
                for pts in corners:
                    ax.plot(pts[:, a], pts[:, b], "-", color="tab:red", lw=1)
                ax.axhline(m.get("floor_z", 0.0) if m is not None else 0.0, color="gray", lw=0.5)
                root = xpos[1]
                ax.set_xlim(root[a] - 1.0, root[a] + 1.0)
                ax.set_ylim(-0.1, 1.9)
                ax.set_aspect("equal")
                ax.set_xlabel(alabel)
                ax.set_ylabel(blabel)
            title = f"t = {t / fps:.2f} s"
            if m is not None and "mode" in m:
                title += f"  [{m['mode']}]"
                if "mode_ref" in m:
                    r = m["mode_ref"]
                    title += f" ref=({r[0]:+.2f}, {r[1]:+.2f}, {r[2]:+.2f})"
            axes[0].set_title(title)
            fig.canvas.draw()
            frames.append(np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy())
    finally:
        plt.close(fig)
    return render_gl.write_video(out_path, frames, fps), "stick figure"
