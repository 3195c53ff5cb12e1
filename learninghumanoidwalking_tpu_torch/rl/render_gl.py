"""Offscreen 3D rendering of recorded trajectories through MuJoCo + EGL
(counterpart of learninghumanoidwalking_tpu/rl/render_gl.py).

The physics runs in the port; rendering is a replay: the env's RobotSpec
exported to MJCF by the port's own exporter (physics/mjcf.py), recorded
qpos frames written into MjData, and the scene rasterized offscreen through
EGL. Task markers (footstep targets, the remaining plan, terrain boxes) go
in as decorative scene geoms; the episode heightfield of jvrc_walk_rough
as a real hfield asset, re-uploaded when the env re-jitters it.

mujoco and imageio are imported where they are used, so that the rest of
the port runs where they are not installed. rl/render.py tries this path
first and draws matplotlib stick figures where no GL stack exists.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

_GL_OK: bool | None = None


def gl_available() -> bool:
    """Whether mujoco can render offscreen in this process, probed once:
    a GL context and a MuJoCo render context on it. mujoco picks its GL
    backend when first imported (EGL where MUJOCO_GL says so, set here if
    it is unset); a backend without a display can hand out a context
    that cannot render, which the render context's creation shows."""
    global _GL_OK
    if _GL_OK is None:
        os.environ.setdefault("MUJOCO_GL", "egl")
        try:
            import mujoco

            ctx = mujoco.GLContext(64, 64)
            try:
                ctx.make_current()
                mujoco.MjrContext(mujoco.MjModel.from_xml_string("<mujoco/>"), mujoco.mjtFontScale.mjFONTSCALE_150)
            finally:
                ctx.free()
            _GL_OK = True
        except Exception:  # no mujoco, no GL library, no device or display: no GL stack
            _GL_OK = False
    return _GL_OK


def _add_geom(scn, gtype, size, pos, rgba, mat=None):
    import mujoco

    if scn.ngeom >= scn.maxgeom:
        return None
    g = scn.geoms[scn.ngeom]
    mujoco.mjv_initGeom(
        g,
        gtype,
        np.asarray(size, np.float64),
        np.asarray(pos, np.float64),
        (np.eye(3) if mat is None else np.asarray(mat, np.float64)).flatten(),
        np.asarray(rgba, np.float32),
    )
    scn.ngeom += 1
    return g


def _add_connector(scn, p0, p1, width, rgba):
    import mujoco

    g = _add_geom(scn, mujoco.mjtGeom.mjGEOM_CAPSULE, np.zeros(3), np.zeros(3), rgba)
    if g is not None:
        mujoco.mjv_connector(
            g, mujoco.mjtGeom.mjGEOM_CAPSULE, width, np.asarray(p0, np.float64), np.asarray(p1, np.float64)
        )


def _yaw_mat(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _draw_markers(scn, m: dict) -> None:
    """Footstep targets (t1, t2 with a heading tick), the plan and terrain
    boxes of one marker dict (an env's render_markers) as scene geoms."""
    import mujoco

    if "terrain_pos" in m:
        yaws = m.get("terrain_yaw")
        for ti, (p, s) in enumerate(zip(m["terrain_pos"], m["terrain_size"])):
            if abs(p[0]) > 20 or abs(p[1]) > 20:
                continue  # parked (inactive) boxes
            rot = _yaw_mat(float(yaws[ti])) if yaws is not None else None
            _add_geom(scn, mujoco.mjtGeom.mjGEOM_BOX, s, p, (0.55, 0.50, 0.45, 1.0), rot)
    if "sequence" in m:
        for p in m["sequence"]:
            _add_geom(scn, mujoco.mjtGeom.mjGEOM_SPHERE, (0.02, 0, 0), (p[0], p[1], p[2] + 0.02), (0.2, 0.7, 0.3, 0.5))
    if "targets" in m:
        for k, rgba in enumerate([(1.0, 0.55, 0.1, 0.9), (0.15, 0.75, 0.25, 0.7)]):
            t = m["targets"][k]
            _add_geom(scn, mujoco.mjtGeom.mjGEOM_SPHERE, (0.04, 0, 0), (t[0], t[1], t[2] + 0.04), rgba)
            d = np.array([np.cos(t[3]), np.sin(t[3]), 0.0]) * 0.12  # heading tick
            _add_connector(scn, (t[0], t[1], t[2] + 0.04), np.asarray(t[:3]) + d + (0, 0, 0.04), 0.008, rgba)


def hfield_spec(markers):
    """(heights, hfield spec for export_mjcf, zmax) of the episode's first
    heightfield, or (None, None, 1e-6) without one. Mid-episode re-jitters
    are re-uploaded per frame, so zmax covers every frame's field."""
    if not markers or not markers[0] or "hfield" not in markers[0]:
        return None, None, 1e-6
    heights = np.asarray(markers[0]["hfield"], np.float64)
    x0y0 = np.asarray(markers[0]["hfield_x0y0"], np.float64)
    cell = np.asarray(markers[0]["hfield_cell"], np.float64)
    nrow, ncol = heights.shape
    rx, ry = (ncol - 1) * cell[0] / 2.0, (nrow - 1) * cell[1] / 2.0
    zmax = 1e-6
    for mk in markers:
        if mk and "hfield" in mk:
            zmax = max(zmax, float(np.asarray(mk["hfield"]).max()))
    return heights, (nrow, ncol, rx, ry, zmax, x0y0[0] + rx, x0y0[1] + ry), zmax


def scene_xml(env, markers=None) -> str:
    """The replay's MJCF: the env's robot, the floor at the episode's
    floor_z and its heightfield, visual materials on."""
    from learninghumanoidwalking_tpu_torch.physics.mjcf import export_mjcf

    floor_z = float(markers[0].get("floor_z", 0.0)) if markers and markers[0] else 0.0
    _, spec, _ = hfield_spec(markers)
    return export_mjcf(env.spec, with_floor=True, floor_z=floor_z, visual=True, hfield=spec)


def check_writer(out_path: Path) -> None:
    """Raise where no .mp4 writer exists: imageio writes .mp4 through
    imageio-ffmpeg or PyAV (a .gif through Pillow)."""
    if out_path.suffix == ".mp4":
        import importlib.util

        if importlib.util.find_spec("imageio_ffmpeg") is None and importlib.util.find_spec("av") is None:
            raise RuntimeError(
                f"cannot write {out_path}: no .mp4 writer is installed (imageio needs the imageio-ffmpeg package or "
                "PyAV); write a .gif instead"
            )


def write_video(out_path: Path, frames, fps: int) -> Path:
    """Frames to a .gif (at most 25 fps) or another format through imageio."""
    import imageio

    check_writer(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    imageio.mimsave(out_path, frames, fps=min(fps, 25) if out_path.suffix == ".gif" else fps)
    return out_path


def render_trajectory_gl(env, qpos_traj: np.ndarray, out_path: str | Path, fps: int = 40, markers=None,
                         width: int = 640, height: int = 480) -> Path:
    """Render a (T, nq) qpos trajectory to a video through MuJoCo's EGL
    renderer: collision geoms with materials, a capsule skeleton along the
    kinematic tree, the markers, a camera following the root."""
    os.environ.setdefault("MUJOCO_GL", "egl")
    import mujoco

    out_path = Path(out_path)
    check_writer(out_path)
    hf_heights, _, hf_zmax = hfield_spec(markers)
    m = mujoco.MjModel.from_xml_string(scene_xml(env, markers))
    if hf_heights is not None:
        m.hfield_data[:] = (hf_heights / hf_zmax).ravel()
    if m.nq != qpos_traj.shape[1]:
        raise ValueError(f"exported model nq={m.nq} != trajectory nq={qpos_traj.shape[1]}")
    d = mujoco.MjData(m)
    renderer = mujoco.Renderer(m, height, width)

    cam = mujoco.MjvCamera()
    mujoco.mjv_defaultCamera(cam)
    cam.azimuth, cam.elevation, cam.distance = 135.0, -18.0, 2.8

    parent = env.model.body_parent
    skel_rgba = (0.45, 0.55, 0.75, 1.0)
    lookat = None
    frames = []
    try:
        for t in range(qpos_traj.shape[0]):
            d.qpos[:] = qpos_traj[t]
            mujoco.mj_forward(m, d)
            root = d.xpos[1].copy()
            lookat = root if lookat is None else 0.85 * lookat + 0.15 * root  # damped camera follow
            cam.lookat[:] = lookat + np.array([0.0, 0.0, -0.15])
            renderer.update_scene(d, cam)
            scn = renderer.scene
            for bi in range(2, env.model.nbody):
                p = parent[bi]
                if p > 0 and np.linalg.norm(d.xpos[bi] - d.xpos[p]) > 1e-4:
                    _add_connector(scn, d.xpos[p], d.xpos[bi], 0.025, skel_rgba)
            mk = markers[t] if markers is not None and t < len(markers) and markers[t] else None
            if mk is not None:
                if hf_heights is not None and "hfield" in mk:
                    # a mid-episode re-jitter: show the field the physics used
                    fh = np.asarray(mk["hfield"], np.float64)
                    if fh.shape == hf_heights.shape and not np.array_equal(fh, hf_heights):
                        hf_heights = fh
                        m.hfield_data[:] = (fh / hf_zmax).ravel()
                        mujoco.mjr_uploadHField(m, renderer._mjr_context, 0)
                _draw_markers(scn, mk)
            frames.append(renderer.render().copy())
    finally:
        renderer.close()
    return write_video(out_path, frames, fps)
