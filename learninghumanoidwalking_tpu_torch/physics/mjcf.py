"""RobotSpec -> MJCF export (counterpart of
learninghumanoidwalking_tpu/physics/mjcf.py: the same text for the same
spec).

Writes the RobotSpec the port lowers as an MJCF document: for golden tests
against the MuJoCo binary (tests/test_torch_mujoco_golden.py compiles it and
compares settled heights, ground reaction forces and dynamics quantities)
and as a robot file for the ``mjcf:`` env (physics/mjcf_import.py reads it
back). It needs no MuJoCo itself.
"""

from __future__ import annotations

import io

from learninghumanoidwalking_tpu_torch.physics.spec import Body, RobotSpec

_GEOM_TYPES = {"plane": "plane", "sphere": "sphere", "capsule": "capsule", "box": "box"}


def _fmt(vals) -> str:
    return " ".join(f"{float(v):.8g}" for v in vals)


def export_mjcf(
    spec: RobotSpec,
    timestep: float = 0.001,
    with_floor: bool = True,
    terrain_boxes=None,
    floor_z: float = 0.0,
    visual: bool = False,
    hfield=None,
    self_proxy_collisions: bool = False,
) -> str:
    """Serialize a RobotSpec to an MJCF XML string.

    Self-collision proxy geoms are exported as contype=0 (visual-only) so the
    MuJoCo contact set matches the engine's (foot boxes vs floor only).
    With self_proxy_collisions=True they are instead placed in a private
    collision class (contype=conaffinity=2: proxies collide only with each
    other) so MuJoCo's own pipeline reports proxy self-contacts — used by the
    self-collision termination golden. This must be decided at export time:
    MuJoCo 3.4 ignores runtime geom_contype edits for pair filtering.

    terrain_boxes: optional iterable of (pos(3), size(3), yaw) static world
    boxes: the MuJoCo twin of engine.Terrain for stepping-stone goldens.

    hfield: optional (nrow, ncol, rx, ry, zmax) or (nrow, ncol, rx, ry, zmax,
    cx, cy) — emits a MuJoCo heightfield asset + geom centered at
    (cx, cy, floor_z) (default origin), the twin of Terrain.hfield for the
    hfield goldens (jvrc_walk_rough's jittered rough terrain). The caller fills
    mj_model.hfield_data (normalized [0, 1], row-major y-then-x) after
    loading; heights = data * zmax above floor_z.

    visual: add lights / checker-floor material / body colors for offscreen
    rendering; goldens keep the bare model.
    """
    import math

    out = io.StringIO()
    out.write(f"<mujoco model='{spec.name}'>\n")
    out.write(f"  <option timestep='{timestep}' gravity='{_fmt(spec.gravity)}'/>\n")
    hf_cx = hf_cy = 0.0
    if hfield is not None:
        if len(hfield) not in (5, 7):
            raise ValueError(
                "hfield must be (nrow, ncol, rx, ry, zmax) or "
                f"(nrow, ncol, rx, ry, zmax, cx, cy); got {len(hfield)} elements"
            )
        nrow, ncol, rx, ry, zmax, *hf_center = hfield
        if hf_center:
            hf_cx, hf_cy = hf_center
        out.write(
            "  <asset>\n"
            f"    <hfield name='terrain_hf' nrow='{int(nrow)}' ncol='{int(ncol)}' "
            f"size='{rx} {ry} {zmax} 1.0'/>\n"
            "  </asset>\n"
        )
    if visual:
        out.write(
            "  <visual>\n"
            "    <headlight ambient='0.35 0.35 0.35' diffuse='0.7 0.7 0.7' specular='0.2 0.2 0.2'/>\n"
            "    <quality shadowsize='2048'/>\n"
            "    <map znear='0.01'/>\n"
            "  </visual>\n"
            "  <asset>\n"
            "    <texture name='grid' type='2d' builtin='checker' rgb1='0.22 0.27 0.33' "
            "rgb2='0.30 0.36 0.43' width='256' height='256'/>\n"
            "    <material name='grid' texture='grid' texrepeat='24 24' reflectance='0.15'/>\n"
            "    <material name='robot' rgba='0.72 0.74 0.78 1'/>\n"
            "    <material name='foot' rgba='0.85 0.35 0.25 1'/>\n"
            "  </asset>\n"
        )
    out.write("  <worldbody>\n")
    if visual:
        out.write("    <light pos='0 -2 4' dir='0 0.35 -1' directional='true' castshadow='true'/>\n")
    floor_mat = " material='grid'" if visual else ""
    if with_floor:
        out.write(
            f"    <geom name='floor' type='plane' pos='0 0 {floor_z}' size='20 20 1' "
            f"friction='1 0.005 0.0001'{floor_mat}/>\n"
        )
    if hfield is not None:
        out.write(
            f"    <geom name='terrain_hf' type='hfield' hfield='terrain_hf' "
            f"pos='{hf_cx} {hf_cy} {floor_z}' friction='1 0.005 0.0001'/>\n"
        )
    for ti, (tpos, tsize, tyaw) in enumerate(terrain_boxes or ()):
        half = 0.5 * float(tyaw)
        quat = (math.cos(half), 0.0, 0.0, math.sin(half))
        out.write(
            f"    <geom name='terrain{ti}' type='box' pos='{_fmt(tpos)}' size='{_fmt(tsize)}' "
            f"quat='{_fmt(quat)}' friction='1 0.005 0.0001'/>\n"
        )

    children: dict[str, list[Body]] = {}
    for b in spec.bodies:
        children.setdefault(b.parent, []).append(b)

    foot_geoms = set(spec.left_foot_geoms) | set(spec.right_foot_geoms)

    def emit(body: Body, indent: str):
        out.write(f"{indent}<body name='{body.name}' pos='{_fmt(body.pos)}' quat='{_fmt(body.quat)}'>\n")
        if body.mass is not None:
            out.write(
                f"{indent}  <inertial pos='{_fmt(body.ipos)}' quat='{_fmt(body.iquat)}' "
                f"mass='{body.mass}' diaginertia='{_fmt(body.inertia)}'/>\n"
            )
        j = body.joint
        if j is not None:
            name = j.name or f"{body.name}_joint"
            if j.jtype == "free":
                out.write(f"{indent}  <freejoint name='{name}'/>\n")
            else:
                out.write(
                    f"{indent}  <joint name='{name}' type='{j.jtype}' pos='{_fmt(j.pos)}' "
                    f"axis='{_fmt(j.axis)}' damping='{j.damping}' armature='{j.armature}' "
                    f"frictionloss='{j.frictionloss}' limited='false'/>\n"
                )
        for g in body.geoms:
            name = g.name or f"{body.name}_geom"
            collidable = name in foot_geoms
            contype = 1 if collidable else 0
            conaff = 1 if collidable else 0
            if self_proxy_collisions and g.contact == "self":
                contype = conaff = 2
            size = _fmt(g.size)
            mat = f" material='{'foot' if collidable else 'robot'}'" if visual else ""
            out.write(
                f"{indent}  <geom name='{name}' type='{_GEOM_TYPES[g.gtype]}' size='{size}' "
                f"pos='{_fmt(g.pos)}' quat='{_fmt(g.quat)}' friction='{g.friction} 0.005 0.0001' "
                f"contype='{contype}' conaffinity='{conaff}' density='{g.density}'{mat}/>\n"
            )
        for child in children.get(body.name, []):
            emit(child, indent + "  ")
        out.write(f"{indent}</body>\n")

    for root in children.get("world", []):
        emit(root, "    ")
    out.write("  </worldbody>\n")

    if spec.actuators:
        out.write("  <actuator>\n")
        for a in spec.actuators:
            limited = "true" if a.ctrlrange is not None else "false"
            rng = _fmt(a.ctrlrange) if a.ctrlrange is not None else "0 0"
            out.write(
                f"    <motor name='{a.joint}_motor' joint='{a.joint}' gear='{a.gear}' "
                f"ctrllimited='{limited}' ctrlrange='{rng}'/>\n"
            )
        out.write("  </actuator>\n")
    out.write("</mujoco>\n")
    return out.getvalue()
