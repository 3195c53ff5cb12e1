"""MJCF -> RobotSpec importer (counterpart of
learninghumanoidwalking_tpu/physics/mjcf_import.py, the same rules).

The other direction of physics/mjcf.py: a robot description file in the
practically used subset of MJCF becomes a RobotSpec that physics/spec.py
lowers into the port's engine and kernels, with no MuJoCo involved:

  * nested <body> trees with pos/quat/euler, <inertial> (diaginertia or
    fullinertia, diagonalized), <freejoint>, 1-dof <joint> (hinge/slide)
    with axis/pos/damping/armature/frictionloss,
  * <geom> box/sphere/capsule/plane with size/pos/quat/friction/density
    (mesh and other visual-only geom types are skipped: the engine
    collides foot boxes, the floor and terrain only),
  * <motor> actuators with gear/ctrlrange,
  * <option gravity>, <compiler angle>,
  * one level of <default>/<default class> attribute resolution for
    joint/geom/motor (the pattern of the MuJoCo Menagerie's files).

Contact roles (which geoms are feet, which pairs are self-collision
proxies) are not MJCF concepts: they are passed as arguments, as the env
classes name them per robot.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET

import numpy as np

from learninghumanoidwalking_tpu_torch.physics.spec import Actuator, Body, Geom, Joint, RobotSpec

_COLLIDABLE = {"box", "sphere", "capsule", "plane"}


def _floats(s: str | None, default=None):
    if s is None:
        return default
    return tuple(float(v) for v in s.replace(",", " ").split())


def _quat_mul(q, r):
    w1, x1, y1, z1 = q
    w2, x2, y2, z2 = r
    return (
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    )


def _euler_to_quat(euler, degrees: bool):
    """MuJoCo default eulerseq 'xyz'. Lowercase letters mean INTRINSIC
    rotations (each about the already-rotated frame), so the quaternion
    composes in sequence order: q = qx ⊗ qy ⊗ qz."""
    e = [math.radians(v) for v in euler] if degrees else list(euler)
    q = (1.0, 0.0, 0.0, 0.0)
    for axis, ang in zip(((1, 0, 0), (0, 1, 0), (0, 0, 1)), e):
        h = 0.5 * ang
        qn = (math.cos(h), axis[0] * math.sin(h), axis[1] * math.sin(h), axis[2] * math.sin(h))
        q = _quat_mul(q, qn)
    return q


def _orient(el, degrees: bool):
    q = _floats(el.get("quat"))
    if q is not None:
        return q
    e = _floats(el.get("euler"))
    if e is not None:
        return _euler_to_quat(e, degrees)
    return (1.0, 0.0, 0.0, 0.0)


class _Defaults:
    """One-level default class resolution (MJCF <default> trees)."""

    def __init__(self, root: ET.Element):
        self.by_class: dict[str, dict[str, dict[str, str]]] = {}
        for d in root.iter("default"):
            cls = d.get("class", "")
            table = self.by_class.setdefault(cls, {})
            for child in d:
                if child.tag == "default":
                    continue
                table.setdefault(child.tag, {}).update(child.attrib)

    def get(self, el: ET.Element, tag: str, attr: str, default=None):
        v = el.get(attr)
        if v is not None:
            return v
        cls = el.get("class", "")
        for c in (cls, ""):
            v = self.by_class.get(c, {}).get(tag, {}).get(attr)
            if v is not None:
                return v
        return default


def import_mjcf(
    source: str,
    left_foot_geoms=(),
    right_foot_geoms=(),
    self_collision_pairs=(),
    nterrain: int = 0,
) -> RobotSpec:
    """Parse an MJCF XML string (or file path ending in .xml) to a RobotSpec."""
    if source.lstrip().startswith("<"):
        root = ET.fromstring(source)
    else:
        root = ET.parse(source).getroot()

    compiler = root.find("compiler")
    degrees = (compiler is None) or (compiler.get("angle", "degree") == "degree")
    dfl = _Defaults(root)

    option = root.find("option")
    gravity = _floats(option.get("gravity"), (0.0, 0.0, -9.81)) if option is not None else (0.0, 0.0, -9.81)

    bodies: list[Body] = []
    counter = [0]

    def parse_geoms(el: ET.Element, body_name: str) -> list:
        geoms = []
        for g in el.findall("geom"):
            gtype = dfl.get(g, "geom", "type", "sphere")
            if gtype not in _COLLIDABLE:
                continue  # meshes etc.: visual only for the engine
            friction = _floats(dfl.get(g, "geom", "friction"), (1.0,))[0]
            density = float(dfl.get(g, "geom", "density", "1000"))
            size = _floats(dfl.get(g, "geom", "size"), (0.0,))
            name = g.get("name") or f"{body_name}_geom{counter[0]}"
            counter[0] += 1
            gname = g.get("name", "")
            contact = "none"
            if gname in left_foot_geoms or gname in right_foot_geoms:
                contact = "foot"
            elif any(gname in p for p in self_collision_pairs):
                contact = "self"
            geoms.append(
                Geom(
                    gtype=gtype,
                    size=size,
                    name=name,
                    pos=_floats(g.get("pos"), (0.0, 0.0, 0.0)),
                    quat=_orient(g, degrees),
                    friction=friction,
                    density=density,
                    contact=contact,
                )
            )
        return geoms

    def parse_body(el: ET.Element, parent: str):
        name = el.get("name") or f"body{len(bodies)}"
        joint = None
        if el.find("freejoint") is not None:
            fj = el.find("freejoint")
            joint = Joint(jtype="free", name=fj.get("name", f"{name}_free"))
        else:
            j = el.find("joint")
            if j is not None:
                jtype = dfl.get(j, "joint", "type", "hinge")
                if jtype == "free":
                    joint = Joint(jtype="free", name=j.get("name", f"{name}_free"))
                else:
                    joint = Joint(
                        jtype=jtype,
                        name=j.get("name", f"{name}_joint"),
                        axis=_floats(dfl.get(j, "joint", "axis"), (0.0, 0.0, 1.0)),
                        pos=_floats(j.get("pos"), (0.0, 0.0, 0.0)),
                        damping=float(dfl.get(j, "joint", "damping", "0")),
                        armature=float(dfl.get(j, "joint", "armature", "0")),
                        frictionloss=float(dfl.get(j, "joint", "frictionloss", "0")),
                    )
        mass = None
        ipos = (0.0, 0.0, 0.0)
        inertia = None
        iquat = (1.0, 0.0, 0.0, 0.0)
        inertial = el.find("inertial")
        if inertial is not None:
            mass = float(inertial.get("mass"))
            ipos = _floats(inertial.get("pos"), (0.0, 0.0, 0.0))
            di = _floats(inertial.get("diaginertia"))
            if di is not None:
                inertia = di
                iquat = _orient(inertial, degrees)
            else:
                fi = _floats(inertial.get("fullinertia"))
                if fi is not None:
                    ixx, iyy, izz, ixy, ixz, iyz = fi
                    mat = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
                    w, v = np.linalg.eigh(mat)
                    inertia = tuple(float(x) for x in w)
                    if np.linalg.det(v) < 0:
                        v[:, 0] = -v[:, 0]
                    # rotation matrix -> quat
                    tr = np.trace(v)
                    if tr > 0:
                        s = math.sqrt(tr + 1.0) * 2
                        iquat = (0.25 * s, (v[2, 1] - v[1, 2]) / s, (v[0, 2] - v[2, 0]) / s, (v[1, 0] - v[0, 1]) / s)
                    else:
                        i = int(np.argmax(np.diag(v)))
                        j, k = (i + 1) % 3, (i + 2) % 3
                        s = math.sqrt(max(1.0 + v[i, i] - v[j, j] - v[k, k], 1e-12)) * 2
                        q = [0.0, 0.0, 0.0, 0.0]
                        q[0] = (v[k, j] - v[j, k]) / s
                        q[1 + i] = 0.25 * s
                        q[1 + j] = (v[j, i] + v[i, j]) / s
                        q[1 + k] = (v[k, i] + v[i, k]) / s
                        iquat = tuple(q)

        bodies.append(
            Body(
                name=name,
                parent=parent,
                pos=_floats(el.get("pos"), (0.0, 0.0, 0.0)),
                quat=_orient(el, degrees),
                joint=joint,
                geoms=parse_geoms(el, name),
                mass=mass,
                ipos=ipos,
                inertia=inertia,
                iquat=iquat,
            )
        )
        for child in el.findall("body"):
            parse_body(child, name)

    worldbody = root.find("worldbody")
    if worldbody is None:
        raise ValueError("MJCF has no <worldbody>")
    for el in worldbody.findall("body"):
        parse_body(el, "world")

    actuators = []
    act_root = root.find("actuator")
    if act_root is not None:
        for mtr in act_root:
            if mtr.tag not in ("motor", "position", "general"):
                continue
            # MuJoCo autolimits (default since 2.2): a ctrlrange alone is
            # binding unless ctrllimited='false'. Only with <compiler
            # autolimits='false'> does the limit require an explicit
            # ctrllimited='true'.
            autolimits = (compiler is None) or (compiler.get("autolimits", "true") in ("true", "1"))
            limited = dfl.get(mtr, "motor", "ctrllimited")
            rng = None
            if limited in ("true", "1") or (autolimits and limited not in ("false", "0")):
                rng = _floats(dfl.get(mtr, "motor", "ctrlrange"))
            gear = _floats(dfl.get(mtr, "motor", "gear"), (1.0,))[0]
            actuators.append(Actuator(joint=mtr.get("joint"), gear=gear, ctrlrange=rng))

    return RobotSpec(
        name=root.get("model", "imported"),
        bodies=bodies,
        actuators=actuators,
        self_collision_pairs=list(self_collision_pairs),
        left_foot_geoms=list(left_foot_geoms),
        right_foot_geoms=list(right_foot_geoms),
        gravity=gravity,
        nterrain=nterrain,
    )
