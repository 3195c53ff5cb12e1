"""Frozen copy of learninghumanoidwalking_tpu_torch/models/jvrc.py at commit 9e7f4a040c02fdfd29cfe1055f8fc2257b06e82f
(imports made relative), part of the benchmark's plain reference: it does
not follow later changes of the program. The original docstring follows.

JVRC-1 (lower body) robot description.

Copy of learninghumanoidwalking_tpu/models/jvrc.py for the port (pure
Python; no import of the JAX package). The JAX docstring follows.

The reference strips the JVRC-1 MJCF down to 12 actuated leg joints with
arms/waist/head welded in a fixed pose, adds one box collision geom per foot
(size 0.1x0.05x0.01 at (0.029, 0, -0.09778) in the ankle frame), and keeps
hip/knee collision geoms for self-collision
(reference envs/jvrc/gen_xml.py:42-134). The JVRC description assets
(models/jvrc_mj_description submodule) are NOT vendored in this image and the
image has no network egress, so the values below are tiered by provenance:

  (a) pinned by reference code: joint names/order (gen_xml.LEG_JOINTS),
      body-name *_S convention (jvrc_base.py:30-33), foot collision box size
      and ankle-frame offset (gen_xml.py:123-128), nominal base position
      0.81 m and half-sitting pose -30/50/-24 deg
      (jvrc_base.py:52, configs/base.yaml), kp/kd (configs/base.yaml).
  (b) published JVRC-1 kinematics (jvrc_description URDF / VRML, transcribed
      from the published model): hip lateral offset +-0.096 m, equal
      hip-to-knee and knee-to-ankle segments of 0.389 m (the equal-segment
      leg is the HRP-lineage design JVRC-1 follows). The segment length is
      cross-validated by the reference's own pinned numbers: with the
      ankle-to-sole drop implied by (a) (0.09778 + 0.01 = 0.10778 m), the
      half-sitting pose closes the chain at
      0.389*cos(30deg) + 0.389*cos(20deg) + 0.10778 = 0.8102 m — the
      reference's nominal base height (0.81) to within 0.2 mm, so the robot
      initialized per (a) starts with its soles essentially on the floor.
  (c) reconstructed: per-link masses and inertia diagonals. JVRC-1's
      published gross spec is 62 kg / 1.688 m; the per-link split below
      follows robot-typical leg mass distribution (hip actuator clusters,
      thigh carrying the knee drive) normalized so the welded model totals
      exactly 62.0 kg, with inertia diagonals from cylinder/box
      approximations at the (b) link lengths. Upper body (waist, chest,
      arms frozen at the gen_xml.py:92-103 pose, head) is merged into the
      pelvis as the reference's weld does.

Joint chain per leg (matching gen_xml.LEG_JOINTS order, right then left):
HIP_P(y) -> HIP_R(x) -> HIP_Y(z) -> KNEE(y) -> ANKLE_R(x) -> ANKLE_P(y).
Body names mirror the reference's *_S convention (jvrc_base.py:30-33) so the
env layer reads the same names (R_ANKLE_P_S = right foot, PELVIS_S = root,
NECK_P_S = head marker).

Note on the nominal height: the foot is pitched -4 deg at half-sitting
(-30 + 50 - 24), so contact starts on the heel edge and the robot settles
~7 mm from the 0.81 m init before the PD hold catches it.
"""

from .spec import Actuator, Body, Geom, Joint, RobotSpec

LEG_JOINTS = [
    "R_HIP_P",
    "R_HIP_R",
    "R_HIP_Y",
    "R_KNEE",
    "R_ANKLE_R",
    "R_ANKLE_P",
    "L_HIP_P",
    "L_HIP_R",
    "L_HIP_Y",
    "L_KNEE",
    "L_ANKLE_R",
    "L_ANKLE_P",
]

# (b) published kinematics
HIP_Y_OFFSET = 0.096  # pelvis -> hip, lateral
THIGH_LEN = 0.389  # hip -> knee
SHANK_LEN = 0.389  # knee -> ankle
STANDING_HEIGHT = THIGH_LEN + SHANK_LEN + 0.10778  # legs straight, soles on floor

# (a) reference-pinned foot geometry (gen_xml.py:123-128)
FOOT_BOX = (0.1, 0.05, 0.01)  # half-sizes
FOOT_BOX_POS = (0.029, 0.0, -0.09778)

# (c) reconstructed link masses (kg); leg total 12.9 each, welded upper body
# 36.2, robot total 62.0 (published JVRC-1 gross mass)
M_HIP_P = 1.1
M_HIP_R = 1.3
M_THIGH = 5.4
M_SHANK = 3.2
M_ANKLE_R = 0.5
M_FOOT = 1.4
M_UPPER = 62.0 - 2 * (M_HIP_P + M_HIP_R + M_THIGH + M_SHANK + M_ANKLE_R + M_FOOT)


def _leg(prefix: str, sign: float) -> list:
    p = prefix
    return [
        Body(
            name=f"{p}_HIP_P_S",
            parent="PELVIS_S",
            pos=(0.0, sign * HIP_Y_OFFSET, 0.0),
            joint=Joint(jtype="hinge", name=f"{p}_HIP_P", axis=(0, 1, 0), damping=0.2, armature=0.01),
            mass=M_HIP_P,
            ipos=(0.0, 0.0, 0.0),
            inertia=(0.0018, 0.0018, 0.0018),
        ),
        Body(
            name=f"{p}_HIP_R_S",
            parent=f"{p}_HIP_P_S",
            pos=(0.0, 0.0, 0.0),
            joint=Joint(jtype="hinge", name=f"{p}_HIP_R", axis=(1, 0, 0), damping=0.2, armature=0.01),
            mass=M_HIP_R,
            ipos=(0.0, 0.0, -0.04),
            inertia=(0.0025, 0.0025, 0.0025),
        ),
        Body(
            # thigh (hip yaw link; carries the upper-leg + knee-drive inertia)
            name=f"{p}_HIP_Y_S",
            parent=f"{p}_HIP_R_S",
            pos=(0.0, 0.0, 0.0),
            joint=Joint(jtype="hinge", name=f"{p}_HIP_Y", axis=(0, 0, 1), damping=0.2, armature=0.01),
            mass=M_THIGH,
            ipos=(0.0, 0.0, -THIGH_LEN / 2),
            # solid cylinder r=0.06, L=0.389 at 5.4 kg
            inertia=(0.073, 0.073, 0.010),
            geoms=[Geom(gtype="sphere", name=f"{p}_thigh_prox", size=(0.06,), pos=(0.0, 0.0, -0.19), contact="self")],
        ),
        Body(
            name=f"{p}_KNEE_S",
            parent=f"{p}_HIP_Y_S",
            pos=(0.0, 0.0, -THIGH_LEN),
            joint=Joint(jtype="hinge", name=f"{p}_KNEE", axis=(0, 1, 0), damping=0.2, armature=0.01),
            mass=M_SHANK,
            ipos=(0.0, 0.0, -SHANK_LEN * 0.45),
            # solid cylinder r=0.05, L=0.389 at 3.2 kg
            inertia=(0.036, 0.036, 0.006),
            geoms=[Geom(gtype="sphere", name=f"{p}_shank_prox", size=(0.05,), pos=(0.0, 0.0, -0.18), contact="self")],
        ),
        Body(
            name=f"{p}_ANKLE_R_S",
            parent=f"{p}_KNEE_S",
            pos=(0.0, 0.0, -SHANK_LEN),
            joint=Joint(jtype="hinge", name=f"{p}_ANKLE_R", axis=(1, 0, 0), damping=0.2, armature=0.01),
            mass=M_ANKLE_R,
            ipos=(0.0, 0.0, 0.0),
            inertia=(0.0009, 0.0009, 0.0009),
        ),
        Body(
            # foot body (reference R/L_ANKLE_P_S carries the foot collision box)
            name=f"{p}_ANKLE_P_S",
            parent=f"{p}_ANKLE_R_S",
            pos=(0.0, 0.0, 0.0),
            joint=Joint(jtype="hinge", name=f"{p}_ANKLE_P", axis=(0, 1, 0), damping=0.2, armature=0.01),
            mass=M_FOOT,
            ipos=(0.03, 0.0, -0.07),
            # 0.2 x 0.1 x ~0.06 foot block at 1.4 kg
            inertia=(0.002, 0.005, 0.006),
            geoms=[
                Geom(gtype="box", name=f"{p}_foot", size=FOOT_BOX, pos=FOOT_BOX_POS, friction=1.0, contact="foot"),
                Geom(gtype="sphere", name=f"{p}_foot_prox", size=(0.06,), pos=(0.03, 0.0, -0.06), contact="self"),
            ],
        ),
    ]


def jvrc_spec(nterrain: int = 0, timeconst: float = 0.02, dampratio: float = 1.0) -> RobotSpec:
    pelvis = Body(
        name="PELVIS_S",
        parent="world",
        pos=(0.0, 0.0, 0.81),
        # merged welded upper body (pelvis + waist/chest/arms/head in the
        # frozen pose, gen_xml.py:88-103): 36.2 kg so the robot totals the
        # published 62.0 kg; CoM ~0.22 m above the root and 0.03 m forward —
        # the weld freezes the elbows bent at -0.524 rad (gen_xml.py:92-103),
        # putting the forearms ahead of the chest; with it the half-sitting
        # whole-body CoM sits ~7 mm behind the ankle pitch axis (a gentle,
        # ankle-PD-holdable lean) instead of 25 mm. Inertia from a
        # 0.6 m x 0.45 m x 0.3 m trunk + bent-elbow arm distribution.
        joint=Joint(jtype="free", name="root"),
        mass=M_UPPER,
        ipos=(0.03, 0.0, 0.22),
        inertia=(2.2, 1.9, 0.9),
    )
    head_marker = Body(name="NECK_P_S", parent="PELVIS_S", pos=(0.0, 0.0, 0.55))
    bodies = [pelvis, head_marker] + _leg("R", -1.0) + _leg("L", 1.0)
    return RobotSpec(
        name="jvrc",
        bodies=bodies,
        actuators=[Actuator(joint=j, gear=1.0) for j in LEG_JOINTS],
        left_foot_geoms=["L_foot"],
        right_foot_geoms=["R_foot"],
        self_collision_pairs=[
            ("L_foot_prox", "R_foot_prox"),
            ("L_shank_prox", "R_shank_prox"),
            ("L_foot_prox", "R_shank_prox"),
            ("R_foot_prox", "L_shank_prox"),
            ("L_thigh_prox", "R_thigh_prox"),
        ],
        nterrain=nterrain,
        timeconst=timeconst,
        dampratio=dampratio,
    )


NOMINAL_HEIGHT = 0.81  # (a) reference nominal_pose base height (jvrc_base.py:52)
HALF_SITTING_POSE_DEG = [-30, 0, 0, 50, 0, -24, -30, 0, 0, 50, 0, -24]
