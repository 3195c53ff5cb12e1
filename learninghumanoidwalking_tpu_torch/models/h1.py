"""Unitree H1 (lower body) robot description.

Copy of learninghumanoidwalking_tpu/models/h1.py for the port (pure
Python; no import of the JAX package). The JAX docstring follows.

The reference builds its H1 model from the mujoco_menagerie MJCF with arm and
waist joints removed (welded) and 10 actuated leg joints
(reference envs/h1/gen_xml.py:9-30,64-126), pelvis/torso masses
corrected to 8.89/21.289 kg (reference envs/h1/h1_base.py:39-41). The
menagerie submodule is not vendored in this environment, so the kinematic
offsets, masses, and inertia diagonals below are transcribed from the
published Unitree `h1_description` URDF (the source the menagerie MJCF is
converted from): hip cluster offsets (0, +-0.0875, -0.1742) /
(0.039468, 0, 0) / (0, +-0.11536, 0), thigh and shank lengths 0.4 m, link
masses 2.244 / 2.232 / 4.152 / 1.721 / 0.474 kg, pelvis 5.39 -> corrected
8.89 kg, torso 17.789 -> corrected 21.289 kg (the corrections fold the
welded arms' mass into the trunk, per the reference). Inertia tensors are
the published diagonals (off-diagonal terms, which are 1-2 orders smaller,
are dropped; iquat identity). Total mass 51.82 kg matches the reference's
corrected welded model.

Joint order (actuators) matches gen_xml.LEG_JOINTS: left then right;
within a leg: hip_yaw(z), hip_roll(x), hip_pitch(y), knee(y), ankle(y).

The torso (with welded arms folded in) is a welded child body of the pelvis
named `torso_link`, which upper-body rewards (head-over-root alignment) use
as their reference point.
"""

from learninghumanoidwalking_tpu_torch.physics.spec import Actuator, Body, Geom, Joint, RobotSpec

LEG_JOINTS = [
    "left_hip_yaw",
    "left_hip_roll",
    "left_hip_pitch",
    "left_knee",
    "left_ankle",
    "right_hip_yaw",
    "right_hip_roll",
    "right_hip_pitch",
    "right_knee",
    "right_ankle",
]

# kinematics (h1_description URDF joint origins)
HIP_YAW_OFFSET = (0.0, 0.0875, -0.1742)  # pelvis -> hip_yaw
HIP_ROLL_OFFSET = (0.039468, 0.0, 0.0)  # hip_yaw -> hip_roll
HIP_PITCH_OFFSET = (0.0, 0.11536, 0.0)  # hip_roll -> hip_pitch (thigh)
THIGH_LEN = 0.4  # hip_pitch -> knee
SHANK_LEN = 0.4  # knee -> ankle

# With the half-sitting pose (hip_pitch -0.2, knee 0.6, ankle -0.4) the
# ankle sits 0.1742 + 0.4 cos(0.2) + 0.4 cos(0.4) = 0.93464 below the pelvis
# origin; at nominal base height 0.98 the sole plane is 0.04536 below the
# ankle (reference nominal: reference envs/h1/configs/base.yaml).
ANKLE_TO_SOLE = 0.04536
FOOT_BOX = (0.10, 0.04, 0.012)  # half-sizes
FOOT_BOX_POS = (0.045, 0.0, -(ANKLE_TO_SOLE - FOOT_BOX[2]))


def _leg(side: str, sign: float) -> list:
    s = side
    return [
        Body(
            name=f"{s}_hip_yaw_link",
            parent="pelvis",
            pos=(HIP_YAW_OFFSET[0], sign * HIP_YAW_OFFSET[1], HIP_YAW_OFFSET[2]),
            joint=Joint(jtype="hinge", name=f"{s}_hip_yaw", axis=(0, 0, 1), damping=0.1, armature=0.01),
            mass=2.244,
            ipos=(-0.04923, sign * 0.0001, 0.0072),
            inertia=(0.0025731, 0.0030495, 0.0022935),
        ),
        Body(
            name=f"{s}_hip_roll_link",
            parent=f"{s}_hip_yaw_link",
            pos=HIP_ROLL_OFFSET,
            joint=Joint(jtype="hinge", name=f"{s}_hip_roll", axis=(1, 0, 0), damping=0.1, armature=0.01),
            mass=2.232,
            ipos=(-0.0058, sign * -0.00319, -9.5e-05),
            inertia=(0.0020603, 0.0022482, 0.0024323),
        ),
        Body(
            name=f"{s}_thigh",
            parent=f"{s}_hip_roll_link",
            pos=(HIP_PITCH_OFFSET[0], sign * HIP_PITCH_OFFSET[1], HIP_PITCH_OFFSET[2]),
            joint=Joint(jtype="hinge", name=f"{s}_hip_pitch", axis=(0, 1, 0), damping=0.1, armature=0.01),
            mass=4.152,
            ipos=(0.00746, sign * -0.02346, -0.08193),
            inertia=(0.082618, 0.081579, 0.0060081),
            geoms=[Geom(gtype="sphere", name=f"{s}_thigh_prox", size=(0.05,), pos=(0.0, 0.0, -0.2), contact="self")],
        ),
        Body(
            name=f"{s}_shank",
            parent=f"{s}_thigh",
            pos=(0.0, 0.0, -THIGH_LEN),
            joint=Joint(jtype="hinge", name=f"{s}_knee", axis=(0, 1, 0), damping=0.1, armature=0.01),
            mass=1.721,
            ipos=(-0.00136, sign * -0.00512, -0.1384),
            inertia=(0.012205, 0.012509, 0.0020629),
            geoms=[Geom(gtype="sphere", name=f"{s}_shank_prox", size=(0.04,), pos=(0.0, 0.0, -0.2), contact="self")],
        ),
        Body(
            # ankle body carries the foot (reference body name right/left_ankle_link)
            name=f"{s}_ankle_link",
            parent=f"{s}_shank",
            pos=(0.0, 0.0, -SHANK_LEN),
            joint=Joint(jtype="hinge", name=f"{s}_ankle", axis=(0, 1, 0), damping=0.1, armature=0.01),
            mass=0.474,
            ipos=(0.042575, 0.0, -0.044672),
            inertia=(0.000159668, 0.0029, 0.0028054),
            geoms=[
                Geom(gtype="box", name=f"{s}_foot", size=FOOT_BOX, pos=FOOT_BOX_POS, friction=1.0, contact="foot"),
                Geom(gtype="sphere", name=f"{s}_foot_prox", size=(0.06,), pos=(0.04, 0.0, -0.03), contact="self"),
            ],
        ),
    ]


def h1_spec() -> RobotSpec:
    pelvis = Body(
        name="pelvis",
        parent="world",
        pos=(0.0, 0.0, 0.98),
        joint=Joint(jtype="free", name="root"),
        # URDF mass 5.39, corrected to 8.89 (reference h1_base.py:39-41)
        mass=8.89,
        ipos=(0.0, 0.0, -0.04522),
        inertia=(0.044582, 0.0082464, 0.049021),
    )
    torso = Body(
        name="torso_link",
        parent="pelvis",
        # frame at the (removed) waist joint; its xy is the "head over root"
        # alignment point (reference walking_task.py:91, standing_task.py:82)
        pos=(0.0, 0.0, 0.107),
        # welded (waist joint removed, gen_xml.py:24-30); URDF mass 17.789,
        # corrected to 21.289 — the welded arms' mass folded into the trunk
        mass=21.289,
        ipos=(0.000489, 0.002797, 0.20484),
        inertia=(0.4873, 0.40963, 0.12785),
    )
    bodies = [pelvis, torso] + _leg("left", 1.0) + _leg("right", -1.0)
    return RobotSpec(
        name="h1",
        bodies=bodies,
        actuators=[Actuator(joint=j, gear=1.0) for j in LEG_JOINTS],
        left_foot_geoms=["left_foot"],
        right_foot_geoms=["right_foot"],
        self_collision_pairs=[
            ("left_foot_prox", "right_foot_prox"),
            ("left_shank_prox", "right_shank_prox"),
            ("left_foot_prox", "right_shank_prox"),
            ("right_foot_prox", "left_shank_prox"),
            ("left_thigh_prox", "right_thigh_prox"),
        ],
    )


NOMINAL_HEIGHT = 0.98
HALF_SITTING_POSE = [0.0, 0.0, -0.2, 0.6, -0.4, 0.0, 0.0, -0.2, 0.6, -0.4]
