"""Cartpole robot description.

Copy of learninghumanoidwalking_tpu/models/cartpole.py for the port (pure
Python; no import of the JAX package): a 2-DoF cart (slide, x) and pole
(hinge, y) with inertia derived from geoms (inertiafromgeom semantics),
joint damping 0.05, and a gear-50 force motor on the slider. The model has
no contacts.
"""

from learninghumanoidwalking_tpu_torch.physics.spec import Actuator, Body, Geom, Joint, RobotSpec


def cartpole_spec() -> RobotSpec:
    return RobotSpec(
        name="cartpole",
        bodies=[
            Body(
                name="cart",
                parent="world",
                pos=(0.0, 0.0, 0.0),
                joint=Joint(jtype="slide", name="slider", axis=(1, 0, 0), damping=0.05),
                geoms=[Geom(gtype="box", name="cart", size=(0.2, 0.1, 0.05))],
            ),
            Body(
                name="pole",
                parent="cart",
                pos=(0.0, 0.0, 0.0),
                joint=Joint(jtype="hinge", name="hinge", axis=(0, 1, 0), damping=0.05),
                # a capsule from (0,0,0) to (0,0,0.6), radius 0.045
                geoms=[Geom(gtype="capsule", name="cpole", size=(0.045, 0.3), pos=(0.0, 0.0, 0.3))],
            ),
        ],
        actuators=[Actuator(joint="slider", gear=50.0)],
    )
