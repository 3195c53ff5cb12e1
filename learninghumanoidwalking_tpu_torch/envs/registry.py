"""Environment registry (counterpart of learninghumanoidwalking_tpu/envs/registry.py).

Every env of the JAX package: cartpole, jvrc_walk, jvrc_step,
jvrc_walk_rough, h1, h1_walk, and ``mjcf:<path>`` (a walking env built from
an MJCF robot file, envs/mjcf_env.py, with its JSON robot file as
``path_to_json``).
"""

from __future__ import annotations

import importlib

ENVIRONMENTS: dict[str, tuple[str, str]] = {
    "cartpole": ("learninghumanoidwalking_tpu_torch.envs.cartpole", "CartpoleEnv"),
    "h1": ("learninghumanoidwalking_tpu_torch.envs.h1_stand", "H1StandEnv"),
    "h1_walk": ("learninghumanoidwalking_tpu_torch.envs.h1_walk", "H1WalkEnv"),
    "jvrc_walk": ("learninghumanoidwalking_tpu_torch.envs.jvrc_walk", "JvrcWalkEnv"),
    "jvrc_step": ("learninghumanoidwalking_tpu_torch.envs.jvrc_step", "JvrcStepEnv"),
    "jvrc_walk_rough": ("learninghumanoidwalking_tpu_torch.envs.jvrc_walk_rough", "JvrcWalkRoughEnv"),
}


def make_env(name: str, path_to_json: str | None = None, device="cuda"):
    if name.startswith("mjcf:"):
        cls = getattr(importlib.import_module("learninghumanoidwalking_tpu_torch.envs.mjcf_env"), "MjcfWalkEnv")
        return cls(name[len("mjcf:"):], path_to_json, device=device)
    if name not in ENVIRONMENTS:
        raise ValueError(f"unknown env {name!r}; available: {sorted(ENVIRONMENTS)} or mjcf:<path>")
    module_name, cls_name = ENVIRONMENTS[name]
    cls = getattr(importlib.import_module(module_name), cls_name)
    return cls(path_to_json, device=device)
