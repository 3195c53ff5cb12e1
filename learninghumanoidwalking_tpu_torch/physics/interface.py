"""State accessors over (Model, PhysicsState) that the walking env and its
rewards read (subset of learninghumanoidwalking_tpu/physics/interface.py),
batch-leading."""

from __future__ import annotations

import torch

from learninghumanoidwalking_tpu_torch.physics import engine
from learninghumanoidwalking_tpu_torch.physics.model import Model, PhysicsState


def foot_slot_mask(model: Model, geoms) -> torch.Tensor:
    """(nc,) 1.0 on the contact slots of the given foot geoms."""
    sel = [1.0 if g in geoms else 0.0 for g in engine.slot_geoms(model)]
    return torch.as_tensor(sel, dtype=torch.float32, device=model.device)


def contact_point_z(state: PhysicsState) -> torch.Tensor:
    """(B,) lowest active contact z, 0 when airborne."""
    mask = state.contact.mask > 0
    z = torch.where(mask, state.contact.pos[..., 2], torch.full_like(state.contact.pos[..., 2], 1e3))
    return torch.where(torch.any(mask, dim=-1), torch.min(z, dim=-1).values, torch.zeros_like(z[:, 0]))
