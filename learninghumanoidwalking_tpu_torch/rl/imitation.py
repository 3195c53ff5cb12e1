"""Imitation (expert distillation) contract (counterpart of
learninghumanoidwalking_tpu/rl/imitation.py).

An env may provide ``imitation_projector()``, returning a function that
maps a batch of policy observations to an ImitationQuery. The PPO update
feeds the expert observations through a frozen expert policy and regresses
the student's deterministic actions (at ``action_indices``) onto the
expert's, masked by ``sample_mask`` (a weighting, not boolean indexing).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class ImitationQuery(NamedTuple):
    expert_obs: torch.Tensor  # (N, expert_obs_dim)
    sample_mask: torch.Tensor  # (N,) float or bool: which samples contribute
    action_indices: tuple  # student action dims to supervise


ImitationProjector = Callable[[torch.Tensor], ImitationQuery]


def imitation_loss(query: ImitationQuery, student_mean: torch.Tensor, expert_mean: torch.Tensor) -> torch.Tensor:
    """Masked MSE between the student's action means and the expert's."""
    pred = student_mean[:, list(query.action_indices)]
    mask = query.sample_mask.to(pred.dtype)[:, None]
    num = torch.sum(mask) * pred.shape[-1]
    return torch.sum(torch.square(pred - expert_mean) * mask) / torch.clamp_min(num, 1.0)
