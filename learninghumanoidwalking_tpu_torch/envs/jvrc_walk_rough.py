"""JVRC-1 robust walking on uneven, compliant terrain with full domain
randomization (counterpart of learninghumanoidwalking_tpu/envs/jvrc_walk_rough.py).

Terrain: a per-env heightfield (16x16 nodes, 0.25 m cells, heights
U(0, 0.035)) under every foot corner (kernel K3 on the card), drawn anew
every episode and, 1 step in 200 while not standing, in mid-episode.
Contacts use a softer solref (timeconst 0.04) for compliant ground; the
config turns on initial-pose noise, observation noise, perturbations and
dynamics randomization. Its steps run at R=1, as in the reference: the
kernel wrapper pins R for every model on terrain.
"""

from __future__ import annotations

import dataclasses

import torch

from learninghumanoidwalking_tpu_torch.envs.humanoid import load_config
from learninghumanoidwalking_tpu_torch.envs.jvrc_walk import JvrcWalkEnv
from learninghumanoidwalking_tpu_torch.envs.walking_mixin import walking_markers
from learninghumanoidwalking_tpu_torch.models import jvrc
from learninghumanoidwalking_tpu_torch.physics.engine import Terrain
from learninghumanoidwalking_tpu_torch.physics.model import tree_map
from learninghumanoidwalking_tpu_torch.physics.spec import lower
from learninghumanoidwalking_tpu_torch.tasks import walking

HF_RES = 16  # nodes per side
HF_CELL = 0.25  # m between nodes: the grid spans 3.75 m x 3.75 m
HF_X0Y0 = (-1.2, -1.875)  # forward walking corridor; flat beyond (clamped)
HF_MAX = 0.035  # reference hfield z range 0.015-0.035 m


def sample_hfield(draws, n: int, device) -> Terrain:
    """A fresh heightfield for each of n envs (no boxes)."""
    return Terrain(
        pos=torch.zeros((n, 0, 3), device=device),
        size=torch.zeros((n, 0, 3), device=device),
        yaw=torch.zeros((n, 0), device=device),
        floor_z=torch.zeros((n,), device=device),
        hfield=draws.uniform("hfield", (n, HF_RES, HF_RES), 0.0, HF_MAX, device),
        hfield_x0y0=torch.tensor(HF_X0Y0, device=device).expand(n, 2).clone(),
        hfield_cell=torch.full((n, 2), HF_CELL, device=device),
    )


@dataclasses.dataclass
class RoughWalkState:
    walk: walking.WalkingState
    terrain: Terrain


class JvrcWalkRoughEnv(JvrcWalkEnv):
    def __init__(self, path_to_json: str | None = None, device: str | torch.device = "cuda"):
        # the jvrc_walk setup, then the compliant-contact model and the
        # randomized config
        super().__init__(None, device=device)
        self.cfg = load_config("jvrc_rough.json", path_to_json)
        self.spec = jvrc.jvrc_spec(timeconst=0.04)
        self.model = lower(self.spec, device=self.device)
        self._finalize()
        self._setup_walking()
        self._setup_mirror()

    def _task_reset(self, draws, n, iteration, physics):
        return RoughWalkState(walk=walking.reset(draws, n, self.period, self.device), terrain=sample_hfield(draws, n, self.device))

    def _task_step(self, draws, task, physics):
        walk = walking.step(draws, task.walk, self.period, self.dbl_support)
        n = walk.mode.shape[0]
        # occasional terrain re-jitter while walking
        rejitter = (draws.randint("hfield.rejitter", (n,), 0, 200, self.device) == 0) & (walk.mode != walking.STANDING)
        new = sample_hfield(draws, n, self.device)
        terrain = tree_map(lambda a, b: torch.where(rejitter.reshape((n,) + (1,) * (a.dim() - 1)), a, b), new, task.terrain)
        return RoughWalkState(walk=walk, terrain=terrain)

    def _external_obs(self, task) -> torch.Tensor:
        return walking.external_obs(task.walk, self.period)

    def _terrain(self, task):
        return task.terrain

    def _reward(self, state, physics, task, target):
        return super()._reward(state, physics, task.walk, target)

    def render_markers(self, states, i: int) -> dict:
        """Env ``i``'s walking mode and its current heightfield, re-jitters
        included (JAX envs/jvrc_walk_rough.py:102), on the host."""
        terrain = states.task.terrain
        return {
            **walking_markers(self.MODE_NAMES, states.task.walk, i),
            "hfield": terrain.hfield[i].cpu().numpy(),
            "hfield_x0y0": terrain.hfield_x0y0[i].cpu().numpy(),
            "hfield_cell": terrain.hfield_cell[i].cpu().numpy(),
        }
