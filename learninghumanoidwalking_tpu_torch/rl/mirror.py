"""Mirror-symmetry matrices for symmetric gait learning.

Copy of learninghumanoidwalking_tpu/rl/mirror.py (pure numpy) for the port.

Replaces reference rl/envs/wrappers.py:26-85 (SymmetricEnv): builds
fixed signed-permutation matrices from the envs' signed index lists, so the
mirror loss is two matmuls inside the PPO update.

Index encoding (same convention as the reference): entry i of the list is a
signed source index j, meaning mirrored[i] = sign(j) * x[|j|]. Index 0 cannot
carry a sign, so +-0.1 encodes +-x[0] (wrappers.py:78-85).

The clock observation is mirrored by a half-period phase shift
(sin -> -sin, cos -> -cos, wrappers.py:64-76), which is exactly a negation of
both clock entries — folded into the observation matrix here instead of a
separate arcsin-based path.
"""

from __future__ import annotations

import numpy as np


def symmetry_matrix(signed_indices, clock_inds=()) -> np.ndarray:
    n = len(signed_indices)
    mat = np.zeros((n, n), dtype=np.float32)
    for i, idx in enumerate(signed_indices):
        src = int(round(abs(idx)))
        sign = 1.0 if idx >= 0 else -1.0
        if abs(abs(idx) - 0.1) < 1e-6:  # +-0.1 encodes signed index 0
            src = 0
        mat[i, src] = sign
    for c in clock_inds:
        mat[c, :] = 0.0
        mat[c, c] = -1.0
    return mat


def obs_symmetry_matrix(mirrored_obs, clock_inds, history_len: int = 1) -> np.ndarray:
    """Block-diagonal expansion over stacked observation history frames."""
    base = symmetry_matrix(mirrored_obs, clock_inds or ())
    if history_len == 1:
        return base
    n = base.shape[0]
    full = np.zeros((n * history_len, n * history_len), dtype=np.float32)
    for h in range(history_len):
        full[h * n : (h + 1) * n, h * n : (h + 1) * n] = base
    return full
