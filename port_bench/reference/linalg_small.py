"""Frozen copy of learninghumanoidwalking_tpu_torch/physics/linalg_small.py at commit 9e7f4a040c02fdfd29cfe1055f8fc2257b06e82f
(imports made relative), part of the benchmark's plain reference: it does
not follow later changes of the program. The original docstring follows.

Unrolled dense linear algebra for small SPD systems
(counterpart of learninghumanoidwalking_tpu/physics/linalg_small.py).

Same outer-product Cholesky and substitutions as the JAX version, written
for batch-LEADING tensors: matrices are (..., n, n) and right-hand sides
(..., n, k). Kept as explicit loops over the (small, fixed) matrix size so
the rounding follows the JAX version's order of operations.
"""

from __future__ import annotations

import torch


def cholesky_outer(m_mat: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Lower-triangular L with L L^T = M via rank-1 updates. m_mat: (..., n, n)."""
    n = m_mat.shape[-1]
    r = m_mat
    idx = torch.arange(n, device=m_mat.device)
    cols = []
    for j in range(n):
        d = torch.sqrt(torch.clamp_min(r[..., j, j], eps))
        mask = (idx >= j).to(m_mat.dtype)
        col = mask * r[..., :, j] / d[..., None]
        r = r - col[..., :, None] * col[..., None, :]
        cols.append(col)
    return torch.stack(cols, dim=-1)


def solve_lower(l_mat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b by forward substitution. b: (..., n, k)."""
    n = l_mat.shape[-1]
    r = b
    xs = []
    for j in range(n):
        xj = r[..., j, :] / l_mat[..., j, j, None]
        xs.append(xj)
        if j + 1 < n:
            r = r - l_mat[..., :, j, None] * xj[..., None, :]
    return torch.stack(xs, dim=-2)


def solve_upper_t(l_mat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = b by back substitution. b: (..., n, k)."""
    n = l_mat.shape[-1]
    r = b
    xs = [None] * n
    for j in range(n - 1, -1, -1):
        xj = r[..., j, :] / l_mat[..., j, j, None]
        xs[j] = xj
        if j > 0:
            r = r - l_mat[..., j, :, None] * xj[..., None, :]
    return torch.stack(xs, dim=-2)


def cho_solve_outer(l_mat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b given L = cholesky_outer(M). b: (..., n) or (..., n, k)."""
    vec = b.dim() == l_mat.dim() - 1
    if vec:
        b = b[..., None]
    x = solve_upper_t(l_mat, solve_lower(l_mat, b))
    return x[..., 0] if vec else x
