"""Small SPD solves for the 6x6 ICP normal systems (counterpart of
``superodom_tpu.ops.smallsolve``).

The Cholesky factorization runs column by column on whole rows, so one
6x6 solve is a few dozen tensor ops rather than one op per scalar; it
broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch


def _chol6(H: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Lower Cholesky factor of SPD [..., n, n]; guarded square roots keep
    NaNs out for near-singular inputs (callers damp the system)."""
    n = H.shape[-1]
    cols = []
    for j in range(n):
        Lj = torch.stack(cols, dim=-1) if cols else None  # [..., n, j]
        col = H[..., :, j]
        if Lj is not None:
            col = col - torch.sum(Lj * Lj[..., j:j + 1, :], dim=-1)
        d = torch.sqrt(torch.clamp_min(col[..., j:j + 1], eps))
        rows = torch.arange(n, device=H.device)
        col = torch.where(rows > j, col / d, torch.where(rows == j, d, 0.0))
        cols.append(col)
    return torch.stack(cols, dim=-1)


def _chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L L^T X = B for X, B [..., n, m]."""
    n = L.shape[-1]
    y = []
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * y[k]
        y.append(s / L[..., i, i, None])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i, None] * x[k]
        x[i] = s / L[..., i, i, None]
    return torch.stack(x, dim=-2)


def solve6_spd(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x = H^-1 g for SPD 6x6 H."""
    return _chol_solve(_chol6(H), g[..., None])[..., 0]


def inv6_spd(H: torch.Tensor) -> torch.Tensor:
    """H^-1 for SPD 6x6 H."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return _chol_solve(_chol6(H), eye.expand(H.shape))
