"""Closed-form symmetric 3x3 eigendecomposition, batched and branch-free
(counterpart of ``superodom_tpu.ops.eigh3``; the per-thread arithmetic of
the ``plane_fit`` kernel follows it line for line).

Convention: eigenvalues ascending, eigenvectors as columns (Eigen's
SelfAdjointEigenSolver, reference utils/superodom_utils.h:143-163).
"""

from __future__ import annotations

import math

import torch

from superodom_tpu_torch.geometry import cross as _cross
from superodom_tpu_torch.geometry import dot3 as _dot
from superodom_tpu_torch.ops.voxel import true_div

_EPS = 1e-12


def _eigvals3(A: torch.Tensor):
    """Eigenvalues of symmetric [...,3,3], ascending."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = true_div(a00 + a11 + a22, 3.0)
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(true_div(p2, 6.0), 0.0))
    safe_p = torch.clamp_min(p, _EPS)

    b00, b11, b22 = (a00 - q) / safe_p, (a11 - q) / safe_p, (a22 - q) / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = true_div(torch.acos(r), 3.0)

    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min

    diag = torch.sort(torch.stack([a00, a11, a22], dim=-1), dim=-1).values
    near_diag = p1 < _EPS
    lo = torch.where(near_diag, diag[..., 0], lam_min)
    mid = torch.where(near_diag, diag[..., 1], lam_mid)
    hi = torch.where(near_diag, diag[..., 2], lam_max)
    return lo, mid, hi


def _unit(v):
    return v / torch.clamp_min(torch.sqrt(_dot(v, v)), 1e-20)[..., None]


def _eigvec(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector for eigenvalue lam: the largest cross product of rows of
    (A - lam*I); the x axis when all of them vanish (isotropic case)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = A - lam[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)],
                        dim=-2)
    norms = _dot(cands, cands)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cands, -2,
                     best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    nmax = torch.amax(norms, dim=-1, keepdim=True)
    fallback = eye[0].expand(v.shape)
    return _unit(torch.where(nmax > _EPS, v, fallback))


def eigh3(A: torch.Tensor):
    """Symmetric 3x3 eigendecomposition: ``(eigvals[...,3] ascending,
    eigvecs[...,3,3])`` with ``eigvecs[..., :, k]`` for ``eigvals[..., k]``."""
    lo, mid, hi = _eigvals3(A)
    v_lo = _eigvec(A, lo)
    v_hi = _eigvec(A, hi)
    # (near-)isotropic case: both solves fall back to the same direction;
    # replace v_hi with a unit vector orthogonal to v_lo
    c = _cross(v_hi, v_lo)
    c_n = _dot(c, c)[..., None]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    ex = eye[0].expand(v_lo.shape)
    ey = eye[1].expand(v_lo.shape)
    alt1 = _cross(v_lo, ex)
    alt2 = _cross(v_lo, ey)
    alt = torch.where((_dot(alt1, alt1) > _dot(alt2, alt2))[..., None],
                      alt1, alt2)
    v_hi = torch.where(c_n > 1e-12, v_hi, _unit(alt))
    v_mid = _unit(_cross(v_hi, v_lo))
    vals = torch.stack([lo, mid, hi], dim=-1)
    vecs = torch.stack([v_lo, v_mid, v_hi], dim=-1)
    return vals, vecs


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve 3x3 system(s) A x = b via the adjugate (Cramer), batched; a
    determinant below 1e-12 in magnitude gives zeros."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv_det = 1.0 / torch.where(torch.abs(det) < _EPS, math.inf, det)
    x0 = (c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]) * inv_det
    x1 = (c10 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]) * inv_det
    x2 = (c20 * b[..., 0] + c21 * b[..., 1] + c22 * b[..., 2]) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)
