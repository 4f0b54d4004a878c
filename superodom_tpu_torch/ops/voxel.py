"""Voxel hashing primitives (counterpart of ``superodom_tpu.ops.voxel``).

The hashes are defined on uint32 wrap-around arithmetic.  torch's uint32
shifts are not implemented on the CPU, and an int32 emulation gets the
logical shifts wrong, so every hash here runs in int64 holding the uint32
value in its low 32 bits (``& 0xFFFFFFFF`` after each wrapping op).  The
results are bit-identical to the JAX package's (``tests/test_torch_ops.py``).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_P1 = 73856093
_P2 = 19349663
_P3 = 83492791
_SEEDS = (0x9E3779B9, 0x85EBCA77)


def true_div(x: torch.Tensor, s) -> torch.Tensor:
    """x / s, correctly rounded.  On CUDA, PyTorch divides by a Python (CPU)
    scalar as a multiplication by its reciprocal, which can differ in the
    last bit — enough to move a point across a voxel boundary.  Dividing by
    a tensor on x's device keeps the IEEE quotient on every device."""
    if not isinstance(s, torch.Tensor) or s.device != x.device:
        s = torch.full((), float(s), dtype=x.dtype, device=x.device)
    return x / s


def voxel_coords(xyz: torch.Tensor, res) -> torch.Tensor:
    """Integer voxel coordinates floor(x/res), int32 [..., 3]."""
    return torch.floor(true_div(xyz, res)).to(torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor -> its uint32 bit pattern, held in int64."""
    return x.to(torch.int64) & _M32


def u32_to_i32(h: torch.Tensor) -> torch.Tensor:
    """uint32 value held in int64 -> the int32 with the same bits."""
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


def mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for h in [0, 2^32), without int64 overflow."""
    lo = (h * (m & 0xFFFF)) & _M32
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash_coords_u32(coords: torch.Tensor, variant: int = 0) -> torch.Tensor:
    """Spatial hash of int32 [..., 3] as uint32 values held in int64."""
    c = as_u32(coords)
    h = (mul32(c[..., 0], _P1) + mul32(c[..., 1], _P2)
         + mul32(c[..., 2], _P3) + _SEEDS[variant]) & _M32
    return _fmix32(h)


def hash_coords(coords: torch.Tensor, variant: int = 0) -> torch.Tensor:
    """Spatial hash of int32 [..., 3] -> int32 [...]. Two independent variants."""
    return u32_to_i32(hash_coords_u32(coords, variant))


def _composite_sort_order(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic argsort by (h1, h2) built from two stable sorts."""
    order2 = torch.argsort(h2, stable=True)
    order1 = torch.argsort(h1[order2], stable=True)
    return order2[order1]


def uniform_stride_mask(n: int, stride: int, device=None) -> torch.Tensor:
    """Every ``stride``-th lane starting at 1 (featureExtraction.cpp:507)."""
    idx = torch.arange(n, dtype=torch.int32, device=device)
    return (idx >= 1) & ((idx - 1) % stride == 0)
