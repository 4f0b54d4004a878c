"""Voxel hashing primitives (counterpart of ``superodom_tpu.ops.voxel``).

The hashes are defined on uint32 wrap-around arithmetic.  torch's uint32
shifts are not implemented on the CPU, and an int32 emulation gets the
logical shifts wrong, so every hash here runs in int64 holding the uint32
value in its low 32 bits (``& 0xFFFFFFFF`` after each wrapping op).  The
results are bit-identical to the JAX package's (``tests/test_torch_ops.py``).

Scan thinning: :func:`voxel_downsample_scatter` (one survivor per hash-table
slot; on the card the hand-written K10 ``voxel_claim`` of
``csrc/voxel_claim.cu``, on the CPU its plain version) and
:func:`voxel_downsample_centroid` (per-voxel centroids by two stable sorts
and segment sums, plain PyTorch on every device).
"""

from __future__ import annotations

import torch

from superodom_tpu_torch import kernel_ops

_M32 = 0xFFFFFFFF
_P1 = 73856093
_P2 = 19349663
_P3 = 83492791
_SEEDS = (0x9E3779B9, 0x85EBCA77)
_INT_MAX = 2147483647


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


def voxel_downsample_centroid(xyz: torch.Tensor, mask: torch.Tensor, res,
                              *extras: torch.Tensor):
    """Voxel-grid downsample keeping per-voxel centroids (PCL VoxelGrid
    semantics).  ``extras`` are per-lane channels f32[N] or f32[N,d],
    averaged per voxel beside the coordinates.

    Returns (xyz_out f32[N,3], mask_out bool[N], *extras_out): one valid
    lane per occupied voxel, compacted to the front in (h1, h2) order;
    invalid lanes zeroed.  The segment sums are ``index_add`` over the
    sorted lanes, so a centroid may differ from another summation order's
    in the last bits; masks and lane order are exact."""
    n = xyz.shape[0]
    coords = voxel_coords(xyz, res)
    h1 = torch.where(mask, hash_coords(coords, 0), _INT_MAX)
    h2 = torch.where(mask, hash_coords(coords, 1), _INT_MAX)
    order = _composite_sort_order(h1, h2)
    h1s, h2s = h1[order], h2[order]
    new_run = torch.cat([
        torch.ones((1,), dtype=torch.bool, device=xyz.device),
        (h1s[1:] != h1s[:-1]) | (h2s[1:] != h2s[:-1])])[:n]
    seg_id = torch.cumsum(new_run.to(torch.int64), dim=0) - 1
    w = mask[order].to(xyz.dtype)
    cnts = torch.zeros((n,), dtype=xyz.dtype, device=xyz.device).index_add(
        0, seg_id, w)
    safe = torch.clamp_min(cnts, 1.0)
    out_mask = cnts > 0.0

    def seg_mean(a):
        col = (slice(None),) + (None,) * (a.dim() - 1)
        s = torch.zeros_like(a).index_add(0, seg_id, a * w[col])
        return torch.where(out_mask[col], s / safe[col], 0.0)

    return (seg_mean(xyz[order]), out_mask) + tuple(
        seg_mean(e[order]) for e in extras)


def _claim_table_bits(n: int, table_bits: int) -> int:
    return table_bits if table_bits else max((n * 4 - 1).bit_length(), 4)


def voxel_downsample_scatter_reference(xyz: torch.Tensor, mask: torch.Tensor,
                                       res, table_bits: int = 0):
    """Plain version of K10: the keep-mask of scatter-claim voxel thinning.
    slot = hash(floor(xyz / res)) & (T - 1); of the masked lanes that share
    a slot the lowest survives (distinct voxels whose hashes collide in the
    table merge).  ``table_bits`` = 0 sizes the table 4x the lane count."""
    n = xyz.shape[0]
    T = 1 << _claim_table_bits(n, table_bits)
    slot = hash_coords_u32(voxel_coords(xyz, res), 0) & (T - 1)
    slot = torch.where(mask, slot, T)  # masked lanes claim a spare slot
    lane = torch.arange(n, dtype=torch.int32, device=xyz.device)
    claims = torch.full((T + 1,), _INT_MAX, dtype=torch.int32,
                        device=xyz.device).scatter_reduce(
                            0, slot, lane, "amin")
    return mask & (claims[slot] == lane)


def voxel_downsample_scatter(xyz: torch.Tensor, mask: torch.Tensor, res,
                             table_bits: int = 0) -> torch.Tensor:
    """K10: see :func:`voxel_downsample_scatter_reference` for the
    contract.  On the card ``res`` stays a device scalar (a Python number
    is put there without a host read of anything)."""
    if xyz.is_cuda:
        if not isinstance(res, torch.Tensor):
            res = torch.full((), float(res), dtype=xyz.dtype,
                             device=xyz.device)
        return kernel_ops.voxel_claim(
            xyz.contiguous(), mask.contiguous(),
            res.to(device=xyz.device, dtype=xyz.dtype),
            _claim_table_bits(xyz.shape[0], table_bits))
    if xyz.device.type == "cpu":
        return voxel_downsample_scatter_reference(xyz, mask, res, table_bits)
    raise ValueError(f"voxel_downsample_scatter: unsupported device "
                     f"{xyz.device}")


def uniform_stride_mask(n: int, stride: int, device=None) -> torch.Tensor:
    """Every ``stride``-th lane starting at 1 (featureExtraction.cpp:507)."""
    idx = torch.arange(n, dtype=torch.int32, device=device)
    return (idx >= 1) & ((idx - 1) % stride == 0)
