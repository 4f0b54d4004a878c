"""Voxel-hash local map (counterpart of ``superodom_tpu.mapstate``).

Layout, as in the JAX package:

  keys  int32[NB, B]      packed cell coordinate per slot (-1 = empty)
  pts   f32  [NB*B, 3C]   stored points, coordinate-planar slot rows
  cnt   int32[NB, B]      valid points per slot

Unoccupied point lanes hold the BIG sentinel, so a query needs no per-slot
count: sentinel lanes lose every distance comparison.

Hand-written CUDA kernels carry the read side (``csrc/``):

* ``octant_lookup`` (K1) — the 2x2x2 cells nearest each query, their
  packed keys, the fmix bucket and a first-match scan of the bucket row:
  ``int32[Q, 8]`` slot ids, -1 where a cell is absent.
* ``knn_select`` (K2) — the k nearest stored points among those 8 slot
  rows, read straight from the point table, ordered by (distance, lane)
  exactly as ``lax.top_k`` orders them.
* ``reduce_candidates`` (K9a) — K2's selection at k = W, materialised as
  planes ``[Q, W]`` once a scan; ``select_reduced`` (K9b) — the k nearest
  among those W lanes, for the ICP rounds after the first
  (``RegistrationConfig.refresh_width``).

Each has a plain PyTorch version here (``*_reference``) with the JAX
package's layout; CPU tensors take it, CUDA tensors take the kernel.
All functions are pure: they return new tensors and never modify the map.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from superodom_tpu_torch import kernels
from superodom_tpu_torch.config import MapConfig
from superodom_tpu_torch.ops.voxel import (
    _composite_sort_order,
    as_u32,
    hash_coords,
    mul32,
    true_div,
    voxel_coords,
)

BIG = 1e30
_INT_MAX = 2147483647
_EMPTY = -1
_COORD_BITS = 10
_COORD_MASK = (1 << _COORD_BITS) - 1  # 1023
_COORD_PERIOD = 1 << _COORD_BITS  # 1024 cells before wrap


class VoxelHashMap(NamedTuple):
    keys: torch.Tensor  # i32[NB, B] packed cell keys, -1 empty
    pts: torch.Tensor  # f32[NB*B, 3*C] coordinate-planar slot rows
    cnt: torch.Tensor  # i32[NB, B]

    @property
    def cell_capacity(self) -> int:
        return self.pts.shape[1] // 3


def pack_cells(cells: torch.Tensor) -> torch.Tensor:
    """int32 [...,3] cell coords -> packed non-negative int32 [...]
    (10 bits per axis, two's-complement wrap at +-512 cells)."""
    c = cells & _COORD_MASK
    return (c[..., 0] | (c[..., 1] << _COORD_BITS)
            | (c[..., 2] << (2 * _COORD_BITS))).to(torch.int32)


def unpack_cells(packed: torch.Tensor) -> torch.Tensor:
    """Packed key -> int32 [...,3] coords in [-512, 512)."""
    def ext(v):
        return torch.where(v >= _COORD_PERIOD // 2, v - _COORD_PERIOD, v)

    x = ext(packed & _COORD_MASK)
    y = ext((packed >> _COORD_BITS) & _COORD_MASK)
    z = ext((packed >> (2 * _COORD_BITS)) & _COORD_MASK)
    return torch.stack([x, y, z], dim=-1)


def _bucket_scramble(packed: torch.Tensor) -> torch.Tensor:
    """fmix-style scramble of the packed cell word (uint32 value in int64)."""
    h = as_u32(packed)
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    return h ^ (h >> 13)


def _bucket_of(packed: torch.Tensor, nb: int) -> torch.Tensor:
    return (_bucket_scramble(packed) & (nb - 1)).to(torch.int32)


def empty_map(cfg: MapConfig, dtype=torch.float32, device=None) -> VoxelHashMap:
    if cfg.table_size % cfg.bucket_size != 0:
        raise ValueError(
            f"table_size ({cfg.table_size}) must be a multiple of "
            f"bucket_size ({cfg.bucket_size})")
    nb = cfg.table_size // cfg.bucket_size
    if nb & (nb - 1) != 0:
        raise ValueError(
            f"table_size/bucket_size ({nb}) must be a power of two")
    return VoxelHashMap(
        keys=torch.full((nb, cfg.bucket_size), _EMPTY, dtype=torch.int32,
                        device=device),
        pts=torch.full((nb * cfg.bucket_size, 3 * cfg.cell_capacity), BIG,
                       dtype=dtype, device=device),
        cnt=torch.zeros((nb, cfg.bucket_size), dtype=torch.int32,
                        device=device),
    )


def _lookup_keys(keys: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    nb, B = keys.shape
    bucket = _bucket_of(packed, nb)
    match = keys[bucket] == packed[:, None]  # [Q, B] bucket-row gather
    lane = torch.argmax(match.to(torch.int32), dim=-1).to(torch.int32)
    return torch.where(torch.any(match, dim=-1), bucket * B + lane, -1)


def lookup_packed(m: VoxelHashMap, packed: torch.Tensor) -> torch.Tensor:
    """Packed cell keys [Q] -> flat slot index [Q] (bucket*B + lane), -1 if
    absent: the first matching lane of the key's bucket row."""
    return _lookup_keys(m.keys, packed)


def octant_lookup_reference(keys: torch.Tensor, queries: torch.Tensor,
                            cell_size: float) -> torch.Tensor:
    """Plain version of K1: slot ids int32[Q, 8] of the 2x2x2 block of cells
    nearest each query (the lookup half of ``gather_candidates``)."""
    nq = queries.shape[0]
    return _lookup_keys(keys, octant_cells(queries, cell_size).reshape(-1)
                        ).reshape(nq, 8)


def octant_cells(queries: torch.Tensor, cell_size: float) -> torch.Tensor:
    """Packed keys int32[Q, 8] of the 2x2x2 block of cells nearest each
    query, in the JAX package's octant order."""
    scaled = true_div(queries, cell_size)
    cell = torch.floor(scaled).to(torch.int32)
    frac = scaled - cell.to(queries.dtype)
    side = torch.where(frac < 0.5, -1, 1).to(torch.int32)  # [Q,3]
    # octant o = 4*bx + 2*by + bz: the 8 corners of {0, 1}^3 in the JAX
    # package's order
    o = torch.arange(8, dtype=torch.int32, device=queries.device)
    corners = torch.stack([(o >> 2) & 1, (o >> 1) & 1, o & 1], dim=-1)
    ncells = cell[:, None, :] + corners[None] * side[:, None, :]
    return pack_cells(ncells)


def octant_lookup(keys: torch.Tensor, queries: torch.Tensor,
                  cell_size: float) -> torch.Tensor:
    """K1: slot ids int32[Q, 8] of the octant cells nearest each query."""
    if queries.is_cuda:
        return kernels.octant_lookup(keys, queries, cell_size)
    if queries.device.type == "cpu":
        return octant_lookup_reference(keys, queries, cell_size)
    raise ValueError(f"octant_lookup: unsupported device {queries.device}")


def _nearest_lanes(planes, valid: torch.Tensor, queries: torch.Tensor,
                   k: int):
    """The k candidate lanes nearest each query, of coordinate planes
    (x, y, z), each [Q, L]: squared distance ((x-qx)^2 + (y-qy)^2) +
    (z-qz)^2, BIG where ``valid`` is false, the k smallest in (distance,
    lane) order — a stable sort, since ``torch.topk`` does not guarantee
    the lower lane wins a tie.  Returns (the winners' coordinate planes,
    each [Q, k]; sq [Q, k]; lane int64[Q, k]): gathered, never a one-hot
    product (0 * inf is NaN)."""
    cx, cy, cz = planes
    d2 = ((cx - queries[:, 0:1]) ** 2 + (cy - queries[:, 1:2]) ** 2
          + (cz - queries[:, 2:3]) ** 2)
    d2 = torch.where(valid, d2, BIG)
    sq, lane = torch.sort(d2, dim=-1, stable=True)
    sq, lane = sq[:, :k], lane[:, :k]
    return tuple(torch.gather(c, 1, lane) for c in planes), sq, lane


def _candidate_planes(pts: torch.Tensor, slots: torch.Tensor):
    """The 8*C candidate lanes of each query's octant slots as coordinate
    planes (x, y, z), each [Q, 8C], and their validity (``gather_candidates``
    + ``cand_planes``).  Candidate lane ``o*C + c`` is point ``c`` of octant
    slot ``o``; a missing slot reads row 0 and is not valid."""
    nq = slots.shape[0]
    C = pts.shape[1] // 3
    cand = pts[torch.clamp_min(slots, 0)]  # [Q, 8, 3C]
    cvalid = (slots >= 0)[..., None].expand(nq, 8, C).reshape(nq, 8 * C)
    planes = tuple(cand[:, :, a * C:(a + 1) * C].reshape(nq, 8 * C)
                   for a in range(3))
    return planes, cvalid


def knn_select_reference(pts: torch.Tensor, slots: torch.Tensor,
                         queries: torch.Tensor, k: int):
    """Plain version of K2 (``gather_candidates`` + ``select_knn``).

    A missing slot's lanes have distance BIG; an empty lane of a live slot
    holds the BIG sentinel and squares to inf.  The k smallest distances
    are taken in (distance, lane) order.

    Returns (neighbours f32[Q,k,3], sq f32[Q,k], valid bool[Q,k],
    lane int64[Q,k])."""
    planes, cvalid = _candidate_planes(pts, slots)
    near, sq, lane = _nearest_lanes(planes, cvalid, queries, k)
    return torch.stack(near, dim=-1), sq, sq < BIG * 0.5, lane


def knn_select(pts: torch.Tensor, slots: torch.Tensor, queries: torch.Tensor,
               k: int):
    """K2: (neighbours f32[Q,k,3], sq f32[Q,k], valid bool[Q,k],
    lane[Q,k]) — see :func:`knn_select_reference` for the contract."""
    if queries.is_cuda:
        return kernels.knn_select(pts, slots, queries, k)
    if queries.device.type == "cpu":
        return knn_select_reference(pts, slots, queries, k)
    raise ValueError(f"knn_select: unsupported device {queries.device}")


class ReducedCandidates(NamedTuple):
    """The W candidates nearest each query, in (distance, lane) order, as
    coordinate planes.  Made once a scan by :func:`reduce_candidates`; the
    ICP refresh rounds select their k neighbours from these W lanes instead
    of the 8*C gathered ones.  A lane that is not valid holds no point of
    the query's cells (the BIG sentinel, or a point of table row 0)."""

    x: torch.Tensor  # f32[Q, W]
    y: torch.Tensor  # f32[Q, W]
    z: torch.Tensor  # f32[Q, W]
    valid: torch.Tensor  # bool[Q, W]


def reduce_candidates_reference(pts: torch.Tensor, slots: torch.Tensor,
                                queries: torch.Tensor,
                                w: int) -> ReducedCandidates:
    """Plain version of K9a (``gather_candidates`` + ``reduce_candidates``):
    :func:`knn_select_reference` at k = ``w`` with the planar layout.  With
    fewer than ``w`` live candidates the tail takes BIG (missing slot) and
    inf (empty lane) distances, ties to the lower lane, valid false."""
    planes, cvalid = _candidate_planes(pts, slots)
    (x, y, z), sq, _ = _nearest_lanes(planes, cvalid, queries, w)
    return ReducedCandidates(x, y, z, sq < BIG * 0.5)


def reduce_candidates(pts: torch.Tensor, slots: torch.Tensor,
                      queries: torch.Tensor, w: int) -> ReducedCandidates:
    """K9a: see :func:`reduce_candidates_reference` for the contract."""
    if queries.is_cuda:
        return ReducedCandidates(*kernels.reduce_candidates(pts, slots,
                                                            queries, w))
    if queries.device.type == "cpu":
        return reduce_candidates_reference(pts, slots, queries, w)
    raise ValueError(f"reduce_candidates: unsupported device {queries.device}")


def select_knn_reduced_reference(red: ReducedCandidates,
                                 queries: torch.Tensor, k: int):
    """Plain version of K9b (``select_knn_reduced``): the k nearest of the
    reduced lanes, lanes that are not valid at distance BIG.  Returns
    (neighbours f32[Q,k,3], sq f32[Q,k], valid bool[Q,k])."""
    near, sq, _ = _nearest_lanes((red.x, red.y, red.z), red.valid, queries, k)
    return torch.stack(near, dim=-1), sq, sq < BIG * 0.5


def select_knn_reduced(red: ReducedCandidates, queries: torch.Tensor, k: int):
    """K9b: see :func:`select_knn_reduced_reference` for the contract."""
    if queries.is_cuda:
        return kernels.select_reduced(red.x, red.y, red.z, red.valid, queries,
                                      k)
    if queries.device.type == "cpu":
        return select_knn_reduced_reference(red, queries, k)
    raise ValueError(f"select_knn_reduced: unsupported device "
                     f"{queries.device}")


def _run_start(flag: torch.Tensor) -> torch.Tensor:
    """Index of the first lane of each lane's run, given run-start flags."""
    idx = torch.arange(flag.shape[0], device=flag.device)
    return torch.cummax(torch.where(flag, idx, 0), dim=0).values


def insert(m: VoxelHashMap, cfg: MapConfig, xyz: torch.Tensor,
           mask: torch.Tensor, min_dist, max_writes: int = 0) -> VoxelHashMap:
    """Insert world-frame points, keeping stored points >= ``min_dist``
    apart.  Same sequence of stable sorts, allocation and prefix cap as the
    JAX package's insert, so the map matches it bit for bit.  Where the
    JAX code parks dropped lanes on out-of-range rows (``mode="drop"``),
    this code writes them to one trash row appended to each table, which is
    sliced off again: no index is ever out of range."""
    nb, B = m.keys.shape
    C = m.cell_capacity
    n = xyz.shape[0]
    dev = xyz.device
    trash = nb * B
    lane_ids = torch.arange(n, dtype=torch.int32, device=dev)
    min_dist = torch.as_tensor(min_dist, dtype=xyz.dtype, device=dev)

    # one lexicographic sort by (hash(cell), cell, fine-voxel hash)
    fine_h = hash_coords(voxel_coords(xyz, torch.clamp_min(min_dist, 1e-6)), 0)
    packed = pack_cells(voxel_coords(xyz, cfg.cell_size))
    scramble = (_bucket_scramble(packed) >> 1).to(torch.int32)
    sk_cell = torch.where(mask, packed, _INT_MAX)
    sk_hash = torch.where(mask, scramble, _INT_MAX)
    sk_fine = torch.where(mask, fine_h, _INT_MAX)
    order = _composite_sort_order(sk_cell, sk_fine)
    order = order[torch.argsort(sk_hash[order], stable=True)]
    xyz_s = xyz[order]
    packed_s = packed[order]
    key_s = sk_cell[order]
    fine_s = sk_fine[order]

    true1 = torch.ones((1,), dtype=torch.bool, device=dev)
    new_run = torch.cat([true1, key_s[1:] != key_s[:-1]])
    first_of_fine = new_run | torch.cat([true1, fine_s[1:] != fine_s[:-1]])
    mask_s = mask[order] & first_of_fine
    run_start = _run_start(new_run)  # first lane of each lane's cell run

    # resolve / allocate slots: each new cell takes the rank-th empty lane
    # of its bucket, rank = its position among its bucket's new cells
    slot = _lookup_keys(m.keys, packed_s)
    rep = new_run & mask_s & (slot < 0)
    bucket = _bucket_of(packed_s, nb)
    rep_bucket = torch.where(rep, bucket, _INT_MAX)
    border = torch.argsort(rep_bucket, stable=True)
    rb_sorted = rep_bucket[border]
    is_start = torch.cat([true1, rb_sorted[1:] != rb_sorted[:-1]])
    idx = torch.arange(n, device=dev)
    rank = torch.empty((n,), dtype=torch.int32, device=dev)
    rank[border] = (idx - _run_start(is_start)).to(torch.int32)

    empty_cum = torch.cumsum((m.keys == _EMPTY).to(torch.int32), dim=1)
    hit = empty_cum[bucket] == (rank + 1)[:, None]  # [N, B]
    got = rep & torch.any(hit, dim=-1)  # rank < #empty lanes, else drop
    elane = torch.argmax(hit.to(torch.int32), dim=-1).to(torch.int32)
    slot = torch.where(got, bucket * B + elane, slot)
    keys = torch.cat([m.keys.reshape(-1), m.keys.new_full((1,), _EMPTY)])
    keys[torch.where(got, bucket * B + elane, trash)] = packed_s
    keys = keys[:trash].reshape(nb, B)

    # every lane of a cell run takes the slot found at the run's first lane
    slot = torch.maximum(slot, torch.where(new_run, slot, -1)[run_start])
    ok = mask_s & (slot >= 0)
    safe_slot = torch.clamp_min(slot, 0)

    # distance gate vs. existing cell contents
    cnt_flat = m.cnt.reshape(nb * B)
    cell_pts = m.pts[safe_slot]  # [N, 3C]
    cell_cnt = cnt_flat[safe_slot]
    exist = torch.arange(C, dtype=torch.int32, device=dev)[None, :] \
        < cell_cnt[:, None]
    d2 = ((cell_pts[:, 0:C] - xyz_s[:, 0:1]) ** 2
          + (cell_pts[:, C:2 * C] - xyz_s[:, 1:2]) ** 2
          + (cell_pts[:, 2 * C:] - xyz_s[:, 2:3]) ** 2)
    d2 = torch.where(exist, d2, BIG)
    keep = ok & (torch.amin(d2, dim=-1) >= min_dist ** 2)

    # rank survivors within their cell, append
    inc = keep.to(torch.int32)
    ex_cum = torch.cumsum(inc, dim=0, dtype=torch.int32) - inc
    dest = cell_cnt + (ex_cum - ex_cum[run_start])
    write = keep & (dest < C)

    # cap the write set at the insert width (prefix in sorted order keeps
    # each cell's kept lanes contiguous from rank 0), compacted in order
    w_ins = min(max_writes if max_writes > 0 else cfg.insert_width, n)
    if w_ins < n:
        w_rank = torch.cumsum(write.to(torch.int32), dim=0) - 1
        write = write & (w_rank < w_ins)
        sel_keys = torch.where(write, n - lane_ids, 0)
        sel = torch.sort(sel_keys, descending=True, stable=True).indices[:w_ins]
        row_w = torch.where(write[sel], safe_slot[sel], trash)
        col_w = torch.clamp_max(dest[sel], C - 1)
        xyz_w = xyz_s[sel]
    else:
        row_w = torch.where(write, safe_slot, trash)
        col_w = torch.clamp_max(dest, C - 1)
        xyz_w = xyz_s
    pts = torch.cat([m.pts, m.pts.new_full((1, 3 * C), BIG)])
    pts[torch.cat([row_w, row_w, row_w]).long(),
        torch.cat([col_w, col_w + C, col_w + 2 * C]).long()] = torch.cat(
            [xyz_w[:, 0], xyz_w[:, 1], xyz_w[:, 2]])
    pts = pts[:trash]

    seg_id = torch.cumsum(new_run.to(torch.int64), dim=0) - 1
    adds = torch.zeros((n,), dtype=torch.int32, device=dev).index_add_(
        0, seg_id, write.to(torch.int32))
    rep_lane = new_run & (slot >= 0) & mask_s
    cnt = torch.cat([cnt_flat, cnt_flat.new_zeros((1,))]).index_add_(
        0, torch.where(rep_lane, safe_slot, trash).long(), adds[seg_id])
    return VoxelHashMap(keys=keys, pts=pts, cnt=cnt[:trash].reshape(nb, B))


def _wrapped_cell_delta(keys: torch.Tensor, center_cell: torch.Tensor):
    """Cell-coordinate delta to the center, modulo the pack period."""
    d = (unpack_cells(keys) - center_cell) & (_COORD_PERIOD - 1)
    return torch.where(d >= _COORD_PERIOD // 2, d - _COORD_PERIOD, d)


def evict_far(m: VoxelHashMap, cfg: MapConfig,
              center: torch.Tensor) -> VoxelHashMap:
    """Drop cells farther than ``evict_radius`` from ``center`` and restore
    the BIG sentinel on their point lanes."""
    center_cell = torch.floor(true_div(center, cfg.cell_size)).to(torch.int32)
    d = _wrapped_cell_delta(m.keys, center_cell).to(m.pts.dtype) * cfg.cell_size
    far = (m.keys != _EMPTY) & (torch.sum(d * d, dim=-1)
                                > float(np.float32(cfg.evict_radius)) ** 2)
    return VoxelHashMap(
        keys=torch.where(far, _EMPTY, m.keys),
        pts=torch.where(far.reshape(-1)[:, None], BIG, m.pts),
        cnt=torch.where(far, 0, m.cnt),
    )


def census_box(m: VoxelHashMap, cfg: MapConfig, center: torch.Tensor,
               half_extent: torch.Tensor) -> torch.Tensor:
    """Stored points whose cell center lies inside the box around
    ``center`` (reference get5x5LocalMapFeatureSize)."""
    center_cell = torch.floor(true_div(center, cfg.cell_size)).to(torch.int32)
    d = (_wrapped_cell_delta(m.keys, center_cell).to(m.pts.dtype) + 0.5) \
        * cfg.cell_size
    inside = (m.keys != _EMPTY) & torch.all(torch.abs(d) <= half_extent,
                                            dim=-1)
    return torch.sum(torch.where(inside, m.cnt, 0)).to(torch.int32)


def total_points(m: VoxelHashMap) -> torch.Tensor:
    """Stored points over the whole table."""
    return torch.sum(torch.where(m.keys != _EMPTY, m.cnt, 0)).to(torch.int32)


def extract_points(m: VoxelHashMap):
    """Every slot lane of the table as points [NB*B*C, 3] and their
    validity mask (a stored point of a live cell), flattened slot-major."""
    nb, B = m.keys.shape
    C = m.cell_capacity
    lanes = torch.arange(C, dtype=torch.int32, device=m.keys.device)
    valid = (m.keys != _EMPTY)[..., None] & (lanes < m.cnt[..., None])
    pts = torch.stack([m.pts[:, 0:C], m.pts[:, C:2 * C], m.pts[:, 2 * C:]],
                      dim=-1).reshape(-1, 3)
    return pts, valid.reshape(-1)
