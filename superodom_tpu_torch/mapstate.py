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
* K2's gathered mode — the same selection over candidate rows a caller
  has gathered (``gather_candidates``) with any lane mask: the library's
  ``select_knn``, which no replay path calls.
* ``reduce_candidates`` (K9a) — K2's selection at k = W, materialised as
  planes ``[Q, W]`` once a scan; ``select_reduced`` (K9b) — the k nearest
  among those W lanes, for the ICP rounds after the first
  (``RegistrationConfig.refresh_width``).

Each has a plain PyTorch version here (``*_reference``) with the JAX
package's layout; CPU tensors take it, CUDA tensors take the kernel.
All functions are pure: they return new tensors and never modify the map.

A table may be split over M shards (:class:`ShardedMap`, the JAX
package's ``model`` axis): shard j holds buckets ``[j*NB/M, (j+1)*NB/M)``
and their slots, each shard on a device of its own.  The map functions
take either form.  A sharded lookup is K1 with a shard window on every
shard, merged by an elementwise maximum; the ICP rounds read a compact
candidate table gathered once a scan (:func:`candidate_view`), so K2, K9a
and K11b's candidates run on it unchanged; an insert decides everything on
the device of its points and routes each write to the shard that owns its
row.  Either form gives the unsplit table's results to the bit.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from superodom_tpu_torch import kernel_ops, kernels
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


class ShardedMap(NamedTuple):
    """One voxel-hash table split over M shards (M a power of two dividing
    NB), the JAX package's split of a map over its ``model`` axis
    (``parallel._state_pspec``): shard j is a :class:`VoxelHashMap` of the
    NB/M consecutive buckets from ``j*NB/M`` and of their slots, so the
    global bucket b and its slots ``b*B + lane`` live on shard
    ``b // (NB/M)``.  Each shard may lie on its own device."""

    shards: Tuple[VoxelHashMap, ...]

    @property
    def cell_capacity(self) -> int:
        return self.shards[0].cell_capacity


def shard_map_table(m: VoxelHashMap, devices: Sequence) -> ShardedMap:
    """Split ``m`` (any leading instance dimensions) into one shard a
    device of ``devices``; :func:`unshard` is its inverse."""
    M = len(devices)
    nb, B = m.keys.shape[-2:]
    if M < 1 or M & (M - 1) or nb % M:
        raise ValueError(f"a table of {nb} buckets does not split into {M} "
                         f"shards (a power of two dividing the buckets)")
    nbl = nb // M
    return ShardedMap(tuple(VoxelHashMap(
        keys=m.keys.narrow(-2, j * nbl, nbl).to(d).contiguous(),
        pts=m.pts.narrow(-2, j * nbl * B, nbl * B).to(d).contiguous(),
        cnt=m.cnt.narrow(-2, j * nbl, nbl).to(d).contiguous())
        for j, d in enumerate(devices)))


def unshard(m) -> VoxelHashMap:
    """The whole table of a :class:`ShardedMap`, on shard 0's device (a
    :class:`VoxelHashMap` as it is)."""
    if isinstance(m, VoxelHashMap):
        return m
    home = m.shards[0].keys.device
    return VoxelHashMap(*(torch.cat([getattr(s, f).to(home)
                                     for s in m.shards], dim=-2)
                          for f in VoxelHashMap._fields))


def _shards(m) -> Tuple[VoxelHashMap, ...]:
    return m.shards if isinstance(m, ShardedMap) else (m,)


def _merged(m, home, fn) -> torch.Tensor:
    """``fn(shard, bucket_lo, nb_total)`` (global slots, -1 where none) on
    every shard with its window, merged by an elementwise maximum on
    ``home``; on a whole table ``fn(m, 0, 0)``."""
    shards = _shards(m)
    nbl = shards[0].keys.shape[-2]
    nb_total = nbl * len(shards) if len(shards) > 1 else 0
    out = None
    for j, sh in enumerate(shards):
        got = fn(sh, j * nbl, nb_total).to(home)
        out = got if out is None else torch.maximum(out, got)
    return out


def _take(tables, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """Rows ``idx`` (in ``[0, M*rows)``) of a table split into M pieces of
    ``rows`` rows (``tables``, piece j holding rows ``[j*rows,
    (j+1)*rows)``), gathered from their owners onto ``idx``'s device."""
    if len(tables) == 1:
        return tables[0][idx]
    owner = idx // rows
    out = None
    for j, t in enumerate(tables):
        mine = owner == j
        got = t[torch.where(mine, idx - j * rows, 0).to(t.device)].to(
            idx.device)
        out = got if out is None else torch.where(
            mine.reshape(mine.shape + (1,) * (got.dim() - mine.dim())),
            got, out)
    return out


def _local(idx: torch.Tensor, j: int, rows: int) -> torch.Tensor:
    """Global rows ``idx`` (-1: none) -> shard j's own rows; ``rows``, the
    shard's trash row, for -1 and for rows of other shards."""
    return torch.where((idx >= 0) & (idx // rows == j), idx - j * rows, rows)


def _lookup_keys(keys: torch.Tensor, packed: torch.Tensor,
                 bucket_lo: int = 0, nb_total: int = 0) -> torch.Tensor:
    """The slot of each packed key in a key table: the first matching lane
    of its bucket row, -1 if absent.  A shard window: ``keys`` holds
    buckets ``[bucket_lo, bucket_lo + NB)`` of a table of ``nb_total``
    (0: the table is whole); a key hashed outside the window gives -1, a
    hit its global slot."""
    nb, B = keys.shape
    bucket = _bucket_of(packed, nb_total or nb)
    local = bucket - bucket_lo
    inside = (local >= 0) & (local < nb)
    # [Q, B] bucket-row gather
    match = (keys[torch.clamp(local, 0, nb - 1)] == packed[:, None]) \
        & inside[:, None]
    lane = torch.argmax(match.to(torch.int32), dim=-1).to(torch.int32)
    return torch.where(torch.any(match, dim=-1), bucket * B + lane, -1)


def lookup_packed(m, packed: torch.Tensor) -> torch.Tensor:
    """Packed cell keys [Q] -> flat slot index [Q] (bucket*B + lane), -1 if
    absent: the first matching lane of the key's bucket row.  On a
    :class:`ShardedMap` each shard looks up its window and the answers
    merge on the device of ``packed``."""
    return _merged(m, packed.device, lambda s, lo, nbt: _lookup_keys(
        s.keys, packed.to(s.keys.device), lo, nbt))


def lookup(m, cfg: MapConfig, cells: torch.Tensor
           ) -> torch.Tensor:
    """Integer cell coords [Q,3] -> flat slot [Q] or -1."""
    return lookup_packed(m, pack_cells(cells))


def octant_lookup_reference(keys: torch.Tensor, queries: torch.Tensor,
                            cell_size: float, bucket_lo: int = 0,
                            nb_total: int = 0) -> torch.Tensor:
    """Plain version of K1: slot ids int32[Q, 8] of the 2x2x2 block of cells
    nearest each query (the lookup half of ``gather_candidates``); with a
    shard window as :func:`_lookup_keys` has it."""
    nq = queries.shape[0]
    return _lookup_keys(keys, octant_cells(queries, cell_size).reshape(-1),
                        bucket_lo, nb_total).reshape(nq, 8)


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
                  cell_size: float, bucket_lo: int = 0,
                  nb_total: int = 0) -> torch.Tensor:
    """K1: slot ids int32[Q, 8] of the octant cells nearest each query
    (with a shard window: see :func:`octant_lookup_reference`)."""
    if queries.is_cuda:
        return kernel_ops.octant_lookup(keys, queries, float(cell_size),
                                        bucket_lo, nb_total)
    if queries.device.type == "cpu":
        return octant_lookup_reference(keys, queries, cell_size, bucket_lo,
                                       nb_total)
    raise ValueError(f"octant_lookup: unsupported device {queries.device}")


def candidate_view(m, queries: torch.Tensor, cell_size: float):
    """The point table and the octant slots int32[Q, 8] (K1) that K2, K9a
    and K11b's candidates read for ``queries``: on a whole table its own
    point table and slots, no copy.  On a :class:`ShardedMap`, K1 with a
    shard window on every shard, merged, and a compact table on the
    queries' device gathered from the owning shards: row 0 the global
    table's row 0 (which a missing slot reads), row ``1 + 8q + o`` the
    row of query q's octant o, the slots remapped to those rows (-1 stays
    -1).  The candidates' lanes keep their numbering, so the selections
    on the view are the whole table's to the bit."""
    if isinstance(m, VoxelHashMap):
        return m.pts, octant_lookup(m.keys, queries, cell_size)
    home = queries.device
    slots = _merged(m, home, lambda sh, lo, nbt: octant_lookup(
        sh.keys, queries.to(sh.keys.device), cell_size, lo, nbt))
    nq = slots.shape[0]
    rows = _take([sh.pts for sh in m.shards],
                 torch.clamp_min(slots.reshape(-1), 0),
                 m.shards[0].pts.shape[-2])
    pts = torch.cat([m.shards[0].pts[:1].to(home), rows])
    view = torch.arange(1, 8 * nq + 1, dtype=torch.int32,
                        device=home).reshape(nq, 8)
    return pts, torch.where(slots >= 0, view, -1)


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


def _candidate_rows(pts: torch.Tensor, slots: torch.Tensor):
    """The octant slots' rows (cand f32[Q,8,3C]) and their validity
    (bool[Q,8*C]): a missing slot reads row 0 and is not valid."""
    nq = slots.shape[0]
    C = pts.shape[1] // 3
    cand = pts[torch.clamp_min(slots, 0)]  # [Q, 8, 3C]
    cvalid = (slots >= 0)[..., None].expand(nq, 8, C).reshape(nq, 8 * C)
    return cand, cvalid


def cand_planes(cand: torch.Tensor):
    """Split gathered candidate rows ``cand`` f32[Q,8,3C] into coordinate
    planes (x, y, z), each [Q, 8C]: candidate lane ``o*C + c`` is point
    ``c`` of octant row ``o``."""
    nq, eight, three_c = cand.shape
    C = three_c // 3
    return tuple(cand[:, :, a * C:(a + 1) * C].reshape(nq, eight * C)
                 for a in range(3))


def _candidate_planes(pts: torch.Tensor, slots: torch.Tensor):
    """The 8*C candidate lanes of each query's octant slots as coordinate
    planes (x, y, z), each [Q, 8C], and their validity (``gather_candidates``
    + ``cand_planes``); a missing slot reads row 0 and is not valid."""
    cand, cvalid = _candidate_rows(pts, slots)
    return cand_planes(cand), cvalid


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
        return kernel_ops.knn_select(pts, slots, queries, k)
    if queries.device.type == "cpu":
        return knn_select_reference(pts, slots, queries, k)
    raise ValueError(f"knn_select: unsupported device {queries.device}")


def select_knn_reference(cand: torch.Tensor, cvalid: torch.Tensor,
                         queries: torch.Tensor, k: int):
    """Plain version of K2's gathered mode: the k nearest of the gathered
    candidates ``cand`` f32[Q,8,3C] whose lane mask ``cvalid`` bool[Q,8C]
    is set (any lane may be masked, not only whole octant rows), distance
    BIG for a masked lane, in (distance, lane) order.  Returns
    (neighbours f32[Q,k,3], sq f32[Q,k], valid bool[Q,k], lane
    int64[Q,k])."""
    near, sq, lane = _nearest_lanes(cand_planes(cand), cvalid, queries, k)
    return torch.stack(near, dim=-1), sq, sq < BIG * 0.5, lane


def select_knn(cand: torch.Tensor, cvalid: torch.Tensor,
               queries: torch.Tensor, k: int):
    """Top-k nearest among gathered candidates (the JAX package's
    ``select_knn``): K2's gathered mode on the card, its plain version
    :func:`select_knn_reference` on the CPU.  Returns ``(pts f32[Q,k,3],
    sqdist f32[Q,k], valid bool[Q,k])``."""
    if queries.is_cuda:
        out = kernels.knn_select_gathered(cand.contiguous(),
                                          cvalid.contiguous(),
                                          queries.contiguous(), k)
    elif queries.device.type == "cpu":
        out = select_knn_reference(cand, cvalid, queries, k)
    else:
        raise ValueError(f"select_knn: unsupported device {queries.device}")
    return out[:3]


def query_knn(m, cfg: MapConfig, queries: torch.Tensor,
              k: int):
    """K nearest stored points per query among the 2x2x2 block of cells
    nearest it (the reference's per-block octree KNN, LocalMap.h:481-525):
    K1 :func:`octant_lookup`, then K2 :func:`knn_select` — the kernels on
    the card, their plain versions on the CPU.

    Returns ``(pts f32[Q,k,3], sqdist f32[Q,k], valid bool[Q,k])``."""
    pts, sq, valid, _ = knn_select(*candidate_view(m, queries, cfg.cell_size),
                                   queries, k)
    return pts, sq, valid


def gather_candidates(m, cfg: MapConfig,
                      queries: torch.Tensor):
    """The candidate point sets of a batch of queries: the 2x2x2 block of
    cells nearest each query (slots from K1 :func:`octant_lookup`).
    Returns (cand f32[Q,8,3C] — one coordinate-planar slot row per octant
    cell — and valid bool[Q,8*C]); a missing cell reads row 0 and is not
    valid."""
    return _candidate_rows(*candidate_view(m, queries, cfg.cell_size))


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
        return ReducedCandidates(*kernel_ops.reduce_candidates(
            pts, slots, queries, w))
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
        return kernel_ops.select_reduced(red.x, red.y, red.z, red.valid,
                                         queries, k)
    if queries.device.type == "cpu":
        return select_knn_reduced_reference(red, queries, k)
    raise ValueError(f"select_knn_reduced: unsupported device "
                     f"{queries.device}")


def _run_start(flag: torch.Tensor) -> torch.Tensor:
    """Index of the first lane of each lane's run, given run-start flags."""
    idx = torch.arange(flag.shape[0], device=flag.device)
    return torch.cummax(torch.where(flag, idx, 0), dim=0).values


def insert(m, cfg: MapConfig, xyz: torch.Tensor, mask: torch.Tensor,
           min_dist, max_writes: int = 0):
    """Insert world-frame points, keeping stored points >= ``min_dist``
    apart.  Same sequence of stable sorts, allocation and prefix cap as the
    JAX package's insert, so the map matches it bit for bit.  Where the
    JAX code parks dropped lanes on out-of-range rows (``mode="drop"``),
    this code writes them to one trash row appended to each table, which is
    sliced off again: no index is ever out of range.

    On a :class:`ShardedMap` every decision is taken on the device of
    ``xyz`` as for a whole table (the sorts, the thinning, the allocation,
    the distance gate and the insert-width cap, a prefix in hash order that
    spans every shard): the key rows, counts and cell rows are read from
    their owners, and each key, point and count write goes to the shard
    that owns its row (the others' to their trash rows).  The result is the
    whole table's insert, split."""
    shards = _shards(m)
    nbl, B = shards[0].keys.shape
    nb = nbl * len(shards)
    R = nbl * B  # slots a shard; row R of each shard is its trash row
    C = m.cell_capacity
    n = xyz.shape[0]
    dev = xyz.device
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
    slot = lookup_packed(m, packed_s)
    rep = new_run & mask_s & (slot < 0)
    bucket = _bucket_of(packed_s, nb)
    rep_bucket = torch.where(rep, bucket, _INT_MAX)
    border = torch.argsort(rep_bucket, stable=True)
    rb_sorted = rep_bucket[border]
    is_start = torch.cat([true1, rb_sorted[1:] != rb_sorted[:-1]])
    idx = torch.arange(n, device=dev)
    # border is a permutation: the scatter writes every lane once
    rank = torch.zeros_like(border, dtype=torch.int32).scatter(
        0, border, (idx - _run_start(is_start)).to(torch.int32))

    # the empty lanes counted along each lane's bucket row
    empty_cum = torch.cumsum((_take([sh.keys for sh in shards], bucket, nbl)
                              == _EMPTY).to(torch.int32), dim=1)  # [N, B]
    hit = empty_cum == (rank + 1)[:, None]
    got = rep & torch.any(hit, dim=-1)  # rank < #empty lanes, else drop
    elane = torch.argmax(hit.to(torch.int32), dim=-1).to(torch.int32)
    new_slot = bucket * B + elane
    slot = torch.where(got, new_slot, slot)
    key_w = torch.where(got, new_slot, -1)  # the key writes' slots

    # every lane of a cell run takes the slot found at the run's first lane
    slot = torch.maximum(slot, torch.where(new_run, slot, -1)[run_start])
    ok = mask_s & (slot >= 0)
    safe_slot = torch.clamp_min(slot, 0)

    # distance gate vs. existing cell contents
    cell_pts = _take([sh.pts for sh in shards], safe_slot, R)  # [N, 3C]
    cell_cnt = _take([sh.cnt.reshape(R) for sh in shards], safe_slot, R)
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
        row_w = torch.where(write[sel], safe_slot[sel], -1)
        col_w = torch.clamp_max(dest[sel], C - 1)
        xyz_w = xyz_s[sel]
    else:
        row_w = torch.where(write, safe_slot, -1)
        col_w = torch.clamp_max(dest, C - 1)
        xyz_w = xyz_s
    cols3 = torch.cat([col_w, col_w + C, col_w + 2 * C]).long()
    vals3 = torch.cat([xyz_w[:, 0], xyz_w[:, 1], xyz_w[:, 2]])

    seg_id = torch.cumsum(new_run.to(torch.int64), dim=0) - 1
    adds = torch.zeros((n,), dtype=torch.int32, device=dev).index_add(
        0, seg_id, write.to(torch.int32))[seg_id]
    rep_lane = new_run & (slot >= 0) & mask_s
    cnt_w = torch.where(rep_lane, safe_slot, -1)

    # each shard takes the writes to its own rows
    out = []
    for j, sh in enumerate(shards):
        d = sh.keys.device
        keys = torch.cat([sh.keys.reshape(-1), sh.keys.new_full((1,), _EMPTY)])
        keys[_local(key_w, j, R).to(d)] = packed_s.to(d)
        rows = _local(row_w, j, R).to(d)
        pts = torch.cat([sh.pts, sh.pts.new_full((1, 3 * C), BIG)])
        pts[torch.cat([rows, rows, rows]).long(), cols3.to(d)] = vals3.to(d)
        cnt = torch.cat([sh.cnt.reshape(-1), sh.cnt.new_zeros((1,))]
                        ).index_add(0, _local(cnt_w, j, R).to(d).long(),
                                    adds.to(d))
        out.append(VoxelHashMap(keys=keys[:R].reshape(nbl, B), pts=pts[:R],
                                cnt=cnt[:R].reshape(nbl, B)))
    return out[0] if isinstance(m, VoxelHashMap) else ShardedMap(tuple(out))


def _wrapped_cell_delta(keys: torch.Tensor, center_cell: torch.Tensor):
    """Cell-coordinate delta to the center, modulo the pack period."""
    d = (unpack_cells(keys) - center_cell) & (_COORD_PERIOD - 1)
    return torch.where(d >= _COORD_PERIOD // 2, d - _COORD_PERIOD, d)


def _summed(m, home, fn) -> torch.Tensor:
    """An int32 count ``fn(shard)`` summed over the shards on ``home``."""
    if isinstance(m, VoxelHashMap):
        return fn(m)
    return torch.sum(torch.stack([fn(sh).to(home) for sh in m.shards])
                     ).to(torch.int32)


def evict_far(m, cfg: MapConfig, center: torch.Tensor):
    """Drop cells farther than ``evict_radius`` from ``center`` and restore
    the BIG sentinel on their point lanes (shard by shard)."""
    if isinstance(m, ShardedMap):
        return ShardedMap(tuple(evict_far(sh, cfg, center.to(sh.keys.device))
                                for sh in m.shards))
    center_cell = torch.floor(true_div(center, cfg.cell_size)).to(torch.int32)
    d = _wrapped_cell_delta(m.keys, center_cell).to(m.pts.dtype) * cfg.cell_size
    far = (m.keys != _EMPTY) & (torch.sum(d * d, dim=-1)
                                > float(np.float32(cfg.evict_radius)) ** 2)
    return VoxelHashMap(
        keys=torch.where(far, _EMPTY, m.keys),
        pts=torch.where(far.reshape(-1)[:, None], BIG, m.pts),
        cnt=torch.where(far, 0, m.cnt),
    )


def census_box(m, cfg: MapConfig, center: torch.Tensor,
               half_extent: torch.Tensor) -> torch.Tensor:
    """Stored points whose cell center lies inside the box around
    ``center`` (reference get5x5LocalMapFeatureSize), on ``center``'s
    device."""
    if isinstance(m, ShardedMap):
        return _summed(m, center.device, lambda sh: census_box(
            sh, cfg, center.to(sh.keys.device),
            half_extent.to(sh.keys.device)))
    center_cell = torch.floor(true_div(center, cfg.cell_size)).to(torch.int32)
    d = (_wrapped_cell_delta(m.keys, center_cell).to(m.pts.dtype) + 0.5) \
        * cfg.cell_size
    inside = (m.keys != _EMPTY) & torch.all(torch.abs(d) <= half_extent,
                                            dim=-1)
    return torch.sum(torch.where(inside, m.cnt, 0)).to(torch.int32)


def total_points(m) -> torch.Tensor:
    """Stored points over the whole table (on shard 0's device)."""
    if isinstance(m, ShardedMap):
        return _summed(m, m.shards[0].keys.device, total_points)
    return torch.sum(torch.where(m.keys != _EMPTY, m.cnt, 0)).to(torch.int32)


def extract_points(m):
    """Every slot lane of the table as points [NB*B*C, 3] and their
    validity mask (a stored point of a live cell), flattened slot-major
    (on shard 0's device)."""
    if isinstance(m, ShardedMap):
        home = m.shards[0].keys.device
        parts = [extract_points(sh) for sh in m.shards]
        return tuple(torch.cat([p[i].to(home) for p in parts])
                     for i in range(2))
    nb, B = m.keys.shape
    C = m.cell_capacity
    lanes = torch.arange(C, dtype=torch.int32, device=m.keys.device)
    valid = (m.keys != _EMPTY)[..., None] & (lanes < m.cnt[..., None])
    pts = torch.stack([m.pts[:, 0:C], m.pts[:, C:2 * C], m.pts[:, 2 * C:]],
                      dim=-1).reshape(-1, 3)
    return pts, valid.reshape(-1)
