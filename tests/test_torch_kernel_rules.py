"""The decision rules of four hand kernels, emulated in numpy where the
kernels cannot run (no card here), against the reference.

* K10 ``voxel_claim`` (``superodom_tpu_torch/csrc/voxel_claim.cu``) splits
  each claim table of 2^b slots over a cluster of CS blocks: slot s lives
  in block s >> (b - log2 CS) at offset s & (2^(b - log2 CS) - 1); every
  masked lane, in whatever order the lanes arrive, takes the minimum of
  its owner's word, and each block then marks keep for the lane each of
  its claimed words holds.  Held bit for bit
  against the JAX package's ``ops.voxel.voxel_downsample_scatter`` at 2^4,
  2^17 and 2^19 slots and CS = 4, 8 and 16, with the cluster size the
  kernel picks.
* K9a ``reduce_candidates`` (``csrc/knn_select.cu``) selects threshold,
  then rank: tau = the head of rank W-1 among the 32 lanes' sorted lists,
  the keys <= tau at a place j < W - (the rank of their lane's head)
  listed lane by lane, each listed key ranked by the count of listed keys
  below it.  Held against the JAX package's
  ``mapstate.reduce_candidates`` (``lax.top_k``) on integer-grid ties,
  missing slots and empty lanes (rows with fewer than W live lanes),
  lanes with no candidate (C not a multiple of 4); and its k nearest,
  its first k lanes, against K9b's plain version on its own planes with
  NaN queries of either sign.

* K9b ``select_reduced`` (``superodom_tpu_torch/csrc/select_reduced.cu``)
  selects by rank: the lanes of a query form a group of 16 (two queries a
  warp, W <= 16) or 32 lanes; each lane's key is (the bits of its float32
  squared distance, BIG where not valid; its lane), compared unsigned; its
  rank is the count of the query's W keys below it, and the lane of rank r
  < k writes output slot r.  Held bit for bit against the JAX package's
  ``mapstate.select_knn_reduced`` (``lax.top_k``) on integer-grid inputs
  full of distance ties, with rows that have no valid lane, and the
  kernel's mapping of threads to queries checked to cover every query once;
  queries with a NaN coordinate of either sign against the port's plain
  version (``mapstate.select_knn_reduced_reference``).
* K11b ``edge_fit`` (``csrc/edge_fit.cu``) picks the consensus line with
  one group maximum of the key (inlier count << 4) | (15 - j) over the
  lines j of a correspondence.  Held against the port's
  ``registration._edge_consensus`` (``torch.argmax``, the first maximum)
  on ties of two and three lines, rows with one valid lane, and random
  rows at every k the kernel takes.

Each comparison is exact: both sides do the same float32 operations on the
same values.  No step is compiled; JAX runs eagerly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from superodom_tpu import mapstate as jm  # noqa: E402
from superodom_tpu.ops import voxel as jv  # noqa: E402

from superodom_tpu_torch import mapstate as tm  # noqa: E402
from superodom_tpu_torch import registration as tr  # noqa: E402

BIG = np.float32(1e30)
SR_THREADS = 128  # csrc/select_reduced.cu
EF_GROUP = 16  # csrc/edge_fit.cu


def rank_select(x, y, z, valid, q, k):
    """K9b's rule over a launch: each thread's query and lane as the
    kernel maps them, its key, its rank, and the slot it writes."""
    nq, w = x.shape
    g = 16 if w <= 16 else 32
    per_block = (SR_THREADS // 32) * (32 // g)
    tid = np.arange(-(-nq // per_block) * SR_THREADS)
    block, t = tid // SR_THREADS, tid % SR_THREADS
    qi = (block * (SR_THREADS // 32) + (t >> 5)) * (32 // g) + (t & 31) // g
    lane = (t & 31) & (g - 1)
    live = (qi < nq) & (lane < w)
    seen = np.zeros((nq, w), int)
    np.add.at(seen, (qi[live], lane[live]), 1)
    assert (seen == 1).all()  # every (query, lane) once

    dx, dy, dz = (c - q[:, a:a + 1] for a, c in enumerate((x, y, z)))
    d = np.where(valid, (dx * dx + dy * dy) + dz * dz, BIG).astype(np.float32)
    bits = d.view(np.uint32)
    lanes = np.arange(w)
    below = (bits[:, None, :] < bits[:, :, None]) | (
        (bits[:, None, :] == bits[:, :, None])
        & (lanes[None, None, :] < lanes[None, :, None]))
    rank = below.sum(-1)  # [Q, W]: a permutation of 0..W-1 in each row
    assert (np.sort(rank, axis=1) == lanes).all()
    pts = np.zeros((nq, k, 3), np.float32)
    sq = np.zeros((nq, k), np.float32)
    for r, j in zip(*np.nonzero(rank < k)):
        pts[r, rank[r, j]] = (x[r, j], y[r, j], z[r, j])
        sq[r, rank[r, j]] = d[r, j]
    return pts, sq, sq < BIG * np.float32(0.5)


def grid_rows(rng, nq, w):
    """Lanes and queries on a 5 x 5 x 5 integer grid (ties of three and
    more), every fourth row with no valid lane."""
    x, y, z = (rng.integers(-2, 3, (nq, w)).astype(np.float32)
               for _ in range(3))
    valid = rng.random((nq, w)) < 0.75
    valid[::4] = False
    q = rng.integers(-1, 2, (nq, 3)).astype(np.float32)
    return x, y, z, valid, q


@pytest.mark.parametrize("w", [5, 16, 20, 32])
def test_rank_selection_matches_jax_top_k(w):
    rng = np.random.default_rng(w)
    x, y, z, valid, q = grid_rows(rng, 67, w)
    red = jm.ReducedCandidates(*(jnp.asarray(a) for a in (x, y, z, valid)))
    for k in sorted({1, 5, w}):
        got = rank_select(x, y, z, valid, q, k)
        want = [np.asarray(a) for a in jm.select_knn_reduced(
            red, jnp.asarray(q), k)]
        assert not want[2][::4].any() and want[2].any()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), (w, k)


def test_rank_selection_puts_nan_after_big():
    """Queries with a NaN coordinate of either sign: a valid lane's key is
    a NaN's bits, which the unsigned comparison puts after BIG (a signed
    one would put a negative NaN first), as the port's plain version's
    sort puts NaN last; held against it with NaN equal to NaN."""
    rng = np.random.default_rng(7)
    for w, k in ((16, 5), (20, 10)):
        x, y, z, valid, q = grid_rows(rng, 21, w)
        q[1, 0] = np.nan
        q[2, 2] = -np.float32(np.nan)
        valid[1:3] = True
        valid[1:3, [0, w // 2]] = False  # two BIG lanes before the NaNs
        got = rank_select(x, y, z, valid, q, k)
        red = tm.ReducedCandidates(*(torch.from_numpy(a)
                                     for a in (x, y, z, valid)))
        want = [t.numpy() for t in tm.select_knn_reduced_reference(
            red, torch.from_numpy(q), k)]
        assert np.isnan(want[1][1:3]).any()
        for a, b in zip(got, want):
            assert np.array_equal(a, b, equal_nan=a.dtype != bool), (w, k)


def keyed_consensus(neigh, nvalid, max_dist_inlier):
    """K11b's rule: lane j's line through p1 and neighbour j+1, its inlier
    bits and count as the kernel computes them, the group maximum of
    (count << 4) | (15 - j), and the selected set of the winner."""
    m, k, _ = neigh.shape
    rel = neigh[:, 1:] - neigh[:, :1]  # [M, k-1, 3]: rel[c]
    nr = np.sqrt(((rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1])
                  + rel[..., 2] * rel[..., 2]))
    dirs = rel / np.where(nr < 1e-12, np.float32(1e-12), nr)[..., None]
    r, d = rel[:, None, :, :], dirs[:, :, None, :]  # [M, j, c, 3]
    cr = np.stack([r[..., 1] * d[..., 2] - r[..., 2] * d[..., 1],
                   r[..., 2] * d[..., 0] - r[..., 0] * d[..., 2],
                   r[..., 0] * d[..., 1] - r[..., 1] * d[..., 0]], -1)
    dist = (cr[..., 0] * cr[..., 0] + cr[..., 1] * cr[..., 1]) \
        + cr[..., 2] * cr[..., 2]
    nv = nvalid[:, 1:]
    eye = np.eye(k - 1, dtype=bool)
    inl = ((dist < np.float32(max_dist_inlier ** 2)) | eye) \
        & nv[:, None, :] & nv[:, :, None]
    cnt = inl.sum(-1)
    lanes = np.arange(EF_GROUP)
    key = np.zeros((m, EF_GROUP), np.uint32)
    key[:, :k - 1] = (cnt << 4) | (EF_GROUP - 1 - lanes[:k - 1])
    win = EF_GROUP - 1 - (key.max(-1) & 15).astype(int)
    return np.concatenate([nvalid[:, :1], inl[np.arange(m), win]], -1)


def line_rows(rng, m, k):
    """Neighbourhoods near random lines (noise of a few cm), about 30% of
    the points moved up to 0.5 m off them, and random invalid lanes."""
    base = rng.uniform(-5, 5, (m, 1, 3))
    u = rng.normal(size=(m, 1, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    t = rng.uniform(-0.6, 0.6, (m, k, 1))
    pts = base + t * u + rng.normal(scale=0.03, size=(m, k, 3))
    out = rng.random((m, k)) < 0.3
    pts[out] += rng.uniform(-0.5, 0.5, (int(out.sum()), 3))
    return pts.astype(np.float32), rng.random((m, k)) < 0.85


def _hold_consensus(neigh, nvalid):
    got = keyed_consensus(neigh, nvalid, 0.2)
    want, _, _ = tr._edge_consensus(torch.from_numpy(neigh),
                                    torch.from_numpy(nvalid), 0.2)
    assert np.array_equal(got, want.numpy())
    return got


def test_keyed_maximum_matches_consensus_on_random_rows():
    for k in (2, 3, 9, 10, 16):
        rng = np.random.default_rng(k)
        neigh, nvalid = line_rows(rng, 400, k)
        sel = _hold_consensus(neigh, nvalid)
        assert sel.sum(-1).max() >= min(k, 3), k


def test_keyed_maximum_ties_and_one_valid_lane():
    """Ties of two lines (neighbours alternating on two axes, the last one
    off both) and of three (three axes in turn), where the first line must
    win, and rows with one valid lane: the nearest (every count 0, line 0
    wins) or another (its own line, count 1, wins), at k = 10 and 16."""
    for k in (10, 16):
        rows, first = [], []
        for n_axes in (2, 3):
            for a0 in range(3):
                axes = [a0, (a0 + 1) % 3, (a0 + 2) % 3][:n_axes]
                p = np.zeros((k, 3), np.float32)
                for i in range(1, k):
                    p[i, axes[(i - 1) % n_axes]] = 0.25 * (1 + (i - 1)
                                                           // n_axes)
                if n_axes == 2:
                    p[-1] = 0.7
                rows.append(p + np.float32(a0))
                first.append(a0)
        neigh = np.stack(rows + rows[:2])
        nvalid = np.ones(neigh.shape[:2], bool)
        nvalid[-2, 1:] = False  # one valid lane, the nearest
        nvalid[-1, :] = False
        nvalid[-1, 3] = True  # one valid lane, neighbour 3
        sel = _hold_consensus(neigh, nvalid)
        for r, a0 in enumerate(first):  # the winner's points lie on axis a0
            off = neigh[r, sel[r]] - neigh[r, 0]
            assert sel[r].sum() > 1
            assert np.all(np.delete(off, a0, axis=1) == 0.0), (k, r)
        assert sel[-2].tolist() == [True] + [False] * (k - 1)
        assert sel[-1].tolist() == [i == 3 for i in range(k)]


# ------------------------------------------------------------------ K10

VC_PART_MAX_BITS, VC_CL_THREADS = 15, 1024  # csrc/voxel_claim.cu


def cluster_size(bits, n, n_inst=1):
    """``vc_cluster_size``: the blocks the table needs at 2^15 slots a
    block, then more (at least 4 slots a block): up to 16 while a block
    has over 256 lanes for a launch of at most 4 instances, up to 8 while
    it has over 2,048 for a fleet."""
    few = n_inst <= 4
    max_lg, per_block = (4, VC_CL_THREADS // 4) if few else (
        3, 2 * VC_CL_THREADS)
    lg = max(bits - VC_PART_MAX_BITS, 0)
    while lg < max_lg and bits - lg > 2 and per_block << lg < n:
        lg += 1
    return 1 << lg


def cluster_claim(xyz, mask, res, bits, cs, rng):
    """K10's cluster form over a cluster of ``cs`` blocks, the lanes
    arriving in a shuffled order."""
    n = len(xyz)
    c = np.floor(xyz / np.float32(res)).astype(np.int32).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = (c[:, 0] * np.uint32(73856093) + c[:, 1] * np.uint32(19349663)
             + c[:, 2] * np.uint32(83492791) + np.uint32(0x9E3779B9))
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    slot = (h & np.uint32((1 << bits) - 1)).astype(np.int64)
    part_bits = bits - (cs.bit_length() - 1)
    owner, off = slot >> part_bits, slot & ((1 << part_bits) - 1)
    assert owner.max() < cs and np.array_equal((owner << part_bits) | off,
                                               slot)
    parts = np.full((cs, 1 << part_bits), 2 ** 31 - 1, np.int64)
    order = rng.permutation(n)
    order = order[mask[order]]
    # one atomicMin a lane, in arrival order
    np.minimum.at(parts, (owner[order], off[order]), order)
    # each block marks the lane its claimed slots hold
    keep = np.zeros(n, bool)
    keep[parts[parts != 2 ** 31 - 1]] = True
    return keep


def test_cluster_claim_matches_jax_scatter():
    rng = np.random.default_rng(3)
    assert cluster_size(17, 10923) == 16 and cluster_size(19, 43691) == 16
    assert cluster_size(17, 10923, 64) == 8 and cluster_size(17, 1) == 4
    assert cluster_size(4, 43691) == 4 and cluster_size(14, 4000, 64) == 2
    for bits, n in ((4, 3000), (17, 10923), (19, 43691)):
        xyz = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
        xyz[: n // 2, 2] = -1.5  # a floor: many lanes a voxel
        xyz[: n // 8] = np.round(xyz[: n // 8])  # lanes on voxel faces
        mask = rng.random(n) > 0.15
        for res in (0.2, 0.5):
            want = np.asarray(jv.voxel_downsample_scatter(
                jnp.asarray(xyz), jnp.asarray(mask), res, table_bits=bits))
            css = {cluster_size(bits, n)} | {
                cs for cs in (4, 8, 16) if bits - cs.bit_length() + 1 >= 2
                and bits - cs.bit_length() + 1 <= VC_PART_MAX_BITS}
            for cs in sorted(css):
                got = cluster_claim(xyz, mask, res, bits, cs, rng)
                assert np.array_equal(got, want), (bits, res, cs)
            assert want.any() and want.sum() < mask.sum()


# ------------------------------------------------------------------ K9a


def threshold_rank_reduce(cand, cvalid, q, w):
    """K9a's rule: the keys (distance bits << 32 | lane) of each warp lane
    l = o*4 + s (points s*P .. s*P+P-1 of octant row o, ~0 where there is
    no point), sorted; tau, the listed keys <= tau and their ranks; the
    winner of rank r < W at output lane r."""
    nq, _, three_c = cand.shape
    C = three_c // 3
    P = -(-C // 4)
    cx, cy, cz = (cand[:, :, a * C:(a + 1) * C].reshape(nq, 8 * C)
                  for a in range(3))
    with np.errstate(over="ignore", invalid="ignore"):
        dx, dy, dz = cx - q[:, :1], cy - q[:, 1:2], cz - q[:, 2:]
        d = ((dx * dx + dy * dy) + dz * dz).astype(np.float32)
    d = np.where(cvalid, d, BIG).astype(np.float32)  # a missing row: BIG
    bits = d.view(np.uint32).astype(np.uint64)
    key = np.full((nq, 32, P), np.uint64(2 ** 64 - 1))
    for lane in range(32):
        o, c0 = lane >> 2, (lane & 3) * P
        for j in range(P):
            if c0 + j < C:
                idx = o * C + c0 + j
                key[:, lane, j] = (bits[:, idx] << np.uint64(32)) | \
                    np.uint64(idx)
    key.sort(axis=-1)
    hd = (key[:, :, 0] >> np.uint64(32)).astype(np.uint32)
    lanes = np.arange(32)
    hr = ((hd[:, None, :] < hd[:, :, None]).sum(-1)
          + ((hd[:, None, :] == hd[:, :, None])
             & (lanes[None, None, :] < lanes[None, :, None])).sum(-1))
    assert (np.sort(hr, axis=1) == lanes).all()  # a permutation
    x, y, z = (np.zeros((nq, w), np.float32) for _ in range(3))
    valid = np.zeros((nq, w), bool)
    for r in range(nq):
        tau = key[r, hr[r] == w - 1, 0][0]
        # a lane's key at j has hr + j keys below it: j < W - hr to win
        listed = np.concatenate([
            key[r, lane][(key[r, lane] <= tau)
                         & (np.arange(P) < w - hr[r, lane])]
            for lane in range(32)])
        assert w <= len(listed) <= 32 * P
        rank = (listed[None, :] < listed[:, None]).sum(-1)
        win = np.nonzero(rank < w)[0]
        assert np.array_equal(np.sort(rank[win]), np.arange(w))
        for i in win:
            idx = int(listed[i] & np.uint64(0xFFFFFFFF))
            x[r, rank[i]], y[r, rank[i]], z[r, rank[i]] = \
                cx[r, idx], cy[r, idx], cz[r, idx]
            valid[r, rank[i]] = d[r, idx] < BIG * np.float32(0.5)
    return x, y, z, valid


def grid_candidates(rng, nq, C):
    """Candidate rows on an integer grid (ties of many lanes), a third of
    the lanes empty (the BIG sentinel: inf), every octant row of every
    fifth query and some rows elsewhere missing (fewer than W live)."""
    cand = rng.integers(-2, 3, (nq, 8, 3 * C)).astype(np.float32)
    empty = rng.random((nq, 8, C)) < 0.33
    for a in range(3):
        cand[:, :, a * C:(a + 1) * C][empty] = BIG
    row = rng.random((nq, 8)) < 0.7
    row[::5, 1:] = False
    cvalid = np.repeat(row, C, axis=1).reshape(nq, 8 * C)
    q = rng.integers(-1, 2, (nq, 3)).astype(np.float32)
    return cand, cvalid, q


def test_threshold_rank_matches_jax_reduce():
    for C in (5, 16, 24):
        rng = np.random.default_rng(C)
        cand, cvalid, q = grid_candidates(rng, 60, C)
        for w in (5, 16, 20, 32):
            got = threshold_rank_reduce(cand, cvalid, q, w)
            want = jm.reduce_candidates(jnp.asarray(cand), jnp.asarray(cvalid),
                                        jnp.asarray(q), w)
            v = np.asarray(want.valid)
            assert np.array_equal(got[3], v), (C, w)
            for a, b in zip(got[:3], want[:3]):
                assert np.array_equal(a[v], np.asarray(b)[v]), (C, w)
            assert (v.sum(1) < w).any() and v.any()


def test_reduced_first_lanes_are_select_knn_reduced():
    """The plain K9a's k nearest (its first k lanes, BIG where not valid)
    against K9b's plain version on its own planes at the same queries,
    every lane, with NaN queries of either sign (their lanes all invalid:
    K9b ranks them by lane, which is K9a's order)."""
    rng = np.random.default_rng(11)
    C, nq = 16, 40
    pts = rng.integers(-3, 4, (30, 3 * C)).astype(np.float32)
    pts[rng.random(pts.shape) < 0.2] = BIG
    slots = rng.integers(-1, 30, (nq, 8)).astype(np.int32)
    slots[::7] = -1
    q = rng.integers(-2, 3, (nq, 3)).astype(np.float32)
    q[1, 0] = np.nan
    q[2] = -np.float32(np.nan)
    q[3, 2] = -np.float32(np.nan)
    for w, k in ((16, 5), (20, 10), (32, 32)):
        red, near = tm.reduce_candidates_reference(
            torch.from_numpy(pts), torch.from_numpy(slots),
            torch.from_numpy(q), w, k)
        want = tm.select_knn_reduced_reference(red, torch.from_numpy(q), k)
        for a, b in zip(near, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a.numpy(), b.numpy(),
                                  equal_nan=a.dtype != torch.bool), (w, k)
        assert not near[2][1:4].any() and near[2].any()
        assert (~near[2][4:]).any()  # rows with fewer than k valid lanes
