"""The decision rules of two hand kernels, emulated in numpy where the
kernels cannot run (no card here), against the reference.

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
    from superodom_tpu_torch import mapstate as tm

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
