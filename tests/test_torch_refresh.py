"""Candidate refresh of the PyTorch port against the JAX package: the
plain versions of the reduce_candidates (K9a) and select_reduced (K9b)
kernels on synthetic maps — full rows, a young map with fewer live
candidates than the refresh width and fewer valid lanes than k, missing
slots, exact distance ties — at cell capacities 16 and 32.

What the tests compare: ``valid`` exactly, and every coordinate of a valid
lane exactly (the functions only select and copy stored floats).  A lane
that is not valid carries no contract — the JAX package fills it with
whatever its clamped gather found (the BIG sentinel, or a point of table
row 0 for a missing slot) and nothing downstream reads it (the plane fit
gates on ``nvalid``) — so its coordinates are not compared.  Distances are
compared to 1e-6 relative: XLA may contract the sum of squares
differently."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from superodom_tpu import mapstate as jm  # noqa: E402
from superodom_tpu.config import MapConfig as JMapConfig  # noqa: E402

from superodom_tpu_torch import convert, kernels, mapstate as tm  # noqa: E402

from test_torch_mapstate import T  # noqa: E402


W = 16
NQ = 160
CASES = ("full", "young", "tie")


def _refresh_case_map(C, case):
    """A JAX-package map in numpy over the cells of [-3, 3)^3 and queries
    inside it.

    full:  every cell present and full (8*C live candidates a query).
    young: a third of the cells present with 0-3 points each, so most
           queries see fewer than W (and many fewer than 5) live candidates
           and several missing slots.
    tie:   every present cell stores the same C points, so each distance
           occurs once per present octant: the lower lane must win."""
    rng = np.random.default_rng(C * 10 + CASES.index(case))
    cfg = JMapConfig(cell_size=1.0, table_size=1 << 11, bucket_size=32,
                     cell_capacity=C)
    m = jax.device_get(jm.empty_map(cfg))
    keys, pts, cnt = m.keys.copy(), m.pts.copy(), m.cnt.copy()
    nb, B = keys.shape
    shared = rng.uniform(-0.5, 0.5, (C, 3)).astype(np.float32)
    fill = np.zeros(nb, np.int64)
    for cell in np.ndindex(6, 6, 6):
        cell = np.array(cell, np.int32) - 3
        if case != "full" and rng.random() > (0.33 if case == "young" else 0.7):
            continue
        packed = int(np.asarray(jm.pack_cells(cell)))
        b = int(np.asarray(jm._bucket_of(np.array([packed], np.int32), nb))[0])
        lane = fill[b]
        fill[b] += 1
        assert lane < B
        n = C if case != "young" else int(rng.integers(0, 4))
        p = (shared if case == "tie" else
             (cell + rng.uniform(0, 1, (C, 3))).astype(np.float32))
        keys[b, lane] = packed
        cnt[b, lane] = n
        for a in range(3):
            pts[b * B + lane, a * C:a * C + n] = p[:n, a]
    q = rng.uniform(-2.5, 2.5, (NQ, 3)).astype(np.float32)
    if case == "tie":
        q = rng.uniform(-0.4, 0.4, (NQ, 3)).astype(np.float32)
    return cfg, jm.VoxelHashMap(keys=keys, pts=pts, cnt=cnt), q


def _reduce_both(C, case):
    cfg, mj, q = _refresh_case_map(C, case)
    cand, cvalid = jm.gather_candidates(mj, cfg, q)
    red_j = jax.device_get(jm.reduce_candidates(cand, cvalid, q, W))
    slots = tm.octant_lookup_reference(T(mj.keys), T(q), cfg.cell_size)
    red_t, near_t = tm.reduce_candidates(T(mj.pts), slots, T(q), W, 5)
    return q, red_j, (red_t, near_t), np.asarray(cvalid), np.asarray(cand)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("C", [16, 32])
def test_reduce_candidates_matches_jax(C, case):
    """The reduced set, and its 5 nearest lanes at the same queries against
    the JAX package's select_knn_reduced of its own reduced set."""
    q, red_j, (red_t, near_t), cvalid, cand = _reduce_both(C, case)
    assert isinstance(red_t, tm.ReducedCandidates)
    pj, sj, vj = (np.asarray(a) for a in jm.select_knn_reduced(red_j, q, 5))
    pt, st, vt = (a.numpy() for a in near_t)
    assert pt.shape == (NQ, 5, 3) and st.shape == (NQ, 5)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(pt[vj], pj[vj])
    np.testing.assert_allclose(st[vj], sj[vj], rtol=1e-6)
    assert np.all(st[~vj] == tm.BIG)
    assert red_t.x.shape == (NQ, W) and red_t.valid.dtype == torch.bool
    np.testing.assert_array_equal(red_t.valid.numpy(), red_j.valid)
    v = red_j.valid
    for f in ("x", "y", "z"):
        np.testing.assert_array_equal(getattr(red_t, f).numpy()[v],
                                      getattr(red_j, f)[v], err_msg=f)
    n_valid = v.sum(axis=1)
    if case == "full":
        assert v.all()
    if case == "young":  # fewer than W live, fewer than 5, missing slots
        assert (n_valid < W).mean() > 0.9 and (n_valid < 5).any()
        assert (n_valid > 0).any() and not cvalid.all()
    if case == "tie":  # each of the first lanes' distances occurs repeatedly
        d = ((red_j.x - q[:, :1]) ** 2 + (red_j.y - q[:, 1:2]) ** 2
             + (red_j.z - q[:, 2:]) ** 2)
        assert (np.diff(d, axis=1) == 0).mean() > 0.4


@pytest.mark.parametrize("k", [5, 10])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("C", [16, 32])
def test_select_knn_reduced_matches_jax(C, case, k):
    """Both sides select from the JAX package's reduced set, at queries
    moved as a round of ICP moves them."""
    q, red_j, _, _, _ = _reduce_both(C, case)
    q2 = (q + np.float32([0.02, -0.015, 0.01])).astype(np.float32)
    pj, sj, vj = (np.asarray(a) for a in jm.select_knn_reduced(red_j, q2, k))
    pt, st, vt = tm.select_knn_reduced(convert.from_numpy(red_j), T(q2), k)
    assert pt.shape == (NQ, k, 3) and st.shape == (NQ, k)
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_array_equal(pt.numpy()[vj], pj[vj])
    np.testing.assert_allclose(st.numpy()[vj], sj[vj], rtol=1e-6)
    # lanes that are not valid sit at BIG on both sides
    assert np.all(st.numpy()[~vj] >= tm.BIG * 0.5)
    if case == "young":
        assert (~vj).any() and vj.any()  # rows with fewer than k valid lanes
    else:
        assert vj.all()


def test_reduced_then_selected_equals_full_selection():
    """top-k of the top-W equals top-k of all candidates at the same
    query (W >= k): K9a + K9b against K2, lanes and points exact."""
    cfg, mj, q = _refresh_case_map(16, "full")
    slots = tm.octant_lookup_reference(T(mj.keys), T(q), cfg.cell_size)
    red, _ = tm.reduce_candidates(T(mj.pts), slots, T(q), W, 5)
    pr, sr, vr = tm.select_knn_reduced(red, T(q), 5)
    pf, sf, vf, _ = tm.knn_select(T(mj.pts), slots, T(q), 5)
    assert torch.equal(pr, pf) and torch.equal(sr, sf) and torch.equal(vr, vf)


def test_refresh_dispatch():
    """CPU tensors take the plain versions; the kernels' wrappers take CUDA
    tensors only and raise on anything else."""
    cfg, mj, q = _refresh_case_map(16, "young")
    slots = tm.octant_lookup_reference(T(mj.keys), T(q), cfg.cell_size)
    a, near_a = tm.reduce_candidates(T(mj.pts), slots, T(q), W, 5)
    b, near_b = tm.reduce_candidates_reference(T(mj.pts), slots, T(q), W, 5)
    assert all(torch.equal(x, y) for x, y in zip(a + near_a, b + near_b))
    sa = tm.select_knn_reduced(a, T(q), 5)
    sb = tm.select_knn_reduced_reference(a, T(q), 5)
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))
    with pytest.raises(ValueError):
        kernels.reduce_candidates(T(mj.pts), slots, T(q), W, 5)
    with pytest.raises(ValueError):
        kernels.select_reduced(a.x, a.y, a.z, a.valid, T(q), 5)
    assert {"reduce_candidates", "select_reduced", "voxel_claim"} <= set(
        kernels.launch_counts)
