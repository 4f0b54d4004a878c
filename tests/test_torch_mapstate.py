"""The voxel-hash map of the PyTorch port against the JAX package: insert
(bit-exact after several real scans), lookup, the plain versions of the
octant_lookup (K1: also at other bucket sizes, a duplicate key, wrapped
cells and boundary queries) and knn_select (K2) kernels, eviction and
census; and candidate refresh: the plain versions of the reduce_candidates
(K9a) and select_reduced (K9b) kernels on synthetic maps — full rows, a
young map with fewer live candidates than the refresh width and fewer valid
lanes than k, missing slots, exact distance ties — at cell capacities 16
and 32.

What the refresh tests compare: ``valid`` exactly, and every coordinate of
a valid lane exactly (the functions only select and copy stored floats).  A
lane that is not valid carries no contract — the JAX package fills it with
whatever its clamped gather found (the BIG sentinel, or a point of table
row 0 for a missing slot) and nothing downstream reads it (the plane fit
gates on ``nvalid``) — so its coordinates are not compared.  Distances are
compared to 1e-6 relative: XLA may contract the sum of squares
differently."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from superodom_tpu import mapstate as jm  # noqa: E402
from superodom_tpu.config import MapConfig as JMapConfig  # noqa: E402
from superodom_tpu.io.datasets import BoxWorld, make_dataset  # noqa: E402

from superodom_tpu_torch import convert, kernels, mapstate as tm  # noqa: E402
from superodom_tpu_torch.config import MapConfig  # noqa: E402

CFG = dict(cell_size=1.0, table_size=1 << 13, cell_capacity=24,
           evict_radius=200.0)
N_PTS = 2048  # > insert_width, so the capped write path runs


def T(a):
    return torch.from_numpy(np.array(a))


def _scans(n):
    ds = make_dataset(np.random.default_rng(11), n_scans=n,
                      points_per_scan=2600, radius=2.0, laps=0.2,
                      world=BoxWorld(half_extent=np.array([8.0, 6.0, 3.0])),
                      static_scans=1)
    out = []
    for i, s in enumerate(ds.scans):
        q, t = ds.gt_poses_q[i].astype(np.float64), ds.gt_poses_t[i]
        w = np.array([[1 - 2 * (q[2] ** 2 + q[3] ** 2),
                       2 * (q[1] * q[2] - q[0] * q[3]),
                       2 * (q[1] * q[3] + q[0] * q[2])],
                      [2 * (q[1] * q[2] + q[0] * q[3]),
                       1 - 2 * (q[1] ** 2 + q[3] ** 2),
                       2 * (q[2] * q[3] - q[0] * q[1])],
                      [2 * (q[1] * q[3] - q[0] * q[2]),
                       2 * (q[2] * q[3] + q[0] * q[1]),
                       1 - 2 * (q[1] ** 2 + q[2] ** 2)]])
        pts = (s.xyz_body[:N_PTS] @ w.T + t).astype(np.float32)
        mask = np.arange(N_PTS) < min(len(s.xyz_body), N_PTS) - 7
        out.append((pts, mask))
    return out


@pytest.fixture(scope="module")
def built():
    """Five real scans inserted by both packages; the JAX maps after each."""
    cfg_j = JMapConfig(**CFG)
    ins = jax.jit(lambda m, x, k, d: jm.insert(m, cfg_j, x, k, d))
    m = jm.empty_map(cfg_j)
    maps = []
    scans = _scans(6)
    for pts, mask in scans[:5]:
        m = ins(m, pts, mask, jnp.float32(0.2))
        maps.append(jax.device_get(m))
    return scans, maps


def test_insert_bit_exact(built):
    scans, maps = built
    cfg_t = MapConfig(**CFG)
    m = tm.empty_map(cfg_t)
    for (pts, mask), mj in zip(scans[:5], maps):
        m = tm.insert(m, cfg_t, T(pts), T(mask), torch.tensor(0.2))
        np.testing.assert_array_equal(m.keys.numpy(), mj.keys)
        np.testing.assert_array_equal(m.cnt.numpy(), mj.cnt)
        np.testing.assert_array_equal(m.pts.numpy(), mj.pts)
    assert int(np.sum(maps[-1].cnt)) > 3000


def test_insert_uncapped_and_masked(built):
    scans, maps = built
    cfg_j, cfg_t = JMapConfig(**CFG), MapConfig(**CFG)
    pts, mask = scans[5]
    mask = mask & (np.arange(N_PTS) % 3 != 0)
    mj = jm.insert(jm.empty_map(cfg_j), cfg_j, pts, mask, 0.1,
                   max_writes=N_PTS)
    mt = tm.insert(tm.empty_map(cfg_t), cfg_t, T(pts), T(mask),
                   torch.tensor(0.1), max_writes=N_PTS)
    for a, b in zip(mt, jax.device_get(mj)):
        np.testing.assert_array_equal(a.numpy(), b)


def _queries(built, seed=0):
    scans, _ = built
    rng = np.random.default_rng(seed)
    pts = scans[5][0][:512]
    return (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32)


def test_lookup_packed(built):
    _, maps = built
    mj = maps[-1]
    live = mj.keys[mj.keys >= 0][:200]
    rng = np.random.default_rng(1)
    absent = rng.integers(0, 1 << 30, 200).astype(np.int32)
    packed = np.concatenate([live, absent]).astype(np.int32)
    mt = convert.voxel_map_from_numpy(mj)
    np.testing.assert_array_equal(
        tm.lookup_packed(mt, T(packed)).numpy(),
        np.asarray(jm.lookup_packed(mj, packed)))


def test_octant_lookup_reference_matches_gather(built):
    _, maps = built
    mj = maps[-1]
    q = _queries(built)
    cand, cvalid = jm.gather_candidates(mj, JMapConfig(**CFG), q)
    slots = tm.octant_lookup(T(mj.keys), T(q), CFG["cell_size"])
    assert slots.dtype == torch.int32 and slots.shape == (len(q), 8)
    C = CFG["cell_capacity"]
    np.testing.assert_array_equal(
        T(mj.pts)[torch.clamp_min(slots, 0).long()].numpy(),
        np.asarray(cand))
    np.testing.assert_array_equal(
        np.repeat((slots >= 0).numpy(), C, axis=1), np.asarray(cvalid))
    assert (slots >= 0).float().mean() > 0.3


def _slot_map(cells, nb, B):
    """A JAX-package map in numpy that holds ``cells`` (int [N, 3]), each in
    the first free lane of its bucket row, with one point a slot whose x
    is the slot's index: the candidates the JAX package gathers then name
    the slots it looked up."""
    packed = np.asarray(jm.pack_cells(np.asarray(cells, np.int32)))
    bucket = np.asarray(jm._bucket_of(packed, nb))
    keys = np.full((nb, B), -1, np.int32)
    fill = np.zeros(nb, np.int64)
    for p, b in zip(packed.tolist(), bucket.tolist()):
        if fill[b] < B and p not in keys[b, :fill[b]]:
            keys[b, fill[b]] = p
            fill[b] += 1
    pts = np.zeros((nb * B, 3), np.float32)
    pts[:, 0] = np.arange(nb * B)
    return jm.VoxelHashMap(keys=keys, pts=pts, cnt=(keys >= 0).astype(np.int32))


def _slots_both(mj, q, cell_size):
    """The slot ids the JAX package's gather_candidates looked up (read
    back from the gathered points) and the plain K1's; held equal, bit for
    bit: they are integers."""
    nb, B = mj.keys.shape
    cfg = JMapConfig(cell_size=cell_size, table_size=nb * B, bucket_size=B,
                     cell_capacity=1)
    cand, cvalid = jm.gather_candidates(mj, cfg, q)
    slots_j = np.where(np.asarray(cvalid),
                       np.asarray(cand)[:, :, 0].astype(np.int32), -1)
    slots_t = tm.octant_lookup(T(mj.keys), T(q), cell_size)
    assert slots_t.dtype == torch.int32
    np.testing.assert_array_equal(slots_t.numpy(), slots_j)
    return slots_j


@pytest.mark.parametrize("B", [32, 256])
def test_octant_lookup_reference_bucket_sizes(B):
    """The bucket sizes beside the presets' 128 that the kernel's generic
    instance serves."""
    rng = np.random.default_rng(B)
    mj = _slot_map(rng.integers(-7, 8, size=(1500, 3)), 64, B)
    q = rng.uniform(-8.0, 8.0, (500, 3)).astype(np.float32)
    slots = _slots_both(mj, q, 1.0)
    assert (slots >= 0).mean() > 0.2 and (slots < 0).any()


def test_octant_lookup_reference_duplicate_key():
    """A bucket row that holds a key twice resolves to the lower lane, as
    the JAX package's argmax over the row does."""
    nb, B = 64, 128
    mj = _slot_map(np.zeros((0, 3), np.int32), nb, B)
    packed = int(np.asarray(jm.pack_cells(np.array([2, -3, 1], np.int32))))
    b = int(np.asarray(jm._bucket_of(np.array([packed], np.int32), nb))[0])
    mj.keys[b, [70, 5]] = packed
    q = np.array([[2.25, -2.75, 1.25]], np.float32)
    slots = _slots_both(mj, q, 1.0)
    assert slots[0, 0] == b * B + 5 and (slots >= 0).sum() == 1
    np.testing.assert_array_equal(
        tm.lookup_packed(convert.voxel_map_from_numpy(mj),
                         T(np.array([packed], np.int32))).numpy(),
        np.asarray(jm.lookup_packed(mj, np.array([packed], np.int32))))


@pytest.mark.parametrize("cell_size", [1.0, 0.4])
def test_octant_lookup_reference_boundary_queries(cell_size):
    """Queries exactly on a cell boundary and on the half cell: the
    quotient's rounding decides the cell and the side."""
    rng = np.random.default_rng(11)
    mj = _slot_map(rng.integers(-6, 7, size=(1200, 3)), 64, 128)
    steps = np.arange(-10, 11, dtype=np.float32) * np.float32(0.5)
    g = np.stack(np.meshgrid(steps, steps[::3], steps[::5], indexing="ij"),
                 -1).reshape(-1, 3)
    q = (g * np.float32(cell_size)).astype(np.float32)
    slots = _slots_both(mj, q, cell_size)
    assert (slots >= 0).any() and (slots < 0).any()


def test_octant_lookup_reference_negative_and_wrapped_cells():
    """Cells below zero and on both sides of the +-512-cell wrap of the
    10-bit key fields."""
    edge = [-513, -512, -511, -2, -1, 0, 1, 510, 511, 512]
    cells = np.array([(x, y, z) for x in edge for y in (-1, 0, 511)
                      for z in (-512, 0)])
    mj = _slot_map(cells, 64, 128)
    rng = np.random.default_rng(3)
    q = np.stack([rng.choice(edge, 600) + rng.uniform(0, 1, 600),
                  rng.choice([-1, 0, 511], 600) + rng.uniform(0, 1, 600),
                  rng.choice([-512, 0], 600) + rng.uniform(0, 1, 600)],
                 1).astype(np.float32)
    slots = _slots_both(mj, q, 1.0)
    assert (slots >= 0).sum() > 600 and (slots < 0).any()


@pytest.mark.parametrize("k", [5, 10])
def test_knn_select_reference_matches_select_knn(built, k):
    _, maps = built
    mj = maps[-1]
    q = _queries(built, seed=k)
    cand, cvalid = jm.gather_candidates(mj, JMapConfig(**CFG), q)
    pj, sj, vj = (np.asarray(a) for a in jm.select_knn(cand, cvalid, q, k))
    slots = tm.octant_lookup_reference(T(mj.keys), T(q), CFG["cell_size"])
    pt, st, vt, lane = tm.knn_select(T(mj.pts), slots, T(q), k)
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_array_equal(pt.numpy()[vj], pj[vj])
    np.testing.assert_array_equal(np.isfinite(st.numpy()), np.isfinite(sj))
    fin = np.isfinite(sj)
    np.testing.assert_allclose(st.numpy()[fin], sj[fin], rtol=1e-6)
    assert lane.shape == (len(q), k) and vt.any()


def _tie_map():
    """One bucket row holding two cells whose points tie in distance."""
    cfg = JMapConfig(cell_size=2.0, table_size=1 << 10, cell_capacity=8)
    m = jax.device_get(jm.empty_map(cfg))
    keys, pts, cnt = m.keys.copy(), m.pts.copy(), m.cnt.copy()
    B, C = keys.shape[1], 8
    cells = [(0, 0, 0), (1, 0, 0)]
    # exact offsets from the query at (1.5, 1, 1): six at squared
    # distance 0.25, two at 1.0
    offs = [(0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 0.5),
            (-0.5, 0.0, 0.0), (0.0, -0.5, 0.0), (0.0, 0.0, -0.5),
            (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)]
    for ci, cell in enumerate(cells):
        packed = int(np.asarray(jm.pack_cells(np.array(cell, np.int32))))
        b = int(np.asarray(jm._bucket_of(np.array([packed], np.int32),
                                         keys.shape[0]))[0])
        lane = 5 + ci
        keys[b, lane] = packed
        cnt[b, lane] = C
        for j in range(C):
            o = offs[(j + 3 * ci) % len(offs)]
            for a in range(3):
                pts[b * B + lane, a * C + j] = np.float32(
                    [1.5, 1.0, 1.0][a] + o[a])
    return cfg, jm.VoxelHashMap(keys=keys, pts=pts, cnt=cnt)


def test_knn_select_tie_order():
    cfg, mj = _tie_map()
    q = np.array([[1.5, 1.0, 1.0]], np.float32)
    cand, cvalid = jm.gather_candidates(mj, cfg, q)
    pj, sj, _ = jm.select_knn(cand, cvalid, q, 5)
    slots = tm.octant_lookup_reference(T(mj.keys), T(q), cfg.cell_size)
    pt, st, _, lane = tm.knn_select_reference(T(mj.pts), slots, T(q), 5)
    # several candidates tie at the same distance; the lower lane wins,
    # exactly as lax.top_k orders them
    np.testing.assert_array_equal(st.numpy(), np.full((1, 5), 0.25))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert np.all(np.diff(lane.numpy()[0]) > 0)


def test_evict_far_and_census(built):
    _, maps = built
    mj = maps[-1]
    cfg_j = dataclasses.replace(JMapConfig(**CFG), evict_radius=4.0)
    cfg_t = MapConfig(**{**CFG, "evict_radius": 4.0})
    mt = convert.voxel_map_from_numpy(mj)
    center = np.array([3.0, -2.0, 0.5], np.float32)
    ej = jax.device_get(jm.evict_far(mj, cfg_j, center))
    et = tm.evict_far(mt, cfg_t, T(center))
    for a, b in zip(et, ej):
        np.testing.assert_array_equal(a.numpy(), b)
    assert (ej.keys >= 0).sum() < (mj.keys >= 0).sum()
    for half in ([125.0, 125.0, 75.0], [3.0, 2.0, 1.0]):
        he = np.array(half, np.float32)
        assert int(tm.census_box(mt, cfg_t, T(center), T(he))) == int(
            jm.census_box(mj, cfg_j, center, he))


# ---- candidate refresh (K9) ----

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
