"""The voxel-hash map of the PyTorch port against the JAX package: insert
(bit-exact after several real scans), lookup, the plain versions of the
octant_lookup (K1) and knn_select (K2) kernels on that map, knn_select's
tie order, eviction and census.  K1's edge cases are in
test_torch_octant_lookup.py, candidate refresh in test_torch_refresh.py."""

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

from superodom_tpu_torch import convert, mapstate as tm  # noqa: E402
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
