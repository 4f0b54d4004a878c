"""The library's correspondence functions of the PyTorch port against the
JAX package (eager, on the same seeded numpy inputs): ``mapstate.cand_planes``
and ``mapstate.select_knn`` (K2's gathered mode, plain version) with exact
distance ties, a lane-granular candidate mask and k above the valid lanes;
``registration.plane_correspondences_from_candidates`` /
``compute_plane_correspondences`` on a map of real scans and
``compute_edge_correspondences`` / ``edge_correspondences_from_candidates``
on a pole lattice; ``native.available``; ``pipeline.make_step_fn``; and the
fleet CLI's metric name and workload.

Tolerances: where both sides do the same float32 arithmetic on exactly
representable values (the tie cases, the selections' coordinates) the
comparison is bit for bit; squared distances of real points within 1e-6
relative (XLA may contract the sum of squares differently); the fits with
the plane and line fit tests' tolerances (1e-5), lanes at a gate margin
excluded.  Inside the port, the gathered mode on a slot-granular mask and
the slot mode give the same lanes to the bit, and the functions under
JAX's names give the ICP rounds' correspondences to the bit."""

import inspect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu import geometry as jg  # noqa: E402
from superodom_tpu import mapstate as jm  # noqa: E402
from superodom_tpu import native as jnative  # noqa: E402
from superodom_tpu import registration as jr  # noqa: E402
from superodom_tpu.io.datasets import BoxWorld, make_dataset  # noqa: E402

from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch import mapstate as tm  # noqa: E402
from superodom_tpu_torch import native as tnative  # noqa: E402
from superodom_tpu_torch import parallel  # noqa: E402
from superodom_tpu_torch import pipeline as tp  # noqa: E402
from superodom_tpu_torch import registration as tr  # noqa: E402
from superodom_tpu_torch.geometry import Pose  # noqa: E402
from superodom_tpu_torch.io import datasets as tds  # noqa: E402
from superodom_tpu_torch.io.datasets import pole_lattice  # noqa: E402
from superodom_tpu_torch.runner import OdometryRunner  # noqa: E402

MAP = dict(cell_size=1.0, table_size=1 << 13, cell_capacity=16,
           evict_radius=200.0)
PLANE_RES, LINE_RES = 0.2, 0.1
M_FEAT = 640


def T(a):
    return torch.from_numpy(np.array(a))


def _rot(q):
    return np.asarray(jg.quat_to_matrix(q), np.float64)


@pytest.fixture(scope="module")
def scene():
    """A map of five real scans inserted by the JAX package at the true
    poses, and the features of a sixth scan at a perturbed pose:
    (map, p_body, mask, q0, t0)."""
    ds = make_dataset(np.random.default_rng(5), n_scans=7,
                      points_per_scan=3000, radius=2.0, laps=0.2,
                      world=BoxWorld(half_extent=np.array([8.0, 6.0, 3.0])),
                      static_scans=1)
    cfg = jcfg.MapConfig(**MAP)
    ins = jax.jit(lambda m, x, k: jm.insert(m, cfg, x, k,
                                            jnp.float32(PLANE_RES)))
    m = jm.empty_map(cfg)
    for i in range(5):
        s = ds.scans[i]
        pts = (s.xyz_body[:2048] @ _rot(ds.gt_poses_q[i]).T
               + ds.gt_poses_t[i]).astype(np.float32)
        m = ins(m, pts, np.arange(2048) < len(s.xyz_body))
    s = ds.scans[5]
    p_body = s.xyz_body[:M_FEAT].astype(np.float32)
    mask = np.arange(M_FEAT) % 11 != 0
    dq = np.asarray(jg.so3_exp(np.array([0.004, -0.003, 0.012],
                                        np.float32)))
    q0 = np.asarray(jg.quat_mul(dq, ds.gt_poses_q[5]), np.float32)
    t0 = (ds.gt_poses_t[5] + np.array([0.04, -0.03, 0.01])).astype(np.float32)
    return jax.device_get(m), p_body, mask, q0, t0


def _hold_selection(got, want, exact_sq=False):
    """Port (pts, sq, valid) against JAX's: validity equal, the valid
    neighbours' coordinates bit for bit, finite distances within 1e-6
    relative (``exact_sq``: bit for bit), the rest equal in finiteness."""
    pt, st, vt = (a.numpy() for a in got)
    pj, sj, vj = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(pt[vj], pj[vj])
    np.testing.assert_array_equal(np.isfinite(st), np.isfinite(sj))
    fin = np.isfinite(sj)
    if exact_sq:
        np.testing.assert_array_equal(st, sj)
    else:
        np.testing.assert_allclose(st[fin], sj[fin], rtol=1e-6)


@pytest.mark.parametrize("k", [5, 10])
def test_select_knn_matches_jax(scene, k):
    """On a warm map: ``cand_planes`` bit for bit; ``select_knn`` with the
    gathered mask and with a lane-granular one (a third of the lanes
    dropped, not whole octants) against JAX's."""
    m, p_body, _, q0, t0 = scene
    w_pt = np.asarray(jg.Pose(q0, t0).apply(p_body))
    cand, cvalid = (np.asarray(a) for a in jm.gather_candidates(
        m, jcfg.MapConfig(**MAP), w_pt))
    for a, b in zip(tm.cand_planes(T(cand)),
                    jm.cand_planes(jnp.asarray(cand))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    lanes = np.random.default_rng(k).uniform(size=cvalid.shape) < 0.67
    for mask in (cvalid, cvalid & lanes):
        got = tm.select_knn(T(cand), T(mask), T(w_pt), k)
        assert len(got) == 3
        _hold_selection(got, jm.select_knn(jnp.asarray(cand),
                                           jnp.asarray(mask),
                                           jnp.asarray(w_pt), k))
    assert got[2].numpy().mean() > 0.5


def test_select_knn_ties_and_short_rows():
    """Exact ties (points on a grid around grid queries: every distance is
    exact in float32 on both sides), a lane-granular mask, rows with fewer
    valid lanes than k (one with none), empty lanes holding the BIG
    sentinel: bit for bit with JAX, and the gathered mode's lanes on a
    slot-granular mask equal to the slot mode's (K2's plain version)."""
    rng = np.random.default_rng(3)
    nq, C, k = 96, 4, 12
    queries = rng.integers(-4, 4, (nq, 3)).astype(np.float32)
    cand = (queries[:, None, None, :]
            + rng.integers(-1, 2, (nq, 8, C, 3)).astype(np.float32))
    cand[:, :, C - 1] = tm.BIG  # an empty lane in every row
    cand = cand.transpose(0, 1, 3, 2).reshape(nq, 8, 3 * C)
    cvalid = rng.uniform(size=(nq, 8 * C)) < 0.6
    cvalid[:8] &= np.arange(8 * C) < 5  # 5 lanes, 1 of them empty
    cvalid[8] = False
    got = tm.select_knn(T(cand), T(cvalid), T(queries), k)
    _hold_selection(got, jm.select_knn(jnp.asarray(cand), jnp.asarray(cvalid),
                                       jnp.asarray(queries), k),
                    exact_sq=True)
    sq = got[1].numpy()
    assert (sq[:, :-1] == sq[:, 1:]).sum() > nq  # ties were decided
    assert not got[2].numpy()[:9, 4:].any()
    np.testing.assert_array_equal(sq[8], np.full(k, np.float32(tm.BIG)))

    # the slot mode on the same rows: a table of the gathered rows, a slot
    # per octant row, every fourth slot missing
    table = torch.from_numpy(cand.reshape(nq * 8, 3 * C))
    slots = torch.arange(nq * 8, dtype=torch.int32).reshape(nq, 8)
    slots = torch.where(slots % 4 == 3, -1, slots)
    cand_s, cvalid_s = tm._candidate_rows(table, slots)
    want = tm.knn_select_reference(table, slots, T(queries), k)
    mine = tm.select_knn_reference(cand_s, cvalid_s, T(queries), k)
    for a, b in zip(mine, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_plane_correspondences_match_jax(scene):
    """``compute_plane_correspondences`` against JAX's: validity, codes and
    bins off the gate margin, accepted normals and offsets within 1e-5;
    ``plane_correspondences_from_candidates`` on the gathered candidates
    gives the same to the bit, and so does the ICP rounds' slot-mode
    selection with the same fit."""
    m, p_body, mask, q0, t0 = scene
    reg_j, reg_t = jcfg.RegistrationConfig(), tcfg.RegistrationConfig()
    cfg_j, cfg_t = jcfg.MapConfig(**MAP), tcfg.MapConfig(**MAP)
    pj = jax.device_get(jr.compute_plane_correspondences(
        m, cfg_j, reg_j, jg.Pose(q0, t0), p_body, mask,
        jnp.float32(PLANE_RES)))
    m_t = tm.VoxelHashMap(T(m.keys), T(m.pts), T(m.cnt))
    pose = Pose(T(q0), T(t0))
    res = torch.tensor(PLANE_RES)
    pt = tr.compute_plane_correspondences(m_t, cfg_t, reg_t, pose,
                                          T(p_body), T(mask), res)
    w_pt = pose.apply(T(p_body)).contiguous()
    cand, cvalid = tm.gather_candidates(m_t, cfg_t, w_pt)
    again = tr.plane_correspondences_from_candidates(
        cand, cvalid, reg_t, pose, T(p_body), T(mask), res)
    neigh, sq, nvalid, _ = tm.knn_select(m_t.pts, tm.octant_lookup(
        m_t.keys, w_pt, cfg_t.cell_size), w_pt, reg_t.plane_knn)
    icp = tr._plane_fit(neigh, sq, nvalid, reg_t, pose, T(p_body), T(mask),
                        res, w_pt)
    for a, b, c in zip(pt, again, icp):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(a, c, rtol=0, atol=0, equal_nan=True)

    far = ~tr.gate_margin_lanes(neigh, sq, nvalid, w_pt, T(q0),
                                T(pj.normal), T(pj.d), res).numpy()
    assert far.mean() > 0.9 and pj.valid.sum() > 250
    np.testing.assert_array_equal(pt.valid.numpy()[far], pj.valid[far])
    np.testing.assert_array_equal(pt.code.numpy()[far], pj.code[far])
    np.testing.assert_array_equal(pt.obs_bins.numpy()[far],
                                  pj.obs_bins[far])
    used = far & pj.valid
    np.testing.assert_allclose(pt.normal.numpy()[used], pj.normal[used],
                               atol=1e-5)
    np.testing.assert_allclose(pt.d.numpy()[used], pj.d[used], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pt.coeff.numpy()[far], pj.coeff[far],
                               atol=1e-5)
    np.testing.assert_array_equal(pt.p_body.numpy(), p_body)


@pytest.fixture(scope="module")
def poles():
    """A lattice of vertical poles inserted by the JAX package as an edge
    map, and edge features of it seen from a perturbed pose."""
    rng = np.random.default_rng(4)
    pole = pole_lattice(rng)
    cfg = jcfg.MapConfig(**MAP)
    ins = jax.jit(lambda m, x, k: jm.insert(m, cfg, x, k, np.float32(0.03)))
    em = jm.empty_map(cfg)
    for chunk in np.array_split(pole, 2):
        em = ins(em, chunk, np.ones(len(chunk), bool))
    q_true = np.asarray(jg.quat_from_rpy(np.float32(0.0), np.float32(0.0),
                                         np.float32(0.04)))
    t_true = np.array([0.15, -0.1, 0.05], np.float32)
    e_body = ((pole[rng.choice(len(pole), 256, replace=False)] - t_true)
              @ _rot(q_true)).astype(np.float32)
    dq = np.asarray(jg.so3_exp(np.array([0.003, -0.002, 0.01], np.float32)))
    q0 = np.asarray(jg.quat_mul(dq, q_true), np.float32)
    t0 = (t_true + np.array([0.03, -0.02, 0.01])).astype(np.float32)
    return jax.device_get(em), e_body, np.arange(256) % 13 != 0, q0, t0


def test_edge_correspondences_match_jax(poles):
    """``compute_edge_correspondences`` against JAX's, with the line fit
    test's comparison; the re-signed ``edge_correspondences_from_candidates``
    (JAX's ``cand, cvalid``) and the ICP rounds' slot form give the same to
    the bit."""
    em, e_body, e_mask, q0, t0 = poles
    reg_j, reg_t = jcfg.RegistrationConfig(), tcfg.RegistrationConfig()
    cfg_j, cfg_t = jcfg.MapConfig(**MAP), tcfg.MapConfig(**MAP)
    lj = jax.device_get(jr.compute_edge_correspondences(
        em, cfg_j, reg_j, jg.Pose(q0, t0), e_body, e_mask,
        jnp.float32(LINE_RES)))
    em_t = tm.VoxelHashMap(T(em.keys), T(em.pts), T(em.cnt))
    pose = Pose(T(q0), T(t0))
    res = torch.tensor(LINE_RES)
    lt = tr.compute_edge_correspondences(em_t, cfg_t, reg_t, pose,
                                         T(e_body), T(e_mask), res)
    assert list(inspect.signature(
        tr.edge_correspondences_from_candidates).parameters) == list(
        inspect.signature(jr.edge_correspondences_from_candidates).parameters)
    w_pt = pose.apply(T(e_body)).contiguous()
    cand, cvalid = tm.gather_candidates(em_t, cfg_t, w_pt)
    again = tr.edge_correspondences_from_candidates(
        cand, cvalid, reg_t, pose, T(e_body), T(e_mask), res)
    slots = tm.octant_lookup(em_t.keys, w_pt, cfg_t.cell_size)
    icp = tr._edge_correspondences_from_slots(em_t.pts, slots, reg_t,
                                              T(e_body), T(e_mask), res, w_pt)
    for a, b, c in zip(lt, again, icp):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(a, c, rtol=0, atol=0, equal_nan=True)

    neigh, sq, nvalid = tm.select_knn(cand, cvalid, w_pt, reg_t.edge_knn)
    far = ~tr.edge_gate_margin_lanes(
        neigh, sq, nvalid, res, reg_t.min_edge_neighbors,
        reg_t.edge_max_dist_inlier).numpy()
    assert far.mean() > 0.9 and lj.valid.mean() > 0.5
    np.testing.assert_array_equal(lt.valid.numpy()[far], lj.valid[far])
    np.testing.assert_array_equal(lt.code.numpy()[far], lj.code[far])
    used = far & lj.valid
    np.testing.assert_allclose(lt.a.numpy()[used], lj.a[used], atol=1e-5)
    np.testing.assert_allclose(lt.b.numpy()[used], lj.b[used], atol=1e-5)
    np.testing.assert_allclose(lt.coeff.numpy()[far], lj.coeff[far],
                               atol=1e-5)


def test_native_available(monkeypatch):
    """True where the IMU library builds, as JAX's says of its own; False
    when the build or the load fails, which the buffer itself raises."""
    assert tnative.available() is True
    assert jnative.available() is True

    def refuse():
        raise RuntimeError("building the IMU library failed")

    monkeypatch.setattr(tnative, "load", refuse)
    assert tnative.available() is False
    with pytest.raises(RuntimeError):
        tnative.ImuBuffer(capacity=16)


def _tiny_ship():
    from superodom_tpu_torch.tools.profile import apply_overrides

    return apply_overrides(tcfg.ship_config("os1"), {
        "sensor.max_points": 4096, "sensor.max_surface_features": 384,
        "map.table_size": 1 << 13})


def test_make_step_fn_is_the_step():
    """The closure's arity is JAX's (a trailing VioWindow with VIO on);
    one step through it equals ``pipeline.step`` to the bit, and the runner
    steps through it."""
    cfg = _tiny_ship()
    vio = tcfg.PipelineConfig(use_vio_undistortion=True)
    for c in (cfg, vio):
        ours = list(inspect.signature(tp.make_step_fn(c)).parameters)
        assert len(ours) == 5 if c.use_vio_undistortion else len(ours) == 4
    jax_vio = jcfg.PipelineConfig(use_vio_undistortion=True)
    assert jax_vio.use_vio_undistortion == vio.use_vio_undistortion

    ds = tds.bench_dataset(14, cfg.sensor.max_points)
    runner = OdometryRunner(cfg, device="cpu")
    res = runner.run_dataset_chunked(ds, chunk=12)
    assert np.isfinite(res.poses_t).all()
    s = ds.scans[13]
    inputs = runner._to_device(runner._host_inputs(s.t_start, s.xyz_body,
                                                   s.t_rel))
    a = runner.step_fn(runner.state, *inputs)
    b = tp.step(runner.step_cfg, runner.state, *inputs)
    for x, y in zip(jax.tree_util.tree_leaves(tp.tree_map(lambda t: t, a)),
                    jax.tree_util.tree_leaves(tp.tree_map(lambda t: t, b))):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def test_fleet_cli_names_its_workload(monkeypatch, capsys):
    """``aggregate_scans_per_sec_os1_128_x<B>`` is bench_batch's workload:
    one seed-7 dataset of 40 scans broadcast to every instance, chunks of
    10, with ``vs_baseline`` against 200 scans/s; another length carries
    another name.  The replay is replaced by a stub that records what it
    was given (no full-width replay here)."""
    assert parallel.fleet_metric(4) == "aggregate_scans_per_sec_os1_128_x4"
    assert parallel.fleet_metric(2, scans=20) == \
        "aggregate_scans_per_sec_os1_128_x2_20scans"

    made, seen = [], {}
    small = tds.bench_dataset

    def dataset(n, points, seed=7):
        made.append((n, points, seed))
        return small(n, 64, seed)

    def replay(cfg, fleet, chunk, dev):
        seen.update(fleet=fleet, chunk=chunk)
        n = len(fleet[0].scans)
        return parallel.BatchedRunResult(
            poses_q=np.stack([d.gt_poses_q for d in fleet], axis=1),
            poses_t=np.stack([d.gt_poses_t for d in fleet], axis=1),
            stats=[], chunk_ms=[100.0] * (n // chunk),
            aggregate_scans_per_sec=50.0, clock=(0.0, 1.0))

    monkeypatch.setattr(tds, "bench_dataset", dataset)
    monkeypatch.setattr(parallel, "replay_batched", replay)
    parallel.main(["--batch", "3", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "aggregate_scans_per_sec_os1_128_x3"
    assert rec["vs_baseline"] == 50.0 / 200.0
    assert {"value", "unit", "device", "batch", "scans", "chunk",
            "p50_step_ms", "p90_step_ms", "max_ate_m"} <= set(rec)
    assert made == [(40, 131072, 7)]
    assert seen["chunk"] == 10 and len(seen["fleet"]) == 3
    assert all(d is seen["fleet"][0] for d in seen["fleet"])
    assert rec["max_ate_m"] == 0.0
