"""Library functions of the PyTorch port that no step path calls, against
the JAX package on seeded inputs: ``ops.solve3``, ``mapstate.lookup``,
``query_knn`` and ``gather_candidates`` (the plain composition of K1 and
K2 on the CPU), ``frontend.propagate_orientation`` and
``undistort_scan``, ``inertial.imu_static_init`` with
``geometry.gravity_align_matrix``, and ``geometry.pose_interpolate``.

Tolerances: the map functions select and copy stored floats, so their
slots, points and validity are compared exactly and their distances to
1e-6 relative (XLA may contract the sum of squares differently, as in
tests/test_torch_mapstate.py); the float32 arithmetic of the others is
compared to 1e-5 (1e-4 for a gyro chain of 48 products), the order of
float operations differing between the two libraries."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from superodom_tpu import frontend as jf  # noqa: E402
from superodom_tpu import geometry as jg  # noqa: E402
from superodom_tpu import inertial as ji  # noqa: E402
from superodom_tpu import mapstate as jm  # noqa: E402
from superodom_tpu import ops as jops  # noqa: E402
from superodom_tpu.config import MapConfig as JMapConfig  # noqa: E402

from superodom_tpu_torch import convert, frontend as tf  # noqa: E402
from superodom_tpu_torch import geometry as tg  # noqa: E402
from superodom_tpu_torch import inertial as ti  # noqa: E402
from superodom_tpu_torch import mapstate as tm  # noqa: E402
from superodom_tpu_torch import ops as tops  # noqa: E402
from superodom_tpu_torch.config import MapConfig  # noqa: E402

CFG = dict(cell_size=1.0, table_size=1 << 12, cell_capacity=16)


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def warm_map():
    """A map filled by JAX's insert from clustered points, and queries
    near its points and far from them."""
    cfg = JMapConfig(**CFG)
    rng = np.random.default_rng(11)
    centers = rng.uniform(-6, 6, (30, 3))
    pts = (centers[rng.integers(0, 30, 3000)]
           + rng.normal(0, 0.4, (3000, 3))).astype(np.float32)
    m = jm.empty_map(cfg)
    for i in range(3):
        m = jm.insert(m, cfg, pts[1000 * i:1000 * (i + 1)],
                      np.ones(1000, bool), 0.05, max_writes=1000)
    q = np.concatenate([pts[:300] + rng.normal(0, 0.1, (300, 3)),
                        rng.uniform(-30, 30, (40, 3))]).astype(np.float32)
    return jax.device_get(m), q


def test_solve3_matches_jax():
    """Batched Cramer solves: near-singular systems as JAX solves them, a
    zero determinant giving zeros."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A[:4] = 0.0
    A[4:8, 2] = A[4:8, 0]  # rank 2 up to rounding
    b = rng.normal(size=(64, 3)).astype(np.float32)
    got = tops.solve3(T(A), T(b))
    _close(got, jops.solve3(A, b), 1e-5)
    assert torch.all(got[:4] == 0)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", A[8:],
                                         got.numpy()[8:]), b[8:], atol=1e-3)


def test_lookup_matches_jax(warm_map):
    """Integer cells -> slots, present and absent cells alike."""
    mj, q = warm_map
    cells = np.floor(q).astype(np.int32)
    got = tm.lookup(convert.voxel_map_from_numpy(mj), MapConfig(**CFG),
                    T(cells))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jm.lookup(mj, JMapConfig(**CFG), cells)))
    assert (got >= 0).any() and (got < 0).any()


@pytest.mark.parametrize("k", [5, 10])
def test_query_knn_and_gather_candidates_match_jax(warm_map, k):
    """``query_knn``: validity and every valid neighbour exact, distances
    to 1e-6 relative; ``gather_candidates``: the candidate rows of the
    found slots and the validity exact."""
    mj, q = warm_map
    mt, cfg_j = convert.voxel_map_from_numpy(mj), JMapConfig(**CFG)
    pt, st, vt = tm.query_knn(mt, MapConfig(**CFG), T(q), k)
    pj, sj, vj = (np.asarray(a) for a in jm.query_knn(mj, cfg_j, q, k))
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_array_equal(pt.numpy()[vj], pj[vj])
    fin = np.isfinite(sj)
    np.testing.assert_array_equal(np.isfinite(st.numpy()), fin)
    np.testing.assert_allclose(st.numpy()[fin], sj[fin], rtol=1e-6)
    assert vj.any() and not vj.all()
    ct, cvt = tm.gather_candidates(mt, MapConfig(**CFG), T(q))
    cj, cvj = (np.asarray(a) for a in jm.gather_candidates(mj, cfg_j, q))
    np.testing.assert_array_equal(cvt.numpy(), cvj)
    live = cvj.reshape(len(q), 8, -1)[:, :, 0]
    np.testing.assert_array_equal(ct.numpy()[live], cj[live])


def test_propagate_orientation_matches_jax():
    """The gyro chain over a window with masked-out tail samples,
    continued from a previous window's state."""
    rng = np.random.default_rng(1)
    n = 48
    t = (10.0 + np.cumsum(rng.uniform(0.004, 0.006, n))).astype(np.float32)
    gyr = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    mask = np.arange(n) < 40
    q0 = _unit_quats(rng, 1)[0]
    gyr0 = rng.normal(0, 0.5, 3).astype(np.float32)
    t0 = np.float32(t[0] - 0.005)
    got = tf.propagate_orientation(T(q0), T(gyr0), T(t), T(gyr), T(mask),
                                   T(t0))
    _close(got, jf.propagate_orientation(q0, gyr0, t, gyr, mask, t0), 1e-4)
    assert torch.equal(got[40:], got[39:40].expand(8, 4))


def test_undistort_scan_matches_jax():
    """Full-cloud undistortion through a rotating IMU window and an
    extrinsic with a lever arm."""
    rng = np.random.default_rng(2)
    m, n = 24, 700
    t_imu = (5.0 + np.arange(m) * 0.005).astype(np.float32)
    gyr = np.tile(np.array([0.1, -0.3, 1.2], np.float32), (m, 1))
    q = np.asarray(jf.propagate_orientation(
        np.array([1.0, 0, 0, 0], np.float32), gyr[0], t_imu, gyr,
        np.ones(m, bool), t_imu[0]))
    win = jf.ImuWindow(t=t_imu, acc=np.zeros((m, 3), np.float32), gyr=gyr,
                       q=q, mask=np.arange(m) < m - 3)
    scan = jf.Scan(xyz=rng.uniform(-20, 20, (n, 3)).astype(np.float32),
                   t_rel=np.sort(rng.uniform(0, 0.1, n)).astype(np.float32),
                   mask=rng.random(n) < 0.9,
                   t_start=np.float32(t_imu[1]),
                   ring=np.zeros(n, np.int32))
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    t_il = np.array([0.2, 0.05, -0.1], np.float32)
    got = tf.undistort_scan(convert.scan_from_numpy(scan),
                            convert.imu_window_from_numpy(win), T(R),
                            T(t_il))
    want = jf.undistort_scan(scan, win, R, t_il)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)
    assert np.abs(got[0].numpy() - scan.xyz).max() > 1e-2


def test_imu_static_init_and_gravity_align_match_jax():
    """Masked means and covariances, the gravity vector, the roll/pitch
    alignment (whose transpose takes the mean acceleration to +Z) and
    its composition with the extrinsic; too few samples are not ok."""
    rng = np.random.default_rng(3)
    n = 220
    g = np.array([0.8, -1.1, 9.7], np.float32)
    acc = (g + rng.normal(0, 0.02, (n, 3))).astype(np.float32)
    gyr = (np.array([0.01, -0.02, 0.005]) + rng.normal(0, 0.001, (n, 3))
           ).astype(np.float32)
    mask = np.arange(n) < 200
    R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                 np.float32)
    got = ti.imu_static_init(T(acc), T(gyr), T(mask), T(R), 9.80511)
    want = ji.imu_static_init(acc, gyr, mask, R, 9.80511)
    for f in ji.ImuInitState._fields[:-1]:
        _close(getattr(got, f), getattr(want, f), 1e-5)
    assert bool(got.ok) and bool(want.ok)
    up = got.R_gravity.T @ got.acc_mean
    np.testing.assert_allclose(up.numpy()[:2], 0.0, atol=1e-5)
    few = np.arange(n) < 8
    assert not bool(ti.imu_static_init(T(acc), T(gyr), T(few), T(R)).ok)
    accs = rng.normal(0, 5.0, (16, 3)).astype(np.float32)
    _close(tg.gravity_align_matrix(T(accs)), jg.gravity_align_matrix(
        jnp.asarray(accs)), 1e-5)


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_pose_interpolate_matches_jax(alpha):
    """Slerp + lerp between batches of poses, at the ends and between."""
    rng = np.random.default_rng(4)
    q0, q1 = _unit_quats(rng, 32), _unit_quats(rng, 32)
    q1[:4] = q0[:4]  # identical rotations: the small-angle branch
    p0, p1 = (rng.normal(size=(32, 3)).astype(np.float32) for _ in range(2))
    a = np.full(32, alpha, np.float32)
    got = tg.pose_interpolate(tg.Pose(T(q0), T(p0)), tg.Pose(T(q1), T(p1)),
                              T(a)[:, None])
    want = jg.pose_interpolate(jg.Pose(q0, p0), jg.Pose(q1, p1),
                               a[:, None])
    _close(got.q, want.q, 1e-5)
    _close(got.t, want.t, 1e-5)
