"""Frontend and inertial modules of the PyTorch port against the JAX
package: gates, r^2-stratified thinning and compaction (lane sets exact),
IMU undistortion (1e-5), preintegration with its bias Jacobians and the
fixed-lag smoother (1e-4)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from superodom_tpu import frontend as jf  # noqa: E402
from superodom_tpu import geometry as jg  # noqa: E402
from superodom_tpu import inertial as ji  # noqa: E402
from superodom_tpu.config import ImuConfig as JImu  # noqa: E402
from superodom_tpu.io.datasets import BoxWorld, make_dataset  # noqa: E402

from superodom_tpu_torch import convert  # noqa: E402
from superodom_tpu_torch import frontend as tf  # noqa: E402
from superodom_tpu_torch import inertial as ti  # noqa: E402
from superodom_tpu_torch.config import ImuConfig  # noqa: E402
from superodom_tpu_torch.geometry import Pose  # noqa: E402
from superodom_tpu_torch.native import ImuBuffer  # noqa: E402

M_IMU = 48


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    ds = make_dataset(np.random.default_rng(21), n_scans=30,
                      points_per_scan=3000, radius=2.0, laps=0.3,
                      world=BoxWorld(half_extent=np.array([8.0, 6.0, 3.0])),
                      static_scans=12)
    buf = ImuBuffer(capacity=1 << 14)
    for i in range(len(ds.imu.t)):
        buf.add(ds.imu.t[i], ds.imu.acc[i], ds.imu.gyr[i])
        if i == 210:
            assert buf.static_init(1.0) is not None

    def window(k):
        s = ds.scans[k]
        ts, acc, gyr, qs = buf.window(s.t_start, s.t_start + float(
            s.t_rel[-1]), M_IMU)
        pad = M_IMU - len(ts)
        return jf.ImuWindow(
            t=np.pad(ts, (0, pad)).astype(np.float32),
            acc=np.pad(acc, ((0, pad), (0, 0))).astype(np.float32),
            gyr=np.pad(gyr, ((0, pad), (0, 0))).astype(np.float32),
            q=np.concatenate([qs, np.tile(np.array([1.0, 0, 0, 0],
                                                   np.float32), (pad, 1))]),
            mask=np.arange(M_IMU) < len(ts))

    return ds, window


def _scan(ds, k, n=2048):
    s = ds.scans[k]
    xyz = np.zeros((n, 3), np.float32)
    m = min(n, len(s.xyz_body))
    xyz[:m] = s.xyz_body[:m]
    t_rel = np.zeros((n,), np.float32)
    t_rel[:m] = s.t_rel[:m]
    return xyz, t_rel, np.arange(n) < m


def test_feature_gates_exact(data):
    ds, _ = data
    xyz, _, mask = _scan(ds, 3)
    xyz[5] = xyz[4]  # a duplicate of its predecessor
    xyz[9] = [0.05, 0.0, 0.0]  # inside the blind zone
    xyz[11] = [np.nan, 0.0, 0.0]
    prev = np.roll(xyz, 1, axis=0)
    for skip in (False, True):
        np.testing.assert_array_equal(
            tf.uniform_feature_gates(T(xyz), T(prev), T(mask), 0.2, 30.0,
                                     skip_dup=skip).numpy(),
            np.asarray(jf.uniform_feature_gates(xyz, prev, mask, 0.2, 30.0,
                                                skip_dup=skip)))
    np.testing.assert_array_equal(
        tf.uniform_feature_extraction(T(xyz), T(mask), 3, 0.2, 30.0).numpy(),
        np.asarray(jf.uniform_feature_extraction(xyz, mask, 3, 0.2, 30.0)))
    assert tf.decimated_width(131072, 3) == jf.decimated_width(131072, 3)


@pytest.mark.parametrize("target", [300, 3000])
def test_range_stratified_mask_exact(data, target):
    ds, _ = data
    xyz, _, mask = _scan(ds, 7)
    keep_t = tf.range_stratified_mask(T(xyz), T(mask), target).numpy()
    keep_j = np.asarray(jf.range_stratified_mask(xyz, mask, target))
    np.testing.assert_array_equal(keep_t, keep_j)
    assert 0 < keep_j.sum() < mask.sum()


@pytest.mark.parametrize("capacity", [256, 777, 2048])
def test_select_features_lanes_exact(data, capacity):
    ds, _ = data
    xyz, t_rel, mask = _scan(ds, 5)
    mask = mask & (np.arange(len(mask)) % 5 != 2)
    out_t = tf.select_features(T(xyz), T(mask), capacity, T(t_rel))
    out_j = jf.select_features(xyz, mask, capacity, t_rel)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_thin_and_select_range_mode(data):
    ds, _ = data
    xyz, t_rel, mask = _scan(ds, 9)
    out_t = tf.thin_and_select(T(xyz), T(mask), torch.tensor(0.2), 512, 4096,
                               T(t_rel), mode="range")
    out_j = jf.thin_and_select(xyz, mask, 0.2, 512, 4096, t_rel,
                               mode="range")
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(NotImplementedError):
        tf.thin_and_select(T(xyz), T(mask), 0.2, 512, 4096, mode="voxel")


@pytest.mark.parametrize("k", [14, 22])
def test_undistort_points(data, k):
    ds, window = data
    win = window(k)
    xyz, t_rel, mask = _scan(ds, k, 512)
    c, s = np.cos(0.2), np.sin(0.2)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)
    t = np.array([0.1, -0.2, 0.05], np.float32)
    t0 = np.float32(ds.scans[k].t_start)
    out_j = jf.undistort_points(xyz, t_rel, mask, t0, win, R, t)
    out_t = tf.undistort_points(T(xyz), T(t_rel), T(mask), T(t0),
                                convert.from_numpy(win), T(R), T(t))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert np.abs(np.asarray(out_j[0]) - xyz).max() > 1e-3  # it undistorts


def test_preintegrate_with_jacobians(data):
    _, window = data
    win = window(20)
    ba = np.array([0.03, -0.02, 0.01], np.float32)
    bg = np.array([0.002, 0.001, -0.003], np.float32)
    pj = jax.device_get(ji.preintegrate(win, ba, bg))
    pt = ti.preintegrate(convert.from_numpy(win), T(ba), T(bg))
    for f in pj._fields:
        a, b = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(b).max()),
                                   err_msg=f)
    assert np.abs(pj.J_p_ba).max() > 1e-4  # the Jacobians are not trivial


def test_smoother_update_sequence(data):
    """Keyframes from the same lidar poses and IMU windows, each
    marginalizing the oldest state, starting from a full window built by
    the JAX package and carried across.

    While the window fills, the increment coordinates of the not-yet-valid
    states make the scaled system singular up to its 1e-7 damping, so the
    comparison starts from a full window.  The first update is held to
    1e-4.  Later ones inherit the marginal prior: a Schur complement of
    bias random-walk blocks of size ~wba^2 ~ 2e9 whose float32
    cancellation leaves ~1e3 of information noise in either
    implementation (measured: 2.5% of prior_info, 1.8e-2 of the prior
    mean on this sequence), so the chained states are held to that."""
    ds, window = data
    cfg_j, cfg_t = JImu(smoother_gn_iters=2), ImuConfig(smoother_gn_iters=2)
    upd = jax.jit(lambda st, p, tk, w: ji.smoother_update(st, cfg_j, p, tk,
                                                          w))
    st_j = ji.smoother_init(cfg_j)
    rng = np.random.default_rng(2)

    def inputs(k):
        q = ds.gt_poses_q[k].astype(np.float32)
        p = (ds.gt_poses_t[k] + rng.normal(0, 0.005, 3)).astype(np.float32)
        return q, p, window(k - 1), np.float32(ds.scans[k].t_start)

    def compare(st_t, st_j, tol):
        sj = jax.device_get(st_j)
        for f in ("q", "p", "v", "ba", "bg", "t", "meas_q", "meas_p",
                  "valid", "key", "failed"):
            a, b = getattr(st_t, f).numpy(), np.asarray(getattr(sj, f))
            np.testing.assert_allclose(a, b, rtol=tol, atol=2 * tol,
                                       err_msg=f)
        # the marginal prior's mean comes from the cancellation-limited
        # Schur complement already at the first update
        np.testing.assert_allclose(st_t.prior_q.numpy(), sj.prior_q,
                                   atol=2e-3)
        return sj

    for k in range(12, 19):
        q, p, win, tk = inputs(k)
        st_j, _ = upd(st_j, jg.Pose(q, p), tk, win)
    st_t = convert.smoother_state_from_numpy(jax.device_get(st_j))
    for n, k in enumerate(range(19, 23)):
        q, p, win, tk = inputs(k)
        st_j, out_j = upd(st_j, jg.Pose(q, p), tk, win)
        st_t, out_t = ti.smoother_update(st_t, cfg_t, Pose(T(q), T(p)), T(tk),
                                         convert.from_numpy(win))
        sj = compare(st_t, st_j, 1e-4 if n == 0 else 1e-2)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t),
                               atol=2e-3)
    assert bool(sj.valid.all()) and not bool(sj.failed)
    # propagate_state from the same smoothed window
    pre = ji.preintegrate(window(22), sj.ba[-1], sj.bg[-1])
    for a, b in zip(ti.propagate_state(st_t, cfg_t, convert.from_numpy(
            jax.device_get(pre))), ji.propagate_state(sj, cfg_j, pre)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-2)
