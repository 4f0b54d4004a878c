"""Frontend and inertial modules of the PyTorch port against the JAX
package: gates, r^2-stratified thinning and compaction (lane sets exact),
IMU undistortion (1e-5), preintegration with its bias Jacobians and the
fixed-lag smoother (1e-4); and scan thinning: the plain version of the
voxel_claim kernel (K10, keep-masks exact), the per-voxel centroid
downsample with an extra channel (masks and lane order exact, centroids
1e-6: ``index_add_`` and ``segment_sum`` may add in different orders),
``thin_and_select`` in its four modes and through the ``compact_width``
pre-compaction (lane sets exact), and the adaptive voxel size on a near and
a far cloud."""

import dataclasses


import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu import frontend as jf  # noqa: E402
from superodom_tpu import geometry as jg  # noqa: E402
from superodom_tpu import inertial as ji  # noqa: E402
from superodom_tpu import pipeline as jp  # noqa: E402
from superodom_tpu.config import ImuConfig as JImu  # noqa: E402
from superodom_tpu.io.datasets import BoxWorld, make_dataset  # noqa: E402
from superodom_tpu.ops import voxel as jv  # noqa: E402

from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch import convert, kernels  # noqa: E402
from superodom_tpu_torch import frontend as tf  # noqa: E402
from superodom_tpu_torch import inertial as ti  # noqa: E402
from superodom_tpu_torch import pipeline as tp  # noqa: E402
from superodom_tpu_torch.config import ImuConfig  # noqa: E402
from superodom_tpu_torch.geometry import Pose  # noqa: E402
from superodom_tpu_torch.native import ImuBuffer  # noqa: E402
from superodom_tpu_torch.ops import voxel as tv  # noqa: E402

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
    # the other three modes: test_thin_and_select_modes below
    with pytest.raises(ValueError):
        tf.thin_and_select(T(xyz), T(mask), 0.2, 512, 4096, mode="octree")


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


# ---- scan thinning (K10, centroid, thin_and_select, voxel size) ----

N_CLOUD = 3000


def _cloud(seed=0, n=N_CLOUD, centre=(0.0, 0.0, 0.0)):
    """Points on and around a few surfaces, several a 0.2 m voxel, on both
    sides of every axis; every seventh lane masked out."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    xyz[: n // 2, 2] = np.float32(-1.5)  # a floor: many points a voxel
    xyz[n // 2: 3 * n // 4, 0] = np.float32(4.0)
    xyz = (xyz + np.float32(centre)).astype(np.float32)
    mask = np.arange(n) % 7 != 3
    t_rel = rng.uniform(0.0, 0.1, n).astype(np.float32)
    return xyz, mask, t_rel


SCATTER_CASES = {
    # name: (table_bits, res, centre, all lanes masked out)
    "default_table": (0, 0.2, (0.0, 0.0, 0.0), False),
    "given_table": (14, 0.2, (0.0, 0.0, 0.0), False),
    "16_entries": (4, 0.2, (0.0, 0.0, 0.0), False),  # collisions everywhere
    "negative_coordinates": (0, 0.2, (-40.0, -25.0, -9.0), False),
    "all_masked_out": (0, 0.2, (0.0, 0.0, 0.0), True),
    "coarse": (0, 0.8, (3.0, -2.0, 0.5), False),
}


@pytest.mark.parametrize("res_as_tensor", [False, True],
                         ids=["float", "tensor"])
@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_voxel_downsample_scatter_exact(case, res_as_tensor):
    bits, res, centre, dead = SCATTER_CASES[case]
    xyz, mask, _ = _cloud(1, centre=centre)
    if dead:
        mask = np.zeros_like(mask)
    keep_j = np.asarray(jv.voxel_downsample_scatter(xyz, mask,
                                                    np.float32(res), bits))
    keep_t = tv.voxel_downsample_scatter(
        T(xyz), T(mask), torch.tensor(res) if res_as_tensor else res,
        table_bits=bits)
    assert keep_t.dtype == torch.bool
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    if dead:
        assert not keep_j.any()
    elif bits == 4:
        assert keep_j.sum() == 16  # every table entry has one survivor
    else:
        assert 100 < keep_j.sum() < mask.sum()
    if case == "negative_coordinates":
        assert (xyz < 0).all()


def test_voxel_downsample_scatter_dispatch():
    xyz, mask, _ = _cloud(2)
    a = tv.voxel_downsample_scatter(T(xyz), T(mask), 0.2)
    b = tv.voxel_downsample_scatter_reference(T(xyz), T(mask), 0.2)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):  # the kernel's wrapper: CUDA tensors only
        kernels.voxel_claim(T(xyz), T(mask), torch.tensor(0.2), 14)


@pytest.mark.parametrize("res", [0.2, 0.7])
def test_voxel_downsample_centroid_with_extras(res):
    xyz, mask, t_rel = _cloud(3)
    two = np.stack([t_rel, 1.0 - t_rel], axis=1).astype(np.float32)
    out_j = jv.voxel_downsample_centroid(xyz, mask, np.float32(res), t_rel,
                                         two)
    out_t = tv.voxel_downsample_centroid(T(xyz), T(mask), torch.tensor(res),
                                         T(t_rel), T(two))
    assert len(out_t) == 4
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    for a, b in zip((out_t[0], *out_t[2:]), (out_j[0], *out_j[2:])):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    n_vox = int(np.asarray(out_j[1]).sum())
    assert 50 < n_vox < mask.sum()
    assert not out_t[0].numpy()[n_vox:].any()  # compacted to the front


THIN_CASES = {
    # name: (mode, compact_width): 4096 leaves the 3,000 lanes alone, 1024
    # compacts them first
    "voxel": ("voxel", 4096),
    "voxel_compacted": ("voxel", 1024),
    "centroid": ("centroid", 4096),
    "centroid_compacted": ("centroid", 1024),
    "range": ("range", 4096),
    "none": ("none", 4096),
}


@pytest.mark.parametrize("case", list(THIN_CASES))
def test_thin_and_select_modes(case):
    mode, width = THIN_CASES[case]
    xyz, mask, t_rel = _cloud(4)
    bits = max((4 * N_CLOUD * 3 - 1).bit_length(), 4)  # a 3x wider sensor's table
    out_j = jf.thin_and_select(xyz, mask, np.float32(0.2), 512, width, t_rel,
                               mode=mode, table_bits=bits)
    out_t = tf.thin_and_select(T(xyz), T(mask), torch.tensor(0.2), 512, width,
                               T(t_rel), mode=mode, table_bits=bits)
    assert len(out_t) == 3 and out_t[0].shape == (512, 3)
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    assert 100 < int(out_t[1].sum()) <= 512
    if mode == "centroid":  # lanes are means: 1e-6
        for a, b in zip(out_t, out_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    else:  # lanes are input lanes: exact
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_thin_and_select_table_bits_follows_the_sensor():
    """The table size decides which voxels merge: the default (4x the lane
    count) and a wider sensor's table keep different lanes, and both sides
    agree on each."""
    xyz, mask, _ = _cloud(5)
    keeps = []
    for bits in (0, 11):
        kj = np.asarray(jv.voxel_downsample_scatter(xyz, mask,
                                                    np.float32(0.2), bits))
        kt = tv.voxel_downsample_scatter(T(xyz), T(mask), 0.2, bits).numpy()
        np.testing.assert_array_equal(kt, kj)
        keeps.append(kj)
    assert (keeps[0] != keeps[1]).any()


@pytest.mark.parametrize("scale,expect", [(0.25, (0.1, 0.2)),
                                          (1.0, (0.3, 0.6)),
                                          (2.5, (0.4, 0.8))],
                         ids=["near", "between", "far"])
def test_adjust_voxel_size_auto(scale, expect):
    """auto_voxel_size: the product of the per-axis mean |coordinate|
    selects the near preset (< 25), the far one (> 65), or keeps the
    running resolutions."""
    xyz, mask, _ = _cloud(6)
    xyz = (np.abs(xyz) * np.float32(scale) + np.float32(0.5)).astype(
        np.float32)
    cfg_j = jcfg.PipelineConfig(auto_voxel_size=True)
    cfg_t = tcfg.PipelineConfig(auto_voxel_size=True)
    rt_j, avg_j = jp._adjust_voxel_size(
        cfg_j, jcfg.RuntimeParams(np.float32(0.3), np.float32(0.6)), xyz, mask)
    rt_t, avg_t = tp._adjust_voxel_size(
        cfg_t, tcfg.RuntimeParams(torch.tensor(0.3), torch.tensor(0.6)),
        T(xyz), T(mask))
    np.testing.assert_allclose(float(avg_t), float(avg_j), rtol=1e-5)
    assert rt_t.line_res.dtype == torch.float32 and rt_t.line_res.dim() == 0
    for got, want_j, want in zip(rt_t, rt_j, expect):
        assert float(got) == float(np.float32(want_j)) == float(
            np.float32(want))
    # off: the running resolutions pass through untouched
    off = dataclasses.replace(cfg_t, auto_voxel_size=False)
    rt0 = tcfg.RuntimeParams(torch.tensor(0.3), torch.tensor(0.6))
    assert tp._adjust_voxel_size(off, rt0, T(xyz), T(mask))[0] is rt0
