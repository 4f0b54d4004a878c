"""The port's VIO path against the JAX package: the 6-DoF undistortion
against an external pose path, the sweep-coverage gate, the runner's VIO
windows, the scenario generator's numpy copy, one step on a degenerate
corridor scan where VIO takes over the prediction and the pose prior, and
one chunk of 4 scans with their VIO windows (each scan from the state JAX
carries, C2).  The configuration is tests/test_vio.py's ``_small_cfg``
with ``use_vio_undistortion``.  JAX compiles two programs here: the step
and the chunked step, both with the VIO argument."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu import frontend as jfront  # noqa: E402
from superodom_tpu import pipeline as jpipe  # noqa: E402
from superodom_tpu.io import scenarios as jsc  # noqa: E402
from superodom_tpu.runner import OdometryRunner as JRunner  # noqa: E402

from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch import convert, frontend as tfront  # noqa: E402
from superodom_tpu_torch import pipeline as tp  # noqa: E402
from superodom_tpu_torch.io import scenarios as tsc  # noqa: E402
from superodom_tpu_torch.runner import OdometryRunner  # noqa: E402

N_SCANS = 16  # the corridor scaled to 16 scans: VIO engages from scan ~10
STEP_AT = 12
CHUNK = 4
AT_CHUNK = 3  # scans 12-15


def _small_cfg(mod, **kw):
    """tests/test_vio.py's ``_small_cfg`` in either package."""
    sensor = mod.SensorProfile(
        name="velodyne", n_scan_lines=16, max_points=4096, min_range=0.2,
        max_range=130.0, filter_point_size=1, max_surface_features=1024,
        max_edge_features=128, scan_period=0.1, default_line_res=0.1,
        default_plane_res=0.2)
    return mod.PipelineConfig(
        sensor=sensor,
        map=mod.MapConfig(table_size=1 << 13, cell_capacity=16),
        registration=mod.RegistrationConfig(max_icp_iters=2, max_gn_iters=2),
        imu=mod.ImuConfig(window_size=4, smoother_gn_iters=2),
        auto_voxel_size=False, **kw)


def _case(module, name, pps, scale):
    return next(c for c in module.stress_battery(points_per_scan=pps,
                                                 scale=scale)
                if c.name == name)


def _corridor():
    """The stress battery's VIO corridor at 4,096 points a scan, scaled
    to N_SCANS scans."""
    case = _case(jsc, "vio_corridor", 4096, (N_SCANS + 0.5) / 170)
    ds = case.build(np.random.default_rng(7))
    assert len(ds.scans) == N_SCANS and ds.vio is not None
    return ds


def _index(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _feed_imu(runners, ds, i, imu_i):
    s = ds.scans[i]
    t_end = s.t_start + float(s.t_rel[-1])
    while imu_i < len(ds.imu.t) and ds.imu.t[imu_i] <= t_end + 0.02:
        for r in runners:
            r.add_imu(ds.imu.t[imu_i], ds.imu.acc[imu_i], ds.imu.gyr[imu_i])
        imu_i += 1
    return imu_i


@pytest.fixture(scope="module")
def corridor():
    """JAX replays the corridor scan by scan with its VIO stream, keeping
    every scan's inputs, state and outputs; the port's runner is fed the
    same stream beside it and builds its own inputs."""
    ds = _corridor()
    cfg_j = _small_cfg(jcfg, use_vio_undistortion=True)
    jr = JRunner(cfg_j)
    tr = OdometryRunner(_small_cfg(tcfg, use_vio_undistortion=True),
                        device="cpu")
    for r in (jr, tr):
        r._ingest_dataset_vio(ds)
    imu_i, steps = 0, []
    for i, s in enumerate(ds.scans):
        imu_i = _feed_imu((jr, tr), ds, i, imu_i)
        t_end = s.t_start + float(s.t_rel[-1])
        win, ok = jr._imu_window(s.t_start, t_end)
        args = (jr.make_scan(s.t_start, s.xyz_body, s.t_rel), win,
                np.asarray(ok), jr._vio_window(s.t_start, t_end))
        before = jax.device_get(jr.state)
        jr.state, out = jr.step_fn(jr.state, *args)
        steps.append(dict(before=before, args=args,
                          port_args=tr._host_inputs(s.t_start, s.xyz_body,
                                                    s.t_rel),
                          out=jax.device_get(out),
                          after=jax.device_get(jr.state)))
    return {"ds": ds, "steps": steps, "step_fn": jr.step_fn}


def _smear_case(rng):
    v = np.array([8.0, 0.0, 0.0])  # fast translation, no rotation
    n, k = 512, 8
    t_rel = np.sort(rng.uniform(0, 0.1, n)).astype(np.float32)
    pts_w = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    xyz = (pts_w - v[None, :] * t_rel[:, None]).astype(np.float32)
    path_t = np.linspace(-0.05, 0.2, k).astype(np.float32)
    return (xyz, t_rel, np.ones(n, bool), np.float32(0.0), path_t,
            np.tile(np.array([1, 0, 0, 0], np.float32), (k, 1)),
            (v[None, :] * path_t[:, None]).astype(np.float32),
            np.ones(k, bool)), pts_w


def _six_dof_case(rng):
    """A sweep along a random 6-DoF path at a platform's rates (a few
    degrees and tens of cm between samples), some points and the last
    sample masked out."""
    n, k, t0 = 512, 8, 12.3
    t_rel = np.sort(rng.uniform(0, 0.1, n)).astype(np.float32)
    xyz = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    rpy = np.cumsum(rng.normal(0, 0.02, (k, 3)), axis=0)
    q = jsc._quat_from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2])
    p = np.cumsum(rng.normal(0, 0.3, (k, 3)), axis=0) + [20.0, -5.0, 1.0]
    return (xyz, t_rel, rng.uniform(size=n) < 0.9, np.float32(t0),
            (t0 + np.linspace(-0.05, 0.2, k)).astype(np.float32),
            q.astype(np.float32), p.astype(np.float32),
            np.arange(k) < k - 1), None


@pytest.mark.parametrize("make", [_smear_case, _six_dof_case],
                         ids=["translation_smear", "six_dof"])
def test_posed_undistortion_matches_jax(make):
    """``undistort_points_posed`` on the same inputs: points within 1e-6
    m, the start pose identical; on the translation smear the points are
    the world points (the scan-start frame is the world frame there)."""
    args, pts_w = make(np.random.default_rng(5))
    out_j = [np.asarray(a) for a in jfront.undistort_points_posed(
        *[jnp.asarray(a) for a in args])]
    out_t = [a.numpy() for a in tfront.undistort_points_posed(
        *[torch.from_numpy(np.array(a)) for a in args])]
    np.testing.assert_allclose(out_t[0], out_j[0], rtol=0, atol=1e-6)
    for a, b in zip(out_t[1:], out_j[1:]):
        np.testing.assert_array_equal(a, b)
    assert float(np.abs(out_t[0] - args[0]).max()) > 0.5
    if pts_w is not None:
        np.testing.assert_allclose(out_t[0], pts_w, atol=1e-3)


def _coverage_case(name):
    rng = np.random.default_rng(11)
    n, t0 = 256, 5.0
    t_rel = np.sort(rng.uniform(0, 0.1, n)).astype(np.float32)
    mask = np.arange(n) < n - 40  # the sweep's last lanes are masked out
    t_end_live = t0 + float(t_rel[mask].max())
    t, valid = {
        "covering": (np.linspace(4.95, 5.2, 8), np.ones(8, bool)),
        "short": (np.linspace(4.95, 5.05, 8), np.ones(8, bool)),
        "one_sample": (np.linspace(4.95, 5.2, 8), np.arange(8) == 0),
        # ends between the last live lane and the last masked-out lane
        "covers_live_lanes": (
            np.linspace(4.95, t_end_live + 2e-4, 8), np.ones(8, bool)),
    }[name]
    q = np.tile(np.array([1, 0, 0, 0], np.float32), (8, 1))
    scan = (rng.normal(size=(n, 3)).astype(np.float32), t_rel, mask,
            np.float32(t0), np.zeros(n, np.int32))
    vio = (t.astype(np.float32), q, np.zeros((8, 3), np.float32), valid)
    return scan, vio


@pytest.mark.parametrize("name,expect", [
    ("covering", True), ("short", False), ("one_sample", False),
    ("covers_live_lanes", True)])
def test_vio_covers_matches_jax(name, expect):
    """The coverage gate: at least two samples spanning the sweep, the
    sweep's end its latest live lane; the flag identical to JAX's."""
    scan, vio = _coverage_case(name)
    got_j = bool(jpipe._vio_covers(
        jfront.Scan(*[jnp.asarray(a) for a in scan]),
        jfront.VioWindow(*[jnp.asarray(a) for a in vio])))
    got_t = tp._vio_covers(
        tfront.Scan(*[torch.from_numpy(np.array(a)) for a in scan]),
        tfront.VioWindow(*[torch.from_numpy(np.array(a)) for a in vio]))
    assert got_t.dtype == torch.bool and got_t.shape == ()
    assert bool(got_t) == got_j == expect


def test_vio_window_matches_jax():
    """``_vio_window`` of both runners over one 30 Hz stream: a sweep
    whose bracketing samples exceed ``max_vio_per_scan`` (decimated,
    endpoints kept), one inside the capacity, and sweeps the stream does
    not cover (all masked out): identical arrays, dtypes included."""
    rng = np.random.default_rng(2)
    kw = dict(use_vio_undistortion=True, max_vio_per_scan=5)
    jr = JRunner(_small_cfg(jcfg, **kw))
    tr = OdometryRunner(_small_cfg(tcfg, **kw), device="cpu")
    ts = np.arange(0.0, 3.0, 1.0 / 30)
    qs = rng.normal(size=(len(ts), 4)).astype(np.float32)
    ps = rng.normal(size=(len(ts), 3)).astype(np.float32)
    for r in (jr, tr):
        for t, q, p in zip(ts, qs, ps):
            r.add_vio_pose(t, q, p)
    seen = set()
    for t0, t1 in ((1.0, 1.3), (1.02, 1.1), (2.9, 3.1), (-0.1, 0.05),
                   (0.5, 0.6)):
        wj, wt = jr._vio_window(t0, t1), tr._vio_window(t0, t1)
        assert type(wt).__name__ == "VioWindow"
        for f in wj._fields:
            a, b = getattr(wt, f), getattr(wj, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        seen.add(int(wj.mask.sum()))
    assert seen >= {0, 4, 5}


def _assert_same_arrays(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_scenarios_copy_matches_jax():
    """The port's numpy copy of the scenario generator, array for array:
    a small VIO corridor (scans, IMU, ground truth, VIO stream), the
    SuperLoc prior map, and the localization room."""
    for name in ("vio_corridor", "superloc_corridor", "localization_room"):
        cj = _case(jsc, name, 256, 0.1)
        ct = _case(tsc, name, 256, 0.1)
        assert (cj.ate_bound, cj.settle) == (ct.ate_bound, ct.settle)
        assert {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                    else v) for k, v in cj.cfg_overrides.items()} == \
            {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                 else v) for k, v in ct.cfg_overrides.items()}
        dj, dt = (c.build(np.random.default_rng(7)) for c in (cj, ct))
        assert len(dj.scans) == len(dt.scans) >= 5
        for a, b in zip(dj.scans, dt.scans):
            assert a.t_start == b.t_start
            _assert_same_arrays((a.xyz_body, a.t_rel), (b.xyz_body, b.t_rel))
        _assert_same_arrays((dj.imu, dj.gt_poses_q, dj.gt_poses_t, dj.times),
                            (dt.imu, dt.gt_poses_q, dt.gt_poses_t, dt.times))
        assert (dj.vio is None) == (dt.vio is None) == (name ==
                                                        "localization_room")
        if dj.vio is not None:
            _assert_same_arrays(tuple(dj.vio), tuple(dt.vio))
        if cj.prior_points is not None:
            _assert_same_arrays(cj.prior_points(np.random.default_rng(8)),
                                ct.prior_points(np.random.default_rng(8)))


def _step_tolerances(out_t, after_t, out_j, after_j):
    np.testing.assert_allclose(out_t.pose.t, out_j.pose.t, rtol=0, atol=1e-4)
    np.testing.assert_allclose(out_t.pose.q, out_j.pose.q, rtol=0, atol=1e-5)
    assert out_t.prediction_source == out_j.prediction_source
    assert bool(after_t.vio_available) == bool(after_j.vio_available)
    assert bool(after_t.degenerate) == bool(after_j.degenerate)
    assert bool(out_t.icp.degenerate) == bool(out_j.icp.degenerate)
    np.testing.assert_allclose(after_t.vio_pose.t, after_j.vio_pose.t,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(after_t.vio_pose.q, after_j.vio_pose.q,
                               rtol=0, atol=1e-6)
    for f in ("surf_stack_num", "surf_map_num", "motion_accepted"):
        assert getattr(out_t, f) == getattr(out_j, f), f


def test_step_where_vio_takes_over_matches_jax(corridor):
    """One step of a degenerate corridor scan from JAX's state: VIO
    source (2) with the pose prior enabled in both; ICP pose within 1e-4
    m, quaternion within 1e-5, source, ``vio_available`` and
    ``degenerate`` exact; the same from a window that does not cover the
    sweep, which drops the VIO availability.  The port's runner built
    every scan's inputs, VIO windows included, identical to JAX's."""
    steps = corridor["steps"]
    for s in steps:
        _assert_same_arrays(s["port_args"], s["args"])
    assert sum(int(s["out"].prediction_source) == 2 for s in steps) >= 3
    st = steps[STEP_AT]
    assert int(st["out"].prediction_source) == jpipe.PRED_VIO_ODOM
    assert bool(st["before"].degenerate) and bool(st["after"].vio_available)
    scan, imu, avail, vio = st["args"]
    after_t, out_t = tp.step(
        _small_cfg(tcfg, use_vio_undistortion=True),
        convert.odom_state_from_numpy(st["before"]),
        convert.scan_from_numpy(scan), convert.imu_window_from_numpy(imu),
        torch.tensor(bool(avail)), convert.vio_window_from_numpy(vio))
    _step_tolerances(convert.to_numpy(out_t), convert.to_numpy(after_t),
                     st["out"], st["after"])
    # a window that does not cover the sweep (the stream stopped) drops
    # the VIO availability for this scan, in both
    gone = jpipe.empty_vio_window(vio.t.shape[0])
    after_j, out_j = jax.device_get(corridor["step_fn"](
        st["before"], scan, imu, avail, gone))
    assert not bool(after_j.vio_available)
    after_t, out_t = tp.step(
        _small_cfg(tcfg, use_vio_undistortion=True),
        convert.odom_state_from_numpy(st["before"]),
        convert.scan_from_numpy(scan), convert.imu_window_from_numpy(imu),
        torch.tensor(bool(avail)),
        convert.vio_window_from_numpy(jax.device_get(gone)))
    _step_tolerances(convert.to_numpy(out_t), convert.to_numpy(after_t),
                     out_j, after_j)
    # without a window the flag is ignored, as in JAX
    _, plain = tp.step(_small_cfg(tcfg, use_vio_undistortion=True),
                       convert.odom_state_from_numpy(st["before"]),
                       convert.scan_from_numpy(scan),
                       convert.imu_window_from_numpy(imu),
                       torch.tensor(bool(avail)))
    assert not torch.equal(plain.pose.t, out_t.pose.t)


def test_one_chunk_with_vio_matches_jax(corridor):
    """Chunk AT_CHUNK of JAX's ``make_chunked_step_fn`` over its
    ``stack_chunked_inputs`` (VIO windows stacked as the fifth input): the
    port's inputs identical; each port step from the state JAX carries at
    the one-step tolerances; the port's chunk from JAX's state at the
    chunk's start gives its own four steps to the bit."""
    ds = corridor["ds"]
    cfg_j = _small_cfg(jcfg, use_vio_undistortion=True)
    cfg_t = _small_cfg(tcfg, use_vio_undistortion=True)
    jr = JRunner(cfg_j)
    stacked, n_chunks = jr.stack_chunked_inputs(ds, use_imu=True,
                                                chunk=CHUNK)
    assert n_chunks == N_SCANS // CHUNK and len(stacked) == 4
    tr = OdometryRunner(cfg_t, device="cpu")
    stacked_t, rest, n_t = tr.stack_chunked_inputs(ds, use_imu=True,
                                                   chunk=CHUNK)
    assert n_t == n_chunks and rest == []
    _assert_same_arrays(stacked_t, stacked)
    chunk_j = jpipe.make_chunked_step_fn(cfg_j)
    state_j = jr.state
    for c in range(AT_CHUNK):
        state_j, _ = chunk_j(state_j, *_index(stacked, c))
    state_j = jax.device_get(state_j)
    inputs = _index(stacked, AT_CHUNK)
    outs_j = jax.device_get(chunk_j(state_j, *inputs)[1])
    assert (outs_j.prediction_source == jpipe.PRED_VIO_ODOM).any()
    to_t = (convert.scan_from_numpy, convert.imu_window_from_numpy,
            torch.from_numpy, convert.vio_window_from_numpy)
    state_own = convert.odom_state_from_numpy(state_j)
    _, chunk_t = tp.make_chunked_step_fn(cfg_t)(
        state_own, *[f(x) for f, x in zip(to_t, inputs)])
    chunk_t = convert.to_numpy(chunk_t)
    for k in range(CHUNK):
        args = _index(inputs, k)
        args_t = [f(np.array(x)) if f is torch.from_numpy else f(x)
                  for f, x in zip(to_t, args)]
        after_t, out_t = tp.step(cfg_t, convert.odom_state_from_numpy(state_j),
                                 *args_t)
        state_j, out_j = jax.device_get(corridor["step_fn"](state_j, *args))
        np.testing.assert_array_equal(out_j.pose.t, outs_j.pose.t[k])
        _step_tolerances(convert.to_numpy(out_t), convert.to_numpy(after_t),
                         out_j, state_j)
        state_own, own = tp.step(cfg_t, state_own, *args_t)
        _assert_same_arrays(convert.to_numpy(own), _index(chunk_t, k))
