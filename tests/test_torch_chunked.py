"""The port's chunked replay and IMU-rate stream against the JAX package:
``propagate_high_rate`` on the same smoother state and window; one chunk
of 4 scans from a transplanted JAX state against JAX's
``make_chunked_step_fn`` on JAX's ``stack_chunked_inputs``; the whole
chunked replay (with its per-scan remainder) against the JAX chunked
replay under the golden-lock pinning rule; the per-scan stream against
JAX's.  The port alone: every chunk size and ``preload=False`` give the
per-scan poses bit for bit, and the warm-up step leaves the state as it
was.  JAX compiles two programs here: the chunked step (with the stream)
and the per-scan step."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu import inertial as jinertial  # noqa: E402
from superodom_tpu.io.datasets import BoxWorld, ate_rmse, make_dataset  # noqa: E402
from superodom_tpu.pipeline import make_chunked_step_fn as j_chunked  # noqa: E402
from superodom_tpu.pipeline import make_step_fn  # noqa: E402
from superodom_tpu.runner import OdometryRunner as JRunner  # noqa: E402

from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch import convert, inertial, pipeline as tp  # noqa: E402
from superodom_tpu_torch.geometry import (  # noqa: E402
    quat_identity,
    quat_mul,
    quat_normalize,
    quat_rotate,
    so3_exp,
)
from superodom_tpu_torch.runner import OdometryRunner  # noqa: E402

from test_torch_pipeline import _tiny  # noqa: E402

N_SCANS = 22  # 5 chunks of 4 and a remainder of 2
CHUNK = 4
AT_CHUNK = 3  # scans 12-15: past static IMU init and the startup window


def _dataset(n_scans=N_SCANS, static_scans=12):
    return make_dataset(np.random.default_rng(3), n_scans=n_scans,
                        points_per_scan=3000, radius=2.0, laps=0.1,
                        world=BoxWorld(half_extent=np.array([8.0, 6.0, 3.0])),
                        static_scans=static_scans)


def _cfg(mod):
    return _tiny(mod, early_exit=False)


def _index(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX, on one dataset: the per-scan replay with its IMU-rate stream,
    and the chunked replay assembled from ``stack_chunked_inputs``, the
    chunked step with the stream and the per-scan step for the remainder
    (JAX's own ``run_dataset_chunked`` raises NameError: C1)."""
    ds = _dataset()
    per_scan = JRunner(_cfg(jcfg)).run_dataset(ds, use_imu=True,
                                               high_rate=True, warmup=False)
    runner = JRunner(_cfg(jcfg))
    stacked, n_chunks = runner.stack_chunked_inputs(ds, use_imu=True,
                                                    chunk=CHUNK)
    chunk_fn = j_chunked(runner.step_cfg, high_rate=True)
    state, chunks, before = runner.state, [], None
    for c in range(n_chunks):
        if c == AT_CHUNK:
            before = jax.device_get(state)
        state, outs = chunk_fn(state, *_index(stacked, c))
        chunks.append(jax.device_get(outs))
    poses = [o.pose.t for o, _ in chunks]
    for s in ds.scans[n_chunks * CHUNK:]:
        t_end = s.t_start + float(s.t_rel[-1])
        win, ok = runner._imu_window(s.t_start, t_end)
        state, out = runner.step_fn(
            state, runner.make_scan(s.t_start, s.xyz_body, s.t_rel), win,
            np.asarray(ok))
        poses.append(np.asarray(out.pose.t)[None])
    return {"ds": ds, "per_scan": per_scan, "stacked": stacked,
            "chunks": chunks, "before": before,
            "poses": np.concatenate(poses)}


def _integrate_chain_before(t, acc, gyr, mask, ba, bg, dtype, rate=200.0):
    """The port's ``_integrate_chain`` as it was before it took a start
    state: the preintegration must keep its results to the bit."""
    dt = inertial._sample_dts(t, mask, dtype, rate)
    Q = quat_normalize(inertial._prefix_scan(
        so3_exp((gyr - bg) * dt[:, None]), quat_mul))
    q_prev = torch.cat([quat_identity(dtype, t.device)[None], Q[:-1]], dim=0)
    acc_w = torch.where(mask[:, None], quat_rotate(q_prev, acc - ba), 0.0)
    v = torch.cumsum(acc_w * dt[:, None], dim=0)
    v_prev = torch.cat([torch.zeros((1, 3), dtype=dtype), v[:-1]], dim=0)
    p = torch.cumsum(v_prev * dt[:, None] + 0.5 * acc_w * dt[:, None] ** 2,
                     dim=0)
    return Q, v, p, dt


def test_propagate_high_rate_matches_jax(jax_runs):
    """The stream's chain from a warm JAX smoother state over a live IMU
    window, to 1e-5; the chain without a start state bit-identical to the
    one before it took one."""
    before = jax_runs["before"]
    win = _index(jax_runs["stacked"][1], (AT_CHUNK, 0))
    assert win.mask.sum() > 10
    imu_cfg = _cfg(jcfg).imu
    poses_j, vel_j, mask_j = jax.device_get(jinertial.propagate_high_rate(
        before.smoother, imu_cfg, win))
    sm = convert.smoother_state_from_numpy(before.smoother)
    w = convert.imu_window_from_numpy(win)
    poses_t, vel_t, mask_t = inertial.propagate_high_rate(
        sm, _cfg(tcfg).imu, w)
    np.testing.assert_array_equal(mask_t.numpy(), mask_j)
    m = mask_j
    np.testing.assert_allclose(poses_t.q.numpy()[m], poses_j.q[m], atol=1e-5)
    np.testing.assert_allclose(poses_t.t.numpy()[m], poses_j.t[m], atol=1e-5)
    np.testing.assert_allclose(vel_t.numpy()[m], vel_j[m], atol=1e-5)
    args = (w.t, w.acc, w.gyr, w.mask, sm.ba[-1], sm.bg[-1], torch.float32)
    for a, b in zip(inertial._integrate_chain(*args, rate=200.0),
                    _integrate_chain_before(*args, rate=200.0)):
        assert torch.equal(a, b)


def _assert_step_like_jax(out_t, out_j):
    """test_torch_pipeline.py's one-step tolerances, on numpy outputs."""
    np.testing.assert_allclose(out_t.pose.q, out_j.pose.q, atol=1e-4)
    np.testing.assert_allclose(out_t.pose.t, out_j.pose.t, atol=1e-4)
    np.testing.assert_allclose(out_t.smoothed_pose.t, out_j.smoothed_pose.t,
                               atol=1e-3)
    for f in ("surf_stack_num", "edge_stack_num", "surf_map_num",
              "edge_map_num", "prediction_source", "motion_accepted",
              "imu_healthy"):
        assert getattr(out_t, f) == getattr(out_j, f), f
    assert out_t.icp.n_iterations == out_j.icp.n_iterations
    np.testing.assert_allclose(out_t.icp.plane_rejection_hist,
                               out_j.icp.plane_rejection_hist, atol=3)


def test_one_chunk_matches_jax(jax_runs):
    """Chunk AT_CHUNK, scan by scan from the state JAX carries (its own
    per-scan step gives its chunk's outputs to the bit): each of the port's
    steps at the one-step tolerances (pose 1e-4, the integer outputs
    equal); the chunk's stream from the smoother JAX's step left to 1e-3
    (p) and 1e-4 (q), its mask that of the port's step.  The port's chunk
    from JAX's state at the chunk's start, carrying its own state, gives
    its own four steps and their streams to the bit."""
    scans_j, imus_j, avails_j = _index(jax_runs["stacked"], AT_CHUNK)
    outs_j, hr_j = jax_runs["chunks"][AT_CHUNK]
    assert avails_j.all() and hr_j.mask.sum() > CHUNK * 10
    cfg = _cfg(tcfg)
    step_j = make_step_fn(_cfg(jcfg))
    state_j = jax_runs["before"]
    state_own = convert.odom_state_from_numpy(state_j)
    _, chunk_t = tp.make_chunked_step_fn(cfg, high_rate=True)(
        state_own, convert.scan_from_numpy(scans_j),
        convert.imu_window_from_numpy(imus_j), torch.from_numpy(avails_j))
    chunk_t = convert.to_numpy(chunk_t)
    for k in range(CHUNK):
        scan, imu, avail = _index((scans_j, imus_j, avails_j), k)
        scan_t = convert.scan_from_numpy(scan)
        imu_t = convert.imu_window_from_numpy(imu)
        avail_t = torch.tensor(bool(avail))
        after_t, out_t = tp.step(cfg, convert.odom_state_from_numpy(state_j),
                                 scan_t, imu_t, avail_t)
        state_j, out_j = jax.device_get(step_j(state_j, scan, imu, avail))
        np.testing.assert_array_equal(out_j.pose.t, outs_j.pose.t[k])
        _assert_step_like_jax(convert.to_numpy(out_t), out_j)
        # the stream from the smoother JAX's step left: after one update
        # the port's own smoother stands further from JAX's than the
        # stream's tolerance (C2, ROADMAP.md)
        poses, vels, mask = convert.to_numpy(inertial.propagate_high_rate(
            convert.smoother_state_from_numpy(state_j.smoother), cfg.imu,
            imu_t))
        m = hr_j.mask[k]
        np.testing.assert_array_equal(
            mask & (not bool(after_t.smoother.failed)), m)
        np.testing.assert_array_equal(imu.t, hr_j.t[k])
        np.testing.assert_allclose(poses.t[m], hr_j.p[k][m], atol=1e-3)
        np.testing.assert_allclose(poses.q[m], hr_j.q[k][m], atol=1e-4)
        np.testing.assert_allclose(vels[m], hr_j.v[k][m], atol=1e-3)
        # the port's chunk is its own steps
        state_own, own = tp.step(cfg, state_own, scan_t, imu_t, avail_t)
        own_hr = inertial.propagate_high_rate(state_own.smoother, cfg.imu,
                                              imu_t)
        mine = jax.tree_util.tree_leaves(
            (convert.to_numpy(own), convert.to_numpy(own_hr[:2])))
        stacked = jax.tree_util.tree_leaves(
            (_index(chunk_t[0], k), _index(chunk_t[1][1:4], k)))
        assert len(mine) == len(stacked) > 30
        for a, b in zip(mine, stacked):
            np.testing.assert_array_equal(a, b)


def test_chunked_replay_tracks_like_jax(jax_runs):
    """The port's whole chunked replay, remainder included, against the
    JAX chunked replay: ATE <= max(1.3 x JAX ATE, JAX ATE + 1 cm), the
    pinning rule of tests/test_golden.py; its IMU-rate stream as
    tests/test_chunked.py holds JAX's (monotonic across chunk and
    remainder boundaries, ~50 Hz, finite, continuous, on the smoothed
    trajectory)."""
    ds = jax_runs["ds"]
    ate_j = ate_rmse(jax_runs["poses"], ds.gt_poses_t)
    res = OdometryRunner(_cfg(tcfg), device="cpu").run_dataset_chunked(
        ds, use_imu=True, chunk=CHUNK, high_rate=True)
    assert res.poses_t.shape == (N_SCANS, 3) and np.isfinite(res.poses_t).all()
    assert [s["i"] for s in res.stats] == list(range(N_SCANS))
    ate_t = ate_rmse(res.poses_t, ds.gt_poses_t)
    assert ate_t <= max(1.3 * ate_j, ate_j + 0.01), (ate_t, ate_j)
    assert ate_j < 0.1
    t, p = res.high_rate_t, res.high_rate_p
    assert len(t) > (t[-1] - t[0]) * 35, (len(t), t[-1] - t[0])
    assert np.all(np.diff(t) > 0)
    assert np.isfinite(p).all() and np.isfinite(res.high_rate_v).all()
    assert np.linalg.norm(np.diff(p, axis=0), axis=1).max() < 0.15
    # the remainder's scans add samples after the last chunk's
    assert t[-1] > ds.scans[N_SCANS - CHUNK // 2].t_start
    idx = np.clip(np.searchsorted(t, np.asarray(ds.times)[5:-1]), 0,
                  len(t) - 1)
    d = np.linalg.norm(p[idx] - res.smoothed_t[5:-1], axis=1)
    assert np.median(d) < 0.2, np.median(d)


def test_per_scan_stream_matches_jax(jax_runs):
    """``run_dataset(high_rate=True)``: the same sample times as JAX's
    per-scan stream, positions within the 0.1 m that tests/test_chunked.py
    allows between two streams, and on the port's own smoothed
    trajectory."""
    ds, res_j = jax_runs["ds"], jax_runs["per_scan"]
    res = OdometryRunner(_cfg(tcfg), device="cpu").run_dataset(
        ds, use_imu=True, high_rate=True)
    t, p = res.high_rate_t, res.high_rate_p
    assert len(t) > 40
    np.testing.assert_array_equal(t, res_j.high_rate_t)
    np.testing.assert_allclose(p, res_j.high_rate_p, atol=0.1)
    assert res.high_rate_q.shape == (len(t), 4)
    assert np.isfinite(res.high_rate_v).all()
    idx = np.clip(np.searchsorted(t, np.asarray(ds.times)[5:-1]), 0,
                  len(t) - 1)
    d = np.linalg.norm(p[idx] - res.smoothed_t[5:-1], axis=1)
    assert np.median(d) < 0.2, np.median(d)


def test_chunk_sizes_give_the_per_scan_poses():
    """The port alone, without IMU (so both replays see the same
    windows): chunks of 4 over 10 scans (2 chunks and a remainder of 2),
    one chunk of 10, the streamed inputs and a chunk longer than the
    replay all give the per-scan poses bit for bit, with the per-scan
    stats surface less ``"t"``."""
    ds = _dataset(10, static_scans=2)
    cfg = _cfg(tcfg)
    ref = OdometryRunner(cfg, device="cpu").run_dataset(ds, use_imu=False)
    for kw in (dict(chunk=4), dict(chunk=10), dict(chunk=4, preload=False),
               dict(chunk=16, time_chunks=True)):
        res = OdometryRunner(cfg, device="cpu").run_dataset_chunked(
            ds, use_imu=False, **kw)
        np.testing.assert_array_equal(res.poses_t, ref.poses_t, err_msg=kw)
        np.testing.assert_array_equal(res.poses_q, ref.poses_q, err_msg=kw)
        np.testing.assert_array_equal(res.smoothed_t, ref.smoothed_t)
        assert [s["i"] for s in res.stats] == list(range(10))
        for a, b in zip(ref.stats, res.stats):
            assert set(a) - set(b) == {"t"} and set(b) <= set(a)
            assert a["n_iterations"] == b["n_iterations"]
            assert a["plane_rejection_hist"] == b["plane_rejection_hist"]
            assert b["time_elapsed_ms"] >= 0.0
        assert res.scans_per_sec > 0.0


def _leaves(tree):
    return [np.array(a) for a in jax.tree_util.tree_leaves(
        convert.to_numpy(tree))]


def test_warm_up_leaves_the_state_as_it_was():
    """The chunked replay's warm-up step, and the step itself, leave
    their input state bit-identical (the step changes nothing in place)
    on a warm state with a live IMU window."""
    ds = _dataset(13)
    runner = OdometryRunner(_cfg(tcfg), device="cpu")
    stacked, rest, n_chunks = runner.stack_chunked_inputs(ds, chunk=12)
    assert n_chunks == 1 and len(rest) == 1
    chunk_fn = tp.make_chunked_step_fn(runner.step_cfg)
    runner.state, _ = chunk_fn(runner.state,
                               *runner._to_device(_index(stacked, 0)))
    assert bool(runner.state.smoother.valid[0])
    assert bool(rest[0][2]) and rest[0][1].mask.any()
    state = runner.state
    snapshot = _leaves(state)
    runner._warm_up(rest[0])
    assert runner.state is state
    tp.step(runner.step_cfg, state, *runner._to_device(rest[0]))
    after = _leaves(state)
    assert len(after) == len(snapshot) > 40
    for a, b in zip(snapshot, after):
        np.testing.assert_array_equal(a, b)
