"""The PyTorch port's step and runner against the JAX package: one full
step from the same transplanted state (pose 1e-4, outputs, next map), the
same step with LIO prediction, and
a 20-scan replay through ``OdometryRunner.run_dataset`` held to the
golden-lock pinning rule against the JAX replay of the same data; and, the
port alone, three scans through the runner on the CPU at the full widths
of the reference-envelope OS1-128, VLP-16 and Livox configurations."""

import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu.io.datasets import BoxWorld, ate_rmse, make_dataset  # noqa: E402
from superodom_tpu.runner import OdometryRunner as JRunner  # noqa: E402

from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch import convert, kernels, pipeline as tp  # noqa: E402
from superodom_tpu_torch.runner import OdometryRunner  # noqa: E402

N_SCANS = 20
STEP_AT = 16  # past static IMU init and the 10-frame startup window


def _tiny(mod, early_exit):
    """tests/test_pipeline.py's tiny_config on the ship path: r^2 thinning,
    2 ICP rounds x 4 GN with Tukey annealing, a 2-iteration smoother."""
    sensor = mod.SensorProfile(
        name="velodyne", n_scan_lines=16, max_points=4096, min_range=0.2,
        max_range=130.0, filter_point_size=2, max_surface_features=768,
        max_edge_features=64, scan_period=0.1, default_line_res=0.1,
        default_plane_res=0.2, scan_thin_mode="range")
    return mod.PipelineConfig(
        sensor=sensor,
        map=mod.MapConfig(cell_size=1.0, table_size=1 << 13,
                          cell_capacity=24, evict_radius=200.0),
        registration=mod.RegistrationConfig(
            max_icp_iters=2, max_gn_iters=4, tukey_anneal=0.25,
            icp_early_exit=early_exit),
        imu=mod.ImuConfig(max_imu_per_scan=48, window_size=6,
                          smoother_gn_iters=2),
        auto_voxel_size=False,
    )


def _dataset():
    return make_dataset(np.random.default_rng(3), n_scans=N_SCANS,
                        points_per_scan=3000, radius=2.0, laps=0.1,
                        world=BoxWorld(half_extent=np.array([8.0, 6.0, 3.0])),
                        static_scans=12)


def _feed_imu(runner, ds, i, imu_i):
    s = ds.scans[i]
    t_end = s.t_start + float(s.t_rel[-1])
    while imu_i < len(ds.imu.t) and ds.imu.t[imu_i] <= t_end + 0.02:
        runner.add_imu(ds.imu.t[imu_i], ds.imu.acc[imu_i],
                       ds.imu.gyr[imu_i])
        imu_i += 1
    return imu_i


@pytest.fixture(scope="module")
def jax_replay():
    """The JAX package replays the dataset scan by scan (fixed-count ICP),
    keeping the state and inputs of scan STEP_AT."""
    ds = _dataset()
    runner = JRunner(_tiny(jcfg, early_exit=False))
    imu_i = 0
    poses, captured = [], None
    for i, s in enumerate(ds.scans):
        imu_i = _feed_imu(runner, ds, i, imu_i)
        if i == STEP_AT:
            scan = runner.make_scan(s.t_start, s.xyz_body, s.t_rel)
            win, ok = runner._imu_window(s.t_start,
                                         s.t_start + float(s.t_rel[-1]))
            before = jax.device_get(runner.state)
            after, out = jax.device_get(runner.step_fn(before, scan, win,
                                                       np.asarray(ok)))
            captured = (before, scan, win, ok, after, out)
        out = jax.device_get(runner.process_scan(s.t_start, s.xyz_body,
                                                 s.t_rel))
        poses.append(out.pose.t)
    return ds, np.asarray(poses), captured


def test_one_step_matches_jax(jax_replay):
    _, _, (before, scan, win, ok, after_j, out_j) = jax_replay
    assert ok  # the IMU window covers this scan
    cfg = _tiny(tcfg, early_exit=False)
    state = convert.odom_state_from_numpy(before)
    after_t, out_t = tp.step(cfg, state, convert.scan_from_numpy(scan),
                             convert.imu_window_from_numpy(win),
                             torch.tensor(bool(ok)))
    np.testing.assert_allclose(out_t.pose.q.numpy(), out_j.pose.q, atol=1e-4)
    np.testing.assert_allclose(out_t.pose.t.numpy(), out_j.pose.t, atol=1e-4)
    np.testing.assert_allclose(out_t.smoothed_pose.t.numpy(),
                               out_j.smoothed_pose.t, atol=1e-3)
    for f in ("surf_stack_num", "edge_stack_num", "surf_map_num",
              "edge_map_num", "prediction_source", "motion_accepted",
              "imu_healthy"):
        assert np.asarray(getattr(out_t, f)) == np.asarray(getattr(out_j, f)), f
    assert int(out_t.icp.n_iterations) == int(out_j.icp.n_iterations)
    np.testing.assert_allclose(out_t.icp.plane_rejection_hist.numpy(),
                               out_j.icp.plane_rejection_hist, atol=3)
    for f in ("translation_from_last", "rotation_from_last",
              "total_translation", "total_rotation", "average_distance"):
        np.testing.assert_allclose(float(getattr(out_t, f)),
                                   float(getattr(out_j, f)), atol=1e-4,
                                   rtol=1e-4, err_msg=f)
    # the next state's map: same cells, same counts, same points
    np.testing.assert_array_equal(after_t.surf_map.keys.numpy(),
                                  after_j.surf_map.keys)
    np.testing.assert_array_equal(after_t.surf_map.cnt.numpy(),
                                  after_j.surf_map.cnt)
    np.testing.assert_allclose(after_t.surf_map.pts.numpy(),
                               after_j.surf_map.pts, atol=1e-4)
    assert int(after_t.frame_count) == int(after_j.frame_count)
    np.testing.assert_array_equal(after_t.prev_imu.mask.numpy(),
                                  after_j.prev_imu.mask)


def test_replay_tracks_like_jax(jax_replay):
    """20 scans through the port's runner (early-exit ICP, the ship
    default) on the CPU: ATE <= max(1.3 x JAX ATE, JAX ATE + 1 cm), the
    pinning rule of tests/test_golden.py."""
    ds, poses_j, _ = jax_replay
    ate_j = ate_rmse(poses_j, ds.gt_poses_t)
    runner = OdometryRunner(_tiny(tcfg, early_exit=True), device="cpu")
    res = runner.run_dataset(ds, use_imu=True)
    assert res.poses_t.shape == (N_SCANS, 3) and np.isfinite(res.poses_t).all()
    ate_t = ate_rmse(res.poses_t, ds.gt_poses_t)
    assert ate_t <= max(1.3 * ate_j, ate_j + 0.01), (ate_t, ate_j)
    assert ate_j < 0.1  # the comparison is between two tracking runs
    assert len(res.stats) == N_SCANS and "time_elapsed_ms" in res.stats[0]
    assert res.stats[-1]["n_iterations"] >= 1


def test_runner_runs_on_the_card_by_default():
    """The entry point takes the card unless the caller names the CPU
    (checked by signature: constructing it here would need a card)."""
    params = inspect.signature(OdometryRunner.__init__).parameters
    assert params["device"].default == "cuda"


def test_lio_prediction_matches_jax(jax_replay):
    """LIO prediction (the smoother's newest state propagated through the
    previous interval) from the same warm state as
    test_one_step_matches_jax, whose smoother window is full: the source is
    PRED_LIO_ODOM on both sides, and the step agrees at that test's
    tolerances."""
    from superodom_tpu.pipeline import make_step_fn

    _, _, (before, scan, win, ok, _, _) = jax_replay
    assert before.smoother.valid[0] and before.prev_imu.mask.any()
    cfg_j = dataclasses.replace(_tiny(jcfg, early_exit=False),
                                enable_lio_prediction=True)
    cfg_t = dataclasses.replace(_tiny(tcfg, early_exit=False),
                                enable_lio_prediction=True)
    after_j, out_j = jax.device_get(make_step_fn(cfg_j)(before, scan, win,
                                                        np.asarray(ok)))
    after_t, out_t = tp.step(cfg_t, convert.odom_state_from_numpy(before),
                             convert.scan_from_numpy(scan),
                             convert.imu_window_from_numpy(win),
                             torch.tensor(bool(ok)))
    assert int(out_j.prediction_source) == tp.PRED_LIO_ODOM == 1
    assert int(out_t.prediction_source) == tp.PRED_LIO_ODOM
    np.testing.assert_allclose(out_t.pose.q.numpy(), out_j.pose.q, atol=1e-4)
    np.testing.assert_allclose(out_t.pose.t.numpy(), out_j.pose.t, atol=1e-4)
    np.testing.assert_allclose(out_t.smoothed_pose.t.numpy(),
                               out_j.smoothed_pose.t, atol=1e-3)
    for f in ("surf_stack_num", "surf_map_num", "motion_accepted",
              "imu_healthy"):
        assert np.asarray(getattr(out_t, f)) == np.asarray(getattr(out_j, f)), f
    assert int(out_t.icp.n_iterations) == int(out_j.icp.n_iterations)
    np.testing.assert_allclose(out_t.icp.plane_rejection_hist.numpy(),
                               out_j.icp.plane_rejection_hist, atol=3)
    for f in ("translation_from_last", "total_translation",
              "total_rotation"):
        np.testing.assert_allclose(float(getattr(out_t, f)),
                                   float(getattr(out_j, f)), atol=1e-4,
                                   rtol=1e-4, err_msg=f)
    np.testing.assert_array_equal(after_t.surf_map.cnt.numpy(),
                                  after_j.surf_map.cnt)
    # the trust gate itself, both ways
    for deg, ema, inst in ((True, 0.5, 0.5), (True, 0.5, 0.01),
                           (True, 0.01, 0.5), (False, 0.0, 0.0)):
        got = tp.lio_obs_trusted(torch.tensor(deg), torch.full((3,), ema),
                                 0.05, obs_inst=torch.full((3,), inst))
        assert bool(got) == (not deg or (ema > 0.05 and inst > 0.05))


def test_unported_branches_raise():
    """VIO undistortion is not ported yet (edge features and LIO
    prediction are: tests/test_torch_edges.py and
    test_lio_prediction_matches_jax)."""
    cfg = _tiny(tcfg, early_exit=True)
    state = tp.init_state(cfg)
    scan = OdometryRunner(cfg, device="cpu").make_scan(
        0.0, np.zeros((10, 3), np.float32), np.zeros(10, np.float32))
    win = tp.empty_imu_window(cfg.imu.max_imu_per_scan)
    with pytest.raises(NotImplementedError):
        tp.step(dataclasses.replace(cfg, use_vio_undistortion=True), state,
                scan, win, torch.tensor(False))


@pytest.mark.parametrize("name,make", [("os1", tcfg.parity_config),
                                       ("vlp16", tcfg.ship_config),
                                       ("livox", tcfg.ship_config)])
def test_full_width_configs_run_on_the_cpu(name, make):
    """The reference-envelope OS1-128 configuration and the VLP-16 and
    Livox defaults, at their full widths through the entry point (the port
    alone; sparse scans keep it quick): finite poses, every scan
    registered, the feature and table shapes of the configuration."""
    cfg = make(name)
    ds = make_dataset(np.random.default_rng(11), n_scans=3,
                      points_per_scan=6000, radius=2.0, laps=0.02,
                      world=BoxWorld(half_extent=np.array([8.0, 6.0, 3.0])),
                      static_scans=1)
    runner = OdometryRunner(cfg, device="cpu")
    res = runner.run_dataset(ds)
    assert res.poses_t.shape == (3, 3) and np.isfinite(res.poses_t).all()
    assert np.isfinite(res.poses_q).all()
    assert runner.state.surf_map.pts.shape == (
        cfg.map.table_size, 3 * cfg.map.cell_capacity)
    assert int(runner.state.frame_count) == 3
    for rec in res.stats:
        assert 1 <= rec["n_iterations"] <= cfg.registration.max_icp_iters
        assert len(rec["iterations"]) == cfg.registration.max_icp_iters
    assert res.stats[-1]["surf_stack"] > 300
    assert res.stats[-1]["iterations"][0]["num_surf_from_scan"] > 100
    # the Gauss-Newton kernel's staging fits the widest feature set, with
    # the edge rows beside the planes
    assert kernels.gn_staged_bytes(
        cfg.sensor.max_surface_features,
        cfg.sensor.max_edge_features) <= kernels.GN_MAX_ROW_BYTES
