"""The further paths of the PyTorch port against the JAX package, at tiny
sizes: one full step from a transplanted state under a tiny
reference-envelope ("parity") configuration (5 ICP rounds with early exit,
candidate refresh from 16 lanes) and under a tiny VLP-16-default one (voxel
thinning, capacity 32, 4 rounds, a 3-iteration smoother): pose within 1e-4,
the next map's keys and counts exact; map insert / evict cadences 2 and 3
over 12 frames, each frame stepped from the JAX package's state of that
frame: keys and counts exact.  (The three full-width configurations
through ``OdometryRunner`` on the CPU: tests/test_torch_pipeline.py.)"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu.io.datasets import BoxWorld, make_dataset  # noqa: E402
from superodom_tpu.runner import OdometryRunner as JRunner  # noqa: E402

from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch import convert, kernels, pipeline as tp  # noqa: E402
from superodom_tpu_torch.runner import OdometryRunner  # noqa: E402

STEP_AT = 16  # past static IMU init and the 10-frame startup window
CADENCE_FRAMES = 12


def _tiny(mod, kind):
    """A 4,096-point, 768-feature sensor over an 8,192-slot map.

    parity:    ``parity_config``'s registration, thinning, capacity and
               smoother.
    vlp16:     the package defaults ``ship_config("vlp16")`` runs on.
    cadence_k: the ship path's 2 rounds with the map inserted and evicted
               every k-th frame, and an eviction radius inside the room so
               that evicting shows."""
    thin = "voxel" if kind == "vlp16" else "range"
    sensor = mod.SensorProfile(
        name="velodyne", n_scan_lines=16, max_points=4096, min_range=0.2,
        max_range=130.0, filter_point_size=2, max_surface_features=768,
        max_edge_features=64, scan_period=0.1, default_line_res=0.1,
        default_plane_res=0.2, scan_thin_mode=thin)
    map_kw = dict(cell_size=1.0, table_size=1 << 13, evict_radius=200.0)
    if kind == "parity":
        m = mod.MapConfig(cell_capacity=16, **map_kw)
        reg = mod.RegistrationConfig(max_icp_iters=5, refresh_width=16,
                                     tukey_anneal=0.25)
        smoother = 2
    elif kind == "vlp16":
        m = mod.MapConfig(**map_kw)
        reg = mod.RegistrationConfig()
        smoother = mod.ImuConfig().smoother_gn_iters
    else:
        k = int(kind.rsplit("_", 1)[1])
        m = mod.MapConfig(cell_capacity=16, insert_cadence=k, evict_cadence=k,
                          **dict(map_kw, evict_radius=5.0))
        reg = mod.RegistrationConfig(max_icp_iters=2, tukey_anneal=0.25)
        smoother = 2
    return mod.PipelineConfig(
        sensor=sensor, map=m, registration=reg,
        imu=mod.ImuConfig(max_imu_per_scan=48, window_size=6,
                          smoother_gn_iters=smoother),
        auto_voxel_size=False)


def test_tiny_configs_carry_the_paths_settings():
    """The tiny configurations differ from the real ones only in size."""
    for kind, real in (("parity", tcfg.parity_config("os1")),
                       ("vlp16", tcfg.ship_config("vlp16"))):
        tiny = _tiny(tcfg, kind)
        assert tiny.registration == real.registration
        assert tiny.map.cell_capacity == real.map.cell_capacity
        assert tiny.sensor.scan_thin_mode == real.sensor.scan_thin_mode
        assert tiny.imu.smoother_gn_iters == real.imu.smoother_gn_iters
    assert tcfg.ship_config("vlp16").map.cell_capacity == 32
    assert tcfg.ship_config("vlp16").registration.max_icp_iters == 4


def _jax_frames(kind, n_scans, static_scans, keep):
    """The JAX package replays a dataset scan by scan; for every frame in
    ``keep``: (state before, scan, IMU window, synced, state after,
    output)."""
    ds = make_dataset(np.random.default_rng(3), n_scans=n_scans,
                      points_per_scan=3000, radius=2.0, laps=0.1,
                      world=BoxWorld(half_extent=np.array([8.0, 6.0, 3.0])),
                      static_scans=static_scans)
    runner = JRunner(_tiny(jcfg, kind))
    imu_i, frames = 0, {}
    for i, s in enumerate(ds.scans):
        t_end = s.t_start + float(s.t_rel[-1])
        while imu_i < len(ds.imu.t) and ds.imu.t[imu_i] <= t_end + 0.02:
            runner.add_imu(ds.imu.t[imu_i], ds.imu.acc[imu_i],
                           ds.imu.gyr[imu_i])
            imu_i += 1
        if i in keep:
            scan = runner.make_scan(s.t_start, s.xyz_body, s.t_rel)
            win, ok = runner._imu_window(s.t_start, t_end)
            before = jax.device_get(runner.state)
            after, out = jax.device_get(runner.step_fn(before, scan, win,
                                                       np.asarray(ok)))
            frames[i] = (before, scan, win, ok, after, out)
            runner.state = after  # what process_scan would leave
        else:
            runner.process_scan(s.t_start, s.xyz_body, s.t_rel)
    return frames


def _port_step(kind, frame):
    before, scan, win, ok, _, _ = frame
    counts = dict(kernels.launch_counts)
    after, out = tp.step(_tiny(tcfg, kind),
                         convert.odom_state_from_numpy(before),
                         convert.scan_from_numpy(scan),
                         convert.imu_window_from_numpy(win),
                         torch.tensor(bool(ok)))
    assert kernels.launch_counts == counts  # the CPU launches no kernel
    return after, out


def _assert_same_map(after_t, after_j):
    np.testing.assert_array_equal(after_t.surf_map.keys.numpy(),
                                  after_j.surf_map.keys)
    np.testing.assert_array_equal(after_t.surf_map.cnt.numpy(),
                                  after_j.surf_map.cnt)


@pytest.mark.parametrize("kind", ["parity", "vlp16"])
def test_one_step_matches_jax(kind):
    """Pose 1e-4 (metres, quaternion components); the round count, the
    per-round correspondence counts and the integer outputs equal; the
    next map's keys and counts exact, its points 1e-4."""
    frame = _jax_frames(kind, STEP_AT + 1, 12, {STEP_AT})[STEP_AT]
    _, _, _, ok, after_j, out_j = frame
    assert ok  # the IMU window covers this scan
    after_t, out_t = _port_step(kind, frame)
    np.testing.assert_allclose(out_t.pose.q.numpy(), out_j.pose.q, atol=1e-4)
    np.testing.assert_allclose(out_t.pose.t.numpy(), out_j.pose.t, atol=1e-4)
    np.testing.assert_allclose(out_t.smoothed_pose.t.numpy(),
                               out_j.smoothed_pose.t, atol=1e-3)
    for f in ("surf_stack_num", "edge_stack_num", "surf_map_num",
              "edge_map_num", "prediction_source", "motion_accepted",
              "imu_healthy"):
        assert np.asarray(getattr(out_t, f)) == np.asarray(getattr(out_j, f)), f
    n_it = int(out_j.icp.n_iterations)
    assert int(out_t.icp.n_iterations) == n_it
    # the rounds after the first ran (through the refresh, where it is on)
    assert 2 <= n_it <= _tiny(tcfg, kind).registration.max_icp_iters
    assert int(out_j.surf_stack_num) > 300
    # per-round counts: a lane within 1e-5 of a plane-fit gate may flip
    np.testing.assert_allclose(out_t.icp.iter_surf_num.numpy(),
                               out_j.icp.iter_surf_num, atol=3)
    assert (out_j.icp.iter_surf_num[:n_it] > 200).all()
    _assert_same_map(after_t, after_j)
    np.testing.assert_allclose(after_t.surf_map.pts.numpy(),
                               after_j.surf_map.pts, atol=1e-4)
    assert int(after_t.frame_count) == int(after_j.frame_count)


@pytest.mark.parametrize("cadence", [2, 3])
def test_map_cadences_match_jax(cadence):
    """Frames 0..11 on a moving platform: the first 8 always insert, later
    ones when ``frame % cadence == 0``; eviction (radius 5 m in a 16 x 12 m
    room) on ``frame % cadence == 0`` throughout.  Each frame is stepped
    from the JAX package's state of that frame."""
    kind = f"cadence_{cadence}"
    frames = _jax_frames(kind, CADENCE_FRAMES, 2, set(range(CADENCE_FRAMES)))
    changed, evicted = [], []
    for i in range(CADENCE_FRAMES):
        before, _, _, _, after_j, _ = frames[i]
        assert int(before.frame_count) == i
        after_t, _ = _port_step(kind, frames[i])
        _assert_same_map(after_t, after_j)
        grew = after_j.surf_map.cnt.sum() > before.surf_map.cnt.sum()
        gone = ((before.surf_map.keys >= 0)
                & (after_j.surf_map.keys != before.surf_map.keys)).any()
        changed.append(bool(grew))
        evicted.append(bool(gone))
    insert_frames = [i < 8 or i % cadence == 0 for i in range(CADENCE_FRAMES)]
    # a skipped frame leaves the counts alone; an inserting one adds points
    assert [c for c, ins in zip(changed, insert_frames) if not ins] == \
        [False] * insert_frames.count(False)
    assert sum(changed) >= 6
    # cells leave only on an evicting frame, and on some of them
    assert not any(e for i, e in enumerate(evicted) if i % cadence)
    assert any(evicted)


@pytest.mark.parametrize("kind", ["parity", "vlp16", "cadence_3"])
def test_formerly_refused_configs_step(kind):
    """Candidate refresh, voxel thinning and map cadences run; edges (here),
    VIO and LIO prediction (tests/test_torch_pipeline.py) still raise
    NotImplementedError."""
    cfg = _tiny(tcfg, kind)
    scan = OdometryRunner(cfg, device="cpu").make_scan(
        0.0, np.zeros((10, 3), np.float32), np.zeros(10, np.float32))
    win = tp.empty_imu_window(cfg.imu.max_imu_per_scan)
    after, _ = tp.step(cfg, tp.init_state(cfg), scan, win,
                       torch.tensor(False))
    assert int(after.frame_count) == 1
    with pytest.raises(NotImplementedError):
        tp.step(dataclasses.replace(cfg, use_edge_features=True),
                tp.init_state(cfg), scan, win, torch.tensor(False))
