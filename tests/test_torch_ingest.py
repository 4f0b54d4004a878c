"""Recorded and live sensor input through the PyTorch port, against the
JAX package: the four real-time ingestion semantics of
``OdometryRunner.push_scan`` / ``drain_scans`` (tests/test_online_ingestion.py:
skip-frame decimation, drop-oldest shedding at 50 queued, waiting for IMU
coverage, a scan older than the buffer run LiDAR-only); a rosbag2
recording streamed message by message into ``push_scan``; the CLI on a
``--bag`` (with ``--max-scans`` and ``--gt-topic``), an ``--npz`` and a
``--config``, on the CPU, against the JAX CLI on the same files.

Both packages run the JAX CLI's configuration of a VLP-16 cut to 2,048
points a scan (as tests/test_cli.py cuts it), so JAX compiles two step
programs here: that configuration's and, for the decimation case, the
same with ``skip_frame = 3``.

Tolerances: the integer outcomes (outputs, skipped, shed, queued,
prediction sources, scan counts, report keys) are equal; the first
streamed scan's pose is within 1e-4 m of JAX's; whole trajectories are
held to JAX's own bound to ground truth (1.0 m, tests/test_cli.py) and to
the pinning rule of tests/test_golden.py against JAX's ATE (<= max(1.3 x,
+1 cm)), since the smoother's float32 numerics let two correct
implementations part by more than a step's tolerance over a replay (C2,
ROADMAP.md)."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402,F401

from superodom_tpu import cli as jcli  # noqa: E402
from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu import runner as jrunner  # noqa: E402

from superodom_tpu_torch import cli as tcli  # noqa: E402
from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch.io import rosbag as trb  # noqa: E402
from superodom_tpu_torch.io.datasets import (  # noqa: E402
    BoxWorld,
    ate_rmse,
    make_dataset,
)
from superodom_tpu_torch.runner import OdometryRunner  # noqa: E402

N_SCANS = 16
TRACK_BOUND_M = 1.0  # tests/test_cli.py's bound to ground truth
CLOUD_DELAY_S = 0.12  # a cloud is recorded once its sweep has ended


def _small(mod):
    """Each package's ``profile_by_name`` cut to 2,048 points a scan."""
    real = mod.profile_by_name

    def small(name):
        return dataclasses.replace(real(name), max_points=2048,
                                   max_surface_features=512,
                                   max_edge_features=128)
    return small


@pytest.fixture(scope="module")
def small_cli():
    """Both CLIs resolve the cut profile; JAX's runners share one traced
    step program per configuration (each would trace its own)."""
    cache = {}
    make = jrunner.make_step_fn

    def cached(cfg):
        if cfg not in cache:
            cache[cfg] = make(cfg)
        return cache[cfg]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcfg, "profile_by_name", _small(jcfg))
        small_t = _small(tcfg)
        mp.setattr(tcfg, "profile_by_name", small_t)
        mp.setattr(tcli, "profile_by_name", small_t)
        mp.setattr(jrunner, "make_step_fn", cached)
        yield cache


def _cfgs(mod, **sensor):
    return mod.PipelineConfig(sensor=dataclasses.replace(
        mod.profile_by_name("vlp_16"), **sensor))


@pytest.fixture(scope="module")
def sim():
    """16 scans with 6 of motion after 10 static (the IMU's 1 s static
    init completes first)."""
    return make_dataset(np.random.default_rng(11), n_scans=N_SCANS,
                        points_per_scan=2048, radius=2.0, laps=0.1,
                        static_scans=10,
                        world=BoxWorld(half_extent=np.array([10.0, 8.0, 4.0])))


@pytest.fixture(scope="module")
def bag(sim, tmp_path_factory):
    """The dataset as a rosbag2 recording written by the port: PointCloud2
    (x, y, z, time f32), a 200 Hz Imu topic and an Odometry topic of
    ground-truth poses at each scan's start."""
    path = str(tmp_path_factory.mktemp("bags") / "sim")
    w = trb.Rosbag2Writer(path)
    w.add_topic("/velodyne_points", "sensor_msgs/msg/PointCloud2")
    w.add_topic("/imu/data", "sensor_msgs/msg/Imu")
    w.add_topic("/ground_truth", "nav_msgs/msg/Odometry")
    fields = [trb.PointField(k, 4 * i, 7, 1)
              for i, k in enumerate(("x", "y", "z", "time"))]
    for i, s in enumerate(sim.scans):
        n = len(s.xyz_body)
        rec = np.concatenate([s.xyz_body, s.t_rel[:, None]], axis=1)
        msg = trb.PointCloud2(s.t_start, "velodyne", 1, n, fields, False, 16,
                              16 * n, rec.astype("<f4").tobytes(), True)
        w.write("/velodyne_points", int((s.t_start + CLOUD_DELAY_S) * 1e9),
                trb.encode_pointcloud2(msg))
        w.write("/ground_truth", int(s.t_start * 1e9), trb.encode_odometry(
            trb.OdometryMsg(s.t_start, "map", "velodyne", sim.gt_poses_q[i],
                            sim.gt_poses_t[i])))
    for k in range(len(sim.imu.t)):
        w.write("/imu/data", int(sim.imu.t[k] * 1e9), trb.encode_imu(
            trb.ImuMsg(float(sim.imu.t[k]), "imu", np.array([1.0, 0, 0, 0]),
                       sim.imu.gyr[k], sim.imu.acc[k])))
    w.close()
    return path


def _scan(rng, n=512):
    return rng.uniform(-8, 8, (n, 3)).astype(np.float32), \
        np.sort(rng.uniform(0, 0.1, n)).astype(np.float32)


def _imu(runner, t):
    runner.add_imu(t, np.array([0, 0, 9.80511], np.float32),
                   np.zeros(3, np.float32))


def _drive(runner, case):
    """tests/test_online_ingestion.py's scenario ``case`` on ``runner``;
    returns the outputs of every scan it processed."""
    rng = np.random.default_rng(0)
    outs = []
    if case == "skip_frame":
        for i in range(9):
            outs += runner.push_scan(1.0 + i * 0.1, *_scan(rng))
    elif case == "shed":
        _imu(runner, 0.0)  # one sample: the sync says "wait" forever
        for i in range(60):
            outs += runner.push_scan(1.0 + i * 0.1, *_scan(rng, 256))
    elif case == "deferred":
        for k in range(220):
            _imu(runner, k * 0.005)
        outs += runner.push_scan(220 * 0.005 + 0.05, *_scan(rng))
        assert outs == [] and len(runner._scan_queue) == 1
        for k in range(220, 280):
            _imu(runner, k * 0.005)
        outs += runner.drain_scans()
    else:
        for k in range(300):
            _imu(runner, 5.0 + k * 0.005)
        runner.imu_buf.clean(5.5)
        outs += runner.push_scan(5.2, *_scan(rng))  # predates the buffer
    return outs


@pytest.mark.parametrize("case", ["skip_frame", "shed", "deferred",
                                  "predating"])
def test_ingestion_semantics_match_jax(small_cli, case):
    """The same scenario through both runners: the same number of
    outputs, frames skipped, frames shed and queue length, and the same
    prediction source on every processed scan."""
    kw = dict(skip_frame=3) if case == "skip_frame" else {}
    rt = OdometryRunner(_cfgs(tcfg, **kw), device="cpu")
    rj = jrunner.OdometryRunner(_cfgs(jcfg, **kw))
    out_t, out_j = _drive(rt, case), _drive(rj, case)
    assert len(out_t) == len(out_j) == {"skip_frame": 3, "shed": 0,
                                        "deferred": 1, "predating": 1}[case]
    assert (rt.frames_skipped, rt.frames_shed, len(rt._scan_queue)) == (
        rj.frames_skipped, rj.frames_shed, len(rj._scan_queue))
    assert [int(o.prediction_source) for o in out_t] == \
        [int(o.prediction_source) for o in out_j]
    if case == "shed":
        assert len(rt._scan_queue) == rt.MAX_SCAN_QUEUE == 50
        assert rt.frames_shed == 10


def _stream(runner, bag_path):
    """The bag's messages in recorded order: IMU to ``add_imu``, clouds
    through the adapters into ``push_scan``; then one last drain."""
    outs = []
    for _, _, _, msg in trb.Rosbag2Reader(bag_path).messages(
            ["/velodyne_points", "/imu/data"]):
        if isinstance(msg, trb.ImuMsg):
            runner.add_imu(msg.stamp, msg.linear_acceleration,
                           msg.angular_velocity)
        else:
            raw = trb._cloud_to_rawscan(msg, "velodyne", 16)
            outs += runner.push_scan(msg.stamp, raw.xyz, raw.t_rel, raw.ring)
    return outs + runner.drain_scans()


def test_streamed_bag_matches_jax(small_cli, sim, bag):
    """The bag streamed into both runners: every scan processed, nothing
    skipped, shed or left queued, the first scan's pose
    within 1e-4 m of JAX's and the whole trajectory tracking as JAX's."""
    rt = OdometryRunner(_cfgs(tcfg), device="cpu")
    rj = jrunner.OdometryRunner(_cfgs(jcfg))
    out_t, out_j = _stream(rt, bag), _stream(rj, bag)
    assert len(out_t) == len(out_j) == N_SCANS
    assert rt.frames_skipped == rt.frames_shed == len(rt._scan_queue) == 0
    p_t = np.stack([o.pose.t.numpy() for o in out_t])
    p_j = np.stack([np.asarray(o.pose.t) for o in out_j])
    np.testing.assert_allclose(p_t[0], p_j[0], atol=1e-4)
    ate_t, ate_j = ate_rmse(p_t, sim.gt_poses_t), ate_rmse(p_j, sim.gt_poses_t)
    assert ate_t <= max(1.3 * ate_j, ate_j + 0.01) and ate_t < TRACK_BOUND_M


def _keys(d, prefix=""):
    """A report's key paths (the prediction sources' by name only: which
    sources appear is a count, not a key)."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "prediction_sources":
            out |= _keys(v, prefix + k + ".")
    return out


def _run_both(tmp_path, capsys, argv, tag):
    """The port's CLI (on the CPU) and the JAX CLI on the same argv:
    (their JSON lines, trajectories, reports)."""
    out = []
    for name, main, extra in (("t", tcli.main, ["--device", "cpu"]),
                              ("j", jcli.main, [])):
        d = tmp_path / f"{tag}_{name}"
        main(argv + extra + ["--out", str(d)])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        traj = np.loadtxt(d / "trajectory.txt")
        out.append((line, traj, json.loads((d / "report.json").read_text())))
    return out


def _assert_tracks_like_jax(t, j, gt):
    (line_t, traj_t, rep_t), (line_j, traj_j, rep_j) = t, j
    n = len(traj_j)
    assert line_t["scans"] == line_j["scans"] == n
    assert traj_t.shape == traj_j.shape == (n, 7)
    assert _keys(rep_t) == _keys(rep_j)
    assert np.isfinite(traj_t).all()
    err = np.linalg.norm(traj_t[:, :3] - gt[:n], axis=1)
    assert float(err.max()) < TRACK_BOUND_M
    ate_t, ate_j = ate_rmse(traj_t[:, :3], gt[:n]), ate_rmse(traj_j[:, :3],
                                                              gt[:n])
    assert ate_t <= max(1.3 * ate_j, ate_j + 0.01), (ate_t, ate_j)


def test_cli_bag_matches_jax(small_cli, sim, bag, tmp_path, capsys):
    """``--bag --max-scans 12``: JAX's scan count and report keys, the
    trajectory tracking; with ``--gt-topic`` the report adds ATE and RPE
    against the bag's ground truth."""
    argv = ["--bag", bag, "--profile", "vlp_16", "--max-scans", "12"]
    t, j = _run_both(tmp_path, capsys, argv, "bag")
    _assert_tracks_like_jax(t, j, sim.gt_poses_t)
    assert "ate" not in t[2] and t[0]["ate_rmse_m"] is None
    stats = (tmp_path / "bag_t" / "stats.jsonl").read_text().splitlines()
    assert len(stats) == 12
    tcli.main(argv + ["--gt-topic", "/ground_truth", "--device", "cpu",
                      "--out", str(tmp_path / "gt")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rep = json.loads((tmp_path / "gt" / "report.json").read_text())
    assert rep["ate"]["n_poses"] == 12 and "rpe_rmse_m" in rep["rpe"]
    np.testing.assert_allclose(rep["ate"]["rmse_m"], ate_rmse(
        t[1][:, :3], sim.gt_poses_t[:12]), rtol=1e-6)
    assert line["ate_rmse_m"] == rep["ate"]["rmse_m"]


def test_cli_npz_matches_jax(small_cli, sim, tmp_path, capsys):
    """``--npz`` with the JAX CLI's dataset layout."""
    arrays = {"n_scans": len(sim.scans), "imu_t": sim.imu.t,
              "imu_acc": sim.imu.acc, "imu_gyr": sim.imu.gyr,
              "gt_q": sim.gt_poses_q, "gt_t": sim.gt_poses_t,
              "times": sim.times}
    for i, s in enumerate(sim.scans):
        arrays.update({f"scan_{i}_t": s.t_start, f"scan_{i}_xyz": s.xyz_body,
                       f"scan_{i}_trel": s.t_rel})
    path = str(tmp_path / "sim.npz")
    np.savez(path, **arrays)
    t, j = _run_both(tmp_path, capsys, ["--npz", path], "npz")
    _assert_tracks_like_jax(t, j, sim.gt_poses_t)


def test_cli_config_matches_jax(small_cli, sim, bag, tmp_path, capsys):
    """``--config`` with a reference-style YAML that restates the VLP-16
    defaults: the configuration is the one ``--profile vlp_16`` gives,
    and the bag replays as through the JAX CLI."""
    path = tmp_path / "vlp_16.yaml"
    path.write_text("/**:\n  ros__parameters:\n    sensor: velodyne\n"
                    "    laser_mapping_node:\n      max_iterations: 4\n")
    args = tcli.parse_args(["--config", str(path), "--bag", bag])
    assert tcli.config_from_args(args) == _cfgs(tcfg)
    t, j = _run_both(tmp_path, capsys, ["--config", str(path), "--bag", bag],
                     "cfg")
    _assert_tracks_like_jax(t, j, sim.gt_poses_t)
    assert t[0]["config"] == str(path)


def test_cli_needs_exactly_one_source(capsys):
    """One of ``--synthetic`` / ``--npz`` / ``--bag`` is required, and only
    one; ``--config`` names another configuration than ``--ship`` or
    ``--parity`` and is refused with them."""
    for argv in ([], ["--profile", "os1_128"], ["--synthetic", "3", "--bag",
                                                "b"],
                 ["--npz", "a.npz", "--bag", "b"],
                 ["--config", "c.yaml", "--ship", "--bag", "b"],
                 ["--config", "c.yaml", "--parity", "--npz", "a.npz"]):
        with pytest.raises(SystemExit) as e:
            tcli.parse_args(argv)
        assert e.value.code == 2, argv
    capsys.readouterr()
    for argv in (["--synthetic", "3"], ["--npz", "a.npz"], ["--bag", "b"]):
        assert tcli.parse_args(argv).out
