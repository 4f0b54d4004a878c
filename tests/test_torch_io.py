"""Host I/O of the PyTorch port against the JAX package, exactly: the
native point decode and ring/time synthesis (library and plain versions),
the vendor adapters, the CDR codecs and rosbag2 storage (the bytes each
package writes, and each package reading the other's bags), the bag
loader's arrays, the YAML configuration and calibration loaders, and the
CLI's report and the viewer exports.  No step runs here."""

import json
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu import mapstate as jmap  # noqa: E402
from superodom_tpu import native as jnative  # noqa: E402
from superodom_tpu.io import adapters as jad  # noqa: E402
from superodom_tpu.io import rosbag as jrb  # noqa: E402
from superodom_tpu.tools import benchmark as jbm  # noqa: E402
from superodom_tpu.tools import visualize as jviz  # noqa: E402

from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch import convert, native as tnative  # noqa: E402
from superodom_tpu_torch import utils  # noqa: E402
from superodom_tpu_torch.io import adapters as tad  # noqa: E402
from superodom_tpu_torch.io import rosbag as trb  # noqa: E402
from superodom_tpu_torch.tools import benchmark as tbm  # noqa: E402
from superodom_tpu_torch.tools import visualize as tviz  # noqa: E402

# the ouster_ros point layout: (name, offset, PointField datatype)
OUSTER_FIELDS = (("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("intensity", 16, 7),
                 ("t", 20, 6), ("reflectivity", 24, 4), ("ring", 26, 4),
                 ("ambient", 28, 4), ("range", 32, 6))
OUSTER_STEP = 48
# a VLP-16 layout with its f32 time at an unaligned offset
VELODYNE_FIELDS = (("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("intensity", 12, 7),
                   ("ring", 16, 4), ("time", 18, 7))
VELODYNE_STEP = 22


def _records(rng, fields, step, n, nonfinite=0):
    """n packed records of random field values: coordinates in +-20 m,
    times within a 0.1 s sweep (ns for an integer field), the first
    ``nonfinite`` records' x NaN / inf in turn."""
    buf = np.zeros((n, step), np.uint8)
    for name, off, code in fields:
        dt = trb._PF_DTYPES[code]
        if name in ("x", "y", "z"):
            v = rng.uniform(-20, 20, n)
        elif name in ("t", "time"):
            v = rng.uniform(0, 0.1, n) * (1e9 if dt.kind in "iu" else 1.0)
        else:
            v = rng.uniform(0, 127, n)
        v = v.astype(dt)
        if name == "x" and nonfinite:
            v[:nonfinite] = np.where(np.arange(nonfinite) % 2, np.inf, np.nan)
        buf[:, off:off + dt.itemsize] = v.view(np.uint8).reshape(n, -1)
    return buf.reshape(-1)


def _cloud(mod, rng, fields, step, n, stamp=1.25, nonfinite=0):
    data = _records(rng, fields, step, n, nonfinite).tobytes()
    return mod.PointCloud2(stamp, "lidar", 1, n,
                           [mod.PointField(f, o, c, 1) for f, o, c in fields],
                           False, step, step * n, data, True)


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["ouster_ros", "velodyne", "nonfinite"])
def test_decode_points_matches_jax(kind, monkeypatch):
    """``native.decode_points`` bit for bit against the JAX package's, on
    the ouster_ros layout (u32 ns times scaled by 1e-9), a VLP-16 layout
    (f32 time at an unaligned offset) and records with NaN / inf x that
    are dropped: the library against JAX's library, the plain version
    against JAX's numpy branch."""
    rng = np.random.default_rng(1)
    fields, step = ((VELODYNE_FIELDS, VELODYNE_STEP) if kind == "velodyne"
                    else (OUSTER_FIELDS, OUSTER_STEP))
    pc = _cloud(trb, rng, fields, step, 777,
                nonfinite=40 if kind == "nonfinite" else 0)
    layout = {k: v for k, v in pc.layout().items()
              if k in ("x", "y", "z", "ring", "intensity")}
    tkey = "time" if kind == "velodyne" else "t"
    layout["time"] = pc.layout()[tkey]
    scale = 1.0 if kind == "velodyne" else 1e-9
    args = (pc.data, 777, step, layout, scale)
    lib = tnative.decode_points(*args)
    _assert_same(lib, jnative.decode_points(*args))
    assert len(lib[0]) == 777 - (40 if kind == "nonfinite" else 0)
    ref = tnative.decode_points_reference(*args)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    _assert_same(ref, jnative.decode_points(*args))
    _assert_same(ref, lib)
    with pytest.raises(ValueError):
        tnative.decode_points(pc.data[:-step], 777, step, layout, scale)


@pytest.mark.parametrize("case", ["ouster", "livox", "rings"])
def test_adapters_match_jax(case, monkeypatch):
    """The vendor adapters bit for bit: the Ouster sensor-frame rotation
    and ns -> s times; the Livox tag and line filter; ring and time
    synthesis for 16, 32 and 64 lines (``from_velodyne`` without times,
    ``native.synth_ring_time`` against JAX's library and its plain
    version against JAX's numpy branch)."""
    rng = np.random.default_rng(2)
    n = 4000
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    if case == "ouster":
        t_ns = rng.uniform(0, 1e8, n)
        ring = rng.integers(0, 128, n)
        refl = rng.uniform(0, 1000, n)
        _assert_same(tad.from_ouster(xyz, t_ns, ring, refl),
                     jad.from_ouster(xyz, t_ns, ring, refl))
        _assert_same(tad.from_ouster(xyz, t_ns), jad.from_ouster(xyz, t_ns))
        np.testing.assert_array_equal(tad.OUSTER_SENSOR_R, jad.OUSTER_SENSOR_R)
        np.testing.assert_array_equal(tad.OUSTER_SENSOR_T, jad.OUSTER_SENSOR_T)
    elif case == "livox":
        off = rng.integers(0, 10 ** 8, n).astype(np.uint32)
        line = rng.integers(0, 6, n).astype(np.uint8)
        tag = rng.choice(np.array([0x00, 0x10, 0x20, 0x30, 0x15], np.uint8), n)
        refl = rng.integers(0, 255, n).astype(np.uint8)
        R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
        got = tad.from_livox(xyz, off, line, tag, refl, gravity_alignment=R)
        _assert_same(got, jad.from_livox(xyz, off, line, tag, refl,
                                         gravity_alignment=R))
        keep = (line < 4) & np.isin(tag & 0x30, (0x00, 0x10))
        assert len(got.xyz) == keep.sum() and 0 < keep.sum() < n
    else:
        for lines in (16, 32, 64):
            _assert_same(tad.from_velodyne(xyz, n_scan_lines=lines),
                         jad.from_velodyne(xyz, n_scan_lines=lines))
            args = (xyz, lines, tad.COLUMN_TIME, tad.LASER_TIME)
            lib = tnative.synth_ring_time(*args)
            assert 0 < len(lib[0]) < n
            _assert_same(lib, jnative.synth_ring_time(*args))
            ref = tnative.synth_ring_time_reference(*args)
            with monkeypatch.context() as m:
                m.setattr(jnative, "_load", lambda: None)
                _assert_same(ref, jnative.synth_ring_time(*args))
        with pytest.raises(ValueError):
            tad.from_velodyne(xyz, n_scan_lines=40)


def _messages(mod, rng):
    """One message of each codec, built from ``mod``'s own types."""
    n = 53
    livox = mod.LivoxCustomMsg(
        3.5, "livox", 3_500_000_000, rng.uniform(-5, 5, (n, 3)).astype(
            np.float32), (np.arange(n) * 10_000).astype(np.uint32),
        rng.integers(0, 255, n).astype(np.uint8),
        rng.choice(np.array([0x00, 0x10, 0x20], np.uint8), n),
        (np.arange(n) % 6).astype(np.uint8))
    return {
        "sensor_msgs/msg/PointCloud2": mod.encode_pointcloud2(_cloud(
            mod, rng, OUSTER_FIELDS, OUSTER_STEP, 61, stamp=12.345678901)),
        "sensor_msgs/msg/Imu": mod.encode_imu(mod.ImuMsg(
            7.5, "imu", np.array([0.9, 0.1, -0.2, 0.3]),
            rng.normal(size=3), rng.normal(size=3))),
        "livox_ros_driver2/msg/CustomMsg": mod.encode_livox_custom(livox),
        "nav_msgs/msg/Odometry": mod.encode_odometry(mod.OdometryMsg(
            2.0, "map", "base", np.array([0.9, 0.1, 0.2, 0.3]),
            np.array([1.0, 2.0, 3.0]))),
    }


def _same_message(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "fields":
            assert [tuple(p) for p in x] == [tuple(p) for p in y]
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, f


def test_cdr_and_bags_interchange(tmp_path):
    """The four codecs write JAX's bytes and parse JAX's bytes into the
    same fields; a bag written by either package is read by the other,
    topics, timestamps and messages alike."""
    enc_t = _messages(trb, np.random.default_rng(3))
    enc_j = _messages(jrb, np.random.default_rng(3))
    for typ, data in enc_t.items():
        assert data == enc_j[typ], typ
        _same_message(trb._PARSERS[typ](data), jrb._PARSERS[typ](data))
    for writer_mod, reader_mod in ((trb, jrb), (jrb, trb)):
        path = str(tmp_path / f"bag_{writer_mod.__name__.split('.')[0]}")
        w = writer_mod.Rosbag2Writer(path)
        for k, typ in enumerate(enc_t):
            w.add_topic(f"/topic{k}", typ)
            w.write(f"/topic{k}", 10 ** 9 * (4 - k), enc_t[typ])
        w.close()
        r = reader_mod.Rosbag2Reader(path)
        assert r.topics() == {f"/topic{k}": typ
                              for k, typ in enumerate(enc_t)}
        got = list(r.messages())
        assert [(t, ty, ns) for t, ty, ns, _ in got] == [
            (f"/topic{k}", typ, 10 ** 9 * (4 - k))
            for k, typ in reversed(list(enumerate(enc_t)))]
        for _, typ, _, msg in got:
            _same_message(msg, jrb._PARSERS[typ](enc_t[typ]))
        raw = list(r.messages(["/topic0"], raw=True))
        assert raw == [("/topic0", "sensor_msgs/msg/PointCloud2", 4 * 10 ** 9,
                        enc_t["sensor_msgs/msg/PointCloud2"])]


def _write_bags(tmp_path, rng):
    """Three small bags written with the JAX package: Ouster (ouster_ros
    layout, an IMU topic and a ground-truth odometry topic), Velodyne
    without per-point time (ring and time synthesised) and Livox."""
    bags = {}
    for kind in ("ouster", "velodyne", "livox"):
        path = str(tmp_path / kind)
        w = jrb.Rosbag2Writer(path)
        if kind == "livox":
            w.add_topic("/livox/lidar", "livox_ros_driver2/msg/CustomMsg")
        else:
            w.add_topic("/points", "sensor_msgs/msg/PointCloud2")
        w.add_topic("/imu", "sensor_msgs/msg/Imu")
        w.add_topic("/gt", "nav_msgs/msg/Odometry")
        for i in range(4):
            t = 2.0 + 0.1 * i
            if kind == "livox":
                n = 300
                msg = jrb.encode_livox_custom(jrb.LivoxCustomMsg(
                    t, "livox", int(t * 1e9) if i else 0,
                    rng.uniform(-9, 9, (n, 3)).astype(np.float32),
                    np.sort(rng.integers(0, 10 ** 8, n)).astype(np.uint32),
                    rng.integers(0, 255, n).astype(np.uint8),
                    rng.choice(np.array([0x00, 0x10, 0x20], np.uint8), n),
                    (np.arange(n) % 5).astype(np.uint8)))
                w.write("/livox/lidar", int(t * 1e9), msg)
            else:
                fields = (OUSTER_FIELDS if kind == "ouster"
                          else VELODYNE_FIELDS[:4])
                step = OUSTER_STEP if kind == "ouster" else 16
                w.write("/points", int(t * 1e9), jrb.encode_pointcloud2(
                    _cloud(jrb, rng, fields, step, 500, stamp=t,
                           nonfinite=3)))
            w.write("/gt", int(t * 1e9), jrb.encode_odometry(jrb.OdometryMsg(
                t + 0.003, "map", "base", np.array([1.0, 0.0, 0.0, 0.0]),
                np.array([i, 0.5 * i, 0.0]))))
        for k in range(100):
            t = 1.9 + 0.005 * k
            w.write("/imu", int(t * 1e9), jrb.encode_imu(jrb.ImuMsg(
                t, "imu", np.array([1.0, 0, 0, 0]), rng.normal(0, 0.01, 3),
                np.array([0.0, 0.0, 9.81]) + rng.normal(0, 0.01, 3))))
        w.close()
        bags[kind] = path
    return bags


def test_load_bag_dataset_matches_jax(tmp_path):
    """``load_bag_dataset`` gives JAX's arrays on an Ouster, a Velodyne
    (synthesised rings and times) and a Livox bag, with the topics given
    or found, the sensor kind given or guessed, and ``max_scans``; the
    port's ``gt_topic`` reads the nearest ground-truth pose of each scan
    and leaves the rest as it was."""
    bags = _write_bags(tmp_path, np.random.default_rng(4))
    for kind, path in bags.items():
        for kw in ({}, dict(max_scans=2),
                   dict(sensor_kind="velodyne", n_scan_lines=32)
                   if kind != "livox" else dict(lidar_topic="/livox/lidar",
                                                imu_topic="/imu")):
            dj = jrb.load_bag_dataset(path, **kw)
            dt = trb.load_bag_dataset(path, **kw)
            assert len(dt.scans) == len(dj.scans) == kw.get("max_scans", 4)
            for a, b in zip(dt.scans, dj.scans):
                assert a.t_start == b.t_start
                _assert_same(a[1:], b[1:])
            _assert_same(dt.imu, dj.imu)
            np.testing.assert_array_equal(dt.times, dj.times)
            assert dt.gt_poses_t is None and dj.gt_poses_t is None
        with_gt = trb.load_bag_dataset(path, gt_topic="/gt")
        np.testing.assert_array_equal(
            with_gt.gt_poses_t, [[i, 0.5 * i, 0.0] for i in range(4)])
        np.testing.assert_array_equal(with_gt.gt_poses_q,
                                      np.tile([1.0, 0, 0, 0], (4, 1)))
        assert len(with_gt.scans[0].xyz_body) == len(
            trb.load_bag_dataset(path).scans[0].xyz_body)
    assert trb._guess_sensor_kind("sensor_msgs/msg/PointCloud2", _cloud(
        trb, np.random.default_rng(0), OUSTER_FIELDS, OUSTER_STEP, 1)) \
        == "ouster"
    with pytest.raises(ValueError):
        trb.load_bag_dataset(bags["ouster"], gt_topic="/imu")
    with pytest.raises(FileNotFoundError):
        trb.load_bag_dataset(str(tmp_path / "missing.db3"))


CFG_YAML = """
/**:
  ros__parameters:
    imu_topic: "/imu/data"
    laser_topic: "/points"
    sensor: "velodyne"
    calibration_file: "{calib}"
    provide_imu_laser_extrinsic: {direct}
    feature_extraction_node:
        scan_line: 32
        min_range: 0.5
        filter_point_size: 4
    laser_mapping_node:
        mapping_line_resolution: 0.2
        mapping_plane_resolution: 0.4
        max_iterations: 3
        max_surface_features: 1500
        localization_mode: true
        use_imu_roll_pitch: true
        init_x: 1.0
        init_y: 2.0
        init_z: 3.0
        init_yaw: 0.5
    imu_preintegration_node:
        lidar_correction_noise: 0.02
        acc_n: 0.004
        gyr_n: 0.002
        g_norm: 9.81
"""
CALIB_DIRECT = """%YAML:1.0

#Rotation from laser frame to imu frame, imu^R_laser
extrinsicRotation_imu_laser: !!opencv-matrix
  rows: 3
  cols: 3
  dt: d
  data: [0., -1., 0.,
         1., 0., 0.,
         0., 0., 1.]

extrinsicTranslation_imu_laser: !!opencv-matrix
  rows: 3
  cols: 1
  dt: d
  data: [0.080, 0.029, 0.030]

imu_laser_rotation_offset: !!opencv-matrix
  rows: 3
  cols: 1
  dt: d
  data: [0.0, 90.0, 0.0]

yaw_ratio: 0.25
"""
CALIB_CAMERA = """%YAML:1.0
extrinsicRotation_camera_laser: !!opencv-matrix
  rows: 3
  cols: 3
  dt: d
  data: [0., 0., 1.,
         -1., 0., 0.,
         0., -1., 0.]
extrinsicTranslation_camera_laser: !!opencv-matrix
  rows: 3
  cols: 1
  dt: d
  data: [0.1, 0.0, 0.0]
extrinsicRotation_imu_camera: !!opencv-matrix
  rows: 3
  cols: 3
  dt: d
  data: [1., 0., 0.,
         0., 0., -1.,
         0., 1., 0.]
extrinsicTranslation_imu_camera: !!opencv-matrix
  rows: 3
  cols: 1
  dt: d
  data: [0.0, 0.2, 0.0]
"""


def test_yaml_config_and_calibration_match_jax(tmp_path, monkeypatch):
    """``load_yaml_config`` and ``load_calibration`` give JAX's
    configuration field by field on the YAML texts of
    tests/test_config.py: the direct calibration with its RPY offset and
    the camera composition, each through a config file that names it;
    without PyYAML the loader names the package."""
    import dataclasses
    import sys

    for calib, direct in ((CALIB_DIRECT, "true"), (CALIB_CAMERA, "false")):
        cpath = tmp_path / f"calib_{direct}.yaml"
        cpath.write_text(calib)
        provide = direct == "true"
        (et, yt), (ej, yj) = (tcfg.load_calibration(str(cpath), provide),
                              jcfg.load_calibration(str(cpath), provide))
        assert dataclasses.asdict(et) == dataclasses.asdict(ej)
        assert yt == yj
        path = tmp_path / f"cfg_{direct}.yaml"
        path.write_text(textwrap.dedent(CFG_YAML.format(calib=cpath.name,
                                                        direct=direct)))
        got = dataclasses.asdict(tcfg.load_yaml_config(str(path)))
        assert got == dataclasses.asdict(jcfg.load_yaml_config(str(path)))
        assert got["sensor"]["n_scan_lines"] == 32
        assert got["extrinsics"]["t_imu_laser"] != (0.0, 0.0, 0.0)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        tcfg.load_yaml_config(str(path))


class _Run(types.SimpleNamespace):
    pass


def test_report_and_export_match_jax(tmp_path):
    """``full_report`` / ``write_report`` give JAX's report.json byte for
    byte from the same poses and stats (with and without ground truth);
    ``export_run`` writes JAX's trajectory and map files from the same
    run and the same map (JAX's map carried over); ``load_jsonl`` reads
    the stats that ``utils.JsonlLogger`` wrote (inside a
    ``scoped_timer``), a ``device_trace`` writes its Chrome trace;
    ``rerun_log`` is False without the rerun package."""
    rng = np.random.default_rng(5)
    n = 24
    poses_t = np.cumsum(rng.normal(0, 0.1, (n, 3)), axis=0)
    poses_q = rng.normal(size=(n, 4))
    poses_q /= np.linalg.norm(poses_q, axis=1, keepdims=True)
    stats = [{"surf_stack": int(rng.integers(100, 900)), "surf_map": 1000 + i,
              "n_iterations": int(rng.integers(1, 5)),
              "degenerate": bool(i % 5 == 0), "imu_healthy": i > 3,
              "pred_source": int(i % 3), "uncertainty": rng.random(6).tolist(),
              "time_elapsed_ms": float(rng.uniform(5, 50))}
             for i in range(n)]
    run = _Run(poses_t=poses_t, poses_q=poses_q, smoothed_t=poses_t,
               stats=stats, wall_time_s=1.5, scans_per_sec=n / 1.5)
    gt = poses_t + rng.normal(0, 0.01, (n, 3))
    for g in (None, gt):
        tbm.write_report(str(tmp_path / "t.json"), tbm.full_report(run, g))
        jbm.write_report(str(tmp_path / "j.json"), jbm.full_report(run, g))
        assert (tmp_path / "t.json").read_bytes() == \
            (tmp_path / "j.json").read_bytes()
    rep = json.loads((tmp_path / "t.json").read_text())
    assert {"ate", "rpe"} <= set(rep) and "p90" in rep["stats"][
        "time_elapsed_ms"]
    timings = []
    with utils.scoped_timer("log", sink=timings):
        with utils.JsonlLogger(str(tmp_path / "s.jsonl")) as sink:
            for rec in stats:
                sink.log(rec)
    assert tbm.load_jsonl(str(tmp_path / "s.jsonl")) == stats
    assert [t["name"] for t in timings] == ["log"] and timings[0]["ms"] >= 0
    clock = utils.TicToc()
    assert 0 <= clock.toc() < 1e4
    with utils.device_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert "traceEvents" in json.loads(
        (tmp_path / "trace" / "trace.json").read_text())

    mcfg = jcfg.MapConfig(table_size=1 << 10, cell_capacity=8)
    m = jmap.insert(jmap.empty_map(mcfg), mcfg,
                    rng.uniform(-6, 6, (700, 3)).astype(np.float32),
                    np.ones(700, bool), 0.1, max_writes=700)
    m = jax.device_get(m)
    times = np.arange(n) * 0.1
    jviz.export_run(str(tmp_path / "j"), run, _Run(surf_map=m), times)
    tviz.export_run(str(tmp_path / "t"), run, _Run(
        surf_map=convert.voxel_map_from_numpy(m, "cpu")), times)
    for name in ("trajectory_tum.txt", "map.ply"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    assert b"element vertex 0" not in (tmp_path / "t" / "map.ply").read_bytes()
    assert tviz.rerun_log(run) is False
