"""Host-side pieces of the PyTorch port against the JAX package: the
configuration tree and the CLI's configurations, the synthetic dataset,
the native IMU buffer, the state converters, and the import isolation of
the port (exact).  The CLI's replays are in test_torch_cli.py."""

import ast
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu import native as jnative  # noqa: E402
from superodom_tpu.io import datasets as jds  # noqa: E402
from superodom_tpu.pipeline import init_state as j_init_state  # noqa: E402

from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch import convert, native as tnative  # noqa: E402
from superodom_tpu_torch.io import datasets as tds  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _asdict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", ["VLP_16", "OS1_128", "LIVOX_MID360"])
def test_sensor_presets_equal(name):
    assert _asdict(getattr(tcfg, name)) == _asdict(getattr(jcfg, name))


@pytest.mark.parametrize("cls", ["MapConfig", "RegistrationConfig",
                                 "ImuConfig", "Extrinsics",
                                 "LocalizationConfig", "PipelineConfig"])
def test_config_defaults_equal(cls):
    assert _asdict(getattr(tcfg, cls)()) == _asdict(getattr(jcfg, cls)())


@pytest.mark.parametrize("name", ["os1", "vlp16", "livox"])
def test_ship_config_equals_bench(name):
    sys.path.insert(0, ROOT)
    from bench import _config

    assert _asdict(tcfg.ship_config(name)) == _asdict(_config(name))


@pytest.mark.parametrize("name", ["os1", "vlp16", "livox"])
def test_parity_config_equals_bench(name):
    """The reference-envelope configuration, field by field."""
    sys.path.insert(0, ROOT)
    from bench import _config

    got, want = _asdict(tcfg.parity_config(name)), _asdict(
        _config(name, parity=True))
    assert got == want
    assert got["registration"]["refresh_width"] == 16
    assert got["registration"]["max_icp_iters"] == 5
    assert got != _asdict(tcfg.ship_config(name))


@pytest.mark.parametrize("profile,short", zip(tcfg.PROFILES,
                                              ["os1", "vlp16", "livox"]))
@pytest.mark.parametrize("parity", [False, True])
def test_config_for_profile(profile, short, parity):
    """What ``--profile`` / ``--parity`` select is the benchmark's
    configuration of that sensor, under either of its names."""
    want = (tcfg.parity_config if parity else tcfg.ship_config)(short)
    assert _asdict(tcfg.config_for(profile, parity)) == _asdict(want)
    assert tcfg.profile_by_name(profile) is tcfg.profile_by_name(short)


@pytest.mark.parametrize("profile", tcfg.PROFILES)
@pytest.mark.parametrize("flag", [None, "--parity", "--ship"])
def test_cli_configuration(profile, flag):
    """The port's CLI builds what the JAX CLI builds for ``--profile``
    alone (``PipelineConfig(sensor=profile_by_name(p))``), field by field;
    ``--parity`` and ``--ship`` give the benchmark's configurations."""
    from superodom_tpu_torch import cli

    argv = ["--profile", profile, "--synthetic", "1"] + ([flag] if flag
                                                         else [])
    got = _asdict(cli.config_from_args(cli.parse_args(argv)))
    if flag is None:
        want = jcfg.PipelineConfig(sensor=jcfg.profile_by_name(profile))
        assert got["auto_voxel_size"]
    else:
        want = {"--parity": tcfg.parity_config,
                "--ship": tcfg.ship_config}[flag](profile)
    assert got == _asdict(want)


def test_cli_localize_configuration(tmp_path):
    """``--localize`` puts the JAX CLI's localization on whatever
    configuration the other flags chose: a frozen map from the
    ``--init-pose`` (or the first line of ``--init-pose-file``), zeros
    without either."""
    from superodom_tpu.io.pcd import write_pose_file as j_write_pose_file

    from superodom_tpu_torch import cli

    pose_file = str(tmp_path / "start_pose.txt")
    j_write_pose_file(pose_file, [(1.5, -2.0, 0.25, 0.01, -0.02, 0.3),
                                  (9.0, 9.0, 9.0, 0.0, 0.0, 0.0)])
    for flags, init in (
            ([], (0.0,) * 6),
            (["--init-pose", "1", "2", "3", "0.1", "0.2", "0.3"],
             (1.0, 2.0, 3.0, 0.1, 0.2, 0.3)),
            (["--init-pose-file", pose_file, "--ship"],
             (1.5, -2.0, 0.25, 0.01, -0.02, 0.3))):
        argv = ["--profile", "os1_128", "--synthetic", "1", "--localize",
                "m.pcd"] + flags
        args = cli.parse_args(argv)
        got = _asdict(cli.config_from_args(args))
        base = (tcfg.ship_config("os1_128") if args.ship
                else jcfg.PipelineConfig(sensor=jcfg.OS1_128))
        want = dataclasses.replace(base, localization=jcfg.LocalizationConfig(
            enabled=True, update_map=False, init_pose_xyz=init[:3],
            init_pose_rpy=init[3:]))
        assert got == _asdict(want), flags
        assert got["localization"]["update_map"] is False


def test_profile_by_name_and_runtime():
    for n in ("velodyne", "vlp_16", "ouster", "os1_128", "livox",
              "livox_mid360"):
        assert _asdict(tcfg.profile_by_name(n)) == _asdict(
            jcfg.profile_by_name(n))
    rt_t = tcfg.ship_config("os1").default_runtime()
    rt_j = jcfg.PipelineConfig(sensor=jcfg.OS1_128).default_runtime()
    assert rt_t == rt_j


def test_make_dataset_identical():
    kw = dict(n_scans=4, points_per_scan=700, radius=2.0, laps=0.3,
              world=None, static_scans=1)
    dj = jds.make_dataset(np.random.default_rng(3), **kw)
    dt = tds.make_dataset(np.random.default_rng(3), **kw)
    for a, b in zip(dj.scans, dt.scans):
        assert a.t_start == b.t_start
        np.testing.assert_array_equal(a.xyz_body, b.xyz_body)
        np.testing.assert_array_equal(a.t_rel, b.t_rel)
    for f in ("t", "acc", "gyr"):
        np.testing.assert_array_equal(getattr(dj.imu, f), getattr(dt.imu, f))
    np.testing.assert_array_equal(dj.gt_poses_q, dt.gt_poses_q)
    np.testing.assert_array_equal(dj.gt_poses_t, dt.gt_poses_t)
    assert tds.ate_rmse(dt.gt_poses_t, dt.gt_poses_t * 1.01) == \
        jds.ate_rmse(dj.gt_poses_t, dj.gt_poses_t * 1.01)


@pytest.mark.parametrize("conditioned", [False, True])
def test_imu_buffer_matches_native(conditioned):
    ds = jds.make_dataset(np.random.default_rng(1), n_scans=30,
                          points_per_scan=10, radius=2.0, static_scans=12)
    R = t = None
    if conditioned:
        c, s = np.cos(0.3), np.sin(0.3)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        t = np.array([0.1, -0.05, 0.2])
    bj = jnative.ImuBuffer(capacity=4096, R_imu_laser=R, t_imu_laser=t)
    bt = tnative.ImuBuffer(capacity=4096, R_imu_laser=R, t_imu_laser=t)
    inits = []
    for i in range(len(ds.imu.t)):
        for b in (bj, bt):
            b.add(ds.imu.t[i], ds.imu.acc[i], ds.imu.gyr[i])
        if i == 220:
            inits = [bj.static_init(1.0), bt.static_init(1.0)]
    for a, b in zip(*inits):
        np.testing.assert_array_equal(a, b)
    assert len(bj) == len(bt)
    for t0 in (0.5, 1.3, 2.05, 2.9):
        assert bj.sync(t0, t0 + 0.1) == bt.sync(t0, t0 + 0.1)
        for a, b in zip(bj.window(t0, t0 + 0.1, 48),
                        bt.window(t0, t0 + 0.1, 48)):
            np.testing.assert_array_equal(a, b)


def test_native_loader_is_the_port_own_copy():
    """The port builds its own copy of the native loader, byte for byte the
    JAX package's, and its build names no path of the JAX package."""
    with open(os.path.join(ROOT, "superodom_tpu", "native", "loader.cpp"),
              "rb") as f:
        original = f.read()
    with open(tnative._SRC, "rb") as f:
        assert f.read() == original
    assert tnative._SRC.startswith(
        os.path.join(ROOT, "superodom_tpu_torch") + os.sep)
    with open(tnative.__file__) as f:
        assert "superodom_tpu/" not in f.read()


def _jax_package_paths(path):
    """String constants of a Python file that name a path of the JAX
    package (``file:line`` references to its code are not paths read)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            s = node.value
            if s in ("superodom_tpu", "../superodom_tpu") or re.fullmatch(
                    r"(\.\./)?superodom_tpu/[^\s:]*", s):
                bad.append(s)
    return bad


def test_port_reads_no_file_of_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "superodom_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    bad = {f: b for f in files if (b := _jax_package_paths(f))}
    assert not bad, bad


def test_port_imports_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import superodom_tpu_torch.runner, superodom_tpu_torch.cli, "
        "superodom_tpu_torch.convert, superodom_tpu_torch.kernels, "
        "superodom_tpu_torch.profile, superodom_tpu_torch.checkpoint, "
        "superodom_tpu_torch.io.scenarios, superodom_tpu_torch.io.pcd, "
        "superodom_tpu_torch.io.rosbag, superodom_tpu_torch.io.adapters, "
        "superodom_tpu_torch.tools.benchmark, "
        "superodom_tpu_torch.tools.visualize, superodom_tpu_torch.utils, "
        "superodom_tpu_torch.tools.profile, "
        "superodom_tpu_torch.tools.stress_matrix, "
        "superodom_tpu_torch.tools.kernel_ab, "
        "chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'superodom_tpu' or m.startswith('superodom_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd="/", timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _leaves(tree, prefix=""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{prefix}.{f}")
    else:
        yield prefix, np.asarray(tree)


def test_convert_round_trip():
    cfg = jcfg.PipelineConfig(
        sensor=dataclasses.replace(jcfg.VLP_16, max_points=2048),
        map=jcfg.MapConfig(table_size=1 << 12, cell_capacity=8),
        imu=jcfg.ImuConfig(max_imu_per_scan=16))
    state_j = jax.device_get(j_init_state(cfg))
    state_t = convert.odom_state_from_numpy(state_j, "cpu")
    assert type(state_t).__name__ == "OdomState"
    assert isinstance(state_t.surf_map.pts, torch.Tensor)
    back = convert.odom_state_to_numpy(state_t)
    pairs = list(zip(_leaves(state_j), _leaves(back)))
    assert len(pairs) == len(list(_leaves(state_j)))
    for (na, a), (nb, b) in pairs:
        assert na == nb
        assert a.dtype == b.dtype and a.shape == b.shape, na
        np.testing.assert_array_equal(a, b, err_msg=na)
    with pytest.raises(TypeError):
        convert.odom_state_from_numpy(state_j.surf_map)
