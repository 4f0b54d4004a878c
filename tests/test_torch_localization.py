"""The port's localization mode and checkpoint against the JAX package:
the npz checkpoint in both directions, leaf for leaf; the port's own
resume, bit for bit; the prior-map insert with ``total_points`` and
``extract_points``; the PCD and pose-file copies and the prior-map files;
``native.voxel_downsample`` (the library and its numpy branch); one
localization step against a frozen prior map.  The configuration is
tests/test_torch_pipeline.py's tiny ship path.  JAX compiles one program
here: the localization step."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from superodom_tpu import checkpoint as jck  # noqa: E402
from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu import mapstate as jmap  # noqa: E402
from superodom_tpu import native as jnative  # noqa: E402
from superodom_tpu.io import pcd as jpcd  # noqa: E402
from superodom_tpu.io import scenarios as jsc  # noqa: E402
from superodom_tpu.pipeline import init_state as j_init_state  # noqa: E402
from superodom_tpu.runner import OdometryRunner as JRunner  # noqa: E402

from superodom_tpu_torch import checkpoint as tck  # noqa: E402
from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch import convert, mapstate as tmap  # noqa: E402
from superodom_tpu_torch import native as tnative  # noqa: E402
from superodom_tpu_torch import pipeline as tp  # noqa: E402
from superodom_tpu_torch.io import datasets as tds  # noqa: E402
from superodom_tpu_torch.io import pcd as tpcd  # noqa: E402
from superodom_tpu_torch.runner import OdometryRunner  # noqa: E402

from test_torch_pipeline import _tiny  # noqa: E402

N_ROOM = 12  # the localization room scaled to 12 scans
STEP_AT = 11  # the IMU covers the sweep from scan 10


def _cfg(mod, **kw):
    return dataclasses.replace(_tiny(mod, early_exit=False), **kw)


def _loc(mod):
    """The room case's localization: frozen map, 0.3 m / 0.05 rad init
    offset."""
    return _cfg(mod, localization=mod.LocalizationConfig(
        enabled=True, update_map=False, init_pose_xyz=(0.0, 0.3, 0.0),
        init_pose_rpy=(0.0, 0.0, 0.05)))


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _assert_same_leaves(a, b, at_least=40):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > at_least
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _room():
    case = next(c for c in jsc.stress_battery(points_per_scan=4096,
                                              scale=(N_ROOM + 0.5) / 50)
                if c.name == "localization_room")
    ds = case.build(np.random.default_rng(7))
    assert len(ds.scans) == N_ROOM
    return case, ds


def _prior_points():
    """The room's prior map (its walls and pillars sampled at 0.2 m) and
    20,000 of its points again, shifted 5 cm, so the insert runs two
    batches."""
    case, _ = _room()
    xyz = case.prior_points(np.random.default_rng(8)).astype(np.float32)
    return np.concatenate([xyz, xyz[:20000] + np.float32(0.05)])


@pytest.fixture(scope="module")
def primed():
    """Both packages' states with the same prior points inserted."""
    xyz = _prior_points()
    assert len(xyz) > tck.PRIOR_BATCH
    sj = jax.device_get(jck.insert_prior_points(
        _loc(jcfg), j_init_state(_loc(jcfg)), xyz))
    st = tck.insert_prior_points(_loc(tcfg), tp.init_state(_loc(tcfg)), xyz)
    return sj, st


def _replay_data(seed, n):
    return tds.make_dataset(np.random.default_rng(seed), n_scans=n,
                            points_per_scan=3000, radius=2.0, laps=0.3,
                            world=tds.BoxWorld(half_extent=np.array(
                                [8.0, 6.0, 3.0])), static_scans=1)


def _warm_port_state(n=4):
    ds = _replay_data(3, n)
    r = OdometryRunner(_cfg(tcfg), device="cpu")
    for s in ds.scans:
        r.process_scan(s.t_start, s.xyz_body, s.t_rel)
    return r.state


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_loads_in_the_other_package(direction, primed, tmp_path):
    """An npz written by either package loads in the other, leaf for leaf
    (values, dtypes, shapes): JAX's primed localization state into the
    port, and the port's state after four scans into JAX."""
    path = str(tmp_path / "state")  # both add ".npz"
    if direction == "jax_to_port":
        state = primed[0]
        jck.save_state(path, state)
        back = convert.to_numpy(tck.load_state(path, _loc(tcfg), "cpu"))
        assert isinstance(tck.load_state(path, _loc(tcfg), "cpu").pose.t,
                          torch.Tensor)
    else:
        state = convert.to_numpy(_warm_port_state())
        tck.save_state(path, convert.odom_state_from_numpy(state))
        back = jax.device_get(jck.load_state(path, _cfg(jcfg)))
    assert int(state.frame_count) == (0 if direction == "jax_to_port" else 4)
    _assert_same_leaves(back, state)
    with np.load(path + ".npz") as data:
        assert "superodom_state_meta" in data.files


def test_port_resume_is_bit_identical(tmp_path):
    """The port's own checkpoint: save after five scans, load into a fresh
    runner, then three more scans in both give identical outputs; a state
    of another map geometry, or of fewer leaves, is refused."""
    ds = _replay_data(0, 8)
    cfg = _cfg(tcfg)
    a = OdometryRunner(cfg, device="cpu")
    for s in ds.scans[:5]:
        a.process_scan(s.t_start, s.xyz_body, s.t_rel)
    path = str(tmp_path / "state.npz")
    tck.save_state(path, a.state)
    b = OdometryRunner(cfg, device="cpu")
    b.state = tck.load_state(path, cfg, "cpu")
    for s in ds.scans[5:]:
        out_a = convert.to_numpy(a.process_scan(s.t_start, s.xyz_body,
                                                s.t_rel))
        out_b = convert.to_numpy(b.process_scan(s.t_start, s.xyz_body,
                                                s.t_rel))
        _assert_same_leaves(out_a, out_b, at_least=30)
    assert np.abs(out_a.pose.t).max() > 0.05
    _assert_same_leaves(convert.to_numpy(a.state), convert.to_numpy(b.state))
    other = dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, table_size=1 << 12))
    with pytest.raises(ValueError, match="shape"):
        tck.load_state(path, other, "cpu")
    np.savez(str(tmp_path / "short.npz"), leaf_0000=np.zeros(1),
             superodom_state_meta=np.frombuffer(b'{"n_leaves": 1}',
                                                np.uint8))
    with pytest.raises(ValueError, match="leaves"):
        tck.load_state(str(tmp_path / "short.npz"), cfg, "cpu")


def test_prior_insert_and_map_helpers_match_jax(primed):
    """``insert_prior_points`` over two batches: keys, counts and points
    identical to JAX's; ``total_points`` and ``extract_points`` of the
    result identical too."""
    sj, st = primed
    for f in ("keys", "cnt", "pts"):
        np.testing.assert_array_equal(getattr(st.surf_map, f).numpy(),
                                      getattr(sj.surf_map, f), err_msg=f)
    total = tmap.total_points(st.surf_map)
    assert int(total) == int(jmap.total_points(sj.surf_map)) > 40000
    pj, vj = (np.asarray(a) for a in jmap.extract_points(sj.surf_map))
    pt, vt = (a.numpy() for a in tmap.extract_points(st.surf_map))
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(pt, pj)
    assert int(vt.sum()) == int(total)


def test_pcd_and_pose_files_match_jax(primed, tmp_path):
    """The PCD writer (binary and ascii) gives JAX's bytes and either
    reader reads either file alike; the pose-file pair likewise; the prior
    map saved from both states is one file, and loading it (with host
    thinning) gives both packages the same map."""
    rng = np.random.default_rng(4)
    xyz = rng.normal(0, 20, (777, 3)).astype(np.float32)
    for binary in (True, False):
        pj, pt = tmp_path / f"j{binary}.pcd", tmp_path / f"t{binary}.pcd"
        jpcd.write_pcd(str(pj), xyz, binary=binary)
        tpcd.write_pcd(str(pt), xyz, binary=binary)
        assert pj.read_bytes() == pt.read_bytes()
        np.testing.assert_array_equal(tpcd.read_pcd(str(pj)),
                                      jpcd.read_pcd(str(pt)))
    recs = [(1.0, 2.0, 3.0, 0.1, -0.2, 0.3), (4.5, -1.25, 0.0, 0.0, 0.0, 1.5)]
    tpcd.write_pose_file(str(tmp_path / "t.txt"), recs)
    jpcd.write_pose_file(str(tmp_path / "j.txt"), recs)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert tpcd.read_pose_file(str(tmp_path / "j.txt")) == \
        [tuple(r) for r in jpcd.read_pose_file(str(tmp_path / "t.txt"))]
    sj, st = primed
    jck.save_prior_map(str(tmp_path / "mj.pcd"), sj)
    tck.save_prior_map(str(tmp_path / "mt.pcd"), st)
    assert (tmp_path / "mj.pcd").read_bytes() == \
        (tmp_path / "mt.pcd").read_bytes()
    lj = jax.device_get(jck.load_prior_map(
        str(tmp_path / "mt.pcd"), _cfg(jcfg), j_init_state(_cfg(jcfg)),
        thin_res=0.3))
    lt = tck.load_prior_map(str(tmp_path / "mj.pcd"), _cfg(tcfg),
                            tp.init_state(_cfg(tcfg)), thin_res=0.3)
    for f in ("keys", "cnt", "pts"):
        np.testing.assert_array_equal(getattr(lt.surf_map, f).numpy(),
                                      getattr(lj.surf_map, f), err_msg=f)
    assert 0 < int(tmap.total_points(lt.surf_map)) < int(
        tmap.total_points(st.surf_map))


@pytest.mark.parametrize("library", [True, False],
                         ids=["native", "numpy_branch"])
def test_voxel_downsample_matches_jax(library, monkeypatch):
    """``native.voxel_downsample``: with the library, and with its numpy
    branch (the library absent in both packages), JAX's centroids."""
    if not library:
        monkeypatch.setattr(jnative, "_load", lambda: None)

        def refuse():
            raise OSError("no native library")

        monkeypatch.setattr(tnative, "load", refuse)
    xyz = np.random.default_rng(6).uniform(-5, 5, (20000, 3)).astype(
        np.float32)
    got = tnative.voxel_downsample(xyz, 0.5)
    want = jnative.voxel_downsample(xyz, 0.5)
    assert got.dtype == np.float32 and 500 < len(got) < len(xyz)
    np.testing.assert_array_equal(got, want)


def test_localization_step_matches_jax():
    """One step of the room against its frozen prior map from the state
    JAX carries (init pose offset 0.3 m / 0.05 rad): ICP pose within 1e-4
    m, quaternion within 1e-5, source and ``degenerate`` exact; the map of
    the next state is the prior map, unchanged, in both."""
    case, ds = _room()
    jr = JRunner(_loc(jcfg))
    jsc.prime_prior_map(jr, case, np.random.default_rng(8))
    tr = OdometryRunner(_loc(tcfg), device="cpu")
    tr.state = tck.insert_prior_points(
        tr.cfg, tr.state, case.prior_points(np.random.default_rng(8)))
    prior = jax.device_get(jr.state.surf_map)
    imu_i = 0
    for i, s in enumerate(ds.scans[:STEP_AT + 1]):
        t_end = s.t_start + float(s.t_rel[-1])
        while imu_i < len(ds.imu.t) and ds.imu.t[imu_i] <= t_end + 0.02:
            for r in (jr, tr):
                r.add_imu(ds.imu.t[imu_i], ds.imu.acc[imu_i],
                          ds.imu.gyr[imu_i])
            imu_i += 1
        if i < STEP_AT:
            jr.process_scan(s.t_start, s.xyz_body, s.t_rel)
    before = jax.device_get(jr.state)
    win, ok = jr._imu_window(s.t_start, t_end)
    scan = jr.make_scan(s.t_start, s.xyz_body, s.t_rel)
    after_j, out_j = jax.device_get(jr.step_fn(before, scan, win,
                                               np.asarray(ok)))
    inputs = tr._host_inputs(s.t_start, s.xyz_body, s.t_rel)
    for a, b in zip(_leaves(inputs), _leaves((scan, win, np.asarray(ok)))):
        np.testing.assert_array_equal(a, b)
    assert bool(ok) and np.abs(before.pose.t - ds.gt_poses_t[STEP_AT - 1]
                               ).max() < 0.1
    after_t, out_t = tp.step(tr.step_cfg,
                             convert.odom_state_from_numpy(before),
                             *tr._to_device(inputs))
    out_t, after_t = convert.to_numpy((out_t, after_t))
    np.testing.assert_allclose(out_t.pose.t, out_j.pose.t, rtol=0, atol=1e-4)
    np.testing.assert_allclose(out_t.pose.q, out_j.pose.q, rtol=0, atol=1e-5)
    assert out_t.prediction_source == out_j.prediction_source
    assert bool(after_t.degenerate) == bool(after_j.degenerate)
    assert out_t.surf_map_num == out_j.surf_map_num > 0
    for f in ("keys", "cnt", "pts"):
        np.testing.assert_array_equal(getattr(after_t.surf_map, f),
                                      getattr(prior, f), err_msg=f)
        np.testing.assert_array_equal(getattr(after_j.surf_map, f),
                                      getattr(prior, f), err_msg=f)
