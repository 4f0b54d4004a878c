"""The ICP loop of the PyTorch port against the JAX package, both the
fixed-count and the early-exit branch, on a map built by the JAX package and
carried across; and with candidate refresh, also in a room where round 1
converges."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from superodom_tpu import geometry as jg  # noqa: E402
from superodom_tpu import mapstate as jm  # noqa: E402
from superodom_tpu import registration as jr  # noqa: E402
from superodom_tpu.config import MapConfig as JMapConfig  # noqa: E402
from superodom_tpu.config import RegistrationConfig as JReg  # noqa: E402
from superodom_tpu.config import RuntimeParams as JRt  # noqa: E402

from superodom_tpu_torch import convert, kernels  # noqa: E402
from superodom_tpu_torch import registration as tr  # noqa: E402
from superodom_tpu_torch.config import MapConfig, RegistrationConfig  # noqa: E402
from superodom_tpu_torch.config import RuntimeParams  # noqa: E402
from superodom_tpu_torch.geometry import Pose  # noqa: E402

from test_torch_registration import (  # noqa: E402,F401
    M_FEAT, MAP, REG, RES, T, _rot, scene)


@pytest.mark.parametrize("early_exit", [False, True])
def test_icp_register_matches_jax(scene, early_exit):
    m, p_body, mask, q0, t0 = scene
    reg_j = JReg(**REG, icp_early_exit=early_exit)
    reg_t = RegistrationConfig(**REG, icp_early_exit=early_exit)
    edge_cfg = JMapConfig(table_size=64, bucket_size=8, cell_capacity=4)
    edge_j = jax.device_get(jm.empty_map(edge_cfg))
    edge_pts = np.zeros((64, 3), np.float32)
    edge_mask = np.zeros((64,), bool)
    rt_j = JRt(np.float32(0.1), np.float32(RES))
    prior_j = jr.PosePrior(pose=jg.Pose(q0, t0),
                           information=np.full((6,), 50.0, np.float32),
                           enabled=np.asarray(False))
    icp = jax.jit(lambda sm, p, hold: jr.icp_register(
        edge_j, sm, JMapConfig(**MAP), reg_j, p, edge_pts, edge_mask,
        p_body, mask, rt_j, prior_j, use_edges=False, hold_enabled=hold))
    pose_j, st_j = jax.device_get(icp(m, jg.Pose(q0, t0),
                                      np.asarray(True)))

    pose_t, st_t = tr.icp_register(
        convert.from_numpy(edge_j), convert.voxel_map_from_numpy(m),
        MapConfig(**MAP), reg_t, Pose(T(q0), T(t0)), T(edge_pts),
        T(edge_mask), T(p_body), T(mask),
        RuntimeParams(torch.tensor(0.1), torch.tensor(RES)),
        convert.from_numpy(prior_j), hold_enabled=torch.tensor(True))
    np.testing.assert_allclose(pose_t.q.numpy(), pose_j.q, atol=1e-4)
    np.testing.assert_allclose(pose_t.t.numpy(), pose_j.t, atol=1e-4)
    assert int(st_t.n_iterations) == int(st_j.n_iterations)
    assert bool(st_t.degenerate) == bool(st_j.degenerate)
    # codes may differ only on lanes at a gate threshold
    np.testing.assert_allclose(st_t.plane_rejection_hist.numpy(),
                               st_j.plane_rejection_hist, atol=3)
    np.testing.assert_allclose(st_t.iter_surf_num.numpy(),
                               st_j.iter_surf_num, atol=3)
    np.testing.assert_array_equal(st_t.line_rejection_hist.numpy(),
                                  st_j.line_rejection_hist)
    np.testing.assert_allclose(st_t.iter_trans_norm.numpy(),
                               st_j.iter_trans_norm, atol=1e-4)
    np.testing.assert_allclose(st_t.uncertainty.numpy(), st_j.uncertainty,
                               atol=1e-2)


REFRESH = dict(max_icp_iters=5, max_gn_iters=4, tukey_anneal=0.25,
               refresh_width=16)


@pytest.fixture(scope="module")
def room_scene():
    """A box room (six walls, 5 mm noise) in a map inserted by the JAX
    package, and features that are wall points seen from a known pose, where
    ICP settles: restarted from its own answer, round 1 converges."""
    rng = np.random.default_rng(9)
    half = 5.0
    walls = []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            pts = rng.uniform(-half, half, (1400, 3)).astype(np.float32)
            pts[:, axis] = np.float32(sign * half)
            walls.append(pts)
    world = np.concatenate(walls)
    world += rng.normal(scale=0.005, size=world.shape).astype(np.float32)
    rng.shuffle(world)
    cfg = JMapConfig(**MAP)
    ins = jax.jit(lambda m, x, k: jm.insert(m, cfg, x, k, jnp.float32(RES)))
    m = jm.empty_map(cfg)
    for chunk in np.array_split(world, 4):
        m = ins(m, chunk, np.ones(len(chunk), bool))
    q_true = np.asarray(jg.so3_exp(np.array([0.02, -0.03, 0.08], np.float32)))
    t_true = np.array([0.3, -0.2, 0.1], np.float32)
    p_body = ((world[:M_FEAT] - t_true) @ _rot(q_true)).astype(np.float32)
    mask = np.arange(M_FEAT) % 11 != 0
    t0 = (t_true + np.float32([1e-4, -1e-4, 5e-5])).astype(np.float32)
    return jax.device_get(m), p_body, mask, q_true, t0


@pytest.fixture(scope="module")
def refresh_icp():
    """Both packages' ICP with candidate refresh on a scene (map, features,
    start pose); the JAX side compiled once per early-exit setting."""
    edge_cfg = JMapConfig(table_size=64, bucket_size=8, cell_capacity=4)
    edge_j = jax.device_get(jm.empty_map(edge_cfg))
    edge_pts = np.zeros((64, 3), np.float32)
    edge_mask = np.zeros((64,), bool)
    rt_j = JRt(np.float32(0.1), np.float32(RES))
    compiled = {}

    def run(early_exit, scene):
        m, p_body, mask, q, t = scene
        if early_exit not in compiled:
            reg_j = JReg(**REFRESH, icp_early_exit=early_exit)
            compiled[early_exit] = jax.jit(
                lambda sm, p, pts, msk, hold: jr.icp_register(
                    edge_j, sm, JMapConfig(**MAP), reg_j, p, edge_pts,
                    edge_mask, pts, msk, rt_j, None, use_edges=False,
                    hold_enabled=hold))
        pose_j, st_j = jax.device_get(compiled[early_exit](
            m, jg.Pose(q, t), p_body, mask, np.asarray(True)))
        before = dict(kernels.launch_counts)
        pose_t, st_t = tr.icp_register(
            convert.from_numpy(edge_j), convert.voxel_map_from_numpy(m),
            MapConfig(**MAP),
            RegistrationConfig(**REFRESH, icp_early_exit=early_exit),
            Pose(T(q), T(t)), T(edge_pts), T(edge_mask), T(p_body), T(mask),
            RuntimeParams(torch.tensor(0.1), torch.tensor(RES)), None,
            hold_enabled=torch.tensor(True))
        assert kernels.launch_counts == before  # the CPU launches no kernel
        return (pose_j, st_j), (pose_t, st_t)

    return run


@pytest.mark.parametrize("case", ["fixed_count", "early_exit",
                                  "converges_in_round_1"])
def test_icp_register_refresh_matches_jax(scene, room_scene, refresh_icp,
                                          case):
    """Candidate refresh (refresh_width 16, 5 rounds): round 1 at full
    width, the reduction at the round-1 pose, rounds 2.. from the reduced
    set; without early exit (every round runs, a finished solve frozen),
    with it, and in a room from the pose ICP settled at, so that round 1
    converges and the reduction is skipped.  Pose within 1e-5; the round count and the
    per-round correspondence counts equal."""
    one_round = case == "converges_in_round_1"
    if one_round:
        (settled, _), _ = refresh_icp(True, room_scene)
        scene = (*room_scene[:3], np.asarray(settled.q), np.asarray(settled.t))
    (pose_j, st_j), (pose_t, st_t) = refresh_icp(case != "fixed_count", scene)
    np.testing.assert_allclose(pose_t.q.numpy(), pose_j.q, atol=1e-5)
    np.testing.assert_allclose(pose_t.t.numpy(), pose_j.t, atol=1e-5)
    n_it = int(st_j.n_iterations)
    assert int(st_t.n_iterations) == n_it
    assert n_it == 1 if one_round else n_it >= 2  # the refresh rounds ran
    np.testing.assert_array_equal(st_t.iter_surf_num.numpy(),
                                  st_j.iter_surf_num)
    assert (st_j.iter_surf_num[:n_it] > 300).all()
    assert not st_j.iter_surf_num[n_it:].any()
    np.testing.assert_array_equal(st_t.iter_edge_num.numpy(),
                                  st_j.iter_edge_num)
    np.testing.assert_allclose(st_t.iter_trans_norm.numpy(),
                               st_j.iter_trans_norm, atol=1e-5)
    np.testing.assert_allclose(st_t.iter_rot_norm.numpy(),
                               st_j.iter_rot_norm, atol=1e-5)
    np.testing.assert_array_equal(st_t.plane_rejection_hist.numpy(),
                                  st_j.plane_rejection_hist)
    assert bool(st_t.degenerate) == bool(st_j.degenerate)
