"""Plane registration of the PyTorch port against the JAX package: the
plain versions of the plane_fit (K3) and Gauss-Newton (K4: the solve and
its normal system) kernels, with and without axis hold, pose prior and
Tukey annealing, and the ICP loop (both the fixed-count and the early-exit
branch) on a map built by the JAX package and carried across."""

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
from superodom_tpu.io.datasets import BoxWorld, make_dataset  # noqa: E402

from superodom_tpu_torch import convert, kernels  # noqa: E402
from superodom_tpu_torch import registration as tr  # noqa: E402
from superodom_tpu_torch.config import MapConfig, RegistrationConfig  # noqa: E402
from superodom_tpu_torch.config import RuntimeParams  # noqa: E402
from superodom_tpu_torch.geometry import Pose  # noqa: E402

MAP = dict(cell_size=1.0, table_size=1 << 13, cell_capacity=24,
           evict_radius=200.0)
REG = dict(max_icp_iters=2, max_gn_iters=4, tukey_anneal=0.25)
RES = 0.2
M_FEAT = 768


def T(a):
    return torch.from_numpy(np.array(a))


def _rot(q):
    return np.asarray(jg.quat_to_matrix(q), np.float64)


@pytest.fixture(scope="module")
def scene():
    """A map of six real scans (inserted by the JAX package at the true
    poses) and the features of a seventh scan at a perturbed pose."""
    ds = make_dataset(np.random.default_rng(5), n_scans=8,
                      points_per_scan=3000, radius=2.0, laps=0.2,
                      world=BoxWorld(half_extent=np.array([8.0, 6.0, 3.0])),
                      static_scans=1)
    cfg = JMapConfig(**MAP)
    ins = jax.jit(lambda m, x, k: jm.insert(m, cfg, x, k, jnp.float32(RES)))
    m = jm.empty_map(cfg)
    for i in range(6):
        s = ds.scans[i]
        pts = (s.xyz_body[:2048] @ _rot(ds.gt_poses_q[i]).T
               + ds.gt_poses_t[i]).astype(np.float32)
        m = ins(m, pts, np.arange(2048) < len(s.xyz_body))
    s = ds.scans[6]
    p_body = s.xyz_body[:M_FEAT].astype(np.float32)
    mask = np.arange(M_FEAT) % 11 != 0
    dq = np.asarray(jg.so3_exp(np.array([0.004, -0.003, 0.012],
                                        np.float32)))
    q0 = np.asarray(jg.quat_mul(dq, ds.gt_poses_q[6]), np.float32)
    t0 = (ds.gt_poses_t[6] + np.array([0.04, -0.03, 0.01])).astype(np.float32)
    return jax.device_get(m), p_body, mask, q0, t0


def _planes_j(scene, k=JReg().plane_knn):
    m, p_body, mask, q0, t0 = scene
    reg = JReg(**REG, plane_knn=k)
    pose = jg.Pose(q0, t0)
    w_pt = np.asarray(pose.apply(p_body))
    cand, cvalid = jm.gather_candidates(m, JMapConfig(**MAP), w_pt)
    neigh, sq, nvalid = (np.asarray(a) for a in
                         jm.select_knn(cand, cvalid, w_pt, reg.plane_knn))
    planes = jax.device_get(jr._plane_fit(neigh, sq, nvalid, reg, pose,
                                          p_body, mask, RES, w_pt))
    return planes, (neigh, sq, nvalid, w_pt)


def test_plane_fit_reference_matches_jax(scene):
    _, p_body, mask, q0, t0 = scene
    pj, (neigh, sq, nvalid, w_pt) = _planes_j(scene)
    normal, d, coeff, valid, code, bins = tr.plane_fit(
        T(neigh), T(sq), T(nvalid), T(mask), T(w_pt), T(q0),
        torch.tensor(RES))
    far = ~tr.gate_margin_lanes(
        T(neigh), T(sq), T(nvalid), T(w_pt), T(q0), T(pj.normal), T(pj.d),
        torch.tensor(RES)).numpy()
    assert far.mean() > 0.9 and pj.valid.sum() > 300
    np.testing.assert_array_equal(valid.numpy()[far], pj.valid[far])
    np.testing.assert_array_equal(code.numpy()[far], pj.code[far])
    np.testing.assert_array_equal(bins.numpy()[far], pj.obs_bins[far])
    # a rejected neighbourhood's normal carries no weight, and on
    # line-like ones (lambda0 ~ lambda1) it is ill-conditioned: compare the
    # accepted planes' normal and offset
    used = far & pj.valid
    np.testing.assert_allclose(normal.numpy()[used], pj.normal[used],
                               atol=1e-5)
    np.testing.assert_allclose(d.numpy()[used], pj.d[used], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(coeff.numpy()[far], pj.coeff[far], atol=1e-5)


@pytest.mark.parametrize("k", [3, 10, 16])
def test_plane_fit_reference_matches_jax_other_k(scene, k):
    """The plain K3 at the neighbour counts beside the presets' 5 that the
    kernel serves (10: its other instance with k known when compiled; 3 and
    16: the generic one), with the tolerances of the test above, lanes at a
    gate margin excluded.  Three points span a plane exactly, so at k = 3
    the PCA gate refuses every lane (most of them within the margin of
    that gate) and only the decisions are compared."""
    _, p_body, mask, q0, t0 = scene
    pj, (neigh, sq, nvalid, w_pt) = _planes_j(scene, k)
    assert neigh.shape == (M_FEAT, k, 3)
    normal, d, coeff, valid, code, bins = tr.plane_fit(
        T(neigh), T(sq), T(nvalid), T(mask), T(w_pt), T(q0),
        torch.tensor(RES))
    far = ~tr.gate_margin_lanes(
        T(neigh), T(sq), T(nvalid), T(w_pt), T(q0), T(pj.normal), T(pj.d),
        torch.tensor(RES)).numpy()
    assert far.mean() > (0.9 if k > 3 else 0.3)
    assert (pj.valid.sum() > 100) == (k > 3) and (~pj.valid).sum() > 100
    np.testing.assert_array_equal(valid.numpy()[far], pj.valid[far])
    np.testing.assert_array_equal(code.numpy()[far], pj.code[far])
    np.testing.assert_array_equal(bins.numpy()[far], pj.obs_bins[far])
    used = far & pj.valid
    np.testing.assert_allclose(normal.numpy()[used], pj.normal[used],
                               atol=1e-5)
    np.testing.assert_allclose(d.numpy()[used], pj.d[used], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(coeff.numpy()[far], pj.coeff[far], atol=1e-5)


@pytest.mark.parametrize("a_mult,prior_on", [(1.0, False), (0.25, True)])
def test_normal_system_matches_jax(scene, a_mult, prior_on):
    _, _, _, q0, t0 = scene
    pj, _ = _planes_j(scene)
    pose_j = jg.Pose(q0, t0)
    info = np.array([40.0, 50.0, 60.0, 10.0, 10.0, 0.0], np.float32)
    prior_j = jr.PosePrior(
        pose=jg.Pose(q0, (t0 + 0.05).astype(np.float32)), information=info,
        enabled=np.asarray(prior_on))
    Hj, gj, cj = jr._accumulate_normal_system(
        pose_j, pj, None, JRt(0.1, RES), prior_j, use_edges=False,
        a_mult=a_mult)
    planes_t = convert.from_numpy(pj)
    prior_t = convert.from_numpy(prior_j)
    Ht, gt, ct = tr._accumulate_normal_system(
        Pose(T(q0), T(t0)), planes_t, None,
        RuntimeParams(torch.tensor(0.1), torch.tensor(RES)), prior_t,
        a_mult=torch.tensor(a_mult))
    scale = float(np.abs(np.asarray(Hj)).max())
    np.testing.assert_allclose(Ht.numpy(), Hj, atol=1e-4 * scale)
    np.testing.assert_allclose(gt.numpy(), gj,
                               atol=1e-4 * float(np.abs(gj).max()))
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)
    # the dispatching wrapper takes the plain version for CPU tensors
    H2, _, _ = tr.normal_system(
        planes_t.p_body, planes_t.normal, planes_t.d, planes_t.coeff,
        planes_t.valid, T(q0), T(t0), torch.tensor(3 * RES))
    H3, _, _ = tr.normal_system_reference(
        planes_t.p_body, planes_t.normal, planes_t.d, planes_t.coeff,
        planes_t.valid, T(q0), T(t0), torch.tensor(3 * RES))
    assert torch.equal(H2, H3)


def test_gauss_newton_solve_matches_jax(scene):
    _, _, _, q0, t0 = scene
    pj, _ = _planes_j(scene)
    rt_j = JRt(np.float32(0.1), np.float32(RES))
    pose_j, small_j = jr.gauss_newton_solve(
        jg.Pose(q0, t0), pj, None, rt_j, 4, None, use_edges=False,
        a_mult=1.0, axis_hold_min=10, hold_enabled=np.asarray(True))
    pose_t, small_t = tr.gauss_newton_solve(
        Pose(T(q0), T(t0)), convert.from_numpy(pj), None,
        RuntimeParams(torch.tensor(0.1), torch.tensor(RES)), 4, None,
        axis_hold_min=10, hold_enabled=torch.tensor(True))
    np.testing.assert_allclose(pose_t.q.numpy(), pose_j.q, atol=1e-4)
    np.testing.assert_allclose(pose_t.t.numpy(), pose_j.t, atol=1e-4)
    assert bool(small_t) == bool(small_j)


@pytest.fixture(scope="module")
def planes_j(scene):
    return _planes_j(scene)[0]


GN_INFO = np.array([40.0, 50.0, 60.0, 10.0, 10.0, 0.0], np.float32)


def _gn_both(scene, planes, hold, prior_on, a_mult):
    """The JAX solve and the port's plain solve on the same inputs; the
    hold (when on) holds every body axis with under half the votes."""
    _, _, _, q0, t0 = scene
    prior_j = jr.PosePrior(pose=jg.Pose(q0, (t0 + 0.05).astype(np.float32)),
                           information=GN_INFO, enabled=np.asarray(prior_on))
    kw = dict(axis_hold_min=10000 if hold else 0, axis_hold_frac=0.5)
    pose_j, small_j = jr.gauss_newton_solve(
        jg.Pose(q0, t0), planes, None, JRt(np.float32(0.1), np.float32(RES)),
        4, prior_j, use_edges=False, a_mult=a_mult,
        hold_enabled=np.asarray(True), **kw)
    planes_t = convert.from_numpy(planes)
    prior_t = convert.from_numpy(prior_j)
    pose_t, small_t = tr.gauss_newton_solve(
        Pose(T(q0), T(t0)), planes_t, None,
        RuntimeParams(torch.tensor(0.1), torch.tensor(RES)), 4, prior_t,
        a_mult=torch.tensor(a_mult, dtype=torch.float32),
        hold_enabled=torch.tensor(True), **kw)
    held = tr.axis_hold_mask(planes_t, 10000, 0.5, prior_t, torch.tensor(True))
    return (pose_j, small_j), (pose_t, small_t), held


@pytest.mark.parametrize("hold", [False, True], ids=["free", "hold"])
@pytest.mark.parametrize("prior_on", [False, True], ids=["noprior", "prior"])
@pytest.mark.parametrize("a_mult", [1.0, 0.25])
def test_gauss_newton_solve_cases_match_jax(scene, planes_j, hold, prior_on,
                                            a_mult):
    """The plain GN solve (K4's plain version) against the JAX solve: axis
    hold on and off, pose prior enabled (it releases the hold) and not,
    full and annealed Tukey support."""
    (pose_j, small_j), (pose_t, small_t), held = _gn_both(
        scene, planes_j, hold, prior_on, a_mult)
    assert bool(held.any()) == (not prior_on)  # the hold bites when armed
    np.testing.assert_allclose(pose_t.q.numpy(), pose_j.q, atol=1e-4)
    np.testing.assert_allclose(pose_t.t.numpy(), pose_j.t, atol=1e-4)
    assert bool(small_t) == bool(small_j)


def test_gauss_newton_solve_all_invalid_matches_jax(scene, planes_j):
    """No valid correspondence: delta is 0, the pose stays where it was."""
    _, _, _, q0, t0 = scene
    dead = planes_j._replace(valid=np.zeros_like(planes_j.valid),
                             coeff=np.zeros_like(planes_j.coeff),
                             obs_bins=np.full_like(planes_j.obs_bins, -1))
    (pose_j, small_j), (pose_t, small_t), held = _gn_both(
        scene, dead, True, False, 1.0)
    assert bool(held.all())  # no votes: every axis held
    np.testing.assert_allclose(pose_t.q.numpy(), pose_j.q, atol=1e-6)
    np.testing.assert_allclose(pose_t.t.numpy(), pose_j.t, atol=1e-6)
    np.testing.assert_allclose(pose_t.t.numpy(), t0, atol=1e-6)
    np.testing.assert_allclose(np.abs(pose_t.q.numpy() @ q0), 1.0, atol=1e-6)
    assert bool(small_t) and bool(small_j)


def test_gauss_newton_solve_dispatch(scene, planes_j):
    """CPU tensors take the plain loop; the kernel's wrapper takes CUDA
    tensors only and raises on anything else."""
    _, _, _, q0, t0 = scene
    planes_t = convert.from_numpy(planes_j)
    rt = RuntimeParams(torch.tensor(0.1), torch.tensor(RES))
    kw = dict(axis_hold_min=10, hold_enabled=torch.tensor(True))
    pose_a, small_a = tr.gauss_newton_solve(Pose(T(q0), T(t0)), planes_t,
                                            None, rt, 4, **kw)
    pose_b, small_b = tr.gauss_newton_solve_reference(
        Pose(T(q0), T(t0)), planes_t, None, rt, 4, **kw)
    assert torch.equal(pose_a.q, pose_b.q) and torch.equal(pose_a.t, pose_b.t)
    assert bool(small_a) == bool(small_b)
    with pytest.raises(ValueError):
        kernels.gn_solve(planes_t.p_body, planes_t.normal, planes_t.d,
                         planes_t.coeff, planes_t.valid, planes_t.obs_bins,
                         T(q0), T(t0), torch.tensor(3 * RES), 4)


def test_estimate_registration_error_matches_jax(scene):
    pj, _ = _planes_j(scene)
    _, _, _, q0, t0 = scene
    H, _, _ = jr._accumulate_normal_system(
        jg.Pose(q0, t0), pj, None, JRt(0.1, RES), None, use_edges=False)
    ej = jax.device_get(jr.estimate_registration_error(H))
    et = tr.estimate_registration_error(T(H))
    for f in ("position_error", "pos_inverse_condition",
              "orientation_error_deg", "ori_inverse_condition"):
        np.testing.assert_allclose(float(getattr(et, f)),
                                   float(getattr(ej, f)), rtol=1e-4)
    np.testing.assert_allclose(et.covariance.numpy(), ej.covariance,
                               rtol=1e-4, atol=1e-9)
    hist = np.array([3, 0, 7, 1, 9, 2, 40, 10, 5], np.int32)
    np.testing.assert_allclose(
        tr.lidar_uncertainty_from_histogram(T(hist)).numpy(),
        jr.lidar_uncertainty_from_histogram(hist), rtol=1e-6)
    codes = np.array([0, 1, 6, -1, 3, 3, 9], np.int32)
    np.testing.assert_array_equal(tr._histogram(T(codes), 7).numpy(),
                                  jr._histogram(codes, 7))


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
