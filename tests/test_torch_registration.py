"""Plane registration of the PyTorch port against the JAX package: the
plain versions of the plane_fit (K3) and Gauss-Newton (K4: the solve and
its normal system) kernels on a map built by the JAX package and carried
across, and the registration's error estimate.  The solve's cases (axis
hold, pose prior, Tukey annealing) are in test_torch_gauss_newton.py, the
ICP loop in test_torch_icp.py."""

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

from superodom_tpu_torch import convert  # noqa: E402
from superodom_tpu_torch import registration as tr  # noqa: E402
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
