"""The plain Gauss-Newton solve (K4) of the PyTorch port against the JAX
package on the planes of a map built by the JAX package: axis hold on and
off, pose prior enabled (it releases the hold) and not, full and annealed
Tukey support, no valid correspondence, and the solve's dispatch."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from superodom_tpu import geometry as jg  # noqa: E402
from superodom_tpu import registration as jr  # noqa: E402
from superodom_tpu.config import RuntimeParams as JRt  # noqa: E402

from superodom_tpu_torch import convert, kernels  # noqa: E402
from superodom_tpu_torch import registration as tr  # noqa: E402
from superodom_tpu_torch.config import RuntimeParams  # noqa: E402
from superodom_tpu_torch.geometry import Pose  # noqa: E402

from test_torch_registration import RES, T, _planes_j, scene  # noqa: E402,F401


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
