"""Scan-to-map registration, plane path (counterpart of
``superodom_tpu.registration``).

Correspondences: the octant slots of every feature are looked up once at
the predicted pose (K1, :func:`mapstate.octant_lookup`); each ICP round
re-selects the k nearest map points at the current pose (K2,
:func:`mapstate.knn_select`) and fits planes to them (K3,
:func:`plane_fit`).  The round's whole damped Gauss-Newton solve — robust
normal system, pose-prior diagonal, 6x6 Cholesky solve, axis hold and
SE(3) retraction, every iteration — is one launch of K4
(:func:`gauss_newton_solve`); its ``n_iters = 0`` mode gives the final
normal system (:func:`normal_system`).  ``plane_fit_reference``,
``gauss_newton_solve_reference`` and ``normal_system_reference`` are the
plain versions the CPU takes.

Candidate refresh (``RegistrationConfig.refresh_width`` = W > 0): after
round 1 the W nearest candidates of every feature at the once-corrected
pose are materialised once (K9a, :func:`mapstate.reduce_candidates`), and
the later rounds select their neighbours from those W lanes (K9b,
:func:`mapstate.select_knn_reduced`) instead of the 8*C gathered ones.

The edge path (use_edges) is not ported yet and raises
NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from superodom_tpu_torch import kernels
from superodom_tpu_torch.config import MapConfig, RegistrationConfig, RuntimeParams
from superodom_tpu_torch.geometry import (
    Pose,
    apply_se3_update,
    cross as _cross,
    dot3 as _dot,
    quat_conj,
    quat_mul,
    quat_rotate,
)
from superodom_tpu_torch.mapstate import (
    ReducedCandidates,
    VoxelHashMap,
    knn_select,
    octant_lookup,
    reduce_candidates,
    select_knn_reduced,
)
from superodom_tpu_torch.ops.eigh3 import eigh3
from superodom_tpu_torch.ops.smallsolve import inv6_spd, solve6_spd

# MatchingResult codes (reference LidarSlam.h:85-94)
MATCH_SUCCESS = 0
MATCH_NOT_ENOUGH_NEIGHBORS = 1
MATCH_NEIGHBORS_TOO_FAR = 2
MATCH_BAD_PCA_STRUCTURE = 3
MATCH_INVALID_NUMERICAL = 4
MATCH_MSE_TOO_LARGE = 5
MATCH_UNKNOWN = 6
N_REJECTION_CAUSES = 7
N_OBS_BINS = 9


class PlaneCorrs(NamedTuple):
    """Point-to-plane correspondences (fixed width = n surf features)."""

    p_body: torch.Tensor  # f32[M,3]
    normal: torch.Tensor  # f32[M,3] plane unit normal
    d: torch.Tensor  # f32[M] plane offset
    coeff: torch.Tensor  # f32[M] fit-quality weight
    valid: torch.Tensor  # bool[M]
    code: torch.Tensor  # i32[M] MatchingResult
    obs_bins: torch.Tensor  # i32[M,3] observability histogram contributions


class PosePrior(NamedTuple):
    """Absolute pose constraint under degeneracy."""

    pose: Pose
    information: torch.Tensor  # f32[6] diagonal information
    enabled: torch.Tensor  # bool scalar


class RegistrationError(NamedTuple):
    """6-DoF alignment risk (reference LidarSlam.cpp:854-889)."""

    covariance: torch.Tensor
    position_error: torch.Tensor
    position_error_dir: torch.Tensor
    pos_inverse_condition: torch.Tensor
    orientation_error_deg: torch.Tensor
    orientation_error_dir: torch.Tensor
    ori_inverse_condition: torch.Tensor


class IcpStats(NamedTuple):
    """Per-scan optimization statistics (mirrors OptimizationStats.msg)."""

    iter_trans_norm: torch.Tensor  # f32[max_iters]
    iter_rot_norm: torch.Tensor  # f32[max_iters]
    iter_surf_num: torch.Tensor  # i32[max_iters]
    iter_edge_num: torch.Tensor  # i32[max_iters]
    n_iterations: torch.Tensor  # i32
    plane_rejection_hist: torch.Tensor  # i32[7]
    line_rejection_hist: torch.Tensor  # i32[7]
    obs_histogram: torch.Tensor  # i32[9]
    uncertainty: torch.Tensor  # f32[6]
    error: RegistrationError
    degenerate: torch.Tensor  # bool


def _body_axes(q: torch.Tensor) -> torch.Tensor:
    """Rows: the body x, y, z axes in the world frame."""
    return quat_rotate(q[None, :], torch.eye(3, dtype=q.dtype, device=q.device))


# ---------------------------------------------------------------------------
# K3: plane fit
# ---------------------------------------------------------------------------


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 in index order (the kernels' order; k is small)."""
    s = x[:, 0]
    for j in range(1, x.shape[1]):
        s = s + x[:, j]
    return s


def _weighted_pca(pts: torch.Tensor, w: torch.Tensor):
    """Mean + unnormalised scatter-matrix eigendecomposition over masked
    neighbours (utils::ComputePCA); pts [M,k,3], w [M,k]."""
    wsum = torch.clamp_min(_seq_sum(w), 1e-6)
    mean = _seq_sum(pts * w[..., None]) / wsum[:, None]
    c = (pts - mean[:, None, :]) * w[..., None]
    cov = _seq_sum(c[..., :, None] * c[..., None, :])
    vals, vecs = eigh3(cov)
    return mean, vals, vecs


def _observability_bins(q, w_pt, evals, evecs):
    """FeatureObservabilityAnalysis (LidarSlam.cpp:574-693): top-2 rotation
    and top-1 translation bins of each feature."""
    lam1 = torch.sqrt(torch.clamp_min(evals[:, 2], 0.0))
    lam2 = torch.sqrt(torch.clamp_min(evals[:, 1], 0.0))
    lam3 = torch.sqrt(torch.clamp_min(evals[:, 0], 0.0))
    planar2 = (lam2 - lam3) / torch.clamp_min(lam1, 1e-12)
    normal = evecs[:, :, 0]
    normal = torch.where((_dot(w_pt, normal) < 0)[:, None], -normal, normal)
    axes = _body_axes(q)
    cross = _cross(w_pt, normal)
    rx, ry, rz = (_dot(cross, axes[i]) for i in range(3))
    rot_quality = torch.stack([rx, -rx, ry, -ry, rz, -rz], dim=-1)
    p2 = planar2 * planar2
    trans_quality = torch.stack(
        [p2 * torch.abs(_dot(normal, axes[i])) for i in range(3)], dim=-1)
    top1 = torch.argmax(rot_quality, dim=-1)
    masked = rot_quality.scatter(-1, top1[:, None], -torch.inf)
    top2 = torch.argmax(masked, dim=-1)
    t_top = torch.argmax(trans_quality, dim=-1) + 6
    return torch.stack([top1, top2, t_top], dim=-1).to(torch.int32)


def plane_fit_reference(neigh, sq, nvalid, mask, w_pt, q, plane_res):
    """Plain version of K3 (``_plane_fit`` + ``_weighted_pca`` + ``eigh3`` +
    ``_observability_bins``).  Returns (normal f32[M,3], d f32[M],
    coeff f32[M], valid bool[M], code i32[M], obs_bins i32[M,3]) with coeff
    and obs_bins already zeroed / -1 on invalid lanes."""
    dtype = neigh.dtype
    m, k = sq.shape
    n_found = _seq_sum(nvalid.to(torch.int32))
    enough = n_found >= k
    max_sq = 3.0 * plane_res
    near = enough & (sq[:, -1] <= max_sq)

    mean, evals, evecs = _weighted_pca(neigh, nvalid.to(dtype))
    pca_ok = (evals[:, 0] >= 1e-6) & (
        evals[:, 1] / torch.clamp_min(evals[:, 2], 1e-12) >= 0.1)

    # total-least-squares plane from the PCA: normal = smallest
    # eigenvector, d = -n.mean, sign chosen so d > 0
    normal = evecs[:, :, 0]
    d = -_dot(normal, mean)
    normal = torch.where((d < 0)[:, None], -normal, normal)
    d = torch.abs(d)
    numeric_ok = torch.all(torch.isfinite(normal), dim=-1) & torch.isfinite(d)

    pt_dist = torch.abs(_dot(neigh, normal[:, None, :]) + d[:, None])
    mse_ok = torch.all(torch.where(nvalid, pt_dist <= plane_res / 2.0, True),
                       dim=-1)
    mean_dist = _seq_sum(torch.where(nvalid, pt_dist, 0.0)) \
        / torch.clamp_min(n_found.to(dtype), 1.0)
    coeff = 1.0 - torch.sqrt(torch.clamp(mean_dist / max_sq, 0.0, 1.0))
    valid = mask & enough & near & pca_ok & numeric_ok & mse_ok

    code = torch.full((m,), MATCH_SUCCESS, dtype=torch.int32,
                      device=neigh.device)
    for ok, c in ((mse_ok, MATCH_MSE_TOO_LARGE),
                  (numeric_ok, MATCH_INVALID_NUMERICAL),
                  (pca_ok, MATCH_BAD_PCA_STRUCTURE),
                  (near, MATCH_NEIGHBORS_TOO_FAR),
                  (enough, MATCH_NOT_ENOUGH_NEIGHBORS)):
        code = torch.where(ok, code, c)
    code = torch.where(mask, code, MATCH_UNKNOWN).to(torch.int32)

    obs_bins = _observability_bins(q, w_pt, evals, evecs)
    return (normal, d, torch.where(valid, coeff, 0.0), valid, code,
            torch.where(valid[:, None], obs_bins, -1).to(torch.int32))


def gate_margin_lanes(neigh, sq, nvalid, w_pt, q, normal, d, plane_res,
                      eps=1e-5):
    """Lanes whose plane-fit decision lies within ``eps`` (relative) of a
    gate threshold or of an arg-max tie: there two correct versions of K3
    may round to different codes.  ``normal`` and ``d`` are either
    version's outputs.  Used when a kernel or the JAX package is compared
    with the plain version."""
    _, evals, evecs = _weighted_pca(neigh, nvalid.to(neigh.dtype))
    top = evals[:, 2].abs().clamp_min(1e-30)
    max_sq = 3.0 * plane_res
    pt_dist = torch.abs(_dot(neigh, normal[:, None, :]) + d[:, None])
    worst = torch.where(nvalid, pt_dist, 0.0).amax(dim=-1)
    near = (sq[:, -1] - max_sq).abs() <= eps * max_sq
    near |= (evals[:, 0] - 1e-6).abs() <= eps * top
    near |= (evals[:, 1] / evals[:, 2].clamp_min(1e-12) - 0.1).abs() <= eps
    near |= (evals[:, 1] - evals[:, 0]).abs() <= eps * top
    near |= (worst - plane_res / 2.0).abs() <= eps
    near |= d.abs() <= eps
    lo = evecs[:, :, 0]
    lo = torch.where((_dot(w_pt, lo) < 0)[:, None], -lo, lo)
    axes = _body_axes(q)
    cross = _cross(w_pt, lo)
    rq = torch.stack([_dot(cross, axes[i]) for i in range(3)], dim=-1)
    rq = torch.sort(torch.cat([rq, -rq], -1), dim=-1, descending=True).values
    tq = torch.sort(torch.stack([_dot(lo, axes[i]).abs() for i in range(3)],
                                dim=-1), dim=-1, descending=True).values
    scale = rq[:, 0].abs().clamp_min(1e-30)
    near |= (rq[:, 0] - rq[:, 1] <= eps * scale) | (
        rq[:, 1] - rq[:, 2] <= eps * scale)
    near |= tq[:, 0] - tq[:, 1] <= eps * tq[:, 0].clamp_min(1e-30)
    return near


def plane_fit(neigh, sq, nvalid, mask, w_pt, q, plane_res):
    """K3: see :func:`plane_fit_reference` for the contract."""
    if neigh.is_cuda:
        return kernels.plane_fit(neigh, sq, nvalid, mask, w_pt, q, plane_res)
    if neigh.device.type == "cpu":
        return plane_fit_reference(neigh, sq, nvalid, mask, w_pt, q,
                                   plane_res)
    raise ValueError(f"plane_fit: unsupported device {neigh.device}")


def _plane_fit(neigh, sq, nvalid, reg: RegistrationConfig, pose: Pose,
               p_body, mask, plane_res, w_pt) -> PlaneCorrs:
    """PCA plane fit + gates over selected neighbourhoods (the fitting half
    of ComputePlaneDistanceParameters, LidarSlam.cpp:514-572)."""
    normal, d, coeff, valid, code, obs_bins = plane_fit(
        neigh.contiguous(), sq.contiguous(), nvalid.contiguous(),
        mask.contiguous(), w_pt.contiguous(), pose.q.contiguous(),
        plane_res)
    return PlaneCorrs(p_body=p_body, normal=normal, d=d, coeff=coeff,
                      valid=valid, code=code, obs_bins=obs_bins)


def plane_correspondences_from_reduced(red: ReducedCandidates,
                                       reg: RegistrationConfig, pose: Pose,
                                       p_body, mask, plane_res,
                                       w_pt=None) -> PlaneCorrs:
    """Plane correspondences selected from a once-materialised top-W
    candidate subset (the ICP refresh rounds); ``w_pt`` = the features at
    ``pose`` where the caller has them already."""
    if w_pt is None:
        w_pt = pose.apply(p_body).contiguous()
    neigh, sq, nvalid = select_knn_reduced(red, w_pt, reg.plane_knn)
    return _plane_fit(neigh, sq, nvalid, reg, pose, p_body, mask, plane_res,
                      w_pt)


# ---------------------------------------------------------------------------
# K4: robust normal system
# ---------------------------------------------------------------------------


def _tukey_weight(sq_res, a_sq):
    """IRLS weight of Ceres TukeyLoss(a): (1 - s/a^2)^2 for s < a^2, else 0."""
    ratio = sq_res / torch.clamp_min(a_sq, 1e-12)
    return torch.where(ratio < 1.0, (1.0 - ratio) ** 2, 0.0)


def normal_system_reference(p_body, normal, d, coeff, valid, q, t, a_sq):
    """Plain version of K4: (H f32[6,6], g f32[6], cost f32[]) of the
    point-to-plane residuals n.(Rp+t)+d with Jacobian [n, (Rp+t) x n] and
    weight valid * coeff * Tukey(r^2; a_sq)."""
    wp = quat_rotate(q, p_body) + t
    r = _dot(normal, wp) + d
    J = torch.cat([normal, _cross(wp, normal)], dim=-1)
    w = valid.to(p_body.dtype) * coeff * _tukey_weight(r * r, a_sq)
    H = torch.einsum("m,mi,mj->ij", w, J, J)
    g = torch.einsum("m,mi,m->i", w, J, r)
    return H, g, torch.sum(w * r * r)


def normal_system(p_body, normal, d, coeff, valid, q, t, a_sq):
    """K4 (n_iters = 0 mode): see :func:`normal_system_reference` for the
    contract."""
    if p_body.is_cuda:
        return kernels.normal_system(p_body, normal, d, coeff, valid, q, t,
                                     a_sq)
    if p_body.device.type == "cpu":
        return normal_system_reference(p_body, normal, d, coeff, valid, q, t,
                                       a_sq)
    raise ValueError(f"normal_system: unsupported device {p_body.device}")


def _tukey_support(rt: RuntimeParams, a_mult, like: torch.Tensor):
    """a^2 of the Tukey loss: 3 * plane_res * a_mult, a 0-d tensor."""
    return torch.as_tensor(3.0 * rt.plane_res * a_mult, dtype=like.dtype,
                           device=like.device)


def _accumulate_normal_system(pose: Pose, planes: PlaneCorrs, edges,
                              rt: RuntimeParams, prior: Optional[PosePrior],
                              use_edges: bool = False, a_mult=1.0,
                              system=normal_system):
    """H (6x6), g (6,) and cost of all correspondences at the current pose,
    plus the absolute pose prior's diagonal.  ``system`` computes the
    correspondences' part: the dispatching K4, or its plain version."""
    if use_edges:
        raise NotImplementedError("the edge path is not ported yet")
    H, g, cost = system(
        planes.p_body.contiguous(), planes.normal.contiguous(),
        planes.d.contiguous(), planes.coeff.contiguous(),
        planes.valid.contiguous(), pose.q.contiguous(), pose.t.contiguous(),
        _tukey_support(rt, a_mult, pose.t))
    if prior is not None:
        r_t = pose.t - prior.pose.t
        dq = quat_mul(quat_conj(prior.pose.q), pose.q)
        r6 = torch.cat([r_t, 2.0 * dq[1:4]])
        lam = prior.information * prior.enabled.to(H.dtype)
        H = H + torch.diag(lam)
        g = g + lam * r6
    return H, g, cost


def axis_hold_mask(planes: PlaneCorrs, axis_hold_min: int,
                   axis_hold_frac: float, prior: Optional[PosePrior] = None,
                   hold_enabled=None) -> torch.Tensor:
    """bool[3]: the body translation axes whose dominant-normal vote count
    (``obs_bins[:, 2] - 6`` over valid correspondences) falls below
    min(axis_hold_min, max(1, axis_hold_frac * n_valid)); disarmed by
    ``hold_enabled`` False or an enabled prior."""
    dtype, dev = planes.p_body.dtype, planes.p_body.device
    votes = planes.obs_bins[:, 2] - 6  # top translation axis per corr
    cnt = torch.sum((votes[:, None] == torch.arange(3, device=dev)[None])
                    & planes.valid[:, None], dim=0).to(dtype)
    n_valid = torch.sum(planes.valid).to(dtype)
    thresh = torch.clamp_max(torch.clamp_min(axis_hold_frac * n_valid, 1.0),
                             float(axis_hold_min))
    hold = cnt < thresh  # bool[3], body axes
    if hold_enabled is not None:
        hold = hold & hold_enabled
    if prior is not None:
        hold = hold & ~prior.enabled
    return hold


def gauss_newton_solve(pose: Pose, planes: PlaneCorrs, edges,
                       rt: RuntimeParams, n_iters: int,
                       prior: Optional[PosePrior] = None,
                       damping: float = 1e-4, use_edges: bool = False,
                       a_mult=1.0, axis_hold_min: int = 0,
                       axis_hold_frac: float = 0.005, hold_enabled=None):
    """Fixed-count damped Gauss-Newton on SE(3) with IRLS robust weights
    and the per-axis match-count hold (see the JAX package's docstring).
    Returns (pose, converged_in_one).  On CUDA tensors all ``n_iters``
    iterations run in one launch of K4 (``kernels.gn_solve``); on the CPU
    the plain :func:`gauss_newton_solve_reference`."""
    if use_edges:
        raise NotImplementedError("the edge path is not ported yet")
    if pose.t.is_cuda:
        q, t, first_small = kernels.gn_solve(
            planes.p_body.contiguous(), planes.normal.contiguous(),
            planes.d.contiguous(), planes.coeff.contiguous(),
            planes.valid.contiguous(), planes.obs_bins.contiguous(),
            pose.q.contiguous(), pose.t.contiguous(),
            _tukey_support(rt, a_mult, pose.t), n_iters, damping,
            None if prior is None else tuple(
                x.contiguous() for x in (prior.pose.q, prior.pose.t,
                                         prior.information, prior.enabled)),
            axis_hold_min, axis_hold_frac, hold_enabled)
        return Pose(q, t), first_small
    if pose.t.device.type == "cpu":
        return gauss_newton_solve_reference(
            pose, planes, edges, rt, n_iters, prior, damping, use_edges,
            a_mult, axis_hold_min, axis_hold_frac, hold_enabled)
    raise ValueError(f"gauss_newton_solve: unsupported device {pose.t.device}")


def gauss_newton_solve_reference(pose: Pose, planes: PlaneCorrs, edges,
                                 rt: RuntimeParams, n_iters: int,
                                 prior: Optional[PosePrior] = None,
                                 damping: float = 1e-4,
                                 use_edges: bool = False, a_mult=1.0,
                                 axis_hold_min: int = 0,
                                 axis_hold_frac: float = 0.005,
                                 hold_enabled=None):
    """Plain version of K4's solve: the GN loop in PyTorch ops over
    :func:`normal_system_reference` (never the kernel, on any device)."""
    if use_edges:
        raise NotImplementedError("the edge path is not ported yet")
    dtype, dev = pose.t.dtype, pose.t.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    hold = None
    if axis_hold_min > 0:
        hold = axis_hold_mask(planes, axis_hold_min, axis_hold_frac, prior,
                              hold_enabled)

    p = pose
    first_small = None
    for _ in range(n_iters):
        H, g, _ = _accumulate_normal_system(p, planes, edges, rt, prior,
                                            use_edges, a_mult,
                                            system=normal_system_reference)
        Hd = H + damping * eye6 * (1.0 + torch.diagonal(H))
        delta = -solve6_spd(Hd, g)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        if hold is not None:
            # remove the translation along held BODY axes (delta is world)
            axes = _body_axes(p.q)
            dt = delta[:3] - axes.T @ (hold.to(dtype) * (axes @ delta[:3]))
            delta = torch.cat([dt, delta[3:]])
        p = apply_se3_update(p, delta)
        step_small = torch.linalg.norm(delta) < 1e-6
        if first_small is None:
            first_small = step_small
    return p, first_small


# ---------------------------------------------------------------------------
# degeneracy / uncertainty outputs
# ---------------------------------------------------------------------------


def estimate_registration_error(H: torch.Tensor) -> RegistrationError:
    """cov = H^-1, then eigenanalysis of the position and orientation
    blocks (reference LidarSlam.cpp:854-889)."""
    Hd = H + 1e-6 * torch.eye(6, dtype=H.dtype, device=H.device)
    cov = inv6_spd(Hd)
    evals_p, evecs_p = eigh3(cov[:3, :3])
    evals_r, evecs_r = eigh3(cov[3:, 3:])

    def sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 0.0))

    return RegistrationError(
        covariance=cov,
        position_error=sqrt(evals_p[2]),
        position_error_dir=evecs_p[:, 2],
        pos_inverse_condition=sqrt(evals_p[0])
        / torch.clamp_min(sqrt(evals_p[2]), 1e-12),
        orientation_error_deg=torch.rad2deg(sqrt(evals_r[2])),
        orientation_error_dir=evecs_r[:, 2],
        ori_inverse_condition=sqrt(evals_r[0])
        / torch.clamp_min(sqrt(evals_r[2]), 1e-12),
    )


def lidar_uncertainty_from_histogram(hist: torch.Tensor) -> torch.Tensor:
    """EstimateLidarUncertainty (LidarSlam.cpp:915-986): per-axis share of
    constraining features x3, capped at 1 (LOW = degenerate)."""
    h = hist.to(torch.float32)
    trans_total = h[6] + h[7] + h[8]
    rot_total = h[0] + h[1] + h[2] + h[3] + h[4] + h[5]
    safe_t = torch.clamp_min(trans_total, 1.0)
    safe_r = torch.clamp_min(rot_total, 1.0)
    u = torch.clamp_max(torch.stack([
        h[6] / safe_t * 3.0,
        h[7] / safe_t * 3.0,
        h[8] / safe_t * 3.0,
        (h[0] + h[1]) / safe_r * 3.0,
        (h[2] + h[3]) / safe_r * 3.0,
        (h[4] + h[5]) / safe_r * 3.0,
    ]), 1.0)
    return torch.where((trans_total == 0) | (rot_total == 0), 0.0, u)


def _histogram(codes: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Counts of codes 0..n_bins-1 (negative codes count nowhere)."""
    eq = codes[:, None] == torch.arange(n_bins, dtype=codes.dtype,
                                        device=codes.device)[None, :]
    return torch.sum(eq.to(torch.int32), dim=0).to(torch.int32)


def anneal_mult(reg: RegistrationConfig, it, dtype=torch.float32):
    """Tukey support multiplier for outer round ``it``:
    max(tukey_anneal**it, tukey_anneal_floor); 1.0 when annealing is off."""
    if reg.tukey_anneal >= 1.0:
        return 1.0
    it = torch.as_tensor(it)
    base = torch.full((), reg.tukey_anneal, dtype=dtype, device=it.device)
    return torch.clamp_min(base ** it.to(dtype), reg.tukey_anneal_floor)


# ---------------------------------------------------------------------------
# the ICP loop
# ---------------------------------------------------------------------------


class _Carry(NamedTuple):
    pose: Pose
    converged: torch.Tensor  # bool
    it: torch.Tensor  # i32 live rounds so far
    planes: Optional[PlaneCorrs]
    t_norms: torch.Tensor
    r_norms: torch.Tensor
    surf_ns: torch.Tensor


def icp_register(
    edge_map: VoxelHashMap,
    surf_map: VoxelHashMap,
    map_cfg: MapConfig,
    reg: RegistrationConfig,
    pose0: Pose,
    edge_pts: torch.Tensor,
    edge_mask: torch.Tensor,
    surf_pts: torch.Tensor,
    surf_mask: torch.Tensor,
    rt: RuntimeParams,
    prior: Optional[PosePrior] = None,
    use_edges: bool = False,
    hold_enabled=None,
) -> Tuple[Pose, IcpStats]:
    """Scan-to-map ICP (reference performLocalizationAndMapping,
    LidarSlam.cpp:107-152): outer rounds of correspondence extraction +
    robust GN, a convergence mask freezing a finished solve.

    The octant slots are looked up ONCE at the predicted pose and every
    round re-selects from them.  Round 1 always runs, at full width.  With
    ``icp_early_exit`` each further round runs only while the solve has
    not converged — one host read of the converged flag per round, the
    eager counterpart of the JAX ``while_loop``; without it every round
    runs with the converged solve frozen (the JAX ``scan``).  With
    ``refresh_width`` > 0 the candidates are reduced once at the round-1
    pose, just after the read that lets round 2 run (a scan that converged
    in round 1 skips the reduction, as the JAX ``cond`` does), and rounds
    2.. select from the reduced set."""
    if use_edges:
        raise NotImplementedError("the edge path is not ported yet")
    max_it = reg.max_icp_iters
    dtype, dev = surf_pts.dtype, surf_pts.device
    surf_pts = surf_pts.contiguous()

    w_pt0 = pose0.apply(surf_pts).contiguous()
    slots = octant_lookup(surf_map.keys, w_pt0, map_cfg.cell_size)

    def correspondences(pose: Pose, w_pt) -> PlaneCorrs:
        """Full-width extraction; ``w_pt`` = the features at ``pose``."""
        neigh, sq, nvalid, _ = knn_select(surf_map.pts, slots, w_pt,
                                          reg.plane_knn)
        return _plane_fit(neigh, sq, nvalid, reg, pose, surf_pts, surf_mask,
                          rt.plane_res, w_pt)

    rounds = torch.arange(max_it, device=dev)

    def icp_round(c: _Carry, planes: PlaneCorrs) -> _Carry:
        """One round from ``c`` on the correspondences extracted at
        ``c.pose``."""
        new_pose, one_step = gauss_newton_solve(
            c.pose, planes, None, rt, reg.max_gn_iters, prior,
            use_edges=False, a_mult=anneal_mult(reg, c.it, dtype),
            axis_hold_min=reg.axis_hold_min_matches,
            axis_hold_frac=reg.axis_hold_frac, hold_enabled=hold_enabled)
        new_pose = Pose(*(torch.where(c.converged, o, n)
                          for n, o in zip(new_pose, c.pose)))
        rel_t = torch.linalg.norm(new_pose.t - c.pose.t)
        dq = quat_mul(quat_conj(c.pose.q), new_pose.q)
        rel_r = 2.0 * torch.atan2(torch.linalg.norm(dq[1:4]), torch.abs(dq[0]))
        live = ~c.converged
        at = (rounds == torch.clamp_max(c.it, max_it - 1)) & live
        n_valid = torch.sum(planes.valid.to(torch.int32)).to(torch.int32)
        now_converged = c.converged | one_step | (
            (rel_t < reg.trans_converge_tol) & (rel_r < reg.rot_converge_tol))
        return _Carry(
            pose=new_pose, converged=now_converged,
            it=c.it + live.to(torch.int32), planes=planes,
            t_norms=torch.where(at, rel_t, c.t_norms),
            r_norms=torch.where(at, rel_r, c.r_norms),
            surf_ns=torch.where(at, n_valid, c.surf_ns))

    c = icp_round(_Carry(
        pose=pose0, converged=torch.zeros((), dtype=torch.bool, device=dev),
        it=torch.zeros((), dtype=torch.int32, device=dev), planes=None,
        t_norms=torch.zeros((max_it,), dtype=dtype, device=dev),
        r_norms=torch.zeros((max_it,), dtype=dtype, device=dev),
        surf_ns=torch.zeros((max_it,), dtype=torch.int32, device=dev)),
        correspondences(pose0, w_pt0))
    red = None  # the reduced candidates, made when round 2 is to run
    for _ in range(max_it - 1):
        if reg.icp_early_exit and bool(c.converged):
            break
        w_pt = c.pose.apply(surf_pts).contiguous()
        if reg.refresh_width > 0:
            if red is None:
                red = reduce_candidates(surf_map.pts, slots, w_pt,
                                        reg.refresh_width)
            planes = plane_correspondences_from_reduced(
                red, reg, c.pose, surf_pts, surf_mask, rt.plane_res, w_pt)
        else:
            planes = correspondences(c.pose, w_pt)
        c = icp_round(c, planes)
    pose, planes, n_it = c.pose, c.planes, c.it

    # one H at the final pose, at the last executed round's Tukey support
    H, _, _ = _accumulate_normal_system(
        pose, planes, None, rt, prior, False,
        anneal_mult(reg, torch.clamp_min(n_it - 1, 0), dtype))
    H_data = H
    if prior is not None:
        # alignment risk measures the lidar data alone
        H_data = H - torch.diag(prior.information
                                * prior.enabled.to(H.dtype))
    err = estimate_registration_error(H_data)
    obs_hist = _histogram(
        torch.where(planes.valid[:, None], planes.obs_bins, -1).reshape(-1),
        N_OBS_BINS)
    line_codes = torch.full((edge_pts.shape[0],), MATCH_UNKNOWN,
                            dtype=torch.int32, device=dev)
    stats = IcpStats(
        iter_trans_norm=c.t_norms,
        iter_rot_norm=c.r_norms,
        iter_surf_num=c.surf_ns,
        iter_edge_num=torch.zeros((max_it,), dtype=torch.int32, device=dev),
        n_iterations=torch.sum((rounds < n_it).to(torch.int32)).to(
            torch.int32),
        plane_rejection_hist=_histogram(planes.code, N_REJECTION_CAUSES),
        line_rejection_hist=_histogram(line_codes, N_REJECTION_CAUSES),
        obs_histogram=obs_hist,
        uncertainty=lidar_uncertainty_from_histogram(obs_hist),
        error=err,
        degenerate=(err.pos_inverse_condition < reg.pos_degeneracy_threshold)
        | (err.ori_inverse_condition < reg.ori_degeneracy_threshold),
    )
    return pose.normalize(), stats
