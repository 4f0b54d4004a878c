"""Scan-to-map registration (counterpart of ``superodom_tpu.registration``).

The library's correspondence functions under the JAX package's names and
arguments (:func:`compute_plane_correspondences`,
:func:`plane_correspondences_from_candidates`,
:func:`compute_edge_correspondences`,
:func:`edge_correspondences_from_candidates`) gather the candidate rows
(K1) and select from them with K2's gathered mode
(:func:`mapstate.select_knn`); the ICP rounds below do not call them.

Correspondences: the octant slots of every feature are looked up once at
the predicted pose (K1, :func:`mapstate.candidate_view`); each ICP round
re-selects the k nearest map points at the current pose (K2,
:func:`mapstate.knn_select`) and fits planes to them (K3,
:func:`plane_fit`) and, with edges on (``use_edges``), lines to the edge
map's (K11b, :func:`edge_fit`).  The round's whole damped Gauss-Newton
solve — robust normal system of the planes and lines, pose-prior
diagonal, 6x6 Cholesky solve, axis hold and SE(3) retraction, every
iteration — is one launch of K4 (:func:`gauss_newton_solve`); its
``n_iters = 0`` mode gives the final normal system
(:func:`normal_system`).  ``plane_fit_reference``, ``edge_fit_reference``,
``gauss_newton_solve_reference`` and ``normal_system_reference`` are the
plain versions the CPU takes.

Candidate refresh (``RegistrationConfig.refresh_width`` = W > 0): after
round 1 the W nearest candidates of every feature at the once-corrected
pose are materialised once (K9a, :func:`mapstate.reduce_candidates`), and
the later rounds select their neighbours from those W lanes (K9b,
:func:`mapstate.select_knn_reduced`) instead of the 8*C gathered ones; the
edges' half reduces to max(W, 2 * edge_knn) lanes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from superodom_tpu_torch import kernel_ops
from superodom_tpu_torch.config import MapConfig, RegistrationConfig, RuntimeParams
from superodom_tpu_torch.geometry import (
    Pose,
    apply_se3_update,
    cross as _cross,
    dot3 as _dot,
    quat_conj,
    quat_mul,
    quat_rotate,
    skew,
)
from superodom_tpu_torch.mapstate import (
    ReducedCandidates,
    VoxelHashMap,
    candidate_view,
    gather_candidates,
    knn_select,
    reduce_candidates,
    select_knn,
    select_knn_reduced,
)
from superodom_tpu_torch.ops import invariant as inv
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


class EdgeCorrs(NamedTuple):
    """Point-to-line correspondences (fixed width = n edge features)."""

    p_body: torch.Tensor  # f32[M,3]
    a: torch.Tensor  # f32[M,3] line endpoint A (world)
    b: torch.Tensor  # f32[M,3] line endpoint B (world)
    coeff: torch.Tensor  # f32[M] fit-quality weight
    valid: torch.Tensor  # bool[M]
    code: torch.Tensor  # i32[M] MatchingResult


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
        return kernel_ops.plane_fit(neigh, sq, nvalid, mask, w_pt, q,
                                    plane_res)
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


def compute_plane_correspondences(surf_map, map_cfg: MapConfig,
                                  reg: RegistrationConfig, pose: Pose,
                                  p_body, mask, plane_res) -> PlaneCorrs:
    """Plane correspondences of every surface feature at ``pose``
    (ComputePlaneDistanceParameters, LidarSlam.cpp:514-572): the
    candidates gathered at the features' world points
    (:func:`mapstate.gather_candidates`, K1), then
    :func:`plane_correspondences_from_candidates`.  ``surf_map`` may be a
    :class:`mapstate.ShardedMap`."""
    cand, cvalid = gather_candidates(surf_map, map_cfg,
                                     pose.apply(p_body).contiguous())
    return plane_correspondences_from_candidates(cand, cvalid, reg, pose,
                                                 p_body, mask, plane_res)


def plane_correspondences_from_candidates(cand, cvalid,
                                          reg: RegistrationConfig,
                                          pose: Pose, p_body, mask,
                                          plane_res) -> PlaneCorrs:
    """Plane correspondences fitted against pre-gathered candidates
    ``cand`` f32[Q,8,3C] with the lane mask ``cvalid`` bool[Q,8C]: the
    ``plane_knn`` nearest (:func:`mapstate.select_knn`, K2's gathered
    mode), then the plane fit (K3)."""
    w_pt = pose.apply(p_body).contiguous()
    neigh, sq, nvalid = select_knn(cand, cvalid, w_pt, reg.plane_knn)
    return _plane_fit(neigh, sq, nvalid, reg, pose, p_body, mask, plane_res,
                      w_pt)


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
# K11b: edge (line) fit
# ---------------------------------------------------------------------------


def _edge_consensus(neigh, nvalid, max_dist_inlier):
    """The line-inlier consensus of ``_edge_fit``: for each candidate line
    through the nearest neighbour and neighbour j+1, the inliers among
    neighbours 1..k-1 (strictly within ``max_dist_inlier``, or j itself;
    both lanes valid); the first line with the most inliers wins.  Returns
    (sel_full bool[M,k]: the nearest neighbour if valid and the winner's
    inliers; dist_sq f32[M,k-1,k-1], pair[M,k-1,k-1]: both lanes valid)."""
    p1 = neigh[:, 0, :]
    rel = neigh[:, 1:, :] - p1[:, None, :]
    rest_valid = nvalid[:, 1:]
    dirs = rel / torch.clamp_min(torch.sqrt(_dot(rel, rel)), 1e-12)[..., None]
    c = _cross(rel[:, None, :, :], dirs[:, :, None, :])  # [M, j, c, 3]
    dist_sq = _dot(c, c)
    pair = rest_valid[:, None, :] & rest_valid[:, :, None]
    eye = torch.eye(rel.shape[1], dtype=torch.bool, device=neigh.device)
    is_inlier = ((dist_sq < max_dist_inlier ** 2) | eye[None]) & pair
    counts = torch.sum(is_inlier.to(torch.int32), dim=-1)
    best_j = torch.argmax(counts, dim=-1)  # the first maximum
    sel = torch.gather(is_inlier, 1, best_j[:, None, None].expand(
        -1, 1, is_inlier.shape[2]))[:, 0, :]
    return torch.cat([nvalid[:, :1], sel], dim=-1), dist_sq, pair


def _edge_line_fit(neigh, sel_full):
    """Mean, eigenvalues and line direction (largest eigenvector) of the
    selected neighbours, and each neighbour's squared distance to the
    line."""
    mean, evals, evecs = _weighted_pca(neigh, sel_full.to(neigh.dtype))
    line_dir = evecs[:, :, 2]
    relm = neigh - mean[:, None, :]
    along = _dot(relm, line_dir[:, None, :])
    perp_sq = _dot(relm, relm) - along * along
    return mean, evals, line_dir, perp_sq


def edge_fit_reference(neigh, sq, nvalid, mask, line_res,
                       min_neighbors: int, max_dist_inlier: float):
    """Plain version of K11b (``_edge_fit`` + ``_weighted_pca`` + ``eigh3``):
    the line-inlier consensus, the PCA line fit and the reference's gates.
    Returns (a f32[M,3], b f32[M,3], coeff f32[M] (0 where not valid),
    valid bool[M], code i32[M]).  Neighbour lanes that are not valid (the
    BIG sentinel, or a point of table row 0) are dropped by selects, not by
    zero products (inf * 0 is NaN)."""
    m = sq.shape[0]
    sel_full, _, _ = _edge_consensus(neigh, nvalid, max_dist_inlier)
    n_sel = _seq_sum(sel_full.to(torch.int32))
    enough = n_sel >= min_neighbors
    max_sq = 3.0 * line_res
    far_gate = torch.amax(torch.where(sel_full, sq, -torch.inf),
                          dim=-1) <= max_sq
    mean, evals, line_dir, perp_sq = _edge_line_fit(neigh, sel_full)
    pca_ok = evals[:, 2] >= min_neighbors * evals[:, 1]
    mse_ok = torch.all(torch.where(sel_full, perp_sq <= max_sq, True), dim=-1)
    mean_sq = _seq_sum(torch.where(sel_full, perp_sq, 0.0)) \
        / torch.clamp_min(n_sel.to(neigh.dtype), 1.0)
    coeff = 1.0 - torch.sqrt(torch.clamp(mean_sq / max_sq, 0.0, 1.0))
    valid = mask & enough & far_gate & pca_ok & mse_ok

    code = torch.full((m,), MATCH_SUCCESS, dtype=torch.int32,
                      device=neigh.device)
    for ok, c in ((mse_ok, MATCH_MSE_TOO_LARGE),
                  (pca_ok, MATCH_BAD_PCA_STRUCTURE),
                  (far_gate, MATCH_NEIGHBORS_TOO_FAR),
                  (enough, MATCH_NOT_ENOUGH_NEIGHBORS)):
        code = torch.where(ok, code, c)
    code = torch.where(mask, code, MATCH_UNKNOWN).to(torch.int32)
    return (mean + 0.1 * line_dir, mean - 0.1 * line_dir,
            torch.where(valid, coeff, 0.0), valid, code)


def edge_gate_margin_lanes(neigh, sq, nvalid, line_res, min_neighbors: int,
                           max_dist_inlier: float, eps=1e-5):
    """Lanes whose edge-fit decision lies within ``eps`` (relative) of a
    gate threshold, where two correct versions of K11b may round to
    different codes: an inlier distance at ``max_dist_inlier``^2, the far
    gate, the PCA ratio and the MSE gate.  Used when a kernel or the JAX
    package is compared with the plain version."""
    sel_full, dist_sq, pair = _edge_consensus(neigh, nvalid, max_dist_inlier)
    thresh = max_dist_inlier ** 2
    near = ((dist_sq - thresh).abs() <= eps * thresh) & pair
    near = near.flatten(1).any(dim=1)
    max_sq = 3.0 * line_res
    far = torch.amax(torch.where(sel_full, sq, -torch.inf), dim=-1)
    near |= (far - max_sq).abs() <= eps * max_sq
    _, evals, _, perp_sq = _edge_line_fit(neigh, sel_full)
    top = evals[:, 2].abs().clamp_min(1e-30)
    near |= (evals[:, 2] - min_neighbors * evals[:, 1]).abs() <= eps * top
    worst = torch.where(sel_full, perp_sq, -torch.inf).amax(dim=-1)
    near |= (worst - max_sq).abs() <= eps * max_sq
    return near


def edge_fit(neigh, sq, nvalid, mask, line_res, min_neighbors: int,
             max_dist_inlier: float):
    """K11b: see :func:`edge_fit_reference` for the contract."""
    if neigh.is_cuda:
        return kernel_ops.edge_fit(neigh, sq, nvalid, mask, line_res,
                                   int(min_neighbors),
                                   float(max_dist_inlier))
    if neigh.device.type == "cpu":
        return edge_fit_reference(neigh, sq, nvalid, mask, line_res,
                                  min_neighbors, max_dist_inlier)
    raise ValueError(f"edge_fit: unsupported device {neigh.device}")


def _edge_fit(neigh, sq, nvalid, reg: RegistrationConfig, p_body, mask,
              line_res) -> EdgeCorrs:
    """Line-inlier consensus + PCA line fit + gates over selected
    neighbourhoods (ComputeLineDistanceParameters +
    nearestKSearchSpecificEdgePoint, LidarSlam.cpp:402-493,
    LocalMap.h:377-474)."""
    a, b, coeff, valid, code = edge_fit(
        neigh.contiguous(), sq.contiguous(), nvalid.contiguous(),
        mask.contiguous(), line_res, reg.min_edge_neighbors,
        reg.edge_max_dist_inlier)
    return EdgeCorrs(p_body=p_body, a=a, b=b, coeff=coeff, valid=valid,
                     code=code)


def compute_edge_correspondences(edge_map, map_cfg: MapConfig,
                                 reg: RegistrationConfig, pose: Pose,
                                 p_body, mask, line_res) -> EdgeCorrs:
    """Line correspondences of every edge feature at ``pose``
    (ComputeLineDistanceParameters + the line-inlier selection of
    nearestKSearchSpecificEdgePoint, LidarSlam.cpp:402-493,
    LocalMap.h:377-474): the candidates gathered in the edge map (K1), then
    :func:`edge_correspondences_from_candidates`."""
    cand, cvalid = gather_candidates(edge_map, map_cfg,
                                     pose.apply(p_body).contiguous())
    return edge_correspondences_from_candidates(cand, cvalid, reg, pose,
                                                p_body, mask, line_res)


def edge_correspondences_from_candidates(cand, cvalid,
                                         reg: RegistrationConfig,
                                         pose: Pose, p_body, mask,
                                         line_res) -> EdgeCorrs:
    """Line correspondences fitted against pre-gathered candidates
    ``cand`` f32[Q,8,3C] with the lane mask ``cvalid`` bool[Q,8C]: the
    ``edge_knn`` nearest (K2's gathered mode), then the line fit (K11b)."""
    w_pt = pose.apply(p_body).contiguous()
    neigh, sq, nvalid = select_knn(cand, cvalid, w_pt, reg.edge_knn)
    return _edge_fit(neigh, sq, nvalid, reg, p_body, mask, line_res)


def _edge_correspondences_from_slots(pts, slots, reg: RegistrationConfig,
                                     p_body, mask, line_res,
                                     w_pt) -> EdgeCorrs:
    """Edge correspondences selected at full width from the octant slots
    ``slots`` of the edge map's point table ``pts`` (K2 at k = edge_knn);
    ``w_pt`` = the features at the round's pose (the ICP rounds)."""
    neigh, sq, nvalid, _ = knn_select(pts, slots, w_pt, reg.edge_knn)
    return _edge_fit(neigh, sq, nvalid, reg, p_body, mask, line_res)


def edge_correspondences_from_reduced(red: ReducedCandidates,
                                      reg: RegistrationConfig, pose: Pose,
                                      p_body, mask, line_res,
                                      w_pt=None) -> EdgeCorrs:
    """Edge correspondences selected from a once-materialised top-W
    candidate subset (the ICP refresh rounds)."""
    if w_pt is None:
        w_pt = pose.apply(p_body).contiguous()
    neigh, sq, nvalid = select_knn_reduced(red, w_pt, reg.edge_knn)
    return _edge_fit(neigh, sq, nvalid, reg, p_body, mask, line_res)


# ---------------------------------------------------------------------------
# K4: robust normal system
# ---------------------------------------------------------------------------


def _tukey_weight(sq_res, a_sq):
    """IRLS weight of Ceres TukeyLoss(a): (1 - s/a^2)^2 for s < a^2, else 0."""
    ratio = sq_res / torch.clamp_min(a_sq, 1e-12)
    return torch.where(ratio < 1.0, (1.0 - ratio) ** 2, 0.0)


def normal_system_reference(p_body, normal, d, coeff, valid, q, t, a_sq,
                            edges=None, a_sq_e=None):
    """Plain version of K4: (H f32[6,6], g f32[6], cost f32[]) of the
    point-to-plane residuals n.(Rp+t)+d with Jacobian [n, (Rp+t) x n] and
    weight valid * coeff * Tukey(r^2; a_sq), plus, with ``edges`` = (p_body,
    a, b, coeff, valid), the point-to-line residuals (we-a) x (we-b) / |a-b|
    (we = Rp+t) with Jacobian skew(-(a-b)/|a-b|) [I, -skew(we)] and weight
    valid * coeff * Tukey(|r|^2; a_sq_e)."""
    wp = quat_rotate(q, p_body) + t
    r = _dot(normal, wp) + d
    J = torch.cat([normal, _cross(wp, normal)], dim=-1)
    w = valid.to(p_body.dtype) * coeff * _tukey_weight(r * r, a_sq)
    # ops.invariant's einsums: an instance's bits under vmap do not
    # depend on the batch
    H = inv.einsum("m,mi,mj->ij", w, J, J)
    g = inv.einsum("m,mi,m->i", w, J, r)
    cost = torch.sum(w * r * r)
    if edges is not None:
        e_p, e_a, e_b, e_c, e_v = edges
        we = quat_rotate(q, e_p) + t
        d_ab = e_a - e_b
        d_norm = torch.clamp_min(torch.sqrt(_dot(d_ab, d_ab)), 1e-9)[:, None]
        r_e = _cross(we - e_a, we - e_b) / d_norm
        L = skew(-d_ab / d_norm)
        eye = torch.eye(3, dtype=we.dtype, device=we.device)
        Jw = torch.cat([eye.expand(L.shape), -skew(we)], dim=-1)
        J_e = inv.einsum("mij,mjk->mik", L, Jw)
        sq_e = _dot(r_e, r_e)
        w_e = e_v.to(we.dtype) * e_c * _tukey_weight(sq_e, a_sq_e)
        H = H + inv.einsum("m,mri,mrj->ij", w_e, J_e, J_e)
        g = g + inv.einsum("m,mri,mr->i", w_e, J_e, r_e)
        cost = cost + torch.sum(w_e * sq_e)
    return H, g, cost


def normal_system(p_body, normal, d, coeff, valid, q, t, a_sq, edges=None,
                  a_sq_e=None):
    """K4 (n_iters = 0 mode): see :func:`normal_system_reference` for the
    contract."""
    if p_body.is_cuda:
        out = kernel_ops.normal_system(
            p_body, normal, d, coeff, valid, q, t, a_sq,
            *(edges if edges is not None else (None,) * 5), a_sq_e)
        return out[:36].reshape(6, 6), out[36:42], out[42]
    if p_body.device.type == "cpu":
        return normal_system_reference(p_body, normal, d, coeff, valid, q, t,
                                       a_sq, edges, a_sq_e)
    raise ValueError(f"normal_system: unsupported device {p_body.device}")


def _tukey_support(res, a_mult, like: torch.Tensor):
    """a^2 of the Tukey loss: 3 * res * a_mult (res = plane_res for planes,
    line_res for edges), a 0-d tensor."""
    return torch.as_tensor(3.0 * res * a_mult, dtype=like.dtype,
                           device=like.device)


def _edge_rows(edges: EdgeCorrs):
    return tuple(x.contiguous() for x in (edges.p_body, edges.a, edges.b,
                                          edges.coeff, edges.valid))


def _accumulate_normal_system(pose: Pose, planes: PlaneCorrs, edges,
                              rt: RuntimeParams, prior: Optional[PosePrior],
                              use_edges: bool = False, a_mult=1.0,
                              system=normal_system):
    """H (6x6), g (6,) and cost of all correspondences at the current pose
    (the lines' too with ``use_edges``), plus the absolute pose prior's
    diagonal.  ``system`` computes the correspondences' part: the
    dispatching K4, or its plain version."""
    H, g, cost = system(
        planes.p_body.contiguous(), planes.normal.contiguous(),
        planes.d.contiguous(), planes.coeff.contiguous(),
        planes.valid.contiguous(), pose.q.contiguous(), pose.t.contiguous(),
        _tukey_support(rt.plane_res, a_mult, pose.t),
        _edge_rows(edges) if use_edges else None,
        _tukey_support(rt.line_res, a_mult, pose.t) if use_edges else None)
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
                   hold_enabled=None, edges: Optional[EdgeCorrs] = None,
                   q=None) -> torch.Tensor:
    """bool[3]: the body translation axes whose vote count falls below
    min(axis_hold_min, max(1, axis_hold_frac * n_valid)); disarmed by
    ``hold_enabled`` False or an enabled prior.  A valid plane votes for its
    dominant-normal axis (``obs_bins[:, 2] - 6``); with ``edges``, a valid
    line votes for every body axis of ``q`` (the round's start pose) at
    more than 45 degrees to it (1 - (d.axis)^2 > 0.5), and counts in
    n_valid."""
    dtype, dev = planes.p_body.dtype, planes.p_body.device
    votes = planes.obs_bins[:, 2] - 6  # top translation axis per corr
    cnt = torch.sum((votes[:, None] == torch.arange(3, device=dev)[None])
                    & planes.valid[:, None], dim=0).to(dtype)
    n_valid = torch.sum(planes.valid).to(dtype)
    if edges is not None:
        dvec = edges.a - edges.b
        dvec = dvec / torch.clamp_min(torch.sqrt(_dot(dvec, dvec)),
                                      1e-12)[:, None]
        axes = _body_axes(q)
        sin2 = 1.0 - torch.stack([_dot(dvec, axes[i]) for i in range(3)],
                                 dim=-1) ** 2
        cnt = cnt + torch.sum((sin2 > 0.5) & edges.valid[:, None],
                              dim=0).to(dtype)
        n_valid = n_valid + torch.sum(edges.valid).to(dtype)
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
    iterations run in one launch of K4 (``kernel_ops.gn_solve``), the lines'
    rows (``use_edges``) beside the planes'; on the CPU the plain
    :func:`gauss_newton_solve_reference`."""
    if pose.t.is_cuda:
        qt, first_small = kernel_ops.gn_solve(
            planes.p_body.contiguous(), planes.normal.contiguous(),
            planes.d.contiguous(), planes.coeff.contiguous(),
            planes.valid.contiguous(), planes.obs_bins.contiguous(),
            pose.q.contiguous(), pose.t.contiguous(),
            _tukey_support(rt.plane_res, a_mult, pose.t), int(n_iters),
            float(damping),
            *((None,) * 4 if prior is None else (
                x.contiguous() for x in (prior.pose.q, prior.pose.t,
                                         prior.information, prior.enabled))),
            int(axis_hold_min), float(axis_hold_frac), hold_enabled,
            *(_edge_rows(edges) if use_edges else (None,) * 5),
            _tukey_support(rt.line_res, a_mult, pose.t) if use_edges
            else None)
        return Pose(qt[:4], qt[4:]), first_small
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
    dtype, dev = pose.t.dtype, pose.t.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    hold = None
    if axis_hold_min > 0:
        hold = axis_hold_mask(planes, axis_hold_min, axis_hold_frac, prior,
                              hold_enabled, edges if use_edges else None,
                              pose.q)

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
            # remove the translation along held BODY axes (delta is world);
            # ops.invariant's products keep an instance's bits under vmap
            axes = _body_axes(p.q)
            dt = delta[:3] - inv.matmul(
                axes.T, hold.to(dtype) * inv.matmul(axes, delta[:3]))
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
    lines: Optional[EdgeCorrs]
    t_norms: torch.Tensor
    r_norms: torch.Tensor
    surf_ns: torch.Tensor
    edge_ns: torch.Tensor


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

    The octant slots are looked up ONCE at the predicted pose (in the
    surface map, and with ``use_edges`` in the edge map) and every round
    re-selects from them.  Round 1 always runs, at full width.  With
    ``icp_early_exit`` each further round runs only while the solve has
    not converged — one host read of the converged flag per round, the
    eager counterpart of the JAX ``while_loop``; without it every round
    runs with the converged solve frozen (the JAX ``scan``).  With
    ``refresh_width`` > 0 the candidates are reduced once at the round-1
    pose (the edges' to max(W, 2 * edge_knn) lanes), just after the read
    that lets round 2 run (a scan that converged in round 1 skips the
    reduction, as the JAX ``cond`` does), and rounds 2.. select from the
    reduced sets."""
    max_it = reg.max_icp_iters
    dtype, dev = surf_pts.dtype, surf_pts.device
    surf_pts = surf_pts.contiguous()
    edge_pts = edge_pts.contiguous()

    w_pt0 = pose0.apply(surf_pts).contiguous()
    surf_tab, slots = candidate_view(surf_map, w_pt0, map_cfg.cell_size)
    if use_edges:
        e_pt0 = pose0.apply(edge_pts).contiguous()
        edge_tab, e_slots = candidate_view(edge_map, e_pt0, map_cfg.cell_size)

    def correspondences(pose: Pose, w_pt, e_pt):
        """Full-width extraction; ``w_pt`` / ``e_pt`` = the features at
        ``pose``."""
        neigh, sq, nvalid, _ = knn_select(surf_tab, slots, w_pt,
                                          reg.plane_knn)
        planes = _plane_fit(neigh, sq, nvalid, reg, pose, surf_pts, surf_mask,
                            rt.plane_res, w_pt)
        lines = _edge_correspondences_from_slots(
            edge_tab, e_slots, reg, edge_pts, edge_mask, rt.line_res,
            e_pt) if use_edges else None
        return planes, lines

    rounds = torch.arange(max_it, device=dev)

    def n_valid(corrs):
        return torch.sum(corrs.valid.to(torch.int32)).to(torch.int32)

    def icp_round(c: _Carry, planes: PlaneCorrs, lines) -> _Carry:
        """One round from ``c`` on the correspondences extracted at
        ``c.pose``."""
        new_pose, one_step = gauss_newton_solve(
            c.pose, planes, lines, rt, reg.max_gn_iters, prior,
            use_edges=use_edges, a_mult=anneal_mult(reg, c.it, dtype),
            axis_hold_min=reg.axis_hold_min_matches,
            axis_hold_frac=reg.axis_hold_frac, hold_enabled=hold_enabled)
        new_pose = Pose(*(torch.where(c.converged, o, n)
                          for n, o in zip(new_pose, c.pose)))
        rel_t = torch.linalg.norm(new_pose.t - c.pose.t)
        dq = quat_mul(quat_conj(c.pose.q), new_pose.q)
        rel_r = 2.0 * torch.atan2(torch.linalg.norm(dq[1:4]), torch.abs(dq[0]))
        live = ~c.converged
        at = (rounds == torch.clamp_max(c.it, max_it - 1)) & live
        now_converged = c.converged | one_step | (
            (rel_t < reg.trans_converge_tol) & (rel_r < reg.rot_converge_tol))
        return _Carry(
            pose=new_pose, converged=now_converged,
            it=c.it + live.to(torch.int32), planes=planes, lines=lines,
            t_norms=torch.where(at, rel_t, c.t_norms),
            r_norms=torch.where(at, rel_r, c.r_norms),
            surf_ns=torch.where(at, n_valid(planes), c.surf_ns),
            edge_ns=torch.where(at, n_valid(lines), c.edge_ns)
            if use_edges else c.edge_ns)

    zeros_i = torch.zeros((max_it,), dtype=torch.int32, device=dev)
    c = icp_round(_Carry(
        pose=pose0, converged=torch.zeros((), dtype=torch.bool, device=dev),
        it=torch.zeros((), dtype=torch.int32, device=dev), planes=None,
        lines=None, t_norms=torch.zeros((max_it,), dtype=dtype, device=dev),
        r_norms=torch.zeros((max_it,), dtype=dtype, device=dev),
        surf_ns=zeros_i, edge_ns=zeros_i),
        *correspondences(pose0, w_pt0, e_pt0 if use_edges else None))
    red = red_e = None  # the reduced candidates, made when round 2 is to run
    ew = max(reg.refresh_width, 2 * reg.edge_knn)
    for _ in range(max_it - 1):
        if reg.icp_early_exit and bool(c.converged):
            break
        w_pt = c.pose.apply(surf_pts).contiguous()
        e_pt = c.pose.apply(edge_pts).contiguous() if use_edges else None
        if reg.refresh_width > 0:
            if red is None:
                red = reduce_candidates(surf_tab, slots, w_pt,
                                        reg.refresh_width)
                if use_edges:
                    red_e = reduce_candidates(edge_tab, e_slots, e_pt, ew)
            planes = plane_correspondences_from_reduced(
                red, reg, c.pose, surf_pts, surf_mask, rt.plane_res, w_pt)
            lines = edge_correspondences_from_reduced(
                red_e, reg, c.pose, edge_pts, edge_mask, rt.line_res,
                e_pt) if use_edges else None
        else:
            planes, lines = correspondences(c.pose, w_pt, e_pt)
        c = icp_round(c, planes, lines)
    pose, planes, lines, n_it = c.pose, c.planes, c.lines, c.it

    # one H at the final pose, at the last executed round's Tukey support
    H, _, _ = _accumulate_normal_system(
        pose, planes, lines, rt, prior, use_edges,
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
    line_codes = lines.code if use_edges else torch.full(
        (edge_pts.shape[0],), MATCH_UNKNOWN, dtype=torch.int32, device=dev)
    stats = IcpStats(
        iter_trans_norm=c.t_norms,
        iter_rot_norm=c.r_norms,
        iter_surf_num=c.surf_ns,
        iter_edge_num=c.edge_ns,
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
