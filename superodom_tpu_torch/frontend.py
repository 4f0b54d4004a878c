"""Scan frontend: feature gates, curvature edges (K11a), scan thinning in
its four modes (voxel claim, voxel centroid, r^2-stratified, none),
even-rate compaction, IMU undistortion and the 6-DoF undistortion against
an external (VIO) pose path (counterpart of ``superodom_tpu.frontend``).

Every array keeps its static width with a validity mask: no ``nonzero()``
and no boolean indexing, so the step never waits on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from superodom_tpu_torch import kernel_ops
from superodom_tpu_torch.geometry import (
    Pose,
    dot3,
    matrix_to_quat,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_slerp,
    so3_exp,
)
from superodom_tpu_torch.ops.voxel import (
    hash_coords_u32,
    true_div,
    uniform_stride_mask,
    voxel_coords,
    voxel_downsample_centroid,
    voxel_downsample_scatter,
)


class Scan(NamedTuple):
    """One LiDAR sweep as fixed-size masked tensors."""

    xyz: torch.Tensor  # f32[N,3] sensor frame
    t_rel: torch.Tensor  # f32[N] per-point time since scan start [s]
    mask: torch.Tensor  # bool[N]
    t_start: torch.Tensor  # f32 scalar, scan start time [s]
    ring: torch.Tensor  # i32[N] scan line id


class ImuWindow(NamedTuple):
    """IMU samples covering one scan, fixed capacity."""

    t: torch.Tensor  # f32[M] absolute sample times
    acc: torch.Tensor  # f32[M,3]
    gyr: torch.Tensor  # f32[M,3]
    q: torch.Tensor  # f32[M,4] propagated world orientation q_w_i
    mask: torch.Tensor  # bool[M]


class VioWindow(NamedTuple):
    """External (visual-inertial) odometry pose samples covering one scan,
    as T_w_lidar (removePointDistortion<Odometry> over visualOdomBuf,
    featureExtraction.cpp:236-249,462-468)."""

    t: torch.Tensor  # f32[K] absolute sample times
    q: torch.Tensor  # f32[K,4] lidar-frame world orientation
    p: torch.Tensor  # f32[K,3] lidar-frame world position
    mask: torch.Tensor  # bool[K]


def propagate_orientation(q0: torch.Tensor, gyr0: torch.Tensor,
                          t: torch.Tensor, gyr: torch.Tensor,
                          mask: torch.Tensor, t0) -> torch.Tensor:
    """Integrate gyro rates into per-sample orientations:
    q_i = q_{i-1} * exp(dt * (w_i + w_{i-1}) / 2)
    (reference updateImuOrientation, featureExtraction.cpp:574-583).

    ``q0``/``gyr0``/``t0`` are the previous window's last state so
    integration is continuous across windows; a masked-out sample repeats
    the previous orientation and leaves the state as it was.  A sequential
    loop over the window's samples, as JAX's ``lax.scan``."""
    q_prev, g_prev = q0, gyr0
    t_prev = torch.as_tensor(t0, dtype=t.dtype, device=t.device)
    qs = []
    for i in range(t.shape[0]):
        dt = torch.clamp(t[i] - t_prev, 0.0, 0.5)
        q_i = quat_normalize(quat_mul(q_prev,
                                      so3_exp(dt * 0.5 * (gyr[i] + g_prev))))
        q_i = torch.where(mask[i], q_i, q_prev)
        g_prev = torch.where(mask[i], gyr[i], g_prev)
        t_prev = torch.where(mask[i], t[i], t_prev)
        q_prev = q_i
        qs.append(q_i)
    return torch.stack(qs) if qs else q0.new_zeros((0, 4))


def _interp_pose_at(imu: ImuWindow, pos: torch.Tensor,
                    times: torch.Tensor) -> Pose:
    """Slerp-interpolated pose at arbitrary times from the IMU window,
    clamped to the window ends (featureExtraction.cpp:255-276).  The
    upper-bound index is a compare-and-count over the <= 64 samples."""
    valid_t = torch.where(imu.mask, imu.t, torch.inf)
    after = torch.sum((valid_t[None, :] <= times[:, None]).to(torch.int32),
                      dim=-1)
    n_valid = torch.sum(imu.mask.to(torch.int32))
    after = torch.minimum(torch.clamp_min(after, 1),
                          torch.clamp_min(n_valid - 1, 1))
    before = after - 1
    t0 = imu.t[before]
    t1 = imu.t[after]
    ratio = torch.clamp(
        (times - t0) / torch.clamp_min(t1 - t0, 1e-6), 0.0, 1.0)
    q = quat_slerp(imu.q[before], imu.q[after], ratio)
    p = (1.0 - ratio)[..., None] * pos[before] + ratio[..., None] * pos[after]
    return Pose(q, p)


def undistort_points(
    xyz: torch.Tensor,
    t_rel: torch.Tensor,
    mask: torch.Tensor,
    t_start,
    imu: ImuWindow,
    R_i_l: torch.Tensor,
    t_i_l: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotation-only IMU undistortion into the scan-start lidar frame
    (removePointDistortion<Imu>, featureExtraction.cpp:222-314).

    Returns (undistorted xyz, q_w_original_l, t_w_original_l)."""
    dtype, dev = xyz.dtype, xyz.device
    t_start = torch.as_tensor(t_start, dtype=dtype, device=dev)
    zeros = torch.zeros((imu.t.shape[0], 3), dtype=dtype, device=dev)
    q_w_start = _interp_pose_at(imu, zeros, t_start[None]).q[0]
    pt_pose = _interp_pose_at(imu, zeros, t_start + t_rel)

    q_rel = quat_mul(quat_normalize(quat_conj(q_w_start)).expand(
        pt_pose.q.shape), pt_pose.q)
    # conjugate by the imu->lidar extrinsic
    p_imu = xyz @ R_i_l.T + t_i_l
    p_out = (quat_rotate(q_rel, p_imu) - t_i_l) @ R_i_l
    out = torch.where(mask[:, None], p_out, xyz)
    q_w_original_l = quat_normalize(quat_mul(q_w_start, matrix_to_quat(R_i_l)))
    t_w_original_l = quat_rotate(q_w_start, t_i_l)
    return out, q_w_original_l, t_w_original_l


def undistort_scan(scan: Scan, imu: ImuWindow, R_i_l: torch.Tensor,
                   t_i_l: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-cloud undistortion (see :func:`undistort_points`)."""
    return undistort_points(scan.xyz, scan.t_rel, scan.mask, scan.t_start,
                            imu, R_i_l, t_i_l)


def undistort_points_posed(
    xyz: torch.Tensor,
    t_rel: torch.Tensor,
    mask: torch.Tensor,
    t_start,
    path_t: torch.Tensor,
    path_q: torch.Tensor,
    path_p: torch.Tensor,
    path_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Undistortion against a 6-DoF pose path in the lidar frame (rotation
    and translation, removePointDistortion<Odometry>,
    featureExtraction.cpp:236-249,462-468): p' = T_start^-1 T(t_point) p,
    in the JAX package's operation order.

    Returns (undistorted xyz, q_w_original, t_w_original)."""
    dtype, dev = xyz.dtype, xyz.device
    t_start = torch.as_tensor(t_start, dtype=dtype, device=dev)
    win = ImuWindow(t=path_t, acc=torch.zeros_like(path_p),
                    gyr=torch.zeros_like(path_p), q=path_q, mask=path_mask)
    start = _interp_pose_at(win, path_p, t_start[None])
    q0, p0 = start.q[0], start.t[0]
    pt_pose = _interp_pose_at(win, path_p, t_start + t_rel)
    inv_q = quat_normalize(quat_conj(q0))
    rel_q = quat_mul(inv_q.expand(pt_pose.q.shape), pt_pose.q)
    rel_t = quat_rotate(inv_q[None, :], pt_pose.t - p0[None, :])
    out = quat_rotate(rel_q, xyz) + rel_t
    out = torch.where(mask[:, None], out, xyz)
    return out, q0, p0


def uniform_feature_gates(xyz, prev, mask, min_range: float,
                          max_range: float, skip_dup: bool = False):
    """Point-quality gates of uniformFeatureExtraction (duplicate, blind
    zone, max range, finite) without the stride selection.  ``skip_dup``:
    the duplicate gate already ran on host (runner.make_scan)."""
    rng_sq = torch.sum(xyz * xyz, dim=-1)
    out = (mask & (rng_sq > min_range ** 2) & (rng_sq < max_range ** 2)
           & torch.all(torch.isfinite(xyz), dim=-1))
    if not skip_dup:
        if prev.shape != xyz.shape:
            raise ValueError(
                f"prev.shape {tuple(prev.shape)} != xyz.shape "
                f"{tuple(xyz.shape)}; pass skip_dup=True when the duplicate "
                "gate already ran on host")
        out = out & ~torch.all(torch.abs(xyz - prev) <= 1e-7, dim=-1)
    return out


def decimated_width(max_points: int, stride: int) -> int:
    """Lane count of the host-decimated scan layout."""
    return len(range(1, max_points, stride))


def uniform_feature_extraction(xyz, mask, stride: int, min_range: float,
                               max_range: float):
    """Every ``stride``-th point through the quality gates (reference
    uniformFeatureExtraction, featureExtraction.cpp:504-525)."""
    stride_m = uniform_stride_mask(xyz.shape[0], stride, xyz.device)
    prev = torch.roll(xyz, 1, dims=0)
    return stride_m & uniform_feature_gates(xyz, prev, mask, min_range,
                                            max_range)


def curvature_edge_extraction_reference(xyz, ring, mask,
                                        half_window: int = 5,
                                        curvature_threshold: float = 0.2,
                                        min_range: float = 0.5):
    """Plain version of K11a: LOAM-style edges, the local curvature along
    each scan line, c_i = |sum_{0<|j|<=w} (p_{i+j} - p_i)| / (2w |p_i|),
    over rolled (wrapping) lanes gated to the same ring and live
    neighbours; a lane is an edge when all 2w neighbours pass that gate,
    c_i exceeds the threshold and |p_i| > min_range.  Returns bool[N]."""
    rng_norm = torch.sqrt(dot3(xyz, xyz))
    acc = torch.zeros_like(xyz)
    neigh_ok = torch.ones_like(mask)
    for off in range(-half_window, half_window + 1):
        if off == 0:
            continue
        same = (torch.roll(ring, -off, 0) == ring) & torch.roll(mask, -off, 0)
        acc = acc + torch.where(same[:, None], torch.roll(xyz, -off, 0) - xyz,
                                0.0)
        neigh_ok = neigh_ok & same
    curv = torch.sqrt(dot3(acc, acc)) / (
        2.0 * half_window * torch.clamp_min(rng_norm, 1e-6))
    return mask & neigh_ok & (curv > curvature_threshold) & (
        rng_norm > min_range)


def curvature_edge_extraction(xyz, ring, mask, half_window: int = 5,
                              curvature_threshold: float = 0.2,
                              min_range: float = 0.5):
    """K11a: see :func:`curvature_edge_extraction_reference` for the
    contract."""
    if xyz.is_cuda:
        return kernel_ops.curvature_edges(
            xyz.contiguous(), ring.to(torch.int32).contiguous(),
            mask.contiguous(), half_window, float(curvature_threshold),
            float(min_range))
    if xyz.device.type == "cpu":
        return curvature_edge_extraction_reference(
            xyz, ring, mask, half_window, curvature_threshold, min_range)
    raise ValueError(f"curvature_edge_extraction: unsupported device "
                     f"{xyz.device}")


def range_stratified_mask(xyz: torch.Tensor, mask: torch.Tensor,
                          target: int) -> torch.Tensor:
    """Scatter-free spatial thinning: keep probability ~ r^2, thresholded
    against a position-keyed hash (stable per surface patch)."""
    r_sq = torch.sum(xyz * xyz, dim=-1)
    r_cap = torch.clamp_max(r_sq, 1e4)
    total = torch.clamp_min(torch.sum(r_cap * mask.to(xyz.dtype)), 1.0)
    scale = true_div(torch.full_like(total, float(target)), total)
    p = torch.clamp(r_cap * scale, 0.0, 1.0)
    h = hash_coords_u32(voxel_coords(xyz, 0.1), 1)
    u = h.to(torch.float32) * (1.0 / 4294967296.0)
    return mask & (u < p)


def select_features(xyz: torch.Tensor, mask: torch.Tensor, capacity: int,
                    *extras: torch.Tensor):
    """Compact the masked lanes into ``capacity`` lanes at an even rate
    (LidarSlam.cpp:346-359), in input order.  As with ``lax.top_k`` in the
    JAX package, the padding lanes are the lowest-index unselected lanes:
    a stable descending sort of the same keys gives the same lanes."""
    n = xyz.shape[0]
    count = torch.clamp_min(torch.sum(mask.to(torch.int32)).to(xyz.dtype), 1.0)
    rate = torch.clamp_max(true_div(torch.full_like(count, float(capacity)),
                                    count), 1.0)
    rank = (torch.cumsum(mask.to(torch.int32), dim=0) - 1).to(xyz.dtype)
    sel = mask & (torch.floor(rank * rate) > torch.floor((rank - 1.0) * rate))
    lane = torch.arange(n, dtype=torch.int32, device=xyz.device)
    keys = torch.where(sel, n - lane, 0)
    idx = torch.sort(keys, descending=True, stable=True).indices[:capacity]
    return (xyz[idx], sel[idx]) + tuple(e[idx] for e in extras)


def thin_and_select(xyz, mask, res, capacity: int, compact_width: int,
                    *extras, mode: str = "voxel", table_bits: int = 0):
    """Spatially thin masked lanes, then compact to ``capacity`` feature
    lanes (the role of the reference's downSizeFilterSurf).

    * ``"voxel"`` — scatter-claim one point per ``res`` voxel (K10,
      :func:`ops.voxel.voxel_downsample_scatter`); a cloud wider than
      ``compact_width`` is compacted to that width first.  ``table_bits``
      sizes the claim table: a caller that pre-slices lanes passes the
      pre-slice width's value, so that the survivor set follows the sensor
      and not the slice.
    * ``"centroid"`` — per-voxel centroids, extras averaged (PCL VoxelGrid
      semantics), by two stable sorts.
    * ``"range"`` — r^2-stratified hash thinning
      (:func:`range_stratified_mask`).
    * ``"none"`` — even-rate decimation only."""
    if mode not in ("voxel", "centroid", "range", "none"):
        raise ValueError(f"unknown scan_thin_mode {mode!r}")
    if mode == "range":
        keep = range_stratified_mask(xyz, mask, 3 * capacity)
        return select_features(xyz, keep, capacity, *extras)
    if mode == "none":
        return select_features(xyz, mask, capacity, *extras)
    if xyz.shape[0] > compact_width:
        xyz, mask, *extras = select_features(xyz, mask, compact_width,
                                             *extras)
    if mode == "centroid":
        out = voxel_downsample_centroid(xyz, mask, res, *extras)
        return select_features(out[0], out[1], capacity, *out[2:])
    keep = voxel_downsample_scatter(xyz, mask, res, table_bits=table_bits)
    return select_features(xyz, keep, capacity, *extras)
