"""The odometry step: ``step(cfg, state, scan, imu, imu_available) ->
(state', output)`` (counterpart of ``superodom_tpu.pipeline``).

One scan runs, in order: feature gates, scan thinning and even-rate
compaction, with ``use_edge_features`` curvature edges (K11a) and their
voxel thinning, IMU undistortion with the constant-velocity and
translation de-skews, with ``use_vio_undistortion`` and a VIO window the
6-DoF undistortion against the external pose path and the refresh of the
VIO pose prior, prediction-source selection, scan-to-map ICP (with the
prior under degeneracy), motion gates, map insert and eviction (the edge
map's too; none with a frozen localization map), and the inertial
smoother.  Decisions that JAX makes with ``jnp.where`` stay device-side
selections here, so a step waits on the host only for the ICP early-exit
flag and, where a map cadence is not 1, for the frame count.

The step is pure: it never modifies ``state``.
:func:`make_chunked_step_fn` replays a chunk of stacked scans through
:func:`step`, with the IMU-rate stream of each scan beside its outputs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from superodom_tpu_torch import kernels
from superodom_tpu_torch.config import MapConfig, PipelineConfig, RuntimeParams
from superodom_tpu_torch.frontend import (
    ImuWindow,
    Scan,
    VioWindow,
    curvature_edge_extraction,
    decimated_width,
    thin_and_select,
    undistort_points,
    undistort_points_posed,
    uniform_feature_extraction,
    uniform_feature_gates,
)
from superodom_tpu_torch.geometry import (
    Pose,
    matrix_to_quat,
    pose_delta,
    quat_conj,
    quat_from_rpy,
    quat_identity,
    quat_mul,
    quat_normalize,
    quat_rotate,
    rpy_from_quat,
    so3_exp,
    so3_log,
)
from superodom_tpu_torch.inertial import (
    SmootherState,
    preintegrate,
    propagate_high_rate,
    propagate_state,
    smoother_init,
    smoother_update,
)
from superodom_tpu_torch.mapstate import (
    VoxelHashMap,
    census_box,
    empty_map,
    evict_far,
    insert,
    shard_map_table,
    unshard,
)
from superodom_tpu_torch.ops import invariant as inv
from superodom_tpu_torch.registration import IcpStats, PosePrior, icp_register

# PredictionSource enum (reference LidarSlam.h:50-52)
PRED_IMU_ORIENTATION = 0
PRED_LIO_ODOM = 1
PRED_VIO_ODOM = 2
PRED_NEURAL_IMU_ODOM = 3
PRED_CONSTANT_VELOCITY = 4


class OdomState(NamedTuple):
    """Full estimator state (field meanings: ``superodom_tpu.pipeline``)."""

    pose: Pose
    pose_prev: Pose
    q_odom_pre: torch.Tensor
    startup_count: torch.Tensor
    initialized: torch.Tensor
    frame_count: torch.Tensor
    last_time: torch.Tensor
    rt: RuntimeParams
    edge_map: VoxelHashMap  # or a mapstate.ShardedMap
    surf_map: VoxelHashMap  # or a mapstate.ShardedMap
    smoother: SmootherState
    degenerate: torch.Tensor
    uncertainty: torch.Tensor
    obs_ema: torch.Tensor
    vio_pose: Pose
    vio_available: torch.Tensor
    prev_imu: ImuWindow


class StepOutput(NamedTuple):
    """Everything the reference publishes per scan."""

    pose: Pose
    smoothed_pose: Pose
    vel_body: torch.Tensor
    ang_vel_body: torch.Tensor
    acc_bias: torch.Tensor
    gyr_bias: torch.Tensor
    prediction_source: torch.Tensor
    icp: IcpStats
    surf_stack_num: torch.Tensor
    edge_stack_num: torch.Tensor
    surf_map_num: torch.Tensor
    edge_map_num: torch.Tensor
    average_distance: torch.Tensor
    motion_accepted: torch.Tensor
    imu_healthy: torch.Tensor
    translation_from_last: torch.Tensor
    rotation_from_last: torch.Tensor
    total_translation: torch.Tensor
    total_rotation: torch.Tensor


def _scalar(v, dtype, device):
    return torch.full((), v, dtype=dtype, device=device)


def empty_imu_window(m: int, dtype=torch.float32, device=None) -> ImuWindow:
    """All-masked-out IMU window (identity orientations)."""
    return ImuWindow(
        t=torch.zeros((m,), dtype=dtype, device=device),
        acc=torch.zeros((m, 3), dtype=dtype, device=device),
        gyr=torch.zeros((m, 3), dtype=dtype, device=device),
        q=quat_identity(dtype, device)[None].repeat(m, 1),
        mask=torch.zeros((m,), dtype=torch.bool, device=device),
    )


def empty_vio_window(k: int, dtype=torch.float32, device=None) -> VioWindow:
    """All-masked-out external-odometry window."""
    return VioWindow(
        t=torch.zeros((k,), dtype=dtype, device=device),
        q=quat_identity(dtype, device)[None].repeat(k, 1),
        p=torch.zeros((k, 3), dtype=dtype, device=device),
        mask=torch.zeros((k,), dtype=torch.bool, device=device),
    )


def edge_map_config(cfg: PipelineConfig) -> MapConfig:
    """The edge map's table config: full-size with edge features on,
    minimal otherwise."""
    import dataclasses

    if cfg.use_edge_features:
        return cfg.map
    return dataclasses.replace(cfg.map, table_size=64, bucket_size=8,
                               cell_capacity=4)


def init_state(cfg: PipelineConfig, dtype=torch.float32,
               device=None, shard_devices=None) -> OdomState:
    """The state before the first scan on ``device``; with
    ``shard_devices`` both maps split over them (:func:`shard_state`)."""
    if shard_devices is not None:
        return shard_state(init_state(cfg, dtype, device), shard_devices)
    loc = cfg.localization
    if loc.enabled:
        q0 = quat_from_rpy(*[_scalar(v, dtype, device)
                             for v in loc.init_pose_rpy])
        t0 = torch.tensor(loc.init_pose_xyz, dtype=dtype, device=device)
    else:
        q0 = quat_identity(dtype, device)
        t0 = torch.zeros(3, dtype=dtype, device=device)
    pose0 = Pose(q0, t0)
    return OdomState(
        pose=pose0,
        pose_prev=pose0,
        q_odom_pre=quat_identity(dtype, device),
        startup_count=_scalar(cfg.startup_frames, torch.int32, device),
        initialized=_scalar(False, torch.bool, device),
        frame_count=_scalar(0, torch.int32, device),
        last_time=_scalar(0.0, dtype, device),
        rt=RuntimeParams(
            line_res=_scalar(cfg.sensor.default_line_res, dtype, device),
            plane_res=_scalar(cfg.sensor.default_plane_res, dtype, device),
        ),
        edge_map=empty_map(edge_map_config(cfg), dtype, device),
        surf_map=empty_map(cfg.map, dtype, device),
        smoother=smoother_init(cfg.imu, dtype, device),
        degenerate=_scalar(False, torch.bool, device),
        uncertainty=torch.zeros((6,), dtype=dtype, device=device),
        obs_ema=torch.zeros((3,), dtype=dtype, device=device),
        vio_pose=Pose.identity(dtype, device),
        vio_available=_scalar(False, torch.bool, device),
        prev_imu=empty_imu_window(cfg.imu.max_imu_per_scan, dtype, device),
    )


def shard_state(state: OdomState, devices) -> OdomState:
    """``state`` (one instance's or a fleet's) with both maps split over
    ``devices``, one shard a device (``mapstate.shard_map_table``; a
    single device takes the whole table), every other leaf where it is."""
    def split(m):
        m = unshard(m)
        if len(devices) == 1:
            return tree_map(lambda x: x.to(devices[0]), m)
        return shard_map_table(m, devices)

    return state._replace(surf_map=split(state.surf_map),
                          edge_map=split(state.edge_map))


def unshard_state(state: OdomState) -> OdomState:
    """``state`` with both maps whole, each on its shard 0's device."""
    return state._replace(surf_map=unshard(state.surf_map),
                          edge_map=unshard(state.edge_map))


OBS_EMA_DECAY = 0.8  # per-accepted-frame decay of the observability EMA


def update_obs_ema(obs_ema, uncertainty3, run_icp):
    """Per-axis translation-observability EMA, advanced only on frames
    whose solve ran."""
    return torch.where(
        run_icp, OBS_EMA_DECAY * obs_ema + (1.0 - OBS_EMA_DECAY) * uncertainty3,
        obs_ema)


def lio_obs_trusted(degenerate, obs_ema, min_observability: float,
                    obs_inst=None):
    """LIO-prediction trust gate: trust when the last solve was healthy,
    or when every translation axis holds a real feature share, both in
    the EMA and (with ``obs_inst``) in the last solve."""
    trusted = ~degenerate
    if min_observability > 0.0:
        share_ok = torch.min(obs_ema) > min_observability
        if obs_inst is not None:
            share_ok = share_ok & (torch.min(obs_inst) > min_observability)
        trusted = trusted | share_ok
    return trusted


def _where_pose(c, a: Pose, b: Pose) -> Pose:
    return Pose(torch.where(c, a.q, b.q), torch.where(c, a.t, b.t))


def _extract_roll_pitch(q: torch.Tensor) -> torch.Tensor:
    """Zero the yaw component (utils::extractRollPitch)."""
    roll, pitch, _ = rpy_from_quat(q)
    return quat_from_rpy(roll, pitch, torch.zeros_like(roll))


def _select_prediction(cfg: PipelineConfig, state: OdomState,
                       q_imu: torch.Tensor, imu_available: torch.Tensor,
                       lio_pose: Pose | None = None,
                       lio_available: torch.Tensor | None = None):
    """Prediction-source state machine (laserMapping.cpp:264-412): first
    frame from IMU roll/pitch, IMU orientation during startup, then IMU
    orientation (holding position) or constant velocity; with
    ``lio_pose`` the smoother state propagated to the scan where it is
    available and trusted (:func:`lio_obs_trusted`); VIO under
    degeneracy when an external pose is available."""
    dtype, dev = state.pose.t.dtype, state.pose.t.device
    R_il = torch.tensor(np.asarray(cfg.extrinsics.R_imu_laser), dtype=dtype,
                        device=dev)
    q_extr = quat_normalize(matrix_to_quat(R_il))

    q_first = quat_normalize(quat_mul(quat_conj(q_extr),
                                      _extract_roll_pitch(q_imu)))
    q_first = torch.where(imu_available, q_first,
                          quat_identity(dtype, dev))
    first_pose = Pose(q_first, torch.zeros(3, dtype=dtype, device=dev))
    if cfg.localization.enabled:
        first_pose = state.pose  # configured init pose

    startup_pose = Pose(torch.where(imu_available, q_imu, state.pose.q),
                        state.pose.t)

    use_vio = state.degenerate & state.vio_available
    # IMU orientation: q_pred = q_curr * q_pre^-1 * q_now, position held
    q_pred = quat_normalize(
        quat_mul(state.pose.q, quat_mul(quat_conj(state.q_odom_pre), q_imu)))
    cv_pose = state.pose.compose(state.pose_prev.inverse().compose(state.pose))
    normal_pose = _where_pose(imu_available, Pose(q_pred, state.pose.t),
                              cv_pose)
    source = torch.where(imu_available, PRED_IMU_ORIENTATION,
                         PRED_CONSTANT_VELOCITY)
    if lio_pose is not None:
        trusted = lio_obs_trusted(state.degenerate, state.obs_ema,
                                  cfg.lio_min_observability,
                                  obs_inst=state.uncertainty[:3])
        use_lio = lio_available & imu_available & trusted
        normal_pose = _where_pose(use_lio, lio_pose, normal_pose)
        source = torch.where(use_lio, PRED_LIO_ODOM, source)
    normal_pose = _where_pose(use_vio, state.vio_pose, normal_pose)
    source = torch.where(use_vio, PRED_VIO_ODOM, source).to(torch.int32)

    in_startup = (state.startup_count > 0) & state.initialized
    pred = _where_pose(in_startup, startup_pose, normal_pose)
    pred = _where_pose(state.initialized, pred, first_pose)
    source = torch.where(state.initialized & ~in_startup, source,
                         PRED_IMU_ORIENTATION).to(torch.int32)
    return pred, source, use_vio


def _adjust_voxel_size(cfg: PipelineConfig, rt: RuntimeParams, xyz, mask):
    """Scene-scale adaptive resolutions (laserMapping.cpp:600-651)."""
    w = mask.to(xyz.dtype)
    # ops.invariant's sum: an instance's bits under vmap do not depend on
    # the batch
    n = torch.clamp_min(inv.reduce_sum(w), 1.0)
    avg = inv.reduce_sum(torch.abs(xyz) * w[:, None], 0) / n
    average_distance = avg[0] * avg[1] * avg[2]
    if not cfg.auto_voxel_size:
        return rt, average_distance
    near = average_distance < 25.0
    far = average_distance > 65.0
    line = torch.where(near, 0.1, torch.where(far, 0.4, rt.line_res))
    plane = torch.where(near, 0.2, torch.where(far, 0.8, rt.plane_res))
    return RuntimeParams(line_res=line.to(xyz.dtype),
                         plane_res=plane.to(xyz.dtype)), average_distance


def _vio_covers(scan: Scan, vio: VioWindow) -> torch.Tensor:
    """Sweep-coverage gate of the external pose path: >= 2 samples
    spanning [t_start, t_end], t_end the scan's latest masked point time
    (synchronize_measurements, featureExtraction.cpp:171-217)."""
    n = torch.sum(vio.mask.to(torch.int32))
    tmin = torch.min(torch.where(vio.mask, vio.t, torch.inf))
    tmax = torch.max(torch.where(vio.mask, vio.t, -torch.inf))
    t_end = scan.t_start + torch.max(torch.where(scan.mask, scan.t_rel, 0.0))
    return (n >= 2) & (tmin <= scan.t_start + 1e-6) & (tmax + 1e-6 >= t_end)


def _vio_information(state, surf_mask, reg, dtype):
    """Per-axis information of the absolute-pose constraint under
    degeneracy (LidarSlam.cpp:285-298)."""
    n_feat = torch.sum(surf_mask.to(dtype))
    vcf = reg.visual_confidence_factor
    unc = state.uncertainty
    w_t = (1.0 - unc[:3]) * torch.clamp_min(n_feat * 0.1, 50.0) * vcf
    w_rp = (torch.clamp_min(n_feat * 0.01, 10.0) * vcf).expand(2)
    return torch.cat([w_t, w_rp, torch.zeros((1,), dtype=dtype,
                                             device=unc.device)])


class _Stages:
    """Consecutive named profiler ranges over the stages of one step
    ("step.frontend", "step.registration", ...): visible in torch.profiler
    traces, a few microseconds each when no profiler runs."""

    def __init__(self):
        self._cur = None

    def __call__(self, name: str):
        self.close()
        self._cur = torch.profiler.record_function("step." + name)
        self._cur.__enter__()

    def close(self):
        if self._cur is not None:
            self._cur.__exit__(None, None, None)
            self._cur = None


def step(cfg: PipelineConfig, state: OdomState, scan: Scan, imu: ImuWindow,
         imu_available: torch.Tensor, vio: VioWindow | None = None
         ) -> Tuple[OdomState, StepOutput]:
    """Process one scan end to end (laserMapping::process with the feature
    extraction ahead of it and the inertial smoother after it).  ``vio``
    (an external 6-DoF pose path over the sweep) is read only with
    ``cfg.use_vio_undistortion``; without a window the flag is ignored, as
    in the JAX package.  Under ``torch.func.vmap`` (a fleet,
    ``parallel.make_batched_step``) the step reads nothing on the host:
    the map cadence is decided per instance on the device, and ICP early
    exit must be off."""
    batched = kernels.under_vmap(state.frame_count)
    if batched and cfg.registration.icp_early_exit:
        raise ValueError("the batched step runs fixed-count ICP: turn "
                         "icp_early_exit off")
    use_vio_path = cfg.use_vio_undistortion and vio is not None
    dtype, dev = scan.xyz.dtype, scan.xyz.device
    sensor = cfg.sensor
    reg = cfg.registration
    R_il = torch.tensor(np.asarray(cfg.extrinsics.R_imu_laser), dtype=dtype,
                        device=dev)
    t_il = torch.tensor(np.asarray(cfg.extrinsics.t_imu_laser), dtype=dtype,
                        device=dev)
    imu_available = torch.as_tensor(imu_available, device=dev)

    stage = _Stages()
    # ---------------- frontend: extract features, then undistort ----------
    stage("frontend")
    if scan.xyz.shape[0] < sensor.max_points:  # host-decimated layout
        if cfg.use_edge_features:
            raise ValueError(
                "edge extraction needs the full ring-major cloud; pass "
                "full-width scans when use_edge_features=True")
        w = decimated_width(sensor.max_points, sensor.filter_point_size)
        if scan.xyz.shape[0] != w:
            raise ValueError(
                f"scan width {scan.xyz.shape[0]} is neither max_points "
                f"({sensor.max_points}) nor the decimated width ({w})")
        feat_mask = uniform_feature_gates(scan.xyz, None, scan.mask,
                                          sensor.min_range, sensor.max_range,
                                          skip_dup=True)
    else:
        feat_mask = uniform_feature_extraction(
            scan.xyz, scan.mask, sensor.filter_point_size, sensor.min_range,
            sensor.max_range)
    rt, average_distance = _adjust_voxel_size(cfg, state.rt, scan.xyz,
                                              feat_mask)
    surf_raw, surf_mask, surf_trel = thin_and_select(
        scan.xyz, feat_mask, rt.plane_res, sensor.max_surface_features,
        sensor.compact_width, scan.t_rel, mode=sensor.scan_thin_mode,
        table_bits=max((sensor.max_points * 4 - 1).bit_length(), 4))
    surf_u, q_w_orig_l, _ = undistort_points(
        surf_raw, surf_trel, surf_mask, scan.t_start, imu, R_il, t_il)
    surf_pts = torch.where(imu_available, surf_u, surf_raw)
    q_imu_pred = torch.where(imu_available, q_w_orig_l,
                             quat_identity(dtype, dev))

    # de-skews only past the startup window (the early twist is garbage)
    settled = state.frame_count > cfg.startup_frames
    if cfg.use_cv_undistortion:
        # constant-velocity de-skew for IMU-less sweeps
        rel = state.pose_prev.inverse().compose(state.pose)
        nominal = sensor.scan_period * max(sensor.skip_frame, 1)
        rot_vec = so3_log(rel.q)
        sane = (torch.linalg.norm(rel.t) < 2.0) & (
            torch.linalg.norm(rot_vec) < 0.5)
        use_cv = ~imu_available & state.initialized & sane & settled
        s = (surf_trel / nominal)[:, None]
        cv = quat_rotate(so3_exp(s * rot_vec[None, :]), surf_raw) \
            + s * rel.t[None, :]
        cv = torch.where(surf_mask[:, None], cv, surf_raw)
        surf_pts = torch.where(use_cv, cv, surf_pts)
    if cfg.use_translation_deskew:
        # translation de-skew for IMU-covered sweeps, from the smoother's
        # body-frame velocity
        v_b = quat_rotate(quat_conj(state.smoother.q[-1]),
                          state.smoother.v[-1])
        smoother_ok = state.smoother.valid[-1] & ~state.smoother.failed
        v_sane = torch.linalg.norm(v_b) < cfg.imu.max_velocity
        use_trans = (imu_available & state.initialized & smoother_ok
                     & v_sane & settled)
        tr = torch.where(surf_mask[:, None],
                         surf_trel[:, None] * v_b[None, :], 0.0)
        surf_pts = torch.where(use_trans, surf_u + tr, surf_pts)
    if use_vio_path:
        # 6-DoF undistortion where the external path covers the sweep
        vio_ok = _vio_covers(scan, vio)
        surf_v, q_vio0, p_vio0 = undistort_points_posed(
            surf_raw, surf_trel, surf_mask, scan.t_start, vio.t, vio.q,
            vio.p, vio.mask)
        surf_pts = torch.where(vio_ok, surf_v, surf_pts)
    if cfg.use_edge_features:
        # curvature edges over every raw lane, voxel-thinned at line_res
        # after an even-rate compaction to compact_width // 2 lanes
        em_full = curvature_edge_extraction(
            scan.xyz, scan.ring, scan.mask,
            curvature_threshold=cfg.edge_curvature_threshold,
            min_range=sensor.min_range)
        edge_raw, edge_mask, edge_trel = thin_and_select(
            scan.xyz, em_full, rt.line_res, sensor.max_edge_features,
            sensor.compact_width // 2, scan.t_rel)
        edge_u, _, _ = undistort_points(
            edge_raw, edge_trel, edge_mask, scan.t_start, imu, R_il, t_il)
        edge_pts = torch.where(imu_available, edge_u, edge_raw)
        if cfg.use_cv_undistortion:
            se = (edge_trel / nominal)[:, None]
            cv_e = quat_rotate(so3_exp(se * rot_vec[None, :]), edge_raw) \
                + se * rel.t[None, :]
            cv_e = torch.where(edge_mask[:, None], cv_e, edge_raw)
            edge_pts = torch.where(use_cv, cv_e, edge_pts)
        if cfg.use_translation_deskew:
            tr_e = torch.where(edge_mask[:, None],
                               edge_trel[:, None] * v_b[None, :], 0.0)
            edge_pts = torch.where(use_trans, edge_u + tr_e, edge_pts)
        if use_vio_path:
            edge_v, _, _ = undistort_points_posed(
                edge_raw, edge_trel, edge_mask, scan.t_start, vio.t, vio.q,
                vio.p, vio.mask)
            edge_pts = torch.where(vio_ok, edge_v, edge_pts)
    else:
        # slim-release parity: empty edge clouds (featureExtraction.cpp:429)
        edge_pts = torch.zeros((sensor.max_edge_features, 3), dtype=dtype,
                               device=dev)
        edge_mask = torch.zeros((sensor.max_edge_features,),
                                dtype=torch.bool, device=dev)

    # ---------------- prediction ------------------------------------------
    stage("prediction")
    if use_vio_path:
        # a covering window refreshes the VIO pose and its availability for
        # this scan; availability is per-scan freshness, so a stream that
        # drops out leaves no stale prior
        state = state._replace(
            vio_pose=_where_pose(vio_ok, Pose(q_vio0, p_vio0),
                                 state.vio_pose),
            vio_available=vio_ok)
    lidar2imu = Pose(matrix_to_quat(R_il), t_il)
    # the previous interval, preintegrated once: the LIO source and the
    # smoother share it
    pre = preintegrate(state.prev_imu, state.smoother.ba[-1],
                       state.smoother.bg[-1], rate=cfg.imu.imu_rate)
    lio_pose = lio_available = None
    if cfg.enable_lio_prediction:
        q_lio, p_lio, _ = propagate_state(state.smoother, cfg.imu, pre)
        lio_pose = Pose(q_lio, p_lio).compose(lidar2imu.inverse())
        # trusted once the window has history and the interval carries
        # IMU samples
        lio_available = (state.smoother.valid[0] & ~state.smoother.failed
                         & (pre.dt > 1e-3) & torch.any(state.prev_imu.mask))
    pred_pose, source, use_vio = _select_prediction(
        cfg, state, q_imu_pred, imu_available, lio_pose, lio_available)

    # ---------------- scan-to-map registration ----------------------------
    stage("registration")
    half_extent = torch.tensor([125.0, 125.0, 75.0], dtype=dtype, device=dev)
    surf_map_num = census_box(state.surf_map, cfg.map, pred_pose.t,
                              half_extent)
    edge_map_num = census_box(state.edge_map, cfg.map, pred_pose.t,
                              half_extent)
    enough = surf_map_num > reg.min_map_surf_features
    prior = PosePrior(pose=state.vio_pose,
                      information=_vio_information(state, surf_mask, reg,
                                                   dtype),
                      enabled=use_vio)
    # the per-axis match-count hold is armed only while the map is young
    hold_enabled = (state.startup_count > 0) | (
        state.frame_count <= cfg.startup_frames)
    reg_pose, icp_stats = icp_register(
        state.edge_map, state.surf_map, cfg.map, reg, pred_pose, edge_pts,
        edge_mask, surf_pts, surf_mask, rt, prior,
        use_edges=cfg.use_edge_features, hold_enabled=hold_enabled)
    # accepted correspondences: the planes' successes, and the lines' with
    # edges on
    n_matches = icp_stats.plane_rejection_hist[0]
    if cfg.use_edge_features:
        n_matches = n_matches + icp_stats.line_rejection_hist[0]
    enough_matches = n_matches >= reg.min_plane_matches
    run_icp = state.initialized & enough & enough_matches
    pose = _where_pose(run_icp, reg_pose, pred_pose)
    finite = torch.all(torch.isfinite(pose.t)) & torch.all(
        torch.isfinite(pose.q))
    pose = _where_pose(finite, pose, pred_pose)

    # ---------------- post-optimization (LidarSlam.cpp:155-210) -----------
    stage("motion_gates")
    trans_from_last, rot_from_last = pose_delta(state.pose, pose)
    if reg.yaw_ratio != 0.0:
        roll, pitch, yaw = rpy_from_quat(pose.q)
        yaw = yaw + trans_from_last * (reg.yaw_ratio * np.pi / 180.0)
        pose = Pose(quat_from_rpy(roll, pitch, yaw), pose.t)

    t_start = torch.as_tensor(scan.t_start, dtype=dtype, device=dev)
    dt_scan = t_start - state.last_time
    vel_gate = torch.where(
        state.initialized & (dt_scan > 1e-6),
        trans_from_last / torch.clamp_min(dt_scan, 1e-6)
        < reg.velocity_failure_threshold,
        True)
    small_motion = (trans_from_last < 0.02) & (rot_from_last < 0.005)
    accepted = vel_gate & ~small_motion
    pose = _where_pose(accepted, pose, state.pose)
    startup_count = torch.where(
        ~vel_gate, 5, torch.clamp_min(state.startup_count - 1, 0)
    ).to(torch.int32)

    # ---------------- map update ------------------------------------------
    # insert and evict on their cadences (the first 8 frames always insert,
    # to seed the map).  Eager code skips the work outright: one host read
    # of the frame count decides, made only where a cadence is not 1.  The
    # batched step decides per instance on the device instead: both
    # branches run and torch.where picks (JAX's lax.cond under vmap)
    stage("map_update")
    do_update_map = (not cfg.localization.enabled) \
        or cfg.localization.update_map
    ic, ec = cfg.map.insert_cadence, cfg.map.evict_cadence
    do_insert = do_evict = True
    if batched:
        frame = state.frame_count
        if ic != 1:
            do_insert = (frame % ic == 0) | (frame < 8)
        if ec != 1:
            do_evict = frame % ec == 0
    elif ic != 1 or ec != 1:
        frame = int(state.frame_count)
        do_insert = ic == 1 or frame % ic == 0 or frame < 8
        do_evict = frame % ec == 0

    def cadenced(do, update, m):
        if isinstance(do, bool):
            return update(m) if do else m
        return tree_map(lambda new, old: torch.where(do.to(new.device), new,
                                                     old), update(m), m)

    surf_map = cadenced(do_insert, lambda m: insert(
        m, cfg.map, pose.apply(surf_pts), surf_mask & do_update_map,
        rt.plane_res), state.surf_map)
    surf_map = cadenced(do_evict, lambda m: evict_far(m, cfg.map, pose.t),
                        surf_map)
    edge_map = state.edge_map
    if cfg.use_edge_features:
        edge_map = cadenced(do_insert, lambda m: insert(
            m, cfg.map, pose.apply(edge_pts), edge_mask & do_update_map,
            rt.line_res), edge_map)
        edge_map = cadenced(do_evict, lambda m: evict_far(m, cfg.map,
                                                          pose.t), edge_map)

    # ---------------- inertial smoother -----------------------------------
    stage("smoother")
    smoother, smoothed_imu = smoother_update(
        state.smoother, cfg.imu, pose.compose(lidar2imu), t_start,
        state.prev_imu, pre=pre)
    smoothed_pose = smoothed_imu.compose(lidar2imu.inverse())

    # ---------------- body velocities (laserMapping.cpp:744-758) ----------
    stage("outputs")
    inv_dt = torch.clamp_min(dt_scan, 1e-6)
    vel_body = quat_rotate(quat_conj(pose.q), (pose.t - state.pose.t) / inv_dt)
    dq = quat_mul(pose.q, quat_conj(state.pose.q))
    ang_vel_body = quat_rotate(quat_conj(pose.q), so3_log(dq) / inv_dt)
    zero_v = ~state.initialized | (dt_scan <= 1e-6)
    vel_body = torch.where(zero_v, 0.0, vel_body)
    ang_vel_body = torch.where(zero_v, 0.0, ang_vel_body)

    total_trans, total_rot = pose_delta(pred_pose, pose)

    new_state = OdomState(
        pose=pose,
        pose_prev=state.pose,
        q_odom_pre=torch.where(imu_available, q_imu_pred, state.q_odom_pre),
        startup_count=startup_count,
        initialized=torch.ones((), dtype=torch.bool, device=dev),
        frame_count=state.frame_count + 1,
        last_time=t_start,
        rt=rt,
        edge_map=edge_map,
        surf_map=surf_map,
        smoother=smoother,
        degenerate=icp_stats.degenerate & run_icp,
        uncertainty=torch.where(run_icp, icp_stats.uncertainty,
                                state.uncertainty),
        obs_ema=update_obs_ema(state.obs_ema, icp_stats.uncertainty[:3],
                               run_icp),
        vio_pose=state.vio_pose,
        vio_available=state.vio_available,
        prev_imu=imu._replace(mask=imu.mask & imu_available),
    )
    out = StepOutput(
        pose=pose,
        smoothed_pose=smoothed_pose,
        vel_body=vel_body,
        ang_vel_body=ang_vel_body,
        acc_bias=smoother.ba[-1],
        gyr_bias=smoother.bg[-1],
        prediction_source=source,
        icp=icp_stats,
        surf_stack_num=torch.sum(surf_mask.to(torch.int32)).to(torch.int32),
        edge_stack_num=torch.sum(edge_mask.to(torch.int32)).to(torch.int32),
        surf_map_num=surf_map_num,
        edge_map_num=edge_map_num,
        average_distance=average_distance,
        motion_accepted=accepted,
        imu_healthy=~smoother.failed,
        translation_from_last=trans_from_last,
        rotation_from_last=rot_from_last,
        total_translation=total_trans,
        total_rotation=total_rot,
    )
    stage.close()
    return new_state, out


class HighRateOut(NamedTuple):
    """Per-scan IMU-rate odometry of the chunked replay (the ~200 Hz
    state_estimation stream, imuPreintegration.cpp:629,648-650): the width
    of the scan's IMU window, ``mask`` marking live samples."""

    t: torch.Tensor  # f32[m] sample times
    q: torch.Tensor  # f32[m,4]
    p: torch.Tensor  # f32[m,3]
    v: torch.Tensor  # f32[m,3]
    mask: torch.Tensor  # bool[m]


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (NamedTuples and
    plain tuples; anything else is a leaf)."""
    first = trees[0]
    if isinstance(first, tuple):
        mapped = [tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*mapped) if hasattr(first, "_fields") \
            else tuple(mapped)
    return fn(*trees)


def make_step_fn(cfg: PipelineConfig) -> Callable:
    """The step with the configuration closed over (JAX: the ``jax.jit``
    of it): ``(state, scan, imu, imu_available) -> (state, out)``, with a
    trailing VioWindow when ``cfg.use_vio_undistortion``."""
    if cfg.use_vio_undistortion:
        def step_fn(state, scan, imu, imu_available, vio):
            return step(cfg, state, scan, imu, imu_available, vio)
    else:
        def step_fn(state, scan, imu, imu_available):
            return step(cfg, state, scan, imu, imu_available)
    return step_fn


def make_chunked_step_fn(cfg: PipelineConfig, high_rate: bool = False
                         ) -> Callable:
    """Replay of a chunk of scans (JAX: ``jax.jit`` of a ``lax.scan``):
    ``(state, scans, imus, avails[, vios]) -> (state, outputs)``, where
    every input leaf has a leading chunk dimension (the stacked VIO windows
    with ``cfg.use_vio_undistortion``, as in JAX) and ``outputs`` is the
    StepOutput of each scan stacked on the device.  With ``high_rate`` the
    outputs are ``(stacked StepOutput, stacked HighRateOut)``: each scan's
    IMU window integrated forward from the state the step left.  The loop
    adds no device-to-host read to the step's own."""

    def chunk_fn(state, scans, imus, avails, vios=None):
        if cfg.use_vio_undistortion and vios is None:
            raise TypeError("the chunked step of a use_vio_undistortion "
                            "config takes the stacked VIO windows")
        outs = []
        for k in range(avails.shape[0]):
            scan, imu = tree_map(lambda a: a[k], (scans, imus))
            vio = None if vios is None else tree_map(lambda a: a[k], vios)
            state, out = step(cfg, state, scan, imu, avails[k], vio)
            if high_rate:
                poses, vels, mask = propagate_high_rate(state.smoother,
                                                        cfg.imu, imu)
                out = (out, HighRateOut(
                    t=imu.t, q=poses.q, p=poses.t, v=vels,
                    mask=mask & ~state.smoother.failed))
            outs.append(out)
        return state, tree_map(lambda *xs: torch.stack(xs), *outs)

    return chunk_fn
