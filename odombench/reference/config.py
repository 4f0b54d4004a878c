"""Typed configuration tree (the port's ``config`` dataclasses, field for
field; the benchmark builds it from a configuration file, so the port's
presets and YAML loaders are not copied).

Shapes (point counts, feature caps, map capacities, iteration counts) are
static fields; the scalars the reference tunes at runtime (line/plane
resolution) live in :class:`RuntimeParams` as tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np


class RuntimeParams(NamedTuple):
    """Per-step adaptive parameters (reference laserMapping.cpp:600-651)."""

    line_res: object  # edge feature voxel resolution [m]
    plane_res: object  # planar feature voxel resolution [m]


@dataclasses.dataclass(frozen=True)
class SensorProfile:
    """Per-sensor static parameters (reference config/*.yaml)."""

    name: str
    n_scan_lines: int
    max_points: int  # static input cloud capacity (points per scan)
    min_range: float  # blind-zone radius [m]
    max_range: float  # maximum usable range [m]
    filter_point_size: int  # uniform downsample stride (featureExtraction.cpp:504)
    max_surface_features: int
    max_edge_features: int
    scan_period: float
    default_line_res: float
    default_plane_res: float
    compact_width: int = 32768  # lanes before voxel thinning ("voxel" mode)
    skip_frame: int = 1  # process every k-th scan (featureExtraction.cpp:713)
    # scan-stack spatial thinning: "voxel", "centroid", "range", "none"
    scan_thin_mode: str = "voxel"


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Voxel-hash local map parameters (see :mod:`superodom_tpu_torch.mapstate`)."""

    cell_size: float = 2.0  # hash cell edge [m]
    table_size: int = 1 << 16  # total slots (= buckets * bucket_size)
    bucket_size: int = 128  # slots per hash bucket
    cell_capacity: int = 32  # stored points per cell
    insert_width: int = 1024  # max point writes per insert call
    insert_cadence: int = 1  # insert every k-th frame
    evict_cadence: int = 1  # eviction pass every k-th frame
    evict_radius: float = 250.0  # drop cells farther than this from the pose


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """Scan-to-map ICP parameters (reference LidarSlam.h:273-281)."""

    max_icp_iters: int = 4
    max_gn_iters: int = 4
    plane_knn: int = 5
    edge_knn: int = 10
    min_edge_neighbors: int = 4
    edge_max_dist_inlier: float = 0.2
    min_map_surf_features: int = 50
    min_plane_matches: int = 50
    velocity_failure_threshold: float = 30.0
    yaw_ratio: float = 0.0
    trans_converge_tol: float = 1e-3
    rot_converge_tol: float = 1e-3
    icp_early_exit: bool = True
    refresh_width: int = 0
    tukey_anneal: float = 1.0
    tukey_anneal_floor: float = 0.02
    pos_degeneracy_threshold: float = 0.1
    ori_degeneracy_threshold: float = 0.15
    axis_hold_min_matches: int = 10
    axis_hold_frac: float = 0.005
    visual_confidence_factor: float = 1.0

    def __post_init__(self):
        if self.max_icp_iters < 1:
            raise ValueError(
                f"max_icp_iters must be >= 1, got {self.max_icp_iters}")
        if self.refresh_width != 0 and self.refresh_width < self.plane_knn:
            raise ValueError(
                f"refresh_width ({self.refresh_width}) must be 0 or >= "
                f"plane_knn ({self.plane_knn})")


@dataclasses.dataclass(frozen=True)
class ImuConfig:
    """Inertial fusion parameters (reference imu_preintegration_node)."""

    acc_noise: float = 3.9939570888238808e-03
    gyr_noise: float = 1.5636343949698187e-03
    acc_bias_noise: float = 6.4356659353532566e-05
    gyr_bias_noise: float = 3.5640318696367613e-05
    gravity: float = 9.80511
    lidar_correction_noise: float = 0.01
    imu_rate: float = 200.0
    max_imu_per_scan: int = 64
    window_size: int = 6
    smoother_gn_iters: int = 3
    init_vel_sigma: float = 2.0
    init_acc_bias_sigma: float = 0.5
    init_gyr_bias_sigma: float = 0.1
    prior_forgetting: float = 0.95
    max_velocity: float = 30.0
    max_acc_bias: float = 2.0
    max_gyr_bias: float = 1.0
    init_window_sec: float = 1.0
    high_rate_decimation: int = 4


@dataclasses.dataclass(frozen=True)
class Extrinsics:
    """IMU<->LiDAR calibration; tuples keep the dataclass hashable."""

    R_imu_laser: Tuple[Tuple[float, ...], ...] = (
        (1.0, 0.0, 0.0),
        (0.0, 1.0, 0.0),
        (0.0, 0.0, 1.0),
    )
    t_imu_laser: Tuple[float, ...] = (0.0, 0.0, 0.0)

    def R(self) -> np.ndarray:
        return np.asarray(self.R_imu_laser, dtype=np.float32)

    def t(self) -> np.ndarray:
        return np.asarray(self.t_imu_laser, dtype=np.float32)

    @staticmethod
    def from_arrays(R: np.ndarray, t: np.ndarray) -> "Extrinsics":
        return Extrinsics(
            R_imu_laser=tuple(tuple(float(v) for v in row) for row in R),
            t_imu_laser=tuple(float(v) for v in np.asarray(t).reshape(3)),
        )


@dataclasses.dataclass(frozen=True)
class LocalizationConfig:
    """SLAM mapping vs localization against a prior map."""

    enabled: bool = False
    update_map: bool = False
    init_pose_xyz: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    init_pose_rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Root configuration (field meanings: ``superodom_tpu.config``)."""

    sensor: SensorProfile
    map: MapConfig = MapConfig()
    registration: RegistrationConfig = RegistrationConfig()
    imu: ImuConfig = ImuConfig()
    extrinsics: Extrinsics = Extrinsics()
    localization: LocalizationConfig = LocalizationConfig()
    auto_voxel_size: bool = True
    use_imu_roll_pitch: bool = False
    startup_frames: int = 10
    use_edge_features: bool = False
    edge_curvature_threshold: float = 0.2
    enable_lio_prediction: bool = False
    lio_min_observability: float = 0.05
    use_vio_undistortion: bool = False
    max_vio_per_scan: int = 16
    use_cv_undistortion: bool = True
    use_translation_deskew: bool = True

    def default_runtime(self) -> RuntimeParams:
        return RuntimeParams(
            line_res=np.float32(self.sensor.default_line_res),
            plane_res=np.float32(self.sensor.default_plane_res),
        )
