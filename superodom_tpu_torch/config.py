"""Typed configuration tree (a copy of ``superodom_tpu.config``).

The JAX package's configuration is numpy-only, but importing any
``superodom_tpu`` module imports jax, which the GPU build of this package
does not have.  So the dataclass tree is copied here field for field, with
the same defaults; ``tests/test_torch_host.py`` holds every preset equal to
the JAX package's.

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


VLP_16 = SensorProfile(
    name="velodyne",
    n_scan_lines=16,
    max_points=32768,
    min_range=0.2,
    max_range=130.0,
    filter_point_size=3,
    max_surface_features=2048,
    max_edge_features=512,
    scan_period=0.1,
    default_line_res=0.1,
    default_plane_res=0.2,
)

OS1_128 = SensorProfile(
    name="ouster",
    n_scan_lines=128,
    max_points=131072,
    min_range=0.2,
    max_range=130.0,
    filter_point_size=3,
    max_surface_features=2048,
    max_edge_features=512,
    scan_period=0.1,
    default_line_res=0.1,
    default_plane_res=0.2,
    compact_width=49152,
)

LIVOX_MID360 = SensorProfile(
    name="livox",
    n_scan_lines=4,
    max_points=24576,
    min_range=0.2,
    max_range=70.0,
    filter_point_size=3,
    max_surface_features=4096,
    max_edge_features=512,
    scan_period=0.1,
    default_line_res=0.1,
    default_plane_res=0.1,
)


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

    sensor: SensorProfile = VLP_16
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


# the sensors the command-line entry points offer
PROFILES = ("os1_128", "vlp_16", "livox_mid360")


def profile_by_name(name: str) -> SensorProfile:
    """A sensor by any of its names: the profile's own (``os1_128``, the
    entry points' spelling), the maker's, or the replay benchmark's short
    one (``os1``, ``vlp16``, ``livox``), which the benchmark's
    configurations below are known by."""
    table = {
        "velodyne": VLP_16,
        "vlp_16": VLP_16,
        "vlp16": VLP_16,
        "ouster": OS1_128,
        "os1_128": OS1_128,
        "os1": OS1_128,
        "livox": LIVOX_MID360,
        "livox_mid360": LIVOX_MID360,
    }
    return table[name.lower()]


def ship_config(name: str = "os1") -> PipelineConfig:
    """The ship configuration of the replay benchmark (``bench._config``
    with ``tuned=True``): OS1-128 with r^2-stratified scan thinning, a
    16-point cell capacity, 2 ICP rounds x 4 GN steps with Tukey annealing
    and a 2-iteration smoother.  Other sensors get the untuned defaults,
    as in ``bench._config``.  ``name`` is any name of
    :func:`profile_by_name`."""
    sensor = profile_by_name(name)
    cfg = PipelineConfig(
        sensor=sensor,
        map=MapConfig(),
        registration=RegistrationConfig(),
        imu=ImuConfig(),
        auto_voxel_size=False,
    )
    if sensor is OS1_128:
        cfg = dataclasses.replace(
            cfg,
            sensor=dataclasses.replace(sensor, scan_thin_mode="range"),
            map=MapConfig(cell_capacity=16),
            registration=RegistrationConfig(max_icp_iters=2,
                                            tukey_anneal=0.25),
            imu=ImuConfig(smoother_gn_iters=2),
        )
    return cfg


def parity_config(name: str = "os1") -> PipelineConfig:
    """The reference-envelope configuration of the replay benchmark
    (``bench._config`` with ``parity=True``): the reference's full ICP
    budget — 5 outer rounds with early exit x 4 GN steps — over the ship
    configuration's tuning underneath it: candidate refresh from 16 lanes
    for rounds 2..5, r^2-stratified scan thinning, a 16-point cell
    capacity, Tukey annealing and a 2-iteration smoother.  ``name`` as in
    :func:`ship_config`."""
    cfg = ship_config(name)
    return dataclasses.replace(
        cfg,
        sensor=dataclasses.replace(cfg.sensor, scan_thin_mode="range"),
        map=MapConfig(cell_capacity=16),
        registration=RegistrationConfig(max_icp_iters=5, refresh_width=16,
                                        tukey_anneal=0.25),
        imu=ImuConfig(smoother_gn_iters=2),
    )


def config_for(profile: str, parity: bool = False) -> PipelineConfig:
    """The replay benchmark's configuration of a sensor: the ship one, or
    with ``parity`` the reference-envelope one (the profiler's
    ``--profile`` / ``--parity``, the CLI's ``--ship`` / ``--parity``)."""
    return (parity_config if parity else ship_config)(profile)


# reference-style YAML configurations (the JAX package's config loaders,
# line for line)


def _yaml():
    """PyYAML, imported where a YAML file is read: the rest of the package
    does not need it."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading a reference-style YAML configuration "
                          "needs the PyYAML package (import yaml)") from e
    return yaml


def _rpy_deg_to_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """RPY (degrees) -> rotation matrix, Rz(yaw) @ Ry(pitch) @ Rx(roll)
    (tf2 setRPY convention used by the reference's offset composition)."""
    r, p, y = np.deg2rad([roll, pitch, yaw])
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), \
        np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _load_opencv_yaml(path: str) -> dict:
    """Parse an OpenCV FileStorage YAML (the reference's calibration format):
    strips the '%YAML:1.0' directive and resolves '!!opencv-matrix' nodes to
    numpy arrays."""
    yaml = _yaml()

    with open(path) as f:
        text = f.read()
    lines = text.splitlines()
    if lines and lines[0].lstrip().startswith("%YAML"):
        lines = lines[1:]
        if lines and lines[0].strip() == "---":
            lines = lines[1:]
    text = "\n".join(lines)

    class _CvLoader(yaml.SafeLoader):
        pass

    def _mat(loader, node):
        d = loader.construct_mapping(node, deep=True)
        return np.asarray(d["data"], dtype=np.float64).reshape(
            int(d["rows"]), int(d["cols"])
        )

    _CvLoader.add_constructor("tag:yaml.org,2002:opencv-matrix", _mat)
    _CvLoader.add_constructor("!opencv-matrix", _mat)
    return yaml.load(text, Loader=_CvLoader) or {}


def load_calibration(
    path: str, provide_imu_laser_extrinsic: bool = True
) -> Tuple[Extrinsics, float]:
    """Load a reference-style calibration YAML into (Extrinsics, yaw_ratio).

    Mirrors readCalibration (reference parameter.cpp:118-280):

    * direct path: ``extrinsicRotation_imu_laser`` / ``Translation`` with the
      ``imu_laser_rotation_offset`` RPY (degrees) composed on the LEFT of the
      rotation (parameter.cpp:198-214);
    * camera path (``provide_imu_laser_extrinsic=False``): T_imu_laser =
      T_imu_camera o T_camera_laser (parameter.cpp:237-260);
    * ``yaw_ratio`` (degrees of yaw per meter traveled, parameter.cpp:150).
    """
    raw = _load_opencv_yaml(path)
    yaw_ratio = float(raw.get("yaw_ratio", 0.0) or 0.0)
    if provide_imu_laser_extrinsic:
        R = np.asarray(raw["extrinsicRotation_imu_laser"], np.float64)
        t = np.asarray(raw["extrinsicTranslation_imu_laser"],
                       np.float64).reshape(3)
        off = raw.get("imu_laser_rotation_offset")
        if off is not None:
            off = np.asarray(off, np.float64).reshape(-1)
            R = _rpy_deg_to_matrix(off[0], off[1], off[2]) @ R
    else:
        R_cl = np.asarray(raw["extrinsicRotation_camera_laser"], np.float64)
        t_cl = np.asarray(raw["extrinsicTranslation_camera_laser"],
                          np.float64).reshape(3)
        R_ic = np.asarray(raw["extrinsicRotation_imu_camera"], np.float64)
        t_ic = np.asarray(raw["extrinsicTranslation_imu_camera"],
                          np.float64).reshape(3)
        # renormalize the camera rotation through a quaternion as the
        # reference does (parameter.cpp:252-254)
        u, _, vt = np.linalg.svd(R_ic)
        R_ic = u @ vt
        R = R_ic @ R_cl
        t = R_ic @ t_cl + t_ic
    return Extrinsics.from_arrays(R, t), yaw_ratio


def load_yaml_config(path: str) -> PipelineConfig:
    """Load a reference-style YAML profile into a PipelineConfig.

    Accepts the reference's config schema (config/vlp_16.yaml layout) so users
    of the reference can bring their configs directly.
    """
    yaml = _yaml()

    with open(path) as f:
        raw = yaml.safe_load(f)
    params = raw.get("/**", raw).get("ros__parameters", raw)
    sensor = profile_by_name(params.get("sensor", "velodyne"))
    fe = params.get("feature_extraction_node", {})
    lm = params.get("laser_mapping_node", {})
    imu = params.get("imu_preintegration_node", {})

    sensor = dataclasses.replace(
        sensor,
        n_scan_lines=int(fe.get("scan_line", sensor.n_scan_lines)),
        min_range=float(fe.get("min_range", sensor.min_range)),
        filter_point_size=int(fe.get("filter_point_size", sensor.filter_point_size)),
        max_surface_features=int(
            lm.get("max_surface_features", sensor.max_surface_features)
        ),
        default_line_res=float(
            lm.get("mapping_line_resolution", sensor.default_line_res)
        ),
        default_plane_res=float(
            lm.get("mapping_plane_resolution", sensor.default_plane_res)
        ),
    )
    # calibration file: reference launch files pass it as a node parameter
    # (launch/vlp_16.launch.py); accept a path relative to the config file
    extr = Extrinsics()
    yaw_ratio = 0.0
    calib = params.get("calibration_file") or raw.get("calibration_file")
    if calib:
        import os

        if not os.path.isabs(calib):
            calib = os.path.join(os.path.dirname(os.path.abspath(path)), calib)
        extr, yaw_ratio = load_calibration(
            calib,
            provide_imu_laser_extrinsic=bool(
                params.get("provide_imu_laser_extrinsic", True)
            ),
        )
    reg = RegistrationConfig(
        max_icp_iters=int(lm.get("max_iterations", 4)),
        velocity_failure_threshold=float(lm.get("velocity_failure_threshold", 30.0)),
        yaw_ratio=yaw_ratio,
    )
    imu_cfg = ImuConfig(
        acc_noise=float(imu.get("acc_n", ImuConfig.acc_noise)),
        gyr_noise=float(imu.get("gyr_n", ImuConfig.gyr_noise)),
        acc_bias_noise=float(imu.get("acc_w", ImuConfig.acc_bias_noise)),
        gyr_bias_noise=float(imu.get("gyr_w", ImuConfig.gyr_bias_noise)),
        gravity=float(imu.get("g_norm", ImuConfig.gravity)),
        lidar_correction_noise=float(imu.get("lidar_correction_noise", 0.01)),
    )
    loc = LocalizationConfig(
        enabled=bool(lm.get("localization_mode", False)),
        init_pose_xyz=(
            float(lm.get("init_x", 0.0)),
            float(lm.get("init_y", 0.0)),
            float(lm.get("init_z", 0.0)),
        ),
        init_pose_rpy=(
            float(lm.get("init_roll", 0.0)),
            float(lm.get("init_pitch", 0.0)),
            float(lm.get("init_yaw", 0.0)),
        ),
    )
    return PipelineConfig(
        sensor=sensor, registration=reg, imu=imu_cfg, localization=loc,
        extrinsics=extr,
        use_imu_roll_pitch=bool(
            lm.get("use_imu_roll_pitch",
                   fe.get("use_imu_roll_pitch", False))
        ),
    )
