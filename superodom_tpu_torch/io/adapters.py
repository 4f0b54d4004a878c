"""Sensor adapters: raw per-vendor point formats -> the framework's
(xyz, t_rel, ring, intensity) arrays.

Host-side rebuild of the reference's ingestion callbacks
(reference featureExtraction.cpp:710-823, sensor_data/pointcloud/point_os.h):

* Velodyne: points arrive with per-point relative time + ring.
* Ouster: OusterPointXYZIRT with nanosecond timestamps; points are rotated
  from the ouster frame to the sensor frame by the hardcoded extrinsic
  (parameter.cpp:271-277: R = diag(-1,-1,1), t = (0,0,0.036180)).
* Livox CustomMsg: tag-filtered points with offset_time in ns
  (featureExtraction.cpp:793-805).
* Velodyne without per-point time: ring id from elevation angle + a
  column/laser timing model (assignTimeforPointCloud,
  featureExtraction.cpp:646-708).

The PyTorch port's copy of the JAX package's ``io.adapters``, line for
line.  The native decode of packed binary records is
:func:`superodom_tpu_torch.native.decode_points`; these numpy versions are
the plain versions the tests hold it against.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

# timing model constants (reference featureExtraction.h:91-93)
SCAN_PERIOD = 0.100859904 - 20.736e-6
COLUMN_TIME = 55.296e-6
LASER_TIME = 2.304e-6

# ouster -> sensor frame (reference parameter.cpp:271-277)
OUSTER_SENSOR_R = np.array(
    [[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]], np.float32
)
OUSTER_SENSOR_T = np.array([0.0, 0.0, 0.036180], np.float32)


class RawScan(NamedTuple):
    xyz: np.ndarray  # f32[n,3] sensor frame
    t_rel: np.ndarray  # f32[n] seconds since scan start
    ring: np.ndarray  # i32[n]
    intensity: np.ndarray  # f32[n]


def from_velodyne(
    xyz: np.ndarray,
    time: Optional[np.ndarray] = None,
    ring: Optional[np.ndarray] = None,
    intensity: Optional[np.ndarray] = None,
    n_scan_lines: int = 16,
) -> RawScan:
    """Velodyne-style clouds; synthesizes ring/time when the driver did not
    provide them (reference assignTimeforPointCloud)."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    intensity = (
        np.zeros(n, np.float32) if intensity is None
        else np.asarray(intensity, np.float32)
    )
    if time is not None:
        t_rel = np.asarray(time, np.float32)
        r = (
            np.zeros(n, np.int32) if ring is None else np.asarray(ring, np.int32)
        )
        return RawScan(xyz, t_rel, r, intensity)
    return _synthesize_ring_time(xyz, intensity, n_scan_lines)


def _synthesize_ring_time(xyz, intensity, n_scan_lines) -> RawScan:
    """Ring from elevation angle; per-point time from the column/laser
    timing model (featureExtraction.cpp:646-708).  Out-of-fan points are
    dropped, mirroring the reference's 'continue'."""
    angle = np.degrees(
        np.arctan2(xyz[:, 2], np.sqrt(xyz[:, 0] ** 2 + xyz[:, 1] ** 2))
    )
    if n_scan_lines == 16:
        scan_id = ((angle + 15.0) / 2.0 + 0.5).astype(np.int32)
        ok = (scan_id >= 0) & (scan_id < 16)
    elif n_scan_lines == 32:
        scan_id = ((angle + 92.0 / 3.0) * 3.0 / 4.0).astype(np.int32)
        ok = (scan_id >= 0) & (scan_id < 32)
    elif n_scan_lines == 64:
        upper = angle >= -8.83
        scan_id = np.where(
            upper,
            ((2.0 - angle) * 3.0 + 0.5).astype(np.int32),
            32 + ((-8.83 - angle) * 2.0 + 0.5).astype(np.int32),
        )
        ok = (angle <= 2) & (angle >= -24.33) & (scan_id >= 0) & (scan_id <= 50)
    else:
        raise ValueError(f"unsupported scan line count {n_scan_lines}")

    idx = np.arange(len(xyz))
    rel = (COLUMN_TIME * (idx // n_scan_lines) + LASER_TIME * (idx % n_scan_lines))
    return RawScan(
        xyz[ok],
        rel[ok].astype(np.float32),
        scan_id[ok].astype(np.int32),
        intensity[ok],
    )


def from_ouster(
    xyz: np.ndarray,
    t_ns: np.ndarray,
    ring: Optional[np.ndarray] = None,
    reflectivity: Optional[np.ndarray] = None,
) -> RawScan:
    """Ouster clouds: rotate into the sensor frame, timestamps ns -> s
    (featureExtraction.cpp:732-746)."""
    xyz = np.asarray(xyz, np.float32) @ OUSTER_SENSOR_R.T + OUSTER_SENSOR_T
    n = len(xyz)
    return RawScan(
        xyz.astype(np.float32),
        (np.asarray(t_ns, np.float64) * 1e-9).astype(np.float32),
        np.zeros(n, np.int32) if ring is None else np.asarray(ring, np.int32),
        np.zeros(n, np.float32)
        if reflectivity is None
        else np.asarray(reflectivity, np.float32),
    )


def from_livox(
    xyz: np.ndarray,
    offset_time_ns: np.ndarray,
    line: np.ndarray,
    tag: np.ndarray,
    reflectivity: Optional[np.ndarray] = None,
    n_scan_lines: int = 4,
    gravity_alignment: Optional[np.ndarray] = None,
) -> RawScan:
    """Livox CustomMsg points: keep single/first-return tags on valid lines,
    optionally rotate by the gravity-alignment matrix computed at IMU init
    (featureExtraction.cpp:788-805)."""
    tag = np.asarray(tag)
    line = np.asarray(line)
    keep = (line < n_scan_lines) & (
        ((tag & 0x30) == 0x10) | ((tag & 0x30) == 0x00)
    )
    xyz = np.asarray(xyz, np.float32)[keep]
    if gravity_alignment is not None:
        xyz = xyz @ np.asarray(gravity_alignment, np.float32).T
    refl = (
        np.zeros(keep.sum(), np.float32)
        if reflectivity is None
        else np.asarray(reflectivity, np.float32)[keep]
    )
    return RawScan(
        xyz,
        (np.asarray(offset_time_ns, np.float64)[keep] * 1e-9).astype(np.float32),
        line[keep].astype(np.int32),
        refl,
    )
