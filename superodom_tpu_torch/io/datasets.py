"""Synthetic LiDAR-inertial datasets for tests and benchmarks.

The reference validates by replaying recorded demo bags (SURVEY.md section 4);
those bags are not part of the snapshot, so the regression harness here
generates geometrically structured worlds (rooms, corridors, pole fields),
simulates scans and IMU streams along analytic trajectories, and checks
trajectory recovery (ATE, return-to-origin) — the same metrics as the
reference's save_benchmark_result.py (10 cm return-to-origin pass/fail).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np


def _quat_mul(q, p):
    w1, x1, y1, z1 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def _quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def _quat_rot(q, v):
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _quat_from_yaw(yaw):
    return np.stack(
        [np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw), np.sin(yaw / 2)],
        axis=-1,
    )


def _so3_log(q):
    w = q[..., 0:1]
    v = q[..., 1:4]
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    angle = 2.0 * np.arctan2(n, np.abs(w))
    sign = np.where(w < 0, -1.0, 1.0)
    scale = np.where(n < 1e-9, 2.0 * sign, sign * angle / np.maximum(n, 1e-12))
    return scale * v


@dataclasses.dataclass
class BoxWorld:
    """A box room with optional interior pole lattice — six planes constrain
    all DoF; poles add edge-like structure."""

    half_extent: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([20.0, 15.0, 4.0])
    )
    surface_density: float = 6.0  # points per m^2 available to sampling

    def sample_visible(self, rng, pose_t, n_points, max_range=60.0):
        """Sample world-frame surface points visible (by range) from pose_t."""
        he = self.half_extent
        areas = np.array(
            [he[1] * he[2] * 4, he[0] * he[2] * 4, he[0] * he[1] * 4]
        )
        probs = areas / areas.sum()
        axis = rng.choice(3, size=n_points, p=probs)
        sign = rng.choice([-1.0, 1.0], size=n_points)
        pts = rng.uniform(-1, 1, size=(n_points, 3)) * he[None, :]
        pts[np.arange(n_points), axis] = sign * he[axis]
        d = np.linalg.norm(pts - pose_t[None, :], axis=-1)
        ok = d < max_range
        return pts[ok]


class SimScan(NamedTuple):
    t_start: float
    xyz_body: np.ndarray  # [n,3] distorted body-frame points
    t_rel: np.ndarray  # [n]


class SimImu(NamedTuple):
    t: np.ndarray
    acc: np.ndarray
    gyr: np.ndarray


class SimDataset(NamedTuple):
    scans: list  # of SimScan
    imu: SimImu
    gt_poses_q: np.ndarray  # [n_scans, 4]
    gt_poses_t: np.ndarray  # [n_scans, 3]
    times: np.ndarray  # [n_scans]


def circle_trajectory(
    n_scans, radius=6.0, scan_period=0.1, z_amp=0.3, laps=1.0, static_scans=0
):
    """Closed-loop circular trajectory with heading tangent to the path —
    returns to origin, matching the benchmark harness's pass criterion.

    ``static_scans`` poses at the origin precede the motion (the reference's
    IMU initialization assumes ~1 s of rest, imu_data.h:71-160)."""
    times = np.arange(n_scans) * scan_period
    static_scans = min(static_scans, max(n_scans - 2, 0))
    n_move = n_scans - static_scans
    ang = np.concatenate(
        [
            np.zeros(static_scans),
            np.linspace(0, 2 * np.pi * laps, n_move, endpoint=True),
        ]
    )
    pos = np.stack(
        [
            radius * np.sin(ang),
            radius * (1 - np.cos(ang)),
            z_amp * np.sin(2 * ang),
        ],
        axis=-1,
    )
    pos -= pos[0]
    yaw = ang
    q = _quat_from_yaw(yaw)
    return times, q.astype(np.float64), pos.astype(np.float64)


def make_dataset(
    rng: np.random.Generator,
    n_scans: int = 50,
    points_per_scan: int = 8192,
    world: Optional[BoxWorld] = None,
    imu_rate: float = 200.0,
    scan_period: float = 0.1,
    gyr_bias=(0.002, -0.003, 0.001),
    acc_bias=(0.05, -0.02, 0.03),
    noise_gyr: float = 1e-3,
    noise_acc: float = 1e-2,
    point_noise: float = 0.01,
    gravity: float = 9.80511,
    radius: float = 6.0,
    distortion: bool = True,
    static_scans: int = 15,
    laps: float = 1.0,
) -> SimDataset:
    """Simulate a full LiDAR+IMU sequence along a closed circular loop."""
    world = world or BoxWorld()
    times, q_traj, p_traj = circle_trajectory(
        n_scans, radius, scan_period, static_scans=static_scans, laps=laps
    )

    # dense pose sampling for IMU + per-point interpolation
    dense_dt = 1.0 / imu_rate
    t_dense = np.arange(times[0], times[-1] + scan_period + dense_dt, dense_dt)
    ang_of = lambda t: np.interp(t, times, np.linspace(0, 1, n_scans))
    frac = ang_of(t_dense)
    full = np.linspace(0, 1, n_scans)
    # interpolate position & yaw along trajectory parameter
    p_dense = np.stack([np.interp(frac, full, p_traj[:, i]) for i in range(3)], -1)
    yaw_dense = np.interp(frac, full, np.unwrap(np.arctan2(
        2 * (q_traj[:, 0] * q_traj[:, 3]), 1 - 2 * q_traj[:, 3] ** 2)))
    q_dense = _quat_from_yaw(yaw_dense)

    # IMU: gyro = d yaw/dt about body z; acc = R^T (a_w - g_w)
    g_w = np.array([0.0, 0.0, -gravity])
    v_dense = np.gradient(p_dense, dense_dt, axis=0)
    a_dense = np.gradient(v_dense, dense_dt, axis=0)
    wz = np.gradient(yaw_dense, dense_dt)
    gyr = np.stack([np.zeros_like(wz), np.zeros_like(wz), wz], -1)
    acc_body = _quat_rot(_quat_conj(q_dense), a_dense - g_w[None, :])
    gyr = gyr + np.asarray(gyr_bias)[None, :] + rng.normal(0, noise_gyr, gyr.shape)
    acc = (
        acc_body
        + np.asarray(acc_bias)[None, :]
        + rng.normal(0, noise_acc, acc_body.shape)
    )
    imu = SimImu(t=t_dense, acc=acc.astype(np.float32), gyr=gyr.astype(np.float32))

    def pose_at(t):
        f = ang_of(np.atleast_1d(t))
        p = np.stack([np.interp(f, full, p_traj[:, i]) for i in range(3)], -1)
        yw = np.interp(f, full, np.unwrap(np.arctan2(
            2 * (q_traj[:, 0] * q_traj[:, 3]), 1 - 2 * q_traj[:, 3] ** 2)))
        return _quat_from_yaw(yw), p

    scans = []
    for i in range(n_scans):
        t0 = times[i]
        pts_w = world.sample_visible(rng, p_traj[i], points_per_scan)
        n = len(pts_w)
        t_rel = np.sort(rng.uniform(0, scan_period, size=n)).astype(np.float32)
        if distortion:
            qs, ps = pose_at(t0 + t_rel)
        else:
            qs, ps = pose_at(np.full(n, t0))
        body = _quat_rot(_quat_conj(qs), pts_w - ps)
        body += rng.normal(0, point_noise, body.shape)
        scans.append(SimScan(t_start=float(t0), xyz_body=body.astype(np.float32),
                             t_rel=t_rel))

    return SimDataset(
        scans=scans,
        imu=imu,
        gt_poses_q=q_traj.astype(np.float32),
        gt_poses_t=p_traj.astype(np.float32),
        times=times,
    )


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray) -> float:
    """Absolute trajectory error after origin alignment (both trajectories
    start at the same pose here, so no Umeyama fit is needed)."""
    return float(np.sqrt(np.mean(np.sum((est_t - gt_t) ** 2, axis=-1))))
