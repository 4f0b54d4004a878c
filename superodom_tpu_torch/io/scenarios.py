"""Adversarial scenario generator: 6-DoF trajectories, degenerate worlds,
sensor-fault injection, and external-odometry streams.

The reference qualifies on recorded challenge datasets (SURVEY.md section 4:
superodometry.com SLAM/localization challenge bags, 10 cm return-to-origin
pass/fail); no bags exist in this environment, so this module generates the
stress battery instead: aggressive roll/pitch/yaw excitation and stop-and-go
(beyond anything the easy BoxWorld circle exercises), corridor->room
degeneracy transitions, rotation-degenerate cylinder halls, IMU dropout
windows, outlier points and moving clusters, range-dependent noise, and
long (2000+ scan) runs.

This is the PyTorch port's numpy copy of the JAX package's
``io.scenarios``: the same seeds give the same arrays
(``tests/test_torch_vio.py`` holds them equal), and the GPU host, which has
no JAX, builds ``chip_smoke.py``'s SuperLoc cases here.  Only the map-state
helpers differ: they call the port's ``checkpoint`` and ``mapstate`` and
read tensors through ``.cpu().numpy()``.

Everything here is host-side numpy; the output is the same replayable
dataset shape io.datasets produces (scans + imu + ground truth), extended
with an optional VIO pose stream for the 6-DoF undistortion path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from superodom_tpu_torch.config import LocalizationConfig
from superodom_tpu_torch.io.datasets import SimImu, SimScan

# ---------------------------------------------------------------------------
# quaternion helpers (numpy, wxyz)
# ---------------------------------------------------------------------------


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


def _quat_from_rpy(roll, pitch, yaw):
    """Rz(yaw) Ry(pitch) Rx(roll) as a quaternion (tf2 setRPY order)."""
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    return np.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
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


def _slerp(q0, q1, r):
    """Row-wise slerp, r in [0,1] ([N] for [N,4] quats)."""
    d = np.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = np.where(d < 0, -q1, q1)
    d = np.abs(d).clip(0.0, 1.0)
    theta = np.arccos(d)
    s = np.sin(theta)
    near = s < 1e-6
    r = r[..., None]
    w0 = np.where(near, 1.0 - r, np.sin((1.0 - r) * theta) / np.maximum(s, 1e-12))
    w1 = np.where(near, r, np.sin(r * theta) / np.maximum(s, 1e-12))
    out = w0 * q0 + w1 * q1
    return out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------


class Traj(NamedTuple):
    """Dense 6-DoF trajectory sampled at IMU rate (world <- body)."""

    t: np.ndarray  # [M]
    q: np.ndarray  # [M,4]
    p: np.ndarray  # [M,3]

    def pose_at(self, times: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Slerp/lerp-interpolated poses at arbitrary times [N]."""
        times = np.atleast_1d(np.asarray(times, np.float64))
        hi = np.clip(np.searchsorted(self.t, times, side="right"), 1,
                     len(self.t) - 1)
        lo = hi - 1
        r = np.clip(
            (times - self.t[lo]) / np.maximum(self.t[hi] - self.t[lo], 1e-9),
            0.0, 1.0,
        )
        q = _slerp(self.q[lo], self.q[hi], r)
        p = (1.0 - r)[:, None] * self.p[lo] + r[:, None] * self.p[hi]
        return q, p


def traj_from_curves(
    duration: float,
    pos_fn: Callable[[np.ndarray], np.ndarray],
    rpy_fn: Callable[[np.ndarray], np.ndarray],
    imu_rate: float = 200.0,
    static_sec: float = 1.5,
    soft_start: float = 0.5,
) -> Traj:
    """Build a dense trajectory from analytic curves ``pos_fn(t) -> [N,3]``
    and ``rpy_fn(t) -> [N,3]`` over t in [0, duration].  ``static_sec`` of
    rest at the initial pose precedes the motion (the IMU static
    initializer needs ~1 s, reference imu_data.h:71-160).  Curve time is
    warped through tau = tc^2 / (tc + soft_start), which has tau'(0) = 0:
    the platform leaves rest with zero velocity (no acceleration impulse in
    the synthesized IMU) and reaches full curve dynamics within ~2
    soft_start."""
    dt = 1.0 / imu_rate
    t = np.arange(0.0, static_sec + duration + dt, dt)
    tc = np.maximum(t - static_sec, 0.0)
    if soft_start > 0.0:
        tc = tc * tc / (tc + soft_start)
    p = np.asarray(pos_fn(tc), np.float64)
    rpy = np.asarray(rpy_fn(tc), np.float64)
    q = _quat_from_rpy(rpy[:, 0], rpy[:, 1], rpy[:, 2])
    return Traj(t=t, q=q, p=p - p[0])


def smoothstep_profile(t: np.ndarray, segments: Sequence[Tuple[float, float]],
                       blend: float = 0.3):
    """Piecewise-constant speed with C1 smoothstep blending -> distance s(t).

    ``segments`` is [(duration, speed), ...] (each duration >= blend);
    speed eases from the previous segment's value over ``blend`` seconds:
    v(tau) = v_prev + (v - v_prev) * w(tau/blend), w(b) = 3b^2 - 2b^3.
    Returns arc length at each t (position frozen past the last segment).
    Used for stop-and-go profiles (hard on constant-velocity prediction)."""
    t = np.asarray(t, np.float64)
    s = np.zeros_like(t)
    t0 = 0.0
    v_prev = 0.0
    s_base = 0.0

    def seg_dist(tau, v_from, v_to):
        b = np.clip(tau / blend, 0.0, 1.0)
        # integral of w: blend * (b^3 - b^4/2)
        d_blend = v_from * tau + (v_to - v_from) * blend * (b**3 - 0.5 * b**4)
        d_after = (v_from * blend + (v_to - v_from) * blend * 0.5
                   + v_to * (tau - blend))
        return np.where(tau < blend, d_blend, d_after)

    for dur, v in segments:
        assert dur >= blend, "segment shorter than the blend time"
        tau = np.clip(t - t0, 0.0, dur)
        s = np.where(t > t0, s_base + seg_dist(tau, v_prev, v), s)
        s_base = s_base + float(seg_dist(np.asarray(dur), v_prev, v))
        t0 += dur
        v_prev = v
    return s


def aggressive_traj(
    duration: float = 20.0,
    speed: float = 3.0,
    roll_amp: float = 0.35,
    pitch_amp: float = 0.3,
    yaw_burst_rate: float = 2.5,
    imu_rate: float = 200.0,
    radius: float = 6.0,
    static_sec: float = 1.5,
) -> Traj:
    """Aggressive 6-DoF excitation: circular path with sinusoidal
    roll/pitch rocking (+-20 deg at ~0.8 Hz) and yaw bursts reaching
    ``yaw_burst_rate`` rad/s — far beyond the yaw-only easy world
    (VERDICT round-2: every tuning decision was made on that world)."""
    omega = speed / radius

    def pos(t):
        ang = omega * t
        return np.stack(
            [
                radius * np.sin(ang),
                radius * (1.0 - np.cos(ang)),
                0.4 * np.sin(2.0 * omega * t),
            ],
            axis=-1,
        )

    def rpy(t):
        roll = roll_amp * np.sin(2.0 * np.pi * 0.8 * t)
        pitch = pitch_amp * np.sin(2.0 * np.pi * 0.6 * t)
        # base heading follows the path; a smooth oscillation whose peak
        # angular rate is yaw_burst_rate adds the yaw bursts
        f_burst = 0.5
        amp = yaw_burst_rate / (2.0 * np.pi * f_burst)
        yaw = omega * t + amp * np.sin(2.0 * np.pi * f_burst * t)
        return np.stack([roll, pitch, yaw], axis=-1)

    return traj_from_curves(duration, pos, rpy, imu_rate, static_sec)


def stop_and_go_traj(
    duration: float = 18.0,
    cruise: float = 4.0,
    imu_rate: float = 200.0,
    static_sec: float = 1.5,
) -> Traj:
    """Straight-line stop-and-go: cruise / hard stop / cruise cycles.
    Breaks constant-velocity prediction at every transition."""
    cycle = [(3.0, cruise), (2.0, 0.0), (2.5, cruise), (1.5, 0.0),
             (3.0, cruise * 0.6), (2.0, 0.0), (4.0, cruise)]

    def pos(t):
        s = smoothstep_profile(t, cycle)
        return np.stack([s, np.zeros_like(s), np.zeros_like(s)], axis=-1)

    def rpy(t):
        z = np.zeros_like(t)
        return np.stack([z, z, z], axis=-1)

    return traj_from_curves(duration, pos, rpy, imu_rate, static_sec)


def straight_traj(
    duration: float = 15.0,
    speed: float = 2.0,
    heading: float = 0.0,
    imu_rate: float = 200.0,
    static_sec: float = 1.5,
    z_bob: float = 0.0,
) -> Traj:
    """Constant-velocity straight line (corridor traversals)."""

    def pos(t):
        return np.stack(
            [
                speed * t * np.cos(heading),
                speed * t * np.sin(heading),
                z_bob * np.sin(2.0 * np.pi * 0.5 * t),
            ],
            axis=-1,
        )

    def rpy(t):
        z = np.zeros_like(t)
        return np.stack([z, z, z + heading], axis=-1)

    return traj_from_curves(duration, pos, rpy, imu_rate, static_sec)


# ---------------------------------------------------------------------------
# worlds: finite surface patches (rectangles + cylinder shells)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Rect:
    """Finite plane patch: origin corner + two edge vectors."""

    origin: np.ndarray
    e1: np.ndarray
    e2: np.ndarray

    @property
    def area(self) -> float:
        return float(np.linalg.norm(np.cross(self.e1, self.e2)))

    def sample(self, rng, n):
        u = rng.uniform(size=(n, 1))
        v = rng.uniform(size=(n, 1))
        return self.origin[None, :] + u * self.e1[None, :] + v * self.e2[None, :]


@dataclasses.dataclass
class CylinderShell:
    """Vertical cylinder shell (axis along z) — seen from inside, rotation
    about the axis is unobservable (the orientation-degeneracy scenario)."""

    center: np.ndarray  # [3] axis point at z0
    radius: float
    height: float

    @property
    def area(self) -> float:
        return float(2.0 * np.pi * self.radius * self.height)

    def sample(self, rng, n):
        theta = rng.uniform(0.0, 2.0 * np.pi, size=n)
        z = rng.uniform(0.0, self.height, size=n)
        return np.stack(
            [
                self.center[0] + self.radius * np.cos(theta),
                self.center[1] + self.radius * np.sin(theta),
                self.center[2] + z,
            ],
            axis=-1,
        )


class PatchWorld:
    """World = union of surface patches; scans sample points visible (by
    range) from the platform with a 1/r^2 density falloff — a real scanner
    samples per solid angle, so surface density drops with range squared
    (area-uniform sampling would starve the near field and overweight
    distant walls, the opposite of every real lidar)."""

    def __init__(self, patches: List, max_range: float = 60.0):
        self.patches = patches
        self.max_range = max_range
        areas = np.asarray([p.area for p in patches], np.float64)
        self._probs = areas / areas.sum()

    def sample_visible(self, rng, pose_t, n_points, max_range=None,
                       oversample: int = 4):
        max_range = max_range or self.max_range
        counts = rng.multinomial(n_points * oversample, self._probs)
        pts = np.concatenate(
            [p.sample(rng, c) for p, c in zip(self.patches, counts) if c > 0]
        )
        d = np.linalg.norm(pts - pose_t[None, :], axis=-1)
        pts, d = pts[d < max_range], d[d < max_range]
        if len(pts) <= n_points:
            return pts
        # importance-resample area-uniform candidates to 1/r^2 density
        # without replacement (Gumbel top-k on log weights)
        logw = -2.0 * np.log(np.maximum(d, 1.0))
        keys = logw + rng.gumbel(size=len(d))
        idx = np.argpartition(-keys, n_points)[:n_points]
        return pts[idx]


def sample_world_points(world: "PatchWorld", rng, spacing: float = 0.15,
                        noise: float = 0.01) -> np.ndarray:
    """Dense area-uniform sampling of every patch at ~``spacing`` m point
    pitch — the synthetic stand-in for a prior-map PCD (the reference's
    localization mode loads one from disk, laserMapping.cpp:163-171).
    ``noise`` jitters the samples at sensor level: real prior maps come from
    real scans, and a mathematically exact plane sampling trips the
    reference's own PCA validity gate (eigenvalues(0) < 1e-6 -> BAD_PCA,
    LidarSlam.cpp:772)."""
    out = []
    for p in world.patches:
        n = max(int(np.ceil(p.area / (spacing * spacing))), 1)
        out.append(p.sample(rng, n))
    pts = np.concatenate(out)
    if noise > 0.0:
        pts = pts + rng.normal(0.0, noise, pts.shape)
    return pts.astype(np.float32)


def box_world(half_extent=(20.0, 15.0, 4.0), center=(0.0, 0.0, 0.0),
              max_range=60.0) -> PatchWorld:
    """Closed box room (six rectangles)."""
    he = np.asarray(half_extent, np.float64)
    c = np.asarray(center, np.float64)
    rects = []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            o = np.zeros(3)
            o[axis] = sign * he[axis]
            others = [i for i in range(3) if i != axis]
            e1 = np.zeros(3)
            e2 = np.zeros(3)
            e1[others[0]] = 2 * he[others[0]]
            e2[others[1]] = 2 * he[others[1]]
            origin = c + o - e1 / 2 - e2 / 2
            rects.append(Rect(origin, e1, e2))
    return PatchWorld(rects, max_range)


def corridor_world(length=60.0, width=4.0, height=3.0, x0=-5.0,
                   max_range=60.0) -> PatchWorld:
    """Open-ended corridor along +x: two walls + floor + ceiling, NO end
    caps — translation along x is lidar-unobservable (position degeneracy).
    """
    L = np.array([length, 0, 0], np.float64)
    rects = [
        # walls at y = +-width/2
        Rect(np.array([x0, -width / 2, 0.0]), L, np.array([0, 0, height])),
        Rect(np.array([x0, width / 2, 0.0]), L, np.array([0, 0, height])),
        # floor and ceiling
        Rect(np.array([x0, -width / 2, 0.0]), L, np.array([0, width, 0])),
        Rect(np.array([x0, -width / 2, height]), L, np.array([0, width, 0])),
    ]
    return PatchWorld(rects, max_range)


def add_pillars(world: PatchWorld, positions, z0=0.0, h=2.5,
                side=0.6) -> PatchWorld:
    """Add square columns (indoor clutter) to a world — near-field structure
    that constrains the along-track axis the way real rooms do."""
    rects = list(world.patches)
    for px, py in positions:
        for ex, ey in (((side, 0, 0), (0, 0, h)), ((0, side, 0), (0, 0, h))):
            rects.append(Rect(np.array([px, py, z0]),
                              np.array(ex, np.float64),
                              np.array(ey, np.float64)))
    return PatchWorld(rects, world.max_range)


def corridor_to_room_world(corridor_len=25.0, width=4.0, height=3.0,
                           room_half=(12.0, 9.0, 2.0),
                           max_range=60.0) -> PatchWorld:
    """Degeneracy transition: an x-degenerate corridor opening into a fully
    constraining room at x = corridor_len (the geometry-transition scenario
    of the round-2 verdict)."""
    rects = corridor_world(corridor_len + 2.0, width, height, x0=-5.0).patches
    rh = np.asarray(room_half, np.float64)
    room_center = np.array(
        [corridor_len + rh[0], 0.0, height / 2.0], np.float64
    )
    room = box_world(rh, room_center).patches
    return PatchWorld(rects + room, max_range)


def cylinder_hall_world(radius=6.0, height=5.0, max_range=60.0) -> PatchWorld:
    """Featureless cylinder hall with floor and ceiling: x/y constrained by
    the shell, z by floor/ceiling, but rotation about z (yaw) is
    unobservable — fires the ORIENTATION degeneracy flag while position
    risk stays low (reference alignment-risk analysis covers both blocks,
    LidarSlam.cpp:854-889)."""
    shell = CylinderShell(np.array([0.0, 0.0, -height / 2]), radius, height)
    disc_rects = []
    # floor/ceiling as 2 rectangles each (approximate discs; the corners
    # beyond the shell radius only add benign geometry)
    for z in (-height / 2, height / 2):
        disc_rects.append(
            Rect(
                np.array([-radius, -radius, z]),
                np.array([2 * radius, 0, 0]),
                np.array([0, 2 * radius, 0]),
            )
        )
    return PatchWorld([shell] + disc_rects, max_range)


def open_field_world(half_extent=(90.0, 70.0, 10.0), ground_z=-2.0,
                     max_range=130.0) -> PatchWorld:
    """Large sparse outdoor-like environment: a big ground plane, distant
    perimeter walls, and a few pillars near the path.  The wide coordinate
    spread pushes the scene-scale statistic (mean|x| * mean|y| * mean|z|)
    past the far threshold (65) so auto voxel sizing selects the far-mode
    resolutions (laserMapping.cpp:600-651) and the far-mode KNN gates are
    exercised on genuinely sparse long-range geometry."""
    hx, hy, hz = half_extent
    rects = [
        # ground
        Rect(np.array([-hx, -hy, ground_z]), np.array([2 * hx, 0, 0]),
             np.array([0, 2 * hy, 0])),
        # perimeter walls (height hz from ground)
        Rect(np.array([-hx, -hy, ground_z]), np.array([2 * hx, 0, 0]),
             np.array([0, 0, hz])),
        Rect(np.array([-hx, hy, ground_z]), np.array([2 * hx, 0, 0]),
             np.array([0, 0, hz])),
        Rect(np.array([-hx, -hy, ground_z]), np.array([0, 2 * hy, 0]),
             np.array([0, 0, hz])),
        Rect(np.array([hx, -hy, ground_z]), np.array([0, 2 * hy, 0]),
             np.array([0, 0, hz])),
    ]
    # pillars (0.8 m square columns) scattered within ~40 m of the origin
    for px, py in ((12.0, 6.0), (25.0, -10.0), (-8.0, -14.0), (35.0, 18.0),
                   (18.0, 25.0), (-20.0, 12.0), (6.0, -8.0), (15.0, -18.0),
                   (28.0, 4.0), (3.0, 14.0), (40.0, -6.0), (-12.0, 3.0)):
        for ex, ey in (((0.8, 0, 0), (0, 0, 6.0)), ((0, 0.8, 0), (0, 0, 6.0))):
            rects.append(Rect(np.array([px, py, ground_z]),
                              np.array(ex, np.float64),
                              np.array(ey, np.float64)))
    return PatchWorld(rects, max_range)


def avenue_world(length: float, width: float = 16.0, height: float = 5.0,
                 pillar_every: float = 8.0, baffle_every: float = 10.0,
                 max_range: float = 60.0) -> PatchWorld:
    """Long avenue along +x: side walls + floor/ceiling PLUS pillars and
    transverse baffle walls (alcoves, normal along x) alternating sides, so
    x stays observable over arbitrarily long travel — the geometry of a
    built corridor with door bays rather than a featureless tube.  Used for
    the long-range runs that push the map through the packed-coordinate
    wrap period (mapstate._COORD_PERIOD)."""
    w = corridor_world(length + 10.0, width, height, x0=-5.0,
                       max_range=max_range)
    rects = list(w.patches)
    depth = 0.35 * width
    x, side = baffle_every, 1.0
    while x < length:
        y0 = side * (width / 2)
        rects.append(Rect(np.array([x, y0, 0.0]),
                          np.array([0.0, -side * depth, 0.0]),
                          np.array([0.0, 0.0, height])))
        side = -side
        x += baffle_every
    world = PatchWorld(rects, max_range)
    positions = []
    x, side = pillar_every, 1.0
    while x < length:
        positions.append((x + pillar_every / 2, side * (width / 2 - 1.5)))
        side = -side
        x += pillar_every
    return add_pillars(world, positions, z0=0.0, h=min(height - 0.5, 3.5))


# ---------------------------------------------------------------------------
# fault injection + dataset assembly
# ---------------------------------------------------------------------------


class VioStream(NamedTuple):
    """External (visual-inertial) odometry pose samples, lidar frame."""

    t: np.ndarray  # [K]
    q: np.ndarray  # [K,4]
    p: np.ndarray  # [K,3]


class ScenarioDataset(NamedTuple):
    scans: list  # of SimScan
    imu: SimImu
    gt_poses_q: np.ndarray
    gt_poses_t: np.ndarray
    times: np.ndarray
    vio: Optional[VioStream] = None


@dataclasses.dataclass
class MovingCluster:
    """A dynamic object: a point blob sweeping through the scene (must be
    rejected by the correspondence gates / robust loss, not mapped)."""

    start: np.ndarray  # [3] world position at t=0
    velocity: np.ndarray  # [3] m/s
    extent: float = 0.8  # blob half-size [m]
    points_per_scan: int = 300


@dataclasses.dataclass
class Faults:
    """Sensor-fault injection knobs."""

    imu_dropout: Sequence[Tuple[float, float]] = ()  # [(t0, t1), ...]
    outlier_frac: float = 0.0  # uniform random outliers per scan
    clusters: Sequence[MovingCluster] = ()
    range_noise_k: float = 0.0  # sigma(r) = point_noise + k * r
    # scan index -> keep fraction (0 = empty scan mid-run)
    degraded_scans: dict = dataclasses.field(default_factory=dict)


def make_scenario(
    rng: np.random.Generator,
    traj: Traj,
    world: PatchWorld,
    n_scans: int,
    points_per_scan: int = 8192,
    scan_period: float = 0.1,
    gyr_bias=(0.002, -0.003, 0.001),
    acc_bias=(0.05, -0.02, 0.03),
    noise_gyr: float = 1e-3,
    noise_acc: float = 1e-2,
    point_noise: float = 0.01,
    gravity: float = 9.80511,
    faults: Optional[Faults] = None,
    vio: bool = False,
    vio_rate: float = 30.0,
    vio_pos_noise: float = 0.0,
) -> ScenarioDataset:
    """Simulate a LiDAR+IMU (+optional VIO) sequence along ``traj`` through
    ``world`` with the requested fault injection."""
    faults = faults or Faults()
    g_w = np.array([0.0, 0.0, -gravity])
    t = traj.t
    dt = float(t[1] - t[0])

    # ---- IMU synthesis from the dense pose samples -----------------------
    # body rates: central difference of the quaternion chain
    q_rel = _quat_mul(_quat_conj(traj.q[:-2]), traj.q[2:])
    gyr_mid = _so3_log(q_rel) / (2.0 * dt)
    gyr = np.concatenate([gyr_mid[:1], gyr_mid, gyr_mid[-1:]], axis=0)
    v = np.gradient(traj.p, dt, axis=0)
    a_w = np.gradient(v, dt, axis=0)
    acc_body = _quat_rot(_quat_conj(traj.q), a_w - g_w[None, :])
    gyr = gyr + np.asarray(gyr_bias)[None, :] + rng.normal(
        0, noise_gyr, gyr.shape
    )
    acc = acc_body + np.asarray(acc_bias)[None, :] + rng.normal(
        0, noise_acc, acc_body.shape
    )
    imu_keep = np.ones(len(t), bool)
    for t0, t1 in faults.imu_dropout:
        imu_keep &= ~((t >= t0) & (t <= t1))
    imu = SimImu(
        t=t[imu_keep],
        acc=acc[imu_keep].astype(np.float32),
        gyr=gyr[imu_keep].astype(np.float32),
    )

    # ---- scans ------------------------------------------------------------
    scan_times = np.arange(n_scans) * scan_period
    max_t = float(t[-1]) - scan_period
    if scan_times[-1] > max_t:
        raise ValueError(
            f"trajectory too short: {n_scans} scans x {scan_period}s needs "
            f"{scan_times[-1] + scan_period:.1f}s, have {t[-1]:.1f}s"
        )
    gt_q, gt_p = traj.pose_at(scan_times)

    scans: List[SimScan] = []
    for i in range(n_scans):
        t0 = float(scan_times[i])
        n_pts = points_per_scan
        keep_frac = faults.degraded_scans.get(i, 1.0)
        pts_w = world.sample_visible(rng, gt_p[i], n_pts)
        if keep_frac < 1.0:
            pts_w = pts_w[: max(int(len(pts_w) * keep_frac), 0)]

        # dynamic clusters: points around the moving blob center
        extra = []
        for cl in faults.clusters:
            c = cl.start + cl.velocity * t0
            if np.linalg.norm(c - gt_p[i]) < world.max_range:
                extra.append(
                    c[None, :]
                    + rng.uniform(-cl.extent, cl.extent,
                                  size=(cl.points_per_scan, 3))
                )
        if extra:
            pts_w = np.concatenate([pts_w] + extra)

        n = len(pts_w)
        t_rel = np.sort(rng.uniform(0, scan_period, size=n)).astype(np.float32)
        qs, ps = traj.pose_at(t0 + t_rel.astype(np.float64))
        body = _quat_rot(_quat_conj(qs), pts_w - ps)

        # range-dependent + base noise
        r = np.linalg.norm(body, axis=-1, keepdims=True)
        sigma = point_noise + faults.range_noise_k * r
        body = body + rng.normal(size=body.shape) * sigma

        # uniform random outliers (false returns anywhere in range)
        if faults.outlier_frac > 0.0:
            n_out = int(n * faults.outlier_frac)
            if n_out:
                dirs = rng.normal(size=(n_out, 3))
                dirs /= np.maximum(
                    np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-9
                )
                ranges = rng.uniform(0.5, world.max_range, size=(n_out, 1))
                idx = rng.choice(n, size=n_out, replace=False)
                body[idx] = dirs * ranges

        scans.append(
            SimScan(t_start=t0, xyz_body=body.astype(np.float32), t_rel=t_rel)
        )

    # ---- VIO stream (ground truth + noise at vio_rate) --------------------
    vio_stream = None
    if vio:
        tv = np.arange(0.0, float(t[-1]), 1.0 / vio_rate)
        qv, pv = traj.pose_at(tv)
        if vio_pos_noise > 0:
            pv = pv + rng.normal(0, vio_pos_noise, pv.shape)
        vio_stream = VioStream(
            t=tv, q=qv.astype(np.float32), p=pv.astype(np.float32)
        )

    return ScenarioDataset(
        scans=scans,
        imu=imu,
        gt_poses_q=gt_q.astype(np.float32),
        gt_poses_t=gt_p.astype(np.float32),
        times=scan_times,
        vio=vio_stream,
    )


# ---------------------------------------------------------------------------
# the stress battery (named cases; VERDICT round-2 item 1)
# ---------------------------------------------------------------------------


class StressCase(NamedTuple):
    """One qualification case: dataset builder + config expectations.

    ``ate_bound`` is the pass bound for the SHIP config (meters, settled
    frames); ``cfg_overrides`` are dotted-config keys any runner config must
    apply (e.g. far mode needs auto voxel sizing).  ``check`` optionally
    receives (stats, settle) for scenario-specific signals."""

    name: str
    build: Callable[[np.random.Generator], ScenarioDataset]
    ate_bound: float
    cfg_overrides: dict
    settle: int = 15  # frames excluded from the ATE (map warm-up / startup)
    check: Optional[Callable] = None  # check(res: RunResult, ds, settle)
    # localization-mode cases: dense world sampling loaded into the surf map
    # before the run (the reference's prior-PCD load, laserMapping.cpp:163)
    prior_points: Optional[Callable] = None  # (rng) -> f32[N,3]
    # runs after `check` with the live runner (map-state assertions)
    post_check: Optional[Callable] = None  # (runner, res, ds, settle)


def _check_degeneracy_transition(res, ds, settle):
    """Corridor segment flags degenerate; the segment where the room wall
    is in range clears; the OBSERVABLE axes (y/z) stay tight throughout.

    The unobservable axis (x) inevitably drifts: the slim reference's
    prediction sources under degeneracy hold position (IMU_ORIENTATION
    sets rotation only, laserMapping.cpp:363-369; LIO is distrusted when
    degenerate, :384-402), so x stalls at up to platform speed until the
    room constrains it — the test checks that the drift STOPS once the
    transition happens, not that it never occurred."""
    stats = res.stats
    n = len(stats)
    corridor = [s["degenerate"] for s in stats[settle:n // 3]]
    room = [s["degenerate"] for s in stats[-n // 6:]]
    assert np.mean(corridor) > 0.6, f"corridor deg={np.mean(corridor)}"
    assert np.mean(room) < 0.3, f"room deg={np.mean(room)}"
    err = res.poses_t - np.asarray(ds.gt_poses_t)
    yz = np.sqrt(np.mean(err[settle:, 1:] ** 2))
    assert yz < 0.3, f"y/z ATE {yz}"
    # x drift rate collapses in the constrained segment
    x_err = err[:, 0]
    drift_room = np.abs(np.diff(x_err[-n // 6:])).mean()
    assert drift_room < 0.05, f"room x drift/scan {drift_room}"


def _check_return_to_origin(res, ds, settle):
    """The reference benchmark's pass/fail: end-vs-start distance < 0.1 m on
    a loop whose ground truth closes exactly
    (script/save_benchmark_result.py:263-267)."""
    d = float(np.linalg.norm(res.poses_t[-1] - res.poses_t[0]))
    assert d < 0.10, f"return-to-origin {d:.3f} m >= 0.10"


def _check_far_mode(res, ds, settle):
    """Scene-scale statistic actually selects far mode (avg distance > 65,
    laserMapping.cpp:600-651) for the bulk of the run."""
    far = [s["average_distance"] > 65.0 for s in res.stats[settle:]]
    assert np.mean(far) > 0.8, f"far-mode fraction={np.mean(far)}"


def _check_vio_engaged(res, ds, settle):
    """The external-pose path actually carried frames: the VIO prediction
    source (PRED_VIO_ODOM=2) engaged during the degenerate corridor segment
    (reference determinePredictionSource under degeneracy + VIO,
    laserMapping.cpp:384-412)."""
    n = len(res.stats)
    src = [s["pred_source"] for s in res.stats[settle:max(n // 2, settle + 1)]]
    assert any(s == 2 for s in src), "VIO prediction source never engaged"


def _check_superloc_transition(res, ds, settle):
    """Localization + VIO in a degenerate corridor (the SuperLoc headline
    mode): the corridor flags degenerate, the room clears it, and — unlike
    the unaided corridor case — the VIO absolute-pose prior keeps the FULL
    pose near truth throughout (no x stall)."""
    stats = res.stats
    n = len(stats)
    corridor = [s["degenerate"] for s in stats[settle:n // 3]]
    room = [s["degenerate"] for s in stats[-n // 6:]]
    assert np.mean(corridor) > 0.5, f"corridor deg={np.mean(corridor)}"
    assert np.mean(room) < 0.3, f"room deg={np.mean(room)}"


def _check_map_frozen(runner, res, ds, settle):
    """Localization with update_map=False must not grow the prior map
    (reference laserMapping.cpp:129-177 + LidarSlam.cpp update gating)."""
    from superodom_tpu_torch.mapstate import total_points

    now = int(total_points(runner.state.surf_map))
    before = getattr(runner, "prior_map_total", None)
    assert before is not None, "harness did not prime the prior map"
    assert now == before, f"map grew in localization mode: {before} -> {now}"


def _check_wrap_safety(runner, res, ds, settle):
    """Long-range wrap correctness: after driving through >= half the
    packed-coordinate period (mapstate._COORD_PERIOD cells), the live map
    must be bounded and every live cell must sit within the evict radius of
    the final pose under wrapped nearest-representative coordinates — a
    wrap bug would leave aliased stale cells at bogus distances (the
    reference's analogue is shiftMap recentering, LocalMap.h:169-287)."""
    m = runner.state.surf_map
    keys = m.keys.cpu().numpy()
    live = keys != -1
    frac = float(live.mean())
    assert frac < 0.9, f"map table saturated: {frac:.2f} live"
    period = 1 << 10  # mapstate._COORD_BITS
    packed = keys[live].astype(np.int64)

    def ext(v):
        v = v & (period - 1)
        return np.where(v >= period // 2, v - period, v)

    coords = np.stack([ext(packed), ext(packed >> 10), ext(packed >> 20)],
                      axis=-1)
    cell = runner.cfg.map.cell_size
    center = np.floor(np.asarray(res.poses_t[-1]) / cell).astype(np.int64)
    d = (coords - center[None, :]) & (period - 1)
    d = np.where(d >= period // 2, d - period, d)
    dist = np.linalg.norm(d * cell, axis=-1)
    limit = runner.cfg.map.evict_radius + 4.0 * cell
    assert dist.max() <= limit, (
        f"stale/aliased cells at {dist.max():.0f} m (> {limit:.0f})"
    )


def prime_prior_map(runner, case: "StressCase", rng) -> None:
    """Harness helper: load a case's prior map into a fresh runner and stash
    the stored-point count for the frozen-map post check."""
    if case.prior_points is None:
        return
    from superodom_tpu_torch.checkpoint import insert_prior_points
    from superodom_tpu_torch.mapstate import total_points

    xyz = case.prior_points(rng)
    runner.state = insert_prior_points(runner.cfg, runner.state, xyz)
    runner.prior_map_total = int(total_points(runner.state.surf_map))


def stress_battery(
    points_per_scan: int = 4096,
    scale: float = 1.0,
    long_run: bool = False,
) -> List[StressCase]:
    """The adversarial qualification matrix.  ``scale`` multiplies run
    lengths (CI uses 1.0; tools/stress_matrix.py can stretch); ``long_run``
    adds the 2000+-scan endurance case (matrix-only — far too slow for CI).
    """
    pps = points_per_scan

    def n(base):  # scans per case
        return int(base * scale)

    def aggressive(rng):
        traj = aggressive_traj(duration=n(60) * 0.1 + 1.0, speed=3.0,
                               yaw_burst_rate=2.5)
        world = box_world((20.0, 15.0, 4.0))
        return make_scenario(rng, traj, world, n_scans=n(60),
                             points_per_scan=pps)

    def stop_go(rng):
        traj = stop_and_go_traj(duration=n(95) * 0.1 + 1.0, cruise=4.0)
        world = add_pillars(
            box_world((30.0, 10.0, 3.0), center=(15.0, 0.0, 0.0)),
            [(5.0, -4.0), (12.0, 4.0), (20.0, -3.5), (28.0, 3.0),
             (36.0, -4.0)], z0=-3.0,
        )
        return make_scenario(rng, traj, world, n_scans=n(95),
                             points_per_scan=pps)

    def _corridor_world():
        return corridor_to_room_world(corridor_len=50.0, width=4.0,
                                      height=3.0, room_half=(12.0, 9.0, 2.5),
                                      max_range=35.0)

    def _corridor_ds(rng, vio=False):
        # the corridor must be LONG relative to visibility so the room
        # cannot constrain x from deep inside it: 50 m corridor, 35 m
        # sensing range -> degenerate until the room wall is near.  The
        # platform decelerates and STOPS short of the room: under
        # position-holding prediction a fast approach outruns the
        # correspondence gates (sqrt(3*plane_res) ~ 0.77 m/scan), so the
        # drift-freeze can only be demonstrated at low closing speed.
        def pos(t):
            s = smoothstep_profile(t, [(8.0, 4.0), (4.0, 3.0), (5.0, 0.0)])
            return np.stack([s, np.zeros_like(s), np.zeros_like(s)], axis=-1)

        def rpy(t):
            z = np.zeros_like(t)
            return np.stack([z, z, z], axis=-1)

        traj = traj_from_curves(n(170) * 0.1 + 1.0, pos, rpy)
        return make_scenario(rng, traj, _corridor_world(), n_scans=n(170),
                             points_per_scan=pps, vio=vio,
                             vio_pos_noise=0.02)

    def corridor_room(rng):
        return _corridor_ds(rng)

    def vio_corridor(rng):
        # SLAM mode through the same degenerate corridor, but an external
        # odometry stream covers the run: the VIO prediction source + the
        # absolute-pose prior under degeneracy (LidarSlam.cpp:281-298) must
        # hold the unobservable axis near truth instead of stalling
        return _corridor_ds(rng, vio=True)

    def superloc_corridor(rng):
        # the SuperLoc headline mode: localization against a TRUE-geometry
        # prior map (update_map=False) through the degenerate corridor with
        # VIO aiding (laserMapping.cpp:129-177 + LidarSlam.cpp:281-298)
        return _corridor_ds(rng, vio=True)

    def localization_room(rng):
        # prior-map localization with a deliberate init-pose offset: the
        # estimator must snap back onto the map and track without growing it
        traj = straight_traj(duration=n(50) * 0.1 + 1.0, speed=2.0)
        return make_scenario(rng, traj, straight_room(), n_scans=n(50),
                             points_per_scan=pps)

    def imu_dropout(rng):
        # dropout during steady cruise: constant-velocity prediction must
        # carry the estimator (the reference's no-IMU operation,
        # featureExtraction.cpp:483-496), with undistortion unavailable
        traj = straight_traj(duration=n(60) * 0.1 + 1.0, speed=2.5)
        world = add_pillars(
            box_world((25.0, 10.0, 4.0), center=(10.0, 0.0, 0.0)),
            [(4.0, -4.5), (10.0, 4.0), (16.0, -3.5), (22.0, 4.5)], z0=-4.0,
        )
        return make_scenario(
            rng, traj, world, n_scans=n(60), points_per_scan=pps,
            faults=Faults(imu_dropout=[(3.5, 5.0)]),
        )

    def straight_room(rng_unused=None):
        return add_pillars(
            box_world((25.0, 10.0, 4.0), center=(8.0, 0.0, 0.0)),
            [(2.0, -4.5), (7.0, 4.0), (13.0, -3.5), (19.0, 4.5)], z0=-4.0,
        )

    def scan_dropout(rng):
        traj = straight_traj(duration=n(50) * 0.1 + 1.0, speed=2.0)
        return make_scenario(
            rng, traj, straight_room(), n_scans=n(50), points_per_scan=pps,
            faults=Faults(degraded_scans={25: 0.0, 26: 0.1, 27: 0.3}),
        )

    def outliers(rng):
        traj = straight_traj(duration=n(50) * 0.1 + 1.0, speed=2.0)
        return make_scenario(
            rng, traj, straight_room(), n_scans=n(50), points_per_scan=pps,
            faults=Faults(
                outlier_frac=0.03,
                clusters=[
                    MovingCluster(np.array([8.0, -6.0, 1.0]),
                                  np.array([0.0, 2.0, 0.0])),
                    MovingCluster(np.array([2.0, 5.0, 0.5]),
                                  np.array([1.5, -1.5, 0.0])),
                ],
            ),
        )

    def range_noise(rng):
        traj = straight_traj(duration=n(50) * 0.1 + 1.0, speed=2.0)
        return make_scenario(
            rng, traj, straight_room(), n_scans=n(50), points_per_scan=pps,
            faults=Faults(range_noise_k=0.002),
        )

    def far_field(rng):
        traj = straight_traj(duration=n(50) * 0.1 + 1.0, speed=3.0)
        world = open_field_world((90.0, 70.0, 10.0))
        return make_scenario(rng, traj, world, n_scans=n(50),
                             points_per_scan=pps)

    def closed_loop(rng):
        # one smooth lap ending exactly at the start pose: the reference
        # benchmark's signature pass/fail is end-vs-start distance < 0.1 m
        # (reference script/save_benchmark_result.py:263-267); the phase
        # profile is a smoothstep, so the platform leaves and re-enters
        # rest with zero velocity.  The lap must COMPLETE inside the scanned
        # window: scans cover [0, n*0.1] wall time, of which the first 1.5 s
        # are the static-init rest and curve time lags wall time through the
        # soft-start warp tau = tc^2/(tc+0.5) (traj_from_curves) — so the
        # lap length is sized to ~70% of the warped time the scans reach.
        n_sc = n(160)
        tc_last = n_sc * 0.1 - 1.5
        tau_last = tc_last * tc_last / (tc_last + 0.5)
        lap = max(0.8 * tau_last, 3.0)
        r = min(5.0, 0.4 * lap)  # caps peak speed at ~3.8 m/s at any scale

        def _phi(t):
            u = np.clip(t / lap, 0.0, 1.0)
            return 2.0 * np.pi * (u * u * (3.0 - 2.0 * u))

        def pos(t):
            phi = _phi(t)
            return np.stack(
                [r * np.cos(phi) - r, r * np.sin(phi), np.zeros_like(phi)],
                axis=-1)

        def rpy(t):
            phi = _phi(t)
            z = np.zeros_like(phi)
            return np.stack([z, z, phi], axis=-1)  # heading follows the lap

        traj = traj_from_curves(n_sc * 0.1, pos, rpy)
        # pillars OFF the lap path (circle of radius r centered at (-r, 0))
        world = add_pillars(box_world((18.0, 15.0, 4.0)),
                            [(-r, 0.0), (4.0, 7.0), (-2.0 * r - 4.0, -7.0)],
                            z0=-3.0)
        return make_scenario(rng, traj, world, n_scans=n_sc,
                             points_per_scan=pps)

    loc_frozen = LocalizationConfig(enabled=True, update_map=False)
    loc_offset = LocalizationConfig(
        enabled=True, update_map=False,
        init_pose_xyz=(0.0, 0.3, 0.0), init_pose_rpy=(0.0, 0.0, 0.05),
    )
    cases = [
        StressCase("aggressive_6dof", aggressive, 0.30, {}),
        StressCase("stop_and_go", stop_go, 0.30, {}),
        # full-ATE bound is corridor physics (x stalls at up to platform
        # speed while unobservable); the real assertions live in the check
        StressCase("corridor_to_room", corridor_room, 40.0, {},
                   check=_check_degeneracy_transition),
        StressCase("vio_corridor", vio_corridor, 0.60,
                   {"use_vio_undistortion": True},
                   check=_check_vio_engaged),
        StressCase("superloc_corridor", superloc_corridor, 0.60,
                   {"use_vio_undistortion": True, "localization": loc_frozen},
                   check=_check_superloc_transition,
                   prior_points=lambda rng: sample_world_points(
                       _corridor_world(), rng, spacing=0.2),
                   post_check=_check_map_frozen),
        StressCase("localization_room", localization_room, 0.25,
                   {"localization": loc_offset},
                   prior_points=lambda rng: sample_world_points(
                       straight_room(), rng, spacing=0.2),
                   post_check=_check_map_frozen),
        StressCase("imu_dropout", imu_dropout, 0.50, {}),
        StressCase("scan_dropout", scan_dropout, 0.30, {}),
        StressCase("outliers_clusters", outliers, 0.30, {}),
        StressCase("range_noise", range_noise, 0.40, {}),
        StressCase("closed_loop", closed_loop, 0.30, {},
                   check=_check_return_to_origin),
        StressCase("far_field", far_field, 2.0,
                   {"auto_voxel_size": True, "enable_lio_prediction": True},
                   check=_check_far_mode),
    ]
    if long_run:
        def endurance(rng):
            # 2000+ scans: repeated laps at sustained speed; exercises map
            # recentering/eviction, smoother resets, unbounded-runtime paths
            traj = aggressive_traj(duration=205.0, speed=3.0, roll_amp=0.2,
                                   pitch_amp=0.15, yaw_burst_rate=1.5)
            world = box_world((20.0, 15.0, 4.0))
            return make_scenario(rng, traj, world, n_scans=2000,
                                 points_per_scan=pps)

        def long_range(rng):
            # straight-line travel through >= half the 1024-cell
            # packed-coordinate wrap period (1100 m at cell_size 2.0):
            # proves wrap safety + eviction under real sustained travel
            traj = straight_traj(duration=116.0, speed=10.0)
            world = avenue_world(length=1200.0, max_range=60.0)
            return make_scenario(rng, traj, world, n_scans=1150,
                                 points_per_scan=pps)

        cases.append(StressCase("endurance_2000", endurance, 0.50, {}))
        cases.append(StressCase(
            "long_range_1km", long_range, 15.0,
            # 10 m/s sustained: the LIO source must carry the prediction
            {"enable_lio_prediction": True},
            post_check=_check_wrap_safety))
    return cases
