"""The fleet replay's world and trajectories, made on the device from a seed.

A torch rewrite of the replay benchmark's generator
(``superodom_tpu_torch/io/datasets.py``: ``BoxWorld``, ``circle_trajectory``,
``make_dataset``, ``bench_dataset``), frozen here so that the traffic does not
move with the program.  Differences from that generator, all forced by a
replay that may run any number of scans:

* one whole lap of ``lap_scans`` scans after ``static_scans`` at rest; the
  lap repeats, every time shifted by the lap's period (``lap_time``);
* the pose is an analytic function of time (yaw = angle on the circle, the
  angle linear in time once the lap starts), not a linear interpolation
  between the scans' poses, so the IMU is periodic over the lap and the
  wrap is continuous in pose, velocity and time;
* velocity and acceleration are central differences of that function at
  the IMU's sample spacing (the original's ``np.gradient`` of the samples),
  so the start from rest is spread over two samples as there.

Everything random comes from one ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch


class Trajectory(NamedTuple):
    """One robot's sequence as the program's runner takes it (numpy on the
    host; the runner reads ``scans[i].t_start / xyz_body / t_rel`` and
    ``imu.t / acc / gyr``), with its ground truth."""

    scans: list
    imu: "Imu"
    gt_q: np.ndarray  # [S, 4] wxyz at each scan's start
    gt_t: np.ndarray  # [S, 3]
    times: np.ndarray  # [S]


class Scan(NamedTuple):
    t_start: float
    xyz_body: np.ndarray  # [n, 3] float32, distorted body-frame points
    t_rel: np.ndarray  # [n] float32, sorted


class Imu(NamedTuple):
    t: np.ndarray  # float64
    acc: np.ndarray  # float32
    gyr: np.ndarray  # float32


def lap_time(p: dict) -> float:
    return p["lap_scans"] * p["scan_period"]


def lap_start(p: dict) -> float:
    return p["static_scans"] * p["scan_period"]


def step_index(p: dict, s: int):
    """(index into the rest and the lap, laps wrapped) of step ``s``: past
    the lap's end the index wraps into the lap again."""
    n0 = p["static_scans"]
    if s < n0 + p["lap_scans"]:
        return s, 0
    j = s - n0
    return n0 + j % p["lap_scans"], j // p["lap_scans"]


def angle_at(p: dict, t: torch.Tensor) -> torch.Tensor:
    """Angle on the circle at time ``t``: 0 at rest, then one turn a lap."""
    omega = 2.0 * math.pi / lap_time(p)
    return omega * torch.clamp_min(t - lap_start(p), 0.0)


def pose_at(p: dict, t: torch.Tensor):
    """(q wxyz, position) of the body at times ``t`` (float64)."""
    a = angle_at(p, t)
    r, z = p["radius"], p["z_amp"]
    pos = torch.stack([r * torch.sin(a), r * (1.0 - torch.cos(a)),
                       z * torch.sin(2.0 * a)], -1)
    zero = torch.zeros_like(a)
    q = torch.stack([torch.cos(a / 2), zero, zero, torch.sin(a / 2)], -1)
    return q, pos


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    w, u = q[..., :1], q[..., 1:]
    uv = torch.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.cross(u, uv, dim=-1))


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def _imu(p: dict, gen: torch.Generator, dev) -> Imu:
    """IMU samples over the rest and one lap plus a scan, as the original:
    gyro about body z, specific force in the body frame, biases and white
    noise."""
    n_scans = p["static_scans"] + p["lap_scans"]
    dt = 1.0 / p["imu_rate"]
    t_end = n_scans * p["scan_period"] + p["scan_period"]
    t = torch.arange(0.0, t_end + dt, dt, dtype=torch.float64, device=dev)

    def pos(tt):
        return pose_at(p, tt)[1]

    # np.gradient twice on the samples = these stencils on the function
    v = (pos(t + dt) - pos(t - dt)) / (2 * dt)
    a = (pos(t + 2 * dt) - 2 * pos(t) + pos(t - 2 * dt)) / (4 * dt * dt)
    wz = (angle_at(p, t + dt) - angle_at(p, t - dt)) / (2 * dt)
    del v
    g_w = torch.tensor([0.0, 0.0, -p["gravity"]], dtype=torch.float64,
                       device=dev)
    q = pose_at(p, t)[0]
    acc = quat_rotate(quat_conj(q), a - g_w)
    gyr = torch.stack([torch.zeros_like(wz), torch.zeros_like(wz), wz], -1)
    gyr = gyr + torch.tensor(p["gyr_bias"], dtype=torch.float64, device=dev) \
        + p["noise_gyr"] * torch.randn(gyr.shape, generator=gen,
                                       dtype=torch.float64, device=dev)
    acc = acc + torch.tensor(p["acc_bias"], dtype=torch.float64, device=dev) \
        + p["noise_acc"] * torch.randn(acc.shape, generator=gen,
                                       dtype=torch.float64, device=dev)
    return Imu(t=t.cpu().numpy(), acc=acc.float().cpu().numpy(),
               gyr=gyr.float().cpu().numpy())


def _scans(p: dict, n_points: int, gen: torch.Generator, dev,
           block: int = 32) -> List[Scan]:
    """Distorted sweeps of the box's walls: ``n_points`` samples a scan on
    the six faces by area, those within ``max_range`` kept, each seen from
    the pose at its own time.  Made ``block`` scans at a time."""
    n_scans = p["static_scans"] + p["lap_scans"]
    he = torch.tensor(p["box_half_extent"], dtype=torch.float64, device=dev)
    areas = torch.stack([he[1] * he[2], he[0] * he[2], he[0] * he[1]])
    cum = torch.cumsum(areas / areas.sum(), 0)
    out = []
    for s0 in range(0, n_scans, block):
        s = min(block, n_scans - s0)
        t0 = torch.arange(s0, s0 + s, dtype=torch.float64,
                          device=dev) * p["scan_period"]
        u = torch.rand((s, n_points), generator=gen, dtype=torch.float64,
                       device=dev)
        axis = torch.searchsorted(cum, u.contiguous()).clamp_max(2)
        sign = torch.where(torch.rand((s, n_points), generator=gen,
                                      device=dev) < 0.5, -1.0, 1.0
                           ).to(torch.float64)
        pts = (2.0 * torch.rand((s, n_points, 3), generator=gen,
                                dtype=torch.float64, device=dev) - 1.0) * he
        face = torch.nn.functional.one_hot(axis, 3).bool()
        pts = torch.where(face, (sign[..., None] * he), pts)
        _, p_scan = pose_at(p, t0)
        ok = torch.linalg.norm(pts - p_scan[:, None, :], dim=-1) \
            < p["max_range"]
        # each scan's kept points first, in draw order; their times sorted
        order = torch.argsort((~ok).to(torch.int8), dim=1, stable=True)
        pts = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
        n_ok = ok.sum(1)
        tr = torch.rand((s, n_points), generator=gen, dtype=torch.float64,
                        device=dev) * p["scan_period"]
        lane = torch.arange(n_points, device=dev)[None, :]
        tr = torch.where(lane < n_ok[:, None], tr, math.inf)
        tr = torch.sort(tr, dim=1).values
        tr = torch.where(lane < n_ok[:, None], tr, 0.0)
        # the clock's float32 times, as the sensor stamps them
        tr = tr.float().double()
        qs, ps = pose_at(p, t0[:, None] + tr)
        body = quat_rotate(quat_conj(qs), pts - ps)
        body = body + p["point_noise"] * torch.randn(
            body.shape, generator=gen, dtype=torch.float64, device=dev)
        body = body.float().cpu().numpy()
        tr = tr.float().cpu().numpy()
        n_ok = n_ok.cpu().numpy()
        t0 = t0.cpu().numpy()
        for i in range(s):
            n = int(n_ok[i])
            out.append(Scan(t_start=float(t0[i]), xyz_body=body[i, :n],
                            t_rel=tr[i, :n]))
    return out


def make_trajectory(p: dict, n_points: int, gen: torch.Generator,
                    dev) -> Trajectory:
    """One robot's rest and lap: scans, IMU and ground truth."""
    imu = _imu(p, gen, dev)
    scans = _scans(p, n_points, gen, dev)
    times = np.asarray([s.t_start for s in scans])
    q, t = pose_at(p, torch.as_tensor(times, dtype=torch.float64))
    return Trajectory(scans=scans, imu=imu, gt_q=q.float().numpy(),
                      gt_t=t.float().numpy(), times=times)


def make_trajectories(p: dict, n_points: int, seed: int,
                      dev) -> List[Trajectory]:
    """``p["trajectories"]`` robots' sequences, drawn in turn from one
    generator seeded with ``seed``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return [make_trajectory(p, n_points, gen, dev)
            for _ in range(p["trajectories"])]
