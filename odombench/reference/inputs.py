"""The step's inputs worked out again from the raw sequence: the IMU
buffer's orientation chain, static initialisation and windows (a numpy
rewrite of ``superodom_tpu_torch/csrc/native_loader.cpp``'s
``so_imu_buffer_*``, identity extrinsics) and the scan's host layout (a
copy of ``OdometryRunner.make_host_scan`` / ``_imu_window`` with edge
features off)."""

from __future__ import annotations

import bisect
import math
from typing import List

import numpy as np

from odombench.reference.frontend import ImuWindow, Scan, decimated_width


def _q_mul(a, b):
    return np.array([
        a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3],
        a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2],
        a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1],
        a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0]])


def _q_normalize(q):
    n = math.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    return q / n if n > 0 else q


def _so3_expq(w):
    th = math.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
    if th < 1e-12:
        q = np.array([1.0, 0.5 * w[0], 0.5 * w[1], 0.5 * w[2]])
    else:
        s = math.sin(0.5 * th) / th
        q = np.array([math.cos(0.5 * th), s * w[0], s * w[1], s * w[2]])
    return _q_normalize(q)


class ImuBuffer:
    """Time-ordered IMU samples with the gyro orientation chain
    (trapezoid on rates) and the static initialisation over the first
    ``window_sec`` (gyro bias from the mean rate, roll and pitch from the
    mean specific force)."""

    def __init__(self, rate: float):
        self.rate = rate
        self.t: List[float] = []
        self.acc: List[np.ndarray] = []
        self.gyr: List[np.ndarray] = []
        self.q: List[np.ndarray] = []
        self.q_last = np.array([1.0, 0.0, 0.0, 0.0])
        self.gyr_last = np.zeros(3)
        self.t_last = -1.0
        self.bias = np.zeros(3)
        self.initialized = False

    def _chain(self, t, gyr_c):
        dt = 1.0 / self.rate if self.t_last < 0 else t - self.t_last
        dt = min(max(dt, 0.0), 0.5)
        w = dt * 0.5 * (gyr_c + self.gyr_last)
        q = _q_normalize(_q_mul(self.q_last, _so3_expq(w)))
        self.q_last, self.gyr_last, self.t_last = q, gyr_c.copy(), t
        return q

    def add(self, t, acc, gyr):
        acc_c = np.asarray(acc, np.float32).astype(np.float64)
        gyr_c = np.asarray(gyr, np.float32).astype(np.float64) - self.bias
        q = self._chain(t, gyr_c)
        self.t.append(float(t))
        self.acc.append(acc_c.astype(np.float32))
        self.gyr.append(gyr_c.astype(np.float32))
        self.q.append(q.astype(np.float32))

    def static_init(self, window_sec: float) -> bool:
        if len(self.t) < 10:
            return False
        t0 = self.t[0]
        n = 0
        acc_m, gyr_m = np.zeros(3), np.zeros(3)
        for t, a, g in zip(self.t, self.acc, self.gyr):
            if t > t0 + window_sec:
                break
            acc_m += a.astype(np.float64)
            gyr_m += g.astype(np.float64)
            n += 1
        if n < 10:
            return False
        acc_m /= n
        gyr_m /= n
        theta = math.atan2(acc_m[0], math.sqrt(acc_m[1] ** 2 + acc_m[2] ** 2))
        phi = math.atan2(-acc_m[1], acc_m[2])
        ct, st, cp, sp = (math.cos(theta), math.sin(theta), math.cos(phi),
                          math.sin(phi))
        R = np.array([[ct, 0, st], [sp * st, cp, -sp * ct],
                      [-cp * st, sp, cp * ct]])
        Rt = R.T
        self.q_last = _q_normalize(_matrix_to_quat(Rt))
        self.bias = self.bias + gyr_m
        self.gyr_last = np.zeros(3)
        self.t_last = -1.0
        for i, t in enumerate(self.t):
            g = (self.gyr[i].astype(np.float64) - gyr_m).astype(np.float32)
            self.gyr[i] = g
            self.q[i] = self._chain(t, g.astype(np.float64)).astype(
                np.float32)
        self.initialized = True
        return True

    def covers(self, t0: float, t1: float) -> bool:
        return bool(self.t) and self.t[0] <= t0 and self.t[-1] > t1

    def window(self, t0: float, t1: float, max_out: int):
        lo = bisect.bisect_right(self.t, t0)
        if lo > 0:
            lo -= 1
        hi = bisect.bisect_right(self.t, t1)
        if hi < len(self.t):
            hi += 1
        sel = list(range(lo, hi))
        n = len(sel)
        out_n = min(n, max_out)
        idx = [k if n <= max_out else (k * (n - 1)) // max(out_n - 1, 1)
               for k in range(out_n)]
        pick = [sel[i] for i in idx]
        return (np.asarray([self.t[i] for i in pick], np.float64),
                np.asarray([self.acc[i] for i in pick], np.float32),
                np.asarray([self.gyr[i] for i in pick], np.float32),
                np.asarray([self.q[i] for i in pick], np.float32))


def _matrix_to_quat(Rt):
    r = Rt.reshape(-1)
    tr = r[0] + r[4] + r[8]
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (r[7] - r[5]) / s, (r[2] - r[6]) / s,
                         (r[3] - r[1]) / s])
    if r[0] > r[4] and r[0] > r[8]:
        s = math.sqrt(1.0 + r[0] - r[4] - r[8]) * 2
        return np.array([(r[7] - r[5]) / s, 0.25 * s, (r[1] + r[3]) / s,
                         (r[2] + r[6]) / s])
    if r[4] > r[8]:
        s = math.sqrt(1.0 + r[4] - r[0] - r[8]) * 2
        return np.array([(r[2] - r[6]) / s, (r[1] + r[3]) / s, 0.25 * s,
                         (r[5] + r[7]) / s])
    s = math.sqrt(1.0 + r[8] - r[0] - r[4]) * 2
    return np.array([(r[3] - r[1]) / s, (r[2] + r[6]) / s, (r[5] + r[7]) / s,
                     0.25 * s])


def ingest(imu, rate: float, init_window_sec: float) -> ImuBuffer:
    """Every sample of a sequence's IMU stream, static initialisation once
    ``init_window_sec`` of it is in (the replay's order)."""
    buf = ImuBuffer(rate)
    t_first = None
    for i in range(len(imu.t)):
        t = float(imu.t[i])
        buf.add(t, imu.acc[i], imu.gyr[i])
        if not buf.initialized:
            if t_first is None:
                t_first = t
            if t - t_first >= init_window_sec:
                buf.static_init(init_window_sec)
    return buf


def imu_window(buf: ImuBuffer, t0: float, t1: float, m: int):
    """(ImuWindow of numpy leaves, available)."""
    if not buf.initialized or not buf.covers(t0, t1):
        return ImuWindow(
            t=np.zeros(m, np.float32), acc=np.zeros((m, 3), np.float32),
            gyr=np.zeros((m, 3), np.float32),
            q=np.tile(np.array([1.0, 0, 0, 0], np.float32), (m, 1)),
            mask=np.zeros(m, bool)), False
    ts, acc, gyr, qs = buf.window(t0, t1, m)
    pad = m - len(ts)
    return ImuWindow(
        t=np.pad(ts, (0, pad)).astype(np.float32),
        acc=np.pad(acc, ((0, pad), (0, 0))).astype(np.float32),
        gyr=np.pad(gyr, ((0, pad), (0, 0))).astype(np.float32),
        q=np.concatenate([qs, np.tile(np.array([1.0, 0, 0, 0], np.float32),
                                      (pad, 1))]).astype(np.float32),
        mask=np.arange(m) < len(ts)), True


def host_scan(sensor, t_start: float, xyz: np.ndarray,
              t_rel: np.ndarray) -> Scan:
    """The scan's layout with the host stride and the duplicate gate
    (edge features off)."""
    n_max, stride = sensor.max_points, sensor.filter_point_size
    n = min(len(xyz), n_max)
    xyz_arr = np.zeros((n_max, 3), np.float32)
    t_arr = np.zeros((n_max,), np.float32)
    xyz_arr[:n] = xyz[:n]
    t_arr[:n] = t_rel[:n]
    mask = np.arange(n_max) < n
    if stride > 1:
        w = decimated_width(n_max, stride)
        cand = xyz_arr[1::stride][:w]
        prev = xyz_arr[0::stride][:w]
        dup = np.all(np.abs(cand - prev) <= 1e-7, axis=-1)
        return Scan(xyz=cand, t_rel=t_arr[1::stride][:w],
                    mask=mask[1::stride][:w] & ~dup,
                    t_start=np.asarray(t_start, np.float32),
                    ring=np.zeros((w,), np.int32))
    return Scan(xyz=xyz_arr, t_rel=t_arr, mask=mask,
                t_start=np.asarray(t_start, np.float32),
                ring=np.zeros((n_max,), np.int32))


def step_inputs(cfg, buf: ImuBuffer, scan):
    """(Scan, ImuWindow, available) of one raw scan, numpy leaves."""
    t_end = scan.t_start + (float(scan.t_rel[-1]) if len(scan.t_rel)
                            else 0.0)
    win, ok = imu_window(buf, scan.t_start, t_end, cfg.imu.max_imu_per_scan)
    return (host_scan(cfg.sensor, scan.t_start, scan.xyz_body, scan.t_rel),
            win, np.asarray(ok))
