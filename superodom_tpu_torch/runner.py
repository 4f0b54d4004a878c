"""Host-side shell: feeds scans + IMU windows through the step and collects
trajectories and per-scan statistics (counterpart of the per-scan half of
``superodom_tpu.runner``).

IMU samples go through the native buffer (conditioning into the laser
frame, static init, orientation chain); each scan is decimated on the host
and shipped to the device as one Scan.  Chunked replay is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional

import numpy as np
import torch

from superodom_tpu_torch import kernels, native
from superodom_tpu_torch.config import Extrinsics, PipelineConfig
from superodom_tpu_torch.convert import to_numpy
from superodom_tpu_torch.frontend import ImuWindow, Scan, decimated_width
from superodom_tpu_torch.pipeline import StepOutput, init_state, step


@dataclasses.dataclass
class RunResult:
    poses_q: np.ndarray  # [n,4]
    poses_t: np.ndarray  # [n,3]
    smoothed_t: np.ndarray  # [n,3]
    stats: List[dict]
    wall_time_s: float
    scans_per_sec: float

    def return_to_origin_error(self) -> float:
        return float(np.linalg.norm(self.poses_t[-1] - self.poses_t[0]))


class OdometryRunner:
    """Feeds scans + IMU windows through :func:`pipeline.step` on
    ``device`` — the card unless the caller names ``device="cpu"``.
    Because the native buffer conditions IMU samples into the laser frame,
    the step runs with identity extrinsics."""

    def __init__(self, cfg: PipelineConfig, device="cuda",
                 dtype=torch.float32):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.condition_imu = not (
            np.allclose(cfg.extrinsics.R(), np.eye(3), atol=1e-9)
            and np.allclose(cfg.extrinsics.t(), 0.0, atol=1e-12))
        self.step_cfg = (dataclasses.replace(cfg, extrinsics=Extrinsics())
                         if self.condition_imu else cfg)
        self.state = init_state(self.step_cfg, dtype, self.device)
        self.imu_buf = native.ImuBuffer(
            capacity=1 << 20,
            R_imu_laser=cfg.extrinsics.R() if self.condition_imu else None,
            t_imu_laser=cfg.extrinsics.t() if self.condition_imu else None,
            imu_rate=cfg.imu.imu_rate,
        )
        self.imu_init = None  # (acc_mean, gyr_bias, q0) after static init
        self._imu_t_first: Optional[float] = None

    # ---------------- IMU ingestion ---------------------------------------
    def add_imu(self, t: float, acc: np.ndarray, gyr: np.ndarray):
        """Ingest one raw IMU sample; static init runs once
        ``init_window_sec`` of data has accumulated."""
        self.imu_buf.add(t, np.asarray(acc, np.float32),
                         np.asarray(gyr, np.float32))
        if not self.imu_buf.initialized:
            if self._imu_t_first is None:
                self._imu_t_first = t
            if t - self._imu_t_first >= self.cfg.imu.init_window_sec:
                self.imu_init = self.imu_buf.static_init(
                    self.cfg.imu.init_window_sec)

    def _to_device(self, tree):
        # np.array, not np.ascontiguousarray: the latter turns 0-d into 1-d
        return type(tree)(*(torch.from_numpy(np.array(a)).to(self.device)
                            for a in tree))

    def _imu_window(self, t0: float, t1: float):
        """IMU window covering [t0, t1] on the device, and whether the
        buffer covers the sweep (pre-init scans run LiDAR-only)."""
        m = self.cfg.imu.max_imu_per_scan
        if not self.imu_buf.initialized or self.imu_buf.sync(t0, t1) != 1:
            ts = np.zeros((0,))
            acc = gyr = np.zeros((0, 3), np.float32)
            qs = np.zeros((0, 4), np.float32)
            ok = False
        else:
            ts, acc, gyr, qs = self.imu_buf.window(t0, t1, m)
            ok = True
        pad = m - len(ts)
        return self._to_device(ImuWindow(
            t=np.pad(ts, (0, pad)).astype(np.float32),
            acc=np.pad(acc, ((0, pad), (0, 0))).astype(np.float32),
            gyr=np.pad(gyr, ((0, pad), (0, 0))).astype(np.float32),
            q=np.concatenate([qs, np.tile(np.array([1.0, 0, 0, 0],
                                                   np.float32), (pad, 1))]
                             ).astype(np.float32),
            mask=np.arange(m) < len(ts),
        )), ok

    # ---------------- scan processing --------------------------------------
    def make_scan(self, t_start: float, xyz: np.ndarray,
                  t_rel: np.ndarray) -> Scan:
        """Pack a raw cloud into the Scan layout on the device.  With
        ``filter_point_size > 1`` the stride selection and the duplicate
        gate run here on the host, and only the ~N/stride candidate lanes
        are uploaded."""
        n_max = self.cfg.sensor.max_points
        stride = self.cfg.sensor.filter_point_size
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
            scan = Scan(xyz=cand, t_rel=t_arr[1::stride][:w],
                        mask=mask[1::stride][:w] & ~dup,
                        t_start=np.asarray(t_start, np.float32),
                        ring=np.zeros((w,), np.int32))
        else:
            scan = Scan(xyz=xyz_arr, t_rel=t_arr, mask=mask,
                        t_start=np.asarray(t_start, np.float32),
                        ring=np.zeros((n_max,), np.int32))
        return self._to_device(scan)

    def process_scan(self, t_start, xyz, t_rel) -> StepOutput:
        scan = self.make_scan(t_start, xyz, t_rel)
        t_end = t_start + (float(t_rel[-1]) if len(t_rel) else 0.0)
        window, synced = self._imu_window(t_start, t_end)
        self.state, out = step(
            self.step_cfg, self.state, scan, window,
            torch.tensor(synced, device=self.device))
        return out

    @staticmethod
    def _stats_record(out: StepOutput, i: int, t: Optional[float] = None,
                      time_ms: Optional[float] = None) -> dict:
        """One per-scan stats record (OptimizationStats.msg surface) from a
        StepOutput with numpy leaves."""
        icp = out.icp
        rec = {
            "i": i,
            "surf_stack": int(out.surf_stack_num),
            "edge_stack": int(out.edge_stack_num),
            "surf_map": int(out.surf_map_num),
            "edge_map": int(out.edge_map_num),
            "pred_source": int(out.prediction_source),
            "n_iterations": int(icp.n_iterations),
            "uncertainty": np.asarray(icp.uncertainty).tolist(),
            "degenerate": bool(icp.degenerate),
            "imu_healthy": bool(out.imu_healthy),
            "translation_from_last": float(out.translation_from_last),
            "rotation_from_last": float(out.rotation_from_last),
            "total_translation": float(out.total_translation),
            "total_rotation": float(out.total_rotation),
            "average_distance": float(out.average_distance),
            "motion_accepted": bool(out.motion_accepted),
            "plane_rejection_hist": np.asarray(
                icp.plane_rejection_hist).tolist(),
            "line_rejection_hist": np.asarray(
                icp.line_rejection_hist).tolist(),
            "obs_histogram": np.asarray(icp.obs_histogram).tolist(),
            "position_error": float(icp.error.position_error),
            "position_error_dir": np.asarray(
                icp.error.position_error_dir).tolist(),
            "pos_inverse_condition": float(icp.error.pos_inverse_condition),
            "orientation_error_deg": float(icp.error.orientation_error_deg),
            "orientation_error_dir": np.asarray(
                icp.error.orientation_error_dir).tolist(),
            "ori_inverse_condition": float(icp.error.ori_inverse_condition),
            "iterations": [
                {
                    "translation_norm": float(icp.iter_trans_norm[k]),
                    "rotation_norm": float(icp.iter_rot_norm[k]),
                    "num_surf_from_scan": int(icp.iter_surf_num[k]),
                    "num_corner_from_scan": int(icp.iter_edge_num[k]),
                }
                for k in range(len(np.asarray(icp.iter_trans_norm)))
            ],
            "acc_bias": np.asarray(out.acc_bias).tolist(),
            "gyr_bias": np.asarray(out.gyr_bias).tolist(),
        }
        if t is not None:
            rec["t"] = t
        if time_ms is not None:
            rec["time_elapsed_ms"] = round(time_ms, 3)
            rec["latency_ms"] = round(time_ms, 3)
        return rec

    # ---------------- dataset replay ---------------------------------------
    def run_dataset(self, dataset, use_imu: bool = True,
                    log_path: Optional[str] = None) -> RunResult:
        """Replay a dataset scan by scan.  On CUDA the kernels are built
        before the timed loop (the counterpart of the JAX runner's compile
        warm-up); no step runs before it."""
        if self.device.type == "cuda":
            kernels.load()
        imu_i = 0
        imu = dataset.imu
        poses_q, poses_t, smoothed_t, stats = [], [], [], []
        t_begin = time.perf_counter()
        for i, s in enumerate(dataset.scans):
            t_end_scan = (s.t_start + float(s.t_rel[-1]) if len(s.t_rel)
                          else s.t_start)
            if use_imu:
                while imu_i < len(imu.t) and imu.t[imu_i] <= t_end_scan + 0.02:
                    self.add_imu(imu.t[imu_i], imu.acc[imu_i], imu.gyr[imu_i])
                    imu_i += 1
            t_scan0 = time.perf_counter()
            out = to_numpy(self.process_scan(s.t_start, s.xyz_body, s.t_rel))
            scan_ms = (time.perf_counter() - t_scan0) * 1000.0
            poses_q.append(out.pose.q)
            poses_t.append(out.pose.t)
            smoothed_t.append(out.smoothed_pose.t)
            stats.append(self._stats_record(out, i, t=float(s.t_start),
                                            time_ms=scan_ms))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t_begin

        if log_path:
            with open(log_path, "w") as f:
                for rec in stats:
                    f.write(json.dumps(rec) + "\n")
        return RunResult(
            poses_q=np.asarray(poses_q),
            poses_t=np.asarray(poses_t),
            smoothed_t=np.asarray(smoothed_t),
            stats=stats,
            wall_time_s=wall,
            scans_per_sec=len(dataset.scans) / wall,
        )
