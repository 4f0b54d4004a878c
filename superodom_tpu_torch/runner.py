"""Host-side shell: feeds scans + IMU windows through the step and collects
trajectories and per-scan statistics (counterpart of the per-scan half of
``superodom_tpu.runner``).

IMU samples go through the native buffer (conditioning into the laser
frame, static init, orientation chain); each scan is decimated on the host
(or, with edge features on, kept at full width with its rings) and
shipped to the device as one Scan.  Two replays: :meth:`run_dataset`
steps scan by scan as the IMU arrives; :meth:`run_dataset_chunked` ingests
the whole IMU stream first, stacks every scan's inputs on the host and
steps them in chunks, with the inputs on the device before its timer
starts (the replay the reference benchmark measures).  Either can stream
the IMU-rate odometry beside the poses.  With ``use_vio_undistortion`` an
external (VIO) pose stream, fed by :meth:`OdometryRunner.add_vio_pose` or
a dataset's ``vio``, is cut into one window a scan on the host and ships
with the scan.
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
from superodom_tpu_torch.frontend import (
    ImuWindow,
    Scan,
    VioWindow,
    decimated_width,
)
from superodom_tpu_torch.geometry import Pose
from superodom_tpu_torch.inertial import propagate_high_rate
from superodom_tpu_torch.pipeline import (
    StepOutput,
    empty_imu_window,
    empty_vio_window,
    init_state,
    make_chunked_step_fn,
    step,
    tree_map,
)


@dataclasses.dataclass
class RunResult:
    poses_q: np.ndarray  # [n,4]
    poses_t: np.ndarray  # [n,3]
    smoothed_t: np.ndarray  # [n,3]
    stats: List[dict]
    wall_time_s: float
    scans_per_sec: float
    # the IMU-rate odometry stream (every high_rate_decimation-th sample,
    # ~50 Hz), with run_dataset(high_rate=True) or run_dataset_chunked's
    high_rate_t: Optional[np.ndarray] = None  # [m] sample times
    high_rate_q: Optional[np.ndarray] = None  # [m,4]
    high_rate_p: Optional[np.ndarray] = None  # [m,3]
    high_rate_v: Optional[np.ndarray] = None  # [m,3]

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
        self._last_window: Optional[ImuWindow] = None  # on the device
        # external-odometry pose samples for the 6-DoF path undistortion,
        # bounded like the reference's visualOdomBuf (5000)
        self._vio_samples: list = []

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
        return tree_map(lambda a: torch.from_numpy(np.array(a)).to(
            self.device), tree)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _imu_window(self, t0: float, t1: float):
        """IMU window covering [t0, t1] with host leaves, and whether the
        buffer covers the sweep (pre-init scans run LiDAR-only)."""
        m = self.cfg.imu.max_imu_per_scan
        if not self.imu_buf.initialized or self.imu_buf.sync(t0, t1) != 1:
            return to_numpy(empty_imu_window(m)), False
        ts, acc, gyr, qs = self.imu_buf.window(t0, t1, m)
        pad = m - len(ts)
        return ImuWindow(
            t=np.pad(ts, (0, pad)).astype(np.float32),
            acc=np.pad(acc, ((0, pad), (0, 0))).astype(np.float32),
            gyr=np.pad(gyr, ((0, pad), (0, 0))).astype(np.float32),
            q=np.concatenate([qs, np.tile(np.array([1.0, 0, 0, 0],
                                                   np.float32), (pad, 1))]
                             ).astype(np.float32),
            mask=np.arange(m) < len(ts),
        ), True

    # ---------------- external odometry (VIO) aiding ------------------------
    def add_vio_pose(self, t: float, q_wxyz: np.ndarray, p_xyz: np.ndarray):
        """Ingest one external-odometry pose sample (T_w_lidar at time t),
        the reference's visual_odom_Handler feeding visualOdomBuf."""
        self._vio_samples.append((float(t), np.asarray(q_wxyz, np.float32),
                                  np.asarray(p_xyz, np.float32)))
        if len(self._vio_samples) > 5000:
            self._vio_samples.pop(0)

    def _vio_window(self, t0: float, t1: float) -> VioWindow:
        """Pose samples bracketing [t0, t1] with host leaves, evenly
        decimated to ``max_vio_per_scan`` (endpoints kept); all masked out
        when the stream does not cover the sweep (the step's coverage gate
        checks again)."""
        k = self.cfg.max_vio_per_scan
        ts = np.asarray([s[0] for s in self._vio_samples])
        if len(ts) < 2 or ts[0] > t0 or ts[-1] < t1:
            return to_numpy(empty_vio_window(k))
        lo = int(np.searchsorted(ts, t0, side="right")) - 1
        hi = int(np.searchsorted(ts, t1, side="left")) + 1
        sel = list(range(max(lo, 0), min(hi, len(ts))))
        if len(sel) > k:
            idx = np.linspace(0, len(sel) - 1, k).round().astype(int)
            sel = [sel[i] for i in idx]
        n = len(sel)
        pad = k - n
        q = np.stack([self._vio_samples[i][1] for i in sel])
        p = np.stack([self._vio_samples[i][2] for i in sel])
        return VioWindow(
            t=np.pad(ts[sel], (0, pad)).astype(np.float32),
            q=np.concatenate([q, np.tile(np.array([1, 0, 0, 0], np.float32),
                                         (pad, 1))]).astype(np.float32),
            p=np.pad(p, ((0, pad), (0, 0))).astype(np.float32),
            mask=np.arange(k) < n,
        )

    def set_vio_pose(self, q_wxyz: np.ndarray, t_xyz: np.ndarray,
                     available: bool = True):
        """Set the external absolute pose estimate: the prediction source
        and the absolute-pose constraint under degeneracy
        (addAbsolutePoseConstraints, LidarSlam.cpp:281-298)."""
        self.state = self.state._replace(
            vio_pose=Pose(torch.tensor(np.asarray(q_wxyz), dtype=self.dtype,
                                       device=self.device),
                          torch.tensor(np.asarray(t_xyz), dtype=self.dtype,
                                       device=self.device)),
            vio_available=torch.tensor(bool(available), device=self.device))

    def _ingest_dataset_vio(self, dataset) -> None:
        """Feed a dataset's external-odometry stream (``dataset.vio``),
        where it has one and the VIO path is on, once."""
        vio = getattr(dataset, "vio", None)
        if vio is None or not self.cfg.use_vio_undistortion:
            return
        if self._vio_samples and self._vio_samples[-1][0] >= float(vio.t[0]):
            return  # already ingested
        for i in range(len(vio.t)):
            self.add_vio_pose(vio.t[i], vio.q[i], vio.p[i])

    def _host_inputs(self, t_start: float, xyz: np.ndarray,
                     t_rel: np.ndarray, use_imu: bool = True):
        """One scan's step inputs with host leaves: (Scan, ImuWindow,
        avail) and, with ``use_vio_undistortion``, its VioWindow."""
        t_end = t_start + (float(t_rel[-1]) if len(t_rel) else 0.0)
        win, ok = (self._imu_window(t_start, t_end) if use_imu
                   else (to_numpy(empty_imu_window(
                       self.cfg.imu.max_imu_per_scan)), False))
        out = (self.make_host_scan(t_start, xyz, t_rel), win, np.asarray(ok))
        if self.cfg.use_vio_undistortion:
            out = out + (self._vio_window(t_start, t_end),)
        return out

    # ---------------- scan processing --------------------------------------
    def make_scan(self, t_start: float, xyz: np.ndarray, t_rel: np.ndarray,
                  ring: Optional[np.ndarray] = None) -> Scan:
        """:meth:`make_host_scan` on the device."""
        return self._to_device(self.make_host_scan(t_start, xyz, t_rel, ring))

    def make_host_scan(self, t_start: float, xyz: np.ndarray,
                       t_rel: np.ndarray,
                       ring: Optional[np.ndarray] = None) -> Scan:
        """Pack a raw cloud into the Scan layout, host leaves.  With
        ``filter_point_size > 1`` and edge features off, the stride
        selection and the duplicate gate run here on the host, and only the
        ~N/stride candidate lanes are uploaded.  With edge features on the
        full ring-major cloud ships (the curvature stencil needs the raw
        neighbours), ``ring`` padded with zeros (all zeros when not
        given)."""
        n_max = self.cfg.sensor.max_points
        stride = self.cfg.sensor.filter_point_size
        n = min(len(xyz), n_max)
        xyz_arr = np.zeros((n_max, 3), np.float32)
        t_arr = np.zeros((n_max,), np.float32)
        xyz_arr[:n] = xyz[:n]
        t_arr[:n] = t_rel[:n]
        mask = np.arange(n_max) < n
        if stride > 1 and not self.cfg.use_edge_features:
            w = decimated_width(n_max, stride)
            cand = xyz_arr[1::stride][:w]
            prev = xyz_arr[0::stride][:w]
            dup = np.all(np.abs(cand - prev) <= 1e-7, axis=-1)
            return Scan(xyz=cand, t_rel=t_arr[1::stride][:w],
                        mask=mask[1::stride][:w] & ~dup,
                        t_start=np.asarray(t_start, np.float32),
                        ring=np.zeros((w,), np.int32))
        ring_arr = np.zeros((n_max,), np.int32)
        if ring is not None:
            ring_arr[:n] = ring[:n]
        return Scan(xyz=xyz_arr, t_rel=t_arr, mask=mask,
                    t_start=np.asarray(t_start, np.float32), ring=ring_arr)

    def process_scan(self, t_start, xyz, t_rel) -> StepOutput:
        inputs = self._to_device(self._host_inputs(t_start, xyz, t_rel))
        self.state, out = step(self.step_cfg, self.state, *inputs)
        self._last_window = inputs[1]
        return out

    def high_rate_states(self):
        """IMU-rate odometry over the last scan's IMU window: the latest
        smoothed state propagated through it with the current biases (the
        ~200 Hz state_estimation output, imuPreintegration.cpp:544-570).
        With ``use_imu_roll_pitch`` the orientations are the IMU's own
        chain (prepareOdometryMessage, imuPreintegration.cpp:713-723).

        Returns (times, poses_q [n,4], poses_t [n,3], velocities [n,3])
        of the window's live samples."""
        if self._last_window is None:
            raise RuntimeError("no scan processed yet")
        poses, vels, mask = propagate_high_rate(self.state.smoother,
                                                self.cfg.imu,
                                                self._last_window)
        win, poses, vels, m = to_numpy((self._last_window, poses, vels,
                                        mask))
        qs = win.q[m] if self.cfg.use_imu_roll_pitch else poses.q[m]
        return win.t[m], qs, poses.t[m], vels[m]

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
                    log_path: Optional[str] = None,
                    high_rate: bool = False) -> RunResult:
        """Replay a dataset scan by scan.  On CUDA the kernels are built
        before the timed loop (the counterpart of the JAX runner's compile
        warm-up); no step runs before it.  ``high_rate=True`` also streams
        the IMU-rate odometry: after each scan the smoothed state is
        propagated through the scan's IMU window
        (:meth:`high_rate_states`) and every ``high_rate_decimation``-th
        sample is kept (~50 Hz, imuPreintegration.cpp:629,648-650)."""
        if self.device.type == "cuda":
            kernels.load()
        imu_i = 0
        imu = dataset.imu
        self._ingest_dataset_vio(dataset)
        poses_q, poses_t, smoothed_t, stats = [], [], [], []
        stream = _Stream(self.cfg.imu.high_rate_decimation) \
            if high_rate else None
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
            if stream is not None:
                stream.add(*self.high_rate_states())
        self._sync()
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
            **(stream.fields() if stream is not None else {}),
        )

    def stack_chunked_inputs(self, dataset, use_imu: bool = True,
                             chunk: int = 16):
        """The host half of the chunked replay.  The whole IMU stream is
        ingested before any window is cut, so the buffer is initialised
        before scan 0 (the chunked replay is another estimator than the
        per-scan one over the first scans).  Returns the (Scan, ImuWindow,
        avail[, VioWindow]) trees of the first ``n_chunks * chunk`` scans
        stacked on the host as ``[n_chunks, chunk, ...]`` (None when no
        chunk is whole), the built inputs of the remaining scans, and
        ``n_chunks``."""
        imu = dataset.imu
        if use_imu:
            for i in range(len(imu.t)):
                self.add_imu(imu.t[i], imu.acc[i], imu.gyr[i])
        self._ingest_dataset_vio(dataset)
        built = [self._host_inputs(s.t_start, s.xyz_body, s.t_rel, use_imu)
                 for s in dataset.scans]
        n_chunks = len(built) // chunk
        stacked = None
        if n_chunks:
            stacked = tree_map(
                lambda *xs: np.stack(xs).reshape((n_chunks, chunk)
                                                 + np.shape(xs[0])),
                *built[:n_chunks * chunk])
        return stacked, built[n_chunks * chunk:], n_chunks

    def _warm_up(self, inputs):
        """One discarded step of ``inputs`` (host leaves) on the current
        state, ahead of a timed loop.  The step is pure: the state is
        left as it was."""
        step(self.step_cfg, self.state, *self._to_device(inputs))
        self._sync()

    def run_dataset_chunked(self, dataset, use_imu: bool = True,
                            chunk: int = 16, preload: bool = True,
                            time_chunks: bool = False,
                            high_rate: bool = False) -> RunResult:
        """Replay the dataset offline in chunks of ``chunk`` scans through
        :func:`pipeline.make_chunked_step_fn`, all IMU ingested up front
        (:meth:`stack_chunked_inputs`).

        Before the timer: the kernels are built (on CUDA) and one step of
        scan 0 runs on the current state and is discarded.  With
        ``preload`` every stacked input is on the device before the timer
        starts; without it each chunk is copied from pinned host memory
        inside the timed loop, on the step's stream (the same inputs, so
        the same poses).  ``time_chunks`` synchronises after every chunk
        and stamps each scan with its chunk's time / ``chunk``; otherwise
        each is stamped with the mean over the run.  The outputs are read
        back after the timer stops.  ``high_rate`` streams the IMU-rate
        odometry of each scan (``pipeline.HighRateOut``), decimated and
        deduplicated as :meth:`run_dataset` does.

        The ``len(scans) % chunk`` remaining scans are replayed per scan
        after the timed window, with their stats and stream samples;
        ``scans_per_sec`` is ``len(dataset.scans)`` over the timed window
        all the same.  The stats records lack the per-scan replay's
        ``"t"``."""
        chunk_fn = make_chunked_step_fn(self.step_cfg, high_rate)
        stacked, rest, n_chunks = self.stack_chunked_inputs(dataset, use_imu,
                                                            chunk)
        if self.device.type == "cuda":
            kernels.load()
        self._warm_up(tree_map(lambda a: a[0, 0], stacked) if n_chunks
                      else rest[0])
        inputs = None
        if n_chunks and preload:
            inputs = self._to_device(stacked)
        elif n_chunks:
            inputs = tree_map(torch.from_numpy, stacked)
            if self.device.type == "cuda":
                inputs = tree_map(lambda a: a.pin_memory(), inputs)
        self._sync()

        t_begin = time.perf_counter()
        pending, chunk_ms = [], []
        for c in range(n_chunks):
            t_chunk0 = time.perf_counter()
            inp = tree_map(lambda a: a[c].to(self.device, non_blocking=True),
                           inputs)
            self.state, outs = chunk_fn(self.state, *inp)
            if time_chunks:
                self._sync()
                chunk_ms.append((time.perf_counter() - t_chunk0) * 1000.0)
            pending.append(outs)
        self._sync()
        wall = time.perf_counter() - t_begin
        mean_scan_ms = wall / max(n_chunks * chunk, 1) * 1000.0

        poses_q, poses_t, smoothed_t, stats = [], [], [], []
        stream = _Stream(self.cfg.imu.high_rate_decimation) \
            if high_rate else None
        for c, outs in enumerate(to_numpy(tuple(pending))):
            if stream is not None:
                outs, hr = outs
                for k in range(chunk):
                    live = np.flatnonzero(hr.mask[k])
                    qs = (stacked[1].q[c, k] if self.cfg.use_imu_roll_pitch
                          else hr.q[k])
                    stream.add(hr.t[k, live], qs[live], hr.p[k, live],
                               hr.v[k, live])
            poses_q.append(outs.pose.q)
            poses_t.append(outs.pose.t)
            smoothed_t.append(outs.smoothed_pose.t)
            per_scan_ms = chunk_ms[c] / chunk if time_chunks else mean_scan_ms
            for k in range(chunk):
                stats.append(self._stats_record(
                    tree_map(lambda a: a[k], outs), c * chunk + k,
                    time_ms=per_scan_ms))
        for b in rest:
            t_scan0 = time.perf_counter()
            inp = self._to_device(b)
            self.state, out = step(self.step_cfg, self.state, *inp)
            self._last_window = inp[1]
            out = to_numpy(out)
            scan_ms = (time.perf_counter() - t_scan0) * 1000.0
            poses_q.append(out.pose.q[None])
            poses_t.append(out.pose.t[None])
            smoothed_t.append(out.smoothed_pose.t[None])
            stats.append(self._stats_record(out, len(stats),
                                            time_ms=scan_ms))
            if stream is not None:
                stream.add(*self.high_rate_states())
        return RunResult(
            poses_q=np.concatenate(poses_q),
            poses_t=np.concatenate(poses_t),
            smoothed_t=np.concatenate(smoothed_t),
            stats=stats,
            wall_time_s=wall,
            scans_per_sec=len(dataset.scans) / wall,
            **(stream.fields() if stream is not None else {}),
        )


class _Stream:
    """The IMU-rate stream as it is collected: every ``dec``-th live
    sample of each window, dropping samples at or before the last one
    kept (consecutive windows overlap at the scan boundary)."""

    def __init__(self, dec: int):
        self.dec = dec
        self.t, self.q, self.p, self.v = [], [], [], []
        self.last_t = -np.inf

    def add(self, ts, qs, ps, vs):
        for k in range(0, len(ts), self.dec):
            if ts[k] <= self.last_t:
                continue
            self.last_t = float(ts[k])
            self.t.append(ts[k])
            self.q.append(qs[k])
            self.p.append(ps[k])
            self.v.append(vs[k])

    def fields(self) -> dict:
        return {"high_rate_t": np.asarray(self.t),
                "high_rate_q": np.asarray(self.q),
                "high_rate_p": np.asarray(self.p),
                "high_rate_v": np.asarray(self.v)}
