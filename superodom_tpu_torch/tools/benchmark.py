"""Offline benchmark evaluation: trajectory analysis + stats archiving.

Rebuild of the reference's benchmark tooling (script/save_benchmark_result.py:
return-to-origin pass/fail at 10 cm, start-vs-end pose analysis;
script/save_superodom_stats.py: OptimizationStats archive).  Works on
RunResult objects from superodom_tpu_torch.runner or on recorded JSONL
streams.

The PyTorch port's copy of the JAX package's ``tools.benchmark``, line for
line: the CLI's ``report.json`` has the same keys and values.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

RETURN_TO_ORIGIN_THRESHOLD_M = 0.1  # reference save_benchmark_result.py:263-267


def return_to_origin_report(poses_t: np.ndarray) -> Dict:
    """Start-vs-end pose analysis with the reference's 10 cm pass/fail."""
    start, end = poses_t[0], poses_t[-1]
    dist = float(np.linalg.norm(end - start))
    return {
        "start": start.tolist(),
        "end": end.tolist(),
        "distance_m": dist,
        "per_axis_m": (end - start).tolist(),
        "pass": dist < RETURN_TO_ORIGIN_THRESHOLD_M,
        "threshold_m": RETURN_TO_ORIGIN_THRESHOLD_M,
    }


def ate_report(est_t: np.ndarray, gt_t: np.ndarray) -> Dict:
    err = np.linalg.norm(est_t - gt_t, axis=-1)
    return {
        "rmse_m": float(np.sqrt(np.mean(err**2))),
        "mean_m": float(err.mean()),
        "median_m": float(np.median(err)),
        "max_m": float(err.max()),
        "n_poses": int(len(err)),
    }


def relative_pose_error(est_t: np.ndarray, gt_t: np.ndarray, delta: int = 10) -> Dict:
    """Translation RPE over a fixed frame delta (drift-rate measure)."""
    de = est_t[delta:] - est_t[:-delta]
    dg = gt_t[delta:] - gt_t[:-delta]
    err = np.linalg.norm(de - dg, axis=-1)
    seg = np.linalg.norm(dg, axis=-1)
    drift_pct = err / np.maximum(seg, 1e-6) * 100.0
    return {
        "rpe_rmse_m": float(np.sqrt(np.mean(err**2))),
        "drift_pct_median": float(np.median(drift_pct)),
        "delta_frames": delta,
    }


def stats_summary(stats: List[dict]) -> Dict:
    """Aggregate the per-scan stats stream (the role of
    save_superodom_stats.py over /super_odometry_stats)."""
    if not stats:
        return {}
    def col(k, default=0):
        return np.asarray([s.get(k, default) for s in stats])

    out = {
        "n_scans": len(stats),
        "surf_stack_mean": float(col("surf_stack").mean()),
        "surf_map_final": int(col("surf_map")[-1]),
        "icp_iterations_mean": float(col("n_iterations").mean()),
        "degenerate_frames": int(col("degenerate").sum()),
        "imu_unhealthy_frames": int((~col("imu_healthy", True).astype(bool)).sum()),
        "prediction_sources": {
            str(k): int(v)
            for k, v in zip(*np.unique(col("pred_source"), return_counts=True))
        },
    }
    unc = [s["uncertainty"] for s in stats if "uncertainty" in s]
    if unc:
        u = np.asarray(unc)
        out["uncertainty_mean"] = u.mean(axis=0).tolist()
    # per-scan processing time (OptimizationStats.msg:9-10 time_elapsed)
    lat = [s["time_elapsed_ms"] for s in stats if "time_elapsed_ms" in s]
    if lat:
        la = np.asarray(lat)
        out["time_elapsed_ms"] = {
            "p50": float(np.percentile(la, 50)),
            "p90": float(np.percentile(la, 90)),
            "max": float(la.max()),
        }
    return out


def full_report(run_result, gt_t: Optional[np.ndarray] = None) -> Dict:
    rep = {
        "return_to_origin": return_to_origin_report(run_result.poses_t),
        "stats": stats_summary(run_result.stats),
        "wall_time_s": run_result.wall_time_s,
        "scans_per_sec": run_result.scans_per_sec,
    }
    if gt_t is not None:
        rep["ate"] = ate_report(run_result.poses_t, gt_t)
        rep["rpe"] = relative_pose_error(run_result.poses_t, gt_t)
    return rep


def write_report(path: str, report: Dict) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2)


def load_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
