"""Visualization exports — the role of the reference's Rerun visualizers
(script/visualizers/rerun_vis.py etc.).

The rerun SDK is not part of this image, so the primary outputs are
portable files (PLY point clouds + TUM-format trajectories) that any viewer
opens; when ``rerun`` is importable the same data is logged live.

The PyTorch port's copy of the JAX package's ``tools.visualize``: the map
comes from the port's ``mapstate.extract_points`` (device tensors, read
back to the host).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def write_ply(path: str, xyz: np.ndarray, colors: Optional[np.ndarray] = None):
    """ASCII PLY point cloud writer (viewer-agnostic)."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    has_c = colors is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_c:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        if has_c:
            c = np.asarray(colors, np.uint8)
            for p, col in zip(xyz, c):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                        f"{col[0]} {col[1]} {col[2]}\n")
        else:
            for p in xyz:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def write_tum_trajectory(path: str, times: np.ndarray, poses_t: np.ndarray,
                         poses_q: np.ndarray):
    """TUM format: t x y z qx qy qz qw (evo/rviz compatible).

    ``poses_q`` is (w, x, y, z) as used throughout this framework."""
    with open(path, "w") as f:
        for t, p, q in zip(times, poses_t, poses_q):
            f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def export_run(out_dir: str, run_result, state=None, times=None):
    """Dump everything a viewer needs from a replay: trajectory (TUM),
    smoothed trajectory, and the final map as PLY."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    n = len(run_result.poses_t)
    ts = np.asarray(times) if times is not None else np.arange(n, dtype=float)
    write_tum_trajectory(
        os.path.join(out_dir, "trajectory_tum.txt"),
        ts, run_result.poses_t, run_result.poses_q,
    )
    if state is not None:
        write_ply(os.path.join(out_dir, "map.ply"), _map_points(state))


def _map_points(state) -> np.ndarray:
    """The surface map's stored points, f32[n, 3] on the host."""
    from superodom_tpu_torch.mapstate import extract_points

    pts, valid = extract_points(state.surf_map)
    return pts[valid].cpu().numpy()


def rerun_log(run_result, state=None, app_id="superodom_tpu_torch") -> bool:
    """Log to rerun if the SDK is available; returns False otherwise."""
    try:
        import rerun as rr  # optional dependency
    except ImportError:
        return False
    rr.init(app_id, spawn=False)
    rr.log("trajectory", rr.LineStrips3D([run_result.poses_t]))
    if state is not None:
        rr.log("map", rr.Points3D(_map_points(state)))
    return True
