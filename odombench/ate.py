"""Trajectory error of a run's poses, for its report (a copy of
``superodom_tpu_torch/tools/benchmark.py``'s ``ate_report``)."""

from typing import Dict

import numpy as np


def ate_report(est_t: np.ndarray, gt_t: np.ndarray) -> Dict:
    err = np.linalg.norm(est_t - gt_t, axis=-1)
    return {
        "rmse_m": float(np.sqrt(np.mean(err**2))),
        "mean_m": float(err.mean()),
        "median_m": float(np.median(err)),
        "max_m": float(err.max()),
        "n_poses": int(len(err)),
    }
