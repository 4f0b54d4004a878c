"""Command-line replay runner of the PyTorch port.

Usage:
  python -m superodom_tpu_torch.cli --profile vlp_16 --synthetic 60 \\
      --out /tmp/run1 --device cuda
  python -m superodom_tpu_torch.cli --profile os1_128 --ship --synthetic 60 \\
      --chunked --high-rate --out /tmp/run2

Replays a synthetic dataset (the same world and trajectory as
``superodom_tpu.cli --synthetic``).  ``--profile`` alone builds what the
JAX CLI builds: ``PipelineConfig(sensor=profile_by_name(profile))``, the
package defaults with ``auto_voxel_size``, ``vlp_16`` by default.  The
replay benchmark's configurations are behind explicit flags: ``--ship``
gives ``config.ship_config`` (the tuned OS1-128 path: r^2 thinning,
capacity 16, 2 ICP rounds), ``--parity`` ``config.parity_config`` (5 ICP
rounds with early exit, candidate refresh from 16 lanes).  ``--chunked``
replays in chunks of 16 with all IMU ingested up front and writes no
``stats.jsonl``; ``--high-rate`` also writes the ~50 Hz IMU-rate stream to
``state_estimation.txt`` (TUM order: t x y z qx qy qz qw).  Writes
``trajectory.txt`` (and ``stats.jsonl`` per scan) under ``--out`` and
prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from superodom_tpu_torch.config import (
    PROFILES,
    PipelineConfig,
    config_for,
    profile_by_name,
)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="superodom_tpu_torch replay")
    ap.add_argument("--profile", default="vlp_16", choices=PROFILES)
    bench = ap.add_mutually_exclusive_group()
    bench.add_argument("--ship", action="store_true",
                       help="the replay benchmark's ship configuration of "
                            "the sensor")
    bench.add_argument("--parity", action="store_true",
                       help="the replay benchmark's reference-envelope "
                            "configuration of the sensor")
    ap.add_argument("--synthetic", type=int, required=True,
                    help="run N synthetic scans")
    ap.add_argument("--no-imu", action="store_true")
    ap.add_argument("--chunked", action="store_true",
                    help="chunked replay (chunks of 16, all IMU up front)")
    ap.add_argument("--high-rate", action="store_true",
                    help="also write the ~50 Hz IMU-rate odometry to "
                         "state_estimation.txt (TUM order)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the step runs on (cuda or cpu)")
    ap.add_argument("--out", default="superodom_torch_run")
    return ap.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> PipelineConfig:
    """The configuration the flags select: the JAX CLI's for
    ``--profile`` alone, the benchmark's with ``--ship`` / ``--parity``."""
    if args.ship or args.parity:
        return config_for(args.profile, args.parity)
    return PipelineConfig(sensor=profile_by_name(args.profile))


def main(argv=None):
    args = parse_args(argv)

    import torch

    from superodom_tpu_torch.io.datasets import BoxWorld, ate_rmse, make_dataset
    from superodom_tpu_torch.runner import OdometryRunner

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    cfg = config_from_args(args)
    ds = make_dataset(np.random.default_rng(0), n_scans=args.synthetic,
                      points_per_scan=min(cfg.sensor.max_points, 16384),
                      world=BoxWorld(half_extent=np.array([10.0, 8.0, 4.0])),
                      radius=2.0)
    runner = OdometryRunner(cfg, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    if args.chunked:
        res = runner.run_dataset_chunked(ds, use_imu=not args.no_imu,
                                         high_rate=args.high_rate)
    else:
        res = runner.run_dataset(
            ds, use_imu=not args.no_imu, high_rate=args.high_rate,
            log_path=os.path.join(args.out, "stats.jsonl"))
    np.savetxt(os.path.join(args.out, "trajectory.txt"),
               np.concatenate([res.poses_t, res.poses_q], axis=1),
               header="x y z qw qx qy qz")
    if args.high_rate and len(res.high_rate_t):
        hr = np.concatenate(
            [res.high_rate_t[:, None], res.high_rate_p,
             res.high_rate_q[:, 1:4], res.high_rate_q[:, 0:1]], axis=1)
        np.savetxt(os.path.join(args.out, "state_estimation.txt"), hr,
                   header="t x y z qx qy qz qw")
    device = args.device
    if device.startswith("cuda"):
        device = torch.cuda.get_device_name(torch.device(device))
    print(json.dumps({
        "profile": args.profile,
        "config": ("parity" if args.parity else "ship" if args.ship
                   else "default"),
        "scans": len(res.poses_t),
        "scans_per_sec": round(res.scans_per_sec, 2),
        "return_to_origin_m": res.return_to_origin_error(),
        "ate_rmse_m": ate_rmse(res.poses_t, ds.gt_poses_t),
        "device": device,
        "out": args.out,
    }))


if __name__ == "__main__":
    main()
