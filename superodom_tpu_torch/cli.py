"""Command-line replay runner of the PyTorch port.

Usage:
  python -m superodom_tpu_torch.cli --profile os1_128 --synthetic 60 \\
      --out /tmp/run1 --device cuda

Replays a synthetic dataset (the same world and trajectory as
``superodom_tpu.cli --synthetic``) through the chosen sensor's ship
configuration (``config.ship_config``: the tuned OS1-128 path, or the
package defaults for the VLP-16 and the Livox Mid-360 — voxel thinning,
capacity 32, 4 ICP rounds), or with ``--parity`` through its
reference-envelope configuration (``config.parity_config``: 5 ICP rounds
with early exit, candidate refresh from 16 lanes).  Writes
``trajectory.txt`` and ``stats.jsonl`` under ``--out`` and prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from superodom_tpu_torch.config import PROFILES, config_for


def main(argv=None):
    ap = argparse.ArgumentParser(description="superodom_tpu_torch replay")
    ap.add_argument("--profile", default="os1_128", choices=PROFILES)
    ap.add_argument("--parity", action="store_true",
                    help="the reference-envelope configuration instead of "
                         "the ship one")
    ap.add_argument("--synthetic", type=int, required=True,
                    help="run N synthetic scans")
    ap.add_argument("--no-imu", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device the step runs on (cuda or cpu)")
    ap.add_argument("--out", default="superodom_torch_run")
    args = ap.parse_args(argv)

    import torch

    from superodom_tpu_torch.io.datasets import BoxWorld, ate_rmse, make_dataset
    from superodom_tpu_torch.runner import OdometryRunner

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    cfg = config_for(args.profile, args.parity)
    ds = make_dataset(np.random.default_rng(0), n_scans=args.synthetic,
                      points_per_scan=min(cfg.sensor.max_points, 16384),
                      world=BoxWorld(half_extent=np.array([10.0, 8.0, 4.0])),
                      radius=2.0)
    runner = OdometryRunner(cfg, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    res = runner.run_dataset(ds, use_imu=not args.no_imu,
                             log_path=os.path.join(args.out, "stats.jsonl"))
    np.savetxt(os.path.join(args.out, "trajectory.txt"),
               np.concatenate([res.poses_t, res.poses_q], axis=1),
               header="x y z qw qx qy qz")
    device = args.device
    if device.startswith("cuda"):
        device = torch.cuda.get_device_name(torch.device(device))
    print(json.dumps({
        "profile": args.profile,
        "parity": args.parity,
        "scans": len(res.poses_t),
        "scans_per_sec": round(res.scans_per_sec, 2),
        "return_to_origin_m": res.return_to_origin_error(),
        "ate_rmse_m": ate_rmse(res.poses_t, ds.gt_poses_t),
        "device": device,
        "out": args.out,
    }))


if __name__ == "__main__":
    main()
