"""Command-line replay runner of the PyTorch port.

Usage:
  python -m superodom_tpu_torch.cli --profile vlp_16 --synthetic 60 \\
      --out /tmp/run1 --device cuda
  python -m superodom_tpu_torch.cli --profile os1_128 --ship --synthetic 60 \\
      --chunked --high-rate --out /tmp/run2
  python -m superodom_tpu_torch.cli --synthetic 30 --save-map map.pcd \\
      --checkpoint state.npz --out /tmp/run3
  python -m superodom_tpu_torch.cli --synthetic 30 --localize map.pcd \\
      --init-pose 0 0 0 0 0 0.05 --out /tmp/run4

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

Localization and checkpoints, as in the JAX CLI: ``--localize PCD`` runs
against a frozen prior map (``LocalizationConfig(enabled=True,
update_map=False)`` on the selected configuration) from ``--init-pose x y
z roll pitch yaw`` or the first line of ``--init-pose-file``;
``--save-map PCD`` writes the final surface map; ``--checkpoint NPZ``
saves the whole estimator state at the end, ``--resume NPZ`` starts from
one (loaded before the prior map is inserted).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from superodom_tpu_torch.config import (
    PROFILES,
    LocalizationConfig,
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
    ap.add_argument("--localize", metavar="PCD",
                    help="localization mode against a prior map PCD")
    ap.add_argument("--init-pose", nargs=6, type=float, metavar="V",
                    help="x y z roll pitch yaw for localization init")
    ap.add_argument("--init-pose-file", metavar="TXT",
                    help="read the localization init pose from a pose file "
                         "(x y z roll pitch yaw, first line)")
    ap.add_argument("--save-map", metavar="PCD",
                    help="export the final surface map as a PCD")
    ap.add_argument("--checkpoint", metavar="NPZ",
                    help="save the full estimator state at the end")
    ap.add_argument("--resume", metavar="NPZ",
                    help="resume from a saved estimator state")
    ap.add_argument("--device", default="cuda",
                    help="torch device the step runs on (cuda or cpu)")
    ap.add_argument("--out", default="superodom_torch_run")
    return ap.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> PipelineConfig:
    """The configuration the flags select: the JAX CLI's for
    ``--profile`` alone, the benchmark's with ``--ship`` / ``--parity``;
    with ``--localize`` a frozen-map localization from the init pose."""
    if args.ship or args.parity:
        cfg = config_for(args.profile, args.parity)
    else:
        cfg = PipelineConfig(sensor=profile_by_name(args.profile))
    if args.localize:
        if args.init_pose_file:
            from superodom_tpu_torch.io.pcd import read_pose_file

            rec = read_pose_file(args.init_pose_file)[0]
            init = (rec.x, rec.y, rec.z, rec.roll, rec.pitch, rec.yaw)
        else:
            init = tuple(args.init_pose or [0.0] * 6)
        cfg = dataclasses.replace(cfg, localization=LocalizationConfig(
            enabled=True, update_map=False, init_pose_xyz=init[:3],
            init_pose_rpy=init[3:]))
    return cfg


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
    if args.resume:
        from superodom_tpu_torch.checkpoint import load_state

        runner.state = load_state(args.resume, cfg, runner.device)
    if args.localize:
        from superodom_tpu_torch.checkpoint import load_prior_map

        runner.state = load_prior_map(args.localize, cfg, runner.state)
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
    if args.save_map:
        from superodom_tpu_torch.checkpoint import save_prior_map

        save_prior_map(args.save_map, runner.state)
    if args.checkpoint:
        from superodom_tpu_torch.checkpoint import save_state

        save_state(args.checkpoint, runner.state)
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
