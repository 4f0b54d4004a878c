"""Command-line replay runner of the PyTorch port.

Usage:
  python -m superodom_tpu_torch.cli --bag BAG_DIR --device cuda \\
      --out /tmp/run0
  python -m superodom_tpu_torch.cli --profile os1_128 --ship --bag BAG_DIR \\
      --gt-topic /ground_truth --max-scans 64 --out /tmp/run1
  python -m superodom_tpu_torch.cli --config vlp_16.yaml --npz data.npz \\
      --device cpu --out /tmp/run2
  python -m superodom_tpu_torch.cli --profile vlp_16 --synthetic 60 \\
      --out /tmp/run3 --device cuda
  python -m superodom_tpu_torch.cli --profile os1_128 --ship --synthetic 60 \\
      --chunked --high-rate --out /tmp/run4
  python -m superodom_tpu_torch.cli --synthetic 30 --save-map map.pcd \\
      --checkpoint state.npz --out /tmp/run5
  python -m superodom_tpu_torch.cli --synthetic 30 --localize map.pcd \\
      --init-pose 0 0 0 0 0 0.05 --out /tmp/run6

Replays one of three sources, exactly one of which is given, as the JAX
CLI does: ``--bag`` a rosbag2 recording (a ``.db3`` file or a bag
directory; ``--lidar-topic`` / ``--imu-topic`` default to the bag's first
point-cloud and IMU topics, ``--sensor-kind`` to the vendor guessed from
the field names, ``--max-scans`` caps the scans), ``--npz`` a dataset
file (``scan_<i>_{t,xyz,trel}``, ``imu_{t,acc,gyr}``), ``--synthetic N``
N scans of the JAX CLI's synthetic world and trajectory.  ``--gt-topic``
names a ``nav_msgs/msg/Odometry`` topic of ground-truth poses in the bag.

``--profile`` alone builds what the JAX CLI builds:
``PipelineConfig(sensor=profile_by_name(profile))``, the package defaults
with ``auto_voxel_size``, ``vlp_16`` by default; ``--config`` loads a
reference-style YAML configuration instead (it needs PyYAML).  The replay
benchmark's configurations are behind explicit flags, each exclusive with
the others and with ``--config``: ``--ship`` gives ``config.ship_config``
(the tuned OS1-128 path: r^2 thinning, capacity 16, 2 ICP rounds),
``--parity`` ``config.parity_config`` (5 ICP rounds with early exit,
candidate refresh from 16 lanes).  ``--chunked`` replays in chunks of 16
with all IMU ingested up front and writes no ``stats.jsonl``;
``--high-rate`` also writes the ~50 Hz IMU-rate stream to
``state_estimation.txt`` (TUM order: t x y z qx qy qz qw).  Writes
``trajectory.txt``, ``report.json`` (``tools.benchmark.full_report``: ATE
and RPE where ground truth is known, the synthetic world's or the bag's
``--gt-topic``) and, per scan, ``stats.jsonl`` under ``--out``, and prints
one JSON line (``load_seconds``: the host time to read and decode the
source).

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
import time

import numpy as np

from superodom_tpu_torch.config import (
    PROFILES,
    LocalizationConfig,
    PipelineConfig,
    config_for,
    load_yaml_config,
    profile_by_name,
)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="superodom_tpu_torch replay")
    ap.add_argument("--profile", default="vlp_16", choices=PROFILES)
    bench = ap.add_mutually_exclusive_group()
    bench.add_argument("--config", help="reference-style YAML config file")
    bench.add_argument("--ship", action="store_true",
                       help="the replay benchmark's ship configuration of "
                            "the sensor")
    bench.add_argument("--parity", action="store_true",
                       help="the replay benchmark's reference-envelope "
                            "configuration of the sensor")
    source = ap.add_mutually_exclusive_group(required=True)
    source.add_argument("--synthetic", type=int,
                        help="run N synthetic scans")
    source.add_argument("--npz", help="replay a dataset .npz (scans+imu "
                                      "arrays)")
    source.add_argument("--bag", help="replay a rosbag2 recording (.db3 "
                                      "file or bag directory)")
    ap.add_argument("--lidar-topic", help="point cloud topic in --bag")
    ap.add_argument("--imu-topic", help="IMU topic in --bag")
    ap.add_argument("--gt-topic",
                    help="nav_msgs/msg/Odometry topic of ground-truth poses "
                         "in --bag (ATE and RPE in report.json)")
    ap.add_argument("--sensor-kind", choices=["velodyne", "ouster", "livox"],
                    help="vendor decode path for --bag point clouds "
                         "(default: inferred from field names, logged)")
    ap.add_argument("--max-scans", type=int,
                    help="cap the number of scans replayed from --bag")
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
    ``--profile`` alone or ``--config``, the benchmark's with ``--ship`` /
    ``--parity``; with ``--localize`` a frozen-map localization from the
    init pose."""
    if args.config:
        cfg = load_yaml_config(args.config)
    elif args.ship or args.parity:
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


def load_source(args: argparse.Namespace, cfg: PipelineConfig):
    """The dataset of the source the flags name, and its ground-truth
    positions where they are known (None otherwise)."""
    if args.synthetic is not None:
        from superodom_tpu_torch.io.datasets import BoxWorld, make_dataset

        ds = make_dataset(np.random.default_rng(0), n_scans=args.synthetic,
                          points_per_scan=min(cfg.sensor.max_points, 16384),
                          world=BoxWorld(half_extent=np.array([10.0, 8.0,
                                                               4.0])),
                          radius=2.0)
        return ds, ds.gt_poses_t
    if args.npz:
        return _load_npz_dataset(args.npz), None
    from superodom_tpu_torch.io.rosbag import load_bag_dataset

    ds = load_bag_dataset(
        args.bag, lidar_topic=args.lidar_topic, imu_topic=args.imu_topic,
        n_scan_lines=cfg.sensor.n_scan_lines, max_scans=args.max_scans,
        sensor_kind=args.sensor_kind, gt_topic=args.gt_topic)
    return ds, ds.gt_poses_t


def main(argv=None):
    args = parse_args(argv)

    import torch

    from superodom_tpu_torch.runner import OdometryRunner
    from superodom_tpu_torch.tools import benchmark as bm

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    cfg = config_from_args(args)
    t0 = time.perf_counter()
    ds, gt = load_source(args, cfg)
    load_s = time.perf_counter() - t0
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
    report = bm.full_report(res, gt)
    bm.write_report(os.path.join(args.out, "report.json"), report)
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
                   else args.config or "default"),
        "scans": len(res.poses_t),
        "scans_per_sec": round(res.scans_per_sec, 2),
        "return_to_origin_m": report["return_to_origin"]["distance_m"],
        "ate_rmse_m": report.get("ate", {}).get("rmse_m"),
        "load_seconds": load_s,
        "device": device,
        "out": args.out,
    }))


def _load_npz_dataset(path):
    from superodom_tpu_torch.io.datasets import SimDataset, SimImu, SimScan

    d = np.load(path)
    n = int(d["n_scans"])
    scans = [
        SimScan(t_start=float(d[f"scan_{i}_t"]),
                xyz_body=d[f"scan_{i}_xyz"],
                t_rel=d[f"scan_{i}_trel"])
        for i in range(n)
    ]
    imu = SimImu(t=d["imu_t"], acc=d["imu_acc"], gyr=d["imu_gyr"])
    return SimDataset(scans=scans, imu=imu,
                      gt_poses_q=d.get("gt_q"), gt_poses_t=d.get("gt_t"),
                      times=d.get("times"))


if __name__ == "__main__":
    main()
