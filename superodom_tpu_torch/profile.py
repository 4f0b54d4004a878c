"""Where a step's time goes on the GPU, by stage.

    python -m superodom_tpu_torch.profile [--profile os1_128] [--parity]
                                          [--scans 40] [--warm 20]
                                          [--trace FILE]

Replays the replay benchmark's dataset (seed 7, the chosen sensor's full
scan width; its ship configuration, or with ``--parity`` its
reference-envelope one) through ``OdometryRunner`` on cuda: ``--warm`` scans unprofiled,
then the rest under ``torch.profiler``.  Prints one JSON line with, per
stage range of :func:`pipeline.step` ("step.frontend", ...), the host
wall time inside it (ms per scan), the top device kernels, and the
device's busy share (kernel time over the profiled wall time).
``--trace`` writes the Chrome trace.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from superodom_tpu_torch.config import PROFILES, config_for


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="os1_128", choices=PROFILES)
    ap.add_argument("--parity", action="store_true",
                    help="the reference-envelope configuration")
    ap.add_argument("--scans", type=int, default=40)
    ap.add_argument("--warm", type=int, default=20)
    ap.add_argument("--trace", help="write the Chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")

    from superodom_tpu_torch.convert import to_numpy
    from superodom_tpu_torch.io.datasets import BoxWorld, make_dataset
    from superodom_tpu_torch.runner import OdometryRunner

    cfg = config_for(args.profile, args.parity)
    ds = make_dataset(np.random.default_rng(7), n_scans=args.scans,
                      points_per_scan=cfg.sensor.max_points,
                      world=BoxWorld(half_extent=np.array([40.0, 30.0, 8.0])),
                      radius=5.0, laps=0.5 * args.scans / 120.0,
                      distortion=True)
    runner = OdometryRunner(cfg, device="cuda")
    imu_i = 0

    def run(i):
        nonlocal imu_i
        s = ds.scans[i]
        t_end = s.t_start + float(s.t_rel[-1])
        while imu_i < len(ds.imu.t) and ds.imu.t[imu_i] <= t_end + 0.02:
            runner.add_imu(ds.imu.t[imu_i], ds.imu.acc[imu_i],
                           ds.imu.gyr[imu_i])
            imu_i += 1
        to_numpy(runner.process_scan(s.t_start, s.xyz_body, s.t_rel))

    for i in range(args.warm):
        run(i)
    torch.cuda.synchronize()
    n = args.scans - args.warm
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(args.warm, args.scans):
            run(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    # host wall time inside each step.* range: the step waits on the host
    # (see device_busy_share), so this is where a scan's time goes
    stages = {}
    for e in prof.events():
        if (e.name.startswith("step.")
                and e.device_type == torch.autograd.DeviceType.CPU):
            stages[e.name] = stages.get(e.name, 0.0) + e.cpu_time_total / 1e3 / n
    # device kernels only (the host ops that launch them report the same
    # time again, and the annotation ranges span whole stages)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / n,
                       e.count // n) for e in avgs
                      if e.device_type == cuda
                      and not e.key.startswith("step.")),
                     key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels) / (wall * 1e3 / n)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "profile": args.profile,
        "parity": args.parity,
        "scans_profiled": n,
        "wall_ms_per_scan": wall * 1e3 / n,
        "device_busy_share": busy,
        "stages": stages,
        "top_device": [{"name": k[0][:80], "ms_per_scan": k[1],
                        "launches_per_scan": k[2]} for k in kernels[:15]],
        "ops_per_scan": sum(e.count for e in avgs
                            if not e.key.startswith("step.")) / n,
    }))


if __name__ == "__main__":
    main()
