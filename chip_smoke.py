#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (superodom_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each of which fails the run (non-zero exit, no result line):

0. Requires a CUDA device; prints the card's name and power limit, the
   torch and CUDA versions; builds the hand-written kernels from
   ``superodom_tpu_torch/csrc`` (nvcc, sm_90a) and times the build.
1. Each kernel at the main path's shapes (Q = 2,048 features at a
   perturbed pose, a 65,536 x 48 point table filled by the port's own
   insert from seeded OS1-128 scans, k = 5) against its plain PyTorch
   version on the same card and inputs; device time of both (CUDA graph of
   20 launches, CUDA events, median of 50 replays).
2. The main path: ``OdometryRunner(ship_config("os1"), device="cuda")
   .run_dataset`` over the benchmark's synthetic OS1-128 dataset (seed 7,
   131,072 points a scan).  Launch counters are reset just before and must
   match what the step count implies; poses must be finite and the ATE
   below the reference's 10 cm bar.
3. The first scans of the same dataset through the plain PyTorch path on
   the CPU: the GPU trajectory must agree with it.

Output: a ``{"kernels": [...]}`` line, the nvidia-smi line, then the last
line ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_SCANS = 64  # OS1-128 scans replayed on the main path
TOL_K2_SQ_REL = 1e-6
TOL_K3 = 1e-5
TOL_K4_REL = 1e-5
ATE_BAR_M = 0.1
CPU_AGREE_M = 1e-3
CPU_SCANS = 12

REPLACES = {
    "octant_lookup": "superodom_tpu/mapstate.py:365",
    "knn_select": "superodom_tpu/mapstate.py:406",
    "plane_fit": "superodom_tpu/registration.py:212",
    "normal_system": "superodom_tpu/registration.py:463",
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, torch, inner=20, reps=50) -> float:
    """Median device time of one call of ``fn``: ``inner`` calls captured
    in one CUDA graph, replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def make_ship_dataset(cfg, n_scans, seed=7):
    """The replay benchmark's dataset (bench._dataset): a 80 x 60 x 16 m
    box, radius-5 m circle, 0.5 laps per 120 scans, distorted sweeps."""
    import numpy as np

    from superodom_tpu_torch.io.datasets import BoxWorld, make_dataset

    return make_dataset(np.random.default_rng(seed), n_scans=n_scans,
                        points_per_scan=cfg.sensor.max_points,
                        world=BoxWorld(half_extent=np.array([40.0, 30.0,
                                                             8.0])),
                        radius=5.0, laps=0.5 * n_scans / 120.0,
                        distortion=True)


def phase_kernels(cfg, ds, torch, dev, timer):
    """Phase 1: every kernel against its plain version on the card."""
    from superodom_tpu_torch import frontend, kernels, mapstate, registration
    from superodom_tpu_torch.geometry import Pose, quat_mul, so3_exp
    from superodom_tpu_torch.runner import OdometryRunner

    sensor = cfg.sensor
    res = torch.full((), sensor.default_plane_res, device=dev)
    shaper = OdometryRunner(cfg, device=dev)

    def features(i):
        s = ds.scans[i]
        scan = shaper.make_scan(s.t_start, s.xyz_body, s.t_rel)
        gate = frontend.uniform_feature_gates(
            scan.xyz, None, scan.mask, sensor.min_range, sensor.max_range,
            skip_dup=True)
        pts, mask, _ = frontend.thin_and_select(
            scan.xyz, gate, res, sensor.max_surface_features,
            sensor.compact_width, scan.t_rel, mode=sensor.scan_thin_mode)
        return pts.contiguous(), mask.contiguous()

    def gt_pose(i):
        return Pose(torch.tensor(ds.gt_poses_q[i], device=dev),
                    torch.tensor(ds.gt_poses_t[i], device=dev))

    n_map = min(40, len(ds.scans) - 1)
    m = mapstate.empty_map(cfg.map, device=dev)
    for i in range(n_map):
        pts, mask = features(i)
        m = mapstate.insert(m, cfg.map, gt_pose(i).apply(pts), mask, res)
    stored = int(torch.sum(torch.where(m.keys >= 0, m.cnt, 0)))
    log(f"phase 1: map of {stored} points in "
        f"{int((m.keys >= 0).sum())} cells from {n_map} scans, "
        f"table {tuple(m.pts.shape)}")

    pts, mask = features(n_map)
    gt = gt_pose(n_map)
    pose = Pose(quat_mul(so3_exp(torch.tensor([0.004, -0.003, 0.01],
                                              device=dev)), gt.q),
                gt.t + torch.tensor([0.03, -0.02, 0.01], device=dev))
    queries = pose.apply(pts).contiguous()
    q, t = pose.q.contiguous(), pose.t.contiguous()
    k = cfg.registration.plane_knn
    results = {}

    # K1 octant_lookup: exact
    s_k = kernels.octant_lookup(m.keys, queries, cfg.map.cell_size)
    s_r = mapstate.octant_lookup_reference(m.keys, queries, cfg.map.cell_size)
    torch.cuda.synchronize()
    mism = int((s_k != s_r).sum())
    log(f"K1 octant_lookup: {mism} of {s_r.numel()} slot ids differ; "
        f"{int((s_r >= 0).sum())} found")
    if mism:
        raise SystemExit("K1 octant_lookup disagrees with its plain version")
    results["octant_lookup"] = dict(
        err=float((s_k - s_r).abs().max()),
        ms=timer(lambda: kernels.octant_lookup(m.keys, queries,
                                                   cfg.map.cell_size)),
        plain_ms=timer(lambda: mapstate.octant_lookup_reference(
            m.keys, queries, cfg.map.cell_size)))

    # K2 knn_select: exact lanes and points, sq within 1e-6 relative
    nk, sk, vk, lk = kernels.knn_select(m.pts, s_r, queries, k)
    nr, sr, vr, lr = mapstate.knn_select_reference(m.pts, s_r, queries, k)
    torch.cuda.synchronize()
    fin = torch.isfinite(sr)
    sq_err = float(((sk - sr).abs() / sr.abs().clamp_min(1e-30))[fin].max())
    ok = (torch.equal(lk, lr) and torch.equal(vk, vr) and torch.equal(nk, nr)
          and torch.equal(torch.isfinite(sk), fin) and sq_err <= TOL_K2_SQ_REL)
    log(f"K2 knn_select: lanes equal {torch.equal(lk, lr)}, points equal "
        f"{torch.equal(nk, nr)}, sq max rel err {sq_err:.3e}, "
        f"{int(vr.sum())} of {vr.numel()} neighbours valid")
    if not ok:
        raise SystemExit("K2 knn_select disagrees with its plain version")
    results["knn_select"] = dict(
        err=float((sk - sr)[fin].abs().max()),
        ms=timer(lambda: kernels.knn_select(m.pts, s_r, queries, k)),
        plain_ms=timer(lambda: mapstate.knn_select_reference(
            m.pts, s_r, queries, k)))

    # K3 plane_fit: codes exact away from gate thresholds, floats 1e-5
    args3 = (nr.contiguous(), sr.contiguous(), vr.contiguous(), mask,
             queries, q, res)
    out_k = kernels.plane_fit(*args3)
    out_r = registration.plane_fit_reference(*args3)
    torch.cuda.synchronize()
    near = registration.gate_margin_lanes(nr, sr, vr, queries, q, out_r[0],
                                          out_r[1], res)
    far = ~near
    int_ok = all(torch.equal(a[far], b[far])
                 for a, b in zip(out_k[3:], out_r[3:]))
    # normal and coeff are unitless; d is a distance in metres, compared
    # relative to its size (at 40 m one float ulp is 3.8e-6)
    errs = [float((out_k[0] - out_r[0])[far].abs().max()),
            float(((out_k[1] - out_r[1]).abs()
                   / out_r[1].abs().clamp_min(1.0))[far].max()),
            float((out_k[2] - out_r[2])[far].abs().max())]
    err3 = max(errs)
    n_diff = int((out_k[4] != out_r[4]).sum())
    log(f"K3 plane_fit: {int(out_r[3].sum())} valid planes, "
        f"{int(near.sum())} lanes within 1e-5 of a gate, "
        f"{n_diff} codes differ, max err normal {errs[0]:.3e}, "
        f"d (relative) {errs[1]:.3e}, coeff {errs[2]:.3e}")
    if not int_ok or not err3 <= TOL_K3:
        raise SystemExit("K3 plane_fit disagrees with its plain version")
    results["plane_fit"] = dict(
        err=err3, ms=timer(lambda: kernels.plane_fit(*args3)),
        plain_ms=timer(lambda: registration.plane_fit_reference(*args3)))

    # K4 normal_system: H and g within 1e-5 of |H|
    a_sq = (3.0 * res).contiguous()
    args4 = (pts, out_r[0].contiguous(), out_r[1].contiguous(),
             out_r[2].contiguous(), out_r[3].contiguous(), q, t, a_sq)
    Hk, gk, ck = kernels.normal_system(*args4)
    Hr, gr, cr = registration.normal_system_reference(*args4)
    Hk2, gk2, _ = kernels.normal_system(*args4)
    torch.cuda.synchronize()
    scale = float(Hr.abs().max())
    err4 = max(float((Hk - Hr).abs().max()), float((gk - gr).abs().max()))
    repeat = torch.equal(Hk, Hk2) and torch.equal(gk, gk2)
    log(f"K4 normal_system: |H|max {scale:.4e}, max abs err {err4:.3e} "
        f"({err4 / scale:.3e} relative), repeat bit-identical {repeat}")
    if not (err4 <= TOL_K4_REL * scale and repeat and scale > 0):
        raise SystemExit("K4 normal_system disagrees with its plain version")
    results["normal_system"] = dict(
        err=err4, ms=timer(lambda: kernels.normal_system(*args4)),
        plain_ms=timer(lambda: registration.normal_system_reference(
            *args4)))
    return results


def phase_main(cfg, ds, torch, dev, out_dir, card):
    """Phase 2: the main path through the user's entry point."""
    import numpy as np

    from superodom_tpu_torch import kernels
    from superodom_tpu_torch.io.datasets import ate_rmse
    from superodom_tpu_torch.runner import OdometryRunner

    runner = OdometryRunner(cfg, device=dev)
    kernels.reset_counts()
    res = runner.run_dataset(ds, use_imu=True,
                             log_path=os.path.join(out_dir, "stats.jsonl"))
    counts = dict(kernels.launch_counts)
    n = len(ds.scans)
    rounds = sum(s["n_iterations"] for s in res.stats)
    gn = cfg.registration.max_gn_iters
    expect = {"octant_lookup": n, "knn_select": rounds, "plane_fit": rounds,
              "normal_system": gn * rounds + n}
    log(f"phase 2: launches {counts}, expected {expect} "
        f"({rounds} ICP rounds over {n} scans)")
    if counts != expect or min(counts.values()) <= 0:
        raise SystemExit("kernel launch counts do not match the main path")
    if not (np.isfinite(res.poses_t).all() and np.isfinite(res.poses_q).all()):
        raise SystemExit("non-finite pose on the main path")
    ate = ate_rmse(res.poses_t, np.asarray(ds.gt_poses_t))
    times = np.asarray([s["time_elapsed_ms"] for s in res.stats])
    summary = {
        "scans": n,
        "scans_per_sec": res.scans_per_sec,
        "p50_step_ms": float(np.percentile(times, 50)),
        "p90_step_ms": float(np.percentile(times, 90)),
        "ate_m": ate,
        "final_t": res.poses_t[-1].tolist(),
        "peak_mem_mb": (torch.cuda.max_memory_allocated() / 2 ** 20
                        if dev.type == "cuda" else None),
    }
    log(f"phase 2 main path ({card}): " + json.dumps(summary))
    if not ate < ATE_BAR_M:
        raise SystemExit(f"ATE {ate:.4f} m is not below {ATE_BAR_M} m")
    return res, counts, summary


def phase_cpu_agree(cfg, ds, res_gpu, torch):
    """Phase 3: the plain PyTorch path on the CPU over the first scans."""
    import numpy as np

    from superodom_tpu_torch.io.datasets import SimDataset
    from superodom_tpu_torch.runner import OdometryRunner

    n = min(CPU_SCANS, len(ds.scans))
    small = SimDataset(scans=ds.scans[:n], imu=ds.imu,
                       gt_poses_q=ds.gt_poses_q[:n],
                       gt_poses_t=ds.gt_poses_t[:n], times=ds.times[:n])
    res_cpu = OdometryRunner(cfg, device="cpu").run_dataset(small)
    dt = float(np.abs(res_cpu.poses_t - res_gpu.poses_t[:n]).max())
    dq = float(np.abs(res_cpu.poses_q - res_gpu.poses_q[:n]).max())
    log(f"phase 3: first {n} scans, GPU vs CPU plain path: max |dt| "
        f"{dt:.3e} m, max |dq| {dq:.3e}")
    if not (dt <= CPU_AGREE_M and dq <= CPU_AGREE_M):
        raise SystemExit("the GPU trajectory disagrees with the CPU path")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "chip_smoke"))
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "superodom_tpu_torch", "csrc")):
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository (superodom_tpu_torch/ not found)")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this smoke test runs on the GPU")
    os.makedirs(args.out, exist_ok=True)

    # phase 0: the card and the build
    smi = nvidia_smi_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    from superodom_tpu_torch import kernels
    from superodom_tpu_torch.config import ship_config

    kernels.build(verbose=True)
    log(f"phase 0: built {len(kernels.KERNELS)} kernels in "
        f"{kernels.build_seconds:.2f} s")
    with open(os.path.join(args.out, "ptxas.txt"), "w") as f:
        f.write(kernels.build_log)

    cfg = ship_config("os1")
    t0 = time.perf_counter()
    ds = make_ship_dataset(cfg, N_SCANS)
    log(f"dataset: {len(ds.scans)} scans of {cfg.sensor.max_points} points "
        f"in {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda")
    kres = phase_kernels(cfg, ds, torch, dev,
                         lambda fn: device_ms(fn, torch))
    for name, r in kres.items():
        log(f"  {name}: kernel {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us ({smi})")
    res, counts, summary = phase_main(cfg, ds, torch, dev, args.out, smi)
    phase_cpu_agree(cfg, ds, res, torch)

    entries = [{
        "name": name,
        "route": "cuda",
        "source": f"superodom_tpu_torch/csrc/{name}.cu",
        "replaces": REPLACES[name],
        "launches": counts[name],
        "max_abs_err": kres[name]["err"],
        "ms": kres[name]["ms"],
        "plain_ms": kres[name]["plain_ms"],
    } for name in kernels.KERNELS]
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump({"card": smi, "kernels": entries, "main_path": summary}, f,
                  indent=1)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
