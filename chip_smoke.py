#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (superodom_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each of which fails the run (non-zero exit, no result line):

0. Requires a CUDA device; prints the card's name and power limit, the
   torch and CUDA versions; builds the hand-written kernels from
   ``superodom_tpu_torch/csrc`` (one nvcc, sm_90a) and times the build.
1. Each kernel at the main path's shapes (Q = 2,048 features at a
   perturbed pose, a 65,536 x 48 point table filled by the port's own
   insert from seeded OS1-128 scans, k = 5, 4 GN iterations) against its
   plain PyTorch version on the same card and inputs: K1-K3, K4's
   ``n_iters = 0`` mode, and K4's whole GN solve (pose within GN_TOL of
   the plain solve, the same ``first_small``,
   repeat runs bit-identical).  Device time of every kernel and of its
   plain version (CUDA graph of 20 launches, CUDA events, median of 50
   replays), of an empty kernel (the launch floor), the least time the
   card could take (bytes or operations, from this run's inputs), and the
   host wall time of one whole GN solve, kernel vs plain, in turns.
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
GN_TOL = 1e-5  # GN kernel vs plain solve: metres and quaternion components
ATE_BAR_M = 0.1
CPU_AGREE_M = 1e-3
CPU_SCANS = 12
HOST_REPS = 100  # host-timed GN solves of each kind
# NVIDIA H100 SXM peaks (data sheet): HBM bytes/s, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

REPLACES = {
    "octant_lookup": "superodom_tpu/mapstate.py:365",
    "knn_select": "superodom_tpu/mapstate.py:406",
    "plane_fit": "superodom_tpu/registration.py:212",
    "gn_solve": "superodom_tpu/registration.py:530",
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


def host_us_in_turns(fns, torch, reps=HOST_REPS):
    """Median host wall time (us) of each of ``fns`` (name -> callable),
    each call ending in ``torch.cuda.synchronize()``; the calls alternate
    (a, b, b, a, ...) so drift on the host touches both alike."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names:  # warm up
        fns[n]()
    torch.cuda.synchronize()
    for r in range(reps):
        for n in (names if r % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            fns[n]()
            torch.cuda.synchronize()
            times[n].append((time.perf_counter() - t0) * 1e6)
    return {n: statistics.median(v) for n, v in times.items()}


def bound(nbytes: float, ops: float):
    """(least ms the card could take, what bounds it)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


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


def phase_kernels(cfg, ds, torch, dev, timer, host_timer):
    """Phase 1: every kernel against its plain version on the card."""
    from superodom_tpu_torch import frontend, kernels, mapstate, registration
    from superodom_tpu_torch.config import RuntimeParams
    from superodom_tpu_torch.geometry import Pose, quat_mul, so3_exp
    from superodom_tpu_torch.runner import OdometryRunner

    sensor, reg = cfg.sensor, cfg.registration
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
    nq, k = queries.shape[0], reg.plane_knn
    C = cfg.map.cell_capacity
    floor_ms = timer(lambda: kernels.launch_floor(dev))
    log(f"launch floor (empty kernel, same harness): {floor_ms * 1e3:.2f} us")
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
    nb, B = m.keys.shape
    touched = torch.unique(mapstate._bucket_of(
        mapstate.octant_cells(queries, cfg.map.cell_size).reshape(-1),
        nb)).numel()
    results["octant_lookup"] = dict(
        err=float((s_k - s_r).abs().max()),
        ms=timer(lambda: kernels.octant_lookup(m.keys, queries,
                                                   cfg.map.cell_size)),
        plain_ms=timer(lambda: mapstate.octant_lookup_reference(
            m.keys, queries, cfg.map.cell_size)),
        # queries, the touched bucket rows, the slot ids; per query the
        # cell arithmetic and per octant the hash and B key compares
        bound=bound(nq * 12 + touched * B * 4 + nq * 8 * 4,
                    nq * (12 + 8 * (15 + B))))

    # K2 knn_select: exact lanes and points, sq within 1e-6 relative
    nk, sk, vk, lk = kernels.knn_select(m.pts, s_r, queries, k)
    nr, sr, vr, lr = mapstate.knn_select_reference(m.pts, s_r, queries, k)
    torch.cuda.synchronize()
    fin = torch.isfinite(sr)
    sq_err = float(((sk - sr).abs() / sr.abs().clamp_min(1e-30))[fin].max())
    ok = (torch.equal(lk, lr) and torch.equal(vk, vr) and torch.equal(nk, nr)
          and torch.equal(torch.isfinite(sk), fin) and sq_err <= TOL_K2_SQ_REL)
    log(f"K2 knn_select: lanes equal {torch.equal(lk, lr)}, points equal "
        f"{torch.equal(nk, nr)}, validity equal {torch.equal(vk, vr)}, sq "
        f"max rel err {sq_err:.3e}, {int(vr.sum())} of {vr.numel()} "
        f"neighbours valid")
    if not ok:
        raise SystemExit("K2 knn_select disagrees with its plain version")
    live = torch.unique(s_r[s_r >= 0]).numel()
    results["knn_select"] = dict(
        err=float((sk - sr)[fin].abs().max()),
        ms=timer(lambda: kernels.knn_select(m.pts, s_r, queries, k)),
        plain_ms=timer(lambda: mapstate.knn_select_reference(
            m.pts, s_r, queries, k)),
        # slot ids, queries, the live slot rows; outputs; 8 flops a
        # candidate distance
        bound=bound(nq * 8 * 4 + nq * 12 + live * 3 * C * 4
                    + nq * k * (12 + 4 + 1 + 8),
                    int((s_r >= 0).sum()) * C * 8))

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
        plain_ms=timer(lambda: registration.plane_fit_reference(*args3)),
        # neighbourhoods, mask, points, pose; six outputs; ~450 operations
        # a correspondence (PCA, trigonometric eigensolver, gates, bins)
        bound=bound(nq * k * 17 + nq * 13 + 20 + nq * 37, nq * 450))

    # K4, n_iters = 0 mode (the final normal system): within 1e-5 of |H|
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
    # rows (p_body, normal, d, coeff, valid), pose; H, g, cost; ~124
    # operations a row
    results["normal_system"] = dict(
        err=err4, ms=timer(lambda: kernels.normal_system(*args4)),
        plain_ms=timer(lambda: registration.normal_system_reference(
            *args4)),
        bound=bound(nq * 33 + 32 + 43 * 4, nq * 124))

    # K4, the GN solve of one ICP round as the main path calls it: the
    # pose prior present, the hold armed; and once more with the prior on
    planes = registration.PlaneCorrs(pts, *out_r)
    rt = RuntimeParams(torch.tensor(sensor.default_line_res, device=dev), res)
    n_it = reg.max_gn_iters

    def prior(enabled):
        return registration.PosePrior(
            pose=gt, information=torch.tensor(
                [40.0, 50.0, 60.0, 10.0, 10.0, 0.0], device=dev),
            enabled=torch.tensor(enabled, device=dev))

    hold_on = torch.tensor(True, device=dev)
    kw = dict(prior=prior(False), axis_hold_min=reg.axis_hold_min_matches,
              axis_hold_frac=reg.axis_hold_frac, hold_enabled=hold_on)
    solve_args = (pose, planes, None, rt, n_it)

    def gn_args(pr):  # kernels.gn_solve's arguments for solve_args, **kw
        return (*args4[:5], out_r[5].contiguous(), q, t, a_sq, n_it, 1e-4,
                tuple(x.contiguous() for x in (pr.pose.q, pr.pose.t,
                                               pr.information, pr.enabled)),
                reg.axis_hold_min_matches, reg.axis_hold_frac, hold_on)

    gn_err = 0.0
    for case, pr in (("prior off", prior(False)), ("prior on", prior(True))):
        qk, tk, sk1 = kernels.gn_solve(*gn_args(pr))
        qk2, tk2, sk2 = kernels.gn_solve(*gn_args(pr))
        ref, sr1 = registration.gauss_newton_solve_reference(
            *solve_args, **dict(kw, prior=pr))
        torch.cuda.synchronize()
        dt = float((tk - ref.t).abs().max())
        dq = float((qk - ref.q).abs().max())
        same_small = bool(sk1) == bool(sr1) == bool(sk2)
        rep = torch.equal(qk, qk2) and torch.equal(tk, tk2)
        moved = float((ref.t - pose.t).abs().max())
        log(f"K4 gn_solve ({case}): max |dt| {dt:.3e} m, max |dq| "
            f"{dq:.3e}, first_small kernel {bool(sk1)} plain {bool(sr1)}, "
            f"repeat bit-identical {rep}; the solve moved the pose "
            f"{moved:.3e} m")
        if not (dt <= GN_TOL and dq <= GN_TOL and same_small and rep):
            raise SystemExit("K4 gn_solve disagrees with the plain solve")
        gn_err = max(gn_err, dt, dq)
    args_kw = gn_args(kw["prior"])
    host = host_timer({
        "plain": lambda: registration.gauss_newton_solve_reference(
            *solve_args, **kw),
        "kernel": lambda: registration.gauss_newton_solve(*solve_args,
                                                          **kw)})
    log(f"host wall time of one whole GN solve ({n_it} iterations, ending "
        f"in a synchronize): kernel {host['kernel']:.1f} us, plain "
        f"{host['plain']:.1f} us")
    results["gn_solve"] = dict(
        err=gn_err, ms=timer(lambda: kernels.gn_solve(*args_kw)),
        plain_ms=timer(lambda: registration.gauss_newton_solve_reference(
            *solve_args, **kw)),
        # rows once plus the vote column, pose and prior; the pose; per
        # iteration ~124 operations a row and ~600 for the 6x6 solve
        bound=bound(nq * 37 + 32 + 53 + 29, n_it * (nq * 124 + 600)),
        host_us=host)
    return results, floor_ms


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
    expect = {"octant_lookup": n, "knn_select": rounds, "plane_fit": rounds,
              "gn_solve": rounds, "normal_system": n}
    log(f"phase 2: launches {counts}, expected {expect} "
        f"({rounds} ICP rounds over {n} scans); K4-family launches per "
        f"scan {(counts['gn_solve'] + counts['normal_system']) / n:.3f}")
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
    log(f"phase 0: built {len(kernels.SOURCES)} sources in "
        f"{kernels.build_seconds:.2f} s")
    with open(os.path.join(args.out, "ptxas.txt"), "w") as f:
        f.write(kernels.build_log)

    cfg = ship_config("os1")
    t0 = time.perf_counter()
    ds = make_ship_dataset(cfg, N_SCANS)
    log(f"dataset: {len(ds.scans)} scans of {cfg.sensor.max_points} points "
        f"in {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda")
    kres, floor_ms = phase_kernels(
        cfg, ds, torch, dev, lambda fn: device_ms(fn, torch),
        lambda fns: host_us_in_turns(fns, torch))
    res, counts, summary = phase_main(cfg, ds, torch, dev, args.out, smi)
    n = len(ds.scans)
    for name, r in kres.items():
        log(f"  {name}: kernel {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound'][0] * 1e3:.4f} "
            f"us ({r['bound'][1]}), launch floor {floor_ms * 1e3:.2f} us, "
            f"{counts[name] / n:.3f} launches a scan ({smi})")
    phase_cpu_agree(cfg, ds, res, torch)

    entries = [{
        "name": name,
        "route": "cuda",
        "source": "superodom_tpu_torch/csrc/"
                  f"{kernels.SOURCE_OF.get(name, name)}.cu",
        "replaces": REPLACES[name],
        "launches": counts[name],
        "max_abs_err": kres[name]["err"],
        "ms": kres[name]["ms"],
        "plain_ms": kres[name]["plain_ms"],
        "bound_ms": kres[name]["bound"][0],
        "bound_by": kres[name]["bound"][1],
        "library_ms": None,  # no single PyTorch call computes these
    } for name in kernels.KERNELS]
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump({"card": smi, "kernels": entries, "main_path": summary,
                   "launch_floor_ms": floor_ms,
                   "gn_solve_host_us": kres["gn_solve"]["host_us"]}, f,
                  indent=1)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
