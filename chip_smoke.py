#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (superodom_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each of which fails the run (non-zero exit, no result line):

0. Requires a CUDA device; prints the card's name and power limit, the
   torch and CUDA versions; builds the hand-written kernels from
   ``superodom_tpu_torch/csrc`` (one nvcc, sm_90a) and times the build.
1. Each kernel against its plain PyTorch version on the same card and
   inputs, once for every path of phase 2, at that path's shapes: its
   configuration's thinning gives the features (at a perturbed pose) and
   the port's own insert fills its map from seeded scans (OS1-128,
   capacity 16: a 65,536 x 48 point table; VLP-16, capacity 32:
   65,536 x 96, 256 candidates a query).  K1-K3, K4's ``n_iters = 0``
   mode, and K4's whole GN solve (pose within GN_TOL of the plain solve,
   the same ``first_small``, repeat runs bit-identical) on each path; K9a
   reduce_candidates and K9b select_reduced on the reference-envelope
   path's warm map (W = 16, k = 5; ``valid`` and every valid lane
   identical).  Path E (edges): K11a curvature_edges bit for bit on a
   full-width replay scan (its ring all zeros, so the stencil wraps) and
   on a ring-major sweep of a room with poles (128 rings x 1,024
   azimuths); on path E's own warm edge map K1, K2 at k = 10, K9a at
   W = 20, K9b at 10 of 20, K11b edge_fit (identical but for the lanes at a
   gate margin, which are counted), and K10 on the 24,576-lane edge stream
   (a 2^17 table); on a pole lattice in a walled room K11b (more than half
   of 512 lines valid) and K4 with 512 edge rows beside 2,048 planes
   (normal system within 1e-5 of |H|, GN solve within GN_TOL).  K10
   voxel_claim on a real decimated VLP-16 scan (10,923 lanes, a 2^17
   table) and an OS1-128 one (43,691 lanes, 2^19): the keep-mask
   identical, repeat runs identical.  Device time of every kernel and of
   its plain version (CUDA graph of 20 launches, CUDA events, median of
   50 replays), of an empty kernel (the launch floor), the least time the
   card could take (bytes or operations, from this run's inputs), and the
   host wall time of one whole GN solve, kernel vs plain, in turns.
2. Four paths through ``OdometryRunner(cfg, device="cuda").run_dataset``
   over the benchmark's synthetic world (seed 7), N_SCANS scans each: the
   ship path (``ship_config("os1")``, 131,072 points a scan), the
   reference-envelope path (``parity_config("os1")``: 5 ICP rounds with
   early exit, candidate refresh through K9), the VLP-16 default path
   (``ship_config("vlp16")``: 32,768 points a scan, voxel thinning
   through K10, capacity 32, 4 rounds) and path E
   (``parity_config("os1")`` with ``use_edge_features``: full-width scans,
   curvature edges thinned to 512, an edge map beside the surface map,
   both refreshed).  Launch counters are reset just before each and must
   match what its step and round counts imply; poses must be finite, the
   ATE below the reference's 10 cm bar, and on path E every scan must
   extract edges.
3. The first scans of each path through the plain PyTorch path on the
   CPU: the GPU trajectory must agree with it.
4. The chunked replay (``run_dataset_chunked``: all IMU ingested first,
   every input on the card before the timer, one discarded warm-up step
   of scan 0) over the same datasets: the ship path at chunk = n (the
   replay benchmark's throughput replay), at chunk 16 with
   ``time_chunks`` (its latency percentiles) and at chunk 16 with
   streamed inputs and the IMU-rate stream; path P at chunk = n and at
   chunk 16; the Livox default path (``ship_config("livox")``, 24,576
   points a scan, 4,096 plane rows in K4) at chunk = n.  Each replay's
   launches must equal ``expected_launches`` plus scan 0's once (the
   warm-up), its poses be finite with the ATE below the bar, and the
   replays of a path agree to the bit; the stream's times strictly
   increase at more than 35 samples a second with no step over 0.15 m;
   the ship path's first scans, replayed chunked on the CPU, agree with
   the card's.

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
N_SCANS = 64  # scans replayed on each path
TOL_K2_SQ_REL = 1e-6
TOL_K4_REL = 1e-5
GN_TOL = 1e-5  # GN kernel vs plain solve: metres and quaternion components
ATE_BAR_M = 0.1
CPU_AGREE_M = 1e-3
CPU_SCANS = 12
HOST_REPS = 100  # host-timed GN solves of each kind
CHUNK = 16  # the replay benchmark's latency chunk
HR_MIN_RATE = 35.0  # IMU-rate stream samples a second of its span
HR_MAX_STEP_M = 0.15
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
    "reduce_candidates": "superodom_tpu/mapstate.py:444",
    "select_reduced": "superodom_tpu/mapstate.py:473",
    "voxel_claim": "superodom_tpu/ops/voxel.py:110",
    "curvature_edges": "superodom_tpu/frontend.py:307",
    "edge_fit": "superodom_tpu/registration.py:367",
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


def lanes_that_differ(out_a, out_b, torch):
    """bool[M]: the rows in which any of two versions' per-row outputs
    differs (NaN equal to NaN)."""
    differ = None
    for a, b in zip(out_a, out_b):
        ne = (a != b) & ~((a != a) & (b != b))
        ne = ne if ne.dim() == 1 else ne.flatten(1).any(dim=1)
        differ = ne if differ is None else differ | ne
    return differ


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


def hold_lookup_select(m, cell_size, queries, k, timer, torch, tag=""):
    """K1 octant_lookup (exact) and K2 knn_select (lanes, points and
    validity exact, distances within TOL_K2_SQ_REL) on map ``m`` against
    their plain versions; returns (results, the plain (slots, neighbours,
    distances, validity))."""
    from superodom_tpu_torch import kernels, mapstate

    nq = queries.shape[0]
    C = m.pts.shape[1] // 3
    results = {}
    s_k = kernels.octant_lookup(m.keys, queries, cell_size)
    s_r = mapstate.octant_lookup_reference(m.keys, queries, cell_size)
    torch.cuda.synchronize()
    mism = int((s_k != s_r).sum())
    nb, B = m.keys.shape
    found = s_r[s_r >= 0]
    log(f"K1 octant_lookup{tag}: {mism} of {s_r.numel()} slot ids differ; "
        f"{found.numel()} found, {int((found % B < 32).sum())} of them in "
        f"the first 32 lanes of their row; {int((m.keys >= 0).sum(1).max())} "
        f"keys in the fullest row")
    if mism:
        raise SystemExit("K1 octant_lookup disagrees with its plain version")
    touched = torch.unique(mapstate._bucket_of(
        mapstate.octant_cells(queries, cell_size).reshape(-1),
        nb)).numel()
    results["octant_lookup"] = dict(
        err=float((s_k - s_r).abs().max()),
        ms=timer(lambda: kernels.octant_lookup(m.keys, queries, cell_size)),
        plain_ms=timer(lambda: mapstate.octant_lookup_reference(
            m.keys, queries, cell_size)),
        # queries, the touched bucket rows, the slot ids; per query the
        # cell arithmetic and per octant the hash and B key compares
        bound=bound(nq * 12 + touched * B * 4 + nq * 8 * 4,
                    nq * (12 + 8 * (15 + B))))

    nk, sk, vk, lk = kernels.knn_select(m.pts, s_r, queries, k)
    nr, sr, vr, lr = mapstate.knn_select_reference(m.pts, s_r, queries, k)
    torch.cuda.synchronize()
    fin = torch.isfinite(sr)
    sq_err = float(((sk - sr).abs() / sr.abs().clamp_min(1e-30))[fin].max())
    ok = (torch.equal(lk, lr) and torch.equal(vk, vr) and torch.equal(nk, nr)
          and torch.equal(torch.isfinite(sk), fin) and sq_err <= TOL_K2_SQ_REL)
    log(f"K2 knn_select{tag} (k = {k}): lanes equal {torch.equal(lk, lr)}, "
        f"points equal {torch.equal(nk, nr)}, validity equal "
        f"{torch.equal(vk, vr)}, sq max rel err {sq_err:.3e}, "
        f"{int(vr.sum())} of {vr.numel()} neighbours valid")
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
    return results, (s_r, nr, sr, vr)


def hold_reduce_select(m, s_r, queries, moved_q, W, k, timer, torch,
                       tag=""):
    """K9a reduce_candidates at width ``W`` on map ``m`` (valid and every
    coordinate of a valid lane identical; a lane that is not valid holds no
    point of the query's cells and is not compared), then K9b
    select_reduced of ``k`` from those lanes at ``moved_q`` (the features
    moved as a round of GN moves them): validity, points and distances of
    every valid lane identical."""
    from superodom_tpu_torch import kernels, mapstate

    nq = queries.shape[0]
    C = m.pts.shape[1] // 3
    live = torch.unique(s_r[s_r >= 0]).numel()
    results = {}
    red_k = mapstate.ReducedCandidates(
        *kernels.reduce_candidates(m.pts, s_r, queries, W))
    red_r = mapstate.reduce_candidates_reference(m.pts, s_r, queries, W)
    torch.cuda.synchronize()
    v = red_r.valid
    same_valid = torch.equal(red_k.valid, v)
    err9a = max(float((a - b)[v].abs().max()) for a, b in
                zip(red_k[:3], red_r[:3]))
    log(f"K9a reduce_candidates{tag} (W = {W}): validity equal {same_valid}, "
        f"{int(v.sum())} of {v.numel()} lanes valid, "
        f"{int((v.sum(1) < W).sum())} of {nq} rows with fewer than {W}, max "
        f"abs err of a valid coordinate {err9a:.3e}, every lane equal "
        f"{all(torch.equal(a, b) for a, b in zip(red_k, red_r))}")
    if not (same_valid and err9a == 0.0 and bool(v.any())):
        raise SystemExit("K9a reduce_candidates disagrees with its plain "
                         "version")
    results["reduce_candidates"] = dict(
        err=err9a,
        ms=timer(lambda: kernels.reduce_candidates(m.pts, s_r, queries, W)),
        plain_ms=timer(lambda: mapstate.reduce_candidates_reference(
            m.pts, s_r, queries, W)),
        # slot ids, queries, the live slot rows; three planes and validity
        bound=bound(nq * 8 * 4 + nq * 12 + live * 3 * C * 4 + nq * W * 13,
                    int((s_r >= 0).sum()) * C * 8))

    nk9, sk9, vk9 = kernels.select_reduced(*red_r, moved_q, k)
    nr9, sr9, vr9 = mapstate.select_knn_reduced_reference(red_r, moved_q, k)
    torch.cuda.synchronize()
    same_valid = torch.equal(vk9, vr9)
    err9b = max(float((nk9 - nr9)[vr9].abs().max()),
                float((sk9 - sr9)[vr9].abs().max()))
    log(f"K9b select_reduced{tag} ({k} of {W}): validity equal {same_valid}, "
        f"{int(vr9.sum())} of {vr9.numel()} neighbours valid, max abs err "
        f"of a valid point or distance {err9b:.3e}; the features moved "
        f"{float((moved_q - queries).norm(dim=1).max()):.3e} m at most")
    if not (same_valid and err9b == 0.0 and bool(vr9.any())):
        raise SystemExit("K9b select_reduced disagrees with its plain version")
    results["select_reduced"] = dict(
        err=err9b,
        ms=timer(lambda: kernels.select_reduced(*red_r, moved_q, k)),
        plain_ms=timer(lambda: mapstate.select_knn_reduced_reference(
            red_r, moved_q, k)),
        # the reduced lanes and the queries; points, distances, validity
        bound=bound(nq * W * 13 + nq * 12 + nq * k * 17, nq * W * 8))
    return results


def phase_kernels(name, cfg, ds, torch, dev):
    """Phase 1: every kernel the ``name`` path runs between thinning and
    the pose, against its plain version on the card at that path's
    shapes."""
    from superodom_tpu_torch import frontend, kernels, mapstate, registration
    from superodom_tpu_torch.config import RuntimeParams
    from superodom_tpu_torch.geometry import Pose, quat_mul, so3_exp
    from superodom_tpu_torch.runner import OdometryRunner

    def timer(fn):
        return device_ms(fn, torch)

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
            sensor.compact_width, scan.t_rel, mode=sensor.scan_thin_mode,
            table_bits=max((sensor.max_points * 4 - 1).bit_length(), 4))
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
    log(f"phase 1 [{name}]: map of {stored} points in "
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
    log(f"phase 1 [{name}]: {nq} queries ({int(mask.sum())} live), "
        f"{8 * C} candidates a query, k = {k}")
    results, (s_r, nr, sr, vr) = hold_lookup_select(
        m, cfg.map.cell_size, queries, k, timer, torch)

    # K3 plane_fit: normal and d identical to the bit on every row; coeff,
    # valid, code and bins too, except that they may differ in a lane that
    # gate_margin_lanes flags (a decision within 1e-5 of a gate threshold
    # or an arg-max tie), and the line says how many do
    args3 = (nr.contiguous(), sr.contiguous(), vr.contiguous(), mask,
             queries, q, res)
    out_k = kernels.plane_fit(*args3)
    out_r = registration.plane_fit_reference(*args3)
    torch.cuda.synchronize()
    near = registration.gate_margin_lanes(nr, sr, vr, queries, q, out_r[0],
                                          out_r[1], res)
    differ = lanes_that_differ(out_k, out_r, torch)
    fit_differ = lanes_that_differ(out_k[:2], out_r[:2], torch)
    err3 = max(float((out_k[0] - out_r[0]).abs().max()),
               float((out_k[1] - out_r[1]).abs().max()),
               float((out_k[2] - out_r[2])[~near].abs().max()))
    log(f"K3 plane_fit: {int(out_r[3].sum())} valid planes, "
        f"{int(near.sum())} lanes within 1e-5 of a gate, "
        f"{int(differ.sum())} lanes differ in any output "
        f"({int((differ & ~near).sum())} of them away from a gate, "
        f"{int(fit_differ.sum())} in normal or d), max abs err of normal "
        f"and d, and of coeff away from a gate, {err3:.3e}")
    if bool((differ & ~near).any() | fit_differ.any()) or err3 != 0.0:
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
    host = host_us_in_turns({
        "plain": lambda: registration.gauss_newton_solve_reference(
            *solve_args, **kw),
        "kernel": lambda: registration.gauss_newton_solve(*solve_args,
                                                          **kw)}, torch)
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

    W = reg.refresh_width
    if W == 0:
        return results

    results.update(hold_reduce_select(m, s_r, queries,
                                      ref.apply(pts).contiguous(), W, k,
                                      timer, torch))
    return results


def pole_world_case(cfg, torch, dev, n_edges, n_planes, seed=3):
    """A lattice of vertical poles (the edge map) inside a 16 x 16 x 16 m
    box room (the surface map), both filled by the port's insert at the
    configuration's map shapes, and ``n_edges`` pole points and
    ``n_planes`` wall points seen from a known pose, at a start pose
    perturbed from it: (edge map, surface map, edge body points, wall body
    points, start pose)."""
    import numpy as np

    from superodom_tpu_torch import mapstate
    from superodom_tpu_torch.geometry import Pose, quat_mul, so3_exp
    from superodom_tpu_torch.io.datasets import pole_lattice

    rng = np.random.default_rng(seed)
    pole = torch.from_numpy(pole_lattice(rng)).to(dev)
    walls = rng.uniform(-8, 8, (6, 3000, 3))
    for i in range(6):
        walls[i, :, i // 2] = 8.0 if i % 2 else -8.0
    walls = torch.from_numpy(walls.reshape(-1, 3).astype(np.float32)).to(dev)
    maps = []
    for pts, res in ((pole, cfg.sensor.default_line_res),
                     (walls, cfg.sensor.default_plane_res)):
        m = mapstate.empty_map(cfg.map, device=dev)
        for chunk in torch.split(pts, 1000):
            m = mapstate.insert(m, cfg.map, chunk.contiguous(),
                                torch.ones(len(chunk), dtype=torch.bool,
                                           device=dev),
                                torch.tensor(res, device=dev))
        maps.append(m)
    true = Pose(so3_exp(torch.tensor([0.0, 0.0, 0.04], device=dev)),
                torch.tensor([0.15, -0.1, 0.05], device=dev))
    e_body = true.inverse().apply(pole[torch.from_numpy(
        rng.integers(0, len(pole), n_edges)).to(dev)]).contiguous()
    p_body = true.inverse().apply(walls[torch.from_numpy(
        rng.integers(0, len(walls), n_planes)).to(dev)]).contiguous()
    pose0 = Pose(quat_mul(so3_exp(torch.tensor([0.003, -0.002, 0.01],
                                               device=dev)), true.q),
                 true.t + torch.tensor([0.03, -0.02, 0.01], device=dev))
    return maps[0], maps[1], e_body, p_body, pose0


def hold_edge_fit(neigh, sq, nvalid, mask, line_res, reg, timer, torch,
                  tag):
    """K11b against its plain version: every output identical, except in a
    lane that edge_gate_margin_lanes flags (a decision within 1e-5 of a
    gate), and the line says how many lanes those are."""
    from superodom_tpu_torch import kernels, registration

    args = (neigh.contiguous(), sq.contiguous(), nvalid.contiguous(),
            mask.contiguous(), line_res, reg.min_edge_neighbors,
            reg.edge_max_dist_inlier)
    out_k = kernels.edge_fit(*args)
    out_r = registration.edge_fit_reference(*args)
    torch.cuda.synchronize()
    near = registration.edge_gate_margin_lanes(*args[:3], line_res,
                                               *args[5:])
    differ = lanes_that_differ(out_k, out_r, torch)
    far = ~near
    err = max(float((out_k[i] - out_r[i])[far].abs().max()) if far.any()
              else 0.0 for i in range(3))
    nq = sq.shape[0]
    log(f"K11b edge_fit ({tag}): {int(out_r[3].sum())} of {nq} lines valid, "
        f"codes {torch.bincount(out_r[4], minlength=7).tolist()}, "
        f"{int(near.sum())} lanes within 1e-5 of a gate, "
        f"{int(differ.sum())} lanes differ in any output "
        f"({int((differ & far).sum())} of them away from a gate); max abs "
        f"err of a, b, coeff away from a gate {err:.3e}")
    if bool((differ & far).any()) or err != 0.0:
        raise SystemExit("K11b edge_fit disagrees with its plain version")
    k = sq.shape[1]
    return out_r, dict(
        err=err, ms=timer(lambda: kernels.edge_fit(*args)),
        plain_ms=timer(lambda: registration.edge_fit_reference(*args)),
        # neighbourhoods, mask, resolution; a, b, coeff, valid, code;
        # ~1,500 operations a feature (81 cross products of the consensus,
        # the PCA, the eigensolver, the gates)
        bound=bound(nq * k * 17 + nq + 4 + nq * 33, nq * 1500))


def phase_edges(cfg, ds, torch, dev):
    """Phase 1 of path E: K11a, K11b and K4 with edge rows against their
    plain versions, and K1, K2, K9a, K9b and K10 at the shapes the edge
    half of the path gives them."""
    from superodom_tpu_torch import frontend, kernels, mapstate, registration
    from superodom_tpu_torch.config import RuntimeParams
    from superodom_tpu_torch.geometry import Pose, quat_mul, so3_exp
    from superodom_tpu_torch.io.datasets import ring_sweep
    from superodom_tpu_torch.ops import voxel
    from superodom_tpu_torch.runner import OdometryRunner

    def timer(fn):
        return device_ms(fn, torch)

    sensor, reg = cfg.sensor, cfg.registration
    line_res = torch.full((), sensor.default_line_res, device=dev)
    plane_res = torch.full((), sensor.default_plane_res, device=dev)
    shaper = OdometryRunner(cfg, device=dev)
    results = {}

    def scan_of(i):
        s = ds.scans[i]
        sc = shaper.make_scan(s.t_start, s.xyz_body, s.t_rel)
        return sc.xyz.contiguous(), sc.ring.contiguous(), sc.mask.contiguous()

    # K11a: on a full-width replay scan (its ring all zeros, as the runner
    # sends it: the stencil wraps) and on a ring-major sweep of a room with
    # poles (128 rings x 1,024 azimuths), where the edges are real
    cargs = (5, cfg.edge_curvature_threshold, sensor.min_range)
    sw_xyz, sw_ring = ring_sweep(128, 1024)
    inputs = {"replay scan, zero ring": scan_of(len(ds.scans) // 2),
              "ring-major sweep": (
                  torch.from_numpy(sw_xyz).to(dev),
                  torch.from_numpy(sw_ring).to(dev),
                  torch.ones(len(sw_xyz), dtype=torch.bool, device=dev))}
    for label, inp in inputs.items():
        e_k = kernels.curvature_edges(*inp, *cargs)
        e_r = frontend.curvature_edge_extraction_reference(*inp, *cargs)
        torch.cuda.synchronize()
        differ = int((e_k != e_r).sum())
        log(f"K11a curvature_edges ({label}): {inp[0].shape[0]} lanes, "
            f"{int(inp[2].sum())} live, {int(e_r.sum())} edges; {differ} "
            f"lanes differ from the plain version")
        if differ or not bool(e_r.any()):
            raise SystemExit("K11a curvature_edges disagrees with its plain "
                             "version")
    inp = inputs["replay scan, zero ring"]
    n = inp[0].shape[0]
    results["curvature_edges"] = dict(
        err=0.0, ms=timer(lambda: kernels.curvature_edges(*inp, *cargs)),
        plain_ms=timer(lambda: frontend.curvature_edge_extraction_reference(
            *inp, *cargs)),
        # points, ring, mask; the edge mask; ~80 operations a lane (ten
        # neighbour differences and selects, two norms, a division)
        bound=bound(n * (12 + 4 + 1 + 1), n * 80))

    # path E's warm edge map: the edge stream of 40 replay scans (K11a,
    # compaction, K10 at line_res) inserted at the true poses
    def edge_stream(i):
        xyz, ring, mask = scan_of(i)
        em = frontend.curvature_edge_extraction(
            xyz, ring, mask, curvature_threshold=cfg.edge_curvature_threshold,
            min_range=sensor.min_range)
        wide = frontend.select_features(xyz, em, sensor.compact_width // 2)
        pts, keep = frontend.thin_and_select(
            xyz, em, line_res, sensor.max_edge_features,
            sensor.compact_width // 2)
        return wide, pts.contiguous(), keep.contiguous()

    def gt_pose(i):
        return Pose(torch.tensor(ds.gt_poses_q[i], device=dev),
                    torch.tensor(ds.gt_poses_t[i], device=dev))

    n_map = min(40, len(ds.scans) - 1)
    m = mapstate.empty_map(cfg.map, device=dev)
    for i in range(n_map):
        _, pts, keep = edge_stream(i)
        m = mapstate.insert(m, cfg.map, gt_pose(i).apply(pts), keep, line_res)
    (wide_xyz, wide_mask), pts, keep = edge_stream(n_map)
    log(f"phase 1 [edges]: edge map of "
        f"{int(torch.sum(torch.where(m.keys >= 0, m.cnt, 0)))} points in "
        f"{int((m.keys >= 0).sum())} cells from {n_map} scans; "
        f"{int(keep.sum())} edge features of {pts.shape[0]}")

    # K10 on the edge stream: compact_width // 2 lanes, the table sized by
    # that width
    wide_xyz, wide_mask = wide_xyz.contiguous(), wide_mask.contiguous()
    nw = wide_xyz.shape[0]
    bits = voxel._claim_table_bits(nw, 0)
    keep_k = kernels.voxel_claim(wide_xyz, wide_mask, line_res, bits)
    keep_r = voxel.voxel_downsample_scatter_reference(wide_xyz, wide_mask,
                                                      line_res, bits)
    torch.cuda.synchronize()
    differ = int((keep_k != keep_r).sum())
    log(f"K10 voxel_claim (edge stream): {nw} lanes, {int(wide_mask.sum())} "
        f"edges in, table 2^{bits}, {int(keep_r.sum())} survive at "
        f"{sensor.default_line_res} m; {differ} lanes differ")
    if differ or not bool(keep_r.any()):
        raise SystemExit("K10 voxel_claim disagrees with its plain version")
    results["voxel_claim"] = dict(
        err=float(differ),
        ms=timer(lambda: kernels.voxel_claim(wide_xyz, wide_mask, line_res,
                                             bits)),
        plain_ms=timer(lambda: voxel.voxel_downsample_scatter_reference(
            wide_xyz, wide_mask, line_res, bits)),
        bound=bound(nw * 12 + nw + 4 + nw, nw * 46))

    # K1, K2 (k = 10), K9a (W = 20), K9b (10 of 20) and K11b on the warm
    # edge map, at the edge features of the next scan at a perturbed pose
    gt = gt_pose(n_map)
    pose = Pose(quat_mul(so3_exp(torch.tensor([0.004, -0.003, 0.01],
                                              device=dev)), gt.q),
                gt.t + torch.tensor([0.03, -0.02, 0.01], device=dev))
    queries = pose.apply(pts).contiguous()
    k, W = reg.edge_knn, max(reg.refresh_width, 2 * reg.edge_knn)
    sel, (s_r, nr, sr, vr) = hold_lookup_select(
        m, cfg.map.cell_size, queries, k, timer, torch, " [edge map]")
    results.update(sel)
    results.update(hold_reduce_select(
        m, s_r, queries, Pose(gt.q, gt.t + 0.01).apply(pts).contiguous(), W,
        k, timer, torch, " [edge map]"))
    hold_edge_fit(nr, sr, vr, keep, line_res, reg, timer, torch,
                  "path E's edge map")

    # K11b and K4 on a pole lattice (lines) in a walled room (planes):
    # 512 line and 2,048 plane correspondences at path E's shapes
    em, sm, e_body, p_body, pose0 = pole_world_case(
        cfg, torch, dev, sensor.max_edge_features,
        sensor.max_surface_features)
    w_e = pose0.apply(e_body).contiguous()
    w_p = pose0.apply(p_body).contiguous()
    e_mask = torch.ones(len(e_body), dtype=torch.bool, device=dev)
    _, (_, en, es, ev) = hold_lookup_select(
        em, cfg.map.cell_size, w_e, k, timer, torch, " [pole lattice]")
    fit, results["edge_fit"] = hold_edge_fit(en, es, ev, e_mask, line_res,
                                             reg, timer, torch,
                                             "pole lattice")
    if not float(fit[3].float().mean()) > 0.5:
        raise SystemExit("K11b edge_fit: half or fewer of the pole lattice's "
                         "lines are valid")
    slots = mapstate.octant_lookup_reference(sm.keys, w_p, cfg.map.cell_size)
    pn, ps, pv, _ = mapstate.knn_select_reference(sm.pts, slots, w_p,
                                                  reg.plane_knn)
    q, t = pose0.q.contiguous(), pose0.t.contiguous()
    pfit = registration.plane_fit_reference(
        pn.contiguous(), ps.contiguous(), pv.contiguous(),
        torch.ones(len(p_body), dtype=torch.bool, device=dev), w_p, q,
        plane_res)
    planes = registration.PlaneCorrs(p_body, *pfit)
    lines = registration.EdgeCorrs(e_body, *fit)
    rows = tuple(x.contiguous() for x in (e_body, *fit[:4]))
    a_sq, a_sq_e = (3.0 * plane_res).contiguous(), (3.0 * line_res).contiguous()
    args4 = (p_body, *(x.contiguous() for x in pfit[:4]), q, t, a_sq, rows,
             a_sq_e)
    Hk, gk, _ = kernels.normal_system(*args4)
    Hr, gr, _ = registration.normal_system_reference(*args4)
    Hk2, gk2, _ = kernels.normal_system(*args4)
    Hp, _, _ = registration.normal_system_reference(*args4[:8])
    torch.cuda.synchronize()
    scale = float(Hr.abs().max())
    err4 = max(float((Hk - Hr).abs().max()), float((gk - gr).abs().max()))
    share = float((Hr - Hp).abs().max()) / scale
    repeat = torch.equal(Hk, Hk2) and torch.equal(gk, gk2)
    log(f"K4 normal_system with edge rows: {int(pfit[3].sum())} valid "
        f"planes, {int(fit[3].sum())} valid lines (the lines move max |H| "
        f"by {share:.3f} of it); |H|max {scale:.4e}, max abs err "
        f"{err4:.3e} ({err4 / scale:.3e} relative), repeat bit-identical "
        f"{repeat}")
    if not (err4 <= TOL_K4_REL * scale and repeat and share > 0.01):
        raise SystemExit("K4 normal_system with edge rows disagrees with its "
                         "plain version")
    nq, ne = len(p_body), len(e_body)
    results["normal_system"] = dict(
        err=err4, ms=timer(lambda: kernels.normal_system(*args4)),
        plain_ms=timer(lambda: registration.normal_system_reference(*args4)),
        # plane rows, edge rows, pose, supports; H, g, cost; ~124
        # operations a plane row, ~300 an edge row
        bound=bound(nq * 33 + ne * 41 + 36 + 43 * 4, nq * 124 + ne * 300))

    rt = RuntimeParams(line_res, plane_res)
    n_it = reg.max_gn_iters
    hold_on = torch.tensor(True, device=dev)
    prior = registration.PosePrior(
        pose=pose0, information=torch.tensor([40.0, 50.0, 60.0, 10.0, 10.0,
                                              0.0], device=dev),
        enabled=torch.tensor(False, device=dev))
    kw = dict(prior=prior, use_edges=True,
              axis_hold_min=reg.axis_hold_min_matches,
              axis_hold_frac=reg.axis_hold_frac, hold_enabled=hold_on)
    solve_args = (pose0, planes, lines, rt, n_it)
    pk, sk1 = registration.gauss_newton_solve(*solve_args, **kw)
    pk2, sk2 = registration.gauss_newton_solve(*solve_args, **kw)
    ref, sr1 = registration.gauss_newton_solve_reference(*solve_args, **kw)
    torch.cuda.synchronize()
    dt = float((pk.t - ref.t).abs().max())
    dq = float((pk.q - ref.q).abs().max())
    rep = torch.equal(pk.q, pk2.q) and torch.equal(pk.t, pk2.t)
    same_small = bool(sk1) == bool(sr1) == bool(sk2)
    log(f"K4 gn_solve with edge rows ({nq} planes, {ne} lines, hold armed): "
        f"max |dt| {dt:.3e} m, max |dq| {dq:.3e}, first_small kernel "
        f"{bool(sk1)} plain {bool(sr1)}, repeat bit-identical {rep}; the "
        f"solve moved the pose {float((ref.t - pose0.t).abs().max()):.3e} m")
    if not (dt <= GN_TOL and dq <= GN_TOL and same_small and rep):
        raise SystemExit("K4 gn_solve with edge rows disagrees with the plain "
                         "solve")
    gn = (p_body, *(x.contiguous() for x in pfit[:4]),
          pfit[5].contiguous(), q, t, a_sq, n_it, 1e-4,
          tuple(x.contiguous() for x in (prior.pose.q, prior.pose.t,
                                         prior.information, prior.enabled)),
          reg.axis_hold_min_matches, reg.axis_hold_frac, hold_on, rows,
          a_sq_e)
    results["gn_solve"] = dict(
        err=max(dt, dq), ms=timer(lambda: kernels.gn_solve(*gn)),
        plain_ms=timer(lambda: registration.gauss_newton_solve_reference(
            *solve_args, **kw)),
        # rows once plus the vote column, pose and prior; the pose; per
        # iteration ~124 operations a plane row, ~300 an edge row and ~600
        # for the 6x6 solve
        bound=bound(nq * 37 + ne * 41 + 32 + 53 + 29 + 4,
                    n_it * (nq * 124 + ne * 300 + 600)))
    return results


def phase_voxel_claim(cases, torch, dev):
    """Phase 1, K10: ``cases`` = (label, configuration, dataset); returns
    label -> result.  Each on a real scan in the
    layout the runner uploads (host-decimated), gated as the step gates
    it, with the claim table sized by the sensor."""
    from superodom_tpu_torch import frontend, kernels
    from superodom_tpu_torch.ops import voxel
    from superodom_tpu_torch.runner import OdometryRunner

    results = {}
    for label, cfg, ds in cases:
        sensor = cfg.sensor
        s = ds.scans[len(ds.scans) // 2]
        scan = OdometryRunner(cfg, device=dev).make_scan(
            s.t_start, s.xyz_body, s.t_rel)
        gate = frontend.uniform_feature_gates(
            scan.xyz, None, scan.mask, sensor.min_range, sensor.max_range,
            skip_dup=True).contiguous()
        xyz = scan.xyz.contiguous()
        n = xyz.shape[0]
        bits = max((sensor.max_points * 4 - 1).bit_length(), 4)
        res = torch.full((), sensor.default_plane_res, device=dev)
        keep_k = kernels.voxel_claim(xyz, gate, res, bits)
        keep_r = voxel.voxel_downsample_scatter_reference(xyz, gate, res,
                                                          bits)
        keep_d = voxel.voxel_downsample_scatter(xyz, gate, res,
                                                table_bits=bits)
        # another resolution through the same device scalar, then back
        res.fill_(2.0 * sensor.default_plane_res)
        coarse_k = kernels.voxel_claim(xyz, gate, res, bits)
        coarse_r = voxel.voxel_downsample_scatter_reference(xyz, gate, res,
                                                            bits)
        res.fill_(sensor.default_plane_res)
        keep_k2 = kernels.voxel_claim(xyz, gate, res, bits)
        torch.cuda.synchronize()
        differ = int((keep_k != keep_r).sum()) + int(
            (coarse_k != coarse_r).sum())
        repeat = torch.equal(keep_k, keep_k2) and torch.equal(keep_k, keep_d)
        log(f"K10 voxel_claim ({label}): {n} lanes, {int(gate.sum())} "
            f"gated in, table 2^{bits}, {int(keep_r.sum())} survive at "
            f"{sensor.default_plane_res} m and {int(coarse_r.sum())} at "
            f"twice that; {differ} lanes differ from the plain version, "
            f"repeat identical {repeat}")
        if differ or not repeat or not bool(keep_r.any()) \
                or int(keep_r.sum()) >= int(gate.sum()):
            raise SystemExit("K10 voxel_claim disagrees with its plain "
                             "version")
        r = dict(
            err=float(differ),
            ms=device_ms(lambda: kernels.voxel_claim(xyz, gate, res, bits),
                         torch),
            plain_ms=device_ms(
                lambda: voxel.voxel_downsample_scatter_reference(
                    xyz, gate, res, bits), torch),
            # points, mask, the resolution; the keep-mask (the table is
            # scratch); ~40 integer operations and 3 divisions a lane,
            # held against the float32 rate
            bound=bound(n * 12 + n + 4 + n, n * 46))
        log(f"  voxel_claim ({label}): kernel {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound "
            f"{r['bound'][0] * 1e3:.4f} us ({r['bound'][1]})")
        results[label] = r
    return results


def expected_launches(cfg, stats):
    """What one replay must launch, from its configuration and the ICP
    rounds its scans report.  With edge features every lookup, selection
    and reduction runs twice (the surface map's and the edge map's)."""
    n = len(stats)
    rounds = sum(s["n_iterations"] for s in stats)
    refresh = cfg.registration.refresh_width > 0
    edges = cfg.use_edge_features
    maps = 2 if edges else 1
    return {
        "octant_lookup": maps * n,
        # with candidate refresh only round 1 selects at full width
        "knn_select": maps * (n if refresh else rounds),
        "plane_fit": rounds,
        "gn_solve": rounds,
        "normal_system": n,
        # one reduction a scan that goes on past round 1
        "reduce_candidates": maps * (sum(s["n_iterations"] > 1 for s in stats)
                                     if refresh else 0),
        "select_reduced": maps * (rounds - n) if refresh else 0,
        # one counted launch a scan (its fill, claim and compare kernels):
        # the surface thinning's in voxel mode, the edge stream's always
        "voxel_claim": n * ((cfg.sensor.scan_thin_mode == "voxel") + edges),
        "curvature_edges": n if edges else 0,
        "edge_fit": rounds if edges else 0,
    }


def phase_main(name, cfg, ds, torch, dev, out_dir, card):
    """Phase 2: one path through the user's entry point."""
    import numpy as np

    from superodom_tpu_torch import kernels
    from superodom_tpu_torch.io.datasets import ate_rmse
    from superodom_tpu_torch.runner import OdometryRunner

    runner = OdometryRunner(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    res = runner.run_dataset(ds, use_imu=True, log_path=os.path.join(
        out_dir, f"stats_{name}.jsonl"))
    counts = dict(kernels.launch_counts)
    n = len(ds.scans)
    rounds = sum(s["n_iterations"] for s in res.stats)
    expect = expected_launches(cfg, res.stats)
    log(f"phase 2 [{name}]: launches {counts}, expected {expect} "
        f"({rounds} ICP rounds over {n} scans); K4-family launches per "
        f"scan {(counts['gn_solve'] + counts['normal_system']) / n:.3f}")
    if counts != expect:
        raise SystemExit(f"kernel launch counts do not match the {name} path")
    if not (np.isfinite(res.poses_t).all() and np.isfinite(res.poses_q).all()):
        raise SystemExit(f"non-finite pose on the {name} path")
    if cfg.use_edge_features and not all(s["edge_stack"] > 0
                                         for s in res.stats):
        raise SystemExit(f"a scan of the {name} path extracted no edge")
    ate = ate_rmse(res.poses_t, np.asarray(ds.gt_poses_t))
    times = np.asarray([s["time_elapsed_ms"] for s in res.stats])
    summary = {
        "path": name,
        "scans": n,
        "points_per_scan": cfg.sensor.max_points,
        "icp_rounds": rounds,
        "scans_per_sec": res.scans_per_sec,
        "p50_step_ms": float(np.percentile(times, 50)),
        "p90_step_ms": float(np.percentile(times, 90)),
        "ate_m": ate,
        "final_t": res.poses_t[-1].tolist(),
        "peak_mem_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
    }
    if cfg.use_edge_features:
        summary["edge_stack_min"] = min(s["edge_stack"] for s in res.stats)
        summary["edge_map_last"] = res.stats[-1]["edge_map"]
        # MATCH_SUCCESS lines of each scan's final extraction, summed
        summary["edge_successes"] = sum(s["line_rejection_hist"][0]
                                        for s in res.stats)
        summary["line_rejection_hist_sum"] = np.sum(
            [s["line_rejection_hist"] for s in res.stats], axis=0).tolist()
    log(f"phase 2 [{name}] ({card}): " + json.dumps(summary))
    if not ate < ATE_BAR_M:
        raise SystemExit(f"{name} path: ATE {ate:.4f} m is not below "
                         f"{ATE_BAR_M} m")
    return res, counts, summary


def phase_cpu_agree(name, cfg, ds, res_gpu, torch):
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
    log(f"phase 3 [{name}]: first {n} scans, GPU vs CPU plain path: max "
        f"|dt| {dt:.3e} m, max |dq| {dq:.3e}")
    if not (dt <= CPU_AGREE_M and dq <= CPU_AGREE_M):
        raise SystemExit(f"{name} path: the GPU trajectory disagrees with "
                         f"the CPU path")


def phase_chunked(name, cfg, ds, torch, dev, out_dir, card, runs):
    """Phase 4: one path's chunked replays (``runs``: label -> keyword
    arguments of ``run_dataset_chunked``; the first is the reference of
    the others' poses)."""
    import numpy as np

    from superodom_tpu_torch import kernels
    from superodom_tpu_torch.io.datasets import ate_rmse
    from superodom_tpu_torch.runner import OdometryRunner

    out, first = {}, None
    for label, kw in runs.items():
        runner = OdometryRunner(cfg, device=dev)
        kernels.reset_counts()
        res = runner.run_dataset_chunked(ds, **kw)
        counts = dict(kernels.launch_counts)
        # the warm-up step is scan 0 again: the same state, the same inputs
        expect = expected_launches(cfg, res.stats + res.stats[:1])
        tag = f"phase 4 [{name}, {label}]"
        log(f"{tag}: launches {counts}, expected {expect}")
        if counts != expect:
            raise SystemExit(f"{tag}: kernel launch counts do not match")
        poses = np.concatenate([res.poses_t, res.poses_q], axis=1)
        if len(poses) != len(ds.scans) or not np.isfinite(poses).all():
            raise SystemExit(f"{tag}: missing or non-finite poses")
        if first is None:
            first = poses
        elif not np.array_equal(poses, first):
            raise SystemExit(f"{tag}: poses differ from "
                             f"{next(iter(runs))}'s")
        ate = ate_rmse(res.poses_t, np.asarray(ds.gt_poses_t))
        times = np.asarray([s["time_elapsed_ms"] for s in res.stats])
        summary = {"scans": len(ds.scans), **kw,
                   "icp_rounds": sum(s["n_iterations"] for s in res.stats),
                   "scans_per_sec": res.scans_per_sec,
                   "p50_step_ms": float(np.percentile(times, 50)),
                   "p90_step_ms": float(np.percentile(times, 90)),
                   "max_step_ms": float(times.max()), "ate_m": ate}
        if kw.get("high_rate"):
            t, p = res.high_rate_t, res.high_rate_p
            span = float(t[-1] - t[0])
            steps = np.linalg.norm(np.diff(p, axis=0), axis=1)
            summary.update(high_rate_samples=len(t), high_rate_span_s=span,
                           high_rate_max_step_m=float(steps.max()))
            if not (np.all(np.diff(t) > 0) and len(t) > span * HR_MIN_RATE
                    and np.isfinite(p).all()
                    and np.isfinite(res.high_rate_v).all()
                    and steps.max() < HR_MAX_STEP_M):
                raise SystemExit(f"{tag}: the IMU-rate stream fails its "
                                 f"checks: {summary}")
        log(f"{tag} ({card}): " + json.dumps(summary))
        if not ate < ATE_BAR_M:
            raise SystemExit(f"{tag}: ATE {ate:.4f} m is not below "
                             f"{ATE_BAR_M} m")
        if label == next(iter(runs)):
            with open(os.path.join(out_dir, f"stats_{name}_chunked.jsonl"),
                      "w") as f:
                for rec in res.stats:
                    f.write(json.dumps(rec) + "\n")
        out[label] = dict(summary, launches=counts, result=res)
    return out


def phase_chunked_cpu_agree(cfg, ds, res_gpu):
    """Phase 4: the ship path's first scans replayed chunked on the CPU
    (the same truncated dataset, the full IMU stream) against the card's
    chunked replay."""
    import numpy as np

    from superodom_tpu_torch.io.datasets import SimDataset
    from superodom_tpu_torch.runner import OdometryRunner

    n = min(CPU_SCANS, len(ds.scans))
    small = SimDataset(scans=ds.scans[:n], imu=ds.imu,
                       gt_poses_q=ds.gt_poses_q[:n],
                       gt_poses_t=ds.gt_poses_t[:n], times=ds.times[:n])
    res_cpu = OdometryRunner(cfg, device="cpu").run_dataset_chunked(
        small, chunk=n)
    dt = float(np.abs(res_cpu.poses_t - res_gpu.poses_t[:n]).max())
    dq = float(np.abs(res_cpu.poses_q - res_gpu.poses_q[:n]).max())
    log(f"phase 4 [ship]: first {n} scans chunked, GPU vs CPU plain path: "
        f"max |dt| {dt:.3e} m, max |dq| {dq:.3e}")
    if not (dt <= CPU_AGREE_M and dq <= CPU_AGREE_M):
        raise SystemExit("ship path: the chunked GPU trajectory disagrees "
                         "with the CPU path")
    return {"scans": n, "max_dt_m": dt, "max_dq": dq}


def measured(r):
    """The kernels line's measured fields of one phase-1 result."""
    return {"max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1]}


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
    import dataclasses

    from superodom_tpu_torch import kernels
    from superodom_tpu_torch.config import parity_config, ship_config

    kernels.build(verbose=True)
    log(f"phase 0: built {len(kernels.SOURCES)} sources in "
        f"{kernels.build_seconds:.2f} s")
    with open(os.path.join(args.out, "ptxas.txt"), "w") as f:
        f.write(kernels.build_log)
    dev = torch.device("cuda")

    cfg = ship_config("os1")
    cfg_vlp = ship_config("vlp16")
    datasets = {}
    for label, c in (("OS1-128", cfg), ("VLP-16", cfg_vlp)):
        t0 = time.perf_counter()
        datasets[label] = make_ship_dataset(c, N_SCANS)
        log(f"dataset {label}: {N_SCANS} scans of {c.sensor.max_points} "
            f"points in {time.perf_counter() - t0:.1f} s")
    ds, ds_vlp = datasets["OS1-128"], datasets["VLP-16"]
    # path -> (configuration, dataset, the kernels whose launches and
    # times the kernels line reports from it)
    paths = {
        "ship": (cfg, ds, ("octant_lookup", "knn_select", "plane_fit",
                           "gn_solve", "normal_system")),
        "parity": (parity_config("os1"), ds, ("reduce_candidates",
                                              "select_reduced")),
        "vlp16": (cfg_vlp, ds_vlp, ("voxel_claim",)),
        # path E: the reference-envelope ICP with curvature edges on
        "edges": (dataclasses.replace(parity_config("os1"),
                                      use_edge_features=True), ds,
                  ("curvature_edges", "edge_fit")),
    }
    path_of = {k: name for name, p in paths.items() for k in p[2]}
    if set(path_of) != set(kernels.KERNELS):
        raise SystemExit("a kernel is reported from no path")

    # phase 1: on every path's own map and features
    floor_ms = device_ms(lambda: kernels.launch_floor(dev), torch)
    log(f"launch floor (empty kernel, same harness): {floor_ms * 1e3:.2f} us")
    kres = {name: (phase_edges(c, d, torch, dev) if c.use_edge_features
                   else phase_kernels(name, c, d, torch, dev))
            for name, (c, d, _) in paths.items()}
    claim = phase_voxel_claim(
        (("VLP-16", cfg_vlp, ds_vlp), ("OS1-128", cfg, ds)), torch, dev)
    kres["vlp16"]["voxel_claim"] = claim["VLP-16"]

    # phase 2
    runs = {name: phase_main(name, c, d, torch, dev, args.out, smi)
            for name, (c, d, _) in paths.items()}
    launches = {k: runs[name][1][k] for k, name in path_of.items()}
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel was launched no time on its path: "
                         f"{launches}")
    for name, (_, d, _) in paths.items():
        for k, r in kres[name].items():
            if runs[name][1][k] <= 0:
                raise SystemExit(f"{k} was held at the {name} path's shapes "
                                 f"but that path did not launch it")
            log(f"  {k} [{name}]: kernel {r['ms'] * 1e3:.2f} us, plain "
                f"{r['plain_ms'] * 1e3:.2f} us, bound "
                f"{r['bound'][0] * 1e3:.4f} us ({r['bound'][1]}), launch "
                f"floor {floor_ms * 1e3:.2f} us, "
                f"{runs[name][1][k] / len(d.scans):.3f} launches a scan "
                f"({smi})")

    # phase 3
    for name, (c, d, _) in paths.items():
        phase_cpu_agree(name, c, d, runs[name][0], torch)

    # phase 4: the chunked replay
    n = len(ds.scans)
    cfg_livox = ship_config("livox")
    t0 = time.perf_counter()
    ds_livox = make_ship_dataset(cfg_livox, N_SCANS)
    log(f"dataset Livox: {N_SCANS} scans of {cfg_livox.sensor.max_points} "
        f"points in {time.perf_counter() - t0:.1f} s")
    chunked = {
        "ship": phase_chunked("ship", cfg, ds, torch, dev, args.out, smi, {
            "chunk=n": dict(chunk=n),
            "chunk=16": dict(chunk=CHUNK, time_chunks=True),
            "chunk=16 streamed": dict(chunk=CHUNK, preload=False,
                                      high_rate=True)}),
        "parity": phase_chunked("parity", paths["parity"][0], ds, torch,
                                dev, args.out, smi, {
                                    "chunk=n": dict(chunk=n),
                                    "chunk=16": dict(chunk=CHUNK,
                                                     time_chunks=True)}),
        "livox": phase_chunked("livox", cfg_livox, ds_livox, torch, dev,
                               args.out, smi, {"chunk=n": dict(chunk=n)}),
    }
    chunked_cpu = phase_chunked_cpu_agree(
        cfg, ds, chunked["ship"]["chunk=n"]["result"])
    for name, per in chunked.items():
        ref = runs[name][2] if name in runs else None
        log(f"phase 4 [{name}] ({smi}): chunked " + "; ".join(
            f"{label} {r['scans_per_sec']:.3f} scans/s, p50 / p90 "
            f"{r['p50_step_ms']:.2f} / {r['p90_step_ms']:.2f} ms, ATE "
            f"{r['ate_m']:.6f} m" for label, r in per.items())
            + (f" | per scan (phase 2) {ref['scans_per_sec']:.3f} scans/s, "
               f"p50 / p90 {ref['p50_step_ms']:.2f} / "
               f"{ref['p90_step_ms']:.2f} ms, ATE {ref['ate_m']:.6f} m"
               if ref else ""))

    # every number but ``launches`` and ``bound_ms`` is of the path under
    # ``path``; ``by_path`` has the same fields for every path that runs
    # the kernel
    entries = [{
        "name": k,
        "route": "cuda",
        "source": "superodom_tpu_torch/csrc/"
                  f"{kernels.SOURCE_OF.get(k, k)}.cu",
        "replaces": REPLACES[k],
        "launches": launches[k],
        "path": path_of[k],
        **measured(kres[path_of[k]][k]),
        "library_ms": None,  # no single PyTorch call computes these
        "by_path": {p: dict(measured(kres[p][k]), launches=runs[p][1][k])
                    for p in paths if k in kres[p]},
    } for k in kernels.KERNELS]
    record = {"card": smi, "kernels": entries, "main_path": runs["ship"][2],
              "paths": {p: runs[p][2] for p in paths},
              "launch_floor_ms": floor_ms,
              "voxel_claim_os1_128": measured(claim["OS1-128"]),
              "gn_solve_host_us": {p: kres[p]["gn_solve"]["host_us"]
                                   for p in paths
                                   if "host_us" in kres[p]["gn_solve"]},
              "chunked": {name: {label: {k: v for k, v in r.items()
                                         if k != "result"}
                                 for label, r in per.items()}
                          for name, per in chunked.items()},
              "chunked_cpu_agree": chunked_cpu}
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
