#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (superodom_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each of which fails the run (non-zero exit, no result line),
each logging its wall seconds as ``phase N: S s`` as it ends (kept in
``result.json`` ``seconds`` with the total):

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
   identical; K9a's k nearest equal to K9b's on its planes in every
   lane).  K2's gathered mode (the library's ``select_knn``, on no
   replay path) on the ship path's warm map: its gathered rows with their
   slot mask and with a lane-granular one, every output identical, and
   one library ``compute_plane_correspondences`` launching K1, it and K3
   once each to K3's planes.  Path E (edges): K11a curvature_edges bit for bit on a
   full-width replay scan (its ring all zeros, so the stencil wraps) and
   on a ring-major sweep of a room with poles (128 rings x 1,024
   azimuths); on path E's own warm edge map K1, K2 at k = 10, K9a at
   W = 20, K9b at 10 of 20, K11b edge_fit (identical but for the lanes at a
   gate margin, which are counted), and K10 on the 24,576-lane edge stream
   (a 2^17 table); on a pole lattice in a walled room K11b (more than half
   of 512 lines valid) and K4 with 512 edge rows beside 2,048 planes
   (normal system within 1e-5 of |H|, GN solve within GN_TOL).  K12a
   smoother_gn_step and smoother_marginalize on every system of the
   ship path's first SMOOTHER_SCANS scans per scan (the window filling,
   then marginalizing): each output's finite pattern its plain version's
   and its finite entries within SMOOTHER_K times the plain version's
   float32 sensitivity (the largest change of its output when its inputs
   move one float32 step) plus 2^-20 of their size, and every system the
   plain version's bits (K12a keeps the plain version's library orders at
   the ship window of 6 states: a library whose order moved fails here
   before the benchmark's ``correct`` does).  K10
   voxel_claim on a real decimated VLP-16 scan (10,923 lanes, a 2^17
   table) and an OS1-128 one (43,691 lanes, 2^19): the keep-mask
   identical, repeat runs identical, and the clusters its table takes
   (blocks, shared memory a block, how many the card holds at once).
   Device time of every kernel and of its plain version (CUDA graph of 20
   launches, CUDA events, median of 50 replays), of an empty kernel (the
   launch floor), the least time the card could take (bytes or
   operations, from this run's inputs), and the host wall time of one
   whole GN solve, kernel vs plain, in turns.
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
   CPU: the GPU trajectory must agree with it.  These CPU replays, and
   phase 4's, run in the worker process of phases 5 and 6 while the card
   runs phase 2; phase 5's data follows there while the card runs
   phases 2 to 4.
4. The chunked replay (``run_dataset_chunked``: all IMU ingested first,
   every input on the card before the timer, one discarded warm-up step
   of scan 0) over the same datasets: the ship path at chunk = n (the
   replay benchmark's throughput replay), at chunk 16 with
   ``time_chunks`` (its latency percentiles) and at chunk 16 with
   streamed inputs and the IMU-rate stream; path P at chunk = n; the
   first 32 scans of the Livox default path (``ship_config("livox")``,
   24,576 points a scan, 4,096 plane rows in K4) at chunk = n.  Each replay's
   launches must equal ``expected_launches`` plus scan 0's once (the
   warm-up), its poses be finite with the ATE below the bar, and the
   replays of a path agree to the bit; the stream's times strictly
   increase at more than 35 samples a second with no step over 0.15 m;
   the ship path's first scans, replayed chunked on the CPU, agree with
   the card's.
5. The SuperLoc path at 131,072 points a scan (``ship_config("os1")``
   with each stress case's overrides, the port's copy of the stress
   battery, seed 7): ``vio_corridor`` (SLAM with VIO undistortion and the
   VIO prior, the first 100 of 170 scans), ``superloc_corridor`` (localization against the
   frozen corridor prior map, with VIO; per scan, and its first 60 scans
   chunked at chunk = n) and ``localization_room`` (the room's prior map from a 0.3 m /
   0.05 rad init offset, 50 scans).  Each run's launches must equal
   ``expected_launches`` (plus scan 0's, chunked), its poses be finite,
   its first scans agree with the CPU plain path, a VIO case run K4 with
   the prior enabled on at least one scan, and the case pass its ATE
   bound, ``check`` and ``post_check`` (the map frozen) -- or, for a case
   the reference fails at this density (REFERENCE_FAILS, C7 in
   ROADMAP.md), give the CPU plain path's verdicts over the same
   replay.
   K4 with the VIO prior enabled against the plain solve at a corridor
   scan's features on the prior map; checkpoint and resume on the card
   (bit-identical), the prior map saved and loaded back.
6. Recorded sensors: phase 2's datasets written as rosbag2 recordings
   with the port's ``Rosbag2Writer`` into a temporary directory (each
   cloud recorded 0.12 s after its sweep starts, a 200 Hz IMU topic, a
   ground-truth odometry topic).  6a: the OS1-128 dataset's first 32
   scans as
   ouster_ros ``PointCloud2`` (48-byte points in the Ouster frame, ns
   times) through ``cli.main(["--bag", ..., "--profile", "os1_128",
   "--ship", "--gt-topic", ...])``; 6b: the same bag streamed message by
   message into ``OdometryRunner(ship_config("os1")).push_scan``; 6c: a
   Livox ``CustomMsg`` bag (``--profile livox_mid360 --ship``) and a
   VLP-16 ``PointCloud2`` bag (``--profile vlp_16`` alone: the JAX CLI's
   default configuration, K10), 32 scans each; 6d: 32 scans per scan of
   the ship path with edges and of the ship path with LIO prediction.
   Each run's launches must equal ``expected_launches``, its poses be
   finite, its ATE below the bar (the report's, against the bag's
   ground truth, equal to the trajectory's against the dataset), the
   loader guess the bag's sensor kind, the stream process every scan
   with none skipped or shed, LIO prediction take over on some scan, and
   the first scans agree with the CPU plain path on the same inputs (the
   same bag through the CLI with ``--device cpu``, the same stream, the
   same scans), run meanwhile in phase 5's worker process.  Host time a
   scan of the bag's read and decode, scans/s, the step's p50 / p90 and
   the ``push_scan`` call's are printed.

7. Many instances on one card (``parallel.replay_batched``: the step
   vmapped over the fleet, ICP at a fixed count, the map cadence decided
   per instance on the device; the JAX package's ``bench.bench_batch``).
   7a: every kernel entry through its custom operator's vmap rule at
   B = 1, 4, 16 and 64 (four datasets of seeds 7-10, 40 scans each, each
   its own warm ship map of 30 scans; instance j on dataset j % 4 at its
   own perturbed pose, its scan moved for each earlier copy, so that no
   two instances share their inputs): each instance's outputs equal its
   single launch bit for bit, one launch serves the fleet for every
   entry, the first tensor shared by four instances (a stride of 0) too,
   repeats identical; the device time of the batched launch at each B
   and its bound; K12a also at B = K12A_FLEET (the benchmark's fleet: the
   64 instances' inputs in turn, each copy scaled its own way).  7b: ``replay_batched(ship_config("os1"))`` over the
   datasets' first 20 scans in chunks of 10, four instances on the four
   datasets, against each
   dataset's B = 1 replay through the same function: every instance's
   poses within BATCH_AGREE_M, scan by scan; the ATE of each below the
   bar; K1-K4 launched as often as at B = 1.  7c: the same replay at
   B = 16 and 64 (the instances taking the datasets in turn), each
   instance held as in 7b against its dataset's B = 1 replay, and one
   instance without vmap (``run_dataset_chunked``, fixed count, chunk
   10) within BATCH_AGREE_M of B = 1 through vmap: aggregate scans/s,
   step p50 / p90 (chunk time / 10), peak device memory, every
   instance's ATE.  7d: path V (``ship_config("vlp16")``,
   K10) and path E (path P with edges: K9a, K9b, K10, K11a, K11b on both
   maps) at B = 2 over 24 scans of two datasets, each instance against its
   B = 1 replay, every kernel launched as often as at B = 1.

8. The fleet over a mesh on the one card (``parallel.make_mesh``; ranks
   and shards share the card, a placement that is printed).  8a: K1 with
   a shard window on phase 7a's first warm ship map and its 2,048
   queries, the table cut into M = 2 and 4 windows: each window bit for
   bit its windowed plain version, merged by a maximum the whole table's
   K1 and plain lookup; one window's device time and bound.  8b: the
   maps split in M shards (``replay_batched`` with a one-rank mesh): 7b's
   B = 4 ship fleet at M = 2 and 4 and 7d's path E pair at M = 2, every
   pose and the final maps (whole) equal to the unsplit runs' to the bit,
   K1 launched M times as often and every other kernel as often.  8c:
   two rank processes (``replay_mesh``, a ``gloo`` group) at B = 8 over
   phase 7's 20 scans with unsplit maps and with M = 2, and the same
   fleet in one process, each instance's poses equal to its dataset's 7b
   single replay's to the bit, each rank's launches the
   one-process fleet's; aggregate scans/s, step p50 /
   p90, each rank's placement and peak memory.

Output: a ``{"kernels": [...]}`` line (each entry with ``batched``: its
route under vmap and its time and bound at B = 4, 16 and 64, K12a's at
K12A_FLEET too; and an
``octant_lookup_window`` entry, K1 with a shard window), the nvidia-smi
line, then the last line ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
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
SUPERLOC_POINTS = 131072  # phase 5: the stress battery at OS1-128 density
SUPERLOC_SEED = 7
# the cases that the reference (the JAX package, ship config, on the CPU:
# tools/stress_matrix.py --points 131072) fails at this density (C7,
# ROADMAP.md); each is held to the CPU plain path's verdicts instead
REFERENCE_FAILS = ("vio_corridor", "superloc_corridor")
# phase 5's replays: (case, chunked, scans: None for the case's whole
# length).  vio_corridor replays its first 100 of 170 scans (its VIO
# prior on at 8 of them, as over all 170), the chunked twin of the
# per-scan superloc_corridor its first 60 (six with the prior on)
SUPERLOC_RUNS = (("vio_corridor", False, 100),
                 ("superloc_corridor", False, None),
                 ("superloc_corridor", True, 60),
                 ("localization_room", False, None))
CPU_WORKER_THREADS = 4  # the CPU plain path's worker, beside the card runs
CPU_WORKER_TIMEOUT_S = 600
# phase 6: recorded sensors.  (label, sensor kind, scans) of each bag;
# the CLI flags of each bag's run; (label, ship-config overrides, CPU
# scans) of 6d's per-scan runs (LIO's CPU run covers every scan: the
# prediction takes over once the smoother's window fills, at scan 10)
BAG_SCANS = 32
BAG_RUNS = (("ouster", "ouster", BAG_SCANS), ("livox", "livox", BAG_SCANS),
            ("vlp16", "velodyne", BAG_SCANS))
BAG_CLI_FLAGS = {"ouster": ["--profile", "os1_128", "--ship"],
                 "livox": ["--profile", "livox_mid360", "--ship"],
                 "vlp16": ["--profile", "vlp_16"]}
PER_SCAN_RUNS = (("edges_ship", dict(use_edge_features=True), CPU_SCANS),
                 ("lio", dict(enable_lio_prediction=True), BAG_SCANS))
LIDAR_TOPICS = {"ouster": "/os_cloud_node/points",
                "velodyne": "/velodyne_points", "livox": "/livox/lidar"}
IMU_TOPIC = "/imu/data"
GT_TOPIC = "/ground_truth"
CLOUD_DELAY_S = 0.12  # a cloud is recorded after its 0.1 s sweep
HR_MIN_RATE = 35.0  # IMU-rate stream samples a second of its span
HR_MAX_STEP_M = 0.15
# phase 7: many instances on one card.  The fleet sizes (64:
# BASELINE.json's fleet); bench_batch's datasets (40 scans) of four seeds,
# the first BATCH_SCANS of them replayed in chunks of 10, each instance
# within BATCH_AGREE_M of its single-instance replay; 7a's warm maps and
# its edge rows; 7d's replays of paths V and E
BATCH_SIZES = (1, 4, 16, 64)
BATCH_DATA_SCANS = 40
BATCH_SCANS = 20
BATCH_CHUNK = 10
BATCH_SEEDS = (7, 8, 9, 10)
BATCH_AGREE_M = 1e-4
BATCH_MAP_SCANS = 30
BATCH_W = 16
EDGE_Q = 512
BATCH_PATH_SCANS = 24
# phase 8: the fleet over a mesh on the one card: the maps split in M
# shards, and rank processes
MESH_SHARDS = (2, 4)
MESH_RANKS = 2
MESH_BATCH = 8
# K12a: the ship path's scans whose smoother systems phase 1 holds, the
# fleet 7a also times, the tolerance in units of the plain version's own
# float32 sensitivity (tests/test_torch_kernels_cuda.py holds K12a with
# it too)
SMOOTHER_SCANS = 14
K12A_FLEET = 512
SMOOTHER_K = 16.0
# NVIDIA H100 SXM peaks (data sheet): HBM bytes/s, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

REPLACES = {
    "octant_lookup": "superodom_tpu/mapstate.py:365",
    "knn_select": "superodom_tpu/mapstate.py:406",
    "knn_select_gathered": "superodom_tpu/mapstate.py:406",
    "plane_fit": "superodom_tpu/registration.py:212",
    "gn_solve": "superodom_tpu/registration.py:530",
    "normal_system": "superodom_tpu/registration.py:463",
    "reduce_candidates": "superodom_tpu/mapstate.py:444",
    "select_reduced": "superodom_tpu/mapstate.py:473",
    "voxel_claim": "superodom_tpu/ops/voxel.py:110",
    "curvature_edges": "superodom_tpu/frontend.py:307",
    "edge_fit": "superodom_tpu/registration.py:367",
    "smoother_gn_step": "superodom_tpu/inertial.py:616",
    "smoother_marginalize": "superodom_tpu/inertial.py:451",
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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
    from superodom_tpu_torch.io.datasets import bench_dataset

    return bench_dataset(n_scans, cfg.sensor.max_points, seed)


def first_scans(ds, n):
    """The dataset cut to its first ``n`` scans (the whole IMU and VIO
    streams kept)."""
    return ds._replace(scans=ds.scans[:n], gt_poses_q=ds.gt_poses_q[:n],
                       gt_poses_t=ds.gt_poses_t[:n], times=ds.times[:n])


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
    point of the query's cells and is not compared), and its ``k`` nearest
    at the same queries against K9b select_reduced on its planes (every
    lane, bit for bit) and K9b's plain version (validity, and points and
    distances of every valid lane); then K9b of ``k`` from those lanes at
    ``moved_q`` (the features moved as a round of GN moves them): validity,
    points and distances of every valid lane identical."""
    from superodom_tpu_torch import kernels, mapstate

    nq = queries.shape[0]
    C = m.pts.shape[1] // 3
    live = torch.unique(s_r[s_r >= 0]).numel()
    results = {}
    out_k = kernels.reduce_candidates(m.pts, s_r, queries, W, k)
    red_k, near_k = mapstate.ReducedCandidates(*out_k[:4]), out_k[4:]
    red_r, near_r = mapstate.reduce_candidates_reference(m.pts, s_r, queries,
                                                         W, k)
    near_b = kernels.select_reduced(*red_k, queries, k)
    torch.cuda.synchronize()
    v = red_r.valid
    same_valid = torch.equal(red_k.valid, v)
    err9a = max(float((a - b)[v].abs().max()) for a, b in
                zip(red_k[:3], red_r[:3]))
    vk = near_r[2]
    fused_b = all(torch.equal(a, b) for a, b in zip(near_k, near_b))
    fused_r = torch.equal(near_k[2], vk) and all(
        torch.equal(a[vk], b[vk]) for a, b in zip(near_k[:2], near_r[:2]))
    log(f"K9a reduce_candidates{tag} (W = {W}, k = {k}): validity equal "
        f"{same_valid}, {int(v.sum())} of {v.numel()} lanes valid, "
        f"{int((v.sum(1) < W).sum())} of {nq} rows with fewer than {W}, max "
        f"abs err of a valid coordinate {err9a:.3e}, every lane equal "
        f"{all(torch.equal(a, b) for a, b in zip(red_k, red_r))}; its "
        f"{k} nearest equal to K9b's on its planes in every lane {fused_b}, "
        f"to the plain version in every valid lane {fused_r}")
    if not (same_valid and err9a == 0.0 and bool(v.any()) and fused_b
            and fused_r):
        raise SystemExit("K9a reduce_candidates disagrees with its plain "
                         "version or with K9b")
    results["reduce_candidates"] = dict(
        err=err9a,
        ms=timer(lambda: kernels.reduce_candidates(m.pts, s_r, queries, W,
                                                   k)),
        plain_ms=timer(lambda: mapstate.reduce_candidates_reference(
            m.pts, s_r, queries, W, k)),
        # slot ids, queries, the live slot rows; three planes and validity,
        # the k nearest (points, distances, validity)
        bound=bound(nq * 8 * 4 + nq * 12 + live * 3 * C * 4 + nq * W * 13
                    + nq * k * 17, int((s_r >= 0).sum()) * C * 8))

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


def surface_features(shaper, s, res):
    """The surface features the step selects from simulated scan ``s``:
    the runner's layout, the quality gates, the configuration's thinning
    at ``res`` and the compaction."""
    from superodom_tpu_torch import frontend

    sensor = shaper.cfg.sensor
    scan = shaper.make_scan(s.t_start, s.xyz_body, s.t_rel)
    gate = frontend.uniform_feature_gates(
        scan.xyz, None, scan.mask, sensor.min_range, sensor.max_range,
        skip_dup=True)
    pts, mask, _ = frontend.thin_and_select(
        scan.xyz, gate, res, sensor.max_surface_features,
        sensor.compact_width, scan.t_rel, mode=sensor.scan_thin_mode,
        table_bits=max((sensor.max_points * 4 - 1).bit_length(), 4))
    return pts.contiguous(), mask.contiguous()


def gn_solve_args(pts, fit, q, t, a_sq, n_it, prior, reg, hold):
    """``kernels.gn_solve``'s arguments for the plane rows of ``pts`` and
    their ``plane_fit`` outputs ``fit``, at pose (q, t), with ``prior``."""
    return (pts, *(x.contiguous() for x in fit[:4]), fit[5].contiguous(), q,
            t, a_sq, n_it, 1e-4,
            tuple(x.contiguous() for x in (prior.pose.q, prior.pose.t,
                                           prior.information, prior.enabled)),
            reg.axis_hold_min_matches, reg.axis_hold_frac, hold)


def phase_kernels(name, cfg, ds, torch, dev):
    """Phase 1: every kernel the ``name`` path runs between thinning and
    the pose, against its plain version on the card at that path's
    shapes."""
    from superodom_tpu_torch import kernels, mapstate, registration
    from superodom_tpu_torch.config import RuntimeParams
    from superodom_tpu_torch.geometry import Pose, quat_mul, so3_exp
    from superodom_tpu_torch.runner import OdometryRunner
    from superodom_tpu_torch.utils import device_ms as timer

    sensor, reg = cfg.sensor, cfg.registration
    res = torch.full((), sensor.default_plane_res, device=dev)
    shaper = OdometryRunner(cfg, device=dev)

    def features(i):
        return surface_features(shaper, ds.scans[i], res)

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
    if name == "ship":
        results["knn_select_gathered"] = hold_select_gathered(
            m, cfg.map, reg, pose, pts, mask, res, s_r, queries, out_r,
            timer, torch)

    # K4, n_iters = 0 mode (the final normal system): within 1e-5 of |H|
    a_sq = (3.0 * res).contiguous()
    args4 = (pts, out_r[0].contiguous(), out_r[1].contiguous(),
             out_r[2].contiguous(), out_r[3].contiguous(), q, t, a_sq)
    Hk, gk, ck = registration.normal_system(*args4)
    Hr, gr, cr = registration.normal_system_reference(*args4)
    Hk2, gk2, _ = registration.normal_system(*args4)
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
        return gn_solve_args(pts, out_r, q, t, a_sq, n_it, pr, reg, hold_on)

    gn_err = 0.0
    for case, pr in (("prior off", prior(False)), ("prior on", prior(True))):
        qtk, sk1 = kernels.gn_solve(*gn_args(pr))
        qtk2, sk2 = kernels.gn_solve(*gn_args(pr))
        (qk, tk), (qk2, tk2) = qtk.split((4, 3)), qtk2.split((4, 3))
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

    if name == "ship":
        results.update(hold_smoother(cfg, ds, timer, torch, dev))
    W = reg.refresh_width
    if W == 0:
        return results

    results.update(hold_reduce_select(m, s_r, queries,
                                      ref.apply(pts).contiguous(), W, k,
                                      timer, torch))
    return results


def smoother_calls(cfg, ds, n, dev):
    """The inputs of every K12a call in a per-scan replay of the first
    ``n`` scans of ``ds`` on ``dev``: name -> list of argument tuples."""
    from superodom_tpu_torch import inertial
    from superodom_tpu_torch.runner import OdometryRunner

    rec = {"smoother_gn_step": [], "smoother_marginalize": []}
    plain = (inertial._gn_step, inertial._marginal_system)

    # each argument keeps its strides: the plain version's library calls
    # pick their order by them (the factors' Jacobians are transposed slabs)
    def keep(name, fn):
        def f(*a):
            rec[name].append(tuple(x.detach().clone() for x in a))
            return fn(*a)
        return f

    inertial._gn_step = keep("smoother_gn_step", plain[0])
    inertial._marginal_system = keep("smoother_marginalize", plain[1])
    try:
        OdometryRunner(cfg, device=dev).run_dataset(first_scans(ds, n))
    finally:
        inertial._gn_step, inertial._marginal_system = plain
    return rec


def smoother_work(name, w, bias_map=True):
    """K12a's (bytes, operations) for one instance at a window of ``w``
    states: inputs read once (the bias map, one copy a launch, only with
    ``bias_map``), outputs written once; the GN step's normal equations,
    change of basis (4 N^3), LU (2/3 N^3) and products, the
    marginalisation's blocks, two LUs and Schur complement."""
    if name == "smoother_marginalize":
        return ((450 + 15 + 90 + 6 + 225 + 15) * 4 + (225 + 15) * 4,
                675 * 30 + 225 * 12 + 900 + 630 + 2250 + 7200 + 3600
                + 240 * 30 + 2250 + 450 + 225 + 6 * 225)
    n = 15 * w
    inputs = 90 * w + 6 * w + 465 * (w - 1) + 241
    return ((inputs + n + (n * n if bias_map else 0)) * 4,
            4 * n ** 3 + 2 * n ** 3 // 3 + 9 * n * n
            + 27900 * (w - 1) + 2880 * w)


def smoother_gaps(name, args, torch):
    """K12a's entry ``name`` at ``args`` against its plain version on the
    card, per output: (the finite patterns agree, the largest error of the
    finite entries, the plain version's float32 sensitivity (the largest
    change of the output over four draws of every factor, residual and
    prior entry moved one float32 step, ``nextafter``), the size of the
    finite entries, bit-identical).  tests/test_torch_kernels_cuda.py
    holds the kernel with it too."""
    from superodom_tpu_torch import inertial, kernel_ops

    plain = {"smoother_gn_step": inertial._gn_step_reference,
             "smoother_marginalize":
                 inertial._marginal_system_reference}[name]

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    got = tup(getattr(kernel_ops, name)(*(a.contiguous() for a in args)))
    want = tup(plain(*args))
    g = torch.Generator(device="cpu").manual_seed(0)
    sens = [0.0] * len(want)
    for _ in range(4):
        moved = list(args)
        for i in range(6):
            up = torch.rand(args[i].shape, generator=g) < 0.5
            moved[i] = torch.nextafter(args[i], torch.where(
                up, float("inf"), float("-inf")).to(args[i].device))
        for j, (a, b) in enumerate(zip(tup(plain(*moved)), want)):
            fin = torch.isfinite(a) & torch.isfinite(b)
            if fin.any():
                sens[j] = max(sens[j], float((a - b)[fin].abs().max()))
    out = []
    for k, w, s in zip(got, want, sens):
        fin = torch.isfinite(w)
        err = float((k - w)[fin].abs().max()) if fin.any() else 0.0
        size = float(w[fin].abs().max()) if fin.any() else 0.0
        out.append((torch.equal(torch.isfinite(k), fin), err, s, size,
                    bool(((k == w) | ((k != k) & (w != w))).all())))
    return out


def smoother_within(err, sens, size):
    """K12a's tolerance off its exact orders: SMOOTHER_K times the plain
    version's sensitivity plus 2^-20 of the output's size."""
    return err <= SMOOTHER_K * sens + 2.0 ** -20 * size


def hold_smoother(cfg, ds, timer, torch, dev):
    """K12a on every system of the ship path's first SMOOTHER_SCANS scans
    (the window filling from empty, then marginalizing) against its plain
    version (``smoother_gaps``): the finite patterns equal, every system
    within tolerance and, at the ship window, every one the plain
    version's bits (a library whose order moved fails here first); kernel
    and plain timed at the last GN step's and marginalisation's inputs (a
    full window)."""
    from superodom_tpu_torch import inertial, kernels

    calls = smoother_calls(cfg, ds, SMOOTHER_SCANS, dev)
    plain = {"smoother_gn_step": inertial._gn_step_reference,
             "smoother_marginalize": inertial._marginal_system_reference}
    results = {}
    for name, per in calls.items():
        held = [smoother_gaps(name, a, torch) for a in per]
        for h in held:
            for fin, e, s, size, _ in h:
                if not fin or not smoother_within(e, s, size):
                    raise SystemExit(
                        f"K12a {name} disagrees with its plain version: "
                        f"finite pattern equal {fin}, error {e:.3e}, "
                        f"sensitivity {s:.3e}, size {size:.3e}")
        worst = max((e / s if s > 0 else (0.0 if e == 0 else float("inf")))
                    for h in held for _, e, s, _, _ in h)
        err = max(e for h in held for _, e, _, _, _ in h)
        same = sum(all(o[4] for o in h) for h in held)
        last = per[-1]
        last_c = tuple(x.contiguous() for x in last)
        log(f"K12a {name}: {len(per)} systems of {SMOOTHER_SCANS} scans "
            f"within tolerance, {same} of them bit-identical, max abs err "
            f"{err:.3e}, worst error / sensitivity {worst:.3f} (limit "
            f"{SMOOTHER_K})")
        if same != len(per):
            raise SystemExit(
                f"K12a {name}: {len(per) - same} of {len(per)} systems at "
                f"the ship window of {cfg.imu.window_size} states are not "
                f"the plain version's bits: the library's order moved")
        results[name] = dict(
            err=err, err_over_sensitivity=worst, identical=same,
            systems=len(per),
            ms=timer(lambda: getattr(kernels, name)(*last_c)),
            plain_ms=timer(lambda: plain[name](*last)),
            bound=bound(*smoother_work(name, cfg.imu.window_size)))
    return results


def hold_select_gathered(m, map_cfg, reg, pose, pts, mask, res, s_r,
                         queries, fit, timer, torch):
    """K2's gathered mode (the library's ``select_knn``) on the path's
    warm map at its shapes: the gathered rows with their slot mask (then
    also equal to the slot mode's outputs) and with a lane-granular mask,
    every output bit for bit against its plain version; its launches in
    one call of the library's ``compute_plane_correspondences`` (counts
    set to 0 just before), whose normals and offsets must be K3's on the
    slot mode's neighbours (``fit``)."""
    from superodom_tpu_torch import kernels, mapstate, registration

    k = reg.plane_knn
    nq, C = queries.shape[0], m.pts.shape[1] // 3
    cand, cvalid = mapstate._candidate_rows(m.pts, s_r)
    g = torch.Generator(device="cpu").manual_seed(11)
    lanes = (torch.rand(cvalid.shape, generator=g) < 0.67).to(cvalid.device)
    slot_mode = kernels.knn_select(m.pts, s_r, queries, k)
    ok = True
    for label, cv in (("slot mask", cvalid), ("lane mask", cvalid & lanes)):
        out_k = kernels.knn_select_gathered(cand, cv, queries, k)
        out_r = mapstate.select_knn_reference(cand, cv, queries, k)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(out_k, out_r)]
        as_slots = (label == "lane mask" or all(
            torch.equal(a, b) for a, b in zip(out_k, slot_mode)))
        log(f"K2 knn_select_gathered ({label}, k = {k}): neighbours, sq, "
            f"valid, lane equal {same}, equal to the slot mode "
            f"{as_slots}, {int(out_r[2].sum())} of {out_r[2].numel()} "
            f"neighbours valid, {int(cv.sum())} of {cv.numel()} lanes set")
        ok = ok and all(same) and as_slots
    if not ok:
        raise SystemExit("K2 knn_select_gathered disagrees with its plain "
                         "version")
    kernels.reset_counts()
    lib = registration.compute_plane_correspondences(m, map_cfg, reg, pose,
                                                     pts, mask, res)
    torch.cuda.synchronize()
    launched = {k_: v for k_, v in kernels.launch_counts.items() if v}
    log(f"library compute_plane_correspondences: launches {launched}, "
        f"{int(lib.valid.sum())} valid planes")
    if launched != {"octant_lookup": 1, "knn_select_gathered": 1,
                    "plane_fit": 1} or not (
            torch.equal(lib.normal, fit[0]) and torch.equal(lib.d, fit[1])):
        raise SystemExit("compute_plane_correspondences did not run K1, "
                         "K2's gathered mode and K3 to K3's planes")
    return dict(
        err=0.0, launches=launched["knn_select_gathered"],
        ms=timer(lambda: kernels.knn_select_gathered(cand, cvalid, queries,
                                                     k)),
        plain_ms=timer(lambda: mapstate.select_knn_reference(
            cand, cvalid, queries, k)),
        # the gathered rows and lane mask, the queries; the outputs; 8
        # operations a candidate distance
        bound=bound(nq * 8 * 3 * C * 4 + nq * 8 * C + nq * 12
                    + nq * k * (12 + 4 + 1 + 8), nq * 8 * C * 8))


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
    from superodom_tpu_torch.utils import device_ms as timer

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
    cs, smem, active = kernels.voxel_claim_clusters(bits, nw, 1, dev)
    log(f"K10 voxel_claim (edge stream): {nw} lanes, {int(wide_mask.sum())} "
        f"edges in, table 2^{bits} in clusters of {cs} blocks x "
        f"{smem // 1024} KB ({active} resident at once), "
        f"{int(keep_r.sum())} survive at {sensor.default_line_res} m; "
        f"{differ} lanes differ")
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
    # timed here too, kept apart from the pole lattice's kernels-line entry
    results["edge_fit_edge_map"] = hold_edge_fit(
        nr, sr, vr, keep, line_res, reg, timer, torch, "path E's edge map")[1]

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
    Hk, gk, _ = registration.normal_system(*args4)
    Hr, gr, _ = registration.normal_system_reference(*args4)
    Hk2, gk2, _ = registration.normal_system(*args4)
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
    from superodom_tpu_torch.utils import device_ms

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
        cs, smem, active = kernels.voxel_claim_clusters(bits, n, 1, dev)
        log(f"  voxel_claim ({label}): clusters of {cs} blocks x "
            f"{smem // 1024} KB of shared memory, {active} such clusters "
            f"resident at once")
        r = dict(
            err=float(differ),
            cluster=dict(blocks=cs, smem_bytes=smem, max_active=active),
            ms=device_ms(lambda: kernels.voxel_claim(xyz, gate, res, bits)),
            plain_ms=device_ms(
                lambda: voxel.voxel_downsample_scatter_reference(
                    xyz, gate, res, bits)),
            # points, mask, the resolution; the keep-mask (the table
            # lives in shared memory); ~40 integer operations and 3
            # divisions a lane, held against the float32 rate
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
    refreshing = sum(s["n_iterations"] > 1 for s in stats) if refresh else 0
    edges = cfg.use_edge_features
    maps = 2 if edges else 1
    return {
        "octant_lookup": maps * n,
        # with candidate refresh only round 1 selects at full width
        "knn_select": maps * (n if refresh else rounds),
        "plane_fit": rounds,
        "gn_solve": rounds,
        "normal_system": n,
        # one reduction a scan that goes on past round 1; it gives round 2
        # its neighbours, and K9b selects those of rounds 3..
        "reduce_candidates": maps * refreshing,
        "select_reduced": maps * (rounds - n - refreshing) if refresh else 0,
        # one launch a scan: the surface thinning's in voxel mode, the
        # edge stream's always
        "voxel_claim": n * ((cfg.sensor.scan_thin_mode == "voxel") + edges),
        "curvature_edges": n if edges else 0,
        "edge_fit": rounds if edges else 0,
        # the smoother: a GN step a smoother iteration, a marginalisation a
        # scan
        "smoother_gn_step": n * cfg.imu.smoother_gn_iters,
        "smoother_marginalize": n,
        # K2's gathered mode serves only the library's select_knn
        "knn_select_gathered": 0,
    }


def phase_main(name, cfg, ds, torch, dev, out_dir, card, phase="2"):
    """Phase 2 (and 6d): one path through the user's entry point."""
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
    log(f"phase {phase} [{name}]: launches {counts}, expected {expect} "
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
    log(f"phase {phase} [{name}] ({card}): " + json.dumps(summary))
    if not ate < ATE_BAR_M:
        raise SystemExit(f"{name} path: ATE {ate:.4f} m is not below "
                         f"{ATE_BAR_M} m")
    return res, counts, summary


def cpu_first_scans(n_threads, jobs):
    """Phases 3 and 4's CPU plain path, in the worker process beside the
    card's runs: each job (label, configuration, dataset cut to its first
    scans, chunked) replayed per scan, or chunked in one chunk.  Returns
    {label: (poses_t, poses_q)}."""
    import torch

    from superodom_tpu_torch.runner import OdometryRunner

    torch.set_num_threads(n_threads)
    out = {}
    for label, cfg, ds, chunked in jobs:
        runner = OdometryRunner(cfg, device="cpu")
        res = (runner.run_dataset_chunked(ds, chunk=len(ds.scans))
               if chunked else runner.run_dataset(ds))
        out[label] = (res.poses_t, res.poses_q)
    return out


def phase_cpu_agree(name, cpu, res_gpu):
    """Phase 3: the plain PyTorch path on the CPU over the first scans
    (``cpu``: its poses, from :func:`cpu_first_scans`)."""
    import numpy as np

    n = len(cpu[0])
    dt = float(np.abs(cpu[0] - res_gpu.poses_t[:n]).max())
    dq = float(np.abs(cpu[1] - res_gpu.poses_q[:n]).max())
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


def phase_chunked_cpu_agree(cpu, res_gpu):
    """Phase 4: the ship path's first scans replayed chunked on the CPU
    (the same truncated dataset, the full IMU stream; ``cpu``: its poses,
    from :func:`cpu_first_scans`) against the card's chunked replay."""
    import numpy as np

    n = len(cpu[0])
    dt = float(np.abs(cpu[0] - res_gpu.poses_t[:n]).max())
    dq = float(np.abs(cpu[1] - res_gpu.poses_q[:n]).max())
    log(f"phase 4 [ship]: first {n} scans chunked, GPU vs CPU plain path: "
        f"max |dt| {dt:.3e} m, max |dq| {dq:.3e}")
    if not (dt <= CPU_AGREE_M and dq <= CPU_AGREE_M):
        raise SystemExit("ship path: the chunked GPU trajectory disagrees "
                         "with the CPU path")
    return {"scans": n, "max_dt_m": dt, "max_dq": dq}


def case_outcome(case, runner, res, ds):
    """A stress case's verdicts on one run, as tools/stress_matrix.py
    reads them: finite poses, the settled ATE against the case's bound,
    the case's ``check`` and ``post_check``.  Returns (ATE, verdicts,
    failure messages)."""
    import numpy as np

    from superodom_tpu_torch.io.datasets import ate_rmse

    s = case.settle
    finite = bool(np.isfinite(res.poses_t).all()
                  and np.isfinite(res.poses_q).all())
    ate = (ate_rmse(res.poses_t[s:], np.asarray(ds.gt_poses_t)[s:])
           if finite else float("inf"))
    verdicts, notes = {"finite": finite, "ate": ate < case.ate_bound}, []
    for label, chk, args in (("check", case.check, (res, ds, s)),
                             ("post_check", case.post_check,
                              (runner, res, ds, s))):
        if chk is None:
            continue
        try:
            chk(*args)
            verdicts[label] = True
        except AssertionError as e:
            verdicts[label] = False
            notes.append(f"{label}: {e}")
    return ate, verdicts, notes


def superloc_run(case, cfg, ds, dev, chunked=False, n_scans=None):
    """One replay of a SuperLoc case on ``dev`` through the user's entry
    point: a fresh runner, the case's prior map primed (seed + 1, as
    tools/stress_matrix.py primes it), then ``run_dataset`` or, chunked,
    ``run_dataset_chunked`` at chunk = n with the inputs preloaded.  The
    launch counts are set to 0 after the priming and read after the
    replay.  ``n_scans`` replays the first scans only."""
    import numpy as np

    from superodom_tpu_torch import kernels
    from superodom_tpu_torch.io import scenarios
    from superodom_tpu_torch.runner import OdometryRunner

    if n_scans is not None:
        ds = first_scans(ds, n_scans)
    runner = OdometryRunner(cfg, device=dev)
    scenarios.prime_prior_map(runner, case,
                              np.random.default_rng(SUPERLOC_SEED + 1))
    kernels.reset_counts()
    if chunked:
        res = runner.run_dataset_chunked(ds, chunk=len(ds.scans))
    else:
        res = runner.run_dataset(ds, use_imu=True)
    counts = dict(kernels.launch_counts)
    return runner, res, counts, ds


def superloc_cases():
    """Phase 5's cases and configurations: {name: (case, config)} for
    every SUPERLOC_RUNS case."""
    import dataclasses

    from superodom_tpu_torch.config import ship_config
    from superodom_tpu_torch.io import scenarios

    cases = {c.name: c for c in scenarios.stress_battery(
        points_per_scan=SUPERLOC_POINTS)}
    base = ship_config("os1")
    return {name: (cases[name],
                   dataclasses.replace(base, **cases[name].cfg_overrides))
            for name, _, _ in SUPERLOC_RUNS}


def superloc_data():
    """Phase 5's data, built in the worker process while the card runs
    phases 2-4: {case name: dataset}.  The two corridor cases build the
    same dataset from the same seed; it is built once."""
    import numpy as np

    built, data = {}, {}
    for name, (case, _) in superloc_cases().items():
        world = "room" if name == "localization_room" else "corridor"
        if world not in built:
            built[world] = case.build(np.random.default_rng(SUPERLOC_SEED))
        data[name] = built[world]
    return data


def cpu_superloc(n_threads, data):
    """Phase 5's CPU plain path, in a worker process beside the card's
    runs: each of SUPERLOC_RUNS replayed on the CPU over ``data``, to its
    depth for a case the reference fails at this density (its verdicts
    are the card's gate), its first CPU_SCANS scans otherwise.  Returns
    {label: (first poses_t, first poses_q, verdicts or None, settled ATE
    or None, seconds)}."""
    import torch

    torch.set_num_threads(n_threads)
    cases = superloc_cases()
    out = {}
    for name, chunked, depth in SUPERLOC_RUNS:
        (case, cfg), ds = cases[name], data[name]
        whole = name in REFERENCE_FAILS
        t0 = time.perf_counter()
        runner, res, _, ds_n = superloc_run(
            case, cfg, ds, "cpu", chunked, n_scans=depth if whole
            else CPU_SCANS)
        ate, verdicts, _ = (case_outcome(case, runner, res, ds_n) if whole
                            else (None, None, None))
        out[run_label(name, chunked)] = (
            res.poses_t[:CPU_SCANS], res.poses_q[:CPU_SCANS], verdicts, ate,
            time.perf_counter() - t0)
    return out


def run_label(name, chunked):
    return name + (" chunked" if chunked else "")


def phase_superloc_case(case, cfg, ds, dev, out_dir, card, chunked=False,
                        depth=None):
    """Phase 5: one SuperLoc case on the card, over its first ``depth``
    scans (None: all).  Gates here: finite poses; launches equal to
    ``expected_launches`` (plus scan 0's once, chunked); a VIO case has at
    least one scan with K4's pose prior enabled (the VIO prediction
    source).  The gates against the CPU plain path are
    :func:`superloc_cpu_gates`'."""
    import numpy as np

    tag = f"phase 5 [{run_label(case.name, chunked)}]"
    runner, res, counts, ds = superloc_run(case, cfg, ds, dev, chunked,
                                           n_scans=depth)
    expect = expected_launches(cfg, res.stats
                               + (res.stats[:1] if chunked else []))
    log(f"{tag}: launches {counts}, expected {expect}")
    if counts != expect:
        raise SystemExit(f"{tag}: kernel launch counts do not match")
    ate, verdicts, notes = case_outcome(case, runner, res, ds)
    if not verdicts["finite"]:
        raise SystemExit(f"{tag}: non-finite pose")
    times = np.asarray([st["time_elapsed_ms"] for st in res.stats])
    prior_frames = sum(st["pred_source"] == 2 for st in res.stats)
    summary = {
        "case": case.name, "chunked": chunked, "scans": len(ds.scans),
        "points_per_scan": cfg.sensor.max_points,
        "icp_rounds": sum(st["n_iterations"] for st in res.stats),
        "launches": counts,
        "scans_per_sec": res.scans_per_sec,
        "p50_step_ms": float(np.percentile(times, 50)),
        "p90_step_ms": float(np.percentile(times, 90)),
        "settled_ate_m": ate, "ate_bound_m": case.ate_bound,
        "verdicts": verdicts, "notes": notes,
        "prior_enabled_frames": int(prior_frames),
        "degenerate_frames": int(sum(st["degenerate"] for st in res.stats)),
        "reference_fails_here": case.name in REFERENCE_FAILS,
    }
    log(f"{tag} ({card}): " + json.dumps(summary))
    with open(os.path.join(out_dir, f"stats_{case.name}"
                           f"{'_chunked' if chunked else ''}.jsonl"), "w") as f:
        for rec in res.stats:
            f.write(json.dumps(rec) + "\n")
    if cfg.use_vio_undistortion and prior_frames == 0:
        raise SystemExit(f"{tag}: no scan ran K4 with the VIO pose prior")
    return runner, res, summary


def superloc_cpu_gates(label, res, summary, cpu):
    """Phase 5, against the CPU plain path's run of the same case: the
    first CPU_SCANS scans agree within CPU_AGREE_M; the case's verdicts
    all pass or, for a case the reference fails at this density (C7),
    equal the CPU plain path's verdicts over the whole replay."""
    import numpy as np

    poses_t, poses_q, cpu_verdicts, cpu_ate, _ = cpu
    n = len(poses_t)
    dt = float(np.abs(poses_t - res.poses_t[:n]).max())
    dq = float(np.abs(poses_q - res.poses_q[:n]).max())
    summary.update(cpu_first_scans_max_dt_m=dt, cpu_first_scans_max_dq=dq)
    if cpu_verdicts is not None:
        summary.update(cpu_settled_ate_m=cpu_ate, cpu_verdicts=cpu_verdicts)
    tag = f"phase 5 [{label}]"
    log(f"{tag}: first {n} scans, GPU vs CPU plain path: max |dt| {dt:.3e} "
        f"m, max |dq| {dq:.3e}" + (
            f"; CPU settled ATE {cpu_ate:.6f} m, verdicts {cpu_verdicts}"
            if cpu_verdicts is not None else ""))
    if not (dt <= CPU_AGREE_M and dq <= CPU_AGREE_M):
        raise SystemExit(f"{tag}: the first {n} scans disagree with the CPU "
                         "plain path")
    verdicts = summary["verdicts"]
    if cpu_verdicts is not None:
        if verdicts != cpu_verdicts:
            raise SystemExit(f"{tag}: verdicts {verdicts} differ from the "
                             f"CPU plain path's {cpu_verdicts}")
    elif not all(verdicts.values()):
        raise SystemExit(f"{tag}: the case fails on the card: {verdicts} "
                         f"{summary['notes']}")


def phase_prior_k4(cfg, m, ds, i, uncertainty, torch, dev):
    """Phase 5: K4's GN solve with the VIO pose prior enabled, against the
    plain solve, at the corridor's own shapes: the features of scan ``i``
    (a scan the replay ran with the prior) at a pose 10 cm off along the
    corridor, the SuperLoc prior map ``m``, the prior's information as
    the step weighs it from the scan's carried ``uncertainty``; with the
    axis hold disarmed (the main path past warm-up) and armed.  The pose
    within GN_TOL of the plain solve, the same ``first_small``, repeat
    runs bit-identical."""
    from types import SimpleNamespace

    from superodom_tpu_torch import kernels, mapstate, registration
    from superodom_tpu_torch.config import RuntimeParams
    from superodom_tpu_torch.geometry import Pose
    from superodom_tpu_torch.pipeline import _vio_information
    from superodom_tpu_torch.runner import OdometryRunner
    from superodom_tpu_torch.utils import device_ms

    sensor, reg = cfg.sensor, cfg.registration
    res = torch.full((), sensor.default_plane_res, device=dev)
    pts, mask = surface_features(OdometryRunner(cfg, device=dev),
                                 ds.scans[i], res)
    gt = Pose(torch.tensor(ds.gt_poses_q[i], device=dev),
              torch.tensor(ds.gt_poses_t[i], device=dev))
    pose = Pose(gt.q, gt.t + torch.tensor([0.1, 0.0, 0.0], device=dev))
    queries = pose.apply(pts).contiguous()
    q, t = pose.q.contiguous(), pose.t.contiguous()
    slots = mapstate.octant_lookup_reference(m.keys, queries,
                                             cfg.map.cell_size)
    nr, sr, vr, _ = mapstate.knn_select_reference(m.pts, slots, queries,
                                                  reg.plane_knn)
    fit = registration.plane_fit_reference(
        nr.contiguous(), sr.contiguous(), vr.contiguous(), mask, queries, q,
        res)
    planes = registration.PlaneCorrs(pts, *fit)
    info = _vio_information(SimpleNamespace(uncertainty=torch.tensor(
        uncertainty, device=dev)), mask, reg, torch.float32)
    prior = registration.PosePrior(
        pose=Pose(gt.q, gt.t + torch.tensor([0.02, -0.01, 0.0], device=dev)),
        information=info.contiguous(),
        enabled=torch.tensor(True, device=dev))
    rt = RuntimeParams(torch.tensor(sensor.default_line_res, device=dev), res)
    n_it = reg.max_gn_iters
    a_sq = (3.0 * res).contiguous()
    nq = pts.shape[0]
    out, err = {}, 0.0
    for hold in (False, True):
        hold_t = torch.tensor(hold, device=dev)
        kw = dict(prior=prior, axis_hold_min=reg.axis_hold_min_matches,
                  axis_hold_frac=reg.axis_hold_frac, hold_enabled=hold_t)
        solve_args = (pose, planes, None, rt, n_it)
        gn = gn_solve_args(pts, fit, q, t, a_sq, n_it, prior, reg, hold_t)
        qtk, sk1 = kernels.gn_solve(*gn)
        qtk2, sk2 = kernels.gn_solve(*gn)
        (qk, tk), (qk2, tk2) = qtk.split((4, 3)), qtk2.split((4, 3))
        ref, sr1 = registration.gauss_newton_solve_reference(*solve_args,
                                                             **kw)
        torch.cuda.synchronize()
        dt = float((tk - ref.t).abs().max())
        dq = float((qk - ref.q).abs().max())
        same_small = bool(sk1) == bool(sr1) == bool(sk2)
        rep = torch.equal(qk, qk2) and torch.equal(tk, tk2)
        log(f"K4 gn_solve, VIO prior on, corridor scan {i} ({nq} rows, "
            f"{int(fit[3].sum())} valid planes, hold "
            f"{'armed' if hold else 'disarmed'}): max |dt| {dt:.3e} m, max "
            f"|dq| {dq:.3e}, first_small kernel {bool(sk1)} plain "
            f"{bool(sr1)}, repeat bit-identical {rep}; the solve moved the "
            f"pose {float((ref.t - pose.t).abs().max()):.3e} m; information "
            f"{[round(float(v), 2) for v in info]}")
        if not (dt <= GN_TOL and dq <= GN_TOL and same_small and rep):
            raise SystemExit("K4 gn_solve with the VIO prior disagrees with "
                             "the plain solve")
        err = max(err, dt, dq)
        if not hold:  # the main path's mode past warm-up
            out = dict(
                err=err, ms=device_ms(lambda: kernels.gn_solve(*gn)),
                plain_ms=device_ms(
                    lambda: registration.gauss_newton_solve_reference(
                        *solve_args, **kw)),
                bound=bound(nq * 37 + 32 + 53 + 29, n_it * (nq * 124 + 600)))
    out["err"] = err
    return out


def phase_checkpoint(cfg, ds, torch, dev, out_dir):
    """Phase 5: checkpoint and resume on the card.  Ten scans of the VIO
    corridor, ``save_state``; ``load_state`` into a fresh runner fed the
    same IMU and VIO streams; ten more scans in both: every output
    bit-identical.  Then ``save_prior_map`` / ``load_prior_map`` into a
    fresh state: above 0.9 of the stored points come back (the insert
    thins co-located points)."""
    import numpy as np

    from superodom_tpu_torch import checkpoint, mapstate
    from superodom_tpu_torch.convert import to_numpy
    from superodom_tpu_torch.pipeline import init_state
    from superodom_tpu_torch.runner import OdometryRunner

    def leaves(tree):
        return ([x for part in tree for x in leaves(part)]
                if isinstance(tree, tuple) else [tree])

    def leaves_equal(x, y):
        lx, ly = leaves(x), leaves(y)
        return len(lx) == len(ly) and all(
            np.array_equal(u, v) for u, v in zip(lx, ly))

    runners = [OdometryRunner(cfg, device=dev) for _ in range(2)]
    for r in runners:
        r._ingest_dataset_vio(ds)
    imu = ds.imu
    imu_i = 0

    def feed(rs, i):
        nonlocal imu_i
        t_end = ds.scans[i].t_start + float(ds.scans[i].t_rel[-1])
        while imu_i < len(imu.t) and imu.t[imu_i] <= t_end + 0.02:
            for r in rs:
                r.add_imu(imu.t[imu_i], imu.acc[imu_i], imu.gyr[imu_i])
            imu_i += 1

    a, b = runners
    for i in range(10):
        feed(runners, i)
        s = ds.scans[i]
        a.process_scan(s.t_start, s.xyz_body, s.t_rel)
    path = os.path.join(out_dir, "checkpoint.npz")
    checkpoint.save_state(path, a.state)
    b.state = checkpoint.load_state(path, cfg, dev)
    same = []
    for i in range(10, 20):
        feed(runners, i)
        s = ds.scans[i]
        outs = [to_numpy(r.process_scan(s.t_start, s.xyz_body, s.t_rel))
                for r in runners]
        same.append(leaves_equal(*outs))
    state_same = leaves_equal(*(to_numpy(r.state) for r in runners))
    os.remove(path)
    pcd = os.path.join(out_dir, "prior_map.pcd")
    checkpoint.save_prior_map(pcd, a.state)
    loaded = checkpoint.load_prior_map(pcd, cfg, init_state(cfg,
                                                            device=dev))
    os.remove(pcd)
    n_before = int(mapstate.total_points(a.state.surf_map))
    n_after = int(mapstate.total_points(loaded.surf_map))
    summary = {"resumed_scans": len(same), "outputs_bit_identical": all(same),
               "state_bit_identical": state_same,
               "map_points_saved": n_before, "map_points_loaded": n_after}
    log("phase 5 [checkpoint]: " + json.dumps(summary))
    if not (all(same) and state_same):
        raise SystemExit("phase 5: the resumed runner's outputs differ from "
                         "the original's")
    if not n_after > 0.9 * n_before:
        raise SystemExit("phase 5: the prior map did not come back")
    return summary


def phase_superloc(pool, data_async, torch, dev, out_dir, card):
    """Phase 5: the SuperLoc path on the card at 131,072 points a scan
    (``ship_config("os1")`` with each case's overrides, the stress
    battery's data, seed 7): ``vio_corridor`` (SLAM with VIO, the first
    100 of 170 scans), ``superloc_corridor`` (the frozen corridor prior
    map with VIO, 170 scans per scan, its first 60 chunked at chunk = n),
    ``localization_room`` (the room's prior map from a 0.3 m / 0.05 rad
    offset, 50 scans); K4 with the VIO prior at the corridor's shapes;
    checkpoint and resume.  The data comes from the worker process of
    ``pool`` (``data_async``, built during phases 2-4), and the CPU plain
    path's replays run there (CPU_WORKER_THREADS threads) beside the
    card's."""
    t0 = time.perf_counter()
    cases, data = superloc_cases(), data_async.get(
        timeout=CPU_WORKER_TIMEOUT_S)
    log(f"phase 5: waited {time.perf_counter() - t0:.1f} s for the "
        f"datasets ({SUPERLOC_POINTS} points a scan) from the worker")
    cpu_async = pool.apply_async(cpu_superloc, (CPU_WORKER_THREADS, data))
    out, card_runs = {}, {}
    for name, chunked, depth in SUPERLOC_RUNS:
        (case, cfg), ds = cases[name], data[name]
        runner, res, summary = phase_superloc_case(
            case, cfg, ds, dev, out_dir, card, chunked, depth)
        out[run_label(name, chunked)] = summary
        card_runs[run_label(name, chunked)] = res
        if name == "superloc_corridor" and not chunked:
            i = next(k for k, st in enumerate(res.stats)
                     if st["pred_source"] == 2)
            k4 = phase_prior_k4(cfg, runner.state.surf_map, ds, i,
                                res.stats[i - 1]["uncertainty"], torch, dev)
    out["checkpoint"] = phase_checkpoint(cases["vio_corridor"][1],
                                         data["vio_corridor"], torch, dev,
                                         out_dir)
    t0 = time.perf_counter()
    cpu = cpu_async.get(timeout=CPU_WORKER_TIMEOUT_S)
    log(f"phase 5: waited {time.perf_counter() - t0:.1f} s for the CPU "
        f"plain path's replays ("
        + ", ".join(f"{k} {v[4]:.1f} s" for k, v in cpu.items()) + ")")
    for label, res in card_runs.items():
        superloc_cpu_gates(label, res, out[label], cpu[label])
        r = out[label]
        log(f"phase 5 [{label}] ({card}): settled ATE "
            f"{r['settled_ate_m']:.6f} m (bound {r['ate_bound_m']} m), "
            f"{r['scans_per_sec']:.3f} scans/s, p50 / p90 "
            f"{r['p50_step_ms']:.2f} / {r['p90_step_ms']:.2f} ms, "
            f"{r['prior_enabled_frames']} scans with K4's VIO prior "
            f"enabled, verdicts {r['verdicts']}")
    return out, k4


def bag_message(rb, kind, s):
    """One scan of a dataset as its vendor's message (CDR bytes).

    ouster: ``sensor_msgs/PointCloud2`` in the ouster_ros layout (48 bytes
    a point, ``t`` in u32 ns, the points in the Ouster frame: the inverse
    of the adapter's sensor-frame transform, whose rotation is diagonal
    +-1 and so its own inverse).  velodyne: the velodyne_pointcloud layout (x,
    y, z, intensity f32, ring u16, f32 time at byte 18; 22 bytes a point).
    livox: ``livox_ros_driver2/CustomMsg`` (offsets in ns from the
    timebase, single-return tags on lines 0-3)."""
    import numpy as np

    from superodom_tpu_torch.io.adapters import (
        OUSTER_SENSOR_R,
        OUSTER_SENSOR_T,
    )

    n = len(s.xyz_body)
    t_ns = np.round(s.t_rel.astype(np.float64) * 1e9).astype(np.uint32)
    if kind == "livox":
        return rb.encode_livox_custom(rb.LivoxCustomMsg(
            s.t_start, "livox", int(round(s.t_start * 1e9)), s.xyz_body,
            t_ns, np.zeros(n, np.uint8), np.full(n, 0x10, np.uint8),
            (np.arange(n) % 4).astype(np.uint8)))
    if kind == "ouster":
        fields = (("x", 0, "<f4"), ("y", 4, "<f4"), ("z", 8, "<f4"),
                  ("intensity", 16, "<f4"), ("t", 20, "<u4"),
                  ("reflectivity", 24, "<u2"), ("ring", 26, "<u2"),
                  ("ambient", 28, "<u2"), ("range", 32, "<u4"))
        step = 48
        xyz = ((s.xyz_body - OUSTER_SENSOR_T) @ OUSTER_SENSOR_R).astype(
            np.float32)
    else:
        fields = (("x", 0, "<f4"), ("y", 4, "<f4"), ("z", 8, "<f4"),
                  ("intensity", 12, "<f4"), ("ring", 16, "<u2"),
                  ("time", 18, "<f4"))
        step = 22
        xyz = s.xyz_body
    rec = np.zeros(n, np.dtype({"names": [f[0] for f in fields],
                                "formats": [f[2] for f in fields],
                                "offsets": [f[1] for f in fields],
                                "itemsize": step}))
    rec["x"], rec["y"], rec["z"] = xyz.T
    if kind == "ouster":
        rec["t"] = t_ns
        rec["range"] = np.linalg.norm(s.xyz_body, axis=1) * 1e3  # mm
    else:
        rec["time"] = s.t_rel
        rec["ring"] = np.arange(n) % 16
    code = {v: k for k, v in rb._PF_DTYPES.items()}
    return rb.encode_pointcloud2(rb.PointCloud2(
        s.t_start, "lidar", 1, n,
        [rb.PointField(name, off, code[np.dtype(t)], 1)
         for name, off, t in fields],
        False, step, step * n, rec.tobytes(), True))


def write_bag(path, kind, ds, n):
    """The first ``n`` scans of ``ds`` as a rosbag2 recording at ``path``:
    each cloud recorded CLOUD_DELAY_S after its sweep starts (when the
    sensor's node publishes it), the IMU on a 200 Hz ``sensor_msgs/Imu`` topic over the
    same span, and the ground-truth pose at each scan's start on a
    ``nav_msgs/Odometry`` topic.  Returns the bag's bytes on disk."""
    import numpy as np

    from superodom_tpu_torch.io import rosbag as rb

    w = rb.Rosbag2Writer(path)
    lidar = LIDAR_TOPICS[kind]
    w.add_topic(lidar, "livox_ros_driver2/msg/CustomMsg" if kind == "livox"
                else "sensor_msgs/msg/PointCloud2")
    w.add_topic(IMU_TOPIC, "sensor_msgs/msg/Imu")
    w.add_topic(GT_TOPIC, "nav_msgs/msg/Odometry")
    for i, s in enumerate(ds.scans[:n]):
        w.write(lidar, int(round((s.t_start + CLOUD_DELAY_S) * 1e9)),
                bag_message(rb, kind, s))
        w.write(GT_TOPIC, int(round(s.t_start * 1e9)), rb.encode_odometry(
            rb.OdometryMsg(s.t_start, "map", "lidar", ds.gt_poses_q[i],
                           ds.gt_poses_t[i])))
    t_stop = ds.scans[n - 1].t_start + 2 * CLOUD_DELAY_S
    ident = np.array([1.0, 0.0, 0.0, 0.0])
    for k in np.flatnonzero(ds.imu.t <= t_stop):
        t = float(ds.imu.t[k])
        w.write(IMU_TOPIC, int(round(t * 1e9)), rb.encode_imu(rb.ImuMsg(
            t, "imu", ident, ds.imu.gyr[k], ds.imu.acc[k])))
    w.close()
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def bag_argv(label, path, n, device, out):
    """The CLI's arguments for a bag run: the bag's profile and
    configuration flags, its ground-truth topic, the scans, the device and
    the output directory."""
    return (["--bag", path, "--gt-topic", GT_TOPIC, "--max-scans", str(n),
             "--device", device, "--out", out] + BAG_CLI_FLAGS[label])


def stream_bag(runner, path, kind, n_lines, stop_after=None):
    """The recording's messages in recorded order, as a live node gets
    them: IMU to ``add_imu``, each cloud parsed and decoded through the
    vendor adapter into ``push_scan``, whose outputs are read back (what a
    consumer of the pose waits for).  After the last message the queue is
    drained once; with ``stop_after`` the stream ends once that many scans
    came out.  Returns (outputs with numpy leaves, host ms a cloud for
    parse and decode, ms a ``push_scan`` call with its read-back)."""
    from superodom_tpu_torch.convert import to_numpy
    from superodom_tpu_torch.io import rosbag as rb

    lidar = LIDAR_TOPICS[kind]
    outs, decode_ms, push_ms = [], [], []
    for topic, _, _, data in rb.Rosbag2Reader(path).messages(
            [lidar, IMU_TOPIC], raw=True):
        if topic == IMU_TOPIC:
            m = rb.parse_imu(data)
            runner.add_imu(m.stamp, m.linear_acceleration,
                           m.angular_velocity)
            continue
        t0 = time.perf_counter()
        pc = rb.parse_pointcloud2(data)
        raw = rb._cloud_to_rawscan(pc, kind, n_lines)
        t1 = time.perf_counter()
        outs += [to_numpy(o) for o in runner.push_scan(
            pc.stamp, raw.xyz, raw.t_rel, raw.ring)]
        push_ms.append((time.perf_counter() - t1) * 1e3)
        decode_ms.append((t1 - t0) * 1e3)
        if stop_after is not None and len(outs) >= stop_after:
            return outs, decode_ms, push_ms
    outs += [to_numpy(o) for o in runner.drain_scans()]
    return outs, decode_ms, push_ms


def cpu_recorded(bags, out_root, n_threads):
    """Phase 6's CPU plain path, in the worker process beside the card's
    runs: each bag's first CPU_SCANS scans through the CLI with
    ``--device cpu``, the Ouster bag streamed into a CPU runner until
    CPU_SCANS scans came out, and 6d's first scans through
    ``run_dataset``.  Returns {label: (poses_t, poses_q, seconds)}."""
    import dataclasses

    import numpy as np
    import torch

    from superodom_tpu_torch import cli
    from superodom_tpu_torch.config import ship_config
    from superodom_tpu_torch.runner import OdometryRunner

    torch.set_num_threads(n_threads)
    out = {}
    for label, (path, kind, _, _) in bags.items():
        t0 = time.perf_counter()
        run_dir = os.path.join(out_root, f"cpu_{label}")
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink):
            cli.main(bag_argv(label, path, CPU_SCANS, "cpu", run_dir))
        traj = np.loadtxt(os.path.join(run_dir, "trajectory.txt"))
        out[label] = (traj[:, :3], traj[:, 3:], time.perf_counter() - t0)
    path, kind, _, _ = bags["ouster"]
    t0 = time.perf_counter()
    cfg = ship_config("os1")
    outs, _, _ = stream_bag(OdometryRunner(cfg, device="cpu"), path, kind,
                            cfg.sensor.n_scan_lines, stop_after=CPU_SCANS)
    out["ouster stream"] = (np.stack([o.pose.t for o in outs]),
                            np.stack([o.pose.q for o in outs]),
                            time.perf_counter() - t0)
    ds = make_ship_dataset(cfg, N_SCANS)
    for label, overrides, n_cpu in PER_SCAN_RUNS:
        t0 = time.perf_counter()
        res = OdometryRunner(dataclasses.replace(cfg, **overrides),
                             device="cpu").run_dataset(first_scans(ds, n_cpu))
        out[label] = (res.poses_t, res.poses_q, time.perf_counter() - t0)
    return out


def agree_with_cpu(tag, poses_t, poses_q, cpu, gt_t):
    """The card's first CPU_SCANS poses against the CPU plain path's,
    within CPU_AGREE_M.  Where the CPU replayed more scans (LIO, whose
    prediction carries the smoother's state into the ICP prior: the
    smoother's float32 sums part the two devices by more than that once
    the window is full, C2 in ROADMAP.md), the card's ATE over those
    scans is also held to the CPU's by the pinning rule of
    tests/test_golden.py (<= max(1.3 x, + 1 cm)).  Returns the numbers
    compared."""
    import numpy as np

    from superodom_tpu_torch.io.datasets import ate_rmse

    c_t, c_q, secs = cpu
    n = min(len(c_t), CPU_SCANS)
    dt = float(np.abs(c_t[:n] - poses_t[:n]).max())
    dq = float(np.abs(c_q[:n] - poses_q[:n]).max())
    out = {"cpu_scans": n, "cpu_max_dt_m": dt, "cpu_max_dq": dq}
    log(f"{tag}: first {n} scans, GPU vs CPU plain path ({secs:.1f} s on "
        f"the CPU): max |dt| {dt:.3e} m, max |dq| {dq:.3e}")
    if not (dt <= CPU_AGREE_M and dq <= CPU_AGREE_M):
        raise SystemExit(f"{tag}: the GPU trajectory disagrees with the CPU "
                         "plain path")
    if len(c_t) > n:
        m = len(c_t)
        gt = np.asarray(gt_t[:m])
        out.update(cpu_whole_scans=m, cpu_ate_m=ate_rmse(c_t, gt),
                   card_ate_m=ate_rmse(poses_t[:m], gt),
                   cpu_whole_max_dt_m=float(np.abs(c_t - poses_t[:m]).max()))
        log(f"{tag}: all {m} scans, ATE card {out['card_ate_m']:.6f} m, CPU "
            f"{out['cpu_ate_m']:.6f} m, max |dt| "
            f"{out['cpu_whole_max_dt_m']:.3e} m")
        if not out["card_ate_m"] <= max(1.3 * out["cpu_ate_m"],
                                        out["cpu_ate_m"] + 0.01):
            raise SystemExit(f"{tag}: the card's ATE is not within the "
                             "pinning rule of the CPU plain path's")
    return out


class _Records(logging.Handler):
    """Collects the records of the logger it is added to."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def phase_bag_cli(label, bag, ds, out_dir, card):
    """Phase 6a / 6c: one recording through ``cli.main`` on the card.
    Gates: the sensor kind the loader guessed (none for a Livox bag, whose
    message type names it); launches equal to ``expected_launches`` of the
    run's stats.jsonl; finite poses; the report's ATE (against the bag's
    ground-truth topic) below the bar and equal to the trajectory's
    against the dataset; the report's ``ate``, ``rpe`` and
    ``stats.time_elapsed_ms``."""
    import numpy as np

    from superodom_tpu_torch import cli, kernels
    from superodom_tpu_torch.io.datasets import ate_rmse
    from superodom_tpu_torch.tools.benchmark import load_jsonl

    path, kind, n, size = bag
    tag = f"phase 6 [{label} bag, CLI]"
    run_dir = os.path.join(out_dir, f"bag_{label}")
    argv = bag_argv(label, path, n, "cuda", run_dir)
    cfg = cli.config_from_args(cli.parse_args(argv))
    records = _Records()
    logger = logging.getLogger("superodom_tpu_torch.io.rosbag")
    logger.addHandler(records)
    printed = io.StringIO()
    kernels.reset_counts()
    try:
        with contextlib.redirect_stdout(printed):
            cli.main(argv)
    finally:
        logger.removeHandler(records)
    counts = dict(kernels.launch_counts)
    line = json.loads(printed.getvalue().strip().splitlines()[-1])
    stats = load_jsonl(os.path.join(run_dir, "stats.jsonl"))
    with open(os.path.join(run_dir, "report.json")) as f:
        report = json.load(f)
    traj = np.loadtxt(os.path.join(run_dir, "trajectory.txt"))
    guessed = [r.args[0] for r in records.records
               if r.msg.startswith("guessed sensor_kind")]
    expect = expected_launches(cfg, stats)
    log(f"{tag}: guessed sensor kinds {guessed}; launches {counts}, "
        f"expected {expect}")
    if guessed != ([] if kind == "livox" else [kind]):
        raise SystemExit(f"{tag}: the loader guessed {guessed}, not {kind}")
    if counts != expect:
        raise SystemExit(f"{tag}: kernel launch counts do not match")
    if traj.shape != (n, 7) or not np.isfinite(traj).all():
        raise SystemExit(f"{tag}: {traj.shape} poses, or a non-finite one")
    missing = [k for k in ("ate", "rpe") if k not in report]
    if missing or "time_elapsed_ms" not in report["stats"]:
        raise SystemExit(f"{tag}: report.json lacks {missing or 'stats'}")
    ate = report["ate"]["rmse_m"]
    ate_ds = ate_rmse(traj[:, :3], np.asarray(ds.gt_poses_t[:n]))
    times = np.asarray([st["time_elapsed_ms"] for st in stats])
    summary = {
        "bag": label, "sensor_kind": kind, "scans": n,
        "points_per_scan": cfg.sensor.max_points,
        "bag_mib": size / 2 ** 20, "flags": BAG_CLI_FLAGS[label],
        "icp_rounds": sum(st["n_iterations"] for st in stats),
        "launches": counts,
        "read_decode_ms_per_scan": line["load_seconds"] / n * 1e3,
        "scans_per_sec": line["scans_per_sec"],
        "p50_step_ms": float(np.percentile(times, 50)),
        "p90_step_ms": float(np.percentile(times, 90)),
        "ate_m": ate, "ate_vs_dataset_m": ate_ds,
        "rpe_rmse_m": report["rpe"]["rpe_rmse_m"],
    }
    log(f"{tag} ({card}): " + json.dumps(summary))
    if not ate < ATE_BAR_M or abs(ate - ate_ds) > 1e-6:
        raise SystemExit(f"{tag}: ATE {ate:.4f} m (against the dataset "
                         f"{ate_ds:.4f} m), bar {ATE_BAR_M} m")
    return summary, traj


def phase_stream(bag, ds, out_dir, card):
    """Phase 6b: the Ouster recording as a live stream into
    ``OdometryRunner(ship_config("os1"), device="cuda").push_scan``.
    Gates: every scan processed, none skipped or shed, none left queued;
    launches equal to ``expected_launches``; finite poses; the ATE below
    the bar."""
    import numpy as np

    from superodom_tpu_torch import kernels
    from superodom_tpu_torch.config import ship_config
    from superodom_tpu_torch.io.datasets import ate_rmse
    from superodom_tpu_torch.runner import OdometryRunner

    path, kind, n, _ = bag
    tag = "phase 6 [ouster stream, push_scan]"
    cfg = ship_config("os1")
    runner = OdometryRunner(cfg, device="cuda")
    kernels.reset_counts()
    outs, decode_ms, push_ms = stream_bag(runner, path, kind,
                                          cfg.sensor.n_scan_lines)
    counts = dict(kernels.launch_counts)
    stats = [runner._stats_record(o, i) for i, o in enumerate(outs)]
    expect = expected_launches(cfg, stats)
    log(f"{tag}: {len(outs)} outputs, skipped {runner.frames_skipped}, "
        f"shed {runner.frames_shed}, queued {len(runner._scan_queue)}; "
        f"launches {counts}, expected {expect}")
    if (len(outs), runner.frames_skipped, runner.frames_shed,
            len(runner._scan_queue)) != (n, 0, 0, 0):
        raise SystemExit(f"{tag}: not every scan was processed")
    if counts != expect:
        raise SystemExit(f"{tag}: kernel launch counts do not match")
    poses_t = np.stack([o.pose.t for o in outs])
    poses_q = np.stack([o.pose.q for o in outs])
    if not (np.isfinite(poses_t).all() and np.isfinite(poses_q).all()):
        raise SystemExit(f"{tag}: non-finite pose")
    ate = ate_rmse(poses_t, np.asarray(ds.gt_poses_t[:n]))
    with open(os.path.join(out_dir, "stats_ouster_stream.jsonl"), "w") as f:
        for rec in stats:
            f.write(json.dumps(rec) + "\n")
    summary = {
        "scans": n, "ate_m": ate,
        "icp_rounds": sum(st["n_iterations"] for st in stats),
        "launches": counts,
        "decode_ms_p50": float(np.percentile(decode_ms, 50)),
        "push_scan_ms_p50": float(np.percentile(push_ms, 50)),
        "push_scan_ms_p90": float(np.percentile(push_ms, 90)),
        "push_scan_ms_max": float(np.max(push_ms)),
        "scans_per_sec": n / (sum(push_ms) + sum(decode_ms)) * 1e3,
    }
    log(f"{tag} ({card}): " + json.dumps(summary))
    if not ate < ATE_BAR_M:
        raise SystemExit(f"{tag}: ATE {ate:.4f} m is not below {ATE_BAR_M} m")
    return summary, poses_t, poses_q


def phase_recorded(pool, datasets, torch, out_dir, card):
    """Phase 6: recorded sensors on the card.  The recordings are written
    into a temporary directory (removed on the way out); every run is
    held against the CPU plain path's, computed meanwhile in the worker
    process (``cpu_recorded``).  6a the Ouster bag through the CLI, 6b
    the same bag as a live stream, 6c the Livox and VLP-16 bags through
    the CLI, 6d the ship path with edges and with LIO prediction, per
    scan.  ``datasets``: {sensor kind: dataset}."""
    import dataclasses
    import shutil
    import tempfile

    from superodom_tpu_torch.config import ship_config
    from superodom_tpu_torch.pipeline import PRED_LIO_ODOM

    root = tempfile.mkdtemp(prefix="chip_smoke_bags_")
    try:
        bags = {}
        for label, kind, n in BAG_RUNS:
            t0 = time.perf_counter()
            path = os.path.join(root, label)
            size = write_bag(path, kind, datasets[kind], n)
            bags[label] = (path, kind, n, size)
            log(f"phase 6: wrote the {label} bag ({n} scans, "
                f"{size / 2 ** 20:.1f} MiB) in "
                f"{time.perf_counter() - t0:.1f} s")
        cpu_async = pool.apply_async(cpu_recorded, (bags, out_dir,
                                                    CPU_WORKER_THREADS))
        out, card_runs = {}, {}
        for label, (path, kind, n, size) in bags.items():
            out[label], traj = phase_bag_cli(label, bags[label],
                                             datasets[kind], out_dir, card)
            card_runs[label] = (traj[:, :3], traj[:, 3:])
        out["ouster stream"], *card_runs["ouster stream"] = phase_stream(
            bags["ouster"], datasets["ouster"], out_dir, card)
        for label, overrides, _ in PER_SCAN_RUNS:
            cfg = dataclasses.replace(ship_config("os1"), **overrides)
            res, _, summary = phase_main(
                label, cfg, first_scans(datasets["ouster"], BAG_SCANS),
                torch, "cuda", out_dir, card, phase="6")
            sources = [st["pred_source"] for st in res.stats]
            summary["pred_sources"] = {str(k): sources.count(k)
                                       for k in sorted(set(sources))}
            out[label] = summary
            card_runs[label] = (res.poses_t, res.poses_q)
            if (overrides.get("enable_lio_prediction")
                    and PRED_LIO_ODOM not in sources):
                raise SystemExit(f"phase 6 [{label}]: no scan took the LIO "
                                 f"prediction: {summary['pred_sources']}")
        t0 = time.perf_counter()
        cpu = cpu_async.get(timeout=CPU_WORKER_TIMEOUT_S)
        log(f"phase 6: waited {time.perf_counter() - t0:.1f} s for the CPU "
            "plain path's runs")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for label, (poses_t, poses_q) in card_runs.items():
        kind = bags[label][1] if label in bags else "ouster"
        out[label].update(agree_with_cpu(f"phase 6 [{label}]", poses_t,
                                         poses_q, cpu[label],
                                         datasets[kind].gt_poses_t))
    return out


def same(a, b):
    """Equal to the bit, NaN where NaN."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | ((a != a) & (b != b))).all())


def batched_instances(cfg, datasets, n_inst, torch, dev):
    """Phase 7a's ``n_inst`` instances: for each dataset its warm map (the
    surface features of its first BATCH_MAP_SCANS scans inserted at the
    true poses); instance j takes dataset j % len(datasets) and, for its
    next scan, every kernel's single-instance inputs at a pose perturbed
    its own way, the scan's points moved by a few centimetres for each
    earlier copy of the same dataset, so that no two instances share
    their inputs.  Returns per instance (name -> kernel_ops arguments) and
    (name -> (bytes, operations))."""
    import dataclasses

    from superodom_tpu_torch import frontend, kernels, mapstate, registration
    from superodom_tpu_torch.geometry import Pose, quat_mul, so3_exp
    from superodom_tpu_torch.runner import OdometryRunner

    sensor, reg = cfg.sensor, cfg.registration
    res = torch.full((), sensor.default_plane_res, device=dev)
    line_res = torch.full((), sensor.default_line_res, device=dev)
    shaper = OdometryRunner(cfg, device=dev)
    full = OdometryRunner(dataclasses.replace(cfg, use_edge_features=True),
                          device=dev)
    k, W, C = reg.plane_knn, BATCH_W, cfg.map.cell_capacity
    bits = max((sensor.max_points * 4 - 1).bit_length(), 4)
    def gt(ds, i):
        return Pose(torch.tensor(ds.gt_poses_q[i], device=dev),
                    torch.tensor(ds.gt_poses_t[i], device=dev))

    maps = []
    for ds in datasets:
        m = mapstate.empty_map(cfg.map, device=dev)
        for i in range(BATCH_MAP_SCANS):
            pts, mask = surface_features(shaper, ds.scans[i], res)
            m = mapstate.insert(m, cfg.map, gt(ds, i).apply(pts), mask, res)
        maps.append(m)
    # K12a's inputs: each dataset's last smoother systems of a per-scan
    # replay (a full window)
    smooth = [{name: tuple(x.contiguous() for x in per[-1])
               for name, per in smoother_calls(
                   cfg, ds, SMOOTHER_SCANS, dev).items()}
              for ds in datasets]
    out = []
    for inst in range(n_inst):
        j, copy = inst % len(datasets), inst // len(datasets)
        ds, m = datasets[j], maps[j]
        s = ds.scans[BATCH_MAP_SCANS]
        pts, mask = surface_features(shaper, s, res)
        g = gt(ds, BATCH_MAP_SCANS)
        pose = Pose(quat_mul(so3_exp(
            torch.tensor([0.004, -0.003, 0.01], device=dev) * (1 + j)
            + torch.tensor([7e-4, 5e-4, -6e-4], device=dev) * copy), g.q),
            g.t + torch.tensor([0.03, -0.02, 0.01], device=dev) * (1 - j / 2)
            + torch.tensor([4e-3, -3e-3, 2e-3], device=dev) * copy)
        shift = torch.tensor([0.013, -0.007, 0.004], device=dev) * copy
        q, t = pose.q.contiguous(), pose.t.contiguous()
        w_pt = pose.apply(pts).contiguous()
        nq = w_pt.shape[0]
        slots = kernels.octant_lookup(m.keys, w_pt, cfg.map.cell_size)
        neigh, sq, nvalid, _ = kernels.knn_select(m.pts, slots, w_pt, k)
        red = kernels.reduce_candidates(m.pts, slots, w_pt, W, k)[:4]
        moved = (w_pt + torch.tensor([0.01, -0.01, 0.005],
                                     device=dev)).contiguous()
        fit = kernels.plane_fit(neigh, sq, nvalid, mask, w_pt, q, res)
        a_sq = (3.0 * res).contiguous()
        prior = (g.q, g.t, torch.tensor([40.0, 50.0, 60.0, 10.0, 10.0, 0.0],
                                        device=dev),
                 torch.tensor(j % 2 == 1, device=dev))
        hold = torch.tensor(True, device=dev)
        scan = shaper.make_scan(s.t_start, s.xyz_body, s.t_rel)
        gate = frontend.uniform_feature_gates(
            scan.xyz, None, scan.mask, sensor.min_range, sensor.max_range,
            skip_dup=True).contiguous()
        fs = full.make_scan(s.t_start, s.xyz_body, s.t_rel)
        ne = min(EDGE_Q, nq)
        e_neigh, e_sq, e_nv, _ = kernels.knn_select(
            m.pts, slots[:ne].contiguous(), w_pt[:ne].contiguous(),
            reg.edge_knn)
        nw, n_full = scan.xyz.shape[0], fs.xyz.shape[0]
        nb, Bk = m.keys.shape
        touched = torch.unique(mapstate._bucket_of(mapstate.octant_cells(
            w_pt, cfg.map.cell_size).reshape(-1), nb)).numel()
        live = torch.unique(slots[slots >= 0]).numel()
        found = int((slots >= 0).sum())
        n_it = reg.max_gn_iters
        args = {
            "octant_lookup": (m.keys, w_pt, float(cfg.map.cell_size)),
            "knn_select": (m.pts, slots, w_pt, k),
            "reduce_candidates": (m.pts, slots, w_pt, W, k),
            "select_reduced": (*red, moved, k),
            "plane_fit": (neigh, sq, nvalid, mask, w_pt, q, res),
            "normal_system": (pts, *fit[:4], q, t, a_sq) + (None,) * 6,
            "gn_solve": (pts, *fit[:4], fit[5], q, t, a_sq, n_it, 1e-4,
                         *prior, reg.axis_hold_min_matches,
                         reg.axis_hold_frac, hold) + (None,) * 6,
            "voxel_claim": ((scan.xyz + shift).contiguous(), gate, res,
                            bits),
            "curvature_edges": ((fs.xyz + shift).contiguous(),
                                fs.ring.contiguous(),
                                fs.mask.contiguous(), 5,
                                float(cfg.edge_curvature_threshold),
                                float(sensor.min_range)),
            "edge_fit": (e_neigh, e_sq, e_nv, mask[:ne].contiguous(),
                         line_res, reg.min_edge_neighbors,
                         float(reg.edge_max_dist_inlier)),
            **{name: (a[0] * (1.0 + 1e-3 * copy),) + a[1:]
               for name, a in smooth[j].items()},
        }
        # the bytes each launch must move and its operations, as phase 1
        # counts them for one instance
        work = {
            "octant_lookup": (nq * 12 + touched * Bk * 4 + nq * 32,
                              nq * (12 + 8 * (15 + Bk))),
            "knn_select": (nq * 44 + live * 3 * C * 4 + nq * k * 25,
                           found * C * 8),
            "reduce_candidates": (nq * 44 + live * 3 * C * 4 + nq * W * 13
                                  + nq * k * 17, found * C * 8),
            "select_reduced": (nq * W * 13 + nq * 12 + nq * k * 17,
                               nq * W * 8),
            "plane_fit": (nq * k * 17 + nq * 13 + 20 + nq * 37, nq * 450),
            "normal_system": (nq * 33 + 32 + 43 * 4, nq * 124),
            "gn_solve": (nq * 37 + 32 + 53 + 29, n_it * (nq * 124 + 600)),
            "voxel_claim": (nw * 14 + 4, nw * 46),
            "curvature_edges": (n_full * 18, n_full * 80),
            "edge_fit": (ne * reg.edge_knn * 17 + ne * 34 + 4, ne * 1500),
            # the bias map is one copy for the fleet
            **{name: smoother_work(name, cfg.imu.window_size, inst == 0)
               for name in smooth[j]},
        }
        out.append((args, work))
    torch.cuda.synchronize()
    return out


def stack_instances(per, idx, torch):
    """Arguments of instances ``idx`` (one kernel_ops argument tuple each)
    stacked on a leading instance dimension, and vmap's in_dims."""
    first = per[idx[0]]
    args = tuple(torch.stack([per[i][a] for i in idx]).contiguous()
                 if isinstance(x, torch.Tensor) else x
                 for a, x in enumerate(first))
    dims = tuple(0 if isinstance(x, torch.Tensor) else None for x in first)
    return args, dims


def phase_batched_kernels(cfg, datasets, torch, dev, card):
    """Phase 7a: every kernel entry for B instances at once (four
    datasets, four warm maps, B distinct poses and scans) through vmap of
    its custom operator, against each instance's single launch, bit for
    bit, at every fleet size; one shared table (stride 0) against single
    launches on it; repeat runs; and the device time of one batched
    launch at every fleet size."""
    from superodom_tpu_torch import kernel_ops, kernels
    from superodom_tpu_torch.utils import device_ms

    t0 = time.perf_counter()
    inst = batched_instances(cfg, datasets, max(BATCH_SIZES), torch, dev)
    log(f"phase 7a: {len(inst)} instances' warm maps and inputs in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for name in kernels.KERNELS:
        op = getattr(kernel_ops, name)
        per = [a[name] for a, _ in inst]
        sizes = BATCH_SIZES
        if name in ("smoother_gn_step", "smoother_marginalize"):
            # the benchmark's fleet: the instances' inputs in turn, each
            # further copy's first tensor scaled its own way
            sizes = BATCH_SIZES + (K12A_FLEET,)
            n0 = len(inst)
            per += [(per[i % n0][0] * (1.0 + 1e-4 * (i // n0)),)
                    + per[i % n0][1:] for i in range(n0, K12A_FLEET)]
        single = [op(*a) for a in per]
        single = [s if isinstance(s, tuple) else (s,) for s in single]
        checks = {}
        for B in sizes:
            idx = list(range(B))
            args, dims = stack_instances(per, idx, torch)
            kernels.reset_counts()
            got = torch.func.vmap(op, in_dims=dims)(*args)
            launches = kernels.launch_counts[name]
            got = got if isinstance(got, tuple) else (got,)
            ok = all(same(g[b], s) for b, i in enumerate(idx)
                     for g, s in zip(got, single[i]))
            if B == 4:
                again = torch.func.vmap(op, in_dims=dims)(*args)
                again = again if isinstance(again, tuple) else (again,)
                ok = ok and all(torch.equal(a, b) for a, b in zip(got, again))
            checks[B] = ok and launches == 1
            ms = device_ms(lambda: torch.func.vmap(op, in_dims=dims)(*args))
            nbytes = sum(inst[i % len(inst)][1][name][0] for i in idx)
            ops = sum(inst[i % len(inst)][1][name][1] for i in idx)
            b_ms, b_by = bound(nbytes, ops)
            out.setdefault(name, {})[B] = dict(
                ms=ms, us_per_instance=ms * 1e3 / B, bound_ms=b_ms,
                bound_by=b_by, launches=launches)
            del args, got
        if name in ("octant_lookup", "knn_select", "plane_fit"):
            # the first argument (the table, or the neighbourhoods)
            # unbatched: the rule shares it with a stride of 0
            four = per[:4]
            shared = tuple(x if i == 0 or not isinstance(x, torch.Tensor)
                           else torch.stack([p[i] for p in four]).contiguous()
                           for i, x in enumerate(four[0]))
            dims = tuple(0 if isinstance(x, torch.Tensor) and i > 0 else None
                         for i, x in enumerate(four[0]))
            got = torch.func.vmap(op, in_dims=dims)(*shared)
            got = got if isinstance(got, tuple) else (got,)
            ref = [op(four[0][0], *p[1:]) for p in four]
            ref = [r if isinstance(r, tuple) else (r,) for r in ref]
            checks["shared"] = all(same(g[b], r) for b in range(4)
                                   for g, r in zip(got, ref[b]))
        torch.cuda.synchronize()
        line = ", ".join(f"B={B} {r['ms'] * 1e3:.2f} us "
                         f"({r['us_per_instance']:.2f} us an instance, "
                         f"bound {r['bound_ms'] * 1e3:.3f} us, "
                         f"{r['launches']} launch(es))"
                         for B, r in out[name].items())
        log(f"phase 7a [{name}, {kernel_ops.ROUTE[name]}] ({card}): "
            f"bit-identical per instance {checks}; {line}")
        if not all(checks.values()):
            raise SystemExit(f"phase 7a: {name} batched disagrees with its "
                             f"single launches")
    return out, inst[0][0]["octant_lookup"]


def replay_fleet(cfg, fleet, torch, dev, tag, card, mesh=None,
                 keep_state=False):
    """One batched replay (``parallel.replay_batched``; with a mesh of one
    rank, its maps split over the rank's shard devices) with the launch
    counts reset just before and read just after, its peak memory, and
    each instance's ATE.  The fleet's final state is kept (copied to the
    host, so that it holds no device memory) only with ``keep_state``."""
    import numpy as np

    from superodom_tpu_torch import kernels
    from superodom_tpu_torch.io.datasets import ate_rmse
    from superodom_tpu_torch.parallel import replay_batched
    from superodom_tpu_torch.pipeline import tree_map

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    res = replay_batched(cfg, fleet, BATCH_CHUNK, dev, mesh=mesh)
    counts = dict(kernels.launch_counts)
    res.state = (tree_map(lambda x: x.cpu(), res.state) if keep_state
                 else None)
    step_ms = np.asarray(res.chunk_ms) / BATCH_CHUNK
    ates = [ate_rmse(res.poses_t[:, b], ds.gt_poses_t)
            for b, ds in enumerate(fleet)]
    summary = {
        "batch": len(fleet), "scans": len(fleet[0].scans),
        "chunk": BATCH_CHUNK,
        "aggregate_scans_per_sec": res.aggregate_scans_per_sec,
        "p50_step_ms": float(np.percentile(step_ms, 50)),
        "p90_step_ms": float(np.percentile(step_ms, 90)),
        "peak_mem_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
        "ate_m": ates, "launches": counts}
    log(f"{tag} ({card}): " + json.dumps(
        {k: v for k, v in summary.items() if k != "ate_m"})
        + f", ATE per instance max {max(ates):.6f} m min {min(ates):.6f} m")
    poses = np.concatenate([res.poses_t, res.poses_q], axis=-1)
    if not np.isfinite(poses).all():
        raise SystemExit(f"{tag}: non-finite poses")
    if not max(ates) < ATE_BAR_M:
        raise SystemExit(f"{tag}: an instance's ATE {max(ates):.4f} m is "
                         f"not below {ATE_BAR_M} m")
    return res, summary


def hold_fleet(tag, res, singles, counts, single_counts):
    """Each instance's poses within BATCH_AGREE_M of its single-instance
    replay (``singles[b]``), scan by scan; every kernel launched as often
    as at B = 1."""
    import numpy as np

    dt = max(float(np.abs(res.poses_t[:, b] - s.poses_t[:, 0]).max())
             for b, s in enumerate(singles))
    dq = max(float(np.abs(res.poses_q[:, b] - s.poses_q[:, 0]).max())
             for b, s in enumerate(singles))
    log(f"{tag}: each instance against its single replay: max |dt| "
        f"{dt:.3e} m, max |dq| {dq:.3e}; launches {counts}, expected "
        f"{single_counts}")
    if not (dt <= BATCH_AGREE_M and dq <= BATCH_AGREE_M):
        raise SystemExit(f"{tag}: an instance disagrees with its single "
                         f"replay")
    if counts != single_counts:
        raise SystemExit(f"{tag}: the batched launches are not the single "
                         f"replay's")
    return {"max_dt_m": dt, "max_dq": dq}


def phase_batched(cfg, torch, dev, card):
    """Phase 7: many instances on one card (``parallel.replay_batched``,
    the counterpart of the JAX package's bench_batch)."""
    import dataclasses

    import numpy as np

    from superodom_tpu_torch.config import parity_config, ship_config
    from superodom_tpu_torch.runner import OdometryRunner

    t0 = time.perf_counter()
    whole = [make_ship_dataset(cfg, BATCH_DATA_SCANS, seed)
             for seed in BATCH_SEEDS]
    log(f"phase 7: datasets of seeds {BATCH_SEEDS} in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    out["kernels"], k1_args = phase_batched_kernels(cfg, whole, torch, dev,
                                                    card)
    data = [first_scans(d, BATCH_SCANS) for d in whole]

    # 7b: four instances on four datasets against each one's B = 1 replay
    singles = [replay_fleet(cfg, [d], torch, dev,
                            f"phase 7b [B=1, seed {s}]", card)
               for s, d in zip(BATCH_SEEDS, data)]
    counts1 = singles[0][1]["launches"]
    if any(s[1]["launches"] != counts1 for s in singles):
        raise SystemExit("phase 7b: the single replays launch differently")
    res4, sum4 = replay_fleet(cfg, data, torch, dev, "phase 7b [B=4]",
                              card, keep_state=True)
    out["b4_vs_single"] = hold_fleet("phase 7b [B=4]", res4,
                                     [s[0] for s in singles],
                                     sum4["launches"], counts1)
    fleets = {1: singles[0][1], 4: sum4}
    # 7c: scaling, the instances taking the four datasets in turn, each
    # held against its dataset's B = 1 replay
    for B in BATCH_SIZES:
        if B not in fleets:
            tag = f"phase 7c [B={B}]"
            res, fleets[B] = replay_fleet(
                cfg, [data[b % 4] for b in range(B)], torch, dev, tag, card)
            out[f"b{B}_vs_single"] = hold_fleet(
                tag, res, [singles[b % 4][0] for b in range(B)],
                fleets[B]["launches"], counts1)
            del res
    # one instance without vmap, the same fixed-count rounds and chunks
    fixed = dataclasses.replace(cfg, registration=dataclasses.replace(
        cfg.registration, icp_early_exit=False))
    r = OdometryRunner(fixed, device=dev).run_dataset_chunked(
        data[0], chunk=BATCH_CHUNK, time_chunks=True)
    times = np.asarray([s["time_elapsed_ms"] for s in r.stats])
    d_unb = float(np.abs(r.poses_t - singles[0][0].poses_t[:, 0]).max())
    dq_unb = float(np.abs(r.poses_q - singles[0][0].poses_q[:, 0]).max())
    out["unbatched_b1"] = {"scans_per_sec": r.scans_per_sec,
                           "p50_step_ms": float(np.percentile(times, 50)),
                           "p90_step_ms": float(np.percentile(times, 90)),
                           "max_dt_vs_vmap_b1_m": d_unb,
                           "max_dq_vs_vmap_b1": dq_unb}
    if not (d_unb <= BATCH_AGREE_M and dq_unb <= BATCH_AGREE_M):
        raise SystemExit(f"phase 7c: the replay without vmap is {d_unb:.3e} "
                         f"m / {dq_unb:.3e} from B = 1 through vmap")
    log(f"phase 7c ({card}): " + "; ".join(
        f"B={B} {f['aggregate_scans_per_sec']:.3f} scans/s, p50 / p90 "
        f"{f['p50_step_ms']:.1f} / {f['p90_step_ms']:.1f} ms, peak "
        f"{f['peak_mem_mb']:.0f} MB" for B, f in sorted(fleets.items()))
        + f" | one instance without vmap (run_dataset_chunked, fixed count, "
        f"chunk {BATCH_CHUNK}): {r.scans_per_sec:.3f} scans/s, p50 / p90 "
        f"{out['unbatched_b1']['p50_step_ms']:.1f} / "
        f"{out['unbatched_b1']['p90_step_ms']:.1f} ms, poses within "
        f"{d_unb:.3e} m / {dq_unb:.3e} of B=1 through vmap")
    out["fleets"] = {B: {k: v for k, v in f.items()}
                     for B, f in sorted(fleets.items())}

    # what phase 8 holds its mesh runs against
    keep = {"data": data, "singles": [sg[0] for sg in singles], "b4": res4,
            "b4_launches": sum4["launches"], "k1_args": k1_args}
    # 7d: the other kernels under batching, two instances on two datasets
    edges = dataclasses.replace(parity_config("os1"), use_edge_features=True)
    vlp = ship_config("vlp16")
    for name, c in (("vlp16", vlp), ("edges", edges)):
        pair = [make_ship_dataset(c, BATCH_PATH_SCANS, seed)
                for seed in BATCH_SEEDS[:2]]
        one = [replay_fleet(c, [d], torch, dev, f"phase 7d [{name}, B=1, "
                            f"seed {s}]", card)
               for s, d in zip(BATCH_SEEDS, pair)]
        res2, sum2 = replay_fleet(c, pair, torch, dev,
                                  f"phase 7d [{name}, B=2]", card,
                                  keep_state=name == "edges")
        out[f"{name}_b2"] = dict(sum2, **hold_fleet(
            f"phase 7d [{name}, B=2]", res2, [o[0] for o in one],
            sum2["launches"], one[0][1]["launches"]))
        if name == "edges" and not all(
                s["edge_stack"] > 0 for st in res2.stats for s in st):
            raise SystemExit("phase 7d: a scan of path E extracted no edge")
        if name == "edges":
            keep.update(e_cfg=c, e_pair=pair, e_b2=res2,
                        e_launches=sum2["launches"])
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 7: {out['seconds']:.1f} s")
    return out, keep


def same_maps(a, b, torch):
    """Both maps of two states (either form, on the host) equal to the
    bit, whole."""
    from superodom_tpu_torch.pipeline import unshard_state

    a, b = unshard_state(a), unshard_state(b)
    return all(torch.equal(getattr(getattr(a, m), f),
                           getattr(getattr(b, m), f))
               for m in ("surf_map", "edge_map") for f in ("keys", "pts",
                                                           "cnt"))


def phase_k1_window(k1_args, torch, card):
    """Phase 8a: K1 with a shard window on phase 7a's first instance (a
    warm ship map, 512 buckets of 128, and its 2,048 queries), the table
    cut into M windows: each window's launch bit for bit its windowed
    plain version, and merged by a maximum the whole table's K1 and plain
    lookup.  Device time and bound of one window's launch (shard 0)."""
    import functools

    from superodom_tpu_torch import kernels, mapstate
    from superodom_tpu_torch.utils import device_ms

    keys, q, cs = k1_args
    nb, B = keys.shape
    nq = q.shape[0]
    whole_k = kernels.octant_lookup(keys, q, cs)
    whole_r = mapstate.octant_lookup_reference(keys, q, cs)
    buckets = mapstate._bucket_of(mapstate.octant_cells(q, cs).reshape(-1),
                                  nb)
    out = {}
    for M in MESH_SHARDS:
        nbl = nb // M
        shards = [keys[j * nbl:(j + 1) * nbl].contiguous() for j in range(M)]
        got_k = [kernels.octant_lookup(sh, q, cs, j * nbl, nb)
                 for j, sh in enumerate(shards)]
        got_r = [mapstate.octant_lookup_reference(sh, q, cs, j * nbl, nb)
                 for j, sh in enumerate(shards)]
        torch.cuda.synchronize()
        merged = functools.reduce(torch.maximum, got_k)
        ok = (all(torch.equal(a, b) for a, b in zip(got_k, got_r))
              and torch.equal(merged, whole_k)
              and torch.equal(merged, whole_r))
        inside = buckets < nbl  # shard 0's window
        n_in = int(inside.sum())
        touched = torch.unique(buckets[inside]).numel()
        out[M] = dict(
            err=float((merged - whole_r).abs().max()),
            ms=device_ms(lambda: kernels.octant_lookup(
                shards[0], q, cs, 0, nb)),
            plain_ms=device_ms(lambda: mapstate.octant_lookup_reference(
                shards[0], q, cs, 0, nb)),
            # queries, the window's touched rows, the slot ids; the cell
            # arithmetic, and the hash of every probe and B compares of
            # the probes inside the window
            bound=bound(nq * 12 + touched * B * 4 + nq * 32,
                        nq * 12 + n_in * (15 + B) + (8 * nq - n_in) * 15),
            probes_inside=n_in)
        log(f"phase 8a [K1, M={M}] ({card}): each window bit-identical to "
            f"its plain version and merged to the whole table's: {ok}; "
            f"shard 0: {out[M]['ms'] * 1e3:.2f} us (plain "
            f"{out[M]['plain_ms'] * 1e3:.2f} us, bound "
            f"{out[M]['bound'][0] * 1e3:.4f} us {out[M]['bound'][1]}), "
            f"{n_in} of {8 * nq} probes inside; the whole table "
            f"{int((whole_r >= 0).sum())} slots found")
        if not ok:
            raise SystemExit(f"phase 8a: K1 with a shard window (M={M}) "
                             f"disagrees")
    return out


def hold_exact(tag, res, singles, fleet, data):
    """Each instance's poses equal, to the bit, the first scans of its
    dataset's B = 1 replay (``singles[j]`` for ``fleet[b] is data[j]``):
    a replay of a dataset's first scans gives that replay's first poses."""
    import numpy as np

    n = res.poses_t.shape[0]
    which = [next(j for j, d in enumerate(data) if d is ds) for ds in fleet]
    ok = all(np.array_equal(res.poses_t[:, b], singles[j].poses_t[:n, 0])
             and np.array_equal(res.poses_q[:, b],
                                singles[j].poses_q[:n, 0])
             for b, j in enumerate(which))
    log(f"{tag}: every instance's poses equal its single replay's: {ok}")
    if not ok:
        raise SystemExit(f"{tag}: an instance differs from its single "
                         f"replay")


def phase_mesh(cfg, keep, torch, dev, card):
    """Phase 8: the fleet over a mesh on the one card
    (``parallel.make_mesh``).  8a: K1 with a shard window.  8b: the maps
    split in M shards (``replay_batched`` with a one-rank mesh): phase
    7b's B = 4 ship fleet at M = 2 and 4 and phase 7d's path E pair at
    M = 2, poses and final maps equal to the unsplit runs' to the bit,
    K1 launched M times as often and every other kernel as often.  8c:
    MESH_RANKS rank processes (``replay_mesh``) at B = MESH_BATCH over
    phase 7b's datasets, with unsplit maps and with M = 2, and the same
    fleet in one process: each instance's poses equal its phase-7b single
    replay's."""
    import numpy as np

    from superodom_tpu_torch.io.datasets import ate_rmse
    from superodom_tpu_torch.parallel import make_mesh, replay_mesh

    t0 = time.perf_counter()
    out = {"k1_window": phase_k1_window(keep["k1_args"], torch, card)}
    data, singles = keep["data"], keep["singles"]
    runs = ((cfg, data, keep["b4"], keep["b4_launches"], "B=4", MESH_SHARDS),
            (keep["e_cfg"], keep["e_pair"], keep["e_b2"],
             keep["e_launches"], "E, B=2", (2,)))
    for c, fleet, whole, counts, label, shard_counts in runs:
        for M in shard_counts:
            tag = f"phase 8b [{label}, M={M}]"
            res, summary = replay_fleet(c, fleet, torch, dev, tag, card,
                                        mesh=make_mesh([dev], 1, M),
                                        keep_state=True)
            poses = (np.array_equal(res.poses_t, whole.poses_t)
                     and np.array_equal(res.poses_q, whole.poses_q))
            maps = same_maps(res.state, whole.state, torch)
            want = {k: v * (M if k == "octant_lookup" else 1)
                    for k, v in counts.items()}
            log(f"{tag}: poses equal the unsplit fleet's {poses}, final "
                f"maps (whole) equal {maps}; launches {summary['launches']}"
                f", expected {want}")
            if not (poses and maps and summary["launches"] == want):
                raise SystemExit(f"{tag}: the split fleet differs from the "
                                 f"unsplit one")
            out[f"{label} M={M}"] = summary
            del res

    # 8c: rank processes, B = MESH_BATCH, the instances taking the four
    # datasets in turn; the same fleet in this process first
    fleet = [data[b % len(data)] for b in range(MESH_BATCH)]
    res, out["one process"] = replay_fleet(
        cfg, fleet, torch, dev, f"phase 8c [B={MESH_BATCH}, one process]",
        card)
    hold_exact(f"phase 8c [B={MESH_BATCH}, one process]", res, singles,
               fleet, data)
    del res
    for model in (1, 2):
        tag = f"phase 8c [B={MESH_BATCH}, data={MESH_RANKS}, model={model}]"
        mesh = make_mesh([dev], MESH_RANKS, model)
        log(f"{tag}: placement " + "; ".join(
            f"rank {p['rank']} on {', '.join(p['shards'])}"
            for p in mesh.placement())
            + f" ({torch.cuda.device_count()} card(s): ranks and shards "
            f"share them)")
        res = replay_mesh(cfg, fleet, mesh, BATCH_CHUNK)
        hold_exact(tag, res, singles, fleet, data)
        # a rank's fleet launches as the one-process fleet of the same
        # scans does (the ship path's kernels launch once a step whatever
        # B), K1 once a shard
        want = {k: v * (model if k == "octant_lookup" else 1)
                for k, v in out["one process"]["launches"].items()}
        step_ms = np.asarray(res.chunk_ms) / BATCH_CHUNK
        ates = [ate_rmse(res.poses_t[:, b], ds.gt_poses_t)
                for b, ds in enumerate(fleet)]
        summary = {
            "batch": MESH_BATCH, "data": MESH_RANKS, "model": model,
            "aggregate_scans_per_sec": res.aggregate_scans_per_sec,
            "p50_step_ms": float(np.percentile(step_ms, 50)),
            "p90_step_ms": float(np.percentile(step_ms, 90)),
            "ate_m": ates, "ranks": res.ranks}
        log(f"{tag} ({card}): {res.aggregate_scans_per_sec:.3f} scans/s "
            f"aggregate (one process at B={MESH_BATCH}: "
            f"{out['one process']['aggregate_scans_per_sec']:.3f}), p50 / "
            f"p90 {summary['p50_step_ms']:.1f} / "
            f"{summary['p90_step_ms']:.1f} ms; ranks: " + "; ".join(
                f"rank {r['rank']} ({r['instances']} instances, shards on "
                f"{', '.join(r['shards'])}): {r['scans_per_sec']:.3f} "
                f"scans/s, peak {r['peak_mem_mb']:.0f} MB"
                for r in res.ranks)
            + f"; ATE per instance max {max(ates):.6f} m")
        if any(r["launches"] != want for r in res.ranks):
            raise SystemExit(f"{tag}: a rank's launches "
                             f"{[r['launches'] for r in res.ranks]} are not "
                             f"the one-process fleet's {want}")
        if not max(ates) < ATE_BAR_M:
            raise SystemExit(f"{tag}: an instance's ATE {max(ates):.4f} m "
                             f"is not below {ATE_BAR_M} m")
        out[f"data={MESH_RANKS} model={model}"] = summary
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 8: {out['seconds']:.1f} s")
    return out


def measured(r):
    """The kernels line's measured fields of one phase-1 result."""
    return {"max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1]}


def main(argv=None):
    t_start = time.perf_counter()
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
    seconds, t_phase = {}, [t_start]

    def phase_done(label):
        """Log the wall seconds since the last phase ended."""
        now = time.perf_counter()
        seconds[label] = now - t_phase[0]
        t_phase[0] = now
        log(f"phase {label}: {seconds[label]:.1f} s")

    # phase 0: the card and the build
    smi = nvidia_smi_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    import dataclasses

    from superodom_tpu_torch import kernel_ops, kernels
    from superodom_tpu_torch.config import parity_config, ship_config
    from superodom_tpu_torch.utils import device_ms

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
                           "gn_solve", "normal_system", "smoother_gn_step",
                           "smoother_marginalize")),
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
    phase_done("0")

    # phase 1: on every path's own map and features
    floor_ms = device_ms(lambda: kernels.launch_floor(dev))
    log(f"launch floor (empty kernel, same harness): {floor_ms * 1e3:.2f} us")
    kres = {name: (phase_edges(c, d, torch, dev) if c.use_edge_features
                   else phase_kernels(name, c, d, torch, dev))
            for name, (c, d, _) in paths.items()}
    claim = phase_voxel_claim(
        (("VLP-16", cfg_vlp, ds_vlp), ("OS1-128", cfg, ds)), torch, dev)
    kres["vlp16"]["voxel_claim"] = claim["VLP-16"]
    # K2's gathered mode runs on no replay path: held at the ship path's
    # shapes, its launches those of one library call
    gathered = kres["ship"].pop("knn_select_gathered")
    # K11b on path E's edge map (its kernels-line entry is the pole
    # lattice's, where most lines are valid)
    edge_map_fit = kres["edges"].pop("edge_fit_edge_map")
    log(f"  edge_fit [edges, path E's edge map]: kernel "
        f"{edge_map_fit['ms'] * 1e3:.2f} us, plain "
        f"{edge_map_fit['plain_ms'] * 1e3:.2f} us, bound "
        f"{edge_map_fit['bound'][0] * 1e3:.4f} us ({smi})")
    phase_done("1")

    # phases 3 to 6 hold the card's runs against the CPU plain path's,
    # computed meanwhile in one spawned worker process (started after
    # phase 1, whose host times it would disturb), stopped on the way out
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        # phases 3 and 4's CPU replays of the first scans, then phase 5's
        # data, while the card runs phases 2 to 4
        cpu_first = pool.apply_async(cpu_first_scans, (
            CPU_WORKER_THREADS,
            [(name, c, first_scans(d, CPU_SCANS), False)
             for name, (c, d, _) in paths.items()]
            + [("ship chunked", cfg, first_scans(ds, CPU_SCANS), True)]))
        superloc_async = pool.apply_async(superloc_data)
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
                    raise SystemExit(f"{k} was held at the {name} path's "
                                     f"shapes but that path did not launch "
                                     f"it")
                log(f"  {k} [{name}]: kernel {r['ms'] * 1e3:.2f} us, plain "
                    f"{r['plain_ms'] * 1e3:.2f} us, bound "
                    f"{r['bound'][0] * 1e3:.4f} us ({r['bound'][1]}), launch "
                    f"floor {floor_ms * 1e3:.2f} us, "
                    f"{runs[name][1][k] / len(d.scans):.3f} launches a scan "
                    f"({smi})")
        phase_done("2")

        # phase 3
        first = cpu_first.get(timeout=CPU_WORKER_TIMEOUT_S)
        for name in paths:
            phase_cpu_agree(name, first[name], runs[name][0])
        phase_done("3")

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
                                    dev, args.out, smi,
                                    {"chunk=n": dict(chunk=n)}),
            "livox": phase_chunked("livox", cfg_livox,
                                   first_scans(ds_livox, BAG_SCANS), torch,
                                   dev, args.out, smi,
                                   {"chunk=n": dict(chunk=BAG_SCANS)}),
        }
        chunked_cpu = phase_chunked_cpu_agree(
            first["ship chunked"], chunked["ship"]["chunk=n"]["result"])
        for name, per in chunked.items():
            ref = runs[name][2] if name in runs else None
            log(f"phase 4 [{name}] ({smi}): chunked " + "; ".join(
                f"{label} {r['scans_per_sec']:.3f} scans/s, p50 / p90 "
                f"{r['p50_step_ms']:.2f} / {r['p90_step_ms']:.2f} ms, ATE "
                f"{r['ate_m']:.6f} m" for label, r in per.items())
                + (f" | per scan (phase 2) {ref['scans_per_sec']:.3f} "
                   f"scans/s, p50 / p90 {ref['p50_step_ms']:.2f} / "
                   f"{ref['p90_step_ms']:.2f} ms, ATE {ref['ate_m']:.6f} m"
                   if ref else ""))
        phase_done("4")

        # phase 5: the SuperLoc path
        superloc, k4_prior = phase_superloc(pool, superloc_async, torch,
                                            dev, args.out, smi)
        phase_done("5")
        # phase 6: recorded sensors
        recorded = phase_recorded(pool, {"ouster": ds, "velodyne": ds_vlp,
                                         "livox": ds_livox}, torch,
                                  args.out, smi)
        phase_done("6")
    finally:
        pool.terminate()
        pool.join()

    # phase 7: many instances on one card
    batched, keep = phase_batched(cfg, torch, dev, smi)
    # phase 8: the fleet over a mesh
    mesh = phase_mesh(cfg, keep, torch, dev, smi)
    del keep
    seconds.update({"7": batched["seconds"], "8": mesh["seconds"],
                    "total": time.perf_counter() - t_start})
    log("seconds per phase: " + json.dumps(
        {k: round(v, 1) for k, v in seconds.items()}))

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
        **({"vio_prior_on_corridor": measured(k4_prior)}
           if k == "gn_solve" else {}),
        "batched": {"route": kernel_ops.ROUTE[k], "us": {
            B: r["ms"] * 1e3 for B, r in batched["kernels"][k].items()
            if B > 1}, "bound_us": {
            B: r["bound_ms"] * 1e3 for B, r in batched["kernels"][k].items()
            if B > 1}},
    } for k in kernels.KERNELS]
    # K1 with a shard window: its launches in phase 8b's fleet whose maps
    # lie in two shards, its time at the ship shapes (8a, shard 0 of 2)
    entries.append({
        "name": "octant_lookup_window",
        "route": "cuda",
        "source": "superodom_tpu_torch/csrc/octant_lookup.cu",
        "replaces": REPLACES["octant_lookup"],
        "launches": mesh["B=4 M=2"]["launches"]["octant_lookup"],
        "path": "ship fleet, B=4, maps in 2 shards (phase 8b)",
        **measured(mesh["k1_window"][2]),
        "library_ms": None,
        "by_shards": {M: measured(r) for M, r in mesh["k1_window"].items()},
    })
    # K2's gathered mode: launched by the library's correspondence
    # functions only (0 a scan on every path), held and timed at the ship
    # path's shapes, its launches those of one compute_plane_correspondences
    entries.append({
        "name": "knn_select_gathered",
        "route": "cuda",
        "source": "superodom_tpu_torch/csrc/knn_select.cu",
        "replaces": REPLACES["knn_select_gathered"],
        "launches": gathered["launches"],
        "path": "library: registration.compute_plane_correspondences at "
                "the ship path's shapes (no replay path launches it)",
        **measured(gathered),
        "library_ms": None,
        "launches_per_scan": {p: runs[p][1]["knn_select_gathered"] / len(
            paths[p][1].scans) for p in paths},
    })
    record = {"card": smi, "kernels": entries, "main_path": runs["ship"][2],
              "paths": {p: runs[p][2] for p in paths},
              "launch_floor_ms": floor_ms,
              "voxel_claim_os1_128": measured(claim["OS1-128"]),
              "voxel_claim_clusters": {label: r["cluster"]
                                       for label, r in claim.items()},
              "edge_fit_edge_map": measured(edge_map_fit),
              "gn_solve_host_us": {p: kres[p]["gn_solve"]["host_us"]
                                   for p in paths
                                   if "host_us" in kres[p]["gn_solve"]},
              "chunked": {name: {label: {k: v for k, v in r.items()
                                         if k != "result"}
                                 for label, r in per.items()}
                          for name, per in chunked.items()},
              "chunked_cpu_agree": chunked_cpu,
              "superloc": superloc,
              "gn_solve_vio_prior_on_corridor": measured(k4_prior),
              "recorded": recorded,
              "batched": batched,
              "mesh": mesh,
              "seconds": seconds}
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
