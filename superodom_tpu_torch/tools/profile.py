"""The profiler driver: config A/B comparison and per-stage device timing
(counterpart of the JAX package's ``tools/profile.py``).

    # interleaved-repeat A/B of config variants (throughput + ATE medians):
    python -m superodom_tpu_torch.tools.profile ab base \\
        A:registration.max_icp_iters=2 \\
        B:sensor.scan_thin_mode=none,map.cell_capacity=32 --n 120 --reps 3

    # per-stage timing of the odometry step on the card:
    python -m superodom_tpu_torch.tools.profile stages --reps 30

Variants are NAME:dotted.key=value,... ("base" = the ship config
``ship_config("os1")``; a name starting with "parity" = the
reference-envelope config ``parity_config("os1")``).  Values parse as
Python literals.  Both run on the card unless ``--device cpu`` is given
(the CPU tests); the output names the device, and on the card its name and
power limit as ``nvidia-smi`` gives them.

``stages`` warms a state over ``--warm-scans`` scans (40, as in JAX) of the
replay benchmark's world, then times each stage of the step on scan 5's
inputs after one warm call: milliseconds a call over ``--reps`` calls that
carry their output into the next call's input (JAX's ``jit(lax.scan)``),
between two CUDA events on the card (the host clock on the CPU).  The
step waits on the host's dispatch (PERF.md section 5), so a stage's time
on the card's stream is mostly the time the host takes to issue it.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import time

import numpy as np
import torch

from superodom_tpu_torch.config import parity_config, ship_config


def apply_overrides(cfg, overrides: dict):
    """Apply {'registration.max_icp_iters': 2, ...} to a frozen config tree."""
    for key, val in overrides.items():
        parts = key.split(".")
        objs = [cfg]
        for p in parts[:-1]:
            objs.append(getattr(objs[-1], p))
        node = dataclasses.replace(objs[-1], **{parts[-1]: val})
        for obj, p in zip(reversed(objs[:-1]), reversed(parts[:-1])):
            node = dataclasses.replace(obj, **{p: node})
        cfg = node
    return cfg


def parse_overrides(kvs) -> dict:
    """``["a.b=1", "c=none"]`` -> ``{"a.b": 1, "c": "none"}``: Python
    literals, else the bare string."""
    ov = {}
    for kv in kvs:
        k, v = kv.split("=", 1)
        try:
            ov[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            ov[k] = v  # bare string (e.g. scan_thin_mode=none)
    return ov


def parse_variant(spec: str):
    if ":" in spec:
        name, kvs = spec.split(":", 1)
    else:
        name, kvs = spec, ""
    # any name starting with "parity" uses the reference-envelope base (so
    # several parity-derived variants can be A/B'd in one run)
    cfg = (parity_config if name.startswith("parity") else ship_config)("os1")
    return name, apply_overrides(
        cfg, parse_overrides(filter(None, kvs.split(","))))


def device_label(device: torch.device) -> str:
    """The device a result was measured on: on the card its name and power
    limit (``nvidia-smi --query-gpu=name,power.limit``), else "cpu"."""
    if device.type != "cuda":
        return "cpu"
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    index = device.index if device.index is not None else 0
    return out.stdout.strip().splitlines()[index]


def device_of(name: str) -> torch.device:
    """The device a tool runs on; the card must exist when it is named
    (no quiet move to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    return dev


def _timeit(fn, init, reps: int, device: torch.device) -> float:
    """ms a call of ``fn`` over ``reps`` calls, each on the previous
    call's output, after one warm call (which also builds the kernels)."""
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    x = fn(init)
    sync()
    if device.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            x = fn(x)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        x = fn(x)
    return (time.perf_counter() - t0) * 1e3 / reps


def run_ab(args):
    from superodom_tpu_torch.io.datasets import ate_rmse, bench_dataset
    from superodom_tpu_torch.runner import OdometryRunner

    dev = device_of(args.device)
    print(f"device: {device_label(dev)}", flush=True)
    variants = dict(parse_variant(s) for s in args.variants)
    first = next(iter(variants.values()))
    ds = bench_dataset(args.n, first.sensor.max_points)

    results = {k: [] for k in variants}
    for rep in range(args.reps):
        for name, c in variants.items():
            r = OdometryRunner(c, device=dev)
            rr = r.run_dataset_chunked(ds, use_imu=True, chunk=args.n,
                                       preload=True)
            ate = ate_rmse(rr.poses_t, np.asarray(ds.gt_poses_t))
            results[name].append((rr.scans_per_sec, ate))
            print(f"  rep{rep} {name:28s} {rr.scans_per_sec:7.3f} scans/s "
                  f"ATE {ate:.4f} m", flush=True)
    print()
    for name, rows in results.items():
        sps = np.median([r[0] for r in rows])
        ate = np.median([r[1] for r in rows])
        print(f"{name:30s} median {sps:7.3f} scans/s  ATE {ate:.4f} m")
    return results


def run_stages(args):
    from superodom_tpu_torch.frontend import (
        select_features,
        undistort_points,
        uniform_feature_extraction,
    )
    from superodom_tpu_torch.geometry import Pose
    from superodom_tpu_torch.inertial import smoother_update
    from superodom_tpu_torch.io.datasets import bench_dataset
    from superodom_tpu_torch.mapstate import (
        census_box,
        evict_far,
        gather_candidates,
        insert,
        select_knn,
    )
    from superodom_tpu_torch.ops.voxel import voxel_downsample_scatter
    from superodom_tpu_torch.registration import (
        PosePrior,
        gauss_newton_solve,
        icp_register,
        plane_correspondences_from_candidates,
    )
    from superodom_tpu_torch.runner import OdometryRunner

    reps = args.reps
    dev = device_of(args.device)
    print(f"device: {device_label(dev)}", flush=True)
    name, cfg = parse_variant(args.config)
    ds = bench_dataset(args.warm_scans, cfg.sensor.max_points)
    runner = OdometryRunner(cfg, device=dev)

    # warm a realistic state: run the scans to populate the map
    res = runner.run_dataset_chunked(ds, use_imu=True, chunk=args.warm_scans)
    state = runner.state
    print(f"warm run ({name}): {res.scans_per_sec:.3f} scans/s", flush=True)

    s = ds.scans[5]
    scan = runner.make_scan(s.t_start, s.xyz_body, s.t_rel)
    win, ok = runner._imu_window(s.t_start, s.t_start + float(s.t_rel[-1]))
    win = runner._to_device(win)
    avail = torch.tensor(ok, device=dev)
    rt = state.rt
    pose = state.pose
    sensor = cfg.sensor
    reg = cfg.registration
    R_il = torch.eye(3, device=dev)
    t_il = torch.zeros(3, device=dev)

    def timed(fn, init):
        return _timeit(fn, init, reps, dev)

    results = {}

    # ---------------- full step ------------------------------------------
    results["full_step"] = timed(
        lambda st: runner.step_fn(st, scan, win, avail)[0], state)

    # ---------------- frontend pieces -------------------------------------
    if scan.xyz.shape[0] == sensor.max_points:  # full width
        def fe_a(x):
            fm = uniform_feature_extraction(
                x, scan.mask, sensor.filter_point_size, sensor.min_range,
                sensor.max_range)
            return x + fm[0] * 1e-20

        results["frontend/uniform_mask"] = timed(fe_a, scan.xyz)

    def fe_b(x):
        keep = voxel_downsample_scatter(x, scan.mask, rt.plane_res)
        return x + keep[0] * 1e-20

    results["frontend/voxel_downsample"] = timed(fe_b, scan.xyz)

    def fe_c(x):
        sr, sm, st_ = select_features(x, scan.mask,
                                      sensor.max_surface_features, scan.t_rel)
        return x + sr[0, 0] * 1e-20

    results["frontend/select_features"] = timed(fe_c, scan.xyz)

    def fe_d(x):
        sr, sm, st_ = select_features(x, scan.mask,
                                      sensor.max_surface_features, scan.t_rel)
        su, q, _ = undistort_points(sr, st_, sm, scan.t_start, win, R_il,
                                    t_il)
        return x + su[0, 0] * 1e-20

    results["frontend/select+undistort"] = timed(fe_d, scan.xyz)

    # ---------------- registration stages ----------------------------------
    keep = voxel_downsample_scatter(scan.xyz, scan.mask, rt.plane_res)
    surf_pts, surf_mask, _tr = select_features(
        scan.xyz, keep, sensor.max_surface_features, scan.t_rel)
    surf_pts = surf_pts.contiguous()

    def g_gather(p):
        cand, cval = gather_candidates(state.surf_map, cfg.map, p)
        return p + cand[0, 0, 0] * 1e-20

    results["icp/gather_candidates"] = timed(g_gather, pose.apply(surf_pts))

    cand, cval = gather_candidates(state.surf_map, cfg.map,
                                   pose.apply(surf_pts))

    def g_select(p):
        pts, sq, v = select_knn(cand, cval, p, reg.plane_knn)
        return p + pts[0, 0] * 1e-20

    results["icp/select_knn"] = timed(g_select, pose.apply(surf_pts))

    def g_plane(p):
        pc = plane_correspondences_from_candidates(
            cand, cval, reg, Pose(pose.q, p[0] * 1e-20 + pose.t), surf_pts,
            surf_mask, rt.plane_res)
        return p + pc.normal[0] * 1e-20

    results["icp/plane_corrs(incl select)"] = timed(g_plane,
                                                    pose.apply(surf_pts))

    planes = plane_correspondences_from_candidates(
        cand, cval, reg, pose, surf_pts, surf_mask, rt.plane_res)

    def g_gn(p):
        po, _ = gauss_newton_solve(Pose(pose.q, p), planes, None, rt,
                                   reg.max_gn_iters, use_edges=False)
        return po.t

    results[f"icp/gauss_newton({reg.max_gn_iters}it)"] = timed(g_gn, pose.t)

    ne = sensor.max_edge_features
    prior = PosePrior(pose=pose, information=torch.zeros(6, device=dev),
                      enabled=torch.tensor(False, device=dev))
    no_edges = torch.zeros((ne, 3), device=dev)
    no_edge_mask = torch.zeros((ne,), dtype=torch.bool, device=dev)

    def g_icp(p):
        po, stats = icp_register(
            state.edge_map, state.surf_map, cfg.map, reg, Pose(pose.q, p),
            no_edges, no_edge_mask, surf_pts, surf_mask, rt, prior,
            use_edges=False)
        return po.t

    results["icp/full_register"] = timed(g_icp, pose.t)

    # ---------------- map update ------------------------------------------
    world = pose.apply(surf_pts)
    results["map/insert"] = timed(
        lambda mp: insert(mp, cfg.map, world, surf_mask, rt.plane_res),
        state.surf_map)
    results["map/evict"] = timed(
        lambda mp: evict_far(mp, cfg.map, pose.t), state.surf_map)
    box = torch.tensor([125.0, 125.0, 75.0], device=dev)
    results["map/census"] = timed(
        lambda p: p + census_box(state.surf_map, cfg.map, p, box) * 1e-20,
        pose.t)

    # ---------------- smoother --------------------------------------------
    results["smoother/update"] = timed(
        lambda sm: smoother_update(sm, cfg.imu, pose, scan.t_start, win)[0],
        state.smoother)

    print()
    for k, v in results.items():
        print(f"{k:38s} {v:8.3f} ms")
    coarse = (
        results["icp/full_register"] + results["map/insert"]
        + results["map/evict"] + results["map/census"]
        + results["smoother/update"] + results["frontend/select+undistort"]
        + results["frontend/voxel_downsample"]
    )
    print(f"\n(sum of coarse stages = {coarse:.3f} ms "
          f"vs full_step {results['full_step']:.3f} ms)")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ab = sub.add_parser("ab", help="config A/B throughput+ATE comparison")
    ab.add_argument("variants", nargs="+",
                    help="NAME[:dotted.key=value,...]; 'base' = ship config, "
                         "'parity' = reference-envelope config")
    ab.add_argument("--n", type=int, default=120, help="scans per run")
    ab.add_argument("--reps", type=int, default=3)
    st = sub.add_parser("stages", help="per-stage device timing")
    st.add_argument("--reps", type=int, default=30)
    st.add_argument("--config", default="base",
                    help="variant spec for the profiled config")
    st.add_argument("--warm-scans", type=int, default=40,
                    help="scans of the warm run that fills the map")
    for p in (ab, st):
        p.add_argument("--device", default="cuda",
                       help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    if args.cmd == "ab":
        return run_ab(args)
    return run_stages(args)


if __name__ == "__main__":
    main()
