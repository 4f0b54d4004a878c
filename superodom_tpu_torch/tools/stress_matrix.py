"""Stress-matrix qualification: the full adversarial battery
(``io.scenarios``) run against BOTH the tuned ship config and the
reference-envelope (parity) config at realistic density (counterpart of
the JAX package's ``tools/stress_matrix.py``, with the same flags but
``--device`` and the same row keys).

    python -m superodom_tpu_torch.tools.stress_matrix   # full battery, both configs
    python -m superodom_tpu_torch.tools.stress_matrix --cases aggressive_6dof far_field
    python -m superodom_tpu_torch.tools.stress_matrix --long-run   # adds the long runs
    python -m superodom_tpu_torch.tools.stress_matrix --points 16384 --json m.json

Runs on the card unless ``--device cpu`` is given.  Prints one row per
(case, config) with the ATE over settled frames and the case bound, then a
worst-case summary; exits 1 if any row fails.  ``--json`` writes the rows
with the run's provenance (the card's name and power limit).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from superodom_tpu_torch.config import parity_config, ship_config
from superodom_tpu_torch.tools.profile import (
    apply_overrides,
    device_label,
    device_of,
    parse_overrides,
)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _configs(points: int):
    """(name, PipelineConfig) pairs: tuned ship config + reference envelope,
    both at the bench's OS1 profile but with max_points sized to the
    battery's density."""
    out = []
    for name, make in (("ship", ship_config), ("parity", parity_config)):
        cfg = make("os1")
        # feature capacity must fit the post-decimation lane count at this
        # density (OS1 stride 3), a multiple of 128 as in the JAX package
        surf_cap = min(cfg.sensor.max_surface_features,
                       points // 3 // 128 * 128)
        cfg = dataclasses.replace(
            cfg, sensor=dataclasses.replace(
                cfg.sensor, max_points=points,
                max_surface_features=surf_cap)
        )
        out.append((name, cfg))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=16384,
                    help="points per scan (battery density)")
    ap.add_argument("--cases", nargs="*", help="subset of case names")
    ap.add_argument("--long-run", action="store_true",
                    help="include the 2000-scan endurance case and the "
                         "1 km long-range case")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="run-length multiplier")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--json", help="write the full result matrix here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--override", action="append", default=[],
                    help="dotted.config.key=value applied to BOTH configs "
                         "(A/B diagnosis, e.g. registration.refresh_width=0)")
    ap.add_argument("--configs", nargs="*", choices=["ship", "parity"],
                    help="subset of configs to run")
    args = ap.parse_args(argv)

    dev = device_of(args.device)

    from superodom_tpu_torch.io import scenarios as sc
    from superodom_tpu_torch.io.datasets import ate_rmse
    from superodom_tpu_torch.runner import OdometryRunner

    cases = sc.stress_battery(points_per_scan=args.points, scale=args.scale,
                              long_run=args.long_run)
    if args.cases:
        cases = [c for c in cases if c.name in set(args.cases)]
    configs = _configs(args.points)
    if args.configs:
        configs = [(n, c) for n, c in configs if n in set(args.configs)]
    if args.override:
        ov = parse_overrides(args.override)
        configs = [(n, apply_overrides(c, ov)) for n, c in configs]

    rows = []
    for case in cases:
        ds = case.build(np.random.default_rng(args.seed))
        for cfg_name, cfg in configs:
            cfg_c = dataclasses.replace(cfg, **case.cfg_overrides)
            runner = OdometryRunner(cfg_c, device=dev)
            sc.prime_prior_map(runner, case,
                               np.random.default_rng(args.seed + 1))
            t0 = time.perf_counter()
            res = runner.run_dataset(ds, use_imu=True)
            wall = time.perf_counter() - t0
            s = case.settle
            finite = bool(np.all(np.isfinite(res.poses_t)))
            ate = (ate_rmse(res.poses_t[s:], np.asarray(ds.gt_poses_t)[s:])
                   if finite else float("inf"))
            check_ok = True
            for chk, chk_args in ((case.check, (res, ds, s)),
                                  (case.post_check, (runner, res, ds, s))):
                if chk is None:
                    continue
                try:
                    chk(*chk_args)
                except AssertionError as e:
                    check_ok = False
                    print(f"  check failed: {e}", file=sys.stderr)
            ok = finite and ate < case.ate_bound and check_ok
            rows.append({
                "case": case.name, "config": cfg_name,
                "n_scans": len(ds.scans), "ate_m": round(ate, 4),
                "bound_m": case.ate_bound, "check_ok": check_ok,
                "pass": ok, "wall_s": round(wall, 1),
            })
            print(f"{case.name:20s} {cfg_name:7s} ate={ate:7.4f} "
                  f"(bound {case.ate_bound}) check={'ok' if check_ok else 'FAIL'} "
                  f"{'PASS' if ok else 'FAIL'}  [{wall:.0f}s]", flush=True)

    worst = max((r for r in rows if r["ate_m"] != float("inf")),
                key=lambda r: r["ate_m"] / r["bound_m"], default=None)
    n_fail = sum(not r["pass"] for r in rows)
    print(f"\n{len(rows) - n_fail}/{len(rows)} passed; worst case: "
          f"{worst['case']}/{worst['config']} ate={worst['ate_m']}"
          if worst else "no finite rows")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"provenance": _provenance(args, dev),
                       "rows": rows}, f, indent=1)
    sys.exit(1 if n_fail else 0)


def _provenance(args, dev):
    """What was measured and when, inside the artifact: the commit (where
    the tree is a git checkout), the device — on the card its name and
    power limit — and the battery's settings."""
    import hashlib
    import subprocess

    try:
        sha = subprocess.run(
            ["git", "-C", _REPO_ROOT, "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=10).stdout.strip()
        dirty = bool(subprocess.run(
            ["git", "-C", _REPO_ROOT, "status", "--porcelain"],
            capture_output=True, text=True, timeout=10).stdout.strip())
    except Exception:
        sha, dirty = "unknown", True
    cfg_hash = hashlib.sha256(
        "\n".join(repr(c) for _, c in _configs(args.points))
        .encode()).hexdigest()[:16]
    return {
        "git_sha": sha or "unknown",
        "git_dirty": dirty,
        "date_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "backend": dev.type,
        "device": device_label(dev),
        "torch": torch.__version__,
        "points": args.points,
        "scale": args.scale,
        "seed": args.seed,
        "config_hash": cfg_hash,
        "overrides": list(args.override),
    }


if __name__ == "__main__":
    main()
