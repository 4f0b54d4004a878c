"""The sweep that chose each configuration's fleet size: traced runs of a
cell at each size, one process a size, and a table of the device's idle
share, the step's milliseconds and the peak memory.

    python3 -m odombench.sweep --workload <name> --instances 256,512,1024
        [--seconds 20] [--seed 1]

A size is usable where the peak stays under ``MAX_GIB`` and a step leaves
at least ``MIN_STEPS`` steps in a ``WINDOW_S`` second window; the rule
takes the smallest usable size at which the device is busy half the traced
window, else the largest usable one.  The configuration's file holds the
size chosen; this is the one place that runs a cell at another."""

import argparse
import json
import subprocess
import sys
import time

T_PROCESS = time.perf_counter()

MAX_GIB = 60.0
WINDOW_S = 51.0
MIN_STEPS = 30
TIMEOUT_S = 600


def one(workload: str, instances: int, seed: int, seconds: float) -> int:
    """One traced run of ``workload`` at ``instances``; its result's line
    on standard output."""
    from pathlib import Path

    import torch

    from odombench import harness, registry

    root = Path(__file__).resolve().parent.parent
    registry.set_cache_dirs(root)
    cell = registry.cell(root, workload)
    cell.config = dict(cell.config, instances=instances)
    r = harness.run_cell(cell, seed, seconds, True, torch.device("cuda", 0),
                         T_PROCESS)
    print(json.dumps(r), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--instances", default="256,512,1024")
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--one", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return one(args.workload, args.one, args.seed, args.seconds)
    rows = []
    for b in (int(x) for x in args.instances.split(",")):
        cmd = [sys.executable, "-m", "odombench.sweep", "--workload",
               args.workload, "--seed", str(args.seed), "--seconds",
               str(args.seconds), "--one", str(b)]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rows.append({"instances": b, "error": "timeout"})
            continue
        lines = p.stdout.strip().splitlines()
        if p.returncode or not lines:
            rows.append({"instances": b, "error": f"exit {p.returncode}",
                         "stderr": p.stderr[-1500:]})
            print(json.dumps(rows[-1]), flush=True)
            continue
        r = json.loads(lines[-1])
        w = r["window"]
        m = {k: v["value"] for k, v in r["metrics"].items()}
        step_ms = w["seconds"] / w["steps"] * 1e3
        rows.append({
            "instances": b, "correct": r["correct"],
            "idle_share": m.get("device_idle_share"),
            "step_ms": step_ms, "scans_per_s": b * w["steps"] / w["seconds"],
            "peak_mib": r["device"]["memory_peak_bytes"] / 2 ** 20,
            "window_peak_mib": m.get("peak_mem_mib"),
            "setup_s": w["setup_s"], "setup_parts": w.get("setup_parts"),
            "check_s": w.get("check_s"), "metrics": m,
            "breakdown": r.get("breakdown"), "compared": r["compared"],
            "usable": (r["device"]["memory_peak_bytes"] < MAX_GIB * 2 ** 30
                       and WINDOW_S * 1e3 / step_ms >= MIN_STEPS)})
        print(json.dumps(rows[-1]), flush=True)
    usable = [r for r in rows if r.get("usable")]
    busy = [r for r in usable if r["idle_share"] is not None
            and r["idle_share"] <= 0.5]
    pick = min(busy, key=lambda r: r["instances"]) if busy else (
        max(usable, key=lambda r: r["instances"]) if usable else None)
    print(json.dumps({"workload": args.workload, "sweep": [
        {k: r.get(k) for k in ("instances", "idle_share", "step_ms",
                               "peak_mib", "correct", "error")}
        for r in rows], "chosen": pick and pick["instances"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
