"""Readings that the limits of ``check.LIMITS`` were set from: for each
seed, the program's numbers against the reference (the lower readings)
and each control's (the reference in a lower precision in the program's
place, ``check.CONTROLS``; the upper readings), on one cell, in one
process.

    python3 -m odombench.control --workload <name> --seeds 1,2,3
        [--seconds 1]

One JSON line a seed, then one with the program's worst and each
control's least."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    import torch

    from odombench import check, harness, registry

    registry.set_cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = registry.cell(ROOT, args.workload)
    lower, upper = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(cell, seed, args.seconds, False,
                             torch.device("cuda", 0), time.perf_counter(),
                             control=True)
        prog = {k: v[0] for k, v in r["compared"].items()}
        lower.append(prog)
        upper.append(r["control"])
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "program": prog, "control": r["control"]}),
              flush=True)
    print(json.dumps({"workload": args.workload,
                      "card": torch.cuda.get_device_name(0),
                      "lower": check.worst(lower),
                      "upper": {c: {k: min(u[c][k] for u in upper)
                                    for k in upper[0][c]}
                                for c in upper[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
