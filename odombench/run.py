"""Runs one cell of the benchmark once and prints its result as the last
line of standard output:

    python3 -m odombench.run --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  Needs as many
CUDA devices as the cell asks for; exits non-zero with no result otherwise,
when the program cannot be imported, or when the process holds JAX or the
JAX package once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "superodom_tpu")
ROOT = Path(__file__).resolve().parent.parent


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from odombench import registry

    registry.set_cache_dirs(ROOT)
    # a library the program uses must not load JAX by itself
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    cell = registry.cell(ROOT, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    try:
        import superodom_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not here: {e}", file=sys.stderr)
        return 2

    from odombench import harness

    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
