"""Interleaved A/B of kernel builds on the card: K9b ``select_reduced`` and
K11b ``edge_fit`` of this tree against builds of other source trees, on
the same inputs, in one process.

    # this tree against a parent commit unpacked into a git-ignored
    # directory (git archive), and against an edited copy of csrc/
    python -m superodom_tpu_torch.tools.kernel_ab \\
        --build parent=_archive/parent/superodom_tpu_torch/csrc \\
        --build variant=_archive/variant/csrc \\
        [--fleets 1,4,16,64] [--json FILE]

Each other tree's ``csrc/*.cu`` is compiled with this tree's ``nvcc``
flags and loaded with ctypes beside this tree's library; the builds share
the C interface, so the port's wrappers launch whichever is current.  The
inputs are path E's own: 24 scans of the replay benchmark's world (seed
7) through ``OdometryRunner`` under path E (``parity_config("os1")``
with edges) on the card, recording the arguments of the last scan's K9b
launches on the surface map (5 of 16 lanes) and on the edge map (10 of
20) and of its K11b launch (512 lines, k = 10).  A fleet of B takes B
copies of them (K9b's queries flattened, K11b's instance dimension), as
``kernel_ops``' vmap rules launch them.

Every build's outputs are held against this tree's: K9b in every valid
lane, K11b outside the lanes that ``edge_gate_margin_lanes`` flags.  Each
case is timed as ``utils.device_ms`` times it (20 launches in one CUDA
graph, the median of 50 replays), once a build in each of 4 turns, the
builds in a palindrome (this, A, B, B, A, this, ...); the medians over
the turns are printed, a line a case and then one JSON line, with the
card's name and power limit.  Runs on the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess

import torch

from superodom_tpu_torch import kernels, registration
from superodom_tpu_torch.config import parity_config
from superodom_tpu_torch.io.datasets import bench_dataset
from superodom_tpu_torch.runner import OdometryRunner
from superodom_tpu_torch.tools.profile import device_label
from superodom_tpu_torch.utils import device_ms

FLEETS = (1, 4, 16, 64)
SCANS = 24  # path E's warm-up: the edge map and the refresh rounds run
TURNS = 4
# the C entry points the timed wrappers call
ENTRIES = ("so_select_reduced", "so_edge_fit")


def build_tree(csrc: str) -> ctypes.CDLL:
    """Compile another tree's ``csrc/*.cu`` as ``kernels.build`` compiles
    this tree's, into ``kernels.BUILD`` under a name hashed from its
    sources, and load it with :data:`ENTRIES` typed as this tree's."""
    srcs = [os.path.join(csrc, f"{n}.cu") for n in kernels.SOURCES]
    h = hashlib.sha256()
    for path in srcs + [os.path.join(csrc, n) for n in kernels.HEADERS]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(kernels.NVCC_FLAGS).encode())
    out = os.path.join(kernels.BUILD, f"ab-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(kernels.BUILD, exist_ok=True)
        proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                               csrc, "-o", out, *srcs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc}:\n{proc.stderr}")
    lib, this = ctypes.CDLL(out), kernels.load()
    for name in ENTRIES:
        fn, ref = getattr(lib, name), getattr(this, name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return lib


def record_path_e(n_scans: int, dev: torch.device):
    """The arguments of the last K9b launch of each width and of the last
    K11b launch of a path E replay of ``n_scans`` scans, cloned."""
    cfg = dataclasses.replace(parity_config("os1"), use_edge_features=True)
    ds = bench_dataset(n_scans, cfg.sensor.max_points)
    seen = {}
    originals = {n: getattr(kernels, n) for n in ("select_reduced",
                                                  "edge_fit")}

    def recorder(name):
        def call(*args):
            key = name if name == "edge_fit" else (name, args[0].shape[1])
            seen[key] = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                              for a in args)
            return originals[name](*args)
        return call

    try:
        for name in originals:
            setattr(kernels, name, recorder(name))
        OdometryRunner(cfg, device=dev).run_dataset(ds)
    finally:
        for name, fn in originals.items():
            setattr(kernels, name, fn)
    torch.cuda.synchronize()
    return seen


def cases(seen, fleets=FLEETS):
    """name -> (launch, check of its outputs against this tree's) at every
    fleet size of ``fleets``."""
    out = {}
    for (_, w), args in sorted((k, v) for k, v in seen.items()
                               if k != "edge_fit"):
        *red, q, k = args
        for B in fleets:
            rep = [torch.cat([t] * B).contiguous() for t in (*red, q)]
            out[f"select_reduced {k} of {w}, B={B}"] = (
                lambda rep=rep, k=k: kernels.select_reduced(*rep, k),
                same_valid_lanes)
    neigh, sq, nvalid, mask, line_res, min_nb, inlier = seen["edge_fit"]
    for B in fleets:
        rep = [t.expand((B,) + t.shape).contiguous()
               for t in (neigh, sq, nvalid, mask, line_res)]
        near = registration.edge_gate_margin_lanes(
            neigh, sq, nvalid, line_res, min_nb, inlier).repeat(B)
        out[f"edge_fit {sq.shape[0]} x {sq.shape[1]}, B={B}"] = (
            lambda rep=rep: kernels.edge_fit_batched(*rep, min_nb, inlier),
            lambda a, b, near=near: same_off_gates(a, b, near))
    return out


def same_valid_lanes(a, b) -> bool:
    """K9b's outputs ``a`` are ``b``'s in validity and in every valid lane."""
    v = b[2]
    return (torch.equal(a[2], v) and torch.equal(a[0][v], b[0][v])
            and torch.equal(a[1][v], b[1][v]))


def same_off_gates(a, b, near) -> bool:
    """K11b's outputs ``a`` are ``b``'s, bit for bit (NaN equal to NaN), in
    every lane that ``near`` (the fleet's lanes flattened) does not flag."""
    far = ~near
    for x, y in zip(a, b):
        x, y = x.reshape(near.shape[0], -1), y.reshape(near.shape[0], -1)
        ne = (x != y) & ~((x != x) & (y != y))
        if bool(ne[far].any()):
            return False
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", action="append", default=[],
                    metavar="NAME=CSRC", help="another tree's csrc directory")
    ap.add_argument("--fleets", default=",".join(map(str, FLEETS)),
                    help="fleet sizes B, comma-separated")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device; the kernels run only on "
                         "the card")
    dev = torch.device("cuda")
    card = device_label(dev)

    libs = {"this": kernels.load()}
    for spec in args.build:
        name, csrc = spec.split("=", 1)
        libs[name] = build_tree(os.path.abspath(csrc))

    seen = record_path_e(SCANS, dev)
    runs = cases(seen, tuple(int(b) for b in args.fleets.split(",")))
    names = list(libs)
    order = []
    for t in range(TURNS):
        order += names if t % 2 == 0 else names[::-1]
    times = {c: {n: [] for n in names} for c in runs}
    agree = {c: {} for c in runs}
    try:
        for name in order:
            kernels._lib = libs[name]
            for label, (launch, same) in runs.items():
                if name not in agree[label]:
                    got = launch()
                    kernels._lib = libs["this"]
                    want = launch()
                    kernels._lib = libs[name]
                    torch.cuda.synchronize()
                    agree[label][name] = bool(same(got, want))
                times[label][name].append(device_ms(launch) * 1e3)
    finally:
        kernels._lib = libs["this"]
    result = {"card": card, "turns": TURNS, "order": order,
              "us": {c: {n: statistics.median(v) for n, v in per.items()}
                     for c, per in times.items()},
              "us_each_turn": times, "agree_with_this": agree}
    for label, per in result["us"].items():
        print(f"{label}: " + ", ".join(
            f"{n} {us:.2f} us" + ("" if agree[label][n] else " (DIFFERS)")
            for n, us in per.items()) + f" ({card})", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"card": card, "us": result["us"]}))
    if not all(all(a.values()) for a in agree.values()):
        raise SystemExit("kernel_ab: a build's outputs differ from this "
                         "tree's")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
