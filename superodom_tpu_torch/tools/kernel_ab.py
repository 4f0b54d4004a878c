"""Interleaved A/B of kernel builds on the card: K9a
``reduce_candidates``, K9b ``select_reduced``, K10 ``voxel_claim`` and
K11b ``edge_fit`` of this tree against builds of other source trees, on
the same inputs, in one process.

    # this tree against a parent commit unpacked into a git-ignored
    # directory (git archive), and against an edited copy of csrc/
    python -m superodom_tpu_torch.tools.kernel_ab \\
        --build parent=_archive/parent/superodom_tpu_torch/csrc \\
        --build variant=_archive/variant/csrc \\
        [--fleets 1,4,16,64] [--json FILE]

Each other tree's ``csrc/*.cu`` is compiled with this tree's ``nvcc``
flags and loaded with ctypes beside this tree's library; the port's
wrappers launch whichever is current.  A build whose K9a has no k nearest
and whose K10 needs a caller's claim table at every size (the interface
before K9a gave K9b's outputs and K10 kept its table in shared memory) is
called through adapters here: its K9a with its old arguments, its K10
with a scratch table.  The inputs are the paths' own: 24 scans of the
replay benchmark's world (seed 7) through ``OdometryRunner`` under path E
(``parity_config("os1")`` with edges) on the card, recording the
arguments of the last scan's K9a and K9b launches on the surface map (16
lanes, 5 of them) and on the edge map (20, 10 of them), of its K11b
launch (512 lines, k = 10) and of its K10 launch (the edge stream); and 4
scans of path V (``ship_config("vlp16")``), recording its K10 launch.  A
fleet of B takes B copies of them (K9b's queries flattened, the others'
instance dimension, each instance its own copy), as ``kernel_ops``' vmap
rules launch them.

The cases: K9a; K9a with round 2's K9b (a build whose K9a has no k
nearest launches K9b on its planes, as its round 2 did); K9b; K10; K11b.
Every build's outputs are held against this tree's: K9a's planes in
validity and every valid lane, the k nearest of round 2 and K10's
keep-masks bit for bit, K9b in every valid lane, K11b outside the lanes
that ``edge_gate_margin_lanes`` flags.  Each case is timed as
``utils.device_ms`` times it (20 launches in one CUDA graph, the median
of 50 replays), once a build in each of 4 turns, the builds in a
palindrome (this, A, B, B, A, this, ...); the medians over the turns are
printed, a line a case and then one JSON line, with the card's name and
power limit.  Runs on the card only.
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
from superodom_tpu_torch.config import parity_config, ship_config
from superodom_tpu_torch.io.datasets import bench_dataset
from superodom_tpu_torch.runner import OdometryRunner
from superodom_tpu_torch.tools.profile import device_label
from superodom_tpu_torch.utils import device_ms

FLEETS = (1, 4, 16, 64)
SCANS = 24  # path E's warm-up: the edge map and the refresh rounds run
SCANS_V = 4  # path V thins every scan through K10
TURNS = 4
# the C entry points the timed wrappers call
ENTRIES = ("so_select_reduced", "so_edge_fit", "so_reduce_candidates",
           "so_voxel_claim")
# K9a's arguments in a build without its k nearest: (pts, C, slots,
# queries, nq, w, x, y, z, valid, n_inst, istride, stream)
_vp, _ci = ctypes.c_void_p, ctypes.c_int
PLANES_ONLY = {"so_reduce_candidates": [_vp, _ci, _vp, _vp, _ci, _ci, _vp,
                                        _vp, _vp, _vp, _ci, _vp, _vp]}


def fused(lib: ctypes.CDLL) -> bool:
    """True for a build whose K9a writes its k nearest and whose K10 keeps
    its claim table in shared memory (it has the cluster query)."""
    return hasattr(lib, "so_voxel_claim_clusters")


def build_tree(csrc: str) -> ctypes.CDLL:
    """Compile another tree's ``csrc/*.cu`` as ``kernels.build`` compiles
    this tree's, into ``kernels.BUILD`` under a name hashed from its
    sources, and load it with :data:`ENTRIES` typed as its interface."""
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
        fn.argtypes = (ref.argtypes if fused(lib)
                       else PLANES_ONLY.get(name, ref.argtypes))
        fn.restype = ref.restype
    return lib


def reduce(pts, slots, queries, w, k):
    """K9a over n instances on the current build: (x, y, z, valid) [n, Q,
    w], then the k nearest of round 2 (neighbours, sq, valid) [n, Q, k];
    a build without them gives its planes and launches K9b on them, as
    its round 2 did."""
    out = reduce_once(pts, slots, queries, w, k)
    if len(out) == 7:
        return out
    n, nq = queries.shape[:2]
    near = kernels.select_reduced(
        *(a.reshape((n * nq,) + a.shape[2:]) for a in (*out, queries)), k)
    return out + tuple(o.reshape((n, nq) + o.shape[1:]) for o in near)


def reduce_once(pts, slots, queries, w, k):
    """One K9a launch over n instances on the current build, as its path
    launches it: with the k nearest (seven outputs), or a build without
    them, its planes alone (four)."""
    lib = kernels._lib
    if fused(lib):
        return kernels.reduce_candidates_batched(pts, slots, queries, w, k)
    dev = queries.device
    n, nq, C, strides = kernels._check_candidates(
        "reduce_candidates", pts, slots, queries, w)
    x, y, z = (torch.empty((n, nq, w), dtype=torch.float32, device=dev)
               for _ in range(3))
    valid = torch.empty((n, nq, w), dtype=torch.bool, device=dev)
    p = kernels._p
    rc = lib.so_reduce_candidates(p(pts), C, p(slots), p(queries), nq, w,
                                  p(x), p(y), p(z), p(valid), n, strides,
                                  kernels._stream(dev))
    kernels._launched("reduce_candidates", rc)
    return x, y, z, valid


def claim(xyz, mask, res, bits):
    """K10 over n instances on the current build; a build that needs a
    claim table at every size gets one."""
    lib = kernels._lib
    if fused(lib):
        return kernels.voxel_claim_batched(xyz, mask, res, bits)
    n, N = xyz.shape[:2]
    strides = kernels._fleet(n, ("xyz", xyz, torch.float32, (N, 3)),
                             ("mask", mask, torch.bool, (N,)),
                             ("res", res, torch.float32, ()))
    table = torch.empty((n, 1 << bits), dtype=torch.int32, device=xyz.device)
    keep = torch.empty((n, N), dtype=torch.bool, device=xyz.device)
    p = kernels._p
    rc = lib.so_voxel_claim(p(xyz), p(mask), N, p(res), bits, p(table),
                            p(keep), n, strides, kernels._stream(xyz.device))
    kernels._launched("voxel_claim", rc)
    return keep


def _record(cfg, n_scans, dev, names, seen, tag=""):
    """Replay ``n_scans`` scans of ``cfg`` on the card, keeping the
    arguments of the last launch of each of ``names`` (K9a and K9b by
    width, K10 under ``tag``), cloned."""
    ds = bench_dataset(n_scans, cfg.sensor.max_points)
    originals = {n: getattr(kernels, n) for n in names}

    def key(name, args):
        if name in ("select_reduced", "reduce_candidates"):
            return (name, args[0].shape[1] if name == "select_reduced"
                    else args[3])
        return (name, tag) if name == "voxel_claim" else name

    def recorder(name):
        def call(*args):
            seen[key(name, args)] = tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
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


def record_paths(dev: torch.device):
    """The recorded arguments: path E's last K9a, K9b (each width), K11b
    and K10 launches, and path V's last K10 launch."""
    seen = {}
    _record(dataclasses.replace(parity_config("os1"), use_edge_features=True),
            SCANS, dev, ("select_reduced", "reduce_candidates", "edge_fit",
                         "voxel_claim"), seen, "edge stream")
    _record(ship_config("vlp16"), SCANS_V, dev, ("voxel_claim",), seen,
            "path V")
    torch.cuda.synchronize()
    return seen


def _copies(t, B):
    """``B`` copies of ``t`` on a leading instance dimension, each its own."""
    return t.expand((B,) + t.shape).contiguous()


def cases(seen, fleets=FLEETS):
    """name -> (launch, check of its outputs against this tree's) at every
    fleet size of ``fleets``."""
    out = {}
    for (_, w), args in sorted((k, v) for k, v in seen.items()
                               if k[0] == "reduce_candidates"):
        pts, slots, q, _, k = args
        for B in fleets:
            rep = [_copies(t, B) for t in (pts, slots, q)]
            out[f"reduce_candidates {w}, B={B}"] = (
                lambda rep=rep, w=w, k=k: reduce_once(*rep, w, k),
                same_valid_planes)
            out[f"reduce_candidates {w} + round 2's {k}, B={B}"] = (
                lambda rep=rep, w=w, k=k: reduce(*rep, w, k),
                lambda a, b: all(same_bits(x, y)
                                 for x, y in zip(a[4:], b[4:])))
    for (_, w), args in sorted((k, v) for k, v in seen.items()
                               if k[0] == "select_reduced"):
        *red, q, k = args
        for B in fleets:
            rep = [torch.cat([t] * B).contiguous() for t in (*red, q)]
            out[f"select_reduced {k} of {w}, B={B}"] = (
                lambda rep=rep, k=k: kernels.select_reduced(*rep, k),
                same_valid_lanes)
    for (_, tag), args in sorted((k, v) for k, v in seen.items()
                                 if k[0] == "voxel_claim"):
        xyz, mask, res, bits = args
        for B in fleets:
            rep = [_copies(t, B) for t in (xyz, mask, res)]
            out[f"voxel_claim {tag} {xyz.shape[0]} x 2^{bits}, B={B}"] = (
                lambda rep=rep, bits=bits: claim(*rep, bits),
                lambda a, b: torch.equal(a, b))
    neigh, sq, nvalid, mask, line_res, min_nb, inlier = seen["edge_fit"]
    for B in fleets:
        rep = [_copies(t, B) for t in (neigh, sq, nvalid, mask, line_res)]
        near = registration.edge_gate_margin_lanes(
            neigh, sq, nvalid, line_res, min_nb, inlier).repeat(B)
        out[f"edge_fit {sq.shape[0]} x {sq.shape[1]}, B={B}"] = (
            lambda rep=rep: kernels.edge_fit_batched(*rep, min_nb, inlier),
            lambda a, b, near=near: same_off_gates(a, b, near))
    return out


def same_bits(a, b) -> bool:
    """Equal to the bit, NaN where NaN."""
    return a.shape == b.shape and bool(((a == b) | ((a != a) & (b != b)))
                                       .all())


def same_valid_planes(a, b) -> bool:
    """K9a's planes ``a`` are ``b``'s in validity and in every valid lane."""
    v = b[3]
    return torch.equal(a[3], v) and all(torch.equal(x[v], y[v])
                                        for x, y in zip(a[:3], b[:3]))


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

    seen = record_paths(dev)
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
