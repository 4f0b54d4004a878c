"""Build and bind the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, ``build/libsuperodom_kernels-<hash>.so``
(the hash is of the sources, so an edited source is never served a stale
library), and loaded with ctypes.  The build runs at first use; nothing
here touches nvcc or the card when the module is imported, so the package
imports on a machine without either.

Each launch function below checks device, dtype, shape and contiguity,
allocates its outputs with ``torch.empty``, launches on the current CUDA
stream, raises if the launch was refused, and adds one to its entry of
:data:`launch_counts` — there and nowhere else.  K1-K4, K9a, K10, K11a,
K11b and K12a also take n instances in one launch (``*_batched``: every input
with a leading instance dimension, each instance contiguous, any stride
between them, 0 for one copy shared by every instance); the
single-instance functions are that launch with n = 1.  They take
CUDA tensors only, and raise on a tensor under ``torch.func.vmap``:
``kernel_ops`` registers each entry as a custom operator whose vmap rule
makes the batched launch.  The dispatching wrappers
(``mapstate.octant_lookup``, ``mapstate.knn_select``,
``mapstate.reduce_candidates``, ``mapstate.select_knn_reduced``,
``ops.voxel.voxel_downsample_scatter``,
``frontend.curvature_edge_extraction``, ``registration.plane_fit``,
``registration.edge_fit``, ``registration.normal_system``,
``registration.gauss_newton_solve``, ``inertial._gn_step``,
``inertial._marginal_system``) call those operators for CUDA
tensors and send CPU tensors to the plain versions.  K2's gathered mode
(:func:`knn_select_gathered`, counted as ``knn_select_gathered``) serves
only the library's ``mapstate.select_knn``, which calls it directly: it
has no instance dimension and no operator, and under vmap it raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("octant_lookup", "knn_select", "plane_fit", "normal_system",
           "select_reduced", "voxel_claim", "curvature_edges", "edge_fit",
           "smoother_solve", "launch_floor")
HEADERS = ("common.cuh", "eigh3.cuh")
# the counted entry points; gn_solve and normal_system are the two modes of
# csrc/normal_system.cu, reduce_candidates is csrc/knn_select.cu with the
# planar output, smoother_gn_step and smoother_marginalize the two kernels
# of csrc/smoother_solve.cu
KERNELS = ("octant_lookup", "knn_select", "plane_fit", "gn_solve",
           "normal_system", "reduce_candidates", "select_reduced",
           "voxel_claim", "curvature_edges", "edge_fit", "smoother_gn_step",
           "smoother_marginalize")
# K2's gathered mode: the library's select_knn over candidates the caller
# gathered (mapstate.select_knn); counted apart, launched by no replay path
LIBRARY_KERNELS = ("knn_select_gathered",)
SOURCE_OF = {"gn_solve": "normal_system", "reduce_candidates": "knn_select",
             "knn_select_gathered": "knn_select",
             "smoother_gn_step": "smoother_solve",
             "smoother_marginalize": "smoother_solve"}
# --threads 0: the sources compile side by side, one thread a core
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "--threads", "0"]
# gn_solve runs on one cluster of GN_BLOCKS blocks; each block stages
# ceil(M / GN_BLOCKS) plane rows of 33 bytes and ceil(Me / GN_BLOCKS) edge
# rows of 41 bytes (each count rounded up to 16) in shared memory, at most
# GN_MAX_ROW_BYTES (csrc/normal_system.cu)
GN_BLOCKS = 8
GN_MAX_ROW_BYTES = 216 * 1024
# K10 keeps its claim table in one thread-block cluster's shared memory up
# to 16 blocks x 2^15 slots; larger tables take its global form
# (csrc/voxel_claim.cu)
VOXEL_CLUSTER_MAX_BITS = 19
# K11a stages a tile of CURVATURE_TILE lanes a block, CURVATURE_LANES
# consecutive lanes a thread; N must leave every tile's lane offsets
# (halo included) in 32 bits (csrc/curvature_edges.cu)
CURVATURE_LANES = 3
CURVATURE_TILE = CURVATURE_LANES * 128
CURVATURE_MAX_N = 2**31 - 1 - 2 * CURVATURE_TILE
# the largest window whose GN system K12a holds in one block's shared
# memory (csrc/smoother_solve.cu's layout, whose C entry refuses a larger
# one as well)
SMOOTHER_MAX_WINDOW = 15

launch_counts = {name: 0 for name in KERNELS + LIBRARY_KERNELS}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""


def reset_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _sources():
    return [os.path.join(CSRC, f"{name}.cu") for name in SOURCES]


def _library_path() -> str:
    h = hashlib.sha256()
    for path in sorted(_sources()) + [os.path.join(CSRC, h)
                                      for h in HEADERS]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD, f"libsuperodom_kernels-{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build(verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` (if the library for these sources is not built
    yet) and return the library path.  ``verbose`` adds ``-Xptxas -v`` and
    keeps the compiler's report (registers, spills) in :data:`build_log`."""
    global build_seconds, build_log
    path = _library_path()
    if os.path.exists(path) and not verbose:
        return path
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-I", CSRC, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + proc.stderr[-8000:])
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stderr
    return path


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.so_octant_lookup.argtypes = [vp, ci, ci, ci, ci, vp, ci, cf, vp, ci,
                                    vp, vp]
    lib.so_knn_select.argtypes = [vp, ci, vp, vp, ci, ci, vp, vp, vp, vp, ci,
                                  vp, vp]
    lib.so_plane_fit.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                 vp, vp, vp, vp, vp, vp, ci, vp, vp]
    lib.so_gn_solve.argtypes = [vp, vp, vp, vp, vp, vp, ci, vp, vp, vp,
                                vp, vp, vp, vp, vp, ci, cf, cf, ci,
                                vp, vp, vp, vp, vp, vp, vp, ci, vp, ci, vp,
                                vp]
    lib.so_knn_select_gathered.argtypes = [vp, ci, vp, vp, ci, ci, vp, vp,
                                           vp, vp, vp]
    lib.so_reduce_candidates.argtypes = [vp, ci, vp, vp, ci, ci, ci, vp, vp,
                                         vp, vp, vp, vp, vp, ci, vp, vp]
    lib.so_select_reduced.argtypes = [vp, vp, vp, vp, ci, vp, ci, ci, vp, vp,
                                      vp, vp]
    lib.so_voxel_claim.argtypes = [vp, vp, ci, vp, ci, vp, vp, ci, vp, vp]
    lib.so_voxel_claim_clusters.argtypes = [ci, ci, ci, vp]
    lib.so_curvature_edges.argtypes = [vp, vp, vp, ci, ci, cf, cf, cf, vp, ci,
                                       vp, vp]
    lib.so_edge_fit.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, cf, vp, vp,
                                vp, vp, vp, ci, vp, vp]
    lib.so_smoother_gn_step.argtypes = [vp] * 8 + [ci, vp, ci, vp, vp]
    lib.so_smoother_marginalize.argtypes = [vp] * 8 + [ci, vp, vp]
    lib.so_launch_floor.argtypes = [vp]
    for fn in (lib.so_octant_lookup, lib.so_knn_select,
               lib.so_knn_select_gathered, lib.so_plane_fit,
               lib.so_gn_solve, lib.so_reduce_candidates,
               lib.so_select_reduced, lib.so_voxel_claim,
               lib.so_voxel_claim_clusters,
               lib.so_curvature_edges, lib.so_edge_fit,
               lib.so_smoother_gn_step, lib.so_smoother_marginalize,
               lib.so_launch_floor):
        fn.restype = ci
    _lib = lib
    return lib


def under_vmap(t: torch.Tensor) -> bool:
    """True for a tensor that ``torch.func.vmap`` carries (a batched tensor
    at its outermost functorch level): it has no device pointer, and its
    values are the instances'."""
    return torch._C._functorch.is_batchedtensor(t)


def _check_form(name: str, t: torch.Tensor, dtype: torch.dtype,
                shape=None) -> None:
    if under_vmap(t):
        raise RuntimeError(f"{name}: a kernel was reached under vmap without "
                           f"its rule (kernel_ops registers one per entry)")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_device(name: str, t: torch.Tensor, device=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None,
           device=None) -> None:
    _check_form(name, t, dtype, shape)
    _check_device(name, t, device)


def _instance0(name: str, t: torch.Tensor, n: int) -> torch.Tensor:
    """The first of ``t``'s ``n`` instances; raises if it has not ``n``."""
    if n < 1:
        raise ValueError(f"{name}: a launch takes at least one instance")
    if t.dim() == 0 or t.shape[0] != n:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{n} instances")
    return t[0]


def _check_inst(name: str, t: torch.Tensor, dtype: torch.dtype, n: int,
                shape=None, device=None) -> int:
    """Check a per-instance input of ``n`` instances, ``[n, *shape]``, each
    instance contiguous; return the stride between instances in elements
    (0 where one tensor is shared, as ``expand`` gives it)."""
    _check(name, _instance0(name, t, n), dtype, shape, device)
    return t.stride(0) if n > 1 else 0


def _fleet(n: int, *specs) -> ctypes.Array:
    """Check the inputs of an ``n``-instance launch, each (name, tensor,
    dtype, per-instance shape): every instance count, dtype, shape and
    layout first, then that all lie on the first one's card, so that a
    malformed fleet is refused for its form wherever it lies.  Returns the
    instance strides."""
    for name, t, dtype, shape in specs:
        _check_form(name, _instance0(name, t, n), dtype, shape)
    dev = specs[0][1].device
    for name, t, _, _ in specs:
        _check_device(name, t, dev)
    return _strides(*(t.stride(0) if n > 1 else 0 for _, t, _, _ in specs))


def _strides(*xs) -> ctypes.Array:
    """The instance strides of a launch, as the C entries read them."""
    return (ctypes.c_longlong * len(xs))(*xs)


def _p(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} "
                           f"({torch.cuda.get_device_name()})")
    launch_counts[name] += 1


def octant_lookup(keys: torch.Tensor, queries: torch.Tensor,
                  cell_size: float, bucket_lo: int = 0,
                  nb_total: int = 0) -> torch.Tensor:
    """K1 on the card: int32[Q, 8] slot ids (see csrc/octant_lookup.cu)."""
    return octant_lookup_batched(keys[None], queries[None], cell_size,
                                 bucket_lo, nb_total)[0]


def octant_lookup_batched(keys: torch.Tensor, queries: torch.Tensor,
                          cell_size: float, bucket_lo: int = 0,
                          nb_total: int = 0) -> torch.Tensor:
    """K1 over n instances in one launch: key tables ``[n, NB, B]``,
    queries ``[n, Q, 3]`` -> int32[n, Q, 8], each instance's slot ids into
    its own table.  A shard window: the tables are buckets
    ``[bucket_lo, bucket_lo + NB)`` of tables of ``nb_total`` buckets (0:
    the tables are whole), the slot ids global, -1 outside the window."""
    n = queries.shape[0]
    dev = queries.device
    nq = queries.shape[1] if queries.dim() == 3 else -1
    qs = _check_inst("queries", queries, torch.float32, n, (nq, 3))
    ks = _check_inst("keys", keys, torch.int32, n, device=dev)
    nb, B = keys.shape[1:] if keys.dim() == 3 else (0, 0)
    if keys.dim() != 3 or nb & (nb - 1) or B % 32 or nb < 1:
        raise ValueError(f"octant_lookup: need power-of-two buckets and a "
                         f"bucket size that is a multiple of 32, got "
                         f"{tuple(keys.shape[1:])}")
    if keys.data_ptr() % 16 or ks % 4:
        raise ValueError("octant_lookup: every key table must start on a "
                         "16-byte line (its rows are read as 16-byte "
                         "vectors)")
    nb_total = nb_total or nb
    if nb_total & (nb_total - 1) or not 0 <= bucket_lo <= nb_total - nb \
            or nb_total * B >= 2 ** 31:
        raise ValueError(f"octant_lookup: the window of {nb} buckets at "
                         f"{bucket_lo} does not fit a power-of-two table of "
                         f"{nb_total} buckets of {B} slots")
    # a shard's table may lie on another card than the current one: the
    # launch goes to the card of its tensors and stream
    with torch.cuda.device(dev):
        out = torch.empty((n, nq, 8), dtype=torch.int32, device=dev)
        rc = load().so_octant_lookup(_p(keys), nb, B, bucket_lo, nb_total,
                                     _p(queries), nq, float(cell_size),
                                     _p(out), n, _strides(ks, qs),
                                     _stream(dev))
    _launched("octant_lookup", rc)
    return out


def _check_candidates(name: str, pts, slots, queries, k: int):
    """The shared input checks of K2 and K9a over n instances; returns (n,
    Q, the cell capacity, the instance strides)."""
    n = queries.shape[0]
    dev = queries.device
    nq = queries.shape[1] if queries.dim() == 3 else -1
    qs = _check_inst("queries", queries, torch.float32, n, (nq, 3))
    ss = _check_inst("slots", slots, torch.int32, n, (nq, 8), dev)
    ps = _check_inst("pts", pts, torch.float32, n, device=dev)
    C = pts.shape[-1] // 3
    if pts.dim() != 3 or pts.shape[-1] != 3 * C or not 1 <= C <= 32 \
            or not 1 <= k <= min(32, 8 * C):
        raise ValueError(f"{name}: unsupported cell capacity {C} or k {k}")
    return n, nq, C, _strides(ps, ss, qs)


def knn_select(pts: torch.Tensor, slots: torch.Tensor, queries: torch.Tensor,
               k: int):
    """K2 on the card: (neighbours f32[Q,k,3], sq f32[Q,k], valid bool[Q,k],
    lane int64[Q,k]) (see csrc/knn_select.cu)."""
    return tuple(o[0] for o in knn_select_batched(pts[None], slots[None],
                                                  queries[None], k))


def knn_select_batched(pts: torch.Tensor, slots: torch.Tensor,
                       queries: torch.Tensor, k: int):
    """K2 over n instances in one launch: point tables ``[n, rows, 3C]``,
    slots ``[n, Q, 8]`` (into the instance's own table), queries
    ``[n, Q, 3]`` -> K2's outputs with a leading instance dimension."""
    dev = queries.device
    n, nq, C, strides = _check_candidates("knn_select", pts, slots, queries,
                                          k)
    neigh = torch.empty((n, nq, k, 3), dtype=torch.float32, device=dev)
    sq = torch.empty((n, nq, k), dtype=torch.float32, device=dev)
    valid = torch.empty((n, nq, k), dtype=torch.bool, device=dev)
    lane = torch.empty((n, nq, k), dtype=torch.int64, device=dev)
    rc = load().so_knn_select(_p(pts), C, _p(slots), _p(queries), nq, k,
                              _p(neigh), _p(sq), _p(valid), _p(lane), n,
                              strides, _stream(dev))
    _launched("knn_select", rc)
    return neigh, sq, valid, lane


def knn_select_gathered(cand: torch.Tensor, cvalid: torch.Tensor,
                        queries: torch.Tensor, k: int):
    """K2's gathered mode on the card: the k nearest of the candidates
    ``cand`` f32[Q,8,3C] whose lane mask ``cvalid`` bool[Q,8C] is set ->
    (neighbours f32[Q,k,3], sq f32[Q,k], valid bool[Q,k], lane
    int64[Q,k]) (see csrc/knn_select.cu)."""
    dev = queries.device
    nq = queries.shape[0] if queries.dim() == 2 else -1
    _check("queries", queries, torch.float32, (nq, 3))
    _check("cand", cand, torch.float32, device=dev)
    C = cand.shape[-1] // 3 if cand.dim() == 3 else 0
    _check("cvalid", cvalid, torch.bool, (nq, 8 * C), dev)
    if tuple(cand.shape) != (nq, 8, 3 * C) or not 1 <= C <= 32 \
            or not 1 <= k <= min(32, 8 * C) or nq * 8 >= 2 ** 31:
        raise ValueError(f"knn_select_gathered: unsupported candidates "
                         f"{tuple(cand.shape)} for {nq} queries, or k {k}")
    neigh = torch.empty((nq, k, 3), dtype=torch.float32, device=dev)
    sq = torch.empty((nq, k), dtype=torch.float32, device=dev)
    valid = torch.empty((nq, k), dtype=torch.bool, device=dev)
    lane = torch.empty((nq, k), dtype=torch.int64, device=dev)
    rc = load().so_knn_select_gathered(_p(cand), C, _p(cvalid), _p(queries),
                                       nq, k, _p(neigh), _p(sq), _p(valid),
                                       _p(lane), _stream(dev))
    _launched("knn_select_gathered", rc)
    return neigh, sq, valid, lane


def reduce_candidates(pts: torch.Tensor, slots: torch.Tensor,
                      queries: torch.Tensor, w: int, k: int):
    """K9a on the card: the ``w`` nearest candidates of each query as planes
    (x f32[Q,w], y, z, valid bool[Q,w]), then the ``k`` nearest of those
    lanes as K9b selects them (neighbours f32[Q,k,3], sq f32[Q,k], valid
    bool[Q,k]) (see csrc/knn_select.cu)."""
    return tuple(o[0] for o in reduce_candidates_batched(
        pts[None], slots[None], queries[None], w, k))


def reduce_candidates_batched(pts: torch.Tensor, slots: torch.Tensor,
                              queries: torch.Tensor, w: int, k: int):
    """K9a over n instances in one launch (inputs as
    :func:`knn_select_batched`'s) -> K9a's seven outputs, each with a
    leading instance dimension."""
    dev = queries.device
    n, nq, C, strides = _check_candidates("reduce_candidates", pts, slots,
                                          queries, w)
    if not 1 <= k <= w:
        raise ValueError(f"reduce_candidates: need 1 <= k <= width, got k "
                         f"{k}, width {w}")
    x, y, z = (torch.empty((n, nq, w), dtype=torch.float32, device=dev)
               for _ in range(3))
    valid = torch.empty((n, nq, w), dtype=torch.bool, device=dev)
    neigh = torch.empty((n, nq, k, 3), dtype=torch.float32, device=dev)
    sq = torch.empty((n, nq, k), dtype=torch.float32, device=dev)
    nvalid = torch.empty((n, nq, k), dtype=torch.bool, device=dev)
    rc = load().so_reduce_candidates(_p(pts), C, _p(slots), _p(queries), nq,
                                     w, k, _p(x), _p(y), _p(z), _p(valid),
                                     _p(neigh), _p(sq), _p(nvalid), n,
                                     strides, _stream(dev))
    _launched("reduce_candidates", rc)
    return x, y, z, valid, neigh, sq, nvalid


def select_reduced(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                   valid: torch.Tensor, queries: torch.Tensor, k: int):
    """K9b on the card: the ``k`` nearest of each query's reduced lanes,
    (neighbours f32[Q,k,3], sq f32[Q,k], valid bool[Q,k]) (see
    csrc/select_reduced.cu).  Every input is per query, so n instances
    are one launch over their n * Q queries flattened."""
    dev = queries.device
    nq = queries.shape[0]
    _check("queries", queries, torch.float32, (nq, 3))
    w = x.shape[1] if x.dim() == 2 else -1
    for name, t in (("x", x), ("y", y), ("z", z)):
        _check(name, t, torch.float32, (nq, w), dev)
    _check("valid", valid, torch.bool, (nq, w), dev)
    if not 1 <= k <= w <= 32:
        raise ValueError(f"select_reduced: need 1 <= k <= width <= 32, got "
                         f"k {k}, width {w}")
    neigh = torch.empty((nq, k, 3), dtype=torch.float32, device=dev)
    sq = torch.empty((nq, k), dtype=torch.float32, device=dev)
    nvalid = torch.empty((nq, k), dtype=torch.bool, device=dev)
    rc = load().so_select_reduced(_p(x), _p(y), _p(z), _p(valid), w,
                                  _p(queries), nq, k, _p(neigh), _p(sq),
                                  _p(nvalid), _stream(dev))
    _launched("select_reduced", rc)
    return neigh, sq, nvalid


def voxel_claim(xyz: torch.Tensor, mask: torch.Tensor, res: torch.Tensor,
                table_bits: int) -> torch.Tensor:
    """K10 on the card: the keep-mask bool[N] of scatter-claim voxel
    thinning over a table of ``1 << table_bits`` slots; ``res`` is a 0-d
    float32 tensor on the card (see csrc/voxel_claim.cu)."""
    return voxel_claim_batched(xyz[None], mask[None], res[None],
                               table_bits)[0]


def voxel_claim_batched(xyz: torch.Tensor, mask: torch.Tensor,
                        res: torch.Tensor, table_bits: int) -> torch.Tensor:
    """K10 over n instances in one launch: clouds ``[n, N, 3]``, masks
    ``[n, N]``, resolutions ``[n]`` -> bool[n, N], each instance's
    keep-mask from a claim table of its own — in a thread-block cluster's
    shared memory up to 2^:data:`VOXEL_CLUSTER_MAX_BITS` slots, else n
    global tables of ``1 << table_bits`` int32 scratch."""
    dev = xyz.device
    n = xyz.shape[0]
    N = xyz.shape[1] if xyz.dim() == 3 else -1
    strides = _fleet(n, ("xyz", xyz, torch.float32, (N, 3)),
                     ("mask", mask, torch.bool, (N,)),
                     ("res", res, torch.float32, ()))
    if not 4 <= table_bits <= 30:
        raise ValueError(f"voxel_claim: table_bits {table_bits} outside 4..30")
    table = None
    if table_bits > VOXEL_CLUSTER_MAX_BITS:
        table = torch.empty((n, 1 << table_bits), dtype=torch.int32,
                            device=dev)
    keep = torch.empty((n, N), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = load().so_voxel_claim(_p(xyz), _p(mask), N, _p(res), table_bits,
                                   _p(table), _p(keep), n, strides,
                                   _stream(dev))
    _launched("voxel_claim", rc)
    return keep


def voxel_claim_clusters(table_bits: int, n: int, n_inst: int = 1,
                         device=None):
    """K10's cluster form for ``n_inst`` instances of ``n`` lanes and a
    table of ``1 << table_bits`` slots on the card: (blocks a cluster,
    shared memory bytes a block, the clusters of that shape the card holds
    at once); (0, 0, 0) above 2^:data:`VOXEL_CLUSTER_MAX_BITS` slots (the
    global form)."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        rc = load().so_voxel_claim_clusters(int(table_bits), int(n),
                                            int(n_inst), out)
    if rc != 0:
        raise RuntimeError(f"voxel_claim_clusters: CUDA error {rc}")
    return tuple(out)


def curvature_edges(xyz: torch.Tensor, ring: torch.Tensor, mask: torch.Tensor,
                    half_window: int, threshold: float,
                    min_range: float) -> torch.Tensor:
    """K11a on the card: the edge mask bool[N] of the curvature stencil
    (see csrc/curvature_edges.cu)."""
    return curvature_edges_batched(xyz[None], ring[None], mask[None],
                                   half_window, threshold, min_range)[0]


def curvature_edges_batched(xyz: torch.Tensor, ring: torch.Tensor,
                            mask: torch.Tensor, half_window: int,
                            threshold: float,
                            min_range: float) -> torch.Tensor:
    """K11a over n instances in one launch: clouds ``[n, N, 3]``, rings and
    masks ``[n, N]`` -> bool[n, N]; each instance's stencil wraps within
    its own N lanes."""
    dev = xyz.device
    n = xyz.shape[0]
    N = xyz.shape[1] if xyz.dim() == 3 else -1
    strides = _fleet(n, ("xyz", xyz, torch.float32, (N, 3)),
                     ("ring", ring, torch.int32, (N,)),
                     ("mask", mask, torch.bool, (N,)))
    if not 1 <= half_window <= 16:
        raise ValueError(f"curvature_edges: half_window {half_window} "
                         f"outside 1..16")
    if N > CURVATURE_MAX_N:
        raise ValueError(f"curvature_edges: {N} lanes, at most "
                         f"{CURVATURE_MAX_N}")
    out = torch.empty((n, N), dtype=torch.bool, device=dev)
    rc = load().so_curvature_edges(
        _p(xyz), _p(ring), _p(mask), N, int(half_window),
        float(2.0 * half_window), float(threshold), float(min_range),
        _p(out), n, strides, _stream(dev))
    _launched("curvature_edges", rc)
    return out


def edge_fit(neigh: torch.Tensor, sq: torch.Tensor, nvalid: torch.Tensor,
             mask: torch.Tensor, line_res: torch.Tensor, min_neighbors: int,
             max_dist_inlier: float):
    """K11b on the card: (a f32[M,3], b f32[M,3], coeff f32[M], valid
    bool[M], code i32[M]) (see csrc/edge_fit.cu)."""
    return tuple(o[0] for o in edge_fit_batched(
        neigh[None], sq[None], nvalid[None], mask[None], line_res[None],
        min_neighbors, max_dist_inlier))


def edge_fit_batched(neigh: torch.Tensor, sq: torch.Tensor,
                     nvalid: torch.Tensor, mask: torch.Tensor,
                     line_res: torch.Tensor, min_neighbors: int,
                     max_dist_inlier: float):
    """K11b over n instances in one launch over their n x M correspondences
    flattened: neighbourhoods ``[n, M, k, 3]``, distances and validity
    ``[n, M, k]``, masks ``[n, M]``, line resolutions ``[n]`` -> K11b's
    outputs with a leading instance dimension."""
    dev = neigh.device
    n = neigh.shape[0]
    nq, k = sq.shape[1:] if sq.dim() == 3 else (-1, -1)
    strides = _fleet(n, ("neigh", neigh, torch.float32, (nq, k, 3)),
                     ("sq", sq, torch.float32, (nq, k)),
                     ("nvalid", nvalid, torch.bool, (nq, k)),
                     ("mask", mask, torch.bool, (nq,)),
                     ("line_res", line_res, torch.float32, ()))
    if not 2 <= k <= 16:
        raise ValueError(f"edge_fit: k={k} outside the kernel's 2..16")
    a, b = (torch.empty((n, nq, 3), dtype=torch.float32, device=dev)
            for _ in range(2))
    coeff = torch.empty((n, nq), dtype=torch.float32, device=dev)
    valid = torch.empty((n, nq), dtype=torch.bool, device=dev)
    code = torch.empty((n, nq), dtype=torch.int32, device=dev)
    rc = load().so_edge_fit(_p(neigh), _p(sq), _p(nvalid), _p(mask),
                            _p(line_res), nq, k, int(min_neighbors),
                            float(max_dist_inlier ** 2), _p(a), _p(b),
                            _p(coeff), _p(valid), _p(code), n, strides,
                            _stream(dev))
    _launched("edge_fit", rc)
    return a, b, coeff, valid, code


def plane_fit(neigh: torch.Tensor, sq: torch.Tensor, nvalid: torch.Tensor,
              mask: torch.Tensor, w_pt: torch.Tensor, q: torch.Tensor,
              plane_res: torch.Tensor):
    """K3 on the card: (normal, d, coeff, valid, code, obs_bins) (see
    csrc/plane_fit.cu)."""
    return tuple(o[0] for o in plane_fit_batched(
        *(t[None] for t in (neigh, sq, nvalid, mask, w_pt, q, plane_res))))


def plane_fit_batched(neigh: torch.Tensor, sq: torch.Tensor,
                      nvalid: torch.Tensor, mask: torch.Tensor,
                      w_pt: torch.Tensor, q: torch.Tensor,
                      plane_res: torch.Tensor):
    """K3 over n instances in one launch: each input with a leading
    instance dimension (``q`` [n, 4], ``plane_res`` [n]) -> K3's outputs
    with one."""
    dev = neigh.device
    n = neigh.shape[0]
    nq, k = sq.shape[1:] if sq.dim() == 3 else (-1, -1)
    strides = _fleet(n, ("neigh", neigh, torch.float32, (nq, k, 3)),
                     ("sq", sq, torch.float32, (nq, k)),
                     ("nvalid", nvalid, torch.bool, (nq, k)),
                     ("mask", mask, torch.bool, (nq,)),
                     ("w_pt", w_pt, torch.float32, (nq, 3)),
                     ("q", q, torch.float32, (4,)),
                     ("plane_res", plane_res, torch.float32, ()))
    if k > 16:
        raise ValueError(f"plane_fit: k={k} exceeds the kernel's 16")
    normal = torch.empty((n, nq, 3), dtype=torch.float32, device=dev)
    d = torch.empty((n, nq), dtype=torch.float32, device=dev)
    coeff = torch.empty((n, nq), dtype=torch.float32, device=dev)
    valid = torch.empty((n, nq), dtype=torch.bool, device=dev)
    code = torch.empty((n, nq), dtype=torch.int32, device=dev)
    bins = torch.empty((n, nq, 3), dtype=torch.int32, device=dev)
    rc = load().so_plane_fit(_p(neigh), _p(sq), _p(nvalid), _p(mask),
                             _p(w_pt), _p(q), _p(plane_res), nq, k,
                             _p(normal), _p(d), _p(coeff), _p(valid),
                             _p(code), _p(bins), n, strides, _stream(dev))
    _launched("plane_fit", rc)
    return normal, d, coeff, valid, code, bins


def _gn_launch(rows, q, t, a_sq, n_iters, out, first_small, *, obs_bins=None,
               prior=None, hold_min=0, hold_frac=0.0, hold_enabled=None,
               damping=0.0, edges=None, a_sq_e=None):
    """Check the inputs of csrc/normal_system.cu over n instances (every
    tensor with a leading instance dimension) and launch it; returns the C
    function's code.  ``rows`` = (p_body, normal, d, coeff, valid);
    ``edges`` = None or (p_body, a, b, coeff, valid) with ``a_sq_e`` their
    Tukey support."""
    p_body, normal, d, coeff, valid = rows
    dev = p_body.device
    n = p_body.shape[0]
    nm = p_body.shape[1] if p_body.dim() == 3 else -1
    ne = 0
    stride = dict.fromkeys(range(20), 0)  # so_gn_solve's input order
    if edges is not None:
        e_p, e_a, e_b, e_c, e_v = edges
        ne = e_p.shape[1] if e_p.dim() == 3 else -1
        for i, name, x in ((14, "edge p_body", e_p), (15, "edge a", e_a),
                           (16, "edge b", e_b)):
            stride[i] = _check_inst(name, x, torch.float32, n, (ne, 3), dev)
        stride[17] = _check_inst("edge coeff", e_c, torch.float32, n, (ne,),
                                 dev)
        stride[18] = _check_inst("edge valid", e_v, torch.bool, n, (ne,),
                                 dev)
        stride[19] = _check_inst("a_sq_e", a_sq_e, torch.float32, n, (),
                                 dev)
    stride[0] = _check_inst("p_body", p_body, torch.float32, n, (nm, 3))
    stride[1] = _check_inst("normal", normal, torch.float32, n, (nm, 3), dev)
    stride[2] = _check_inst("d", d, torch.float32, n, (nm,), dev)
    stride[3] = _check_inst("coeff", coeff, torch.float32, n, (nm,), dev)
    stride[4] = _check_inst("valid", valid, torch.bool, n, (nm,), dev)
    stride[6] = _check_inst("q", q, torch.float32, n, (4,), dev)
    stride[7] = _check_inst("t", t, torch.float32, n, (3,), dev)
    stride[8] = _check_inst("a_sq", a_sq, torch.float32, n, (), dev)
    if hold_min > 0:
        if obs_bins is None:
            raise ValueError("gn_solve: the axis hold needs obs_bins")
        stride[5] = _check_inst("obs_bins", obs_bins, torch.int32, n,
                                (nm, 3), dev)
    if prior is not None:
        for i, name, x, dtype, shape in zip(
                (9, 10, 11, 12),
                ("prior q", "prior t", "prior information", "prior enabled"),
                prior, (torch.float32,) * 3 + (torch.bool,),
                ((4,), (3,), (6,), ())):
            stride[i] = _check_inst(name, x, dtype, n, shape, dev)
    if hold_enabled is not None:
        stride[13] = _check_inst("hold_enabled", hold_enabled, torch.bool, n,
                                 (), dev)
    if gn_staged_bytes(nm, ne) > GN_MAX_ROW_BYTES:
        raise ValueError(f"gn_solve: {nm} plane and {ne} edge rows do not "
                         f"fit the shared memory of {GN_BLOCKS} blocks")
    pq, pt, pi, pe = prior if prior is not None else (None,) * 4
    e_p, e_a, e_b, e_c, e_v = edges if ne else (None,) * 5
    return load().so_gn_solve(
        _p(p_body), _p(normal), _p(d), _p(coeff), _p(valid), _p(obs_bins),
        nm, _p(q), _p(t), _p(a_sq), _p(pq), _p(pt), _p(pi), _p(pe),
        _p(hold_enabled), int(hold_min), float(hold_frac), float(damping),
        int(n_iters), _p(out), _p(first_small), _p(e_p), _p(e_a), _p(e_b),
        _p(e_c), _p(e_v), ne, _p(a_sq_e if ne else None), n,
        _strides(*stride.values()), _stream(dev))


def gn_staged_bytes(n_planes: int, n_edges: int) -> int:
    """Shared memory one block of csrc/normal_system.cu stages."""
    def rows(n):
        return -(-(-(-n // GN_BLOCKS)) // 16) * 16
    return rows(n_planes) * 33 + rows(n_edges) * 41


def _as_instance(x):
    """A single launch's argument as the one instance of a batched launch
    (None stays None; a tuple of tensors maps element by element)."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_as_instance(e) for e in x)
    return x[None]


def normal_system(p_body: torch.Tensor, normal: torch.Tensor, d: torch.Tensor,
                  coeff: torch.Tensor, valid: torch.Tensor, q: torch.Tensor,
                  t: torch.Tensor, a_sq: torch.Tensor, edges=None,
                  a_sq_e=None):
    """K4 on the card, n_iters = 0 mode: f32[43], H (36, row-major), g (6)
    and cost at the pose (q, t), of the plane rows and the ``edges`` rows
    (None or (p_body, a, b, coeff, valid), Tukey support ``a_sq_e``) (see
    csrc/normal_system.cu).  :func:`registration.normal_system` splits
    it."""
    return normal_system_batched(
        *_as_instance((p_body, normal, d, coeff, valid, q, t, a_sq)),
        _as_instance(edges), _as_instance(a_sq_e))[0]


def normal_system_batched(p_body, normal, d, coeff, valid, q, t, a_sq,
                          edges=None, a_sq_e=None) -> torch.Tensor:
    """K4's n_iters = 0 mode over n instances in one launch (every input
    with a leading instance dimension) -> f32[n, 43]: each instance's H
    (36, row-major), g (6) and cost."""
    n = p_body.shape[0]
    out = torch.empty((n, 43), dtype=torch.float32, device=p_body.device)
    rc = _gn_launch((p_body, normal, d, coeff, valid), q, t, a_sq, 0, out,
                    None, edges=edges, a_sq_e=a_sq_e)
    _launched("normal_system", rc)
    return out


def gn_solve(p_body: torch.Tensor, normal: torch.Tensor, d: torch.Tensor,
             coeff: torch.Tensor, valid: torch.Tensor, obs_bins: torch.Tensor,
             q: torch.Tensor, t: torch.Tensor, a_sq: torch.Tensor,
             n_iters: int, damping: float = 1e-4, prior=None,
             hold_min: int = 0, hold_frac: float = 0.005, hold_enabled=None,
             edges=None, a_sq_e=None):
    """K4 on the card: ``n_iters`` damped Gauss-Newton iterations in one
    launch.  ``prior`` is None or (q f32[4], t f32[3], information f32[6],
    enabled bool[]); ``hold_min`` > 0 arms the axis hold; ``edges`` is None
    or the edge rows (p_body, a, b, coeff, valid) with Tukey support
    ``a_sq_e``.  Returns (f32[7]: q and t, first_small bool[]) (see
    csrc/normal_system.cu)."""
    out, small = gn_solve_batched(
        *_as_instance((p_body, normal, d, coeff, valid, obs_bins, q, t, a_sq)),
        n_iters, damping, _as_instance(prior), hold_min, hold_frac,
        _as_instance(hold_enabled), _as_instance(edges), _as_instance(a_sq_e))
    return out[0], small[0]


def gn_solve_batched(p_body, normal, d, coeff, valid, obs_bins, q, t, a_sq,
                     n_iters: int, damping: float = 1e-4, prior=None,
                     hold_min: int = 0, hold_frac: float = 0.005,
                     hold_enabled=None, edges=None, a_sq_e=None):
    """K4 over n instances in one launch, one thread-block cluster each
    (every tensor with a leading instance dimension) -> (f32[n, 7]: each
    instance's q and t, first_small bool[n])."""
    if n_iters < 1:
        raise ValueError("gn_solve: n_iters must be >= 1 (n_iters = 0 is "
                         "normal_system)")
    dev = p_body.device
    n = p_body.shape[0]
    out = torch.empty((n, 7), dtype=torch.float32, device=dev)
    small = torch.empty((n,), dtype=torch.bool, device=dev)
    rc = _gn_launch((p_body, normal, d, coeff, valid), q, t, a_sq, n_iters,
                    out, small, obs_bins=obs_bins, prior=prior,
                    hold_min=hold_min, hold_frac=hold_frac,
                    hold_enabled=hold_enabled, damping=damping,
                    edges=edges, a_sq_e=a_sq_e)
    _launched("gn_solve", rc)
    return out, small


def smoother_gn_step(J_pr, r_pr, J_pair, r_pair, prior_info, r0, prior_gate,
                     T) -> torch.Tensor:
    """K12a on the card: one smoother GN iteration's increment f32[W, 15]
    (see csrc/smoother_solve.cu and
    :func:`inertial._gn_step_reference`)."""
    return smoother_gn_step_batched(*(x[None] for x in (
        J_pr, r_pr, J_pair, r_pair, prior_info, r0, prior_gate, T)))[0]


def smoother_gn_step_batched(J_pr, r_pr, J_pair, r_pair, prior_info, r0,
                             prior_gate, T) -> torch.Tensor:
    """K12a's GN step over n instances in one launch, one block each:
    factors ``J_pr`` [n, W, 6, 15], ``r_pr`` [n, W, 6], ``J_pair``
    [n, W - 1, 15, 30], ``r_pair`` [n, W - 1, 15], the marginal prior
    ``prior_info`` [n, 15, 15], ``r0`` [n, 15], ``prior_gate`` [n], the
    bias map ``T`` [n, 15W, 15W] (a stride of 0: one map for the fleet) ->
    f32[n, W, 15].  W comes from the shapes; a window whose system does
    not fit one block's shared memory is refused."""
    dev = J_pr.device
    n = J_pr.shape[0]
    w = J_pr.shape[1] if J_pr.dim() == 4 else -1
    if w > SMOOTHER_MAX_WINDOW:
        raise ValueError(f"smoother_gn_step: a window of {w} states does not "
                         f"fit one block's shared memory (at most "
                         f"{SMOOTHER_MAX_WINDOW})")
    f32 = torch.float32
    strides = _fleet(n, ("J_pr", J_pr, f32, (w, 6, 15)),
                     ("r_pr", r_pr, f32, (w, 6)),
                     ("J_pair", J_pair, f32, (w - 1, 15, 30)),
                     ("r_pair", r_pair, f32, (w - 1, 15)),
                     ("prior_info", prior_info, f32, (15, 15)),
                     ("r0", r0, f32, (15,)),
                     ("prior_gate", prior_gate, f32, ()),
                     ("T", T, f32, (15 * w, 15 * w)))
    delta = torch.empty((n, w, 15), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = load().so_smoother_gn_step(
            _p(J_pr), _p(r_pr), _p(J_pair), _p(r_pair), _p(prior_info),
            _p(r0), _p(prior_gate), _p(T), w, _p(delta), n, strides,
            _stream(dev))
    _launched("smoother_gn_step", rc)
    return delta


def smoother_marginalize(Jp, rp, J6, r6, prior_info, r0):
    """K12a on the card: the marginalisation's (info f32[15, 15], delta
    f32[15]) (see csrc/smoother_solve.cu and
    :func:`inertial._marginal_system_reference`)."""
    return tuple(o[0] for o in smoother_marginalize_batched(
        *(x[None] for x in (Jp, rp, J6, r6, prior_info, r0))))


def smoother_marginalize_batched(Jp, rp, J6, r6, prior_info, r0):
    """K12a's marginalisation over n instances in one launch, one block
    each: ``Jp`` [n, 15, 30], ``rp`` [n, 15], ``J6`` [n, 6, 15], ``r6``
    [n, 6], ``prior_info`` [n, 15, 15], ``r0`` [n, 15] -> (info
    f32[n, 15, 15], delta f32[n, 15])."""
    dev = Jp.device
    n = Jp.shape[0]
    f32 = torch.float32
    strides = _fleet(n, ("Jp", Jp, f32, (15, 30)), ("rp", rp, f32, (15,)),
                     ("J6", J6, f32, (6, 15)), ("r6", r6, f32, (6,)),
                     ("prior_info", prior_info, f32, (15, 15)),
                     ("r0", r0, f32, (15,)))
    info = torch.empty((n, 15, 15), dtype=f32, device=dev)
    delta = torch.empty((n, 15), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = load().so_smoother_marginalize(
            _p(Jp), _p(rp), _p(J6), _p(r6), _p(prior_info), _p(r0),
            _p(info), _p(delta), n, strides, _stream(dev))
    _launched("smoother_marginalize", rc)
    return info, delta


def launch_floor(device) -> None:
    """Launch the empty kernel of csrc/launch_floor.cu (timing only; not
    counted, not on any path)."""
    rc = load().so_launch_floor(_stream(device))
    if rc != 0:
        raise RuntimeError(f"launch_floor: CUDA launch failed with error {rc}")
