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
:data:`launch_counts` — there and nowhere else.  They take CUDA tensors
only; the dispatching wrappers (``mapstate.octant_lookup``,
``mapstate.knn_select``, ``registration.plane_fit``,
``registration.normal_system``, ``registration.gauss_newton_solve``) send
CPU tensors to the plain versions.
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
           "launch_floor")
# the counted entry points; gn_solve and normal_system are the two modes of
# csrc/normal_system.cu
KERNELS = ("octant_lookup", "knn_select", "plane_fit", "gn_solve",
           "normal_system")
SOURCE_OF = {"gn_solve": "normal_system"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]
# gn_solve runs on one cluster of GN_BLOCKS blocks; each block stages
# ceil(M / GN_BLOCKS) rows (rounded up to 16) of 33 bytes in shared memory,
# at most GN_MAX_ROW_BYTES (csrc/normal_system.cu)
GN_BLOCKS = 8
GN_MAX_ROW_BYTES = 216 * 1024

launch_counts = {name: 0 for name in KERNELS}

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
    for path in sorted(_sources()) + [os.path.join(CSRC, "common.cuh")]:
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
    lib.so_octant_lookup.argtypes = [vp, ci, ci, vp, ci, cf, vp, vp]
    lib.so_knn_select.argtypes = [vp, ci, vp, vp, ci, ci, vp, vp, vp, vp, vp]
    lib.so_plane_fit.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                 vp, vp, vp, vp, vp, vp, vp]
    lib.so_gn_solve.argtypes = [vp, vp, vp, vp, vp, vp, ci, vp, vp, vp,
                                vp, vp, vp, vp, vp, ci, cf, cf, ci,
                                vp, vp, vp]
    lib.so_launch_floor.argtypes = [vp]
    for fn in (lib.so_octant_lookup, lib.so_knn_select, lib.so_plane_fit,
               lib.so_gn_solve, lib.so_launch_floor):
        fn.restype = ci
    _lib = lib
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None,
           device=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


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
                  cell_size: float) -> torch.Tensor:
    """K1 on the card: int32[Q, 8] slot ids (see csrc/octant_lookup.cu)."""
    dev = queries.device
    nq = queries.shape[0]
    _check("queries", queries, torch.float32, (nq, 3))
    _check("keys", keys, torch.int32, device=dev)
    nb, B = keys.shape
    if nb & (nb - 1) or B % 32:
        raise ValueError(f"octant_lookup: need power-of-two buckets and a "
                         f"bucket size that is a multiple of 32, got {nb}x{B}")
    if keys.data_ptr() % 16:
        raise ValueError("octant_lookup: the key table must start on a "
                         "16-byte line (its rows are read as 16-byte vectors)")
    out = torch.empty((nq, 8), dtype=torch.int32, device=dev)
    rc = load().so_octant_lookup(_p(keys), nb, B, _p(queries), nq,
                                 float(cell_size), _p(out), _stream(dev))
    _launched("octant_lookup", rc)
    return out


def knn_select(pts: torch.Tensor, slots: torch.Tensor, queries: torch.Tensor,
               k: int):
    """K2 on the card: (neighbours f32[Q,k,3], sq f32[Q,k], valid bool[Q,k],
    lane int64[Q,k]) (see csrc/knn_select.cu)."""
    dev = queries.device
    nq = queries.shape[0]
    _check("queries", queries, torch.float32, (nq, 3))
    _check("slots", slots, torch.int32, (nq, 8), dev)
    _check("pts", pts, torch.float32, device=dev)
    C = pts.shape[1] // 3
    if pts.shape[1] != 3 * C or not 1 <= C <= 32 or not 1 <= k <= min(
            32, 8 * C):
        raise ValueError(f"knn_select: unsupported cell capacity {C} or k {k}")
    neigh = torch.empty((nq, k, 3), dtype=torch.float32, device=dev)
    sq = torch.empty((nq, k), dtype=torch.float32, device=dev)
    valid = torch.empty((nq, k), dtype=torch.bool, device=dev)
    lane = torch.empty((nq, k), dtype=torch.int64, device=dev)
    rc = load().so_knn_select(_p(pts), C, _p(slots), _p(queries), nq, k,
                              _p(neigh), _p(sq), _p(valid), _p(lane),
                              _stream(dev))
    _launched("knn_select", rc)
    return neigh, sq, valid, lane


def plane_fit(neigh: torch.Tensor, sq: torch.Tensor, nvalid: torch.Tensor,
              mask: torch.Tensor, w_pt: torch.Tensor, q: torch.Tensor,
              plane_res: torch.Tensor):
    """K3 on the card: (normal, d, coeff, valid, code, obs_bins) (see
    csrc/plane_fit.cu)."""
    dev = neigh.device
    nq, k = sq.shape
    _check("neigh", neigh, torch.float32, (nq, k, 3))
    _check("sq", sq, torch.float32, (nq, k), dev)
    _check("nvalid", nvalid, torch.bool, (nq, k), dev)
    _check("mask", mask, torch.bool, (nq,), dev)
    _check("w_pt", w_pt, torch.float32, (nq, 3), dev)
    _check("q", q, torch.float32, (4,), dev)
    _check("plane_res", plane_res, torch.float32, (), dev)
    if k > 16:
        raise ValueError(f"plane_fit: k={k} exceeds the kernel's 16")
    normal = torch.empty((nq, 3), dtype=torch.float32, device=dev)
    d = torch.empty((nq,), dtype=torch.float32, device=dev)
    coeff = torch.empty((nq,), dtype=torch.float32, device=dev)
    valid = torch.empty((nq,), dtype=torch.bool, device=dev)
    code = torch.empty((nq,), dtype=torch.int32, device=dev)
    bins = torch.empty((nq, 3), dtype=torch.int32, device=dev)
    rc = load().so_plane_fit(_p(neigh), _p(sq), _p(nvalid), _p(mask),
                             _p(w_pt), _p(q), _p(plane_res), nq, k,
                             _p(normal), _p(d), _p(coeff), _p(valid),
                             _p(code), _p(bins), _stream(dev))
    _launched("plane_fit", rc)
    return normal, d, coeff, valid, code, bins


def _gn_launch(rows, q, t, a_sq, n_iters, out, first_small, *, obs_bins=None,
               prior=None, hold_min=0, hold_frac=0.0, hold_enabled=None,
               damping=0.0):
    """Check the inputs of csrc/normal_system.cu and launch it; returns the
    C function's code.  ``rows`` = (p_body, normal, d, coeff, valid)."""
    p_body, normal, d, coeff, valid = rows
    dev = p_body.device
    nm = p_body.shape[0]
    _check("p_body", p_body, torch.float32, (nm, 3))
    _check("normal", normal, torch.float32, (nm, 3), dev)
    _check("d", d, torch.float32, (nm,), dev)
    _check("coeff", coeff, torch.float32, (nm,), dev)
    _check("valid", valid, torch.bool, (nm,), dev)
    _check("q", q, torch.float32, (4,), dev)
    _check("t", t, torch.float32, (3,), dev)
    _check("a_sq", a_sq, torch.float32, (), dev)
    if hold_min > 0:
        if obs_bins is None:
            raise ValueError("gn_solve: the axis hold needs obs_bins")
        _check("obs_bins", obs_bins, torch.int32, (nm, 3), dev)
    if prior is not None:
        for name, x, dtype, shape in zip(
                ("prior q", "prior t", "prior information", "prior enabled"),
                prior, (torch.float32,) * 3 + (torch.bool,),
                ((4,), (3,), (6,), ())):
            _check(name, x, dtype, shape, dev)
    if hold_enabled is not None:
        _check("hold_enabled", hold_enabled, torch.bool, (), dev)
    per_block = -(-nm // GN_BLOCKS)
    if -(-per_block // 16) * 16 * 33 > GN_MAX_ROW_BYTES:
        raise ValueError(f"gn_solve: {nm} rows do not fit the shared memory "
                         f"of {GN_BLOCKS} blocks")
    pq, pt, pi, pe = prior if prior is not None else (None,) * 4
    return load().so_gn_solve(
        _p(p_body), _p(normal), _p(d), _p(coeff), _p(valid), _p(obs_bins),
        nm, _p(q), _p(t), _p(a_sq), _p(pq), _p(pt), _p(pi), _p(pe),
        _p(hold_enabled), int(hold_min), float(hold_frac), float(damping),
        int(n_iters), _p(out), _p(first_small), _stream(dev))


def normal_system(p_body: torch.Tensor, normal: torch.Tensor, d: torch.Tensor,
                  coeff: torch.Tensor, valid: torch.Tensor, q: torch.Tensor,
                  t: torch.Tensor, a_sq: torch.Tensor):
    """K4 on the card, n_iters = 0 mode: (H f32[6,6], g f32[6], cost f32[])
    at the pose (q, t) (see csrc/normal_system.cu)."""
    out = torch.empty((43,), dtype=torch.float32, device=p_body.device)
    rc = _gn_launch((p_body, normal, d, coeff, valid), q, t, a_sq, 0, out,
                    None)
    _launched("normal_system", rc)
    return out[:36].view(6, 6), out[36:42], out[42]


def gn_solve(p_body: torch.Tensor, normal: torch.Tensor, d: torch.Tensor,
             coeff: torch.Tensor, valid: torch.Tensor, obs_bins: torch.Tensor,
             q: torch.Tensor, t: torch.Tensor, a_sq: torch.Tensor,
             n_iters: int, damping: float = 1e-4, prior=None,
             hold_min: int = 0, hold_frac: float = 0.005, hold_enabled=None):
    """K4 on the card: ``n_iters`` damped Gauss-Newton iterations in one
    launch.  ``prior`` is None or (q f32[4], t f32[3], information f32[6],
    enabled bool[]); ``hold_min`` > 0 arms the axis hold.  Returns
    (q f32[4], t f32[3], first_small bool[]) (see csrc/normal_system.cu)."""
    if n_iters < 1:
        raise ValueError("gn_solve: n_iters must be >= 1 (n_iters = 0 is "
                         "normal_system)")
    dev = p_body.device
    out = torch.empty((7,), dtype=torch.float32, device=dev)
    small = torch.empty((), dtype=torch.bool, device=dev)
    rc = _gn_launch((p_body, normal, d, coeff, valid), q, t, a_sq, n_iters,
                    out, small, obs_bins=obs_bins, prior=prior,
                    hold_min=hold_min, hold_frac=hold_frac,
                    hold_enabled=hold_enabled, damping=damping)
    _launched("gn_solve", rc)
    return out[:4], out[4:], small


def launch_floor(device) -> None:
    """Launch the empty kernel of csrc/launch_floor.cu (timing only; not
    counted, not on any path)."""
    rc = load().so_launch_floor(_stream(device))
    if rc != 0:
        raise RuntimeError(f"launch_floor: CUDA launch failed with error {rc}")
