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
``registration.normal_system``) send CPU tensors to the plain versions.
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
KERNELS = ("octant_lookup", "knn_select", "plane_fit", "normal_system")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

launch_counts = {name: 0 for name in KERNELS}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""


def reset_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _sources():
    return [os.path.join(CSRC, f"{name}.cu") for name in KERNELS]


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
    lib.so_normal_system.argtypes = [vp, vp, vp, vp, vp, ci, vp, vp, vp, vp,
                                     vp]
    for fn in (lib.so_octant_lookup, lib.so_knn_select, lib.so_plane_fit,
               lib.so_normal_system):
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


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


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
    if pts.shape[1] != 3 * C or 8 * C > 256 or not 1 <= k <= 8 * C:
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


_TRIU = [(i, j) for i in range(6) for j in range(i, 6)]


def normal_system(p_body: torch.Tensor, normal: torch.Tensor, d: torch.Tensor,
                  coeff: torch.Tensor, valid: torch.Tensor, q: torch.Tensor,
                  t: torch.Tensor, a_sq: torch.Tensor):
    """K4 on the card: (H f32[6,6], g f32[6], cost f32[]) (see
    csrc/normal_system.cu)."""
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
    out = torch.empty((28,), dtype=torch.float32, device=dev)
    rc = load().so_normal_system(_p(p_body), _p(normal), _p(d), _p(coeff),
                                 _p(valid), nm, _p(q), _p(t), _p(a_sq),
                                 _p(out), _stream(dev))
    _launched("normal_system", rc)
    if dev not in _SYM:
        _SYM[dev] = torch.tensor(
            [_TRIU.index((min(i, j), max(i, j))) for i in range(6)
             for j in range(6)], device=dev)
    return out[_SYM[dev]].reshape(6, 6), out[21:27], out[27]


_SYM: dict = {}  # device -> index of each H entry in the upper triangle
