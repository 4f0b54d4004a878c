"""Host IMU buffer and prior-map thinning: ctypes bindings for the
repository's native runtime.

The C++ source is this package's ``csrc/native_loader.cpp``, a byte-for-byte
copy of the JAX package's native loader (held equal by
``tests/test_torch_host.py``).  It sits apart from the CUDA kernels and is
built with the host C++ compiler into this package's ``build/`` directory
at first use.  The library's name carries a hash of the source, the
compiler, its flags and what ``-march=native`` means on this host, so a
library built on another CPU is never loaded.  A failed build raises for
the IMU buffer; :func:`voxel_downsample`, a host utility of the prior-map
load, keeps the JAX package's numpy branch for a host without the
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "native_loader.cpp")
_BUILD = os.path.join(_PKG, "build")
# the flags of the JAX package's native Makefile, so both builds compute alike
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-march=native"]

_lib: Optional[ctypes.CDLL] = None


def _library_path(cxx: str) -> str:
    # the compiler's predefined macros under these flags name the target
    # CPU and every instruction set -march=native turns on
    proc = subprocess.run([cxx, *_CXXFLAGS, "-dM", "-E", "-x", "c++", "-"],
                          input="", capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} cannot name its target:\n"
                           f"{proc.stderr[-4000:]}")
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join([cxx, *_CXXFLAGS]).encode())
    h.update(proc.stdout.encode())
    return os.path.join(_BUILD, f"libsuperodom_native-{h.hexdigest()[:16]}.so")


def _build(cxx: str, path: str) -> None:
    os.makedirs(_BUILD, exist_ok=True)
    # build to a private name, then rename: concurrent test workers may
    # build at once, and a half-written library must never be loaded
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *_CXXFLAGS, "-shared", "-o", tmp, _SRC],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {_SRC} failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    cxx = os.environ.get("CXX", "g++")
    path = _library_path(cxx)
    if not os.path.exists(path):
        _build(cxx, path)
    lib = ctypes.CDLL(path)
    i64, i32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    vp = ctypes.c_void_p
    lib.so_imu_buffer_new.restype = vp
    lib.so_imu_buffer_new.argtypes = [i64]
    lib.so_imu_buffer_free.argtypes = [vp]
    lib.so_imu_buffer_set_conditioning.argtypes = [vp, f64p, f64p, f64]
    lib.so_imu_buffer_add.argtypes = [vp, f64, f32p, f32p]
    lib.so_imu_buffer_static_init.restype = i32
    lib.so_imu_buffer_static_init.argtypes = [vp, f64, f64p]
    lib.so_imu_buffer_size.restype = i64
    lib.so_imu_buffer_size.argtypes = [vp]
    lib.so_imu_buffer_sync.restype = i32
    lib.so_imu_buffer_sync.argtypes = [vp, f64, f64]
    lib.so_imu_buffer_window.restype = i64
    lib.so_imu_buffer_window.argtypes = [vp, f64, f64, i64, f64p, f32p, f32p,
                                         f32p]
    lib.so_voxel_downsample.restype = i64
    lib.so_voxel_downsample.argtypes = [f32p, i64, f64, f32p]
    _lib = lib
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def voxel_downsample(xyz: np.ndarray, res: float) -> np.ndarray:
    """Per-voxel centroids of ``xyz`` at ``res`` (the prior map's host
    thinning): the native hash grid, or where the library cannot be built
    the numpy centroid per voxel."""
    try:
        lib = load()
    except (OSError, RuntimeError):
        lib = None
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    if lib is not None:
        out = np.empty((n, 3), np.float32)
        m = lib.so_voxel_downsample(_fp(xyz), n, res, _fp(out))
        return out[:m].copy()
    keys = np.floor(xyz / res).astype(np.int64)
    _, inv, cnt = np.unique(keys, axis=0, return_inverse=True,
                            return_counts=True)
    sums = np.zeros((len(cnt), 3), np.float64)
    np.add.at(sums, inv, xyz)
    return (sums / cnt[:, None]).astype(np.float32)


class ImuBuffer:
    """Time-indexed bounded IMU buffer: raw-sample conditioning into the
    laser frame, gyro orientation chain, static initialization and scan
    synchronization (reference MapRingBuffer<Imu> + imuConverter +
    updateImuOrientation + Imu::imuInit)."""

    def __init__(self, capacity: int = 4096, R_imu_laser=None,
                 t_imu_laser=None, imu_rate: float = 200.0):
        self._lib = load()
        self.initialized = False
        self._h = self._lib.so_imu_buffer_new(capacity)
        if R_imu_laser is not None or t_imu_laser is not None:
            R = np.eye(3) if R_imu_laser is None else np.asarray(
                R_imu_laser, np.float64)
            R_li = np.ascontiguousarray(R.T)  # imu -> laser
            t = np.ascontiguousarray(
                np.zeros(3) if t_imu_laser is None
                else np.asarray(t_imu_laser, np.float64))
            self._lib.so_imu_buffer_set_conditioning(self._h, _dp(R_li),
                                                     _dp(t), imu_rate)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.so_imu_buffer_free(self._h)
            self._h = None

    def add(self, t: float, acc: np.ndarray, gyr: np.ndarray):
        acc = np.ascontiguousarray(acc, np.float32)
        gyr = np.ascontiguousarray(gyr, np.float32)
        self._lib.so_imu_buffer_add(self._h, t, _fp(acc), _fp(gyr))

    def static_init(self, window_sec: float = 1.0):
        """Gravity/bias initialization over the first ``window_sec``.
        Returns (acc_mean, gyr_bias, q0_wxyz), or None without enough data."""
        out = np.zeros(10, np.float64)
        if not self._lib.so_imu_buffer_static_init(self._h, window_sec,
                                                   _dp(out)):
            return None
        self.initialized = True
        return out[:3], out[3:6], out[6:10]

    def __len__(self):
        return int(self._lib.so_imu_buffer_size(self._h))

    def sync(self, t0: float, t1: float) -> int:
        """1 = covered, 0 = wait for more IMU, -1 = scan predates buffer."""
        return int(self._lib.so_imu_buffer_sync(self._h, t0, t1))

    def window(self, t0: float, t1: float, max_out: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Samples covering [t0, t1] (one before, one after), evenly
        decimated to ``max_out``.  Returns (t, acc, gyr, q_wxyz)."""
        t = np.empty(max_out, np.float64)
        acc = np.empty((max_out, 3), np.float32)
        gyr = np.empty((max_out, 3), np.float32)
        q = np.empty((max_out, 4), np.float32)
        m = self._lib.so_imu_buffer_window(self._h, t0, t1, max_out, _dp(t),
                                           _fp(acc), _fp(gyr), _fp(q))
        return t[:m], acc[:m], gyr[:m], q[:m]
