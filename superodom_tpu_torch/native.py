"""Host IMU buffer, point-record decode and prior-map thinning: ctypes
bindings for the repository's native runtime.

The C++ source is this package's ``csrc/native_loader.cpp``, a byte-for-byte
copy of the JAX package's native loader (held equal by
``tests/test_torch_host.py``).  It sits apart from the CUDA kernels and is
built with the host C++ compiler into this package's ``build/`` directory
at first use.  The library's name carries a hash of the source, the
compiler, its flags and what ``-march=native`` means on this host, so a
library built on another CPU is never loaded.  A failed build raises for
the IMU buffer, :func:`decode_points` and :func:`synth_ring_time` (their
numpy versions, :func:`decode_points_reference` and
:func:`synth_ring_time_reference`, are what the tests hold them
against); :func:`voxel_downsample`, a host utility of the prior-map
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

FIELD_F32, FIELD_F64 = 0, 1
FIELD_I8, FIELD_U8, FIELD_I16, FIELD_U16, FIELD_I32, FIELD_U32 = 2, 3, 4, 5, 6, 7

_NP_TO_FIELD = {
    np.dtype("f4"): FIELD_F32, np.dtype("f8"): FIELD_F64,
    np.dtype("i1"): FIELD_I8, np.dtype("u1"): FIELD_U8,
    np.dtype("i2"): FIELD_I16, np.dtype("u2"): FIELD_U16,
    np.dtype("i4"): FIELD_I32, np.dtype("u4"): FIELD_U32,
}
# the record fields so_decode_points reads, in its argument order
_DECODE_FIELDS = ("x", "y", "z", "time", "ring", "intensity")

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
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    vp = ctypes.c_void_p
    lib.so_decode_points.restype = i64
    lib.so_decode_points.argtypes = [u8p, i64, i64, i64p, i32p, f64, f32p,
                                     f32p, i32p, f32p]
    lib.so_synth_ring_time.restype = i64
    lib.so_synth_ring_time.argtypes = [f32p, i64, i32, f64, f64, f32p, f32p,
                                       i32p]
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
    lib.so_imu_buffer_clean.argtypes = [vp, f64]
    lib.so_voxel_downsample.restype = i64
    lib.so_voxel_downsample.argtypes = [f32p, i64, f64, f32p]
    _lib = lib
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _record_bytes(data) -> np.ndarray:
    return (data.view(np.uint8).reshape(-1) if isinstance(data, np.ndarray)
            else np.frombuffer(data, dtype=np.uint8))


def decode_points(data, n: int, stride: int, layout: dict,
                  time_scale: float = 1.0):
    """Decode ``n`` packed point records of ``stride`` bytes
    (PointCloud2-style layouts) in one native pass.

    ``layout`` maps field name -> (byte offset, numpy dtype) for any of
    x, y, z, time, ring, intensity; x/y/z are required.  Records with a
    non-finite coordinate are dropped; ``time`` is scaled by
    ``time_scale`` in float64.  Returns (xyz f32[m,3], t f32[m],
    ring i32[m], intensity f32[m])."""
    buf = _record_bytes(data)
    ends = [layout[k][0] + np.dtype(layout[k][1]).itemsize
            for k in _DECODE_FIELDS if k in layout]
    if n > 0 and (n - 1) * stride + max(ends) > len(buf):
        raise ValueError(f"{len(buf)} bytes hold fewer than {n} records of "
                         f"{stride} bytes with fields ending at {max(ends)}")
    offsets = np.array([layout[k][0] if k in layout else -1
                        for k in _DECODE_FIELDS], np.int64)
    types = np.array([_NP_TO_FIELD[np.dtype(layout[k][1])] if k in layout
                      else FIELD_F32 for k in _DECODE_FIELDS], np.int32)
    lib = load()
    xyz = np.empty((n, 3), np.float32)
    t = np.empty(n, np.float32)
    ring = np.empty(n, np.int32)
    inten = np.empty(n, np.float32)
    m = lib.so_decode_points(_ip(buf, ctypes.c_uint8), n, stride,
                             _ip(offsets, ctypes.c_int64),
                             _ip(types, ctypes.c_int32), time_scale,
                             _fp(xyz), _fp(t), _ip(ring, ctypes.c_int32),
                             _fp(inten))
    return xyz[:m], t[:m], ring[:m], inten[:m]


def decode_points_reference(data, n: int, stride: int, layout: dict,
                            time_scale: float = 1.0):
    """Plain numpy version of :func:`decode_points`: strided views over the
    raw buffer (the JAX package's fallback branch)."""
    buf = _record_bytes(data)

    def field(k, default=0.0, out_dtype=np.float32):
        if k not in layout:
            return np.full(n, default, out_dtype)
        off, dt = layout[k]
        v = np.ndarray(shape=(n,), dtype=np.dtype(dt), buffer=buf.tobytes(),
                       offset=off, strides=(stride,))
        return v.astype(out_dtype)

    x, y, z = field("x"), field("y"), field("z")
    ok = np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
    xyz = np.stack([x, y, z], -1)[ok]
    tt = (field("time", 0.0, np.float64) * time_scale).astype(np.float32)[ok]
    rr = field("ring", 0, np.float64).astype(np.int32)[ok]
    ii = field("intensity", 0.0)[ok]
    return xyz, tt, rr, ii


def synth_ring_time(xyz: np.ndarray, n_scan_lines: int, column_time: float,
                    laser_time: float):
    """Ring from elevation and per-point time from the column/laser timing
    model, in one native pass (the reference's assignTimeforPointCloud);
    points outside the fan are dropped.  Returns (xyz f32[m,3], t f32[m],
    ring i32[m])."""
    lib = load()
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    xo = np.empty((n, 3), np.float32)
    to = np.empty(n, np.float32)
    ro = np.empty(n, np.int32)
    m = lib.so_synth_ring_time(_fp(xyz), n, n_scan_lines, column_time,
                               laser_time, _fp(xo), _fp(to),
                               _ip(ro, ctypes.c_int32))
    return xo[:m], to[:m], ro[:m]


def synth_ring_time_reference(xyz: np.ndarray, n_scan_lines: int,
                              column_time: float, laser_time: float):
    """Plain numpy version of :func:`synth_ring_time` (the adapters'
    float32 timing model, at the adapters' own column and laser times)."""
    from superodom_tpu_torch.io.adapters import _synthesize_ring_time

    xyz = np.ascontiguousarray(xyz, np.float32)
    raw = _synthesize_ring_time(xyz, np.zeros(len(xyz), np.float32),
                                n_scan_lines)
    return raw.xyz, raw.t_rel, raw.ring


def available() -> bool:
    """Whether the IMU library builds and loads on this host.  A query
    only: the IMU buffer and the decoders raise on a failed build."""
    try:
        load()
    except (OSError, RuntimeError):
        return False
    return True


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

    def clean(self, t: float):
        """Drop the samples older than ``t`` (MapRingBuffer::clean)."""
        self._lib.so_imu_buffer_clean(self._h, t)
