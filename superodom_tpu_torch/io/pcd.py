"""Minimal PCD (Point Cloud Data) reader/writer + pose-file IO.

Replaces the reference's PCL PCD IO for localization-mode prior maps
(reference laserMapping.cpp:163-177, utils/superodom_utils.cpp:16-60
readPointCloud / readLocalizationPose) without a PCL dependency.  Supports
ascii and binary encodings with at least x/y/z fields.

The PyTorch port's copy of the JAX package's ``io.pcd``, line for line.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

_DTYPES = {("F", 4): "f4", ("F", 8): "f8",
           ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4",
           ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def read_pcd(path: str) -> np.ndarray:
    """Read a PCD file, returning f32[n, 3] xyz (extra fields ignored)."""
    with open(path, "rb") as f:
        fields, sizes, types, counts = [], [], [], []
        n_points = 0
        data_mode = "ascii"
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, rest = line.partition(" ")
            key = key.upper()
            if key == "FIELDS":
                fields = rest.split()
            elif key == "SIZE":
                sizes = [int(v) for v in rest.split()]
            elif key == "TYPE":
                types = rest.split()
            elif key == "COUNT":
                counts = [int(v) for v in rest.split()]
            elif key == "POINTS":
                n_points = int(rest)
            elif key == "DATA":
                data_mode = rest.strip().lower()
                break
        if not counts:
            counts = [1] * len(fields)

        if data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n_points)
            raw = np.atleast_2d(raw)
            col = 0
            cols = {}
            for name, c in zip(fields, counts):
                cols[name] = col
                col += c
            xyz = np.stack(
                [raw[:, cols["x"]], raw[:, cols["y"]], raw[:, cols["z"]]], -1
            )
            return xyz.astype(np.float32)
        if data_mode == "binary":
            dtype = np.dtype(
                {
                    "names": [
                        n if c == 1 else f"{n}" for n, c in zip(fields, counts)
                    ],
                    "formats": [
                        _DTYPES[(t, s)] if c == 1 else (_DTYPES[(t, s)], (c,))
                        for t, s, c in zip(types, sizes, counts)
                    ],
                }
            )
            raw = np.frombuffer(f.read(dtype.itemsize * n_points), dtype=dtype,
                                count=n_points)
            return np.stack(
                [raw["x"], raw["y"], raw["z"]], axis=-1
            ).astype(np.float32)
        raise ValueError(f"unsupported PCD data mode: {data_mode}")


def write_pcd(path: str, xyz: np.ndarray, binary: bool = True) -> None:
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(np.ascontiguousarray(xyz).tobytes())
        else:
            np.savetxt(f, xyz, fmt="%.6f")


class OdometryRecord(NamedTuple):
    """One line of a localization pose file (reference
    utils::readLocalizationPose: x y z roll pitch yaw per line)."""

    x: float
    y: float
    z: float
    roll: float
    pitch: float
    yaw: float


def read_pose_file(path: str) -> List[OdometryRecord]:
    out = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) >= 6:
                out.append(OdometryRecord(*vals[:6]))
    return out


def write_pose_file(path: str, records) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(" ".join(f"{v:.6f}" for v in r) + "\n")
