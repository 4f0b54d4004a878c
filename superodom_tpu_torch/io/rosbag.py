"""Minimal rosbag2 (SQLite3 ``.db3``) reader/writer with CDR message codecs.

The reference replays demo recordings with ``ros2 bag play``
(reference readme.md:161-163, script/benchmark_velodyne.yaml) — this module
is the ingestion shell's equivalent: it reads rosbag2 SQLite storage
directly (stdlib ``sqlite3``), deserializes the CDR payloads of the message
types the reference subscribes to, and assembles a replayable dataset:

* ``sensor_msgs/msg/PointCloud2`` (Velodyne/Ouster handlers,
  featureExtraction.cpp:710-772)
* ``sensor_msgs/msg/Imu``          (imu_Handler, featureExtraction.cpp:620)
* ``livox_ros_driver2/msg/CustomMsg`` (livoxHandler, featureExtraction.cpp:775)
* ``nav_msgs/msg/Odometry``        (visual odometry aiding input)

Only XCDR1 little-endian encoding is implemented (what ROS 2 Humble's
rmw_fastrtps writes into bags).  The writer exists so tests can round-trip
real bag files without a ROS installation.

The PyTorch port's copy of the JAX package's ``io.rosbag``: the codecs,
the storage and the dataset loader are the same, byte for byte in what
they write and array for array in what they read.  The reader selects
the wanted topics in SQL and sorts the message index, not the payloads;
the loader also takes an optional ground-truth odometry topic
(``gt_topic``).
"""

from __future__ import annotations

import os
import sqlite3
import struct
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

# PointField datatype codes (sensor_msgs/msg/PointField)
_PF_DTYPES = {
    1: np.dtype("i1"), 2: np.dtype("u1"), 3: np.dtype("i2"),
    4: np.dtype("u2"), 5: np.dtype("i4"), 6: np.dtype("u4"),
    7: np.dtype("f4"), 8: np.dtype("f8"),
}
_PF_CODES = {v: k for k, v in _PF_DTYPES.items()}


class CdrReader:
    """Alignment-aware little-endian XCDR1 reader.

    Alignment origin is the first byte AFTER the 4-byte encapsulation
    header, per the DDS-RTPS serialized-payload rules.
    """

    def __init__(self, data: bytes):
        if len(data) < 4:
            raise ValueError("CDR payload shorter than encapsulation header")
        if data[1] not in (0x01, 0x03):  # CDR_LE / PL_CDR_LE
            raise NotImplementedError("big-endian CDR bags are not supported")
        self._d = data
        self._o = 4  # cursor (alignment is relative to offset 4)

    def _align(self, size: int):
        rem = (self._o - 4) % size
        if rem:
            self._o += size - rem

    def _prim(self, fmt: str, size: int):
        self._align(size)
        v = struct.unpack_from("<" + fmt, self._d, self._o)[0]
        self._o += size
        return v

    def u8(self):
        v = self._d[self._o]
        self._o += 1
        return v

    def i8(self):
        return self._prim("b", 1)

    def u16(self):
        return self._prim("H", 2)

    def u32(self):
        return self._prim("I", 4)

    def i32(self):
        return self._prim("i", 4)

    def u64(self):
        return self._prim("Q", 8)

    def f32(self):
        return self._prim("f", 4)

    def f64(self):
        return self._prim("d", 8)

    def string(self) -> str:
        n = self.u32()  # length including NUL
        s = self._d[self._o:self._o + max(n - 1, 0)].decode("utf-8", "replace")
        self._o += n
        return s

    def bytes_seq(self) -> bytes:
        n = self.u32()
        b = self._d[self._o:self._o + n]
        self._o += n
        return b

    def f64_array(self, n: int) -> np.ndarray:
        self._align(8)
        a = np.frombuffer(self._d, np.dtype("<f8"), n, self._o).copy()
        self._o += 8 * n
        return a


class CdrWriter:
    """Little-endian XCDR1 writer (tests / bag synthesis)."""

    def __init__(self):
        self._b = bytearray(b"\x00\x01\x00\x00")  # CDR_LE encapsulation

    def _align(self, size: int):
        rem = (len(self._b) - 4) % size
        if rem:
            self._b += b"\x00" * (size - rem)

    def _prim(self, fmt: str, size: int, v):
        self._align(size)
        self._b += struct.pack("<" + fmt, v)

    def u8(self, v):
        self._b.append(v & 0xFF)

    def u16(self, v):
        self._prim("H", 2, v)

    def u32(self, v):
        self._prim("I", 4, v)

    def i32(self, v):
        self._prim("i", 4, v)

    def u64(self, v):
        self._prim("Q", 8, v)

    def f32(self, v):
        self._prim("f", 4, v)

    def f64(self, v):
        self._prim("d", 8, v)

    def string(self, s: str):
        b = s.encode() + b"\x00"
        self.u32(len(b))
        self._b += b

    def bytes_seq(self, b: bytes):
        self.u32(len(b))
        self._b += b

    def f64_array(self, arr):
        self._align(8)
        self._b += np.asarray(arr, "<f8").tobytes()

    def data(self) -> bytes:
        return bytes(self._b)


# ---------------------------------------------------------------------------
# message codecs
# ---------------------------------------------------------------------------


class PointField(NamedTuple):
    name: str
    offset: int
    datatype: int
    count: int


class PointCloud2(NamedTuple):
    stamp: float  # seconds
    frame_id: str
    height: int
    width: int
    fields: List[PointField]
    is_bigendian: bool
    point_step: int
    row_step: int
    data: bytes
    is_dense: bool

    def layout(self) -> Dict[str, Tuple[int, np.dtype]]:
        """Field layout for native.decode_points."""
        return {f.name: (f.offset, _PF_DTYPES[f.datatype]) for f in self.fields}


class ImuMsg(NamedTuple):
    stamp: float
    frame_id: str
    orientation: np.ndarray  # [4] w,x,y,z
    angular_velocity: np.ndarray  # [3]
    linear_acceleration: np.ndarray  # [3]


class LivoxCustomMsg(NamedTuple):
    stamp: float
    frame_id: str
    timebase: int  # ns
    xyz: np.ndarray  # f32[n,3]
    offset_time_ns: np.ndarray  # u4[n]
    reflectivity: np.ndarray  # u1[n]
    tag: np.ndarray  # u1[n]
    line: np.ndarray  # u1[n]


class OdometryMsg(NamedTuple):
    stamp: float
    frame_id: str
    child_frame_id: str
    q_wxyz: np.ndarray  # [4]
    t_xyz: np.ndarray  # [3]


def _read_header(r: CdrReader) -> Tuple[float, str]:
    sec = r.i32()
    nsec = r.u32()
    frame = r.string()
    return sec + nsec * 1e-9, frame


def _write_header(w: CdrWriter, stamp: float, frame_id: str):
    sec = int(stamp)
    w.i32(sec)
    w.u32(int(round((stamp - sec) * 1e9)))
    w.string(frame_id)


def parse_pointcloud2(data: bytes) -> PointCloud2:
    r = CdrReader(data)
    stamp, frame = _read_header(r)
    height, width = r.u32(), r.u32()
    nf = r.u32()
    fields = []
    for _ in range(nf):
        name = r.string()
        fields.append(PointField(name, r.u32(), r.u8(), r.u32()))
    is_be = bool(r.u8())
    point_step, row_step = r.u32(), r.u32()
    blob = r.bytes_seq()
    dense = bool(r.u8())
    return PointCloud2(stamp, frame, height, width, fields, is_be,
                       point_step, row_step, blob, dense)


def encode_pointcloud2(msg: PointCloud2) -> bytes:
    w = CdrWriter()
    _write_header(w, msg.stamp, msg.frame_id)
    w.u32(msg.height)
    w.u32(msg.width)
    w.u32(len(msg.fields))
    for f in msg.fields:
        w.string(f.name)
        w.u32(f.offset)
        w.u8(f.datatype)
        w.u32(f.count)
    w.u8(1 if msg.is_bigendian else 0)
    w.u32(msg.point_step)
    w.u32(msg.row_step)
    w.bytes_seq(msg.data)
    w.u8(1 if msg.is_dense else 0)
    return w.data()


def parse_imu(data: bytes) -> ImuMsg:
    r = CdrReader(data)
    stamp, frame = _read_header(r)
    qx, qy, qz, qw = r.f64(), r.f64(), r.f64(), r.f64()
    r.f64_array(9)  # orientation covariance
    gyr = np.array([r.f64(), r.f64(), r.f64()])
    r.f64_array(9)
    acc = np.array([r.f64(), r.f64(), r.f64()])
    r.f64_array(9)
    return ImuMsg(stamp, frame, np.array([qw, qx, qy, qz]), gyr, acc)


def encode_imu(msg: ImuMsg) -> bytes:
    w = CdrWriter()
    _write_header(w, msg.stamp, msg.frame_id)
    qw, qx, qy, qz = msg.orientation
    for v in (qx, qy, qz, qw):
        w.f64(v)
    w.f64_array(np.zeros(9))
    for v in msg.angular_velocity:
        w.f64(v)
    w.f64_array(np.zeros(9))
    for v in msg.linear_acceleration:
        w.f64(v)
    w.f64_array(np.zeros(9))
    return w.data()


def parse_livox_custom(data: bytes) -> LivoxCustomMsg:
    r = CdrReader(data)
    stamp, frame = _read_header(r)
    timebase = r.u64()
    n = r.u32()
    r.u8()  # lidar_id
    r.u8()
    r.u8()
    r.u8()  # rsvd[3]
    cnt = r.u32()  # points sequence length (== point_num)
    n = min(n, cnt)
    # CustomPoint: u32 offset_time, 3x f32 xyz, u8 reflectivity, u8 tag,
    # u8 line -> 19 bytes, aligned to 4 => 20-byte stride
    rec = np.dtype([("off", "<u4"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                    ("refl", "u1"), ("tag", "u1"), ("line", "u1"),
                    ("_pad", "u1")])
    r._align(4)
    arr = np.frombuffer(r._d, rec, cnt, r._o)
    r._o += rec.itemsize * cnt
    xyz = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
    return LivoxCustomMsg(stamp, frame, timebase, xyz,
                          arr["off"].copy(), arr["refl"].copy(),
                          arr["tag"].copy(), arr["line"].copy())


def encode_livox_custom(msg: LivoxCustomMsg) -> bytes:
    w = CdrWriter()
    _write_header(w, msg.stamp, msg.frame_id)
    w.u64(msg.timebase)
    n = len(msg.xyz)
    w.u32(n)
    w.u8(0)
    for _ in range(3):
        w.u8(0)
    w.u32(n)
    rec = np.zeros(n, np.dtype([("off", "<u4"), ("x", "<f4"), ("y", "<f4"),
                                ("z", "<f4"), ("refl", "u1"), ("tag", "u1"),
                                ("line", "u1"), ("_pad", "u1")]))
    rec["off"] = msg.offset_time_ns
    rec["x"], rec["y"], rec["z"] = msg.xyz.T
    rec["refl"], rec["tag"], rec["line"] = (
        msg.reflectivity, msg.tag, msg.line)
    w._align(4)
    w._b += rec.tobytes()
    return w.data()


def parse_odometry(data: bytes) -> OdometryMsg:
    r = CdrReader(data)
    stamp, frame = _read_header(r)
    child = r.string()
    t = np.array([r.f64(), r.f64(), r.f64()])
    qx, qy, qz, qw = r.f64(), r.f64(), r.f64(), r.f64()
    return OdometryMsg(stamp, frame, child, np.array([qw, qx, qy, qz]), t)


def encode_odometry(msg: OdometryMsg) -> bytes:
    w = CdrWriter()
    _write_header(w, msg.stamp, msg.frame_id)
    w.string(msg.child_frame_id)
    for v in msg.t_xyz:
        w.f64(v)
    qw, qx, qy, qz = msg.q_wxyz
    for v in (qx, qy, qz, qw):
        w.f64(v)
    w.f64_array(np.zeros(36))  # pose covariance
    # twist (zeroed) + covariance
    for _ in range(6):
        w.f64(0.0)
    w.f64_array(np.zeros(36))
    return w.data()


_PARSERS = {
    "sensor_msgs/msg/PointCloud2": parse_pointcloud2,
    "sensor_msgs/msg/Imu": parse_imu,
    "livox_ros_driver2/msg/CustomMsg": parse_livox_custom,
    "nav_msgs/msg/Odometry": parse_odometry,
}


# ---------------------------------------------------------------------------
# SQLite3 storage
# ---------------------------------------------------------------------------


def _resolve_db3(path: str) -> List[str]:
    """Accept a .db3 file or a rosbag2 directory (metadata.yaml + *.db3)."""
    if os.path.isdir(path):
        dbs = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".db3")
        )
        if not dbs:
            raise FileNotFoundError(f"no .db3 files under {path}")
        return dbs
    if not os.path.exists(path):
        # sqlite3.connect would silently CREATE an empty db here
        raise FileNotFoundError(f"rosbag not found: {path}")
    return [path]


class Rosbag2Reader:
    """Iterate (topic, type, t_bag_ns, parsed message) over a rosbag2
    SQLite recording."""

    def __init__(self, path: str):
        self._dbs = _resolve_db3(path)

    def topics(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for db in self._dbs:
            con = sqlite3.connect(db)
            try:
                for name, typ in con.execute("SELECT name, type FROM topics"):
                    out[name] = typ
            finally:
                con.close()
        return out

    def messages(
        self, topics: Optional[List[str]] = None, raw: bool = False
    ) -> Iterator[Tuple[str, str, int, object]]:
        for db in self._dbs:
            con = sqlite3.connect(db)
            try:
                tmap = dict(con.execute("SELECT id, name FROM topics"))
                types = dict(con.execute("SELECT name, type FROM topics"))
                ids = [i for i, name in tmap.items()
                       if not topics or name in topics]
                # order the (id, topic, time) columns alone, then read each
                # record by its row id: an ORDER BY over the records
                # themselves sorts every payload of the recording in a
                # temporary store
                order = con.execute(
                    "SELECT id, topic_id, timestamp FROM messages WHERE "
                    f"topic_id IN ({','.join('?' * len(ids))}) "
                    "ORDER BY timestamp, id", ids).fetchall()
                for mid, tid, ts in order:
                    (data,) = con.execute(
                        "SELECT data FROM messages WHERE id = ?",
                        (mid,)).fetchone()
                    topic = tmap[tid]
                    typ = types[topic]
                    if raw:
                        yield topic, typ, ts, data
                        continue
                    parser = _PARSERS.get(typ)
                    if parser is None:
                        continue
                    yield topic, typ, ts, parser(data)
            finally:
                con.close()


class Rosbag2Writer:
    """Minimal rosbag2 SQLite writer (schema compatible with ros2 bag)."""

    def __init__(self, path: str):
        if path.endswith(".db3"):
            db = path
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        else:
            os.makedirs(path, exist_ok=True)
            db = os.path.join(path, os.path.basename(path.rstrip("/")) + "_0.db3")
        self._con = sqlite3.connect(db)
        self._con.executescript(
            """
            CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT NOT NULL,
              type TEXT NOT NULL, serialization_format TEXT NOT NULL,
              offered_qos_profiles TEXT NOT NULL);
            CREATE TABLE messages(id INTEGER PRIMARY KEY,
              topic_id INTEGER NOT NULL, timestamp INTEGER NOT NULL,
              data BLOB NOT NULL);
            """
        )
        self._topic_ids: Dict[str, int] = {}

    def add_topic(self, name: str, typ: str) -> int:
        tid = len(self._topic_ids) + 1
        self._con.execute(
            "INSERT INTO topics VALUES (?, ?, ?, 'cdr', '')", (tid, name, typ)
        )
        self._topic_ids[name] = tid
        return tid

    def write(self, topic: str, t_ns: int, data: bytes):
        self._con.execute(
            "INSERT INTO messages(topic_id, timestamp, data) VALUES (?, ?, ?)",
            (self._topic_ids[topic], t_ns, data),
        )

    def close(self):
        self._con.commit()
        self._con.close()


# ---------------------------------------------------------------------------
# bag -> replayable dataset
# ---------------------------------------------------------------------------


class BagDataset(NamedTuple):
    """Replay-compatible dataset (same surface as io.datasets.SimDataset,
    without ground truth)."""

    scans: list  # of SimScan
    imu: object  # SimImu
    gt_poses_q: Optional[np.ndarray]
    gt_poses_t: Optional[np.ndarray]
    times: np.ndarray


def _cloud_to_rawscan(pc: PointCloud2, sensor_kind: str, n_scan_lines: int):
    """Decode a PointCloud2 into a RawScan via the vendor adapters
    (the roles of laserCloudHandler's per-vendor branches,
    featureExtraction.cpp:727-751)."""
    from superodom_tpu_torch import native
    from superodom_tpu_torch.io import adapters

    layout = pc.layout()
    names = set(layout)
    n = pc.width * pc.height
    # per-point relative time field naming varies by driver
    tkey = next((k for k in ("time", "point_time", "timestamp", "t", "ts")
                 if k in names), None)
    # ouster 't' is uint32 nanoseconds; velodyne 'time' is float32 seconds
    ns_time = tkey is not None and layout[tkey][1] in (
        np.dtype("u4"), np.dtype("i4"))
    dec_layout = {k: layout[k] for k in ("x", "y", "z") if k in layout}
    if tkey:
        dec_layout["time"] = layout[tkey]
    if "ring" in names:
        dec_layout["ring"] = layout["ring"]
    if "intensity" in names:
        dec_layout["intensity"] = layout["intensity"]
    xyz, t_rel, ring, inten = native.decode_points(
        pc.data, n, pc.point_step, dec_layout, 1e-9 if ns_time else 1.0)
    if sensor_kind == "ouster":
        return adapters.from_ouster(xyz, t_rel * 1e9, ring, inten)
    if tkey is None:
        return adapters.from_velodyne(xyz, None, None, inten, n_scan_lines)
    return adapters.RawScan(xyz, t_rel, ring, inten)


def _guess_sensor_kind(typ: str, pc: Optional[PointCloud2]) -> str:
    if typ == "livox_ros_driver2/msg/CustomMsg":
        return "livox"
    if pc is not None:
        names = {f.name for f in pc.fields}
        if "t" in names or "ambient" in names or "reflectivity" in names:
            return "ouster"
    return "velodyne"


def load_bag_dataset(
    path: str,
    lidar_topic: Optional[str] = None,
    imu_topic: Optional[str] = None,
    n_scan_lines: int = 16,
    max_scans: Optional[int] = None,
    sensor_kind: Optional[str] = None,
    gt_topic: Optional[str] = None,
) -> BagDataset:
    """Read a rosbag2 recording into a replayable dataset.

    Topics default to the first PointCloud2/CustomMsg topic and the first
    Imu topic in the bag (the reference wires these explicitly in its launch
    files; bags typically contain exactly one of each).

    ``sensor_kind`` ("velodyne" | "ouster" | "livox") selects the vendor
    decode path explicitly; when omitted it is inferred from the message
    type and field names, and the guess is logged — the vendor path decides
    time/ring synthesis AND the ouster sensor-frame rotation, so a wrong
    guess silently rotates the cloud.

    ``gt_topic`` names a ``nav_msgs/msg/Odometry`` topic of ground-truth
    poses; each scan's ground truth is the message whose stamp is nearest
    its start (without it, as in the JAX package, the dataset has none).
    """
    from superodom_tpu_torch.io.datasets import SimImu, SimScan

    reader = Rosbag2Reader(path)
    topics = reader.topics()
    if lidar_topic is None:
        lidar_topic = next(
            (t for t, ty in topics.items()
             if ty in ("sensor_msgs/msg/PointCloud2",
                       "livox_ros_driver2/msg/CustomMsg")),
            None,
        )
    if imu_topic is None:
        imu_topic = next(
            (t for t, ty in topics.items() if ty == "sensor_msgs/msg/Imu"),
            None,
        )
    if lidar_topic is None:
        raise ValueError(f"no point-cloud topic found in {path}: {topics}")

    scans: List[SimScan] = []
    imu_t: List[float] = []
    imu_acc: List[np.ndarray] = []
    imu_gyr: List[np.ndarray] = []
    wanted = [lidar_topic] + ([imu_topic] if imu_topic else [])
    if gt_topic is not None:
        if topics.get(gt_topic) != "nav_msgs/msg/Odometry":
            raise ValueError(f"{gt_topic} is not a nav_msgs/msg/Odometry "
                             f"topic of {path}: {topics}")
        wanted.append(gt_topic)
    gt: List[OdometryMsg] = []
    for topic, typ, t_ns, msg in reader.messages(wanted):
        if topic == gt_topic:
            gt.append(msg)
            continue
        if topic == imu_topic and isinstance(msg, ImuMsg):
            imu_t.append(msg.stamp)
            imu_acc.append(msg.linear_acceleration.astype(np.float32))
            imu_gyr.append(msg.angular_velocity.astype(np.float32))
            continue
        if max_scans is not None and len(scans) >= max_scans:
            continue
        if isinstance(msg, LivoxCustomMsg):
            from superodom_tpu_torch.io import adapters

            raw = adapters.from_livox(
                msg.xyz, msg.offset_time_ns, msg.line, msg.tag,
                msg.reflectivity)
            t0 = msg.timebase * 1e-9 if msg.timebase else msg.stamp
            scans.append(SimScan(t0, raw.xyz, raw.t_rel))
            sensor_kind = "livox"
        elif isinstance(msg, PointCloud2):
            if sensor_kind is None:
                sensor_kind = _guess_sensor_kind(typ, msg)
                import logging

                logging.getLogger(__name__).warning(
                    "guessed sensor_kind=%r for topic %s from field names "
                    "%s — pass sensor_kind= explicitly if wrong",
                    sensor_kind, lidar_topic,
                    [f.name for f in msg.fields],
                )
            raw = _cloud_to_rawscan(msg, sensor_kind, n_scan_lines)
            scans.append(SimScan(msg.stamp, raw.xyz, raw.t_rel))
    if not scans:
        raise ValueError(f"no scans decoded from {path} topic {lidar_topic}")

    imu = SimImu(
        t=np.asarray(imu_t, np.float64),
        acc=np.asarray(imu_acc, np.float32).reshape(-1, 3),
        gyr=np.asarray(imu_gyr, np.float32).reshape(-1, 3),
    )
    times = np.asarray([s.t_start for s in scans])
    gt_q = gt_t = None
    if gt_topic is not None:
        if not gt:
            raise ValueError(f"no message on {gt_topic} in {path}")
        stamps = np.asarray([g.stamp for g in gt])
        order = np.argsort(stamps, kind="stable")
        stamps = stamps[order]
        hi = np.minimum(np.searchsorted(stamps, times), len(stamps) - 1)
        lo = np.maximum(hi - 1, 0)
        near = np.where(np.abs(times - stamps[lo]) <= np.abs(stamps[hi]
                                                             - times), lo, hi)
        pick = [gt[order[i]] for i in near]
        gt_q = np.asarray([g.q_wxyz for g in pick], np.float32)
        gt_t = np.asarray([g.t_xyz for g in pick], np.float32)
    return BagDataset(
        scans=scans, imu=imu, gt_poses_q=gt_q, gt_poses_t=gt_t, times=times,
    )
