"""ROS 2 rosbag (sqlite3 .db3) reading and writing without ROS (numpy
only).

The port's own copy of the JAX package's io/rosbag.py: a bag either
package writes holds the same bytes, and each reads the other's. The
reference reads Nebula bags through rclpy deserialization
(nebula_multirobot_processor.py:70-95 BagFileParser); here the bag schema
is read with the standard library's sqlite3 and sensor_msgs/msg/
PointCloud2 payloads are decoded from their CDR wire format, which is
enough for LiDAR replay. Messages of other types come back raw.

CDR: an rmw serialization starts with a 4-byte encapsulation header
(0x00 0x01 = little-endian CDR); the fields follow in IDL order, each
aligned to its size relative to the start of the payload (after the
header).
"""

from __future__ import annotations

import dataclasses
import sqlite3
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

_DATATYPE_NP = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
                5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


class _CdrReader:
    def __init__(self, buf: bytes):
        if len(buf) < 4:
            raise ValueError("CDR payload too short")
        self.buf = buf
        self.little = buf[1] in (0x01, 0x03)
        self.off = 4  # skip encapsulation header
        self._fmt = "<" if self.little else ">"

    def _align(self, n: int) -> None:
        rem = (self.off - 4) % n
        if rem:
            self.off += n - rem

    def u8(self) -> int:
        v = self.buf[self.off]
        self.off += 1
        return v

    def _num(self, fmt: str, size: int):
        self._align(size)
        v = struct.unpack_from(self._fmt + fmt, self.buf, self.off)[0]
        self.off += size
        return v

    def u16(self):
        return self._num("H", 2)

    def u32(self):
        return self._num("I", 4)

    def i32(self):
        return self._num("i", 4)

    def f64(self):
        return self._num("d", 8)

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off:self.off + n - 1].decode("utf-8", "replace") \
            if n > 0 else ""
        self.off += n
        return s

    def bytes_seq(self) -> bytes:
        n = self.u32()
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b


@dataclasses.dataclass
class PointField:
    name: str
    offset: int
    datatype: int
    count: int


@dataclasses.dataclass
class PointCloud2:
    stamp: float
    frame_id: str
    height: int
    width: int
    fields: List[PointField]
    point_step: int
    row_step: int
    data: bytes

    def xyz(self) -> np.ndarray:
        """Decode to (N, 3) float32 xyz."""
        by_name = {f.name: f for f in self.fields}
        n = self.height * self.width
        raw = np.frombuffer(self.data, dtype=np.uint8)
        raw = raw[: n * self.point_step].reshape(n, self.point_step)
        cols = []
        for name in ("x", "y", "z"):
            f = by_name[name]
            dt = np.dtype(_DATATYPE_NP[f.datatype]).newbyteorder("<")
            width = dt.itemsize
            col = raw[:, f.offset:f.offset + width].copy().view(dt)[:, 0]
            cols.append(col.astype(np.float32))
        out = np.stack(cols, axis=1)
        return out[np.isfinite(out).all(axis=1)]


def parse_pointcloud2(payload: bytes) -> PointCloud2:
    r = _CdrReader(payload)
    sec = r.i32()
    nsec = r.u32()
    frame_id = r.string()
    height = r.u32()
    width = r.u32()
    n_fields = r.u32()
    fields = []
    for _ in range(n_fields):
        name = r.string()
        offset = r.u32()
        datatype = r.u8()
        count = r.u32()
        fields.append(PointField(name, offset, datatype, count))
    _is_bigendian = r.u8()
    point_step = r.u32()
    row_step = r.u32()
    data = r.bytes_seq()
    return PointCloud2(stamp=sec + nsec * 1e-9, frame_id=frame_id,
                       height=height, width=width, fields=fields,
                       point_step=point_step, row_step=row_step, data=data)


class BagReader:
    """stdlib-sqlite3 reader for rosbag2 .db3 files."""

    def __init__(self, bag_file: str):
        self.conn = sqlite3.connect(f"file:{bag_file}?mode=ro", uri=True)
        cur = self.conn.execute("SELECT id, name, type FROM topics")
        rows = cur.fetchall()
        self.topic_id = {name: tid for tid, name, _ in rows}
        self.topic_type = {name: typ for _, name, typ in rows}

    def topics(self) -> Dict[str, str]:
        return dict(self.topic_type)

    def messages(self, topic: str) -> Iterator[Tuple[float, bytes]]:
        tid = self.topic_id[topic]
        cur = self.conn.execute(
            "SELECT timestamp, data FROM messages WHERE topic_id = ? "
            "ORDER BY timestamp", (tid,))
        for ts, data in cur:
            yield ts * 1e-9, data

    def pointclouds(self, topic: str) -> Iterator[Tuple[float, np.ndarray]]:
        """(bag_time_s, (N,3) xyz) for a sensor_msgs/msg/PointCloud2 topic."""
        for ts, payload in self.messages(topic):
            yield ts, parse_pointcloud2(payload).xyz()

    def close(self) -> None:
        self.conn.close()


# ---------------------------------------------------------------------------
# writing (for tests / converting synthetic data into bags)
# ---------------------------------------------------------------------------

def serialize_pointcloud2(stamp: float, frame_id: str,
                          points: np.ndarray) -> bytes:
    """Encode (N,3) float32 xyz as a CDR sensor_msgs/msg/PointCloud2."""
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    out = bytearray(b"\x00\x01\x00\x00")  # little-endian CDR header

    def align(k):
        rem = (len(out) - 4) % k
        if rem:
            out.extend(b"\x00" * (k - rem))

    def u32(v):
        align(4)
        out.extend(struct.pack("<I", v))

    def i32(v):
        align(4)
        out.extend(struct.pack("<i", v))

    def string(s):
        b = s.encode() + b"\x00"
        u32(len(b))
        out.extend(b)

    sec = int(stamp)
    i32(sec)
    u32(int((stamp - sec) * 1e9))
    string(frame_id)
    u32(1)      # height
    u32(n)      # width
    u32(3)      # n fields
    for i, name in enumerate(("x", "y", "z")):
        string(name)
        u32(i * 4)          # offset
        align(1)
        out.append(7)       # FLOAT32
        u32(1)              # count
    out.append(0)           # is_bigendian
    u32(12)                 # point_step
    u32(12 * n)             # row_step
    data = pts.tobytes()
    u32(len(data))
    out.extend(data)
    out.append(0)           # is_dense = false (bool)
    return bytes(out)


def write_bag(bag_file: str, topic: str,
              clouds: List[Tuple[float, np.ndarray]],
              msg_type: str = "sensor_msgs/msg/PointCloud2") -> None:
    """Create a minimal rosbag2-compatible .db3 with PointCloud2 messages."""
    write_multi_bag(bag_file, {topic: clouds}, msg_type=msg_type)


def write_multi_bag(bag_file: str,
                    topics: "Dict[str, List[Tuple[float, np.ndarray]]]",
                    msg_type: str = "sensor_msgs/msg/PointCloud2") -> None:
    """Multi-topic bag writer — one PointCloud2 stream per robot namespace,
    the shape the reference's Nebula fleet bags have
    (nebula_multirobot_processor.py:70-95 reads per-robot topics from one
    sqlite bag). Messages interleave in global timestamp order."""
    conn = sqlite3.connect(bag_file)
    conn.executescript(
        "CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT, type TEXT,"
        " serialization_format TEXT, offered_qos_profiles TEXT);"
        "CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id INTEGER,"
        " timestamp INTEGER, data BLOB);")
    rows = []
    for tid, (topic, clouds) in enumerate(topics.items(), start=1):
        conn.execute("INSERT INTO topics VALUES (?, ?, ?, 'cdr', '')",
                     (tid, topic, msg_type))
        for stamp, pts in clouds:
            rows.append((tid, int(stamp * 1e9),
                         serialize_pointcloud2(stamp, "velodyne", pts)))
    rows.sort(key=lambda r: r[1])
    for i, (tid, ts, payload) in enumerate(rows):
        conn.execute("INSERT INTO messages VALUES (?, ?, ?, ?)",
                     (i + 1, tid, ts, payload))
    conn.commit()
    conn.close()
