"""Pure-Python rosbag v2.0 reader (+ writer for tests).

Counterpart of ``mvil_fusion_tpu/io/rosbag.py``: the same reader, writer,
encoders and decoders, so that both packages write the same bytes from the
same messages and read each other's bags.

The reference is driven by `rosbag play` on the released MYNTEYE+LeiShen
bags (reference: README.md:44-57).  This module ingests those bags with no
ROS installation: the bag v2.0 container format (records, connections,
chunks with none/bz2 compression) and the three message types the system
consumes —

  sensor_msgs/Imu           (/mynteye/imu/data_raw)
  sensor_msgs/Image mono8   (/mynteye/left/image_mono)
  sensor_msgs/PointCloud2   (/lslidar_point_cloud, /full_cloud)

— decoded straight into numpy.  `play()` yields messages in time order,
which `pipeline.system.VilSystem` consumes directly.
"""

from __future__ import annotations

import bz2
import io
import struct
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from mvil_fusion_torch.io import lz4 as _lz4


def _decompress_chunk(comp: str, data: bytes) -> bytes:
    """Chunk payload → record bytes.  Unknown compressions raise (the
    silent-misparse alternative would drop messages without a trace)."""
    if comp == "none":
        return data
    if comp == "bz2":
        return bz2.decompress(data)
    if comp == "lz4":
        return _lz4.decompress(data)
    raise ValueError(f"unsupported rosbag chunk compression {comp!r}")

# record opcodes (rosbag v2.0 spec)
OP_MSG_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _read_header(data: bytes) -> dict:
    fields = {}
    off = 0
    while off < len(data):
        (flen,) = struct.unpack_from("<I", data, off)
        off += 4
        field = data[off:off + flen]
        off += flen
        k, _, v = field.partition(b"=")
        fields[k.decode()] = v
    return fields


def _encode_header(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        field = k.encode() + b"=" + v
        out += struct.pack("<I", len(field)) + field
    return out


def _iter_records(buf: bytes) -> Iterator[tuple[dict, bytes]]:
    off = 0
    n = len(buf)
    while off + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + hlen + 4 > n:
            return                    # truncated record — stop cleanly
        header = _read_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + dlen > n:
            return
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


@dataclass
class Connection:
    topic: str
    msg_type: str


@dataclass
class BagMessage:
    topic: str
    msg_type: str
    t: float            # receive timestamp (s)
    raw: bytes


class BagReader:
    """Sequential reader for rosbag v2.0 files."""

    def __init__(self, path: str):
        self.path = path

    def messages(self, topics: Optional[set] = None
                 ) -> Iterator[BagMessage]:
        with open(self.path, "rb") as f:
            magic = f.readline()
            if not magic.startswith(b"#ROSBAG V2.0"):
                raise ValueError(f"not a rosbag v2.0 file: {magic!r}")
            buf = f.read()
        connections: dict[int, Connection] = {}
        for header, data in _iter_records(buf):
            op = header.get("op", b"\x00")[0]
            if op == OP_CONNECTION:
                conn_id = struct.unpack("<I", header["conn"])[0]
                sub = _read_header(data)
                connections[conn_id] = Connection(
                    topic=header["topic"].decode(),
                    msg_type=sub.get("type", b"").decode())
            elif op == OP_CHUNK:
                comp = header.get("compression", b"none").decode()
                chunk = _decompress_chunk(comp, data)
                for h2, d2 in _iter_records(chunk):
                    op2 = h2.get("op", b"\x00")[0]
                    if op2 == OP_CONNECTION:
                        conn_id = struct.unpack("<I", h2["conn"])[0]
                        sub = _read_header(d2)
                        connections[conn_id] = Connection(
                            topic=h2["topic"].decode(),
                            msg_type=sub.get("type", b"").decode())
                    elif op2 == OP_MSG_DATA:
                        conn_id = struct.unpack("<I", h2["conn"])[0]
                        secs, nsecs = struct.unpack("<II", h2["time"])
                        c = connections.get(conn_id)
                        if c is None:
                            continue
                        if topics and c.topic not in topics:
                            continue
                        yield BagMessage(topic=c.topic, msg_type=c.msg_type,
                                         t=secs + 1e-9 * nsecs, raw=d2)
            elif op == OP_MSG_DATA:
                conn_id = struct.unpack("<I", header["conn"])[0]
                secs, nsecs = struct.unpack("<II", header["time"])
                c = connections.get(conn_id)
                if c is None or (topics and c.topic not in topics):
                    continue
                yield BagMessage(topic=c.topic, msg_type=c.msg_type,
                                 t=secs + 1e-9 * nsecs, raw=data)


# ---------------------------------------------------------------------------
# message decoding (serialized ROS1 message bodies)
# ---------------------------------------------------------------------------

class _R:
    def __init__(self, raw):
        self.b = raw
        self.o = 0

    def u32(self):
        (v,) = struct.unpack_from("<I", self.b, self.o)
        self.o += 4
        return v

    def f64(self, n=1):
        v = struct.unpack_from(f"<{n}d", self.b, self.o)
        self.o += 8 * n
        return v if n > 1 else v[0]

    def string(self):
        n = self.u32()
        s = self.b[self.o:self.o + n]
        self.o += n
        return s.decode(errors="replace")

    def time(self):
        s = self.u32()
        ns = self.u32()
        return s + 1e-9 * ns

    def skip(self, n):
        self.o += n

    def bytes_(self, n):
        v = self.b[self.o:self.o + n]
        self.o += n
        return v


def _header(r: _R):
    r.u32()                      # seq
    t = r.time()
    frame = r.string()
    return t, frame


def decode_imu(raw: bytes):
    """sensor_msgs/Imu → (t_header, acc (3,), gyr (3,))."""
    r = _R(raw)
    t, _ = _header(r)
    r.f64(4)                     # orientation quaternion
    r.f64(9)                     # orientation covariance
    gyr = np.asarray(r.f64(3))
    r.f64(9)
    acc = np.asarray(r.f64(3))
    r.f64(9)
    return t, acc, gyr


def decode_image(raw: bytes):
    """sensor_msgs/Image (mono8) → (t_header, img (H,W) float32)."""
    r = _R(raw)
    t, _ = _header(r)
    h = r.u32()
    w = r.u32()
    encoding = r.string()
    r.skip(1)                    # is_bigendian
    step = r.u32()
    n = r.u32()
    data = np.frombuffer(r.bytes_(n), np.uint8)
    if encoding not in ("mono8", "8UC1"):
        raise ValueError(f"unsupported image encoding {encoding}")
    img = data.reshape(h, step)[:, :w].astype(np.float32)
    return t, img


def decode_pointcloud2(raw: bytes):
    """sensor_msgs/PointCloud2 → (t_header, dict of field arrays).

    Extracts x/y/z (float32) and, when present, intensity and ring —
    everything the compensator/estimator consume.
    """
    r = _R(raw)
    t, _ = _header(r)
    height = r.u32()
    width = r.u32()
    nf = r.u32()
    fields = []
    for _ in range(nf):
        name = r.string()
        offset = r.u32()
        datatype = r.u32()
        count = r.u32()
        fields.append((name, offset, datatype, count))
    r.skip(1)                    # is_bigendian
    point_step = r.u32()
    r.u32()                      # row_step
    n = r.u32()
    buf = np.frombuffer(r.bytes_(n), np.uint8)
    n_pts = (height * width) if height * width else len(buf) // point_step
    n_pts = min(n_pts, len(buf) // max(point_step, 1))  # truncation-safe
    buf = buf[: n_pts * point_step].reshape(n_pts, point_step)

    _DT = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
           5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}
    out = {}
    for (name, offset, datatype, count) in fields:
        dt = np.dtype(_DT[datatype]).newbyteorder("<")
        w_ = dt.itemsize
        col = buf[:, offset:offset + w_ * count].copy().view(dt)
        out[name] = col.reshape(n_pts, count).squeeze(-1) \
            if count == 1 else col.reshape(n_pts, count)
    pts = np.stack([out["x"], out["y"], out["z"]], axis=-1).astype(np.float32)
    return t, dict(pts=pts, **{k: v for k, v in out.items()
                               if k not in ("x", "y", "z")})


# ---------------------------------------------------------------------------
# writer (tests / converting synthetic data into bag form)
# ---------------------------------------------------------------------------

class BagWriter:
    """Minimal rosbag v2.0 writer (one chunk; none/bz2/lz4 compression)."""

    def __init__(self, path: str, compression: str = "none"):
        if compression not in ("none", "bz2", "lz4"):
            raise ValueError(f"unsupported compression {compression!r}")
        self.path = path
        self.compression = compression
        self.connections: dict[str, int] = {}
        self.conn_types: dict[str, str] = {}
        self.msgs: list = []

    def add_connection(self, topic: str, msg_type: str):
        if topic not in self.connections:
            self.connections[topic] = len(self.connections)
            self.conn_types[topic] = msg_type

    def write(self, topic: str, t: float, raw: bytes):
        self.msgs.append((topic, t, raw))

    @staticmethod
    def _record(header: dict, data: bytes) -> bytes:
        h = _encode_header(header)
        return (struct.pack("<I", len(h)) + h
                + struct.pack("<I", len(data)) + data)

    def close(self):
        records = []
        for topic, msg_type in self.conn_types.items():
            cid = self.connections[topic]
            sub = _encode_header({"topic": topic.encode(),
                                  "type": msg_type.encode(),
                                  "md5sum": b"0" * 32,
                                  "message_definition": b""})
            records.append(self._record(
                {"op": bytes([OP_CONNECTION]),
                 "conn": struct.pack("<I", cid),
                 "topic": topic.encode()}, sub))
        for topic, t, raw in sorted(self.msgs, key=lambda m: m[1]):
            secs = int(t)
            nsecs = int(round((t - secs) * 1e9))
            records.append(self._record(
                {"op": bytes([OP_MSG_DATA]),
                 "conn": struct.pack("<I", self.connections[topic]),
                 "time": struct.pack("<II", secs, nsecs)}, raw))
        chunk = b"".join(records)
        with open(self.path, "wb") as f:
            f.write(b"#ROSBAG V2.0\n")
            f.write(self._record(
                {"op": bytes([OP_BAG_HEADER]),
                 "index_pos": struct.pack("<Q", 0),
                 "conn_count": struct.pack("<I", len(self.connections)),
                 "chunk_count": struct.pack("<I", 1)},
                b" " * max(0, 4096)))
            payload = chunk
            if self.compression == "bz2":
                payload = bz2.compress(chunk)
            elif self.compression == "lz4":
                payload = _lz4.compress(chunk)
            f.write(self._record(
                {"op": bytes([OP_CHUNK]),
                 "compression": self.compression.encode(),
                 "size": struct.pack("<I", len(chunk))}, payload))


# ---------------------------------------------------------------------------
# message encoding (writer side, for tests)
# ---------------------------------------------------------------------------

def _enc_header(t: float, frame: str = "") -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    fb = frame.encode()
    return (struct.pack("<I", 0) + struct.pack("<II", secs, nsecs)
            + struct.pack("<I", len(fb)) + fb)


def encode_imu(t: float, acc, gyr) -> bytes:
    out = _enc_header(t)
    out += struct.pack("<4d", 0, 0, 0, 1)
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *gyr)
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *acc)
    out += struct.pack("<9d", *([0.0] * 9))
    return out


def encode_image(t: float, img: np.ndarray) -> bytes:
    h, w = img.shape
    data = np.clip(img, 0, 255).astype(np.uint8).tobytes()
    out = _enc_header(t)
    out += struct.pack("<II", h, w)
    enc = b"mono8"
    out += struct.pack("<I", len(enc)) + enc
    out += b"\x00"
    out += struct.pack("<I", w)
    out += struct.pack("<I", len(data)) + data
    return out


def encode_pointcloud2(t: float, pts: np.ndarray,
                       intensity: np.ndarray | None = None) -> bytes:
    n = len(pts)
    fields = [("x", 0), ("y", 4), ("z", 8)]
    point_step = 12
    if intensity is not None:
        fields.append(("intensity", 12))
        point_step = 16
    out = _enc_header(t)
    out += struct.pack("<II", 1, n)
    out += struct.pack("<I", len(fields))
    for name, off in fields:
        nb = name.encode()
        out += struct.pack("<I", len(nb)) + nb
        out += struct.pack("<III", off, 7, 1)      # float32, count 1
    out += b"\x00"
    out += struct.pack("<I", point_step)
    out += struct.pack("<I", point_step * n)
    buf = np.zeros((n, point_step // 4), np.float32)
    buf[:, 0:3] = pts
    if intensity is not None:
        buf[:, 3] = intensity
    data = buf.tobytes()
    out += struct.pack("<I", len(data)) + data
    return out


DECODERS = {
    "sensor_msgs/Imu": decode_imu,
    "sensor_msgs/Image": decode_image,
    "sensor_msgs/PointCloud2": decode_pointcloud2,
}


def play(path: str, imu_topic: str, image_topic: str, lidar_topic: str
         ) -> Iterator[tuple[str, float, tuple]]:
    """Yield ('imu'|'image'|'lidar', header_time, decoded...) in bag order —
    the rosbag-play replacement feeding VilSystem."""
    kinds = {imu_topic: "imu", image_topic: "image", lidar_topic: "lidar"}
    reader = BagReader(path)
    for msg in reader.messages(topics=set(kinds)):
        dec = DECODERS.get(msg.msg_type)
        if dec is None:
            continue
        decoded = dec(msg.raw)
        yield kinds[msg.topic], decoded[0], decoded[1:]
