"""Pure-Python ROS1 bag (format 2.0) reader and writer — no `rosbags`
dependency. Parses the record/chunk structure, indexes
sensor_msgs/PointCloud2 messages per topic, and deserializes them with
the ROS1 wire format into objects the in-repo PointCloud2 parser
(pin_slam_tpu_torch/utils/point_cloud2.py) consumes. Supports uncompressed and
bz2 chunks (lz4 needs an external codec and raises).

Replaces the reference's `rosbags.highlevel.AnyReader` dependency for the
rosbag dataloader (reference: dataset/dataloaders/rosbag.py:33-88).

Bag format: http://wiki.ros.org/Bags/Format/2.0
  file := "#ROSBAG V2.0\n" record*
  record := <u32 hlen> header <u32 dlen> data
  header := (<u32 flen> name "=" value)*
  ops: 0x03 bag header, 0x05 chunk, 0x07 connection, 0x02 message data,
       0x04 index data, 0x06 chunk info

The port's own copy of `pin_slam_tpu/dataset/rosbag1.py`.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from pin_slam_tpu_torch.utils import point_cloud2 as pc2

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAGHDR = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNKINFO = 0x06
OP_CONN = 0x07


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    out = {}
    i = 0
    n = len(buf)
    while i + 4 <= n:
        (flen,) = struct.unpack_from("<I", buf, i)
        i += 4
        field = buf[i: i + flen]
        i += flen
        eq = field.index(b"=")
        out[field[:eq]] = field[eq + 1:]
    return out


def _encode_header(fields: Dict[bytes, bytes]) -> bytes:
    parts = []
    for k, v in fields.items():
        f = k + b"=" + v
        parts.append(struct.pack("<I", len(f)) + f)
    return b"".join(parts)


@dataclass
class _Conn:
    cid: int
    topic: str
    msgtype: str


@dataclass
class _MsgLoc:
    conn: int
    time_ns: int
    # either (chunk_idx, offset) into a decompressed chunk, or
    # (-1, file_offset) for messages outside chunks
    chunk_idx: int
    offset: int
    length: int


@dataclass
class _Chunk:
    file_offset: int     # of the chunk DATA
    comp: str            # "none" | "bz2" | "lz4"
    comp_len: int
    raw_len: int


class Bag1Reader:
    """Index a ROS1 v2.0 bag; iterate messages of one topic lazily
    (the last touched chunk stays decompressed in a 1-entry cache)."""

    def __init__(self, path: str):
        self.path = path
        self.connections: Dict[int, _Conn] = {}
        self.chunks: List[_Chunk] = []
        self.messages: List[_MsgLoc] = []
        self._cache: Tuple[int, bytes] = (-2, b"")
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path}: not a ROS1 v2.0 bag")
            self._scan(f)
        self.messages.sort(key=lambda m: m.time_ns)

    # ------------------------------------------------------------ scanning

    def _read_record(self, f):
        pos = f.tell()
        raw = f.read(4)
        if len(raw) < 4:
            return None
        (hlen,) = struct.unpack("<I", raw)
        hdr = _parse_header(f.read(hlen))
        (dlen,) = struct.unpack("<I", f.read(4))
        data_off = f.tell()
        return pos, hdr, dlen, data_off

    def _scan(self, f):
        while True:
            rec = self._read_record(f)
            if rec is None:
                return
            _, hdr, dlen, data_off = rec
            op = hdr[b"op"][0]
            if op == OP_CONN:
                self._add_conn(hdr, f.read(dlen))
            elif op == OP_CHUNK:
                comp = hdr.get(b"compression", b"none").decode()
                (raw_len,) = struct.unpack("<I", hdr[b"size"])
                ci = len(self.chunks)
                self.chunks.append(_Chunk(data_off, comp, dlen, raw_len))
                if comp == "none":
                    # index sub-records in place without copying
                    self._scan_chunk(f.read(dlen), ci)
                else:
                    self._scan_chunk(self._decompress(ci, f.read(dlen)), ci)
            elif op == OP_MSG:
                (cid,) = struct.unpack("<I", hdr[b"conn"])
                t = struct.unpack("<II", hdr[b"time"])
                self.messages.append(_MsgLoc(
                    cid, t[0] * 1_000_000_000 + t[1], -1, data_off, dlen))
                f.seek(data_off + dlen)
            else:
                f.seek(data_off + dlen)

    def _scan_chunk(self, data: bytes, chunk_idx: int):
        i = 0
        n = len(data)
        while i + 4 <= n:
            (hlen,) = struct.unpack_from("<I", data, i)
            hdr = _parse_header(data[i + 4: i + 4 + hlen])
            (dlen,) = struct.unpack_from("<I", data, i + 4 + hlen)
            doff = i + 8 + hlen
            op = hdr[b"op"][0]
            if op == OP_CONN:
                self._add_conn(hdr, data[doff: doff + dlen])
            elif op == OP_MSG:
                (cid,) = struct.unpack("<I", hdr[b"conn"])
                t = struct.unpack("<II", hdr[b"time"])
                self.messages.append(_MsgLoc(
                    cid, t[0] * 1_000_000_000 + t[1], chunk_idx, doff,
                    dlen))
            i = doff + dlen

    def _add_conn(self, hdr: Dict[bytes, bytes], data: bytes):
        (cid,) = struct.unpack("<I", hdr[b"conn"])
        sub = _parse_header(data)
        topic = (sub.get(b"topic") or hdr.get(b"topic", b"")).decode()
        msgtype = sub.get(b"type", b"").decode()
        self.connections[cid] = _Conn(cid, topic, msgtype)

    def _decompress(self, chunk_idx: int, payload: bytes) -> bytes:
        comp = self.chunks[chunk_idx].comp
        if comp == "none":
            return payload
        if comp == "bz2":
            return bz2.decompress(payload)
        raise NotImplementedError(
            f"bag chunk compression '{comp}' needs an external codec")

    # ------------------------------------------------------------- reading

    def topics(self) -> Dict[str, Tuple[str, int]]:
        """{topic: (msgtype, msgcount)}"""
        out: Dict[str, Tuple[str, int]] = {}
        for m in self.messages:
            c = self.connections[m.conn]
            t, n = out.get(c.topic, (c.msgtype, 0))
            out[c.topic] = (t, n + 1)
        return out

    def _chunk_bytes(self, chunk_idx: int) -> bytes:
        if self._cache[0] == chunk_idx:
            return self._cache[1]
        ch = self.chunks[chunk_idx]
        with open(self.path, "rb") as f:
            f.seek(ch.file_offset)
            data = self._decompress(chunk_idx, f.read(ch.comp_len))
        self._cache = (chunk_idx, data)
        return data

    def read_message(self, m: _MsgLoc) -> bytes:
        if m.chunk_idx < 0:
            with open(self.path, "rb") as f:
                f.seek(m.offset)
                return f.read(m.length)
        data = self._chunk_bytes(m.chunk_idx)
        return data[m.offset: m.offset + m.length]

    def iter_topic(self, topic: str):
        """Yield (time_ns, raw message bytes) in timestamp order."""
        for m in self.messages:
            if self.connections[m.conn].topic == topic:
                yield m.time_ns, self.read_message(m)


# --------------------------------------------------- PointCloud2 (de)ser


def deserialize_pointcloud2(raw: bytes) -> pc2.SimplePointCloud2:
    """ROS1 wire format -> SimplePointCloud2 (little-endian, the ROS1
    serialization byte order)."""
    i = 0

    def u32():
        nonlocal i
        (v,) = struct.unpack_from("<I", raw, i)
        i += 4
        return v

    def u8():
        nonlocal i
        v = raw[i]
        i += 1
        return v

    u32()                       # header.seq
    sec, nsec = u32(), u32()    # header.stamp
    flen = u32()
    frame_id = raw[i: i + flen].decode()
    i += flen
    height, width = u32(), u32()
    nf = u32()
    fields = []
    for _ in range(nf):
        nlen = u32()
        name = raw[i: i + nlen].decode()
        i += nlen
        off = u32()
        dt = u8()
        cnt = u32()
        fields.append(pc2._Field(name, off, dt, cnt))
    is_bigendian = bool(u8())
    point_step, row_step = u32(), u32()
    dlen = u32()
    data = np.frombuffer(raw, np.uint8, dlen, i)
    i += dlen
    obj = pc2.SimplePointCloud2.__new__(pc2.SimplePointCloud2)
    obj.fields = fields
    obj.height = height
    obj.width = width
    obj.is_bigendian = is_bigendian
    obj.point_step = point_step
    obj.row_step = row_step
    obj.data = data
    obj.header = type("H", (), {"frame_id": frame_id,
                                "stamp": sec + nsec * 1e-9})()
    return obj


def make_cloud(points: np.ndarray,
               point_ts: Optional[np.ndarray] = None
               ) -> pc2.SimplePointCloud2:
    """[N,3] points (+ optional per-point times) -> the unorganised x, y, z
    (+ `time`) float32 cloud the writers store for arrays."""
    n = points.shape[0]
    fields = [pc2._Field("x", 0, pc2.FLOAT32), pc2._Field("y", 4, pc2.FLOAT32),
              pc2._Field("z", 8, pc2.FLOAT32)]
    step = 12
    if point_ts is not None:
        fields.append(pc2._Field("time", 12, pc2.FLOAT32))
        step = 16
    buf = np.zeros((n, step), np.uint8)
    buf[:, 0:12] = points.astype(np.float32).view(np.uint8).reshape(n, 12)
    if point_ts is not None:
        buf[:, 12:16] = (np.asarray(point_ts, np.float32)
                         .view(np.uint8).reshape(n, 4))
    obj = pc2.SimplePointCloud2.__new__(pc2.SimplePointCloud2)
    obj.fields = fields
    obj.height, obj.width = 1, n
    obj.is_bigendian = False
    obj.point_step, obj.row_step = step, step * n
    obj.data = buf.tobytes()
    return obj


def as_cloud(item) -> pc2.SimplePointCloud2:
    """A writer's input item: a PointCloud2-shaped object (any field
    layout, organised or not) as it is, an [N,3] array or a (points,
    point_ts) tuple through `make_cloud`."""
    if hasattr(item, "fields"):
        return item
    pts, ts = item if isinstance(item, tuple) else (item, None)
    return make_cloud(np.asarray(pts), ts)


def serialize_cloud(msg, stamp: float = 0.0,
                    frame_id: str = "lidar") -> bytes:
    """A PointCloud2-shaped object -> ROS1 PointCloud2 wire bytes."""
    data = bytes(msg.data)
    out = [struct.pack("<I", 0),
           struct.pack("<II", int(stamp), int((stamp % 1) * 1e9)),
           struct.pack("<I", len(frame_id)), frame_id.encode(),
           struct.pack("<II", msg.height, msg.width),
           struct.pack("<I", len(msg.fields))]
    for f in msg.fields:
        out += [struct.pack("<I", len(f.name)), f.name.encode(),
                struct.pack("<IBI", f.offset, f.datatype,
                            getattr(f, "count", 1) or 1)]
    out += [bytes([bool(msg.is_bigendian)]),
            struct.pack("<II", msg.point_step, msg.row_step),
            struct.pack("<I", len(data)), data, b"\x01"]
    return b"".join(out)


def serialize_pointcloud2(points: np.ndarray, stamp: float = 0.0,
                          frame_id: str = "lidar",
                          point_ts: Optional[np.ndarray] = None) -> bytes:
    """points [N,3] (+ optional per-point times) -> ROS1 PointCloud2
    wire bytes (for the writer/tests)."""
    return serialize_cloud(make_cloud(points, point_ts), stamp, frame_id)


def write_bag1(path: str, clouds, topic: str = "/points",
               hz: float = 10.0, compression: str = "none",
               t0: float = 0.0, chunk_msgs: int = 0):
    """Write a minimal single-connection ROS1 v2.0 bag of PointCloud2
    messages, message k stamped t0 + k / hz. `clouds` is an iterable of
    [N,3] arrays, (points, point_ts) tuples or PointCloud2-shaped objects
    (`as_cloud`). The messages go into uncompressed or bz2 chunks of
    `chunk_msgs` messages each (0: one chunk, the JAX package's layout)."""
    def record(hdr: Dict[bytes, bytes], data: bytes) -> bytes:
        h = _encode_header(hdr)
        return (struct.pack("<I", len(h)) + h
                + struct.pack("<I", len(data)) + data)

    conn_sub = _encode_header({
        b"topic": topic.encode(),
        b"type": b"sensor_msgs/PointCloud2",
        b"md5sum": b"1158d486dd51d683ce2f1be655c3c181",
        b"message_definition": b"",
    })
    chunks = [[record({b"op": bytes([OP_CONN]),
                       b"conn": struct.pack("<I", 0),
                       b"topic": topic.encode()}, conn_sub)]]
    for k, c in enumerate(clouds):
        if chunk_msgs and len(chunks[-1]) >= chunk_msgs + (len(chunks) == 1):
            chunks.append([])
        t = t0 + k / hz
        msg = serialize_cloud(as_cloud(c), stamp=t)
        chunks[-1].append(record(
            {b"op": bytes([OP_MSG]), b"conn": struct.pack("<I", 0),
             b"time": struct.pack("<II", int(t), int((t % 1) * 1e9))},
            msg))

    with open(path, "wb") as f:
        f.write(MAGIC)
        # bag header record (data padded to 4096 per format convention)
        bh = record({b"op": bytes([OP_BAGHDR]),
                     b"index_pos": struct.pack("<Q", 0),
                     b"conn_count": struct.pack("<I", 1),
                     b"chunk_count": struct.pack("<I", len(chunks))},
                    b" " * 4096)
        f.write(bh)
        for inner in chunks:
            payload = b"".join(inner)
            comp_payload = (bz2.compress(payload) if compression == "bz2"
                            else payload)
            f.write(record({b"op": bytes([OP_CHUNK]),
                            b"compression": compression.encode(),
                            b"size": struct.pack("<I", len(payload))},
                           comp_payload))


def read_point_cloud(msg: pc2.SimplePointCloud2):
    """PointCloud2 -> (points [N,3] f64, point_ts [N] normalized frame
    fraction or None) — reference semantics
    (reference: utils/point_cloud2.py:59-101); delegates to the in-repo
    structured-dtype parser."""
    pts, ts, _ = pc2.read_point_cloud2(msg)
    return pts, ts
