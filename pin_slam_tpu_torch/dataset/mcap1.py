"""Pure-Python MCAP reader for ROS2 PointCloud2 streams — no `mcap` /
`mcap-ros2-support` dependency. Parses the record stream (Schema /
Channel / Message / Chunk), supports uncompressed chunks (lz4/zstd need
external codecs and raise), and deserializes sensor_msgs/msg/PointCloud2
from CDR ("cdr" channels) or the ROS1 wire format ("ros1" channels,
rosbridge-recorded files).

Replaces the reference's mcap dependency for the mcap dataloader
(reference: dataset/dataloaders/mcap.py:29-40).

MCAP spec: https://mcap.dev/spec — records are <u8 opcode><u64 len>
<payload>; strings are u32-length-prefixed UTF-8.

The port's own copy of `pin_slam_tpu/dataset/mcap1.py`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from pin_slam_tpu_torch.utils import point_cloud2 as pc2

MAGIC = b"\x89MCAP0\r\n"

OP_HEADER = 0x01
OP_SCHEMA = 0x03
OP_CHANNEL = 0x04
OP_MESSAGE = 0x05
OP_CHUNK = 0x06
OP_DATA_END = 0x0F


@dataclass
class _Channel:
    cid: int
    topic: str
    message_encoding: str
    schema_name: str


@dataclass
class _Msg:
    cid: int
    log_time: int
    chunk_idx: int   # -1 = top-level
    offset: int
    length: int


@dataclass
class _ChunkLoc:
    file_offset: int   # of the records byte array
    comp: str
    comp_len: int


def _read_str(buf: bytes, i: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, i)
    return buf[i + 4: i + 4 + n].decode(), i + 4 + n


class McapReader:
    """Index an MCAP file; read PointCloud2 messages lazily (one-chunk
    decompression cache)."""

    def __init__(self, path: str):
        self.path = path
        self.schemas: Dict[int, str] = {}
        self.channels: Dict[int, _Channel] = {}
        self.chunks: List[_ChunkLoc] = []
        self.messages: List[_Msg] = []
        self._cache: Tuple[int, bytes] = (-2, b"")
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path}: not an MCAP file")
            self._scan(f)
        self.messages.sort(key=lambda m: m.log_time)

    # ----------------------------------------------------------- scanning

    def _scan(self, f):
        while True:
            head = f.read(9)
            if len(head) < 9:
                return
            op = head[0]
            (ln,) = struct.unpack("<Q", head[1:9])
            if op == OP_DATA_END:
                return
            if op == OP_CHUNK:
                payload_off = f.tell()
                # start/end times u64x2, uncompressed_size u64, crc u32,
                # compression string, records byte array (u64 length)
                f.seek(24 + 4, 1)
                (clen,) = struct.unpack("<I", f.read(4))
                comp = f.read(clen).decode()
                (rec_len,) = struct.unpack("<Q", f.read(8))
                ci = len(self.chunks)
                self.chunks.append(_ChunkLoc(f.tell(), comp, rec_len))
                data = self._decompress(ci, f.read(rec_len))
                self._scan_records(data, ci)
                f.seek(payload_off + ln)
            elif op in (OP_SCHEMA, OP_CHANNEL, OP_MESSAGE):
                payload = f.read(ln)
                self._one_record(op, payload, -1, None)
            else:
                f.seek(ln, 1)

    def _scan_records(self, data: bytes, chunk_idx: int):
        i = 0
        n = len(data)
        while i + 9 <= n:
            op = data[i]
            (ln,) = struct.unpack_from("<Q", data, i + 1)
            payload_off = i + 9
            self._one_record(op, data[payload_off: payload_off + ln],
                             chunk_idx, payload_off)
            i = payload_off + ln

    def _one_record(self, op: int, payload: bytes, chunk_idx: int,
                    chunk_off: Optional[int]):
        if op == OP_SCHEMA:
            (sid,) = struct.unpack_from("<H", payload, 0)
            name, _ = _read_str(payload, 2)
            self.schemas[sid] = name
        elif op == OP_CHANNEL:
            (cid,) = struct.unpack_from("<H", payload, 0)
            (sid,) = struct.unpack_from("<H", payload, 2)
            topic, i = _read_str(payload, 4)
            enc, _ = _read_str(payload, i)
            self.channels[cid] = _Channel(
                cid, topic, enc, self.schemas.get(sid, ""))
        elif op == OP_MESSAGE:
            (cid,) = struct.unpack_from("<H", payload, 0)
            (log_time,) = struct.unpack_from("<Q", payload, 6)
            data_off = 2 + 4 + 8 + 8
            if chunk_idx < 0:
                # top-level: store the message bytes directly (rare path)
                self._toplevel = getattr(self, "_toplevel", [])
                self.messages.append(_Msg(cid, log_time, -1,
                                          len(self._toplevel), 0))
                self._toplevel.append(payload[data_off:])
            else:
                self.messages.append(_Msg(
                    cid, log_time, chunk_idx, chunk_off + data_off,
                    len(payload) - data_off))

    def _decompress(self, chunk_idx: int, payload: bytes) -> bytes:
        comp = self.chunks[chunk_idx].comp
        if comp in ("", "none"):
            return payload
        raise NotImplementedError(
            f"mcap chunk compression '{comp}' needs an external codec")

    # ------------------------------------------------------------ reading

    def topics(self) -> Dict[str, Tuple[str, str, int]]:
        """{topic: (schema_name, message_encoding, count)}"""
        out: Dict[str, Tuple[str, str, int]] = {}
        for m in self.messages:
            c = self.channels[m.cid]
            s, e, n = out.get(c.topic, (c.schema_name,
                                        c.message_encoding, 0))
            out[c.topic] = (s, e, n + 1)
        return out

    def read_message(self, m: _Msg) -> bytes:
        if m.chunk_idx < 0:
            return self._toplevel[m.offset]
        if self._cache[0] != m.chunk_idx:
            ch = self.chunks[m.chunk_idx]
            with open(self.path, "rb") as f:
                f.seek(ch.file_offset)
                self._cache = (m.chunk_idx,
                               self._decompress(m.chunk_idx,
                                                f.read(ch.comp_len)))
        return self._cache[1][m.offset: m.offset + m.length]


# ------------------------------------------------- CDR (ROS2) PointCloud2


class _Cdr:
    """Little-endian CDR cursor (XCDR1): primitives align to their size
    relative to the start of the serialized body (after the 4-byte
    encapsulation header)."""

    def __init__(self, raw: bytes):
        if raw[:2] not in (b"\x00\x01", b"\x00\x00"):
            raise ValueError("unsupported CDR encapsulation")
        self.le = raw[1] in (1, 3)
        self.buf = raw
        self.i = 4

    def _align(self, size: int):
        off = (self.i - 4) % size
        if off:
            self.i += size - off

    def u(self, fmt: str, size: int):
        self._align(size)
        (v,) = struct.unpack_from(("<" if self.le else ">") + fmt,
                                  self.buf, self.i)
        self.i += size
        return v

    def u8(self):
        return self.u("B", 1)

    def u32(self):
        return self.u("I", 4)

    def i32(self):
        return self.u("i", 4)

    def string(self) -> str:
        n = self.u32()                    # length INCLUDING the NUL
        s = self.buf[self.i: self.i + max(n - 1, 0)].decode()
        self.i += n
        return s

    def bytes_seq(self) -> np.ndarray:
        n = self.u32()
        out = np.frombuffer(self.buf, np.uint8, n, self.i)
        self.i += n
        return out


def deserialize_pointcloud2_cdr(raw: bytes) -> pc2.SimplePointCloud2:
    """ROS2 sensor_msgs/msg/PointCloud2 from CDR bytes."""
    c = _Cdr(raw)
    c.i32()                      # header.stamp.sec
    c.u32()                      # header.stamp.nanosec
    frame_id = c.string()
    height, width = c.u32(), c.u32()
    nf = c.u32()
    fields = []
    for _ in range(nf):
        name = c.string()
        off = c.u32()
        dt = c.u8()
        cnt = c.u32()
        fields.append(pc2._Field(name, off, dt, cnt))
    is_bigendian = bool(c.u8())
    point_step, row_step = c.u32(), c.u32()
    data = c.bytes_seq()
    obj = pc2.SimplePointCloud2.__new__(pc2.SimplePointCloud2)
    obj.fields = fields
    obj.height = height
    obj.width = width
    obj.is_bigendian = is_bigendian
    obj.point_step = point_step
    obj.row_step = row_step
    obj.data = data
    obj.header = type("H", (), {"frame_id": frame_id})()
    return obj


def serialize_cloud_cdr(msg, stamp: float = 0.0,
                        frame_id: str = "lidar") -> bytes:
    """A PointCloud2-shaped object -> ROS2 PointCloud2 CDR bytes."""
    out = bytearray(b"\x00\x01\x00\x00")

    def align(size):
        off = (len(out) - 4) % size
        if off:
            out.extend(b"\x00" * (size - off))

    def u32(v):
        align(4)
        out.extend(struct.pack("<I", v))

    def string(s):
        b = s.encode() + b"\x00"
        u32(len(b))
        out.extend(b)

    u32(int(stamp))                       # sec (i32)
    u32(int((stamp % 1) * 1e9))           # nanosec
    string(frame_id)
    u32(msg.height)
    u32(msg.width)
    u32(len(msg.fields))
    for f in msg.fields:
        string(f.name)
        u32(f.offset)
        out.append(f.datatype)            # u8
        u32(getattr(f, "count", 1) or 1)
    out.append(int(bool(msg.is_bigendian)))
    u32(msg.point_step)
    u32(msg.row_step)
    data = bytes(msg.data)
    u32(len(data))
    out.extend(data)
    out.append(1)                         # is_dense
    return bytes(out)


def serialize_pointcloud2_cdr(points: np.ndarray, stamp: float = 0.0,
                              frame_id: str = "lidar",
                              point_ts=None) -> bytes:
    """points -> CDR bytes (writer/tests)."""
    from pin_slam_tpu_torch.dataset.rosbag1 import make_cloud

    return serialize_cloud_cdr(make_cloud(points, point_ts), stamp,
                               frame_id)


def write_mcap(path: str, clouds, topic: str = "/points",
               hz: float = 10.0, encoding: str = "cdr", t0: float = 0.0):
    """Write a minimal uncompressed MCAP of PointCloud2 messages, message
    k logged at t0 + k / hz (writer for tests/tooling). `clouds` holds
    arrays, (points, point_ts) tuples or PointCloud2-shaped objects, as
    `rosbag1.write_bag1` takes them."""
    from pin_slam_tpu_torch.dataset.rosbag1 import as_cloud, serialize_cloud

    def rec(op: int, payload: bytes) -> bytes:
        return bytes([op]) + struct.pack("<Q", len(payload)) + payload

    def s(x: str) -> bytes:
        b = x.encode()
        return struct.pack("<I", len(b)) + b

    schema_name = ("sensor_msgs/msg/PointCloud2" if encoding == "cdr"
                   else "sensor_msgs/PointCloud2")
    records = [
        rec(OP_SCHEMA, struct.pack("<H", 1) + s(schema_name)
            + s("ros2msg" if encoding == "cdr" else "ros1msg") + s("")),
        rec(OP_CHANNEL, struct.pack("<HH", 1, 1) + s(topic) + s(encoding)
            + struct.pack("<I", 0)),
    ]
    ser = serialize_cloud_cdr if encoding == "cdr" else serialize_cloud
    for k, c in enumerate(clouds):
        t = t0 + k / hz
        body = ser(as_cloud(c), stamp=t)
        records.append(rec(
            OP_MESSAGE,
            struct.pack("<HIQQ", 1, k, int(t * 1e9), int(t * 1e9)) + body))
    inner = b"".join(records)
    chunk = (struct.pack("<QQQ", 0, 0, len(inner))   # start/end/uncomp
             + struct.pack("<I", 0)                  # crc (0 = absent)
             + s("")                                 # compression none
             + struct.pack("<Q", len(inner)) + inner)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(rec(OP_HEADER, s("ros2") + s("pin_slam_tpu_torch")))
        f.write(rec(OP_CHUNK, chunk))
        f.write(rec(OP_DATA_END, struct.pack("<I", 0)))
        f.write(MAGIC)
