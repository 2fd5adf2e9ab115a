"""Ouster pcap dataloader on an in-repo packet parser (no ouster-sdk).

Capability-equivalent rebuild of the reference loader
(reference: dataset/dataloaders/ouster.py:1-118), which wraps
`ouster.sdk.open_source` + `client.XYZLut`. Consistent with this repo's
from-scratch rosbag1/mcap readers, this module parses the capture
container and the sensor packets directly:

* pcap (classic, usec/nsec magic) and pcapng (SHB/IDB/EPB blocks) framing,
  ethernet + optional VLAN, IPv4 (with fragment reassembly), UDP;
* Ouster lidar packets in the LEGACY profile (16-byte column headers, 12-byte
  pixels, 4-byte column footer) and the eUDP single-return profile
  RNG19_RFL8_SIG16_NIR16 (32-byte packet header, 12-byte column headers,
  12-byte pixels);
* the documented beam-to-XYZ projection (staggered range image -> points):
      theta_enc = 2*pi*(1 - measurement_id / W)
      theta_az  = -2*pi*beam_azimuth_angles[r]/360
      phi       =  2*pi*beam_altitude_angles[r]/360
      xyz = (range - n)*[cos(theta_enc+theta_az)*cos(phi),
                         sin(theta_enc+theta_az)*cos(phi),
                         sin(phi)] + n*[cos(theta_enc), sin(theta_enc), 0]
  with n = lidar_origin_to_beam_origin_mm/1000, then the metadata's
  lidar_to_sensor_transform (the same frame `client.XYZLut` outputs).

Output dict matches the reference: {"points" [N,3] float64 in the sensor
frame, "point_ts" [N] in [0,1) column-normalized per-point time}.

Scans are indexed once at load (byte offsets per frame); pixels decode
lazily per __getitem__.

The port's own copy of `pin_slam_tpu/dataset/dataloaders/ouster.py`.
"""

import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------- container


def _iter_pcap_udp(path: str):
    """Yield (dst_port, payload_offset, payload_len, reassembled_payload)
    for every UDP datagram in a pcap/pcapng file. `reassembled_payload` is
    None when the datagram is a single unfragmented packet (read lazily via
    offset), bytes when it needed IP reassembly."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic in (b"\xd4\xc3\xb2\xa1", b"\xa1\xb2\xc3\xd4",
                     b"\x4d\x3c\xb2\xa1", b"\xa1\xb2\x3c\x4d"):
            yield from _iter_classic_pcap(f, magic)
        elif magic == b"\x0a\x0d\x0d\x0a":
            yield from _iter_pcapng(f)
        else:
            raise ValueError(f"not a pcap/pcapng file: {path}")


def _iter_classic_pcap(f, magic):
    le = magic in (b"\xd4\xc3\xb2\xa1", b"\x4d\x3c\xb2\xa1")
    end = "<" if le else ">"
    f.read(20)  # rest of the global header
    frags: Dict[tuple, dict] = {}
    while True:
        hdr = f.read(16)
        if len(hdr) < 16:
            return
        _, _, incl, _ = struct.unpack(end + "IIII", hdr)
        off = f.tell()
        data = f.read(incl)
        if len(data) < incl:
            return
        yield from _eth_to_udp(data, off, frags)


def _iter_pcapng(f):
    f.seek(0)
    frags: Dict[tuple, dict] = {}
    end = "<"
    while True:
        bh = f.read(8)
        if len(bh) < 8:
            return
        btype, blen = struct.unpack(end + "II", bh)
        if btype == 0x0A0D0D0A:  # section header: detect endianness
            body = f.read(blen - 12)
            bom = struct.unpack("<I", body[:4])[0]
            if bom == 0x4D3C2B1A:
                end = ">"
                _, blen = struct.unpack(end + "II", bh)
            f.read(4)
            continue
        body_off = f.tell()
        body = f.read(blen - 12)
        f.read(4)  # trailing block length
        if btype == 6:  # enhanced packet block
            cap_len = struct.unpack(end + "I", body[12:16])[0]
            pkt = body[20: 20 + cap_len]
            yield from _eth_to_udp(pkt, body_off + 20, frags)
        elif btype == 3:  # simple packet block
            pkt = body[4:]
            yield from _eth_to_udp(pkt, body_off + 4, frags)


def _eth_to_udp(data: bytes, file_off: int, frags: Dict[tuple, dict]):
    """Parse ethernet/IPv4/UDP; handle IPv4 fragmentation."""
    if len(data) < 34:
        return
    etype = struct.unpack(">H", data[12:14])[0]
    ip_off = 14
    if etype == 0x8100:  # VLAN tag
        etype = struct.unpack(">H", data[16:18])[0]
        ip_off = 18
    if etype != 0x0800:
        return
    ihl = (data[ip_off] & 0x0F) * 4
    proto = data[ip_off + 9]
    if proto != 17:
        return
    total_len = struct.unpack(">H", data[ip_off + 2: ip_off + 4])[0]
    ident = struct.unpack(">H", data[ip_off + 4: ip_off + 6])[0]
    flags_frag = struct.unpack(">H", data[ip_off + 6: ip_off + 8])[0]
    more = bool(flags_frag & 0x2000)
    frag_off = (flags_frag & 0x1FFF) * 8
    src = data[ip_off + 12: ip_off + 16]
    payload = data[ip_off + ihl: ip_off + total_len]

    if not more and frag_off == 0:
        # unfragmented: UDP header at payload start
        if len(payload) < 8:
            return
        dport = struct.unpack(">H", payload[2:4])[0]
        yield (dport, file_off + ip_off + ihl + 8, len(payload) - 8, None)
        return

    key = (ident, src)
    st = frags.setdefault(key, {"parts": [], "total": None})
    st["parts"].append((frag_off, payload))
    if not more:
        st["total"] = frag_off + len(payload)
    if st["total"] is not None:
        have = sum(len(p) for _, p in st["parts"])
        if have >= st["total"]:
            buf = bytearray(st["total"])
            for fo, p in st["parts"]:
                buf[fo: fo + len(p)] = p
            del frags[key]
            if len(buf) < 8:
                return
            dport = struct.unpack(">H", bytes(buf[2:4]))[0]
            yield (dport, -1, len(buf) - 8, bytes(buf[8:]))


# ----------------------------------------------------------------- metadata


class _SensorInfo:
    """Normalized view over both metadata.json layouts (flat legacy and
    nested `beam_intrinsics`/`lidar_data_format` sensor_info)."""

    def __init__(self, meta: dict):
        beams = meta.get("beam_intrinsics", meta)
        self.altitude_deg = np.asarray(
            beams["beam_altitude_angles"], np.float64)
        self.azimuth_deg = np.asarray(
            beams["beam_azimuth_angles"], np.float64)
        self.n_m = float(beams.get(
            "lidar_origin_to_beam_origin_mm", 15.806)) / 1000.0

        fmt = meta.get("lidar_data_format", meta.get("data_format", {}))
        self.h = int(fmt.get("pixels_per_column", len(self.altitude_deg)))
        self.w = int(fmt.get("columns_per_frame", 1024))
        self.cols_per_packet = int(fmt.get("columns_per_packet", 16))
        self.profile = fmt.get("udp_profile_lidar", "LEGACY")
        shift = fmt.get("pixel_shift_by_row")
        self.pixel_shift = (np.asarray(shift, np.int64)
                            if shift is not None else None)

        intr = meta.get("lidar_intrinsics", meta)
        t = intr.get("lidar_to_sensor_transform")
        self.lidar_to_sensor = (
            np.asarray(t, np.float64).reshape(4, 4) if t is not None
            else np.diag([-1.0, -1.0, 1.0, 1.0]))  # default: 180° about z
        # translation is in mm in the metadata
        self.lidar_to_sensor = self.lidar_to_sensor.copy()
        self.lidar_to_sensor[:3, 3] /= 1000.0

        conf = meta.get("config_params", meta)
        self.udp_port = int(conf.get("udp_port_lidar", 7502))

    # packet layout ------------------------------------------------------

    def column_nbytes(self) -> int:
        if self.profile == "LEGACY":
            return 16 + 12 * self.h + 4
        return 12 + 12 * self.h

    def packet_nbytes(self) -> int:
        body = self.cols_per_packet * self.column_nbytes()
        if self.profile == "LEGACY":
            return body
        return 32 + body  # eUDP packet header


# ------------------------------------------------------------------ loader


class OusterDataloader:
    """Ouster pcap dataloader (reference:
    dataset/dataloaders/ouster.py:31-118) on the in-repo parser."""

    def __init__(self, data_dir: str, meta: Optional[str] = None,
                 *_, **__):
        assert os.path.isfile(data_dir), \
            "Ouster pcap dataloader expects an existing PCAP file"
        self._pcap_file = str(data_dir)
        self.data_dir = os.path.dirname(data_dir)

        meta_path = meta or self._find_metadata(data_dir)
        if meta_path is None or not os.path.isfile(meta_path):
            raise FileNotFoundError(
                "Ouster pcap needs the recording's metadata json (pass "
                "`meta` or store it next to the pcap)")
        with open(meta_path) as fp:
            self.info = _SensorInfo(json.load(fp))

        self._xyz_dir, self._xyz_org = self._make_xyz_lut(self.info)

        # index: frame_id -> list of (file_offset, nbytes, payload_or_None)
        print("Indexing Ouster pcap to count the scans number ...")
        self._index: List[List[Tuple[int, int, Optional[bytes]]]] = []
        self._frame_ts: List[int] = []
        self._scan_index(data_dir)
        self._scans_num = len(self._index)
        print(f"Ouster pcap total scans number:  {self._scans_num}")
        self._timestamps = 1e-9 * np.asarray(self._frame_ts, np.float64)

    # ------------------------------------------------------------- indexing

    @staticmethod
    def _find_metadata(pcap_path: str) -> Optional[str]:
        """Longest-common-prefix .json next to the pcap (reference :63-66)."""
        d = os.path.dirname(pcap_path) or "."
        stem = os.path.basename(pcap_path)
        best, best_len = None, -1
        for fn in os.listdir(d):
            if not fn.endswith(".json"):
                continue
            n = len(os.path.commonprefix([stem, fn]))
            if n > best_len:
                best, best_len = os.path.join(d, fn), n
        return best

    def _scan_index(self, path: str):
        info = self.info
        want = info.packet_nbytes()
        cur_fid = None
        cur: List[Tuple[int, int, Optional[bytes]]] = []
        cur_ts = 0
        for dport, off, nbytes, payload in _iter_pcap_udp(path):
            if dport != info.udp_port or nbytes != want:
                continue
            head = payload if payload is not None else None
            if head is None:
                with open(path, "rb") as f:
                    f.seek(off)
                    head = f.read(24 if info.profile == "LEGACY" else 44)
            if info.profile == "LEGACY":
                ts, _mid, fid = struct.unpack("<QHH", head[:12])
            else:
                fid = struct.unpack("<H", head[2:4])[0]
                ts = struct.unpack("<Q", head[32:40])[0]
            if fid != cur_fid:
                if cur:
                    self._index.append(cur)
                    self._frame_ts.append(cur_ts)
                cur, cur_fid, cur_ts = [], fid, ts
            cur.append((off, nbytes, payload))
        if cur:
            self._index.append(cur)
            self._frame_ts.append(cur_ts)

    # ------------------------------------------------------------ projection

    @staticmethod
    def _make_xyz_lut(info: _SensorInfo):
        """Direction + origin-offset lookup tables [H, W, 3] such that
        xyz = dir * range_m + org for staggered range images."""
        h, w = info.h, info.w
        mid = np.arange(w, dtype=np.float64)
        theta_enc = 2.0 * np.pi * (1.0 - mid / w)                  # [W]
        theta_az = -2.0 * np.pi * info.azimuth_deg / 360.0         # [H]
        phi = 2.0 * np.pi * info.altitude_deg / 360.0              # [H]
        a = theta_enc[None, :] + theta_az[:, None]                 # [H, W]
        dirs = np.stack([np.cos(a) * np.cos(phi)[:, None],
                         np.sin(a) * np.cos(phi)[:, None],
                         np.broadcast_to(np.sin(phi)[:, None], (h, w))], -1)
        org = np.stack([np.cos(theta_enc), np.sin(theta_enc),
                        np.zeros(w)], -1)[None] * info.n_m \
            - dirs * info.n_m
        R = info.lidar_to_sensor[:3, :3]
        t = info.lidar_to_sensor[:3, 3]
        return dirs @ R.T, org @ R.T + t

    # -------------------------------------------------------------- reading

    def _decode_frame(self, packets) -> np.ndarray:
        """Range image [H, W] in meters (0 = no return)."""
        info = self.info
        h, cpp = info.h, info.cols_per_packet
        rng = np.zeros((info.h, info.w), np.float64)
        col_sz = info.column_nbytes()
        for off, nbytes, payload in packets:
            if payload is None:
                with open(self._pcap_file, "rb") as f:
                    f.seek(off)
                    payload = f.read(nbytes)
            body = payload if info.profile == "LEGACY" else payload[32:]
            for c in range(cpp):
                blk = body[c * col_sz: (c + 1) * col_sz]
                if info.profile == "LEGACY":
                    _ts, mid = struct.unpack("<QH", blk[:10])
                    status = struct.unpack("<I", blk[-4:])[0]
                    if status != 0xFFFFFFFF:
                        continue
                    px = np.frombuffer(blk[16: 16 + 12 * h],
                                       np.uint32).reshape(h, 3)
                    r = (px[:, 0] & 0xFFFFF).astype(np.float64) / 1000.0
                else:
                    _ts, mid, status = struct.unpack("<QHH", blk[:12])
                    if not (status & 0x1):
                        continue
                    px = np.frombuffer(blk[12: 12 + 12 * h],
                                       np.uint32).reshape(h, 3)
                    r = (px[:, 0] & 0x7FFFF).astype(
                        np.float64) / 1000.0  # RNG19: mm resolution
                if 0 <= mid < info.w:
                    rng[:, mid] = r
        return rng

    def __getitem__(self, idx):
        info = self.info
        rng = self._decode_frame(self._index[idx])
        sel = rng > 0
        xyz = self._xyz_dir * rng[..., None] + self._xyz_org
        # column-normalized per-point time (reference :108-112)
        ts01 = np.tile(
            np.linspace(0, 1.0, info.w, endpoint=False), (info.h, 1))
        return {"points": xyz[sel], "point_ts": ts01[sel]}

    def get_frames_timestamps(self) -> np.ndarray:
        return self._timestamps

    def __len__(self):
        return self._scans_num
