"""MCAP dataloader backed by the in-repo pure-Python reader
(pin_slam_tpu_torch/dataset/mcap1.py) — no mcap / mcap-ros2-support packages.

Mirrors the reference loader surface (reference:
dataset/dataloaders/mcap.py:29-120): one .mcap file or a directory of
files read in name order, PointCloud2 topic auto-selected when unique,
frames as {"points", "point_ts"}. Handles "cdr" (ROS2) and "ros1"
channel encodings; compressed chunks (lz4/zstd) raise.

The port's own copy of `pin_slam_tpu/dataset/dataloaders/mcap.py`.
"""

from __future__ import annotations

import os
from typing import List

from pin_slam_tpu_torch.dataset.mcap1 import (
    McapReader, deserialize_pointcloud2_cdr)
from pin_slam_tpu_torch.dataset.rosbag1 import (
    deserialize_pointcloud2, read_point_cloud)

_PC2_SCHEMAS = ("sensor_msgs/msg/PointCloud2", "sensor_msgs/PointCloud2")


class McapDataloader:
    def __init__(self, data_dir, topic: str = "", *_, **__):
        data_dir = str(data_dir)
        if os.path.isfile(data_dir):
            paths = [data_dir]
        elif os.path.isdir(data_dir):
            paths = sorted(
                os.path.join(data_dir, f) for f in os.listdir(data_dir)
                if f.endswith(".mcap"))
            if not paths:
                raise FileNotFoundError(f"no .mcap files under {data_dir}")
        else:
            raise ValueError(f"{data_dir} is neither a file nor directory")
        self.sequence_id = os.path.basename(paths[0]).split(".")[0]
        self.readers = [McapReader(p) for p in paths]
        self.topic = self._check_topic(topic)

        msgs = []
        for r in self.readers:
            for m in r.messages:
                ch = r.channels[m.cid]
                if ch.topic == self.topic:
                    msgs.append((m.log_time, r, m, ch.message_encoding))
        msgs.sort(key=lambda x: x[0])
        self._msgs = msgs
        self.timestamps: List[float] = []

    def __len__(self) -> int:
        return len(self._msgs)

    def __getitem__(self, idx: int):
        t_ns, reader, loc, enc = self._msgs[idx]
        self.timestamps.append(t_ns / 1e9)
        raw = reader.read_message(loc)
        msg = (deserialize_pointcloud2_cdr(raw) if enc == "cdr"
               else deserialize_pointcloud2(raw))
        points, point_ts = read_point_cloud(msg)
        return {"points": points, "point_ts": point_ts}

    def get_frames_timestamps(self) -> List[float]:
        return self.timestamps

    def _check_topic(self, topic: str) -> str:
        available = {}
        for r in self.readers:
            for t, (schema, _enc, n) in r.topics().items():
                if schema in _PC2_SCHEMAS:
                    available[t] = available.get(t, 0) + n
        if topic:
            if topic in available:
                return topic
            raise ValueError(
                f"topic '{topic}' not found; PointCloud2 topics: "
                f"{sorted(available)}")
        if len(available) == 1:
            return next(iter(available))
        raise ValueError(
            "multiple PointCloud2 topics, pass one explicitly: "
            f"{sorted(available)}" if available
            else "file contains no PointCloud2 topics")
