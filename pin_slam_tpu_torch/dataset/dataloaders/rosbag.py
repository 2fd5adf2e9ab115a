"""ROS1 bag dataloader backed by the in-repo pure-Python bag reader
(pin_slam_tpu_torch/dataset/rosbag1.py) — no `rosbags` dependency.

Mirrors the reference loader's surface and semantics (reference:
dataset/dataloaders/rosbag.py:33-140): accepts one .bag file or a
directory of split bags (replayed merged in timestamp order), selects the
PointCloud2 topic (auto when unique), yields {"points", "point_ts"}.
ROS2 bags (sqlite/mcap-based) are not ROS1 format and raise.

The port's own copy of `pin_slam_tpu/dataset/dataloaders/rosbag.py`.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import List

from pin_slam_tpu_torch.dataset.rosbag1 import (
    Bag1Reader, deserialize_pointcloud2, read_point_cloud)

_PC2_TYPES = ("sensor_msgs/PointCloud2", "sensor_msgs/msg/PointCloud2")


class RosbagDataset:
    def __init__(self, data_dir, topic: str = "", *_, **__):
        data_dir = Path(data_dir)
        if data_dir.is_file():
            paths = [str(data_dir)]
        else:
            paths = sorted(glob.glob(os.path.join(str(data_dir), "*.bag")))
            if not paths:
                raise FileNotFoundError(f"no .bag files under {data_dir}")
        self.sequence_id = os.path.basename(paths[0]).split(".")[0]
        self.readers = [Bag1Reader(p) for p in paths]

        self.topic = self._check_topic(topic)
        # merged timestamp-ordered message list across split bags
        msgs = []
        for r in self.readers:
            for m in r.messages:
                if r.connections[m.conn].topic == self.topic:
                    msgs.append((m.time_ns, r, m))
        msgs.sort(key=lambda x: x[0])
        self._msgs = msgs
        self.timestamps: List[float] = []

    def __len__(self) -> int:
        return len(self._msgs)

    def __getitem__(self, idx: int):
        t_ns, reader, loc = self._msgs[idx]
        self.timestamps.append(t_ns / 1e9)
        msg = deserialize_pointcloud2(reader.read_message(loc))
        points, point_ts = read_point_cloud(msg)
        return {"points": points, "point_ts": point_ts}

    def get_frames_timestamps(self) -> List[float]:
        return self.timestamps

    def _check_topic(self, topic: str) -> str:
        available = {}
        for r in self.readers:
            for t, (mt, n) in r.topics().items():
                if mt in _PC2_TYPES:
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
            else "bag contains no sensor_msgs/PointCloud2 topics")
