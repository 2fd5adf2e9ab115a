"""TUM RGB-D loader (reference: dataset/dataloaders/tum.py:31-175):
rgb.txt/depth.txt/groundtruth.txt association by timestamp, freiburg
intrinsics, depth scale 5000.

The port's own copy of `pin_slam_tpu/dataset/dataloaders/tum.py`.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from pin_slam_tpu_torch.dataset.dataloaders.rgbd_utils import backproject_rgbd

FX, FY, CX, CY = 525.0, 525.0, 319.5, 239.5
DEPTH_SCALE = 5000.0


class TUMDataset:
    def __init__(self, data_dir, sequence: str = None, *args,
                 max_depth_m: float = 8.0, down_rate: int = 4, **kwargs):
        root = Path(data_dir)
        seq_dir = root / sequence if sequence else root
        self.seq_dir = seq_dir
        rgb_list = self._parse_list(seq_dir / "rgb.txt")
        depth_list = self._parse_list(seq_dir / "depth.txt")
        gt_list = None
        gt_file = seq_dir / "groundtruth.txt"
        if gt_file.exists():
            gt_list = self._parse_list(gt_file)

        t_rgb = rgb_list[:, 0].astype(np.float64)
        t_depth = depth_list[:, 0].astype(np.float64)
        self.rgb_frames, self.depth_frames, poses = [], [], []
        for i, t in enumerate(t_rgb):
            j = int(np.argmin(np.abs(t_depth - t)))
            if abs(t_depth[j] - t) > 0.08:
                continue
            self.rgb_frames.append(str(seq_dir / rgb_list[i, 1]))
            self.depth_frames.append(str(seq_dir / depth_list[j, 1]))
            if gt_list is not None:
                k = int(np.argmin(np.abs(
                    gt_list[:, 0].astype(np.float64) - t)))
                poses.append(self._pose_from_quat(
                    gt_list[k, 1:].astype(np.float64)))
        self.gt_poses = np.stack(poses) if poses else None
        if self.gt_poses is not None:
            self.gt_poses = np.linalg.inv(self.gt_poses[0]) @ self.gt_poses
        self.max_depth_m = max_depth_m
        self.down_rate = down_rate

    @staticmethod
    def _parse_list(path):
        rows = []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                rows.append(line.strip().split())
        return np.array(rows, dtype=str)

    @staticmethod
    def _pose_from_quat(pvec):
        tx, ty, tz, qx, qy, qz, qw = pvec[:7]
        n = np.sqrt(qx**2 + qy**2 + qz**2 + qw**2)
        qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
        T = np.eye(4)
        T[:3, :3] = np.array([
            [1 - 2 * (qy**2 + qz**2), 2 * (qx * qy - qw * qz),
             2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx**2 + qz**2),
             2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
             1 - 2 * (qx**2 + qy**2)]])
        T[:3, 3] = [tx, ty, tz]
        return T

    def __len__(self):
        return len(self.depth_frames)

    def __getitem__(self, idx):
        pts = backproject_rgbd(
            self.rgb_frames[idx], self.depth_frames[idx],
            FX, FY, CX, CY, DEPTH_SCALE, self.max_depth_m, self.down_rate)
        return {"points": pts, "point_ts": None}
