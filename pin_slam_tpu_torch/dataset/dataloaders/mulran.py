"""MulRan loader (reference: dataset/dataloaders/mulran.py:1-105):
Ouster .bin scans (xyzi float32), 64x1024 row-major timestamps, gt from
global_pose.csv matched by scan timestamp and re-based to the first pose.

The port's own copy of `pin_slam_tpu/dataset/dataloaders/mulran.py`.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np


class MulranDataset:
    def __init__(self, data_dir, *args, **kwargs):
        self.sequence_dir = Path(data_dir)
        self.scan_files = sorted(
            glob.glob(str(self.sequence_dir / "Ouster" / "*.bin")))
        if not self.scan_files:
            raise FileNotFoundError(
                f"no Ouster scans under {self.sequence_dir}")
        self.scan_timestamps = [
            int(os.path.basename(f).split(".")[0]) for f in self.scan_files]
        self.gt_poses = None
        gt_file = self.sequence_dir / "global_pose.csv"
        if gt_file.exists():
            self.gt_poses = self._load_gt_poses(str(gt_file))

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        points = np.fromfile(self.scan_files[idx],
                             dtype=np.float32).reshape(-1, 4)[:, :3]
        ts = self._timestamps()
        if points.shape[0] != ts.shape[0]:
            ts = None
        return {"points": points.astype(np.float64), "point_ts": ts}

    @staticmethod
    def _timestamps():
        H, W = 64, 1024
        return (np.floor(np.arange(H * W) / H) / W)

    def _load_gt_poses(self, poses_file: str) -> np.ndarray:
        data = np.loadtxt(poses_file, delimiter=",")
        timestamps = data[:, 0]
        rows = data[:, 1:]
        n = rows.shape[0]
        poses = np.concatenate(
            [rows, np.tile([0, 0, 0, 1.0], (n, 1))], axis=1).reshape(n, 4, 4)
        poses = poses[[int(np.argmin(np.abs(timestamps - t)))
                       for t in self.scan_timestamps]]
        return np.linalg.inv(poses[0]) @ poses
