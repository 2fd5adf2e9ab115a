"""Replica RGB-D loader (reference: dataset/dataloaders/replica.py:37-119):
results/<frameXXXXXX.jpg, depthXXXXXX.png> + traj.txt (flattened 4x4 rows);
Replica camera intrinsics, depth scale 6553.5.

The port's own copy of `pin_slam_tpu/dataset/dataloaders/replica.py`.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np

from pin_slam_tpu_torch.dataset.dataloaders.rgbd_utils import backproject_rgbd

H, W = 680, 1200
FX = FY = 600.0
CX, CY = 599.5, 339.5
DEPTH_SCALE = 6553.5


class ReplicaDataset:
    def __init__(self, data_dir, sequence: str = None, *args,
                 max_depth_m: float = 10.0, down_rate: int = 4, **kwargs):
        root = Path(data_dir)
        seq_dir = root / sequence if sequence else root
        res = seq_dir / "results"
        self.rgb_frames = sorted(glob.glob(str(res / "frame*.jpg")))
        self.depth_frames = sorted(glob.glob(str(res / "depth*.png")))
        if not self.depth_frames:
            raise FileNotFoundError(f"no frames under {res}")
        self.max_depth_m = max_depth_m
        self.down_rate = down_rate
        self.gt_poses = None
        traj = seq_dir / "traj.txt"
        if traj.exists():
            rows = np.loadtxt(str(traj))
            self.gt_poses = rows.reshape(-1, 4, 4)

    def __len__(self):
        return len(self.depth_frames)

    def __getitem__(self, idx):
        pts = backproject_rgbd(
            self.rgb_frames[idx], self.depth_frames[idx],
            FX, FY, CX, CY, DEPTH_SCALE, self.max_depth_m, self.down_rate)
        return {"points": pts, "point_ts": None}
