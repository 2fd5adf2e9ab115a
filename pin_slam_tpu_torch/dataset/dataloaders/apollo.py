"""Apollo (SouthBay) loader (reference: dataset/dataloaders/apollo.py:35-76
— rebuilt: in-repo PCD reader + quaternion math, no open3d/pyquaternion).

Layout:
  <root>/pcds/*.pcd                (naturally sorted, e.g. 1.pcd .. 102.pcd)
  <root>/poses/gt_poses.txt        rows: idx ts x y z qx qy qz qw

The port's own copy of `pin_slam_tpu/dataset/dataloaders/apollo.py`.
"""

from __future__ import annotations

import glob
import os
import re
from pathlib import Path

import numpy as np

from pin_slam_tpu_torch.dataset import io as pcio
from pin_slam_tpu_torch.dataset.io import _quat_to_rot


def _natural_key(path: str):
    """Natural sort: numeric runs compared as integers ('2' < '10')."""
    return [int(tok) if tok.isdigit() else tok
            for tok in re.split(r"(\d+)", os.path.basename(path))]


class ApolloDataset:
    def __init__(self, data_dir, *args, **kwargs):
        root = Path(data_dir)
        self.scan_files = sorted(
            glob.glob(str(root / "pcds" / "*.pcd")), key=_natural_key)
        if not self.scan_files:
            raise FileNotFoundError(f"no scans under {root / 'pcds'}")
        self.sequence_id = os.path.basename(str(data_dir))
        self.gt_poses = self.read_poses(str(root / "poses" / "gt_poses.txt"))

    def __len__(self):
        return len(self.scan_files)

    @staticmethod
    def read_poses(path: str) -> np.ndarray:
        """idx ts x y z qx qy qz qw rows -> [T,4,4], first pose = identity."""
        data = np.loadtxt(path, ndmin=2)
        trans = data[:, 2:5]
        qxyzw = data[:, 5:9]
        n = data.shape[0]
        poses = np.tile(np.eye(4), (n, 1, 1))
        for i in range(n):
            qx, qy, qz, qw = qxyzw[i]
            poses[i, :3, :3] = _quat_to_rot(qw, qx, qy, qz)
        poses[:, :3, 3] = trans
        return np.linalg.inv(poses[0]) @ poses

    @staticmethod
    def get_timestamps(points: np.ndarray) -> np.ndarray:
        """Spinning-lidar point time by yaw."""
        yaw = -np.arctan2(points[:, 1], points[:, 0])
        return 0.5 * (yaw / np.pi + 1.0)

    def __getitem__(self, idx):
        xyz = pcio.read_pcd(self.scan_files[idx]).astype(np.float64)
        return {"points": xyz, "point_ts": self.get_timestamps(xyz)}
