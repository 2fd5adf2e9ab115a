"""ParisLuco loader (reference: dataset/dataloaders/paris_luco.py:31-71
— rebuilt on the in-repo PLY parser, no plyfile).

Layout:
  <root>/frames/*.ply              per-point fields x y z timestamp
  <root>/gt_traj_lidar.txt         rows: x y z   (translation-only GT)

The ground truth carries no orientation; poses are identity-rotation
transforms, matching the reference's apply_calibration behavior.

The port's own copy of `pin_slam_tpu/dataset/dataloaders/paris_luco.py`.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np

from pin_slam_tpu_torch.dataset import io as pcio


class ParisLucoDataset:
    def __init__(self, data_dir, *args, **kwargs):
        root = Path(data_dir)
        self.sequence_id = os.path.basename(str(data_dir))
        self.scan_files = sorted(glob.glob(str(root / "frames" / "*.ply")))
        if not self.scan_files:
            raise FileNotFoundError(f"no scans under {root / 'frames'}")
        self.gt_poses = self.load_gt_poses(str(root / "gt_traj_lidar.txt"))

    def __len__(self):
        return len(self.scan_files)

    @staticmethod
    def load_gt_poses(path: str) -> np.ndarray:
        xyz = np.loadtxt(path, ndmin=2)
        n = xyz.shape[0]
        poses = np.tile(np.eye(4), (n, 1, 1))
        poses[:, :3, 3] = xyz[:, :3]
        return poses

    def __getitem__(self, idx):
        d = pcio.read_ply(self.scan_files[idx])
        pts = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float64)
        ts = np.asarray(d["timestamp"], np.float64)
        mx = ts.max()
        if mx > 0:
            ts = ts / mx
        return {"points": pts, "point_ts": ts}
