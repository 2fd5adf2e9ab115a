"""Boreas loader (reference: dataset/dataloaders/boreas.py:33-90):
.bin scans with 6 float32 fields (x, y, z, i, laser_id, t).

The port's own copy of `pin_slam_tpu/dataset/dataloaders/boreas.py`.
"""

from __future__ import annotations

import glob
from pathlib import Path

import numpy as np


class BoreasDataset:
    def __init__(self, data_dir, *args, **kwargs):
        self.sequence_dir = Path(data_dir)
        for sub in ("lidar", "."):
            self.scan_files = sorted(
                glob.glob(str(self.sequence_dir / sub / "*.bin")))
            if self.scan_files:
                break
        if not self.scan_files:
            raise FileNotFoundError(f"no scans under {self.sequence_dir}")
        self.gt_poses = None

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        data = np.fromfile(self.scan_files[idx],
                           dtype=np.float32).reshape(-1, 6)
        points = data[:, :3].astype(np.float64)
        t = data[:, 5]
        rng = t.max() - t.min()
        ts = (t - t.min()) / rng if rng > 0 else None
        return {"points": points, "point_ts": ts}
