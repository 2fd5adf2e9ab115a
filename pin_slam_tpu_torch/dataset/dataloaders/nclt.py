"""NCLT loader (reference: dataset/dataloaders/nclt.py:34-150):
int16-packed velodyne scans with 0.005 scaling and -100 offset.

The port's own copy of `pin_slam_tpu/dataset/dataloaders/nclt.py`.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np


class NCLTDataset:
    def __init__(self, data_dir, *args, **kwargs):
        self.sequence_dir = Path(data_dir)
        for sub in ("velodyne_sync", "points", "."):
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
        binary = np.fromfile(self.scan_files[idx], dtype=np.int16)
        # packed as x,y,z,i per point in int16 (reference :66-90)
        pts = binary.reshape(-1, 4)[:, :3].astype(np.float32)
        scaling, offset = 0.005, -100.0
        xyz = pts * scaling + offset
        return {"points": xyz.astype(np.float64), "point_ts": None}
