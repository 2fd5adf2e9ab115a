"""HeLiPR loader (reference: dataset/dataloaders/helipr.py:49-160):
sensor-specific packed binary records; here the common Ouster/Velodyne
variants (xyz f32 + intensity + extras).

The port's own copy of `pin_slam_tpu/dataset/dataloaders/helipr.py`.
"""

from __future__ import annotations

import glob
import os
import struct
from pathlib import Path

import numpy as np

_FORMATS = {
    # sensor -> (struct format per point, intensity index)
    "Ouster": ("ffffIHHH", 3),
    "Velodyne": ("ffffHf", 3),
    "Aeva": ("fffffflB", None),
    "Avia": ("ffffBBB", 3),
}


class HeLiPRDataset:
    def __init__(self, data_dir, sequence: str = "Ouster", *args, **kwargs):
        root = Path(data_dir)
        self.sensor = sequence if sequence in _FORMATS else "Ouster"
        scan_dir = root / "LiDAR" / self.sensor
        if not scan_dir.exists():
            scan_dir = root
        self.scan_files = sorted(glob.glob(str(scan_dir / "*.bin")))
        if not self.scan_files:
            raise FileNotFoundError(f"no scans under {scan_dir}")
        self.gt_poses = None

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        fmt, _ = _FORMATS[self.sensor]
        size = struct.calcsize(fmt)
        raw = open(self.scan_files[idx], "rb").read()
        n = len(raw) // size
        pts = np.zeros((n, 3))
        for i, rec in enumerate(struct.iter_unpack(fmt, raw[: n * size])):
            pts[i] = rec[:3]
        return {"points": pts, "point_ts": None}
