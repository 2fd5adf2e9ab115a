"""Generic folder-of-point-clouds loader (reference:
dataset/dataloaders/generic.py semantics: sorted supported files, optional
kitti-format poses file). The port's own copy of
`pin_slam_tpu/dataset/dataloaders/generic.py`."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pin_slam_tpu_torch.dataset import io as pcio
from pin_slam_tpu_torch.dataset.dataloaders import supported_file_extensions


class GenericDataset:
    def __init__(self, data_dir, *args, **kwargs):
        self.data_dir = Path(data_dir)
        self.scan_files = sorted(
            str(p) for p in self.data_dir.iterdir()
            if p.suffix in supported_file_extensions())
        if not self.scan_files:
            raise FileNotFoundError(
                f"no supported point clouds under {data_dir}")
        self.gt_poses = None
        for cand in ("poses.txt", "poses_kitti.txt"):
            p = self.data_dir.parent / cand
            if p.exists():
                poses = pcio.read_kitti_format_poses(str(p))
                if poses:
                    self.gt_poses = np.stack(poses)
                break

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        points, ts = pcio.read_point_cloud(self.scan_files[idx])
        return {"points": points, "point_ts": ts}
