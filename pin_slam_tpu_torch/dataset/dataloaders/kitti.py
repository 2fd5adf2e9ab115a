"""KITTI odometry loader (reference: dataset/dataloaders/kitti.py:1-292).

Reads velodyne .bin scans, calib.txt (Tr), poses/<seq>.txt; applies the
intrinsic vertical-angle correction (reference :150-170) and moves ground
truth into the LiDAR frame. The port's own copy of
`pin_slam_tpu/dataset/dataloaders/kitti.py`.
"""

from __future__ import annotations

import glob
from pathlib import Path

import numpy as np

from pin_slam_tpu_torch.dataset import io as pcio
from pin_slam_tpu_torch.dataset.slam_dataset import intrinsic_correct


class KITTIOdometryDataset:
    def __init__(self, data_dir, sequence: str = "00", *args,
                 correct: bool = True, load_img: bool = False, **kwargs):
        root = Path(data_dir)
        self.sequence_dir = root / "sequences" / sequence
        scan_dir = self.sequence_dir / "velodyne"
        self.scan_files = sorted(glob.glob(str(scan_dir / "*.bin")))
        if not self.scan_files:
            raise FileNotFoundError(f"no scans under {scan_dir}")
        self.correct = correct
        # image colorization via cam2 (reference: kitti.py:191-237)
        self.img_files = sorted(glob.glob(str(
            self.sequence_dir / "image_2" / "*.png")))
        self.load_img = load_img and \
            len(self.img_files) >= len(self.scan_files)

        self.calib = {}
        calib_file = self.sequence_dir / "calib.txt"
        if calib_file.exists():
            self.calib = pcio.read_kitti_format_calib(str(calib_file))
        self.gt_poses = None
        pose_file = root / "poses" / f"{sequence}.txt"
        if pose_file.exists():
            poses = pcio.read_kitti_format_poses(str(pose_file))
            if poses and "Tr" in self.calib:
                poses = pcio.apply_kitti_format_calib(poses, self.calib["Tr"])
            if poses:
                self.gt_poses = np.stack(poses)

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        points = np.fromfile(self.scan_files[idx],
                             dtype=np.float32).reshape(-1, 4)
        xyz = points[:, :3].astype(np.float64)
        if self.correct:
            xyz = intrinsic_correct(xyz, 0.195)
        # spinning-lidar timestamps by yaw (reference kitti.py get_timestamps)
        ts = pcio.estimate_point_ts(xyz)
        if not self.load_img or "P2" not in self.calib \
                or "Tr" not in self.calib:
            return {"points": xyz, "point_ts": ts}
        from pin_slam_tpu_torch.dataset.dataloaders.colorize import (
            load_image, project_points_with_P)
        img = load_image(self.img_files[idx])
        Tr = self.calib["Tr"].copy()          # already 4x4 (io.py:150-165)
        Tr[3] = [0.0, 0.0, 0.0, 1.0]
        P = self.calib["P2"][:3, :4] @ Tr
        colors, has = project_points_with_P(xyz, img, P)
        return {"points": np.hstack([xyz, colors]), "point_ts": ts,
                "has_color": has}
