"""Newer College loader (reference: dataset/dataloaders/ncd.py:1-110):
Ouster .bin xyzi scans, 64x1024 timestamps, gt csv in the camera frame
transformed by the fixed T_CL extrinsic.

The port's own copy of `pin_slam_tpu/dataset/dataloaders/ncd.py`.
"""

from __future__ import annotations

import glob
from pathlib import Path

import numpy as np


class NewerCollegeDataset:
    T_CL = np.eye(4)
    T_CL[:3, 3] = [-0.084, -0.025, 0.050]

    def __init__(self, data_dir, *args, **kwargs):
        self.sequence_dir = Path(data_dir)
        self.scan_files = sorted(
            glob.glob(str(self.sequence_dir / "bin" / "*.bin")))
        if not self.scan_files:
            self.scan_files = sorted(
                glob.glob(str(self.sequence_dir / "*.bin")))
        if not self.scan_files:
            raise FileNotFoundError(f"no scans under {self.sequence_dir}")
        self.gt_poses = None
        for cand in self.sequence_dir.glob("*.csv"):
            try:
                self.gt_poses = self._load_gt_poses(str(cand))
                break
            except Exception:
                continue

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        points = np.fromfile(self.scan_files[idx],
                             dtype=np.float32).reshape(-1, 4)[:, :3]
        H, W = 64, 1024
        ts = ((np.floor(np.arange(H * W) / H) / W)
              if points.shape[0] == H * W else None)
        return {"points": points.astype(np.float64), "point_ts": ts}

    def _load_gt_poses(self, file_path: str) -> np.ndarray:
        gt = np.genfromtxt(file_path, delimiter=",", dtype=np.float64)[1:]
        # columns: sec, nsec, x, y, z, qx, qy, qz, qw
        t = gt[:, 2:5]
        qx, qy, qz, qw = gt[:, 5], gt[:, 6], gt[:, 7], gt[:, 8]
        n = gt.shape[0]
        poses = np.tile(np.eye(4), (n, 1, 1))
        poses[:, 0, 0] = 1 - 2 * (qy**2 + qz**2)
        poses[:, 0, 1] = 2 * (qx * qy - qw * qz)
        poses[:, 0, 2] = 2 * (qx * qz + qw * qy)
        poses[:, 1, 0] = 2 * (qx * qy + qw * qz)
        poses[:, 1, 1] = 1 - 2 * (qx**2 + qz**2)
        poses[:, 1, 2] = 2 * (qy * qz - qw * qx)
        poses[:, 2, 0] = 2 * (qx * qz - qw * qy)
        poses[:, 2, 1] = 2 * (qy * qz + qw * qx)
        poses[:, 2, 2] = 1 - 2 * (qx**2 + qy**2)
        poses[:, :3, 3] = t
        poses = np.einsum(
            "nij,jk->nik", np.linalg.inv(poses[0]) @ poses, self.T_CL)
        poses = np.einsum("ij,njk->nik", np.linalg.inv(self.T_CL),
                          poses)
        return poses
