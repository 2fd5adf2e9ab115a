"""KITTI tracking (MOT) loader (reference:
dataset/dataloaders/kitti_mot.py:39-462 — rebuilt: numpy/PIL, own tracking
calib parsing, no cv2/open3d).

Layout (data_dir = kitti_mot root):
  data_tracking_velodyne/<split>/velodyne/<seq>/*.bin
  data_tracking_image_2/<split>/image_02/<seq>/*.png   (optional, colors)
  data_tracking_calib/<split>/calib/<seq>.txt
  data_tracking_oxts/<split>/oxts/<seq>.txt            (ground truth)

The port's own copy of `pin_slam_tpu/dataset/dataloaders/kitti_mot.py`.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np

from pin_slam_tpu_torch.dataset.dataloaders.colorize import (
    load_image,
    oxts_to_poses,
    project_points_to_cam,
)


def _tracking_calib(path: str) -> dict:
    vals = {}
    with open(path) as f:
        for line in f:
            tokens = line.strip().split()
            if not tokens:
                continue
            key = tokens[0].rstrip(":")
            try:
                vals[key] = np.array([float(t) for t in tokens[1:]])
            except ValueError:
                pass
    out = {}
    for pk in ("P2", "P3"):
        if pk in vals:
            out[pk] = vals[pk].reshape(3, 4)
    for name, key in (("T_c_l", "Tr_velo_cam"),
                      ("T_imu_l", "Tr_imu_velo")):
        if key in vals:
            T = np.eye(4)
            T[:3] = vals[key].reshape(3, 4)
            out[name] = T
    # rectification (R_rect in tracking calib)
    if "R_rect" in vals:
        R = np.eye(4)
        R[:3, :3] = vals["R_rect"].reshape(3, 3)
        out["R_rect"] = R
    return out


class KITTIMOTDataset:
    def __init__(self, data_dir, sequence: str = "0", *args,
                 split: str = "training", load_img: bool = False, **kwargs):
        root = Path(data_dir)
        seq = str(sequence).zfill(4)
        scan_dir = root / "data_tracking_velodyne" / split / "velodyne" / seq
        self.scan_files = sorted(glob.glob(str(scan_dir / "*.bin")))
        if not self.scan_files:
            raise FileNotFoundError(f"no scans under {scan_dir}")

        calib_path = root / "data_tracking_calib" / split / "calib" / \
            f"{seq}.txt"
        self.calib = _tracking_calib(str(calib_path)) if calib_path.exists() \
            else {}

        self.img_files = sorted(glob.glob(str(
            root / "data_tracking_image_2" / split / "image_02" / seq
            / "*.png")))
        self.load_img = (load_img and "P2" in self.calib
                         and "T_c_l" in self.calib
                         and len(self.img_files) >= len(self.scan_files))
        if self.load_img:
            P2 = self.calib["P2"]
            self.K = P2[:3, :3]
            # P2 carries the rectified-cam-2 baseline in its 4th column:
            # fold it into the extrinsic chain T = K^-1 P2 [R_rect Tr | ...]
            T = self.calib.get("R_rect", np.eye(4)) @ self.calib["T_c_l"]
            shift = np.linalg.solve(self.K, P2[:, 3])
            T2 = np.eye(4)
            T2[:3, 3] = shift
            self.T_c_l = T2 @ T

        # ground truth from oxts (per-frame rows in one file)
        self.gt_poses = None
        oxts_path = root / "data_tracking_oxts" / split / "oxts" / \
            f"{seq}.txt"
        if oxts_path.exists():
            rows = np.loadtxt(str(oxts_path))
            if rows.ndim == 1:
                rows = rows[None]
            rows = rows[: len(self.scan_files), :6]
            imu_poses = oxts_to_poses(rows)
            if "T_imu_l" in self.calib:
                T_il = self.calib["T_imu_l"]
                self.gt_poses = T_il @ imu_poses @ np.linalg.inv(T_il)
            else:
                self.gt_poses = imu_poses

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        raw = np.fromfile(self.scan_files[idx],
                          dtype=np.float32).reshape(-1, 4)
        xyz = raw[:, :3].astype(np.float64)
        yaw = -np.arctan2(xyz[:, 1], xyz[:, 0])
        ts = 0.5 * (yaw / np.pi + 1.0)
        if not self.load_img:
            return {"points": xyz, "point_ts": ts}
        img = load_image(self.img_files[idx])
        colors, has = project_points_to_cam(xyz, img, self.T_c_l, self.K)
        return {"points": np.hstack([xyz, colors]), "point_ts": ts,
                "has_color": has}
