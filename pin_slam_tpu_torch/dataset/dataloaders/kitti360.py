"""KITTI-360 loader (reference: dataset/dataloaders/kitti360.py:36-497 —
rebuilt: numpy/PIL, own calib/oxts parsing, no cv2/devkit).

Layout:
  <root>/data_3d_raw/2013_05_28_drive_XXXX_sync/velodyne_points/data/*.bin
  <root>/data_2d_raw/.../image_00/data_rect/*.png        (optional, colors)
  <root>/data_poses/.../oxts/data/*.txt  or  poses.txt   (ground truth)
  <root>/calibration/{calib_cam_to_velo.txt, perspective.txt,
                      calib_imu_to_velo.txt(optional)}

The port's own copy of `pin_slam_tpu/dataset/dataloaders/kitti360.py`.
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


def _rigid(path: str) -> np.ndarray:
    T = np.eye(4)
    T[:3] = np.loadtxt(path).reshape(3, 4)
    return T


def _read_perspective(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            try:
                out[key.strip()] = np.array(
                    [float(v) for v in vals.split()])
            except ValueError:
                pass
    return out


class KITTI360Dataset:
    def __init__(self, data_dir, sequence: str = "0", *args,
                 load_img: bool = False, **kwargs):
        root = Path(data_dir)
        seq = f"2013_05_28_drive_{str(sequence).zfill(4)}_sync"
        lidar_dir = root / "data_3d_raw" / seq / "velodyne_points" / "data"
        self.scan_files = sorted(glob.glob(str(lidar_dir / "*.bin")))
        if not self.scan_files:
            raise FileNotFoundError(f"no scans under {lidar_dir}")
        self.load_img = load_img

        calib = root / "calibration"
        # cam0 -> velodyne rigid transform
        T_l_c0 = _rigid(str(calib / "calib_cam_to_velo.txt"))
        self.T_c0_l = np.linalg.inv(T_l_c0)
        persp = _read_perspective(str(calib / "perspective.txt"))
        self.K = np.eye(3)
        if "P_rect_00" in persp:
            self.K = persp["P_rect_00"].reshape(3, 4)[:3, :3]
        self.T_cr_l = np.eye(4)
        if "R_rect_00" in persp:
            R_rect = np.eye(4)
            R_rect[:3, :3] = persp["R_rect_00"].reshape(3, 3)
            self.T_cr_l = R_rect @ self.T_c0_l
        else:
            self.T_cr_l = self.T_c0_l

        self.img_files = sorted(glob.glob(str(
            root / "data_2d_raw" / seq / "image_00" / "data_rect" / "*.png")))
        if load_img and len(self.img_files) < len(self.scan_files):
            self.load_img = False

        # ground truth: oxts per scan preferred, keyframe poses.txt fallback
        pose_dir = root / "data_poses" / seq
        self.gt_poses = None
        oxts_files = sorted(glob.glob(str(pose_dir / "oxts" / "data"
                                          / "*.txt")))
        T_l_imu = None
        imu_velo = calib / "calib_imu_to_velo.txt"
        if imu_velo.exists():
            T_l_imu = _rigid(str(imu_velo))
        if oxts_files and len(oxts_files) >= len(self.scan_files):
            rows = np.stack([np.loadtxt(f)[:6] for f in
                             oxts_files[: len(self.scan_files)]])
            imu_poses = oxts_to_poses(rows)
            if T_l_imu is not None:
                self.gt_poses = (T_l_imu @ imu_poses
                                 @ np.linalg.inv(T_l_imu))
            else:
                self.gt_poses = imu_poses
        elif (pose_dir / "poses.txt").exists():
            # keyframe IMU poses "frame_idx r11 ... t3"; interpolate missing
            # frames by holding the nearest earlier pose
            data = np.loadtxt(str(pose_dir / "poses.txt"))
            idxs = data[:, 0].astype(int)
            mats = np.tile(np.eye(4), (len(self.scan_files), 1, 1))
            cur = np.eye(4)
            by_idx = {int(i): r[1:].reshape(3, 4) for i, r in
                      zip(idxs, data)}
            for i in range(len(self.scan_files)):
                if i in by_idx:
                    cur = np.eye(4)
                    cur[:3] = by_idx[i]
                mats[i] = cur
            if T_l_imu is not None:
                mats = T_l_imu @ mats @ np.linalg.inv(T_l_imu)
            self.gt_poses = mats

    def __len__(self):
        return len(self.scan_files)

    @staticmethod
    def get_timestamps(points: np.ndarray) -> np.ndarray:
        """Spinning-lidar point time by yaw (reference kitti360.py:215-221)."""
        yaw = -np.arctan2(points[:, 1], points[:, 0])
        return 0.5 * (yaw / np.pi + 1.0)

    def __getitem__(self, idx):
        raw = np.fromfile(self.scan_files[idx],
                          dtype=np.float32).reshape(-1, 4)
        xyz = raw[:, :3].astype(np.float64)
        ts = self.get_timestamps(xyz)
        if not self.load_img:
            return {"points": xyz, "point_ts": ts}
        img = load_image(self.img_files[idx])
        colors, has = project_points_to_cam(xyz, img, self.T_cr_l, self.K,
                                            min_depth=1.0)
        pts = np.hstack([xyz, colors])
        return {"points": pts, "point_ts": ts, "has_color": has}
