"""KITTI raw-dataset loader (reference: dataset/dataloaders/kitti_raw.py:45-387
— rebuilt: own oxts->SE(3) Mercator conversion via colorize.oxts_to_poses,
own calib parsing, no pykitti).

Layout (odometry sequence id -> raw drive):
  <root>/<date>/<date>_drive_XXXX_sync/velodyne_points/data/*.bin
  <root>/<date>/<date>_drive_XXXX_sync/oxts/data/*.txt
  <root>/<date>/{calib_imu_to_velo.txt, calib_velo_to_cam.txt,
                 calib_cam_to_cam.txt}

Ground-truth poses come from the GNSS/IMU (oxts) track, converted with a
Mercator projection anchored at the first packet and expressed in the
velodyne frame: T_velo_imu @ T_w_imu @ inv(T_velo_imu).

The port's own copy of `pin_slam_tpu/dataset/dataloaders/kitti_raw.py`.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np

from pin_slam_tpu_torch.dataset.dataloaders.colorize import oxts_to_poses

# odometry-benchmark sequence -> raw drive folder + frame window
# (reference kitti_raw.py:30-43,106-124; sequence 03's drive is unreleased)
RAW_DRIVE_OF_SEQ = {
    "00": ("2011_10_03", "2011_10_03_drive_0027_sync", 0, 4540),
    "01": ("2011_10_03", "2011_10_03_drive_0042_sync", 0, 1100),
    "02": ("2011_10_03", "2011_10_03_drive_0034_sync", 0, 4660),
    "04": ("2011_09_30", "2011_09_30_drive_0016_sync", 0, 270),
    "05": ("2011_09_30", "2011_09_30_drive_0018_sync", 0, 2760),
    "06": ("2011_09_30", "2011_09_30_drive_0020_sync", 0, 1100),
    "07": ("2011_09_30", "2011_09_30_drive_0027_sync", 0, 1100),
    "08": ("2011_09_30", "2011_09_30_drive_0028_sync", 1100, 5170),
    "09": ("2011_09_30", "2011_09_30_drive_0033_sync", 0, 1590),
    "10": ("2011_09_30", "2011_09_30_drive_0034_sync", 0, 1200),
}


def _read_kv_calib(path: str) -> dict:
    """'key: v v v' lines -> {key: np.ndarray}; non-numeric lines skipped."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            try:
                out[key.strip()] = np.array([float(v) for v in vals.split()])
            except ValueError:
                pass
    return out


def _rigid_from_kv(path: str) -> np.ndarray:
    """calib file with R (9) and T (3) entries -> 4x4."""
    kv = _read_kv_calib(path)
    T = np.eye(4)
    T[:3, :3] = kv["R"].reshape(3, 3)
    T[:3, 3] = kv["T"].reshape(3)
    return T


class KITTIRawDataset:
    """Raw KITTI drives addressed by odometry-benchmark sequence id."""

    def __init__(self, data_dir, sequence: str = "00", *args, **kwargs):
        seq = str(sequence).zfill(2)
        if seq not in RAW_DRIVE_OF_SEQ:
            raise ValueError(
                f"kitti_raw sequence '{seq}' has no raw drive; "
                f"available: {sorted(RAW_DRIVE_OF_SEQ)}")
        date, drive, lo, hi = RAW_DRIVE_OF_SEQ[seq]
        self.sequence_id = seq
        root = Path(data_dir)
        self.drive_dir = root / date / drive

        scan_dir = self.drive_dir / "velodyne_points" / "data"
        scans = sorted(glob.glob(str(scan_dir / "*.bin")))
        if not scans:
            raise FileNotFoundError(f"no scans under {scan_dir}")
        self.scan_files = scans[lo:hi + 1]

        # calibration lives next to the drive folders, per date
        calib_dir = root / date
        self.T_velo_imu = _rigid_from_kv(
            str(calib_dir / "calib_imu_to_velo.txt"))
        # camera chain is optional here (poses only need imu->velo); parse it
        # when present so colorization-style consumers can use K_cam2
        self.calib = {}
        velo_cam = calib_dir / "calib_velo_to_cam.txt"
        cam_cam = calib_dir / "calib_cam_to_cam.txt"
        if velo_cam.exists() and cam_cam.exists():
            self.calib["T_cam0_velo_unrect"] = _rigid_from_kv(str(velo_cam))
            self.calib.update(_read_kv_calib(str(cam_cam)))

        # GNSS/IMU packets -> world-frame IMU poses -> velodyne frame
        oxts_dir = self.drive_dir / "oxts" / "data"
        oxts_files = sorted(glob.glob(str(oxts_dir / "*.txt")))[lo:hi + 1]
        self.gt_poses = None
        self.oxts = None
        if oxts_files:
            rows = np.stack([np.loadtxt(f, ndmin=2)[0] for f in oxts_files])
            self.oxts = rows
            imu_poses = oxts_to_poses(rows[:, :6])
            # start from identity (reference kitti_raw.py:384-386)
            imu_poses = np.linalg.inv(imu_poses[0]) @ imu_poses
            T_iv = np.linalg.inv(self.T_velo_imu)
            self.gt_poses = self.T_velo_imu @ imu_poses @ T_iv

    def __len__(self):
        return len(self.scan_files)

    def get_velocities(self, idx):
        """(linear [vf,vl,vu], angular [wf,wl,wu]) from the oxts packet
        (reference kitti_raw.py:79-88)."""
        if self.oxts is None:
            return None, None
        row = self.oxts[idx]
        return row[8:11].copy(), row[20:23].copy()

    @staticmethod
    def get_timestamps(points: np.ndarray) -> np.ndarray:
        yaw = -np.arctan2(points[:, 1], points[:, 0])
        return 0.5 * (yaw / np.pi + 1.0)

    def __getitem__(self, idx):
        pts = np.fromfile(self.scan_files[idx],
                          dtype=np.float32).reshape(-1, 4)
        xyz = pts[:, :3].astype(np.float64)
        return {"points": xyz, "point_ts": self.get_timestamps(xyz)}
