"""nuScenes LiDAR loader WITHOUT the nuscenes-devkit (reference:
dataset/dataloaders/nuscenes.py:1-154 uses the devkit; the devkit is just a
JSON-table reader, so this loader parses the v1.0 tables directly).

Layout (data_dir = nuScenes root):
  v1.0-{mini,trainval,test}/{scene,sample,sample_data,ego_pose,
                             calibrated_sensor}.json
  samples|sweeps/LIDAR_TOP/*.pcd.bin   (x, y, z, intensity, ring) float32

The port's own copy of `pin_slam_tpu/dataset/dataloaders/nuscenes.py`.
"""

from __future__ import annotations

import glob
import json
import os
from pathlib import Path

import numpy as np


def _quat_to_rot(q) -> np.ndarray:
    """nuScenes [w, x, y, z] quaternion -> 3x3 rotation."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _pose(rec) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = _quat_to_rot(rec["rotation"])
    T[:3, 3] = rec["translation"]
    return T


class NuScenesDataset:
    def __init__(self, data_dir, sequence: str = "0", *args,
                 version: str = None, **kwargs):
        root = Path(data_dir)
        if version is None:
            cands = sorted(p.name for p in root.iterdir()
                           if p.name.startswith("v1.0"))
            if not cands:
                raise FileNotFoundError(
                    f"no v1.0-* metadata directory under {root}")
            version = cands[0]
        meta = root / version

        def load(name):
            with open(meta / f"{name}.json") as f:
                return json.load(f)

        scenes = load("scene")
        # sequence may be a scene index or a scene name like 'scene-0061'
        try:
            scene = scenes[int(sequence)]
        except (ValueError, IndexError):
            match = [s for s in scenes if s["name"] == str(sequence)]
            if not match:
                raise ValueError(f"scene '{sequence}' not found")
            scene = match[0]

        samples = {s["token"]: s for s in load("sample")}
        ego_poses = {p["token"]: p for p in load("ego_pose")}
        calibs = {c["token"]: c for c in load("calibrated_sensor")}
        sdata = load("sample_data")

        # walk the keyframe chain of the scene, pick LIDAR_TOP records
        lidar_by_sample = {}
        for d in sdata:
            if d["is_key_frame"] and "LIDAR_TOP" in d["filename"]:
                lidar_by_sample[d["sample_token"]] = d

        self.scan_files = []
        self.gt_poses = []
        tok = scene["first_sample_token"]
        while tok:
            sample = samples[tok]
            d = lidar_by_sample.get(tok)
            if d is not None:
                self.scan_files.append(str(root / d["filename"]))
                T_ego = _pose(ego_poses[d["ego_pose_token"]])
                T_lid = _pose(calibs[d["calibrated_sensor_token"]])
                self.gt_poses.append(T_ego @ T_lid)
            tok = sample["next"]
        if not self.scan_files:
            raise FileNotFoundError(f"no LIDAR_TOP keyframes in scene")
        gt = np.stack(self.gt_poses)
        # express relative to the first lidar pose (lidar frame convention)
        self.gt_poses = np.linalg.inv(gt[0]) @ gt

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        raw = np.fromfile(self.scan_files[idx],
                          dtype=np.float32).reshape(-1, 5)
        xyz = raw[:, :3].astype(np.float64)
        yaw = -np.arctan2(xyz[:, 1], xyz[:, 0])
        ts = 0.5 * (yaw / np.pi + 1.0)
        return {"points": xyz, "point_ts": ts}
