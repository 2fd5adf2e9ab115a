"""Dataset path shortcuts (reference: dataset/dataset_indexing.py:10-83).
The port's own copy of `pin_slam_tpu/dataset/dataset_indexing.py`."""

from __future__ import annotations

import os

from pin_slam_tpu_torch.config import Config


def set_dataset_path(config: Config, dataset_name: str = "", seq: str = ""):
    if seq is None:
        seq = ""
    config.name = config.name + "_" + dataset_name + "_" + seq.replace("/", "")

    if config.use_dataloader:
        config.data_loader_name = dataset_name
        config.data_loader_seq = seq
        return

    if dataset_name == "kitti":
        base = config.pc_path.rsplit("/", 3)[0]
        config.pc_path = os.path.join(base, "sequences", seq, "velodyne")
        config.pose_path = os.path.join(base, "poses", seq + ".txt")
        config.calib_path = os.path.join(base, "sequences", seq, "calib.txt")
        config.label_path = os.path.join(base, "sequences", seq, "labels")
        config.kitti_correction_on = True
        config.correction_deg = 0.195
    elif dataset_name == "mulran":
        base = config.pc_path.rsplit("/", 2)[0]
        config.pc_path = os.path.join(base, seq, "Ouster")
        config.pose_path = os.path.join(base, seq, "poses.txt")
    elif dataset_name == "kitti_carla":
        base = config.pc_path.rsplit("/", 3)[0]
        config.pc_path = os.path.join(base, seq, "generated", "frames")
        config.pose_path = os.path.join(base, seq, "generated", "poses.txt")
        config.calib_path = os.path.join(base, seq, "generated", "calib.txt")
    elif dataset_name == "ncd":
        base = config.pc_path.rsplit("/", 2)[0]
        config.pc_path = os.path.join(base, seq, "bin")
        config.pose_path = os.path.join(base, seq, "poses.txt")
        config.calib_path = os.path.join(base, seq, "calib.txt")
    elif dataset_name == "ncd128":
        base = config.pc_path.rsplit("/", 2)[0]
        config.pc_path = os.path.join(base, seq, "ply")
        config.pose_path = os.path.join(base, seq, "poses.txt")
    elif dataset_name == "ipbcar":
        base = config.pc_path.rsplit("/", 2)[0]
        config.pc_path = os.path.join(base, seq, "ouster")
        config.pose_path = os.path.join(base, seq, "poses.txt")
        config.calib_path = os.path.join(base, seq, "calib.txt")
    elif dataset_name == "hilti":
        base = config.pc_path.rsplit("/", 2)[0]
        config.pc_path = os.path.join(base, seq, "ply")
    elif dataset_name == "m2dgr":
        base = config.pc_path.rsplit("/", 2)[0]
        config.pc_path = os.path.join(base, seq, "points")
        config.pose_path = os.path.join(base, seq, "poses.txt")
    elif dataset_name == "replica":
        base = config.pc_path.rsplit("/", 2)[0]
        config.pc_path = os.path.join(base, seq, "rgbd_down_ply")
        config.pose_path = os.path.join(base, seq, "poses.txt")
    elif dataset_name == "synthetic":
        pass  # handled by the caller (in-repo ray-cast scenes)
    else:
        print("Unknown dataset shortcut; use a data loader (-d) instead.")
