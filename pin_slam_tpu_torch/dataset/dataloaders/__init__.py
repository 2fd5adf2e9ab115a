"""Dataset-specific loaders (registry + factory). The port's own copy of
`pin_slam_tpu/dataset/dataloaders/__init__.py`.

Rebuilds the reference's kiss-icp-derived loader collection
(reference: dataset/dataloaders/__init__.py:45-83 + 18 loader modules).
Every loader yields per-frame dicts {"points": [N,3(+c)] float64,
"point_ts": [N] or None} and optionally exposes `gt_poses`.

rosbag (ROS1 bags), mcap and ouster (pcap) run on in-repo pure-Python
readers (dataset/rosbag1.py, dataset/mcap1.py, dataloaders/ouster.py) —
no rosbags/mcap/ouster-sdk dependencies. The RGB-D loaders (replica, tum,
neuralrgbd) and camera colours read images with PIL, imported when a frame
is read.
"""

from __future__ import annotations


def supported_file_extensions():
    return [".bin", ".pcd", ".ply", ".xyz", ".obj", ".ctm", ".off", ".stl",
            ".npy"]


def sequence_dataloaders():
    return ["kitti", "kitti_raw", "nuscenes", "helipr", "replica"]


def available_dataloaders():
    return ["generic", "kitti", "kitti_raw", "kitti360", "kitti_mot",
            "mulran", "ncd", "nclt", "boreas", "apollo", "paris_luco",
            "helipr", "replica", "tum", "neuralrgbd", "rosbag", "mcap",
            "ouster", "nuscenes", "synthetic"]


def dataset_factory(dataloader: str, data_dir, *args, **kwargs):
    """(reference: dataset/dataloaders/__init__.py:76-83)"""
    dl = dataloader.lower()
    if dl == "generic":
        from pin_slam_tpu_torch.dataset.dataloaders.generic import GenericDataset
        return GenericDataset(data_dir, *args, **kwargs)
    if dl == "kitti":
        from pin_slam_tpu_torch.dataset.dataloaders.kitti import KITTIOdometryDataset
        return KITTIOdometryDataset(data_dir, *args, **kwargs)
    if dl == "kitti_raw":
        from pin_slam_tpu_torch.dataset.dataloaders.kitti_raw import KITTIRawDataset
        return KITTIRawDataset(data_dir, *args, **kwargs)
    if dl == "kitti360":
        from pin_slam_tpu_torch.dataset.dataloaders.kitti360 import KITTI360Dataset
        return KITTI360Dataset(data_dir, *args, **kwargs)
    if dl == "kitti_mot":
        from pin_slam_tpu_torch.dataset.dataloaders.kitti_mot import KITTIMOTDataset
        return KITTIMOTDataset(data_dir, *args, **kwargs)
    if dl == "mulran":
        from pin_slam_tpu_torch.dataset.dataloaders.mulran import MulranDataset
        return MulranDataset(data_dir, *args, **kwargs)
    if dl == "ncd":
        from pin_slam_tpu_torch.dataset.dataloaders.ncd import NewerCollegeDataset
        return NewerCollegeDataset(data_dir, *args, **kwargs)
    if dl == "nclt":
        from pin_slam_tpu_torch.dataset.dataloaders.nclt import NCLTDataset
        return NCLTDataset(data_dir, *args, **kwargs)
    if dl == "boreas":
        from pin_slam_tpu_torch.dataset.dataloaders.boreas import BoreasDataset
        return BoreasDataset(data_dir, *args, **kwargs)
    if dl == "apollo":
        from pin_slam_tpu_torch.dataset.dataloaders.apollo import ApolloDataset
        return ApolloDataset(data_dir, *args, **kwargs)
    if dl == "paris_luco":
        from pin_slam_tpu_torch.dataset.dataloaders.paris_luco import ParisLucoDataset
        return ParisLucoDataset(data_dir, *args, **kwargs)
    if dl == "helipr":
        from pin_slam_tpu_torch.dataset.dataloaders.helipr import HeLiPRDataset
        return HeLiPRDataset(data_dir, *args, **kwargs)
    if dl == "replica":
        from pin_slam_tpu_torch.dataset.dataloaders.replica import ReplicaDataset
        return ReplicaDataset(data_dir, *args, **kwargs)
    if dl in ("tum", "neuralrgbd"):
        from pin_slam_tpu_torch.dataset.dataloaders.tum import TUMDataset
        return TUMDataset(data_dir, *args, **kwargs)
    if dl == "rosbag":
        from pin_slam_tpu_torch.dataset.dataloaders.rosbag import RosbagDataset
        return RosbagDataset(data_dir, *args, **kwargs)
    if dl == "mcap":
        from pin_slam_tpu_torch.dataset.dataloaders.mcap import McapDataloader
        return McapDataloader(data_dir, *args, **kwargs)
    if dl == "ouster":
        from pin_slam_tpu_torch.dataset.dataloaders.ouster import OusterDataloader
        return OusterDataloader(data_dir, *args, **kwargs)
    if dl == "nuscenes":
        from pin_slam_tpu_torch.dataset.dataloaders.nuscenes import NuScenesDataset
        return NuScenesDataset(data_dir, *args, **kwargs)
    raise ValueError(
        f"unknown dataloader '{dataloader}'; "
        f"available: {available_dataloaders()}")
