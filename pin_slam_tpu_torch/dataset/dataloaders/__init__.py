"""Dataset-specific loaders (registry + factory). The port's own copy of
`pin_slam_tpu/dataset/dataloaders/__init__.py`.

Every loader yields per-frame dicts {"points": [N,3(+c)] float64,
"point_ts": [N] or None} and optionally exposes `gt_poses`. The port has the
generic folder loader and the KITTI odometry loader; the JAX package's other
loaders (and its in-repo rosbag / mcap / pcap readers) are listed as still to
port in ROADMAP.md (queue 1, "the remaining data loaders"), and the factory
raises NotImplementedError for them.
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
        from pin_slam_tpu_torch.dataset.dataloaders.generic import (
            GenericDataset)
        return GenericDataset(data_dir, *args, **kwargs)
    if dl == "kitti":
        from pin_slam_tpu_torch.dataset.dataloaders.kitti import (
            KITTIOdometryDataset)
        return KITTIOdometryDataset(data_dir, *args, **kwargs)
    if dl in available_dataloaders() and dl != "synthetic":
        raise NotImplementedError(
            f"dataloader '{dataloader}' is not ported yet (ROADMAP.md, queue "
            "1: the remaining data loaders); the port has 'generic' and "
            "'kitti'")
    raise ValueError(
        f"unknown dataloader '{dataloader}'; "
        f"available: {available_dataloaders()}")
