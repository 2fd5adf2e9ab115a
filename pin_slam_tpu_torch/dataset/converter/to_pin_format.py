#!/usr/bin/env python3
"""Convert any supported dataset to the "pin format": a folder of PLY point
clouds + a KITTI-format poses.txt.

Replaces the reference's per-dataset converter scripts
(reference: dataset/converter/replica_to_pin_format.py:17 and siblings) with
one loader-backed tool:

    python -m pin_slam_tpu_torch.dataset.converter.to_pin_format \
        --loader replica --input <root> --sequence room0 --output <out-dir>

The port's own copy of `pin_slam_tpu/dataset/converter/to_pin_format.py`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pin_slam_tpu_torch.dataset.dataloaders import dataset_factory
from pin_slam_tpu_torch.dataset.io import write_kitti_format_poses, write_ply_points


def convert(loader_name: str, input_path: str, sequence: str,
            output: str, down_rate: int = 1, max_frames: int = int(1e9)):
    loader = dataset_factory(loader_name, input_path, sequence)
    ply_dir = os.path.join(output, "rgbd_down_ply"
                           if loader_name in ("replica", "tum", "neuralrgbd")
                           else "ply")
    os.makedirs(ply_dir, exist_ok=True)
    n = min(len(loader), max_frames)
    for i in range(n):
        d = loader[i]
        pts = np.asarray(d["points"])
        if down_rate > 1:
            pts = pts[::down_rate]
        colors = pts[:, 3:6] if pts.shape[1] >= 6 else None
        write_ply_points(os.path.join(ply_dir, f"{i:06d}.ply"),
                         pts[:, :3].astype(np.float32), colors)
        if i % 50 == 0:
            print(f"{i}/{n}")
    gt = getattr(loader, "gt_poses", None)
    if gt is not None:
        write_kitti_format_poses(os.path.join(output, "poses.txt"), gt[:n])
    print(f"wrote {n} frames to {ply_dir}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--loader", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--sequence", default=None)
    p.add_argument("--output", required=True)
    p.add_argument("--down-rate", type=int, default=1)
    p.add_argument("--max-frames", type=int, default=int(1e9))
    a = p.parse_args()
    convert(a.loader, a.input, a.sequence, a.output, a.down_rate,
            a.max_frames)


if __name__ == "__main__":
    main()
