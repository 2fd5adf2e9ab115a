"""RGB-D back-projection without Open3D: PIL + NumPy pinhole unprojection
(replaces o3d.geometry.PointCloud.create_from_rgbd_image used by the
reference's replica/tum/neuralrgbd loaders).

The port's own copy of `pin_slam_tpu/dataset/dataloaders/rgbd_utils.py`.
"""

from __future__ import annotations

import numpy as np


def backproject_rgbd(
    rgb_path: str,
    depth_path: str,
    fx: float, fy: float, cx: float, cy: float,
    depth_scale: float,
    depth_trunc: float = 8.0,
    down_rate: int = 1,
) -> np.ndarray:
    """Returns [N, 6] xyzrgb (rgb in [0,1]) in the camera frame
    (x right, y down, z forward). Needs PIL, imported here (not at the
    module's top), so the module imports without it."""
    from PIL import Image

    depth = np.asarray(Image.open(depth_path), np.float64) / depth_scale
    rgb = np.asarray(Image.open(rgb_path), np.float64)[..., :3] / 255.0
    h, w = depth.shape
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    valid = (depth > 0) & (depth < depth_trunc)
    if down_rate > 1:
        keep = np.zeros_like(valid)
        keep[::down_rate, ::down_rate] = True
        valid &= keep
    z = depth[valid]
    u = us[valid]
    v = vs[valid]
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    xyz = np.stack([x, y, z], -1)
    cols = rgb[valid]
    return np.hstack([xyz, cols])
