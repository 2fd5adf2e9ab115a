"""Camera-projection colorization of the KITTI loader (reference:
dataset/dataloaders/kitti.py:191-237, rebuilt with numpy/PIL, no OpenCV).
The part of `pin_slam_tpu/dataset/dataloaders/colorize.py` that
`dataloaders/kitti.py` reads; PIL is imported only when an image is
loaded."""

from __future__ import annotations

import numpy as np


def load_image(path: str) -> np.ndarray:
    """RGB image as [H, W, 3] float in [0, 1]."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float64) / 255.0


def project_points_with_P(
    points: np.ndarray,       # [N, 3] lidar frame
    img: np.ndarray,
    P: np.ndarray,            # [3, 4] full projection (e.g. P2 @ Tr)
    min_depth: float = 0.5,
    max_depth: float = 100.0,
):
    """Colour points by projecting them with a combined 3x4 projection.
    Returns (colors [N, 3] in [0,1], has_color [N] bool)."""
    n = points.shape[0]
    homo = np.hstack([points, np.ones((n, 1))])
    uvw = homo @ P.T
    depth = uvw[:, 2]
    safe = np.where(np.abs(depth) < 1e-9, -1e-6, depth)
    u = np.round(uvw[:, 0] / np.abs(safe)).astype(np.int64)
    v = np.round(uvw[:, 1] / np.abs(safe)).astype(np.int64)
    h, w = img.shape[:2]
    mask = ((u >= 0) & (u < w) & (v >= 0) & (v < h)
            & (depth > min_depth) & (depth < max_depth))
    colors = np.ones((n, 3))
    colors[mask] = img[v[mask], u[mask]]
    return colors, mask
