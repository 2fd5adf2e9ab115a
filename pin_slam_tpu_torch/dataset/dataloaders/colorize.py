"""Camera-projection colorization utilities shared by the KITTI-family
loaders (reference: dataset/dataloaders/kitti.py:191-237,
kitti360.py:150-201 — rebuilt with numpy/PIL, no OpenCV).

The port's own copy of `pin_slam_tpu/dataset/dataloaders/colorize.py`.
"""

from __future__ import annotations

import numpy as np


def load_image(path: str) -> np.ndarray:
    """RGB image as [H, W, 3] float in [0, 1]."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float64) / 255.0


def project_points_to_cam(
    points: np.ndarray,       # [N, 3] lidar frame
    img: np.ndarray,          # [H, W, 3] float RGB
    T_c_l: np.ndarray,        # [4, 4] lidar -> camera
    K: np.ndarray,            # [3, 3] camera intrinsics
    min_depth: float = 0.5,
    max_depth: float = 100.0,
):
    """Color points by projecting into one camera.

    Returns (colors [N, 3] in [0,1], has_color [N] bool).
    """
    n = points.shape[0]
    pc = points @ T_c_l[:3, :3].T + T_c_l[:3, 3]
    depth = pc[:, 2]
    safe = np.where(np.abs(depth) < 1e-9, -1e-6, depth)
    uvw = pc @ K.T
    u = np.round(uvw[:, 0] / np.abs(safe)).astype(np.int64)
    v = np.round(uvw[:, 1] / np.abs(safe)).astype(np.int64)
    h, w = img.shape[:2]
    mask = ((u >= 0) & (u < w) & (v >= 0) & (v < h)
            & (depth > min_depth) & (depth < max_depth))
    colors = np.ones((n, 3))
    colors[mask] = img[v[mask], u[mask]]
    return colors, mask


def project_points_with_P(
    points: np.ndarray,       # [N, 3] lidar frame
    img: np.ndarray,
    P: np.ndarray,            # [3, 4] full projection (e.g. P2 @ Tr)
    min_depth: float = 0.5,
    max_depth: float = 100.0,
):
    """Same as project_points_to_cam but with a combined 3x4 projection."""
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


# ---------------------------------------------------------------- OXTS poses

_EARTH_R = 6378137.0


def oxts_to_poses(oxts_rows: np.ndarray) -> np.ndarray:
    """GNSS/IMU packets -> [T, 4, 4] poses (first row defines the Mercator
    scale; standard KITTI oxts conversion, rebuilt from the published
    format spec: lat lon alt roll pitch yaw ...)."""
    lat, lon, alt = oxts_rows[:, 0], oxts_rows[:, 1], oxts_rows[:, 2]
    roll, pitch, yaw = oxts_rows[:, 3], oxts_rows[:, 4], oxts_rows[:, 5]
    scale = np.cos(lat[0] * np.pi / 180.0)
    tx = scale * lon * np.pi * _EARTH_R / 180.0
    ty = scale * _EARTH_R * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    tz = alt

    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    n = oxts_rows.shape[0]
    R = np.zeros((n, 3, 3))
    # R = Rz(yaw) @ Ry(pitch) @ Rx(roll)
    R[:, 0, 0] = cy * cp
    R[:, 0, 1] = cy * sp * sr - sy * cr
    R[:, 0, 2] = cy * sp * cr + sy * sr
    R[:, 1, 0] = sy * cp
    R[:, 1, 1] = sy * sp * sr + cy * cr
    R[:, 1, 2] = sy * sp * cr - cy * sr
    R[:, 2, 0] = -sp
    R[:, 2, 1] = cp * sr
    R[:, 2, 2] = cp * cr

    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, 0, 3] = tx - tx[0]
    T[:, 1, 3] = ty - ty[0]
    T[:, 2, 3] = tz - tz[0]
    return T
