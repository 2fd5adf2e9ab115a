"""SO(3)/SE(3)/quaternion math in torch (f32 on device) and NumPy (f64 on
host). Port of `pin_slam_tpu/ops/transforms.py`.

Pose chains stay in host float64 NumPy; per-frame device math is float32
in a sensor-anchored frame. Quaternions are (w, x, y, z).
"""

from __future__ import annotations

import numpy as np
import torch

# --------------------------------------------------------------------------
# torch (device, f32)
# --------------------------------------------------------------------------


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of batched 3-vectors [..., 3] -> [..., 3, 3]."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, axis-angle [..., 3] -> rotation [..., 3, 3].
    Taylor branch near zero; the untaken `where` branch stays finite so the
    backward pass is never poisoned by 0/0."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-10
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / t2_safe)
    S = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(S.shape)
    return eye + a[..., None, None] * S + b[..., None, None] * (S @ S)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist [..., 6] (rot, trans) -> [..., 4, 4]; the translation is applied
    directly, as the reference tracker's GN update does."""
    R = so3_exp(xi[..., :3])
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = xi[..., 3:]
    T[..., 3, 3] = 1.0
    return T


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle (rad) of [..., 3, 3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    return torch.arccos(cos)


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply one 4x4 transform to [N, 3] points."""
    return points @ T[:3, :3].T + T[:3, 3]


def transform_points_batch(points: torch.Tensor,
                           T: torch.Tensor) -> torch.Tensor:
    """Apply per-point 4x4 transforms [N, 4, 4] to [N, 3] points."""
    return torch.einsum("nij,nj->ni", T[:, :3, :3], points) + T[:, :3, 3]


def transform_points_by_ts(points: torch.Tensor, ts: torch.Tensor,
                           diffs: torch.Tensor) -> torch.Tensor:
    """Transform [N, 3] points by the 4x4 transform of their timestamp,
    diffs [T, 4, 4], timestamps clipped to [0, T-1]. Twelve [N] coefficient
    gathers instead of an [N, 4, 4] gather: over a 12M-row replay pool the
    latter holds 768 MB, these at most a few [N] rows at a time. Each
    output row sums r0*x + r1*y + r2*z + t in the JAX package's order."""
    ts = torch.clamp(ts.long(), 0, diffs.shape[0] - 1)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    out = []
    for i in range(3):
        r0 = diffs[:, i, 0][ts]
        r1 = diffs[:, i, 1][ts]
        r2 = diffs[:, i, 2][ts]
        t = diffs[:, i, 3][ts]
        out.append(r0 * x + r1 * y + r2 * z + t)
    return torch.stack(out, dim=-1)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of batched quaternions [..., 4]."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by quaternions q [..., 4]."""
    w = q[..., 0]
    u, v = torch.broadcast_tensors(q[..., 1:4], v)
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w[..., None] * uv + uuv)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Batched rotation matrix [..., 3, 3] -> quaternion [..., 4], branch-free
    (Shepperd-style selection by `where`)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
         (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
         (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
         (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
         (m12 + m21) / (4 * qz3), qz3], dim=-1)

    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q_neg = torch.where(cond1[..., None], q1,
                        torch.where(cond2[..., None], q2, q3))
    q = torch.where((tr > 0)[..., None], q0, q_neg)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


# --------------------------------------------------------------------------
# NumPy (host, f64) — pose chain bookkeeping
# --------------------------------------------------------------------------


def np_rotation_angle_deg(R: np.ndarray) -> float:
    tr = np.trace(R[:3, :3])
    return float(np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))))


def np_se3_inv(T: np.ndarray) -> np.ndarray:
    Ti = np.eye(4, dtype=np.float64)
    Ti[:3, :3] = T[:3, :3].T
    Ti[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return Ti


def np_rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """`rotmat_to_quat` on the host: [..., 3, 3] -> float32 (w, x, y, z),
    the same formula in float32 (agrees with the device function to float32
    rounding)."""
    R = np.asarray(R, np.float32)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    one, two, four = np.float32(1.0), np.float32(2.0), np.float32(4.0)

    def safe_sqrt(x):
        return np.sqrt(np.maximum(x, np.float32(1e-12)))

    qw0 = safe_sqrt(one + tr) / two
    q0 = np.stack([qw0, (m21 - m12) / (four * qw0),
                   (m02 - m20) / (four * qw0), (m10 - m01) / (four * qw0)], -1)
    qx1 = safe_sqrt(one + m00 - m11 - m22) / two
    q1 = np.stack([(m21 - m12) / (four * qx1), qx1,
                   (m01 + m10) / (four * qx1), (m02 + m20) / (four * qx1)], -1)
    qy2 = safe_sqrt(one - m00 + m11 - m22) / two
    q2 = np.stack([(m02 - m20) / (four * qy2), (m01 + m10) / (four * qy2),
                   qy2, (m12 + m21) / (four * qy2)], -1)
    qz3 = safe_sqrt(one - m00 - m11 + m22) / two
    q3 = np.stack([(m10 - m01) / (four * qz3), (m02 + m20) / (four * qz3),
                   (m12 + m21) / (four * qz3), qz3], -1)
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q_neg = np.where(cond1[..., None], q1, np.where(cond2[..., None], q2, q3))
    q = np.where((tr > 0)[..., None], q0, q_neg)
    n = np.sqrt(np.sum(q * q, axis=-1, keepdims=True))
    return (q / n).astype(np.float32)


def np_slerp_rotmats(R: np.ndarray, ratios: np.ndarray) -> np.ndarray:
    """Interpolate from identity to rotation R by per-point ratios [N] ->
    [N, 3, 3] (axis-angle scaling)."""
    angle = np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))
    if angle < 1e-9:
        return np.broadcast_to(np.eye(3), (ratios.shape[0], 3, 3)).copy()
    axis = np.array([
        R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]
    ]) / (2.0 * np.sin(angle))
    thetas = ratios * angle
    K = np.array([
        [0, -axis[2], axis[1]],
        [axis[2], 0, -axis[0]],
        [-axis[1], axis[0], 0],
    ])
    sin_t = np.sin(thetas)[:, None, None]
    cos_t = np.cos(thetas)[:, None, None]
    eye = np.eye(3)[None]
    return eye + sin_t * K[None] + (1.0 - cos_t) * (K @ K)[None]
