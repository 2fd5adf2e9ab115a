"""Trajectory evaluation: ATE (Horn-aligned) and KITTI-style relative drift.
The port's own copy of `pin_slam_tpu/utils/eval_traj.py` (numpy only).

Rebuilds reference eval/eval_traj_utils.py:14-174 (absolute_error with
Umeyama/Horn alignment; relative translational %/rotational deg-per-100m
over 100..800 m segments). Pure NumPy (host-side tooling).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def align_umeyama(gt_xyz: np.ndarray, est_xyz: np.ndarray,
                  with_scale: bool = False):
    """Horn/Umeyama SE(3) (+scale) alignment est -> gt.
    Returns (R, t, s). (reference: eval/eval_traj_utils.py:74-109)"""
    mu_gt = gt_xyz.mean(0)
    mu_est = est_xyz.mean(0)
    gt_c = gt_xyz - mu_gt
    est_c = est_xyz - mu_est
    W = gt_c.T @ est_c / gt_xyz.shape[0]
    U, d, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_est = (est_c**2).sum() / est_xyz.shape[0]
        s = float(np.trace(np.diag(d) @ S) / var_est)
    else:
        s = 1.0
    t = mu_gt - s * R @ mu_est
    return R, t, s


def rotation_angle_deg(R: np.ndarray) -> float:
    """Geodesic angle [deg] of a (possibly slightly non-orthonormal) 3x3.

    Estimated pose chains compound thousands of float32 tracker outputs;
    by frame ~1000 the rotations carry ~0.3 % scale/shear error, which
    pushes trace(R) above 3 — the plain trace formula then CLIPS to 0 deg
    and silently under-reports rotation error (measured: a 6.5 deg odometry
    chain error scored as 0.00). Project to SO(3) via SVD first."""
    U, _, Vt = np.linalg.svd(R)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    Rp = U @ S @ Vt
    return float(np.degrees(np.arccos(
        np.clip((np.trace(Rp) - 1.0) / 2.0, -1.0, 1.0))))


def absolute_error(
    gt_poses: np.ndarray, est_poses: np.ndarray, align_on: bool = True
) -> Tuple[float, float]:
    """ATE RMSE [m] and ARE RMSE [deg] after optional alignment
    (reference: eval/eval_traj_utils.py:14-63)."""
    assert gt_poses.shape[0] == est_poses.shape[0]
    gt_xyz = gt_poses[:, :3, 3]
    est_xyz = est_poses[:, :3, 3]
    if align_on:
        R, t, s = align_umeyama(gt_xyz, est_xyz)
    else:
        R, t, s = np.eye(3), np.zeros(3), 1.0
    est_aligned = (s * (R @ est_xyz.T)).T + t
    err = est_aligned - gt_xyz
    ate = float(np.sqrt((err**2).sum(-1).mean()))

    are_sq = 0.0
    for i in range(gt_poses.shape[0]):
        R_est = R @ est_poses[i, :3, :3]
        dR = R_est @ gt_poses[i, :3, :3].T
        ang = rotation_angle_deg(dR)
        are_sq += ang**2
    are = float(np.sqrt(are_sq / gt_poses.shape[0]))
    return ate, are


def _trajectory_distances(poses: np.ndarray) -> np.ndarray:
    d = np.zeros(poses.shape[0])
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    d[1:] = np.cumsum(steps)
    return d


def relative_error(
    gt_poses: np.ndarray, est_poses: np.ndarray,
    lengths: List[float] = (100, 200, 300, 400, 500, 600, 700, 800),
    step: int = 10,
) -> Tuple[float, float]:
    """KITTI drift: mean translational error [%] and rotational error
    [deg/100m] over fixed-length segments
    (reference: eval/eval_traj_utils.py:112-174)."""
    dist = _trajectory_distances(gt_poses)
    errs = []
    for first in range(0, gt_poses.shape[0], step):
        for seg_len in lengths:
            target = dist[first] + seg_len
            last = int(np.searchsorted(dist, target))
            if last >= gt_poses.shape[0]:
                continue
            gt_rel = np_inv(gt_poses[first]) @ gt_poses[last]
            est_rel = np_inv(est_poses[first]) @ est_poses[last]
            err = np_inv(est_rel) @ gt_rel
            t_err = np.linalg.norm(err[:3, 3]) / seg_len
            r_err = rotation_angle_deg(err[:3, :3]) / seg_len
            errs.append((t_err, r_err))
    if not errs:
        return 0.0, 0.0
    errs = np.array(errs)
    return float(errs[:, 0].mean() * 100.0), float(errs[:, 1].mean() * 100.0)


def np_inv(T: np.ndarray) -> np.ndarray:
    Ti = np.eye(4)
    Ti[:3, :3] = T[:3, :3].T
    Ti[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return Ti


def get_metrics(gt_poses, est_poses, align_on=True) -> Dict[str, float]:
    """(reference: eval/eval_traj_utils.py:382-392)"""
    ate, are = absolute_error(gt_poses, est_poses, align_on)
    drift_t, drift_r = relative_error(gt_poses, est_poses)
    return {
        "Average Translation Error [%]": drift_t,
        "Average Rotational Error [deg/100m]": drift_r,
        "Absoulte Trajectory Error [m]": ate,  # (sic) reference key spelling
        "Absoulte Rotational Error [deg]": are,
    }


def mean_metrics(metric_dicts: List[Dict[str, float]]) -> Dict[str, float]:
    """(reference: eval/eval_traj_utils.py:394-404)"""
    out: Dict[str, float] = {}
    for k in metric_dicts[0]:
        out[k] = float(np.mean([m[k] for m in metric_dicts]))
    return out
