"""Host-side dataset wrapper: frame IO, calibration, deskewing, results.
The port's own copy of `pin_slam_tpu/dataset/slam_dataset.py` (numpy only).

Rebuilds the reference `SLAMDataset` (reference: dataset/slam_dataset.py:37-988)
minus the device residency — frames stay NumPy on host until the SLAM
system pads them onto the device. Pose bookkeeping lives in the SLAM system
(slam/system.py); this class handles files, calibration, timestamps and
result writing. The trajectory and timing plots of the JAX package wait for
the port of `utils/plots.py` (matplotlib); the files and metrics are the
same.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import List, Optional

import numpy as np

from pin_slam_tpu_torch.config import Config
from pin_slam_tpu_torch.dataset import io as pcio
from pin_slam_tpu_torch.ops.transforms import np_slerp_rotmats
from pin_slam_tpu_torch.utils.eval_traj import absolute_error, relative_error

SUPPORTED_EXT = (".bin", ".ply", ".pcd", ".npy")


class SLAMDataset:
    def __init__(self, config: Config):
        self.config = config
        self.silence = config.silence
        self.plot_status = None        # set by write_results

        # data-loader-backed mode (reference read_frame_with_loader,
        # dataset/slam_dataset.py:215-252)
        self.loader = None
        if config.use_dataloader:
            from pin_slam_tpu_torch.dataset.dataloaders import dataset_factory
            self.loader = dataset_factory(
                config.data_loader_name, config.pc_path,
                config.data_loader_seq)
            self.total_pc_count = len(self.loader)
            self.gt_poses = getattr(self.loader, "gt_poses", None)
            if self.gt_poses is not None:
                self.gt_poses = self.gt_poses[
                    config.begin_frame: config.end_frame: config.step_frame]
            self.gt_pose_provided = self.gt_poses is not None
            self.frame_ids = list(range(
                config.begin_frame,
                min(config.end_frame, self.total_pc_count),
                config.step_frame))
            self.total_pc_count = len(self.frame_ids)
            self.pc_filenames = []
            return

        self.pc_filenames: List[str] = []
        if config.pc_path:
            self.pc_filenames = sorted(
                str(p) for p in Path(config.pc_path).iterdir()
                if p.suffix in SUPPORTED_EXT)
            self.pc_filenames = self.pc_filenames[
                config.begin_frame: config.end_frame: config.step_frame]
        self.total_pc_count = len(self.pc_filenames)

        # semantic label files (reference reads .label alongside .bin,
        # dataset/slam_dataset.py:1063-1092)
        self.label_filenames: List[str] = []
        if config.semantic_on and config.label_path and \
                os.path.isdir(config.label_path):
            self.label_filenames = sorted(
                str(p) for p in Path(config.label_path).iterdir()
                if p.suffix == ".label")
            self.label_filenames = self.label_filenames[
                config.begin_frame: config.end_frame: config.step_frame]
            if len(self.label_filenames) < self.total_pc_count:
                if not self.silence:
                    print(f"warning: {len(self.label_filenames)} label files"
                          f" for {self.total_pc_count} scans; semantics off"
                          " for unmatched frames")

        # ground truth poses (kitti or tum), moved into the LiDAR frame
        self.gt_poses: Optional[np.ndarray] = None
        self.gt_pose_provided = False
        if config.pose_path:
            poses = None
            try:
                poses = pcio.read_kitti_format_poses(config.pose_path)
            except Exception:
                poses = None
            if poses is None:
                poses, _ = pcio.read_tum_format_poses(config.pose_path)
            if poses:
                if config.calib_path:
                    calib = pcio.read_kitti_format_calib(config.calib_path)
                    if "Tr" in calib:
                        poses = pcio.apply_kitti_format_calib(
                            poses, calib["Tr"])
                poses = poses[
                    config.begin_frame: config.end_frame: config.step_frame]
                self.gt_poses = np.stack(poses)
                self.gt_pose_provided = True

    # ------------------------------------------------------------- reading

    def read_frame(self, frame_id: int):
        """Returns (points [N,3(+c)] f64 sensor frame, point_ts or None)."""
        pts, ts, _ = self.read_frame_sem(frame_id)
        return pts, ts

    def read_frame_sem(self, frame_id: int):
        """Like read_frame but also returns per-point semantic learning
        labels (or None). When `filter_moving_object` is on and labels
        exist, moving-class points are dropped here (reference:
        dataset/slam_dataset.py:1063-1092, filter_sem_kitti :1273-1290)."""
        if self.loader is not None:
            d = self.loader[self.frame_ids[frame_id]]
            return (np.asarray(d["points"], np.float64), d.get("point_ts"),
                    d.get("sem_labels"))
        filename = self.pc_filenames[frame_id]
        points, ts = pcio.read_point_cloud(
            filename, self.config.color_channel)
        if ts is None and self.config.deskew:
            ts = pcio.estimate_point_ts(points[:, :3],
                                        self.config.lidar_type_guess)
        if self.config.kitti_correction_on:
            points = intrinsic_correct(points, self.config.correction_deg)

        sem_labels = None
        if frame_id < len(self.label_filenames):
            from pin_slam_tpu_torch.utils.semantic_kitti_utils import (
                filter_moving_mask, sem_map_function)
            raw = np.fromfile(self.label_filenames[frame_id],
                              dtype=np.uint32).reshape(-1) & 0xFFFF
            if raw.shape[0] == points.shape[0]:
                sem_labels = sem_map_function(raw)
                if self.config.filter_moving_object:
                    keep = filter_moving_mask(sem_labels)
                    points = points[keep]
                    sem_labels = sem_labels[keep]
                    if ts is not None:
                        ts = np.asarray(ts)[keep]
            elif not self.silence:
                print(f"warning: label count {raw.shape[0]} != point count "
                      f"{points.shape[0]} for frame {frame_id}")
        return points, ts, sem_labels

    # ------------------------------------------------------------ deskewing

    @staticmethod
    def deskew(points: np.ndarray, ts: np.ndarray,
               last_tran: np.ndarray, ts_mid_pose: float = 0.5) -> np.ndarray:
        """Constant-velocity motion undistortion (reference:
        utils/tools.py:747-779): rotate/translate each point by the slerped
        fraction of T_last<-cur around the mid-scan pose."""
        if ts is None:
            return points
        ts = np.asarray(ts, np.float64)
        rng = ts.max() - ts.min()
        if rng < 1e-12:
            return points
        r = (ts - ts.min()) / rng - ts_mid_pose
        R = np_slerp_rotmats(last_tran[:3, :3], r)
        t = r[:, None] * last_tran[:3, 3]
        out = points.copy()
        out[:, :3] = np.einsum("nij,nj->ni", R, points[:, :3]) + t
        return out

    # -------------------------------------------------------------- results

    def _write_plots(self, run_path, odom_poses, slam_poses, timings,
                     loop_edges) -> str:
        """The plots of `write_results`, as the JAX package writes them;
        returns the names written, or why none were."""
        try:
            from pin_slam_tpu_torch.utils import plots
            written = []
            if timings is not None:
                plots.plot_timing_detail(
                    os.path.join(run_path, "timing_details.png"),
                    np.asarray(timings))
                written.append("timing_details.png")
            final = slam_poses if slam_poses is not None else odom_poses
            gtp = self.gt_poses if self.gt_pose_provided else None
            extra = ({"odometry": odom_poses}
                     if slam_poses is not None else None)
            plots.plot_trajectories(
                os.path.join(run_path, "traj_plot_2d.png"), final, gtp,
                extra=extra)
            plots.plot_trajectories(
                os.path.join(run_path, "traj_plot_3d.png"), final, gtp,
                extra=extra, plot_3d=True)
            written += ["traj_plot_2d.png", "traj_plot_3d.png"]
            if loop_edges is not None and len(loop_edges) > 0:
                plots.plot_loops(os.path.join(run_path, "loop_plot.png"),
                                 final, loop_edges)
                written.append("loop_plot.png")
        except Exception as e:
            return f"not written ({type(e).__name__}: {e})"
        return "written: " + ", ".join(written)

    def write_results(self, run_path: str, odom_poses: np.ndarray,
                      slam_poses: Optional[np.ndarray] = None,
                      timings: Optional[np.ndarray] = None,
                      loop_edges=None) -> dict:
        """Write trajectories (KITTI + TUM), timing table, the plots of
        `utils/plots.py` (trajectories 2D and 3D, timing, the loop edges)
        and the pose evaluation CSV (reference:
        dataset/slam_dataset.py:681-858). Returns the metric dict (empty
        without gt). The plots are host-side output: where they cannot be
        written (no matplotlib) `plot_status` says why, and the run's log
        says it in one line."""
        os.makedirs(run_path, exist_ok=True)
        pcio.write_kitti_format_poses(
            os.path.join(run_path, "odom_poses_kitti.txt"), odom_poses)
        pcio.write_tum_format_poses(
            os.path.join(run_path, "odom_poses_tum.txt"), odom_poses)
        final = slam_poses if slam_poses is not None else odom_poses
        if slam_poses is not None:
            pcio.write_kitti_format_poses(
                os.path.join(run_path, "slam_poses_kitti.txt"), slam_poses)
            pcio.write_tum_format_poses(
                os.path.join(run_path, "slam_poses_tum.txt"), slam_poses)
        if timings is not None:
            np.save(os.path.join(run_path, "time_table.npy"),
                    np.asarray(timings))
        self.plot_status = self._write_plots(run_path, odom_poses,
                                             slam_poses, timings, loop_edges)
        if not self.silence:
            print(f"plots: {self.plot_status}")

        metrics = {}
        if self.gt_pose_provided and self.gt_poses is not None:
            n = min(final.shape[0], self.gt_poses.shape[0])
            ate, are = absolute_error(self.gt_poses[:n], final[:n],
                                      self.config.eval_traj_align)
            drift_t, drift_r = relative_error(self.gt_poses[:n], final[:n])
            # relative_error already returns deg/100m — no extra scaling
            metrics = {
                "Average Translation Error [%]": drift_t,
                "Average Rotational Error [deg/100m]": drift_r,
                "Absoulte Trajectory Error [m]": ate,
                "Absoulte Rotational Error [deg]": are,
            }
            with open(os.path.join(run_path, "pose_eval.csv"), "w",
                      newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(metrics.keys()))
                w.writeheader()
                w.writerow(metrics)
            if not self.silence:
                for k, v in metrics.items():
                    print(f"{k}: {v:.4f}")
        return metrics


def intrinsic_correct(points: np.ndarray, correct_deg: float) -> np.ndarray:
    """KITTI vertical-angle correction (reference:
    dataset/slam_dataset.py:1251-1270)."""
    if correct_deg == 0.0:
        return points
    dist = np.linalg.norm(points[:, :3], axis=1)
    kitti_var_vertical_ang = correct_deg / 180.0 * np.pi
    v_ang = np.arcsin(np.clip(points[:, 2] / np.maximum(dist, 1e-12), -1, 1))
    v_ang_c = v_ang + kitti_var_vertical_ang
    hor_scale = np.cos(v_ang_c) / np.maximum(np.cos(v_ang), 1e-12)
    out = points.copy()
    out[:, 0] *= hor_scale
    out[:, 1] *= hor_scale
    out[:, 2] = dist * np.sin(v_ang_c)
    return out


def crop_frame_np(points: np.ndarray, min_z, max_z, min_range, max_range):
    """(reference: dataset/slam_dataset.py:1229-1249) — host-side variant;
    the device preprocess does the same masking on-device."""
    d = np.linalg.norm(points[:, :3], axis=1)
    keep = ((d > min_range) & (d < max_range)
            & (points[:, 2] > min_z) & (points[:, 2] < max_z))
    return points[keep]
