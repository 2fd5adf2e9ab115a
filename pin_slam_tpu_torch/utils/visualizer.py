"""Headless visualizer: per-frame artifact dumps. The port's own copy of
`pin_slam_tpu/utils/visualizer.py`.

The reference ships an Open3D GUI in a spawned process fed by mp.Queues
(reference: gui/slam_gui.py, gui/gui_utils.py:13-163, pin_slam.py:412-492);
the spawned viewer is `gui/`. This file visualizer writes, on the
reference's cadence, under <run_path>/vis:

  * the neural point map as PLY with PCA feature colors
    (reference: model/neural_points.py:175-179 + feature_pca_torch,
    utils/tools.py:799-857),
  * horizontal (and vertical) SDF slice PNGs through `Mesher.sdf_slice`
    (reference: utils/mesher.py:211-279),
  * incremental local meshes through `Mesher.recon_aabb_mesh`
    (reference: pin_slam.py:443-471),
  * the live trajectory plot (where matplotlib is installed).

The map stays on its device; only the slices, meshes and the final point
map come to the host. This module imports neither torch nor matplotlib at
import time.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def feature_pca(features: np.ndarray, down_rate: int = 17,
                principal_components: Optional[np.ndarray] = None):
    """Project features to RGB via PCA (reference: utils/tools.py:799-857).
    Returns (colors [N,3] in [0,1], components [F,3])."""
    f = np.asarray(features, np.float64)
    if principal_components is None:
        sub = f[::down_rate]
        sub = sub - sub.mean(0, keepdims=True)
        _, _, vt = np.linalg.svd(sub, full_matrices=False)
        principal_components = vt[:3].T                    # [F, 3]
    proj = (f - f.mean(0, keepdims=True)) @ principal_components
    lo, hi = np.percentile(proj, 2, axis=0), np.percentile(proj, 98, axis=0)
    colors = np.clip((proj - lo) / np.maximum(hi - lo, 1e-9), 0, 1)
    return colors, principal_components


class FileVisualizer:
    """Writes visualization artifacts under <run_path>/vis on the cadence of
    the reference GUI settings (mesh_freq_frame, sdfslice_freq_frame)."""

    def __init__(self, config, run_path: str):
        self.config = config
        self.dir = os.path.join(run_path, "vis")
        os.makedirs(self.dir, exist_ok=True)
        self._pca = None

    def on_frame(self, system, frame_id: int, mesher=None):
        """Dump cadence artifacts; returns (mesh_verts, mesh_faces) when a
        local mesh was built this frame (fed to the viewer process)."""
        c = self.config
        mesh_out = (None, None)
        args = (system.state, system.params["geo_features"],
                system.params["geo_mlp"])
        if c.sdf_default_on and frame_id % max(c.sdfslice_freq_frame, 1) == 0 \
                and mesher is not None:
            from pin_slam_tpu_torch.utils.plots import plot_sdf_slice
            center = system.cur_pose_ref[:3, 3]
            xs, ys, sdf = mesher.sdf_slice(
                *args, center, extent=20.0,
                height=center[2] + c.sdf_slice_height, res=c.vis_sdf_res_m)
            plot_sdf_slice(
                os.path.join(self.dir, f"sdf_slice_{frame_id:05d}.png"),
                xs, ys, sdf, clim=2.0)
            if c.vis_sdf_slice_v:
                # vertical slice through the sensor (reference:
                # utils/mesher.py:458-504)
                ys_v, zs_v, sdf_v = mesher.sdf_slice(
                    *args, center, extent=20.0, height=center[0],
                    res=c.vis_sdf_res_m, axis="x")
                plot_sdf_slice(
                    os.path.join(self.dir,
                                 f"sdf_slice_v_{frame_id:05d}.png"),
                    ys_v, zs_v, sdf_v, clim=2.0)

        if c.mesh_default_on and frame_id > 0 \
                and frame_id % max(c.mesh_freq_frame, 1) == 0 \
                and mesher is not None:
            from pin_slam_tpu_torch.slam.mesher import write_ply
            center = system.cur_pose_ref[:3, 3]
            lo = center - c.max_range / 2
            hi = center + c.max_range / 2
            v, f = mesher.recon_aabb_mesh(*args, lo, hi)
            if v.shape[0]:
                write_ply(os.path.join(
                    self.dir, f"mesh_{frame_id:05d}.ply"), v, f)
                mesh_out = (v, f)
        return mesh_out

    def write_neural_points(self, system, name: str = "neural_points_pca"):
        """Neural point map colored by geo-feature PCA."""
        from pin_slam_tpu_torch.dataset.io import write_ply_points

        cnt = int(system.state.count)
        if cnt == 0:
            return
        pos = system.state.positions[:cnt].cpu().numpy()
        feats = system.params["geo_features"][:cnt].cpu().numpy()
        colors, self._pca = feature_pca(feats, principal_components=self._pca)
        write_ply_points(
            os.path.join(self.dir, f"{name}.ply"), pos, colors)

    def finalize(self, system, n_frames: int, gt_poses=None):
        """The live trajectory plot (where matplotlib is installed: without
        it the log says so in one line) and the PCA-coloured neural
        points."""
        from pin_slam_tpu_torch.utils.plots import plot_trajectories

        try:
            plot_trajectories(
                os.path.join(self.dir, "traj_live.png"),
                system.pgo_poses[:n_frames] if self.config.pgo_on
                else system.odom_poses[:n_frames],
                gt_poses[:n_frames] if gt_poses is not None else None)
        except ImportError as e:
            print(f"vis: traj_live.png not written ({e})")
        self.write_neural_points(system)
