"""Inter-process visualization plumbing. The port's own copy of
`pin_slam_tpu/gui/gui_utils.py`.

The reference runs an Open3D window in a spawned process fed by two
mp.Queues with latest-wins draining (reference: gui/gui_utils.py:13-163,
pin_slam.py:200-217,412-492). This module reproduces that concurrency
architecture — packet types, queues, drain, pause protocol — with plain
numpy payloads: every `add_*` converts what it is given (torch tensors on
any device included) to numpy on the host, so a packet never holds a
torch tensor. Unpickling one in the spawned viewer process would import
torch there, and a CUDA tensor would initialise CUDA in it. This module
imports neither torch nor anything that does.

VisPacket field surface matches the reference's VisPacket
(gui/gui_utils.py:14-133); ControlPacket matches gui/gui_utils.py:150-163.
"""

from __future__ import annotations

import queue
import time
from typing import Optional

import numpy as np


class VisPacket:
    """One frame's worth of visualization state (main -> viewer)."""

    def __init__(
        self,
        frame_id: Optional[int] = None,
        finish: bool = False,
        current_pointcloud_xyz: Optional[np.ndarray] = None,
        current_pointcloud_rgb: Optional[np.ndarray] = None,
        mesh_verts: Optional[np.ndarray] = None,
        mesh_faces: Optional[np.ndarray] = None,
        mesh_verts_rgb: Optional[np.ndarray] = None,
        odom_poses: Optional[np.ndarray] = None,
        gt_poses: Optional[np.ndarray] = None,
        slam_poses: Optional[np.ndarray] = None,
        travel_dist: Optional[float] = None,
        mem_usage_gb: Optional[float] = None,
        cur_fps: Optional[float] = None,
        slam_finished: bool = False,
    ):
        self.frame_id = frame_id
        self.finish = finish
        self.slam_finished = slam_finished
        self.travel_dist = _scalar(travel_dist)
        self.mem_usage_gb = _scalar(mem_usage_gb)
        self.cur_fps = _scalar(cur_fps)

        self.has_neural_points = False
        self.neural_points_data = None

        self.sdf_slice_xyz = None
        self.sdf_slice_rgb = None
        self.sdf_pool_xyz = None
        self.sdf_pool_rgb = None

        self.add_scan(current_pointcloud_xyz, current_pointcloud_rgb)
        self.add_mesh(mesh_verts, mesh_faces, mesh_verts_rgb)
        self.add_traj(odom_poses, gt_poses, slam_poses)

    def add_scan(self, xyz=None, rgb=None):
        self.current_pointcloud_xyz = _np32(xyz)
        self.current_pointcloud_rgb = _np32(rgb)

    def add_mesh(self, verts=None, faces=None, verts_rgb=None):
        self.mesh_verts = _np32(verts)
        self.mesh_faces = None if faces is None else np.asarray(
            _host(faces), np.int32)
        self.mesh_verts_rgb = _np32(verts_rgb)

    def add_traj(self, odom_poses=None, gt_poses=None, slam_poses=None,
                 loop_edges=None):
        self.odom_poses = _np32(odom_poses)
        self.gt_poses = _np32(gt_poses)
        self.slam_poses = (_np32(slam_poses) if slam_poses is not None
                           else self.odom_poses)
        self.loop_edges = (None if loop_edges is None else
                           [tuple(int(v) for v in _host(e))
                            for e in loop_edges])

    def add_sdf_slice(self, xyz=None, rgb=None):
        self.sdf_slice_xyz = _np32(xyz)
        self.sdf_slice_rgb = _np32(rgb)

    def add_sdf_training_pool(self, xyz=None, rgb=None):
        self.sdf_pool_xyz = _np32(xyz)
        self.sdf_pool_rgb = _np32(rgb)

    def add_neural_points_data(self, positions: np.ndarray,
                               geo_features: Optional[np.ndarray] = None,
                               stability: Optional[np.ndarray] = None,
                               ts: Optional[np.ndarray] = None,
                               count: Optional[int] = None,
                               local_count: Optional[int] = None,
                               map_memory_mb: Optional[float] = None,
                               resolution: Optional[float] = None,
                               pca_color_on: bool = True):
        """Neural-point payload (reference: gui/gui_utils.py:57-112). The
        caller passes already-pulled numpy arrays; PCA coloring happens
        here so the device side stays free of it."""
        self.has_neural_points = True
        d = {"position": _np32(positions), "count": _scalar(count, int),
             "local_count": _scalar(local_count, int),
             "map_memory_mb": _scalar(map_memory_mb),
             "resolution": _scalar(resolution),
             "stability": _np32(stability),
             "ts": None if ts is None else np.asarray(_host(ts))}
        if geo_features is not None and pca_color_on:
            from pin_slam_tpu_torch.utils.visualizer import feature_pca
            colors, _ = feature_pca(np.asarray(_host(geo_features)))
            d["color_pca_geo"] = colors.astype(np.float32)
        self.neural_points_data = d


class ControlPacket:
    """Viewer -> main control state (reference: gui/gui_utils.py:150-163)."""

    flag_pause = False
    flag_vis = True
    flag_mesh = False
    flag_sdf = False
    flag_global = False
    flag_source = False
    mc_res_m = 0.2
    mesh_min_nn = 10
    mesh_freq_frame = 50
    sdf_freq_frame = 50
    sdf_slice_height = 0.2
    sdf_res_m = 0.2
    cur_frame_id = 0


def get_latest_queue(q):
    """Drain a queue, keeping only the newest message (latest-wins;
    reference: gui/gui_utils.py:136-148)."""
    message = None
    while True:
        try:
            message = q.get_nowait()
        except queue.Empty:
            if q.empty():
                break
    return message


def apply_control(q_vis2main, vis_state: dict,
                  sleep_s: float = 0.1, max_pause_s: float = 0.0) -> dict:
    """Main-loop side of the control protocol (reference:
    pin_slam.py:412-433): drain the control queue latest-wins, copy the
    flags into `vis_state`, and block while the viewer holds pause
    (re-reading the queue until unpaused). `max_pause_s > 0` bounds the
    block (used by tests and headless runs)."""
    cp = get_latest_queue(q_vis2main)
    if cp is None:
        return vis_state
    for k in ("flag_vis", "flag_global", "flag_mesh", "flag_sdf",
              "flag_source", "mc_res_m", "mesh_min_nn", "mesh_freq_frame",
              "sdf_slice_height", "sdf_freq_frame", "sdf_res_m"):
        vis_state[k] = getattr(cp, k)
    t0 = time.time()
    while getattr(cp, "flag_pause", False):
        if max_pause_s > 0 and time.time() - t0 > max_pause_s:
            break
        time.sleep(sleep_s)
        nxt = get_latest_queue(q_vis2main)
        if nxt is not None:
            cp = nxt
            if not cp.flag_pause:
                break
    return vis_state


class ParamsGUI:
    """Viewer-process launch parameters (reference:
    gui/gui_utils.py:165-200)."""

    def __init__(self, q_main2vis=None, q_vis2main=None, run_path: str = ".",
                 frame_axis_len: float = 0.5, ego_state_on: bool = False,
                 mesh_default_on: bool = False, sdf_default_on: bool = False,
                 neural_point_map_default_on: bool = False,
                 render_every: int = 1):
        self.q_main2vis = q_main2vis
        self.q_vis2main = q_vis2main
        self.run_path = run_path
        self.frame_axis_len = frame_axis_len
        self.ego_state_on = ego_state_on
        self.mesh_default_on = mesh_default_on
        self.sdf_default_on = sdf_default_on
        self.neural_point_map_default_on = neural_point_map_default_on
        self.render_every = render_every


def _host(a):
    """A torch tensor (on any device) as a host numpy array; anything else
    as it is."""
    if hasattr(a, "detach") and hasattr(a, "cpu"):
        return a.detach().cpu().numpy()
    return a


def _np32(a):
    return None if a is None else np.asarray(_host(a), np.float32)


def _scalar(v, cast=float):
    return None if v is None else cast(_host(v))
