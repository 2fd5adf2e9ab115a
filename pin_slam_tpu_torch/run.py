#!/usr/bin/env python3
"""PIN-SLAM command-line entry point of the PyTorch port. Port of
`pin_slam_tpu/run.py`, with the same flags:

    python -m pin_slam_tpu_torch.run [config.yaml] [dataset] [sequence]
        -i/--input-path -o/--output-path --range B E S --seed N
        -d/--data-loader-on -c/--cpu-only -l/--log-on
        -s/--save-map -m/--save-mesh -p/--save-merged-pc --deskew -v

The run is on the CUDA card and raises without one; `-c` asks for the CPU
(every kernel wrapper then runs its plain PyTorch version). With
`setting: load_model: True` and `model_path` pointing at a saved
`pin_map.npz` the run localizes against that map without mapping.
`-v` (or `o3d_vis_on`) spawns the viewer process (`gui/`: an Open3D window
where open3d and a display are present, else PNG renders and
`<run>/gui/latest.npz`), fed one numpy-only packet a frame; `mesh_default_on`
and `sdf_default_on` write local meshes and SDF slices under `<run>/vis`
(`utils/visualizer.py`). With `tpu: dp_on` and more than one card the
training and the meshers run data-parallel over them.

Also importable as a library: `run_pin_slam(...)` returns the pose-eval
metric dict (reference: pin_slam.py:566).
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime
from typing import Optional, Tuple

import numpy as np
import yaml

from pin_slam_tpu_torch.config import Config
from pin_slam_tpu_torch.device import resolve_device


def setup_experiment(config: Config, argv=None) -> str:
    """Create the run directory tree and dump the resolved config
    (reference: utils/tools.py:41-128)."""
    ts = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    run_name = f"{config.name}_{ts}"
    run_path = os.path.join(config.output_root, run_name)
    for sub in ("map", "mesh", "model", "log", "meta"):
        os.makedirs(os.path.join(run_path, sub), exist_ok=True)
    config.run_path = run_path
    dump = {k: v for k, v in vars(config).items()
            if isinstance(v, (int, float, str, bool, list))}
    with open(os.path.join(run_path, "meta", "config_all.yaml"), "w") as f:
        yaml.safe_dump(dump, f)
    if argv:
        with open(os.path.join(run_path, "run.sh"), "w") as f:
            f.write("#!/bin/bash\npython " + " ".join(argv) + "\n")
    np.random.seed(config.seed)
    return run_path


def run_pin_slam(
    config_path: Optional[str] = None,
    dataset_name: Optional[str] = None,
    sequence_name: Optional[str] = None,
    input_path: Optional[str] = None,
    output_path: Optional[str] = None,
    frame_range: Optional[Tuple[int, int, int]] = None,
    seed: int = 42,
    data_loader_on: bool = False,
    cpu_only: bool = False,
    log_on: bool = False,
    save_map: bool = False,
    save_mesh: bool = False,
    save_merged_pc: bool = False,
    deskew: bool = False,
    visualize: bool = False,
    config: Optional[Config] = None,
    argv=None,
):
    """Run the full SLAM pipeline; returns the pose-eval metrics dict."""
    if config is None:
        config = Config()
        if config_path:
            config.load(config_path)
    config.use_dataloader = config.use_dataloader or data_loader_on
    config.seed = seed
    config.silence = not log_on
    config.save_map = config.save_map or save_map
    config.save_mesh = config.save_mesh or save_mesh
    config.save_merged_pc = config.save_merged_pc or save_merged_pc
    if deskew:
        config.deskew = True
    if visualize:
        config.o3d_vis_on = True
    if frame_range:
        config.begin_frame, config.end_frame, config.step_frame = frame_range
    if input_path:
        config.pc_path = input_path
    if output_path:
        config.output_root = output_path
    if dataset_name:
        from pin_slam_tpu_torch.dataset.dataset_indexing import (
            set_dataset_path)
        set_dataset_path(config, dataset_name, sequence_name)
    config.finalize()
    device = resolve_device("cpu" if cpu_only else None)

    run_path = setup_experiment(config, argv)
    if not config.silence:
        print(f"PIN-SLAM (PyTorch port) starts on {device}")

    from pin_slam_tpu_torch.dataset.slam_dataset import SLAMDataset
    from pin_slam_tpu_torch.slam.loop import LoopPgoManager
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    dataset = SLAMDataset(config)
    if dataset.total_pc_count == 0:
        raise FileNotFoundError(
            f"no point clouds found under '{config.pc_path}'")
    if config.max_frames < dataset.total_pc_count:
        config.max_frames = 1 << int(np.ceil(
            np.log2(dataset.total_pc_count + 1)))

    system = PinSLAMSystem(config, device=device)
    if dataset.gt_pose_provided:
        system.set_gt_poses(dataset.gt_poses)
    if config.load_model:
        system.load_map(config.model_path)
        if not config.silence:
            print(f"localization mode: map loaded from {config.model_path}")
    loop_mgr = LoopPgoManager(config, system) if config.pgo_on else None

    visualizer = None
    vis_mesher = None
    if config.o3d_vis_on or config.mesh_default_on or config.sdf_default_on:
        from pin_slam_tpu_torch.slam.mesher import MeshConfig, Mesher
        from pin_slam_tpu_torch.utils.visualizer import FileVisualizer
        visualizer = FileVisualizer(config, run_path)
        vis_mesher = Mesher(
            system.qp,
            MeshConfig(mc_res_m=config.mc_res_m,
                       mesh_min_nn=config.mesh_min_nn,
                       skip_top_voxel=config.skip_top_voxel,
                       min_cluster_vertices=0,
                       infer_bs=config.infer_bs_final),
            mesh=system.mesh)

    metrics_logger = None
    if config.wandb_vis_on or log_on:
        from pin_slam_tpu_torch.utils.logger import MetricsLogger
        metrics_logger = MetricsLogger(config, run_path)

    # spawned viewer process + control/vis queues (reference:
    # pin_slam.py:200-217,412-433)
    viewer = q_main2vis = q_vis2main = None
    vis_state = {}
    if config.o3d_vis_on:
        from pin_slam_tpu_torch.gui import start_viewer
        viewer, q_main2vis, q_vis2main = start_viewer(
            run_path, backend=config.gui_backend)

    t_start = time.time()
    for frame_id in range(dataset.total_pc_count):
        points, point_ts, sem_labels = dataset.read_frame_sem(frame_id)
        # deskew the cloud with the last relative motion estimate
        if config.deskew and frame_id > 0 and not system.lose_track \
                and point_ts is not None:
            points = dataset.deskew(points, point_ts, system.last_odom_tran)
        hook = None
        if loop_mgr is not None:
            hook = (lambda fid, _p=points: loop_mgr.after_frame(fid, _p))
        system.process_frame(frame_id, points,
                             gt_pose=dataset.gt_poses[frame_id]
                             if dataset.gt_pose_provided else None,
                             loop_hook=hook,
                             sem_labels=sem_labels
                             if config.semantic_on else None)
        mesh_vf = (None, None)
        if visualizer is not None:
            mesh_vf = visualizer.on_frame(system, frame_id, vis_mesher)
        if viewer is not None:
            from pin_slam_tpu_torch.gui import VisPacket, apply_control
            vis_state = apply_control(q_vis2main, vis_state,
                                      max_pause_s=600.0)
            el = time.time() - t_start
            pkt = VisPacket(frame_id=frame_id,
                            travel_dist=system.travel_dist[frame_id],
                            cur_fps=(frame_id + 1) / max(el, 1e-9))
            T = system.cur_pose_ref
            pkt.add_scan(points[:: 5, :3] @ T[:3, :3].T + T[:3, 3])
            pkt.add_traj(system.odom_poses[: frame_id + 1],
                         dataset.gt_poses[: frame_id + 1]
                         if dataset.gt_pose_provided else None,
                         system.pgo_poses[: frame_id + 1]
                         if config.pgo_on else None,
                         loop_edges=loop_mgr.pgm.loop_edges
                         if loop_mgr is not None else None)
            if mesh_vf[0] is not None:
                pkt.add_mesh(mesh_vf[0], mesh_vf[1])
            if frame_id % 20 == 0:
                cnt = int(system.state.count)
                if cnt:
                    stride = max(1, cnt // 40000)
                    pkt.add_neural_points_data(
                        system.state.positions[:cnt:stride],
                        count=cnt,
                        map_memory_mb=system.map_memory_mb(),
                        resolution=config.voxel_size_m,
                        pca_color_on=False)
            q_main2vis.put(pkt)
        # periodic pose-log snapshots (reference: write_results_log,
        # dataset/slam_dataset.py:646-666)
        if config.log_freq_frame > 0 and \
                (frame_id + 1) % config.log_freq_frame == 0:
            np.save(os.path.join(run_path, "log",
                                 f"odom_poses_{frame_id:05d}.npy"),
                    system.odom_poses[: frame_id + 1])
            if metrics_logger is not None:
                row = {"travel_dist": system.travel_dist[frame_id],
                       "map_memory_mb": system.map_memory_mb(),
                       "lose_track": int(system.lose_track)}
                if system.last_train_metrics is not None:
                    row.update(system.last_train_metrics)
                metrics_logger.log(row, step=frame_id)
        if not config.silence and frame_id % 10 == 0:
            el = time.time() - t_start
            print(f"frame {frame_id}/{dataset.total_pc_count} "
                  f"({el / (frame_id + 1) * 1e3:.0f} ms/frame, "
                  f"map {int(system.state.count)})")

    n = dataset.total_pc_count
    odom = system.odom_poses[:n]
    slam = system.pgo_poses[:n] if config.pgo_on else None
    metrics = dataset.write_results(
        run_path, odom, slam, np.asarray(system.timings),
        loop_edges=(loop_mgr.pgm.loop_edges
                    if loop_mgr is not None else None))

    if visualizer is not None:
        visualizer.finalize(system, n, dataset.gt_poses
                            if dataset.gt_pose_provided else None)
    if viewer is not None:
        from pin_slam_tpu_torch.gui import stop_viewer
        stop_viewer(viewer, q_main2vis)
    if metrics_logger is not None:
        if metrics:
            metrics_logger.log(metrics, step=n)
        metrics_logger.finish()

    if loop_mgr is not None and loop_mgr.pgo_count > 0:
        loop_mgr.write_g2o(os.path.join(run_path, "final_pose_graph.g2o"))
        loop_mgr.write_loops(os.path.join(run_path, "loop_log.txt"))

    if config.save_map:
        from pin_slam_tpu_torch.dataset.io import write_ply_points
        from pin_slam_tpu_torch.utils.map_io import save_implicit_map
        save_implicit_map(
            os.path.join(run_path, "model", "pin_map.npz"),
            system.state, system.params, config)
        cnt = int(system.state.count)
        write_ply_points(
            os.path.join(run_path, "map", "neural_points.ply"),
            system.state.positions[:cnt].cpu().numpy())

    if config.save_merged_pc:
        from pin_slam_tpu_torch.dataset.io import write_ply_points
        from pin_slam_tpu_torch.dataset.slam_dataset import crop_frame_np
        final = system.pgo_poses if config.pgo_on else system.odom_poses
        merged = []
        for frame_id in range(0, n, max(1, n // 500)):
            pts, _ = dataset.read_frame(frame_id)
            pts = crop_frame_np(pts[:, :3], config.min_z, config.max_z,
                                config.min_range, config.max_range)
            pts = pts[:: max(1, pts.shape[0] // 20000)]
            T = final[frame_id]
            merged.append(pts @ T[:3, :3].T + T[:3, 3])
        write_ply_points(
            os.path.join(run_path, "map", "merged_point_cloud.ply"),
            np.concatenate(merged).astype(np.float32))

    if config.save_mesh:
        from pin_slam_tpu_torch.slam.mesher import MeshConfig, Mesher, write_ply
        out_res = config.mc_res_m * 0.6
        mesher = Mesher(
            system.qp,
            MeshConfig(
                mc_res_m=out_res, pad_voxel=config.pad_voxel,
                skip_top_voxel=config.skip_top_voxel,
                mc_mask_on=config.mc_mask_on,
                mesh_min_nn=config.mesh_min_nn,
                min_cluster_vertices=config.min_cluster_vertices,
                infer_bs=config.infer_bs_final,
                chunk_m=out_res * 200),
            color_channel=config.color_channel,
            semantic_on=config.semantic_on,
            mesh=system.mesh)
        verts, faces = mesher.recon_map_mesh(
            system.state, system.params["geo_features"],
            system.params["geo_mlp"])
        mesh_colors = None
        if verts.shape[0] and (config.color_on or config.semantic_on):
            colors, sems = mesher.vertex_attributes(
                system.state, system.params["geo_features"],
                system.params["geo_mlp"], verts,
                color_features=system.params.get("color_features"),
                color_mlp=system.params.get("color_mlp")
                if config.color_on else None,
                sem_mlp=system.params.get("sem_mlp")
                if config.semantic_on else None,
                color_channel=config.color_channel)
            if config.semantic_on and sems is not None:
                from pin_slam_tpu_torch.utils.semantic_kitti_utils import (
                    sem_kitti_color)
                mesh_colors = sem_kitti_color(sems)
            else:
                mesh_colors = colors
        mesh_path = os.path.join(
            run_path, "mesh", f"mesh_{round(out_res * 100)}cm.ply")
        write_ply(mesh_path, verts, faces, mesh_colors)
        if not config.silence:
            print(f"mesh saved to {mesh_path}")

    return metrics


def main(argv=None):
    """Parse the command line (`argv`, default sys.argv[1:]) and run."""
    p = argparse.ArgumentParser(description="PIN-SLAM (PyTorch port)")
    p.add_argument("config_path", nargs="?", default=None)
    p.add_argument("dataset_name", nargs="?", default=None)
    p.add_argument("sequence_name", nargs="?", default=None)
    p.add_argument("-i", "--input-path", default=None)
    p.add_argument("-o", "--output-path", default=None)
    p.add_argument("--range", nargs=3, type=int, default=None,
                   metavar=("BEGIN", "END", "STEP"))
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("-d", "--data-loader-on", action="store_true")
    p.add_argument("-c", "--cpu-only", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    p.add_argument("-l", "--log-on", action="store_true")
    p.add_argument("-s", "--save-map", action="store_true")
    p.add_argument("-m", "--save-mesh", action="store_true")
    p.add_argument("-p", "--save-merged-pc", action="store_true")
    p.add_argument("--deskew", action="store_true")
    p.add_argument("-v", "--visualize", action="store_true",
                   help="spawn the viewer process (Open3D window or "
                   "headless PNG renderer)")
    a = p.parse_args(argv)
    metrics = run_pin_slam(
        a.config_path, a.dataset_name, a.sequence_name, a.input_path,
        a.output_path, tuple(a.range) if a.range else None, a.seed,
        a.data_loader_on, a.cpu_only, a.log_on, a.save_map, a.save_mesh,
        a.save_merged_pc, a.deskew, a.visualize, argv=None)
    if metrics:
        print(metrics)
    return metrics


if __name__ == "__main__":
    main()
