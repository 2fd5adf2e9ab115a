#!/usr/bin/env python3
"""Offline map inspector: load a saved PIN map, remesh at any resolution.
Port of `pin_slam_tpu/vis_map.py` (reference: vis_pin_map.py:48-165, minus
the interactive GUI): loads `pin_map.npz` (written by either package),
rebuilds the hash, reconstructs the mesh at the requested resolution and
writes PLY (+ optional neural-point cloud export).

    python -m pin_slam_tpu_torch.vis_map <run_dir_or_npz> [-m mc_res_m]
        [-o output_mesh.ply] [-n] [--mesh-min-nn K] [-c]

On the CUDA card unless `-c` (or `device="cpu"`) asks for the CPU.
"""

from __future__ import annotations

import argparse
import os


def vis_pin_map(result_folder: str, mc_res_m: float = 0.2,
                mesh_out: str = None, export_points: bool = False,
                mesh_min_nn: int = 8, device=None):
    """Mesh a saved map; returns (verts, faces). `device` None: the card."""
    path = result_folder
    if os.path.isdir(path):
        path = os.path.join(path, "model", "pin_map.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(path)

    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.dataset.io import write_ply_points
    from pin_slam_tpu_torch.slam import map_query as mq
    from pin_slam_tpu_torch.slam.mesher import MeshConfig, Mesher, write_ply
    from pin_slam_tpu_torch.utils.map_io import load_implicit_map

    # the mesher's cell probe reads no brick cache
    state, mlps, meta = load_implicit_map(path, device=device,
                                          with_btable=False)
    cfg = Config()
    cfg.voxel_size_m = meta["voxel_size_m"]
    cfg.feature_dim = meta["feature_dim"]
    cfg.sigma_sigmoid_m = meta["sigma_sigmoid_m"]
    cfg.logistic_gaussian_ratio = meta["logistic_gaussian_ratio"]
    cfg.main_loss_type = meta["main_loss_type"]
    cfg.geo_mlp_hidden_dim = meta["geo_mlp_hidden_dim"]
    cfg.geo_mlp_level = meta["geo_mlp_level"]
    cfg.finalize()
    qp = mq.make_query_params(cfg)

    cnt = int(state.count)
    print(f"loaded map: {cnt} neural points (voxel {cfg.voxel_size_m} m)")

    out_dir = (result_folder if os.path.isdir(result_folder)
               else os.path.dirname(os.path.dirname(path)))
    if export_points:
        ply = os.path.join(out_dir, "map", "neural_points.ply")
        os.makedirs(os.path.dirname(ply), exist_ok=True)
        write_ply_points(ply, state.positions[:cnt].cpu().numpy())
        print(f"neural points -> {ply}")

    mesher = Mesher(qp, MeshConfig(
        mc_res_m=mc_res_m, mesh_min_nn=mesh_min_nn, skip_top_voxel=0,
        infer_bs=1 << 16))
    verts, faces = mesher.recon_map_mesh(
        state, state.geo_features, mlps["geo_mlp"])
    if mesh_out is None:
        mesh_out = os.path.join(
            out_dir, "mesh", f"mesh_{round(mc_res_m * 100)}cm_offline.ply")
    os.makedirs(os.path.dirname(mesh_out), exist_ok=True)
    write_ply(mesh_out, verts, faces)
    print(f"mesh ({verts.shape[0]} verts, {faces.shape[0]} faces) "
          f"-> {mesh_out}")
    return verts, faces


def main(argv=None):
    p = argparse.ArgumentParser(description="PIN map inspector")
    p.add_argument("result_folder")
    p.add_argument("-m", "--mc-res", type=float, default=0.2)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-n", "--export-points", action="store_true")
    p.add_argument("--mesh-min-nn", type=int, default=8)
    p.add_argument("-c", "--cpu-only", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    a = p.parse_args(argv)
    vis_pin_map(a.result_folder, a.mc_res, a.output, a.export_points,
                a.mesh_min_nn, device="cpu" if a.cpu_only else None)


if __name__ == "__main__":
    main()
