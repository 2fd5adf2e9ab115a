"""The port's second slice, map -> mesh under `weighted_first=False`,
against the JAX package at a small size on the CPU.

Four synthetic frames go through both PinSLAMSystems in join mode with the
per-neighbour decode (`weighted_first=False`, which also turns on the
tracker's sdf_std term), both starting from the JAX system's initial
decoder. Then each package's Mesher, built as `pin_slam_tpu.run` builds it,
meshes its own system's map.

The two systems draw their ray samples and batches from different
generators, so every comparison here is STATISTICAL:
* each frame's pose within MAX_DT / MAX_DA of the other system and of
  ground truth (the bounds of tests/test_torch_slice.py, for its reasons);
* map point counts within 8 % (they follow the pose: 5.3 % apart at most
  over four seeds of each system);
* both meshes non-empty, their samples a median <= 0.15 m (half a map
  voxel) from the true scene surface, the two medians within 5 cm of each
  other and the vertex counts within 25 %.
One comparison is exact up to rounding: the JAX mesher on the PORT's map
(converted back with numpy) gives the port's mesh, vertex counts within
1 % and Chamfer distance < 1 mm (a 1e-6 SDF difference may flip a cell).
"""

import numpy as np
import pytest
from scipy.spatial import cKDTree

import jax
import jax.numpy as jnp

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.slam import mesher as jmesh
from pin_slam_tpu.slam.system import PinSLAMSystem as JSystem
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence, circle_trajectory, default_scene, lidar_directions)
from pin_slam_tpu_torch.ops import fused_decode as tfd
from pin_slam_tpu_torch.slam import mesher as tmesh
from pin_slam_tpu_torch.slam.system import PinSLAMSystem as TSystem
from pin_slam_tpu_torch.utils.eval_mesh import sample_mesh_points

N_FRAMES = 4
MAX_DT, MAX_DA = 0.10, 0.5
MAX_MEDIAN_M = 0.15


def small_config(cls):
    cfg = cls()
    cfg.track_on = True
    cfg.weighted_first = False
    cfg.max_range = 60.0
    cfg.min_range = 0.5
    cfg.vox_down_m = 0.08
    cfg.source_vox_down_m = 0.4
    cfg.voxel_size_m = 0.3
    cfg.sigma_sigmoid_m = 0.1
    cfg.surface_sample_range_m = 0.25
    cfg.loss_weight_on = True
    cfg.bs = 1024
    # 8 training iterations a frame: with the 3 of tests/test_torch_slice.py
    # the per-neighbour decode leaves BOTH systems 4-14 cm from ground
    # truth by frame 3 (four seeds each); with 8 both stay within 8 cm and
    # 0.36 deg, inside the bounds that file states
    cfg.iters = 8
    cfg.init_iter_ratio = 100
    cfg.bs_new_sample = 256
    cfg.reg_iter_n = 20
    cfg.map_capacity = 1 << 16
    cfg.buffer_size = 1 << 18
    cfg.frame_point_cap = 1 << 13
    cfg.source_point_cap = 1 << 11
    cfg.max_frames = 16
    cfg.local_set_cap = 1 << 16    # never truncates the local map here
    cfg.train_subset_hist = 2048
    cfg.probe_mode = "join"
    cfg.mc_res_m = 0.3
    cfg.finalize()
    cfg.pool_capacity = 200_000
    return cfg


def _mesh_config(cls, c):
    return cls(mc_res_m=c.mc_res_m, pad_voxel=c.pad_voxel,
               skip_top_voxel=c.skip_top_voxel, mc_mask_on=c.mc_mask_on,
               mesh_min_nn=c.mesh_min_nn,
               min_cluster_vertices=c.min_cluster_vertices,
               infer_bs=c.infer_bs_final, chunk_m=c.mc_res_m * 200)


@pytest.fixture(scope="module")
def runs():
    s = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(N_FRAMES, radius=6.0, revolutions=0.02,
                                ease_in_frames=4),
        dirs=lidar_directions(512, 32), max_range=60.0)
    frames = [s.frame(i) for i in range(N_FRAMES)]
    js = JSystem(small_config(JConfig))
    ts = TSystem(small_config(TConfig), device="cpu")
    assert js.qp.weighted_first is False and ts.qp.weighted_first is False
    ts.params["geo_mlp"] = convert.mlp_from_numpy(
        jax.tree.map(np.asarray, js.params["geo_mlp"]))
    out = {"seq": s, "jax": [], "torch": [], "jcount": [], "tcount": []}
    for sys_, name, cnt in ((js, "jax", "jcount"), (ts, "torch", "tcount")):
        sys_.set_gt_poses(s.poses)
        for i in range(N_FRAMES):
            nxt = frames[i + 1] if i + 1 < N_FRAMES else None
            out[name].append(sys_.process_frame(i, frames[i],
                                                next_points=nxt))
            out[cnt].append(int(sys_.state.count))

    jm = jmesh.Mesher(js.qp, _mesh_config(jmesh.MeshConfig, js.config))
    tm = tmesh.Mesher(ts.qp, _mesh_config(tmesh.MeshConfig, ts.config))
    out["jmesh"] = jm.recon_map_mesh(js.state, js.params["geo_features"],
                                     js.params["geo_mlp"])
    n0 = tfd.LAUNCHES
    out["tmesh"] = tm.recon_map_mesh(ts.state, ts.params["geo_features"],
                                     ts.params["geo_mlp"])
    out["launches"] = tfd.LAUNCHES - n0
    out["n_batches"] = tm.n_batches

    # the JAX mesher on the port's own map and decoder
    st = ts.state
    back = js.state.replace(**{
        f: jnp.asarray(getattr(st, f).detach().numpy().astype(
            np.asarray(getattr(js.state, f)).dtype))
        for f in convert.STATE_FIELDS})
    mlp = ts.params["geo_mlp"]
    jmlp = {"w": [jnp.asarray(w.detach().numpy()) for w in mlp["w"]],
            "b": [jnp.asarray(b.detach().numpy()) for b in mlp["b"]]}
    out["jmesh_of_tmap"] = jm.recon_map_mesh(
        back, jnp.asarray(ts.params["geo_features"].detach().numpy()), jmlp)
    return out


def _err(a, b):
    dt = np.linalg.norm(a[:3, 3] - b[:3, 3])
    R = a[:3, :3].T @ b[:3, :3]
    da = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    return dt, da


@pytest.mark.parametrize("frame", range(1, N_FRAMES))
def test_frames_pose(runs, frame):
    gt = runs["seq"].poses[frame]
    for other in (runs["jax"][frame], gt):
        dt, da = _err(runs["torch"][frame], other)
        assert dt < MAX_DT and da < MAX_DA, (frame, dt, da)
    dt, da = _err(runs["jax"][frame], gt)
    assert dt < MAX_DT and da < MAX_DA, ("jax", frame, dt, da)


def test_map_counts(runs):
    for j, t in zip(runs["jcount"], runs["tcount"]):
        assert abs(t - j) <= 0.08 * j, (runs["jcount"], runs["tcount"])


def _median_to_surface(runs, key):
    v, f = runs[key]
    assert v.shape[0] > 0 and f.shape[0] > 0
    assert np.isfinite(v).all() and f.min() >= 0 and f.max() < v.shape[0]
    pts = sample_mesh_points(v, f, 20000, seed=0)
    return float(np.median(np.abs(runs["seq"].scene_sdf(pts))))


@pytest.mark.parametrize("key", ["tmesh", "jmesh"])
def test_mesh_lies_on_the_scene(runs, key):
    assert _median_to_surface(runs, key) <= MAX_MEDIAN_M


def test_meshes_alike(runs):
    (tv, tf), (jv, jf) = runs["tmesh"], runs["jmesh"]
    assert abs(tv.shape[0] - jv.shape[0]) <= 0.25 * jv.shape[0]
    assert abs(tf.shape[0] - jf.shape[0]) <= 0.25 * jf.shape[0]
    assert abs(_median_to_surface(runs, "tmesh")
               - _median_to_surface(runs, "jmesh")) < 0.05


def test_jax_mesher_on_the_ports_map_gives_the_ports_mesh(runs):
    (tv, tf), (jv, jf) = runs["tmesh"], runs["jmesh_of_tmap"]
    assert abs(tv.shape[0] - jv.shape[0]) <= 0.01 * jv.shape[0]
    assert abs(tf.shape[0] - jf.shape[0]) <= 0.01 * jf.shape[0]
    chamfer = 0.5 * (cKDTree(jv).query(tv)[0].mean()
                     + cKDTree(tv).query(jv)[0].mean())
    assert chamfer < 1e-3


def test_cpu_mesher_launches_no_kernel(runs):
    assert runs["n_batches"] > 0 and runs["launches"] == 0
