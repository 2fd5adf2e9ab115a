#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. Builds every CUDA kernel of the port from pin_slam_tpu_torch/csrc (one
   nvcc per source, in parallel) into build/kernels/.
2. Kernel against plain: the spatial-join k-NN kernel and its plain PyTorch
   version on the same prepared inputs at the two main-path shapes
   (tracker: 16384 queries, k = 12; training probe: 77824 queries, k = 8;
   local set capacity 65536). idx, d2, cnt and visits must be equal. Prints
   the kernel's time, the plain version's, and the bound (the larger of
   bytes over 3.35 TB/s and fp32 operations over 67 TFLOP/s, the H100 SXM
   peaks, with the operations counted from this run's visited tile pairs).
3. Kernel against plain: the fused per-neighbour SDF decode kernel and its
   plain PyTorch version at the mesher's batch (N = 524288 queries, k = 6,
   F+3 = 11 inputs, H = 64 hidden units) and at a ragged shape (N = 777,
   k = 8); they must agree to FUSED_ATOL (float32 sums in another order,
   outputs of O(0.1)). Prints kernel, plain and bound times.
4. The slice: PinSLAMSystem.process_frame over synthetic HDL-64 frames
   (1800 x 64 rays, ~115k points) in the configuration of bench.py, each
   frame's successor passed as next_points, on a default system: prints
   per-frame ms, steady-state fps, ATE against ground truth and the
   kernel's launch count, which must be > 0. Every tracked frame must be
   valid, every pose finite and within MAX_DRIFT_M of ground truth. A
   second system, which closes every stage with a device sync, gives the
   stage medians.
5. Map to mesh: a third default system runs the same frames with
   weighted_first=False (the per-neighbour decode), held to the same
   validity, finiteness and drift gates; prints its fps and ATE. Then a
   Mesher built as `pin_slam_tpu.run` builds it for a final save (infer_bs
   = infer_bs_final = 524288) meshes that system's map through the
   cell-table probe and the fused decode kernel. The marching resolution is
   the configuration's mc_res_m (0.3 m, not the 0.6x of a final save) and
   the cluster filter is off, so the host-side marching stays a small part
   of the run. The fused decode's launch count must equal the number of
   grid batches, the first grid batch must agree between kernel and plain
   version to FUSED_ATOL, the mesh must be non-empty, and the median
   distance of points sampled on it to the true scene surface must be <=
   MAX_MESH_MEDIAN_M.

The last two lines of stdout are a JSON object with every kernel's numbers
and {"ok": true, "device": {...}}. Exits non-zero, printing neither, when no
CUDA device is present or any phase fails.
"""

import json
import os
import re
import subprocess
import sys
import time
from multiprocessing import get_context

import numpy as np

N_FRAMES = 20
WARMUP = 10
MAX_DRIFT_M = 0.09 * N_FRAMES
FUSED_ATOL = 1e-5              # kernel against plain, outputs of O(0.1)
MAX_MESH_MEDIAN_M = 0.2        # half a map voxel: a bound on lost geometry
MESH_SAMPLES = 200_000
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM non-tensor fp32
# fp32 operations per query/point distance: 3 sub, 1 mul, 2 fma (2 each)
FLOP_PER_PAIR = 8


def log(*a):
    print(*a, flush=True)


def bench_config(Config, weighted_first=True):
    """The configuration of bench.py (KITTI-like, reference
    config/lidar_slam/run_kitti.yaml, static caps sized to HDL-64).
    `weighted_first=False` selects the per-neighbour decode, as
    config/lidar_slam/run_ncd_128.yaml and seven other shipped files do."""
    cfg = Config()
    cfg.weighted_first = weighted_first
    cfg.track_on = True
    cfg.max_range = 80.0
    cfg.min_range = 0.5
    cfg.vox_down_m = 0.08
    cfg.source_vox_down_m = 0.6
    cfg.voxel_size_m = 0.4
    cfg.sigma_sigmoid_m = 0.08
    cfg.surface_sample_range_m = 0.25
    cfg.surface_sample_n = 4
    cfg.loss_weight_on = True
    cfg.bs = 16384
    cfg.iters = 12
    cfg.init_iter_ratio = 30
    cfg.bs_new_sample = 1000
    cfg.reg_iter_n = 100
    cfg.map_capacity = 1 << 20
    cfg.buffer_size = 1 << 23
    cfg.frame_point_cap = 1 << 17
    cfg.source_point_cap = 1 << 14
    cfg.max_frames = 256
    cfg.local_set_cap = 1 << 16
    cfg.finalize()
    cfg.pool_capacity = 12_000_000
    return cfg


def make_sequence(n_frames):
    from pin_slam_tpu_torch.dataset.synthetic import (
        SyntheticSequence, circle_trajectory, default_scene,
        lidar_directions)
    return SyntheticSequence(
        scene_sdf=default_scene(half_extent=(40.0, 30.0, 6.0)),
        poses=circle_trajectory(n_frames, radius=6.0,
                                revolutions=0.008 * n_frames,
                                ease_in_frames=4),
        dirs=lidar_directions(1800, 64), max_range=80.0)


def _frame(i):
    return make_sequence(N_FRAMES).frame(i)


def cuda_time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_kernels(frames, poses, dev):
    """The k-NN kernel against its plain version at the main-path shapes."""
    import torch
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.ops.voxel import voxel_down_sample_hash_mask

    rng = np.random.RandomState(0)
    world = np.concatenate([f @ p[:3, :3].T + p[:3, 3]
                            for f, p in zip(frames[:4], poses[:4])])
    w = torch.as_tensor(world, dtype=torch.float32, device=dev)
    keep = voxel_down_sample_hash_mask(
        w, torch.ones(len(w), dtype=torch.bool, device=dev), 0.4, 1 << 22)
    pts = w[keep]
    cap = 1 << 16
    pos = torch.zeros((cap + 1, 3), device=dev)
    n = min(len(pts), cap)
    pos[:n] = pts[:n]
    lset = kj.build_local_set(pos, torch.arange(cap, device=dev) < n, 0.4,
                              cap)
    lp = lset.pts[:-1].contiguous()
    log(f"[kernels] local set: {n} neural points in a {cap}-row set")
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.slam.map_query import make_query_params
    md2 = make_query_params(bench_config(Config)).join_max_dist2
    out = []
    for name, nq, k, sigma in (("tracker", 1 << 14, 12, 0.05),
                               ("train", 65536 + 12 * 1000, 8, 0.3)):
        src = pts[torch.as_tensor(rng.randint(0, n, nq), device=dev)]
        q = src + torch.as_tensor(rng.randn(nq, 3).astype(np.float32)
                                  * sigma, device=dev)
        # padded to whole query tiles, as query_neighbors_join pads
        q = torch.cat([q, torch.full(((-nq) % kj.TQ, 3), kj.PAD,
                                     device=dev)])
        qs, tab, bbd, perm, md2f = kj.prepare(q, lp, md2, 0.4)
        got = kj._knn_walk_cuda(qs, lp, tab, bbd, perm, k, md2f)
        ref = kj._knn_walk_plain(qs, lp, tab, bbd, perm, k, md2f)
        torch.cuda.synchronize()
        names = ("idx", "d2", "cnt", "visits")
        for nm, a, b in zip(names, got, ref):
            if nm == "cnt":
                ok = torch.equal(a, b) or bool(((a == b) | ((a >= k)
                                                            & (b >= k))).all())
            else:
                ok = torch.equal(a, b)
            if not ok:
                raise AssertionError(f"knn_join {name}: kernel {nm} differs "
                                     "from the plain version")
        max_err = float((got[1] - ref[1]).abs().max())
        visits = int(got[3].sum())
        ms = cuda_time_ms(
            lambda: kj._knn_walk_cuda(qs, lp, tab, bbd, perm, k, md2f), 50)
        plain_ms = cuda_time_ms(
            lambda: kj._knn_walk_plain(qs, lp, tab, bbd, perm, k, md2f), 3)
        nbytes = (qs.numel() * 4 + lp.numel() * 4 + tab.numel() * 4
                  + bbd.numel() * 4 + perm.numel() * 8       # inputs
                  + qs.shape[0] * (k * 8 + 4) + tab.shape[0] * 4)  # outputs
        flops = visits * kj.TQ * kj.TL * FLOP_PER_PAIR
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        log(f"[kernels] knn_join {name}: N={nq} k={k} L={lp.shape[0]} "
            f"tile pairs visited={visits} idx/d2/cnt equal, max |d2 err|="
            f"{max_err} | kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound:.4f} ms ({'operations' if t_ops > t_bytes else 'bytes'}"
            f": {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB), library n/a")
        out.append(dict(shape=name, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by="operations" if t_ops > t_bytes else "bytes",
                        max_abs_err=max_err, n=nq, k=k, visits=visits))
    return out


def phase_fused_decode(dev):
    """The fused decode kernel against its plain version at the mesher's
    batch shape and at a ragged one."""
    import torch
    from pin_slam_tpu_torch.ops import fused_decode as fd

    out = []
    for name, n, k, d, h in (("mesher", 1 << 19, 6, 11, 64),
                             ("ragged", 777, 8, 11, 64)):
        rng = np.random.RandomState(7)
        gv = np.concatenate(
            [rng.randn(n, k, d - 3).astype(np.float32) * 0.3,
             rng.uniform(-0.6, 0.6, (n, k, 3)).astype(np.float32)], -1)
        w = rng.rand(n, k).astype(np.float32)
        w[rng.rand(n, k) < 0.2] = 0.0          # invalid neighbours weigh 0
        w /= w.sum(-1, keepdims=True) + 1e-15
        args = [torch.as_tensor(a, device=dev) for a in (
            gv, w, rng.randn(d, h).astype(np.float32) * 0.3,
            rng.randn(h).astype(np.float32) * 0.1,
            rng.randn(h, 1).astype(np.float32),
            np.full(1, 0.01, np.float32))]
        scale = 0.044
        got = fd.decode_weighted_sdf(*args, scale)
        ref = fd.decode_weighted_sdf_reference(*args, scale)
        torch.cuda.synchronize()
        max_err = float((got - ref).abs().max())
        if not (got.shape == (n,) and bool(torch.isfinite(got).all())
                and max_err <= FUSED_ATOL):
            raise AssertionError(
                f"fused_decode {name}: kernel differs from the plain version "
                f"by {max_err} (> {FUSED_ATOL})")
        ms = cuda_time_ms(lambda: fd.decode_weighted_sdf(*args, scale), 50)
        plain_ms = cuda_time_ms(
            lambda: fd.decode_weighted_sdf_reference(*args, scale), 10)
        # per row: first product 2*d*h, ReLU h, second product 2*h, then
        # bias, scale, weight and the k-sum (4)
        flops = n * k * (2 * d * h + 3 * h + 4)
        nbytes = sum(a.numel() for a in args) * 4 + n * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        by = "operations" if t_ops > t_bytes else "bytes"
        log(f"[kernels] fused_decode {name}: N={n} k={k} D={d} H={h} "
            f"mean |out|={float(ref.abs().mean()):.4f}, max |err|={max_err} "
            f"| kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.3f} MB), library n/a")
        out.append(dict(shape=name, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by=by, max_abs_err=max_err, n=n, k=k, d=d, h=h))
    return out


def run_frames(system, frames, poses, tag):
    """Drives process_frame over the frames, each frame's successor passed
    as next_points as bench.py does. Returns the estimated poses and the
    steady-state seconds per frame (wall clock from the end of the warm-up
    to the end of the last frame, closed by a device sync)."""
    import torch
    est, lost = [], []
    t_steady = None
    for fid in range(len(frames)):
        t0 = time.time()
        est.append(system.process_frame(
            fid, frames[fid],
            next_points=frames[fid + 1] if fid + 1 < len(frames) else None))
        dt = time.time() - t0
        if fid == WARMUP - 1:
            torch.cuda.synchronize()
            t_steady = time.time()
        tr = system.last_tracking
        losses = system.last_train_losses
        dp = est[-1][:3, 3] - poses[fid][:3, 3]
        if fid > 0 and not (tr is not None and bool(tr.valid)):
            lost.append(fid)
        log(f"[{tag}] frame {fid}: {dt * 1e3:.1f} ms on the host "
            f"(pose err {np.linalg.norm(dp) * 100:.2f} cm, z "
            f"{dp[2] * 100:+.2f} cm, "
            f"tracked={tr is not None and bool(tr.valid)}, "
            f"gn_iters={system.last_track_iters}, "
            f"map={int(system.state.count)}, loss="
            f"{float(losses[-1]) if losses is not None else float('nan'):.4f})")
    torch.cuda.synchronize()
    steady_s = (time.time() - t_steady) / (len(frames) - WARMUP)
    est = np.stack(est)
    if not np.isfinite(est).all():
        raise AssertionError(f"{tag}: non-finite pose")
    if lost:
        raise AssertionError(f"{tag}: the tracker lost track in frames "
                             f"{lost}")
    return est, steady_s


def check_drift(err):
    if err.max() > MAX_DRIFT_M:
        raise AssertionError(f"pose error {err.max():.3f} m is past the "
                             f"drift bound {MAX_DRIFT_M} m")


def phase_slice(frames, poses, dev):
    """The main path on a default PinSLAMSystem (launches, fps, ATE), then
    a second system with a device sync closing every stage, for the stage
    medians. Syncing also moves the frame's training behind its host pull,
    as the JAX reference's PIN_SYNC_TIMING does, so that run's fps is not
    the user's."""
    import torch
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.ops import fused_decode as fd
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    system = PinSLAMSystem(bench_config(Config), device=dev)
    system.set_gt_poses(poses)
    kj.LAUNCHES = 0
    fd.LAUNCHES = 0
    est, steady_s = run_frames(system, frames, poses, "slice")
    launches = kj.LAUNCHES
    if launches <= 0:
        raise AssertionError("the slice never launched the knn_join kernel")
    err = np.linalg.norm(est[:, :3, 3] - poses[: len(est), :3, 3], axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    n_steady = len(frames) - WARMUP
    log(f"[slice] steady state: {steady_s * 1e3:.1f} ms/frame = "
        f"{1 / steady_s:.3f} fps over {n_steady} frames")
    log(f"[slice] ATE (RMSE, no alignment) {ate * 100:.2f} cm, max "
        f"{err.max() * 100:.2f} cm; knn_join launches {launches} "
        f"({launches / len(frames):.1f} per frame); cap-overflow frames "
        f"{system.cap_overflow_frames}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    # The JAX reference sinks into the young map's floor by up to 9 cm per
    # frame on synthetic scans (VERDICT.md, "early-map z-sink"), so 20
    # frames may drift up to 1.8 m without a loss of track.
    check_drift(err)
    del system
    torch.cuda.empty_cache()

    synced = PinSLAMSystem(bench_config(Config), device=dev,
                           sync_timing=True)
    synced.set_gt_poses(poses)
    _, synced_s = run_frames(synced, frames, poses, "synced")
    stages = np.median(np.asarray(synced.timings)[WARMUP:], 0) * 1e3
    labels = ["preprocess", "odometry", "pgo", "map-prep", "map-opt"]
    log(f"[synced] steady state: {synced_s * 1e3:.1f} ms/frame = "
        f"{1 / synced_s:.3f} fps; stage medians: " + " ".join(
            f"{l}={v:.1f}ms" for l, v in zip(labels, stages)))
    return launches, dict(fps=1 / steady_s, ms=steady_s * 1e3, ate_m=ate,
                          stages=stages)


def phase_mesh(frames, poses, scene_sdf, dev):
    """Track+map with weighted_first=False, then mesh the map through the
    fused decode kernel. Returns both kernels' launch counts on this path
    and the mesh figures."""
    import torch
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.models import neural_points as npm
    from pin_slam_tpu_torch.ops import fused_decode as fd
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.slam import map_query as mq
    from pin_slam_tpu_torch.slam.mesher import MeshConfig, Mesher
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem
    from pin_slam_tpu_torch.utils.eval_mesh import sample_mesh_points

    cfg = bench_config(Config, weighted_first=False)
    system = PinSLAMSystem(cfg, device=dev)
    system.set_gt_poses(poses)
    mesher = Mesher(system.qp, MeshConfig(
        mc_res_m=cfg.mc_res_m, pad_voxel=cfg.pad_voxel,
        skip_top_voxel=cfg.skip_top_voxel, mc_mask_on=cfg.mc_mask_on,
        mesh_min_nn=cfg.mesh_min_nn,
        min_cluster_vertices=cfg.min_cluster_vertices,
        infer_bs=cfg.infer_bs_final, chunk_m=cfg.mc_res_m * 200))
    torch.cuda.reset_peak_memory_stats()
    kj.LAUNCHES = 0
    fd.LAUNCHES = 0
    est, steady_s = run_frames(system, frames, poses, "mesh")
    t0 = time.time()
    verts, faces = mesher.recon_map_mesh(
        system.state, system.params["geo_features"],
        system.params["geo_mlp"], filter_isolated=False)
    torch.cuda.synchronize()
    mesh_s = time.time() - t0
    knn_launches, fd_launches = kj.LAUNCHES, fd.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    d = est[:, :3, 3] - poses[: len(est), :3, 3]
    err = np.linalg.norm(d, axis=1)
    log(f"[mesh] weighted_first=False steady state: {steady_s * 1e3:.1f} "
        f"ms/frame = {1 / steady_s:.3f} fps over {len(frames) - WARMUP} "
        f"frames; ATE (RMSE, no alignment) "
        f"{float(np.sqrt(np.mean(err ** 2))) * 100:.2f} cm, max "
        f"{err.max() * 100:.2f} cm, max horizontal "
        f"{np.linalg.norm(d[:, :2], axis=1).max() * 100:.2f} cm, z at the "
        f"last frame {d[-1, 2] * 100:+.2f} cm; knn_join launches "
        f"{knn_launches}")
    check_drift(err)
    if knn_launches <= 0:
        raise AssertionError("the weighted_first=False run never launched "
                             "the knn_join kernel")
    if mesher.decode_route != "fused_decode" or fd_launches <= 0 \
            or fd_launches != mesher.n_batches:
        raise AssertionError(
            f"the mesher ran {mesher.n_batches} grid batches on the "
            f"{mesher.decode_route} route but the fused decode kernel was "
            f"launched {fd_launches} times")

    # the grid the mesher walked, and its first batch through both routes
    cnt = int(system.state.count)
    pos = system.state.positions[:cnt]
    chunks = mesher.split_chunks(pos.amin(0).cpu().numpy(),
                                 pos.amax(0).cpu().numpy(), mesher.mc.chunk_m)
    grids = [mesher.aabb_grid(lo, hi) for lo, hi in chunks]
    n_grid = sum(int(np.prod(d)) for _, d in grids)
    origin, dims = grids[0]
    pts = mesher.grid_coords(origin, dims, 0,
                             min(mesher.mc.infer_bs, int(np.prod(dims))), dev)
    with torch.no_grad():
        a = mq.query_decode(system.params["geo_features"],
                            system.params["geo_mlp"], pts, system.qp,
                            state=system.state, fused=True)
        b = mq.query_decode(system.params["geo_features"],
                            system.params["geo_mlp"], pts, system.qp,
                            state=system.state, fused=False)
    torch.cuda.synchronize()
    if fd.LAUNCHES != fd_launches + 1:
        raise AssertionError("fused=True did not launch the decode kernel")
    batch_err = float((a.sdf - b.sdf).abs().max())
    seen = int((a.nn_count > 0).sum())

    def batch_ms(fused):
        with torch.no_grad():
            return cuda_time_ms(lambda: mq.query_decode(
                system.params["geo_features"], system.params["geo_mlp"],
                pts, system.qp, state=system.state, fused=fused), 5)

    probe_ms = cuda_time_ms(lambda: npm.query_neighbors(
        system.state, pts, offsets=system.qp.offsets_np,
        resolution=system.qp.resolution, nn_k=system.qp.nn_k,
        max_dist2=system.qp.max_dist2), 5)
    fused_ms, plain_ms = batch_ms(True), batch_ms(False)
    if not (bool(torch.isfinite(a.sdf).all()) and batch_err <= FUSED_ATOL):
        raise AssertionError(
            f"first grid batch: kernel and plain decode differ by "
            f"{batch_err} (> {FUSED_ATOL})")

    log(f"[mesh] map of {cnt} neural points, mc_res_m={mesher.mc.mc_res_m} "
        f"(the configuration's, not the 0.6x of a final save), cluster "
        f"filter off: {len(chunks)} chunks, {n_grid} grid points, "
        f"{mesher.n_batches} batches of <= {mesher.mc.infer_bs} = "
        f"{fd_launches} fused_decode launches; query "
        f"{mesher.query_seconds / mesher.n_batches * 1e3:.1f} ms/batch "
        f"(probe, decode and pull), marching {mesher.marching_seconds:.2f} "
        f"s, whole mesh {mesh_s:.2f} s; first batch ({pts.shape[0]} points, "
        f"{seen} with neighbours) kernel vs plain max |err|={batch_err}; "
        f"that batch on the device: cell probe {probe_ms:.2f} ms, probe + "
        f"decode {fused_ms:.2f} ms through the kernel, {plain_ms:.2f} ms "
        f"through the plain decode")
    if verts.shape[0] == 0 or faces.shape[0] == 0:
        raise AssertionError("the mesh is empty")
    if not (np.isfinite(verts).all() and faces.min() >= 0
            and faces.max() < verts.shape[0]):
        raise AssertionError("the mesh has non-finite or dangling vertices")
    samples = sample_mesh_points(verts, faces, MESH_SAMPLES, seed=0)
    dist = np.abs(scene_sdf(samples))
    median = float(np.median(dist))
    log(f"[mesh] {verts.shape[0]} vertices, {faces.shape[0]} faces; "
        f"distance of {len(samples)} mesh samples to the true scene "
        f"surface: median {median:.4f} m, mean {dist.mean():.4f} m, 90 % "
        f"{np.percentile(dist, 90):.4f} m (bound on the median "
        f"{MAX_MESH_MEDIAN_M} m); peak device memory {peak:.2f} GiB")
    if median > MAX_MESH_MEDIAN_M:
        raise AssertionError(
            f"mesh samples lie a median {median:.3f} m from the true "
            f"surface, past {MAX_MESH_MEDIAN_M} m")
    return knn_launches, fd_launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pin_slam_tpu_torch.ops import cuda_build
    from pin_slam_tpu_torch.ops import knn_join as kj

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.time()
    cuda_build.build_all()
    log(f"[build] {', '.join(cuda_build.sources())} in "
        f"{time.time() - t0:.1f} s")
    for name, rep in cuda_build.BUILD_LOG.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", rep)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", rep))
        smem = sorted(set(re.findall(r"(\d+) bytes smem", rep)))
        log(f"[build] {name}: {len(regs)} instantiations, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, spill bytes "
            f"{spills}, shared memory "
            + (f"{'/'.join(smem)} B" if smem else "sized at launch"))

    t0 = time.time()
    seq = make_sequence(N_FRAMES)
    with get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        frames = pool.map(_frame, range(N_FRAMES))
    log(f"[data] {N_FRAMES} frames, {frames[0].shape[0]} points in frame 0, "
        f"{time.time() - t0:.1f} s")

    kres = phase_kernels(frames, seq.poses, dev)
    fres = phase_fused_decode(dev)
    launches, _ = phase_slice(frames, seq.poses, dev)
    mesh_knn_launches, fd_launches = phase_mesh(frames, seq.poses,
                                                seq.scene_sdf, dev)

    tr = next(r for r in kres if r["shape"] == "tracker")
    me = next(r for r in fres if r["shape"] == "mesher")
    kernels = [{
        "name": "knn_join",
        "route": "cuda",
        "source": "pin_slam_tpu_torch/csrc/knn_join.cu",
        "replaces": "pin_slam_tpu/ops/knn_join.py:142",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kres),
        "ms": tr["ms"], "plain_ms": tr["plain_ms"],
        "bound_ms": tr["bound_ms"], "bound_by": tr["bound_by"],
        "library_ms": None,
        "launches_mesh_path": mesh_knn_launches,
        "shapes": {r["shape"]: {k: r[k] for k in (
            "n", "k", "visits", "ms", "plain_ms", "bound_ms", "bound_by")}
            for r in kres},
    }, {
        "name": "fused_decode",
        "route": "cuda",
        "source": "pin_slam_tpu_torch/csrc/fused_decode.cu",
        "replaces": "pin_slam_tpu/ops/pallas_decode.py:31",
        "launches": fd_launches,
        "max_abs_err": max(r["max_abs_err"] for r in fres),
        "ms": me["ms"], "plain_ms": me["plain_ms"],
        "bound_ms": me["bound_ms"], "bound_by": me["bound_by"],
        "library_ms": None,
        "shapes": {r["shape"]: {k: r[k] for k in (
            "n", "k", "d", "h", "ms", "plain_ms", "bound_ms", "bound_by")}
            for r in fres},
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
