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
3. The slice: PinSLAMSystem.process_frame over synthetic HDL-64 frames
   (1800 x 64 rays, ~115k points) in the configuration of bench.py, each
   frame's successor passed as next_points, on a default system: prints
   per-frame ms, steady-state fps, ATE against ground truth and the
   kernel's launch count, which must be > 0. Every tracked frame must be
   valid, every pose finite and within MAX_DRIFT_M of ground truth. A
   second system, which closes every stage with a device sync, gives the
   stage medians.

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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM non-tensor fp32
# fp32 operations per query/point distance: 3 sub, 1 mul, 2 fma (2 each)
FLOP_PER_PAIR = 8


def log(*a):
    print(*a, flush=True)


def bench_config(Config):
    """The configuration of bench.py (KITTI-like, reference
    config/lidar_slam/run_kitti.yaml, static caps sized to HDL-64)."""
    cfg = Config()
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


def phase_slice(frames, poses, dev):
    """The main path on a default PinSLAMSystem (launches, fps, ATE), then
    a second system with a device sync closing every stage, for the stage
    medians. Syncing also moves the frame's training behind its host pull,
    as the JAX reference's PIN_SYNC_TIMING does, so that run's fps is not
    the user's."""
    import torch
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    system = PinSLAMSystem(bench_config(Config), device=dev)
    system.set_gt_poses(poses)
    kj.LAUNCHES = 0
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
    if err.max() > MAX_DRIFT_M:
        raise AssertionError(f"pose error {err.max():.3f} m is past the "
                             f"drift bound {MAX_DRIFT_M} m")
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
            f"{spills}, shared memory {'/'.join(smem)} B")

    t0 = time.time()
    seq = make_sequence(N_FRAMES)
    with get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        frames = pool.map(_frame, range(N_FRAMES))
    log(f"[data] {N_FRAMES} frames, {frames[0].shape[0]} points in frame 0, "
        f"{time.time() - t0:.1f} s")

    kres = phase_kernels(frames, seq.poses, dev)
    launches, _ = phase_slice(frames, seq.poses, dev)

    tr = next(r for r in kres if r["shape"] == "tracker")
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
        "shapes": {r["shape"]: {k: r[k] for k in (
            "n", "k", "visits", "ms", "plain_ms", "bound_ms", "bound_by")}
            for r in kres},
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
