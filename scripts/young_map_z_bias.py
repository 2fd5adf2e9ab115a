#!/usr/bin/env python3
"""Where the vertical drift on a young map comes from: the map or the
feedback. Runs on one GPU.

    python3 scripts/young_map_z_bias.py [--seeds 42,4,1] [--frames 12]

Maps the 20-frame workload of chip_smoke.py with the GROUND-TRUTH poses
(`track_on=False`), so no pose error feeds back into the map. After each
frame's training it registers the NEXT frame against that map, starting at
its true pose, and prints how far the tracker moves it in z and in the
plane. Both `weighted_first` values, once per seed. A tracker that leaves
the true pose on a map built from true poses shows a bias of the young map
itself; one that stays shows that the free-running drift needs the feedback
of its own pose error. `--min-z` sets the preprocessing crop (sensor frame,
metres): the default of -5 removes every return of the scene's floor, which
lies 6 m below the sensor; -7 keeps it.
Needs a CUDA device and nvcc; imports nothing of jax.
"""

import argparse
import os
import sys
from multiprocessing import get_context

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def run(frames, poses, weighted_first, seed, n_frames, min_z):
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    cfg = cs.bench_config(Config, weighted_first)
    cfg.seed = seed
    cfg.track_on = False
    cfg.min_z = min_z
    system = PinSLAMSystem(cfg, device="cuda")
    system.set_gt_poses(poses)
    dz, dxy, iters = [], [], []
    for i in range(n_frames - 1):
        system.process_frame(i, frames[i])
        lset, feats = system._cur_lset, system._cur_track_feats
        _, _, src, src_n, _, _ = system._run_preprocess(frames[i + 1])
        anchor = poses[i][:3, 3].copy()
        T_init = poses[i + 1].copy()
        T_init[:3, 3] -= anchor
        res, T32, _, _ = system.track_chain_cached(
            feats, src, src_n, system._tensor(T_init),
            system._tensor(system.travel_dist[: system.max_frames]),
            system._tensor(anchor), i + 1, lset)
        d = T32[:3, 3].cpu().numpy() - poses[i + 1][:3, 3]
        dz.append(d[2] * 100)
        dxy.append(np.hypot(d[0], d[1]) * 100)
        iters.append(int(res.iterations))
    print(f"weighted_first={weighted_first} seed={seed} min_z={min_z:g} | "
          "tracker from the true pose on the true-pose map, z cm: "
          + " ".join(f"{v:+.1f}" for v in dz) + " | xy cm: "
          + " ".join(f"{v:.1f}" for v in dxy) + " | gn iters: "
          + " ".join(map(str, iters)), flush=True)


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="42,4,1")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--min-z", type=float, default=-5.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("young_map_z_bias: no CUDA device", file=sys.stderr)
        return 2
    seq = cs.make_sequence(cs.N_FRAMES)
    with get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        frames = pool.map(cs._frame, range(args.frames))
    for seed in map(int, args.seeds.split(",")):
        for wf in (False, True):
            run(frames, seq.poses, wf, seed, args.frames, args.min_z)
    return 0


if __name__ == "__main__":
    sys.exit(main())
