#!/usr/bin/env python3
"""Vertical pose drift of the first frames on a young map, in either
package, on the CPU at a cut-down size.

    python3 scripts/young_map_z_drift.py jax   SEED WEIGHTED_FIRST N_FRAMES
    python3 scripts/young_map_z_drift.py torch SEED WEIGHTED_FIRST N_FRAMES

The scene, trajectory and settings are those of bench.py; cut to fit a CPU
are the scan (900 x 32 rays, about 29k points, for 1800 x 64), the batch
(8192 for 16384) and the capacities. Prints the z and horizontal pose error
of every frame against ground truth, so that the JAX reference and the port
can be read side by side. Takes a few minutes per run for the JAX package
and longer for the port (the first frame trains 360 iterations).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config_of(Config, weighted_first):
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
    cfg.bs = 8192
    cfg.iters = 12
    cfg.init_iter_ratio = 30
    cfg.bs_new_sample = 1000
    cfg.reg_iter_n = 100
    cfg.map_capacity = 1 << 17
    cfg.buffer_size = 1 << 21
    cfg.frame_point_cap = 1 << 15
    cfg.source_point_cap = 1 << 13
    cfg.max_frames = 64
    cfg.local_set_cap = 1 << 17
    cfg.probe_mode = "join"
    cfg.finalize()
    cfg.pool_capacity = 3_000_000
    return cfg


def main():
    which, seed = sys.argv[1], int(sys.argv[2])
    weighted_first, n_frames = sys.argv[3] == "1", int(sys.argv[4])
    if which == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from pin_slam_tpu.config import Config
        from pin_slam_tpu.dataset.synthetic import (
            SyntheticSequence, circle_trajectory, default_scene,
            lidar_directions)
        from pin_slam_tpu.slam.system import PinSLAMSystem
        make = lambda c: PinSLAMSystem(c, key=jax.random.PRNGKey(seed))
    else:
        import torch
        from pin_slam_tpu_torch.config import Config
        from pin_slam_tpu_torch.dataset.synthetic import (
            SyntheticSequence, circle_trajectory, default_scene,
            lidar_directions)
        from pin_slam_tpu_torch.slam.system import PinSLAMSystem
        make = lambda c: PinSLAMSystem(
            c, device="cpu", generator=torch.Generator().manual_seed(seed))
    seq = SyntheticSequence(
        scene_sdf=default_scene(half_extent=(40.0, 30.0, 6.0)),
        poses=circle_trajectory(20, radius=6.0, revolutions=0.16,
                                ease_in_frames=4),
        dirs=lidar_directions(900, 32), max_range=80.0)
    frames = [seq.frame(i) for i in range(n_frames)]
    system = make(config_of(Config, weighted_first))
    system.set_gt_poses(seq.poses)
    errs = []
    t0 = time.time()
    for i in range(n_frames):
        pose = np.asarray(system.process_frame(
            i, frames[i],
            next_points=frames[i + 1] if i + 1 < n_frames else None))
        errs.append(pose[:3, 3] - seq.poses[i][:3, 3])
    print(which, "seed", seed, "weighted_first", weighted_first, "points",
          frames[0].shape[0], "| z cm:",
          " ".join(f"{d[2] * 100:+.0f}" for d in errs), "| xy cm:",
          " ".join(f"{np.hypot(d[0], d[1]) * 100:.0f}" for d in errs),
          f"| {time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main()
