#!/usr/bin/env python3
"""Tracking on chip_smoke's loop trajectory, in either package, on the CPU
at a cut-down size.

    python3 scripts/loop_trajectory_tracking.py jax   follow|held N_FRAMES
    python3 scripts/loop_trajectory_tracking.py torch follow|held N_FRAMES

The trajectory is chip_smoke's `[loop]` one (1.2 laps of a 6 m circle over
44 frames, ~1.09 m a frame, 4-frame ease-in) with the heading following the
circle (10.4 deg a frame) or held. Cut to fit a CPU: the scene (half extents
16 x 12 x 4 m instead of 40 x 30 x 6), the scan (512 x 32 rays) and the
settings of tests/test_torch_slice.py's small_config. Prints each frame's
position error against ground truth and the tracker's verdict, so that the
two packages can be read side by side. A few minutes a run.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    pkg, heading, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
    from tests.test_torch_slice import small_config
    from pin_slam_tpu_torch.dataset.synthetic import (
        SyntheticSequence, circle_trajectory, default_scene, lidar_directions)
    if pkg == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_default_matmul_precision", "highest")
        from pin_slam_tpu.config import Config
        from pin_slam_tpu.slam.system import PinSLAMSystem
        system = PinSLAMSystem(small_config(Config))
    else:
        from pin_slam_tpu_torch.config import Config
        from pin_slam_tpu_torch.slam.system import PinSLAMSystem
        system = PinSLAMSystem(small_config(Config), device="cpu")
    seq = SyntheticSequence(
        scene_sdf=default_scene(half_extent=(16.0, 12.0, 4.0)),
        poses=circle_trajectory(44, radius=6.0, revolutions=1.2,
                                ease_in_frames=4,
                                yaw_follow=heading == "follow"),
        dirs=lidar_directions(512, 32), max_range=60.0)
    system.set_gt_poses(seq.poses)
    for i in range(n):
        pose = system.process_frame(i, seq.frame(i))
        tr = system.last_tracking
        err = np.linalg.norm(pose[:3, 3] - seq.poses[i][:3, 3])
        print(f"{pkg} {heading} frame {i}: position error {err:.3f} m, "
              f"tracker valid {None if tr is None else bool(tr.valid)}",
              flush=True)


if __name__ == "__main__":
    main()
