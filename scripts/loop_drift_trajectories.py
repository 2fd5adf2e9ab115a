#!/usr/bin/env python3
"""Odometry drift and loop closure on heading-following circles, at chip_smoke's
full width on the card.

    python3 scripts/loop_drift_trajectories.py [NAME=RADIUS,LAPS,FRAMES ...]

Each variant is a circle of chip_smoke's `[loop]` scene (`make_loop_sequence`
with the heading following the circle, 4-frame ease-in) run through a
PinSLAMSystem in chip_smoke's `loop_config` (a 2^19-row local set, so a
lap's map is never truncated) with `LoopPgoManager.after_frame` as the loop
hook. A variant stops at its first tracker-invalid frame. Prints, per frame,
the position and heading error of the returned pose against ground truth;
then each closure (frame, loop frame, kind), the error of the registered
loop edge and of the odometry chain's edge against the true relative pose,
the odometry and PGO poses' errors at the closure frame, and the ATE of the
odometry chain and of the PGO poses (no alignment). Default variants:
radius 16, 18 and 20 m (outside default_scene's pillar ring, which lies
10.5-14.7 m from the centre), 3-4 deg of turn a frame.
"""

import os
import sys
import time
from multiprocessing import get_context

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

DEFAULT = ["r16=16,1.08,96", "r18=18,1.08,120", "r20=20,1.06,118"]


def yaw_deg(R):
    return float(np.degrees(np.arctan2(R[1, 0], R[0, 0])))


def rel_err(Ta, Tb):
    """Translation (m) and rotation (deg) of Ta^-1 Tb."""
    D = np.linalg.inv(Ta) @ Tb
    ang = np.degrees(np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)))
    return float(np.linalg.norm(D[:3, 3])), float(ang)


def run_variant(name, radius, laps, n, dev):
    import torch
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.slam.loop import LoopPgoManager
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem
    from pin_slam_tpu_torch.utils.eval_traj import absolute_error

    traj = dict(n_frames=n, radius=radius, revolutions=laps, yaw_follow=True)
    seq = cs.make_loop_sequence(**traj)
    gt = seq.poses
    step = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)
    print(f"[{name}] radius {radius} m, {laps} laps, {n} frames, "
          f"{step[5:].mean():.3f} m and {np.degrees(step[5:].mean() / radius):.2f}"
          f" deg a frame", flush=True)
    t0 = time.time()
    with get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        frames = pool.map(cs._loop_frame, [(i, traj) for i in range(n)])
    print(f"[{name}] frames made in {time.time() - t0:.1f} s", flush=True)

    cfg = cs.loop_config(Config)
    cfg.local_set_cap = 1 << 19
    system = PinSLAMSystem(cfg, device=dev)
    system.set_gt_poses(gt)
    mgr = LoopPgoManager(cfg, system)
    done = 0
    t0 = time.time()
    for fid in range(n):
        pose = system.process_frame(
            fid, frames[fid],
            loop_hook=lambda f, _p=frames[fid]: mgr.after_frame(f, _p),
            next_points=frames[fid + 1] if fid + 1 < n else None)
        tr = system.last_tracking
        ok = fid == 0 or (tr is not None and bool(tr.valid))
        dp = pose[:3, 3] - gt[fid][:3, 3]
        dyaw = yaw_deg(pose[:3, :3]) - yaw_deg(gt[fid][:3, :3])
        dyaw = (dyaw + 180) % 360 - 180
        print(f"[{name}] frame {fid}: err {np.linalg.norm(dp) * 100:.2f} cm "
              f"(z {dp[2] * 100:+.2f}), yaw {dyaw:+.3f} deg, valid {ok}, "
              f"gn {system.last_track_iters}, map {int(system.state.count)}",
              flush=True)
        done = fid + 1
        if not ok:
            print(f"[{name}] lost track at frame {fid}", flush=True)
            break
    torch.cuda.synchronize()
    print(f"[{name}] {done} frames in {time.time() - t0:.1f} s", flush=True)
    odom, pgo = system.odom_poses[:done], system.pgo_poses[:done]
    for d in mgr.pgm.loop_diags:
        f, lid = d["frame"], d["loop"]
        T_gt = np.linalg.inv(gt[lid]) @ gt[f]
        e_edge = rel_err(T_gt, d["T_edge"])
        e_chain = rel_err(T_gt, d["T_chain"])
        e_odom = np.linalg.norm(odom[f][:3, 3] - gt[f][:3, 3])
        e_pgo = np.linalg.norm(pgo[f][:3, 3] - gt[f][:3, 3])
        print(f"[{name}] closure {f} -> {lid} ({d['kind']}): edge error "
              f"{e_edge[0] * 100:.2f} cm / {e_edge[1]:.3f} deg, chain edge "
              f"error {e_chain[0] * 100:.2f} cm / {e_chain[1]:.3f} deg; at "
              f"frame {f} odometry {e_odom * 100:.2f} cm, PGO "
              f"{e_pgo * 100:.2f} cm; PGO correction "
              f"{d['pgo_correction_m'] * 100:.2f} cm", flush=True)
    ate_o, _ = absolute_error(gt[:done], odom, align_on=False)
    ate_p, _ = absolute_error(gt[:done], pgo, align_on=False)
    print(f"[{name}] closures {mgr.pgo_count}; ATE odometry "
          f"{ate_o * 100:.2f} cm, PGO {ate_p * 100:.2f} cm", flush=True)


def main():
    import torch
    from pin_slam_tpu_torch.ops import cuda_build
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cuda_build.build_all()
    for spec in sys.argv[1:] or DEFAULT:
        name, vals = spec.split("=")
        r, laps, n = vals.split(",")
        run_variant(name, float(r), float(laps), int(n), torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
