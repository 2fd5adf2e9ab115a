"""Capacity growth and the end-of-run refinement of the port's loop path, on
the CPU at a small size, in one tracking run: the slice tests'
configuration, scans (512 x 32 rays) and trajectory over 10 frames, with
the loop manager as the loop hook and a map capacity (2^14) that the run
outgrows.

* The count is checked every frame; when it passes 90 % of the capacity the
  map grows instead of raising, the run keeps tracking, the count ends above
  the old capacity and every pose stays within the slice tests' 10 cm /
  0.5 deg of ground truth.
* `LoopPgoManager.final_refine` then makes the assertions of the JAX
  package's own test (tests/test_loop_pgo.py, 12 frames of 512 x 32 rays):
  it refines at least half of the frames, keeps the trajectory finite and
  valid, and does not make the ATE worse than 1.2x + 1 cm. Its final
  training boost is the configuration's 3 iterations instead of 4x that:
  the assertions do not read the map it trains.

Torch runs on one thread here, as the test workers share the machine's
cores.
"""

import numpy as np
import pytest
import torch

from pin_slam_tpu_torch.config import Config
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence, circle_trajectory, default_scene, lidar_directions)
from pin_slam_tpu_torch.slam.loop import LoopPgoManager
from pin_slam_tpu_torch.slam.system import PinSLAMSystem
from pin_slam_tpu_torch.utils.eval_traj import absolute_error

from tests.test_torch_slice import MAX_DA, MAX_DT, small_config

OLD_CAP = 1 << 14       # ~15k points after six frames, ~17k after ten


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    n = 10
    seq = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(n, radius=6.0, revolutions=0.005 * n,
                                ease_in_frames=4),
        dirs=lidar_directions(512, 32), max_range=60.0)
    cfg = small_config(Config)
    cfg.map_capacity = OLD_CAP
    cfg.pool_filter_freq = 1         # the count is checked every frame
    cfg.pgo_on = True
    system = PinSLAMSystem(cfg, device="cpu")
    system.set_gt_poses(seq.poses)
    loop_mgr = LoopPgoManager(cfg, system)
    clouds = [seq.frame(i) for i in range(n)]
    est, counts, caps = [], [], []
    for i in range(n):
        est.append(system.process_frame(
            i, clouds[i],
            loop_hook=lambda f, _p=clouds[i]: loop_mgr.after_frame(f, _p)))
        counts.append(int(system.state.count))
        caps.append(system.state.capacity)
    return seq, system, loop_mgr, clouds, est, counts, caps


def _err(a, b):
    dt = np.linalg.norm(a[:3, 3] - b[:3, 3])
    R = a[:3, :3].T @ b[:3, :3]
    da = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    return dt, da


def test_capacity_grows_instead_of_raising(run):
    _, system, _, _, _, counts, caps = run
    assert caps[0] == OLD_CAP and caps[-1] == 2 * OLD_CAP
    assert system.config.map_capacity == 2 * OLD_CAP
    k = caps.index(2 * OLD_CAP)
    # grown at the first frame whose count passed 90 %, before it filled
    assert counts[k] > 0.9 * OLD_CAP
    assert all(c <= 0.9 * OLD_CAP for c in counts[:k])
    assert counts[-1] > OLD_CAP
    s = system.state
    for t in (s.positions, s.orientations, s.geo_features, s.ts_create,
              s.ts_update, s.certainty):
        assert t.shape[0] == 2 * OLD_CAP + 1


def test_tracking_continues_after_growth(run):
    seq, system, _, _, est, _, _ = run
    for i in range(1, len(est)):
        dt, da = _err(est[i], seq.poses[i])
        assert dt < MAX_DT and da < MAX_DA, (i, dt, da)
    assert not system.lose_track
    assert bool(torch.isfinite(system.state.positions).all())


def test_final_refine_improves_or_preserves_trajectory(run):
    """Runs after the two tests above: it moves the run's poses and map."""
    seq, system, loop_mgr, clouds, _, _, _ = run
    n = len(clouds)
    ate_pre, _ = absolute_error(seq.poses[:n], system.pgo_poses[:n],
                                align_on=False)
    n_ok = loop_mgr.final_refine(lambda f: clouds[f], n,
                                 train_boost=system.config.iters)
    assert n_ok >= (n - 1) // 2, f"only {n_ok} frames refined"
    ate_post, are_post = absolute_error(seq.poses[:n], system.pgo_poses[:n],
                                        align_on=False)
    assert np.isfinite(ate_post) and np.isfinite(are_post)
    assert ate_post <= ate_pre * 1.2 + 0.01, (ate_pre, ate_post)
    assert not system.lose_track
    assert system._map_deformed and system.after_pgo
