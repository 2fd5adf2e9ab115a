"""A small hash-probe run through `PinSLAMSystem.process_frame` whose
training takes every turn the captured whole-map route has to follow
(`slam/mapper.py::_WholeMapGraph`): frame 0's long run, other iteration
counts (a loop-closure boost on frame 2), the decoder freeze (frame 3) and
a capacity growth (before frame 4). Three variants: the cell probe, the
brick probe, and `full`, the cell probe with every branch the captured
iteration has (colour features and decoder, the semantic decoder, the
consistency loss, the projective correction) over coloured, labelled
scans. Shared by the CPU test of the route's buffers
(`test_torch_train_graph.py`) and the card test of its replays
(`test_torch_cuda.py`); it imports torch and numpy only."""

import functools

import torch

VARIANTS = ("cells", "brick", "full")

N_FRAMES = 6
BOOST_FRAME, FREEZE_FRAME, GROW_BEFORE = 2, 3, 4
WINDOW_M = 1.0


def config(variant="cells"):
    from pin_slam_tpu_torch.config import Config

    c = Config()
    c.track_on, c.silence = True, True
    c.probe_mode = "brick" if variant == "brick" else "cells"
    if variant == "full":
        c.color_on, c.color_channel = True, 3
        c.semantic_on, c.sem_class_count = True, 4
        c.consistency_loss_on, c.proj_correction_on = True, True
    c.max_range, c.min_range = 60.0, 0.5
    c.voxel_size_m, c.sigma_sigmoid_m, c.loss_weight_on = 0.3, 0.1, True
    c.vox_down_m, c.source_vox_down_m = 0.08, 0.4
    c.bs, c.iters, c.init_iter_ratio, c.bs_new_sample = 512, 3, 20, 128
    c.reg_iter_n = 50
    c.freeze_after_frame = FREEZE_FRAME
    c.map_capacity, c.buffer_size, c.max_frames = 1 << 15, 1 << 18, 16
    c.frame_point_cap, c.source_point_cap = 1 << 13, 1 << 11
    c.finalize()
    c.pool_capacity = 100_000
    return c


def frames(variant="cells"):
    """(poses, scans, semantic labels or None); `full`'s scans carry
    colour."""
    from pin_slam_tpu_torch.dataset.synthetic import (
        SyntheticSequence, circle_trajectory, default_scene_semantic,
        lidar_directions, procedural_color)

    full = variant == "full"
    scene, label_fn = default_scene_semantic()
    s = SyntheticSequence(
        scene_sdf=scene,
        poses=circle_trajectory(N_FRAMES, radius=6.0, revolutions=0.03,
                                ease_in_frames=4),
        dirs=lidar_directions(512, 32), max_range=60.0,
        color_fn=procedural_color if full else None)
    scans = [s.frame(i) for i in range(N_FRAMES)]
    labels = None
    if full:
        labels = [label_fn(p[:, :3] @ T[:3, :3].T + T[:3, 3])
                  for p, T in zip(scans, s.poses)]
    return s.poses, scans, labels


def run(device, seq, variant="cells", eager=False, replay=None):
    """`seq` (from `frames(variant)`) on `device` under the variant's
    configuration, the training loops built with
    `make_train_loop(_eager=eager)`; `replay`, when given, replaces
    `mapper._replays` (the CPU test's way through the graph's buffers).
    Returns (system, one dict a frame of host copies of the trained
    features, every decoder, the certainty, the update timestamps, the
    losses (the last training's) and the pose, and whether the frame
    trained)."""
    from pin_slam_tpu_torch.slam import mapper as mp
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    poses_gt, scans, labels = seq
    system = PinSLAMSystem(config(variant), device=device)
    system.set_gt_poses(poses_gt)
    # a travel window short enough that the frames' points leave it
    system.local_window_dist = WINDOW_M
    orig, orig_replays = mp.make_train_loop, mp._replays
    mp.make_train_loop = functools.partial(orig, _eager=eager)
    if replay is not None:
        mp._replays = replay
    def host(t):
        # a copy on the CPU too, where `.cpu()` would return the live tensor
        return t.detach().to("cpu", copy=True)

    out = []
    try:
        for fid in range(N_FRAMES):
            if fid == BOOST_FRAME:
                system.post_loop_iter_boost_pending = 2
            if fid == GROW_BEFORE:
                system.grow_map_capacity()
            pose = system.process_frame(
                fid, scans[fid],
                sem_labels=None if labels is None else labels[fid])
            s, p = system.state, system.params
            f = {"features": host(s.geo_features)}
            if s.color_features is not None:
                f["color_features"] = host(s.color_features)
            for name in ("geo_mlp", "color_mlp", "sem_mlp"):
                if p.get(name) is not None:
                    f[name] = [host(t) for k in ("w", "b")
                               for t in p[name][k]]
            out.append(dict(
                f, certainty=host(s.certainty), ts_update=host(s.ts_update),
                losses=host(system.last_train_losses),
                pose=torch.as_tensor(pose),
                trained=torch.tensor(system.last_did_map)))
    finally:
        mp.make_train_loop, mp._replays = orig, orig_replays
    return system, out


def assert_bit_equal(a, b):
    """Frame by frame, every field of two `run`s the same bits."""
    assert len(a) == len(b)
    for fid, (fa, fb) in enumerate(zip(a, b)):
        for name in fa:
            xa, xb = fa[name], fb[name]
            for ta, tb in (zip(xa, xb) if isinstance(xa, list)
                           else [(xa, xb)]):
                assert torch.equal(ta, tb), (fid, name)
