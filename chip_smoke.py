#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. Builds every CUDA kernel of the port from pin_slam_tpu_torch/csrc (one
   nvcc per source, in parallel) into build/kernels/.
2. Kernel against plain: the spatial-join k-NN kernel and its plain PyTorch
   version on the same prepared inputs at the two main-path shapes
   (tracker: 16384 queries, k = 12; training probe: 65536 + 12 * 1000 =
   77536 queries, padded to 77568, k = 8; local set capacity 65536). idx,
   d2, cnt and visits must be equal. Prints the longest row of the walk
   (the most local tiles one query tile visited, the kernel's critical
   path) and a histogram of the rows, the kernel's time, the plain version's, and the bound: the larger
   of bytes over 3.35 TB/s and fp32 operations over 67 TFLOP/s, the H100
   SXM peaks. The operations are those this run's data needs: the
   distances of the (warp, 32-point chunk) pairs of the visited tile pairs
   that the kernel's exact chunk test cannot skip, the tests themselves
   and the chunks' bounding boxes.
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
6. Loop closure: the bench.py configuration with loop closure and PGO on,
   as config/lidar_slam/run_kitti.yaml ships them (pgo_freq 20), with the
   cuts of `loop_config` (the floor kept; min_loop_travel_dist_ratio 0.4,
   so a revisit fits in the run; a local set sized to a lap's map), drives
   LOOP_FRAMES frames of 1.2 laps of a 6 m circle (~1.09 m per frame, the
   heading held) through process_frame with
   `loop_hook=lambda f: loop_mgr.after_frame(f, points)`. It fails unless a
   closure is accepted, no frame is tracker-invalid, the map carries
   non-identity orientations afterwards, the training boost is consumed by
   the frame after the closure, and the closure did what it should: the
   solve pulled the closure frame at least LOOP_EDGE_PULL of the way from
   the odometry chain's edge onto the registered loop edge; every live map
   point, and a sample of POOL_SAMPLE pool rows, moved by the correction of
   its own timestamp (against a float64 evaluation on the host, to
   DEFORM_ATOL_M and DEFORM_ROT_ATOL); the ATE of the PGO poses (no
   alignment) is at most the odometry chain's + the smaller of
   LOOP_ATE_SLACK_M and LOOP_ATE_SLACK_OF_CORRECTION x the correction at
   the closure frame; no PGO pose is past MAX_DRIFT_M. Prints each closure
   (with the errors of its loop edge, of the chain's edge and of the
   closure frame's odometry and PGO poses against ground truth), the PGO
   stage's median over closure frames and the others, the device time of
   one deformation, rehash and replay-pool transform at the run's 12M-row
   pool, the k-NN launches, fps, ATE before and after PGO and the peak
   device memory.

7. Bundle adjustment (`[ba]`): config/lidar_slam/run_ncd_128_s.yaml as
   shipped (voxel 0.15 m, range 0.5-15 m, weighted_first=False, bs 16384,
   15 iterations with adaptive_iters, BA every 20 frames over up to 50
   frames with 80 iterations of 16384 samples, map 2^22, pool 10M, and its
   `pgo:` section with map_context, run through LoopPgoManager's hook)
   drives BA_FRAMES frames of an NCD-128-like sensor (Ouster OS0-128: 1024
   x 128 rays over +-45 deg) on a hand-held walk (0.14 m a frame, the
   heading turning 1.34 deg a frame) round the island of make_sequence's
   room, whose far walls lie beyond the 15 m range. Cuts: synthetic scans
   (no NCD data is in the repo); no sweep and process_frame driven directly,
   so the config's `deskew` is not exercised (`[bag]` runs this YAML
   deskewed from a bag through the entry point); 40 frames. It fails unless no
   frame is invalid, BA ran exactly on frames 19 and 39, each BA's last
   loss is below its first, the pose chain after each BA is BA's output,
   POOL_SAMPLE pool rows moved by the correction of their own timestamp
   (float64 host evaluation, to BA_POOL_ATOL_M), the first BA run again
   from the same state with the same draws gives the same bits, and every
   pose is within 0.09 m x frames of ground truth. Prints ms/frame on BA
   frames and the others, BA's device ms, loss curve, largest pose change
   and the ATE before and after each BA, the point-cap overflow count, map
   points and peak memory.
8. The dynamic filter (`[dynamic]`): config/lidar_slam/run_kitti_mos.yaml
   as shipped (voxel 0.4 m, weighted_first=False, k 6, frame cap 65536,
   pool 20M, map 2^22, the filter's thresholds) with the visibility test on
   from origins 10, 30 and 60 frames back (as
   eval/eval_gauntlet_long.py --dynamic sets it), over DYN_FRAMES HDL-64
   frames on make_sequence's circle in make_sequence's room plus three
   spheres of 0.8 m crossing it at 0.15 m a frame. Cuts: min_z -7 m (the
   floor kept, as in `[loop]`), a 2^18-row local set (as `[loop]`),
   synthetic scans. It fails unless no frame is invalid, the fused decode
   kernel was launched once per judged frame, on one frame the kernel's SDF
   agrees with the plain decode to FUSED_ATOL and the two routes' static
   masks differ only where the SDF lies within FUSED_ATOL of a threshold,
   at most MAX_FALSE_DYNAMIC of the static measurements are flagged, and
   some mover measurement is flagged after frame 10 (truth: a training
   point within 0.8 + MOVER_MARGIN_M m of a mover's centre). Prints
   per-frame precision and recall, the filter's device ms, ms/frame and
   ATE.

9. Colour (`[color]`): config/lidar_slam/run_kitti_color.yaml as shipped
   (voxel 0.4 m, weighted_first=False, k 6, colour channels 3, the
   tracker's 100 GN iterations with the colour-consistency weight, decoders
   frozen after frame 40, map 2^22, frame cap 65536, source cap 8192, pool
   20M, and its `pgo:` section through LoopPgoManager's hook) over
   COLOR_FRAMES HDL-64 frames of make_sequence's circle and room, coloured
   by `procedural_color`. Cuts: synthetic scans (`kitti_correct` is not
   exercised), min_z -7 m (as `[dynamic]`). The
   tracker takes its uncached path: a local set with colour features built
   each frame and one k-NN probe every GN iteration. It fails unless no
   frame is invalid, every pose is within 0.09 m x frames of ground truth,
   the k-NN kernel launched, the map's colour at SURFACE_PROBES
   ground-truth surface points (nn_count >= 6, as eval/eval_gauntlet.py
   scores it) has a mean abs error <= COLOR_MAX_MAE and a correlation >
   COLOR_MIN_CORR (tests/test_rgbd_semantic.py's bounds), and the colour
   mesh of the map (a Mesher as `[mesh]` builds it, vertex colours from
   `vertex_attributes`) launched the fused decode once per grid batch.
   Then the k-NN kernel at the colour tracker's shape (the last frame's
   8192-point source cloud, k = 6, against that frame's tracking local set)
   must be bit-equal to its plain version. Prints ms/frame, GN iterations
   and k-NN launches a frame, the tracker's share of the host time, ATE,
   the colour scores, the mesh's vertices and colour error, peak memory.
10. Semantics (`[semantic]`): config/lidar_slam/run_demo_sem.yaml as
   shipped (20 classes, range 60 m, 20 GN iterations, map 2^21,
   weighted_first true) over SEM_FRAMES frames (`[color]`'s ray casts: the
   two rooms have the same primitives) on the same circle in
   `default_scene_semantic`'s room with its labels per point, through
   `process_frame(sem_labels=...)`. Cuts: min_z -7 m, synthetic labels in
   place of SemanticKITTI. Fails unless no frame is invalid, the drift
   gate holds, the k-NN kernel launched, the fused decode did not (its
   decode is weighted_first=False's) and the accuracy at SURFACE_PROBES
   ground-truth surface points is >= SEM_MIN_ACC. Prints ms/frame, ATE,
   accuracy and per-class IoU, and a semantic mesh with its vertex labels'
   accuracy.

11. The entry point (`[run]`): config/lidar_slam/run_kitti.yaml as shipped
   (voxel 0.4 m, weighted_first true, `pgo:` through LoopPgoManager's
   hook, map 2^22, frame cap 65536, source cap 8192, kitti_correct 0.195
   deg) run as a user runs it, `python -m pin_slam_tpu_torch.run <yaml> -o
   <dir> -s -m --deskew` (in-process, through `run.main`), over RUN_FRAMES
   frames of make_sequence's circle and room scanned by a spinning HDL-64
   (`sweep=True`: each ray fires from the pose of its instant), read from
   disk: PLY scans with a `time` field written through the inverse of the
   KITTI correction, poses.txt in the camera frame of a calib.txt whose Tr
   is not the identity, the ground truth at mid-scan (the frame a deskewed
   scan is expressed in). Cuts: synthetic scans, min_z -7 m, the YAML's
   paths pointed at that dataset. It fails unless every artifact of
   tests/test_cli_e2e.py is written, no frame is invalid, the ATE of
   `write_results` and every odometry and PGO pose are within 0.09 m x
   frames, the k-NN kernel launched and the fused decode did not
   (weighted_first true), the final mesh is not empty and the median
   distance of its vertices to the scene is <= MAX_MESH_MEDIAN_M, deskew
   brings the scans closer to the scene (on frames RUN_DESKEW_FRAMES, the
   median |scene SDF| of the scan deskewed as the run did, placed with the
   true pose, is below the raw scan's) and `vis_pin_map` meshes the saved
   map (at the YAML's mc_res_m). Prints ms/frame, GN iterations, launches, ATE, mesh and deskew
   figures.
12. Localization (`[localize]`): the same YAML with `load_model: True` and
   `model_path` at `[run]`'s pin_map.npz, through `run.run_pin_slam(...,
   deskew=True)` over the same frames: the decoders and the map frozen, a
   join set built once over the whole map, every frame tracked against it.
   It fails unless every frame is valid, the map's rows, features and
   decoder are bit-equal to the saved file after the run, the count is
   unchanged, no training ran, the fused decode did not launch, and the ATE
   is at most `[run]`'s + LOC_ATE_SLACK_M. Then the k-NN kernel at the
   localization shape (the last frame's source cloud on its pose, k = 12
   candidates, against the frozen set) must be bit-equal to its plain
   version. Prints ms/frame, GN iterations, k-NN launches a frame, the
   frozen set's size and the kernel's time, plain time and bound.
13. A ROS1 bag (`[bag]`): config/lidar_slam/run_ncd_128_s.yaml as shipped
   (`[ba]`'s configuration: BA every 20 frames, its `pgo:` section through
   LoopPgoManager's hook, weighted_first false, deskew) run as a user runs
   it, `python -m pin_slam_tpu_torch.run <yaml> rosbag -i <dir> -o <out>
   -d --deskew -s -m` (in-process, through `run.main`), over BAG_FRAMES
   frames of `[ba]`'s OS0-128 walk scanned as the sensor scans it: each
   column fired from the pose of its instant, written by the port's
   `write_bag1` as one uncompressed bag of organised 128 x 1024
   PointCloud2 messages in the ouster_ros package's layout (x, y, z,
   intensity, `t` in uint32 ns from the scan's start, reflectivity, ring,
   ambient, range; point_step 48; rays without a return at (0, 0, 0)) on
   BAG_TOPIC. Cuts: synthetic scans, 20 frames. A bag carries no ground
   truth: the phase scores the written poses against the mid-scan truth
   in the first scan's frame. It fails unless every artifact is written,
   no frame is invalid, every odometry and PGO pose is within 0.09 m x
   frames, BA ran once (frame 19) and lowered its loss, the k-NN kernel
   launched and the fused decode launched once per grid batch of the
   final mesh, the final mesh is not empty and the median distance of its
   vertices to the scene is <= MAX_MESH_MEDIAN_M, every frame the rosbag
   loader returns is the cloud written (bit for bit, `t` normalised as
   read_point_cloud2 does) and so are the first 3 written again as MCAP
   and read by McapDataloader, and deskew brings frames BAG_DESKEW_FRAMES
   closer to the scene. Prints process_frame's ms/frame, GN iterations,
   k-NN launches a frame, BA's device ms, the ATE, the host's bag read and
   deskew ms a frame (timed apart from process_frame), the bag's size and
   the peak device memory.

14. The hash-table probes (`[probes]`, after `[mesh]`): the bench.py
   configuration with weighted_first=False and the floor kept (min_z -7
   m, as `[loop]`; a 2^17-row join set, which holds the run's map), over
   the same 20 frames three times, under probe_mode join, cells and brick
   (the brick cache: (2^19 + 1) x 64 x 3 int32 at the 2^23 table). It
   fails unless every frame is tracker-valid in every run, the drift gate
   holds, the join run launched the k-NN kernel and the cell and brick
   runs did not (they build no local set), the brick run's map meshed at
   0.3 m through the brick probe launched the fused decode once per grid
   batch and lies a median <= MAX_MESH_MEDIAN_M from the scene, and on
   that map the brick and cell probes agree within the JAX package's
   bounds (tests/test_ops.py: nn_count differs on < 15 % of the queries,
   the neighbour sets agree on > 90 %) at the tracker's source cloud and
   at a 16384-sample training batch. Prints per mode ms/frame (median of
   the steady frames), GN iterations a frame, ATE, the launches, peak
   memory and the brick table's bytes, and the device ms of the three
   probes (cells, brick, join: the set build plus the k-NN call) at the
   tracker's cloud, the training batch and the mesher's 524288-point
   batch, with the share of queries whose neighbours differ between brick
   and cells.
15. The training options (`[options]`): the same configuration on the
   join probe with incidence labels (mode "label") and the consistency
   loss. Fails unless every frame is valid, the drift gate holds, the
   k-NN kernel launched, some of the last frame's training points are
   corrected by their incidence and the consistency term is finite.
   Prints ms/frame, ATE, z at the last frame, k-NN launches a frame, the
   last training cloud's incidence cosines (the share below 1, the median
   and the share at the floor) and the consistency term at the last
   training iteration.

16. Data parallelism (`[dp]`, after `[mesh]`), DP_REPLICAS replicas on
   the one card (`["cuda:0"] * 2`): the DP training loop on `[slice]`'s
   final map (bench bs 16384 a replica, DP_ITERS iterations, the
   whole-map route) against a sequential mimic of
   tests/test_parallel.py's on the same per-replica draws (losses,
   features and decoder to rtol 1e-4 / atol 1e-5, certainty 1e-4, update
   timestamps equal), timed against one replica's loop at the same
   effective batch; the sharded Mesher over `[mesh]`'s map bit-equal to
   the unsharded one on every grid, with DP_REPLICAS fused-decode launches
   a grid batch; a `dp_on` system over VIEWER_FRAMES bench frames with
   one visible card: `mesh` None, poses and map bit-equal to `dp_on` off.
17. The viewer (`[viewer]`): run_kitti.yaml through `python -m
   pin_slam_tpu_torch.run <yaml> -o <dir> -v --range 0 10 1` (in-process)
   over VIEWER_FRAMES of `[run]`'s swept frames on disk, with
   mesh_default_on and, where matplotlib is installed, sdf_default_on
   every VIEWER_FREQ frames (cuts: no shipped YAML turns these on; without
   matplotlib the PNG renders and SDF slice files are left off and the
   slice is computed through Mesher.sdf_slice after the run and checked
   for finiteness). Fails unless every packet sent to the spawned viewer
   holds no torch tensor, the viewer process exits on stop_viewer,
   gui/latest.npz holds the last frame with the odometry of
   odom_poses_kitti.txt, the local mesh at frame VIEWER_FREQ is non-empty
   and a median <= MAX_MESH_MEDIAN_M from the scene,
   vis/neural_points_pca.ply holds the map's count, the k-NN kernel
   launched and the poses keep the drift gate.
18. The ROS node (`[ros]`): `PINSLAMRosNode` with run_ncd_128_s.yaml fed
   the first ROS_FRAMES PointCloud2 messages of `[bag]`'s bag through its
   frame callback, under stand-in rospy, nav_msgs, geometry_msgs,
   sensor_msgs, tf2_ros and std_srvs modules defined here (the card's
   machine has no ROS). Fails unless every message is tracked, each
   published Odometry is the system's pose with `np_rotmat_to_quat`'s
   quaternion, every pose keeps the drift gate against the mid-scan truth,
   the k-NN kernel launched and the save_results service writes a
   pin_map.npz that `load_implicit_map` reads back bit-equal.

The last two lines of stdout are a JSON object with every kernel's numbers
and {"ok": true, "device": {...}}. Exits non-zero, printing neither, when no
CUDA device is present or any phase fails. `--only color,semantic` (any of
slice, mesh, dp, probes, options, loop, ba, dynamic, color, semantic, run,
localize, viewer, bag, ros; localize runs run first, dp slice and mesh)
runs the build, the kernel checks and the phases named, and prints neither
line: a quicker check while working.
"""

import argparse
import json
import os
import re
import shutil
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
LOOP_FRAMES = 44
# PGO may make the ATE worse by at most this, and by at most half the
# correction it applied at the closure frame
LOOP_ATE_SLACK_M = 0.02
LOOP_ATE_SLACK_OF_CORRECTION = 0.5
# the solve must pull the closure frame at least halfway from the odometry
# chain's edge onto the registered loop edge
LOOP_EDGE_PULL = 0.5
DEFORM_ATOL_M = 1e-4           # float32 transforms of points ~40 m out
DEFORM_ROT_ATOL = 1e-5         # rotation-matrix entries, float32 quaternions
CORRECTION_ATOL = 1e-6         # float32 copies of the solve's corrections
POOL_SAMPLE = 1 << 17          # pool rows held against the plain evaluation
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM non-tensor fp32
# fp32 operations per query/point distance: 3 sub, 1 mul, 2 fma (2 each)
FLOP_PER_PAIR = 8
# per query and 32-point chunk, the k-NN kernel's reachability test: per
# axis 2 sub and 2 max, then 1 mul and 2 fma
CHUNK_TEST_FLOP = 17
# per 32-point chunk, its bounding box: 6 reductions of 32 values
CHUNK_BOX_FLOP = 6 * 31
ROOT = os.path.dirname(os.path.abspath(__file__))
BA_FRAMES = 40
NCD_STEP_M = 0.14              # a walk at 1.4 m/s, scanned at 10 Hz
NCD_RADIUS_M = 6.0             # 1.34 deg of turn a frame
BA_POOL_ATOL_M = 1e-4          # float32 transforms of points <= 15 m out
DYN_FRAMES = 30
DYN_CHECK_FRAME = 20           # the frame whose filter runs both routes
MOVER_RADIUS_M = 0.8
MOVER_MARGIN_M = 0.1
MAX_FALSE_DYNAMIC = 0.01       # tests/test_visibility.py's bound
COLOR_FRAMES = 20
SEM_FRAMES = COLOR_FRAMES      # [semantic] labels [color]'s ray casts
SURFACE_PROBES = 100_000       # eval/eval_gauntlet.py's colour/label probe
COLOR_MAX_MAE = 0.08           # tests/test_rgbd_semantic.py's bounds
COLOR_MIN_CORR = 0.9
SEM_MIN_ACC = 0.8
RUN_FRAMES = 30
RUN_DESKEW_FRAMES = (10, 20, 29)
KITTI_CORRECT_DEG = 0.195      # run_kitti.yaml's kitti_correct / correct_deg
LOC_ATE_SLACK_M = 0.02
BAG_FRAMES = 20                # run_ncd_128_s.yaml's BA runs once, on 19
BAG_DESKEW_FRAMES = (10, 19)
BAG_TOPIC = "/os_cloud_node/points"   # the ouster_ros package's topic
OS_ROWS, OS_COLS = 128, 1024   # Ouster OS0-128 in its 1024 x 10 Hz mode
SCAN_NS = 100_000_000
BAG_ROOM_HALF_HEIGHT_M = 6.0   # make_ncd_sequence's floor and ceiling
VIEWER_FRAMES = 10             # [viewer]'s frames of [run]'s dataset
VIEWER_FREQ = 5                # its local-mesh and SDF-slice cadence
DP_REPLICAS = 2                # [dp]: replicas on the one card
DP_ITERS = 3
ROS_FRAMES = 5                 # [ros]: messages of [bag]'s bag


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
        scene_sdf=default_scene(half_extent=(40.0, 30.0,
                                             BAG_ROOM_HALF_HEIGHT_M)),
        poses=circle_trajectory(n_frames, radius=6.0,
                                revolutions=0.008 * n_frames,
                                ease_in_frames=4),
        dirs=lidar_directions(1800, 64), max_range=80.0)


def _frame(i):
    return make_sequence(N_FRAMES).frame(i)


def loop_config(Config):
    """bench_config with loop closure and PGO as run_kitti.yaml ships them
    (`pgo:` section, pgo_freq_frame 20). Two cuts: the scene's floor is
    kept (min_z = -7 m; the road of run_kitti.yaml's min_z_m = -3.5 lies
    1.73 m below KITTI's sensor), and loop candidates need 0.4 x
    local_map_radius (33 m) of travel instead of 4.0 x (328 m). The local
    set's static cap is sized to a lap's map (2^18 rows; bench.py's 2^16
    holds its 20 frames' ~50k points): a smaller cap would truncate the
    local map, which the tracker cannot survive."""
    cfg = bench_config(Config)
    cfg.pgo_on = True
    cfg.pgo_freq = 20
    cfg.min_z = -7.0
    cfg.min_loop_travel_dist_ratio = 0.4
    cfg.local_set_cap = 1 << 18
    return cfg


def make_loop_sequence(n_frames=LOOP_FRAMES, radius=6.0, revolutions=1.2,
                       yaw_follow=False):
    """1.2 laps of a 6 m circle in make_sequence's scene, ~1.09 m per frame
    (KITTI at 39 km/h), so the frames after ~35 revisit the start. The
    sensor keeps its heading: a heading that follows so tight a circle
    turns 10.4 deg a frame, which the tracker does not follow (it loses
    track in the first frames, with a 4- or a 10-frame ease-in)."""
    from pin_slam_tpu_torch.dataset.synthetic import (
        SyntheticSequence, circle_trajectory, default_scene,
        lidar_directions)
    return SyntheticSequence(
        scene_sdf=default_scene(half_extent=(40.0, 30.0,
                                             BAG_ROOM_HALF_HEIGHT_M)),
        poses=circle_trajectory(n_frames, radius=radius,
                                revolutions=revolutions, ease_in_frames=4,
                                yaw_follow=yaw_follow),
        dirs=lidar_directions(1800, 64), max_range=80.0)


def _loop_frame(args):
    i, traj = args
    return make_loop_sequence(**traj).frame(i)


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


def knn_cases(frames, poses, dev):
    """The k-NN walk's prepared inputs at the two main-path shapes: a local
    set of the first four frames' points (voxel 0.4 m), queries drawn near
    them. Returns [(shape, n_queries, (qs, lp, tab, bbd, perm, k, md2))]."""
    import torch
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.ops.voxel import voxel_down_sample_hash_mask
    from pin_slam_tpu_torch.slam.map_query import make_query_params

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
        out.append((name, nq, (qs, lp, tab, bbd, perm, k, md2f)))
    return out


def chunk_reachable(qs, lp, tiles, ltiles, md2):
    """The k-NN kernel's chunk test, in plain torch: for visited pairs
    (query tile `tiles[i]`, local tile `ltiles[i]`), whether some query of
    each warp (32 consecutive queries) can reach the bounding box of each
    32-point chunk of the local tile. The gap is rounded as the kernel
    rounds it (fma(gz, gz, fma(gx, gx, gy * gy))), so an unreachable chunk
    holds no point in radius of the warp. Returns bool [P, TQ/32, TL/32]."""
    import torch
    from pin_slam_tpu_torch.ops import knn_join as kj

    nc = kj.TL // 32
    chunks = lp.reshape(-1, nc, 32, 3)[ltiles]              # [P, nc, 32, 3]
    lo = chunks.amin(2)[:, None, None]                      # [P, 1, 1, nc, 3]
    hi = chunks.amax(2)[:, None, None]
    q = qs.reshape(-1, kj.TQ // 32, 32, 1, 3)[tiles]        # [P, w, 32, 1, 3]
    gap = torch.clamp(torch.maximum(lo - q, q - hi), min=0.0)
    gx, gy, gz = gap.unbind(-1)
    gap2 = kj._fma(gz, gz, kj._fma(gx, gx, gy * gy))        # [P, w, 32, nc]
    return (gap2 <= md2).any(2)


def knn_needed_work(qs, lp, tab, visits, md2, batch=256):
    """What the k-NN walk must compute on this run's data: for each visited
    (query tile, local tile) pair, the (warp, chunk) pairs that the chunk
    test lets through. Returns (reachable (warp, chunk) pairs per query
    tile, (warp, chunk) pairs tested, distinct chunks visited)."""
    import torch
    from pin_slam_tpu_torch.ops import knn_join as kj

    nt, row_cap = tab.shape
    steps = torch.arange(row_cap, device=tab.device)
    tiles, rows = torch.nonzero(steps[None] < visits[:, None].long(),
                                as_tuple=True)
    ltiles = tab[tiles, rows].long()
    reach = torch.zeros(nt, dtype=torch.int64, device=tab.device)
    for s in range(0, len(tiles), batch):
        ok = chunk_reachable(qs, lp, tiles[s:s + batch],
                             ltiles[s:s + batch], md2)
        reach.index_add_(0, tiles[s:s + batch], ok.sum((1, 2)))
    nc = kj.TL // 32
    tested = len(tiles) * (kj.TQ // 32) * nc
    return reach, tested, int(torch.unique(ltiles).numel()) * nc


def visit_histogram(visits):
    """Query tiles by the number of local tiles they walked."""
    v = visits.cpu().numpy()
    bins = ((0, 0), (1, 4), (5, 8), (9, 16), (17, 32))
    return {f"{a}-{b}" if a != b else str(a): int(((v >= a) & (v <= b)).sum())
            for a, b in bins}


def measure_knn(name, nq, args):
    """The k-NN kernel against its plain version on prepared inputs: idx,
    d2, cnt and visits must be equal. Returns the shape's numbers (kernel,
    plain and bound ms)."""
    import torch
    from pin_slam_tpu_torch.ops import knn_join as kj

    qs, lp, tab, bbd, perm, k, md2f = args
    got = kj._knn_walk_cuda(*args)
    ref = kj._knn_walk_plain(*args)
    torch.cuda.synchronize()
    for nm, a, b in zip(("idx", "d2", "cnt", "visits"), got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"knn_join {name}: kernel {nm} differs "
                                 "from the plain version")
    max_err = float((got[1] - ref[1]).abs().max())
    visits = int(got[3].sum())
    max_visits = int(got[3].max())
    hist = visit_histogram(got[3])
    ms = cuda_time_ms(lambda: kj._knn_walk_cuda(*args), 50)
    plain_ms = cuda_time_ms(lambda: kj._knn_walk_plain(*args), 3)
    nbytes = (qs.numel() * 4 + lp.numel() * 4 + tab.numel() * 4
              + bbd.numel() * 4 + perm.numel() * 8       # inputs
              + qs.shape[0] * (k * 8 + 4) + tab.shape[0] * 4)  # outputs
    # the operations this data needs: the distances of the reachable
    # (warp, chunk) pairs, the chunk tests and the chunks' boxes
    reach, tested, boxes = knn_needed_work(qs, lp, tab, got[3], md2f)
    pairs = int(reach.sum()) * 32 * 32
    flops = (pairs * FLOP_PER_PAIR + tested * 32 * CHUNK_TEST_FLOP
             + boxes * CHUNK_BOX_FLOP)
    longest = int(reach.max()) * 32 * 32
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    by = "operations" if t_ops > t_bytes else "bytes"
    log(f"[kernels] knn_join {name}: N={nq} (padded {qs.shape[0]}) k={k} "
        f"L={lp.shape[0]} query tiles={tab.shape[0]}, tile pairs visited="
        f"{visits}, longest row {max_visits} tiles, query tiles by "
        f"tiles walked {hist}; reachable (warp, chunk) pairs "
        f"{int(reach.sum())} of {tested} tested = {pairs} distances, "
        f"the longest row's {longest}; idx/d2/cnt/visits equal, max "
        f"|d2 err|={max_err} | kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound:.5f} ms ({by}: "
        f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB), library n/a")
    return dict(shape=name, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, max_abs_err=max_err, n=nq, k=k,
                visits=visits, max_visits=max_visits,
                visit_histogram=hist, distances=pairs,
                longest_row_distances=longest)


def phase_kernels(frames, poses, dev):
    """The k-NN kernel against its plain version at the main-path shapes:
    idx, d2, cnt and visits must be equal."""
    return [measure_knn(name, nq, args)
            for name, nq, args in knn_cases(frames, poses, dev)]


def decode_cases(dev):
    """The fused decode's inputs at the mesher's batch shape and at a ragged
    one. Returns [(shape, n, k, d, h, args)], args ending in sdf_scale."""
    import torch

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
        out.append((name, n, k, d, h, (*args, 0.044)))
    return out


def phase_fused_decode(dev):
    """The fused decode kernel against its plain version at the mesher's
    batch shape and at a ragged one."""
    import torch
    from pin_slam_tpu_torch.ops import fused_decode as fd

    out = []
    for name, n, k, d, h, args in decode_cases(dev):
        got = fd.decode_weighted_sdf(*args)
        ref = fd.decode_weighted_sdf_reference(*args)
        torch.cuda.synchronize()
        max_err = float((got - ref).abs().max())
        if not (got.shape == (n,) and bool(torch.isfinite(got).all())
                and max_err <= FUSED_ATOL):
            raise AssertionError(
                f"fused_decode {name}: kernel differs from the plain version "
                f"by {max_err} (> {FUSED_ATOL})")
        ms = cuda_time_ms(lambda: fd.decode_weighted_sdf(*args), 50)
        plain_ms = cuda_time_ms(
            lambda: fd.decode_weighted_sdf_reference(*args), 10)
        # per row: first product 2*d*h, ReLU h, second product 2*h, then
        # bias, scale, weight and the k-sum (4)
        flops = n * k * (2 * d * h + 3 * h + 4)
        nbytes = sum(a.numel() for a in args[:-1]) * 4 + n * 4
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


def run_frames(system, frames, poses, tag, loop_mgr=None, on_frame=None,
               frame_s=None, labels=None):
    """Drives process_frame over the frames, each frame's successor passed
    as next_points as bench.py does, and `loop_mgr.after_frame` as the loop
    hook when given; `labels` (per-frame point labels) go in as sem_labels
    and next_sem_labels. `on_frame(fid)` runs after each frame; each
    frame's host seconds go to the list `frame_s` when given. Returns the
    estimated poses and the steady-state seconds per frame (wall clock from
    the end of the warm-up to the end of the last frame, closed by a device
    sync)."""
    import torch
    est, lost = [], []
    t_steady = None
    for fid in range(len(frames)):
        t0 = time.time()
        hook = None
        if loop_mgr is not None:
            hook = (lambda f, _p=frames[fid]: loop_mgr.after_frame(f, _p))
        last = fid + 1 == len(frames)
        kw = {} if labels is None else dict(
            sem_labels=labels[fid],
            next_sem_labels=None if last else labels[fid + 1])
        est.append(system.process_frame(
            fid, frames[fid], loop_hook=hook,
            next_points=None if last else frames[fid + 1], **kw))
        dt = time.time() - t0
        if frame_s is not None:
            frame_s.append(dt)
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
        if on_frame is not None:
            on_frame(fid)
    torch.cuda.synchronize()
    steady_s = (time.time() - t_steady) / (len(frames) - WARMUP)
    est = np.stack(est)
    if not np.isfinite(est).all():
        raise AssertionError(f"{tag}: non-finite pose")
    if lost:
        raise AssertionError(f"{tag}: the tracker lost track in frames "
                             f"{lost}")
    return est, steady_s


def check_drift(err, bound=MAX_DRIFT_M):
    if err.max() > bound:
        raise AssertionError(f"pose error {err.max():.3f} m is past the "
                             f"drift bound {bound} m")


def phase_slice(frames, poses, dev):
    """The main path on a default PinSLAMSystem: launches, fps, ATE, and
    the medians of its `timings` columns, the host time of each stage span
    (`utils/tracing.py`), with no sync added."""
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

    stages = np.median(np.asarray(system.timings)[WARMUP:], 0) * 1e3
    labels = ["preprocess", "odometry", "pgo", "map-prep", "map-opt"]
    log("[slice] host stage medians: " + " ".join(
        f"{l}={v:.1f}ms" for l, v in zip(labels, stages)))
    return launches, dict(fps=1 / steady_s, ms=steady_s * 1e3, ate_m=ate,
                          stages=stages, system=system)


def phase_mesh(frames, poses, scene_sdf, dev):
    """Track+map with weighted_first=False, then mesh the map through the
    fused decode kernel. Returns both kernels' launch counts on this path,
    the system and its mesher."""
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
    return knn_launches, fd_launches, system, mesher


def quat_to_rotmat(q):
    """[N, 4] (w, x, y, z) float64 -> [N, 3, 3]."""
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(-1, 3, 3)


def edge_gap_m(T_a, T_b):
    """Translation of T_a^-1 T_b, m."""
    return float(np.linalg.norm((np.linalg.inv(T_a) @ T_b)[:3, 3]))


def check_closure(rec, use_mid_ts):
    """One closure's consequences against a plain float64 evaluation on
    the host: the per-frame corrections are the solve's new poses times the
    inverse of the poses before it; each live map point and each sampled
    pool row moved by the correction of its own (mid-)timestamp, clipped to
    T-1; each live point's rotation is that correction's rotation times its
    old one. Also how far the solve moved the closure frame onto the
    registered edge."""
    def host(t):
        return t.cpu().numpy().astype(np.float64)

    b, a = rec["before"], rec["after"]
    D = host(rec["diffs"])
    T = D.shape[0]
    n = int(b["count"])
    tsc = b["tsc"][:n].cpu().numpy().astype(np.int64)
    ts = (tsc + b["tsu"][:n].cpu().numpy()) // 2 if use_mid_ts else tsc
    ts = np.clip(ts, 0, T - 1)
    p0 = host(b["pos"][:n])
    want = np.einsum("nij,nj->ni", D[ts, :3, :3], p0) + D[ts, :3, 3]
    p1 = host(a["pos"][:n])
    rot_want = D[ts, :3, :3] @ quat_to_rotmat(host(b["quat"][:n]))
    rot_got = quat_to_rotmat(host(a["quat"][:n]))
    live = b["prow"].cpu().numpy() < int(b["pcount"])
    pts = np.clip(b["pts"].cpu().numpy().astype(np.int64)[live], 0, T - 1)
    q0 = host(b["pcoord"])[live]
    pool_want = np.einsum("nij,nj->ni", D[pts, :3, :3], q0) + D[pts, :3, 3]
    d, pg = rec["diag"], rec["pgo"]
    n_f = d["frame"] + 1
    return dict(
        correction_err=float(np.abs(
            D[:n_f] - pg[:n_f] @ np.linalg.inv(rec["old"][:n_f])).max()),
        map_rows=n, moved_rows=int((np.linalg.norm(p1 - p0, axis=1)
                                    > 1e-3).sum()),
        map_err=float(np.abs(p1 - want).max()),
        rot_err=float(np.abs(rot_got - rot_want).max()),
        pool_rows=int(live.sum()),
        pool_err=float(np.abs(host(a["pcoord"])[live] - pool_want).max()),
        gap_before=edge_gap_m(d["T_edge"], d["T_chain"]),
        gap_after=edge_gap_m(d["T_edge"], np.linalg.inv(pg[d["loop"]])
                             @ pg[d["frame"]]))


def record_closures(loop_mgr, dev):
    """Wraps the loop manager's consequences step so that each closure keeps
    what it read and wrote (device copies, no sync) for check_closure after
    the run. Returns the list the records go to."""
    import torch
    system, apply, records = loop_mgr.system, loop_mgr._apply_deformation, []
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def apply_and_keep(diffs, rehash_ts):
        s, p = system.state, system.pool
        prow = torch.randint(0, p.capacity, (POOL_SAMPLE,), device=dev,
                             generator=gen)
        before = dict(count=s.count.clone(), pos=s.positions.clone(),
                      quat=s.orientations.clone(), tsc=s.ts_create.clone(),
                      tsu=s.ts_update.clone(), pcount=p.count.clone(),
                      prow=prow, pcoord=p.coord[prow], pts=p.ts[prow])
        apply(diffs, rehash_ts)
        records.append(dict(
            diag=loop_mgr.pgm.loop_diags[-1], old=np.array(system.pgo_poses),
            pgo=np.array(loop_mgr.pgm.pgo_poses), diffs=diffs.clone(),
            before=before, after=dict(
                pos=system.state.positions.clone(),
                quat=system.state.orientations.clone(),
                pcoord=system.pool.coord[prow])))

    loop_mgr._apply_deformation = apply_and_keep
    return records


def phase_loop(frames, poses, dev):
    """Loop closure and PGO on the bench.py workload (run_kitti.yaml's pgo
    path): a PinSLAMSystem driven through process_frame with the loop
    manager's after_frame as its loop hook. Returns the k-NN launches and
    the phase's figures."""
    import torch
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.models import neural_points as npm
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.ops.transforms import transform_points_by_ts
    from pin_slam_tpu_torch.slam.loop import LoopPgoManager
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem
    from pin_slam_tpu_torch.utils.eval_traj import absolute_error

    cfg = loop_config(Config)
    system = PinSLAMSystem(cfg, device=dev)
    system.set_gt_poses(poses)
    loop_mgr = LoopPgoManager(cfg, system)
    records = record_closures(loop_mgr, dev)
    pending = []
    torch.cuda.reset_peak_memory_stats()
    kj.LAUNCHES = 0
    _, steady_s = run_frames(
        system, frames, poses, "loop", loop_mgr=loop_mgr,
        on_frame=lambda f: pending.append(system.post_loop_iter_boost_pending))
    launches = kj.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = len(frames)

    diags = loop_mgr.pgm.loop_diags
    checks = [check_closure(r, cfg.use_mid_ts) for r in records]
    for d, r, c in zip(diags, records, checks):
        f, lid = d["frame"], d["loop"]
        T_true = np.linalg.inv(poses[lid]) @ poses[f]
        log(f"[loop] closure at frame {f} to frame {lid} ({d['kind']}): "
            f"registration residual {d['residual_cm']:.3f} cm, refine moved "
            f"{d['refine_moved_m']:.4f} m, PGO correction at the current "
            f"frame {d['pgo_correction_m']:.4f} m; closure frame off the "
            f"registered edge {c['gap_before'] * 100:.3f} cm before the "
            f"solve, {c['gap_after'] * 100:.3f} cm after; against ground "
            f"truth: loop edge {edge_gap_m(T_true, d['T_edge']) * 100:.2f} "
            f"cm, chain edge {edge_gap_m(T_true, d['T_chain']) * 100:.2f} "
            f"cm, closure frame odometry "
            f"{np.linalg.norm(system.odom_poses[f][:3, 3] - poses[f][:3, 3]) * 100:.2f}"
            f" cm, PGO "
            f"{np.linalg.norm(r['pgo'][f][:3, 3] - poses[f][:3, 3]) * 100:.2f}"
            f" cm")
        log(f"[loop] its consequences against the plain evaluation: "
            f"corrections max |err| {c['correction_err']:.3g}, map "
            f"positions max |err| {c['map_err']:.3g} m over {c['map_rows']} "
            f"live rows ({c['moved_rows']} moved > 1 mm), rotations max "
            f"|err| {c['rot_err']:.3g}, pool max |err| {c['pool_err']:.3g} m "
            f"over {c['pool_rows']} sampled rows")
    if loop_mgr.pgo_count < 1:
        raise AssertionError("[loop] no loop closure was accepted")
    for c in checks:
        if c["gap_after"] > LOOP_EDGE_PULL * c["gap_before"]:
            raise AssertionError(
                f"[loop] the solve left the closure frame "
                f"{c['gap_after']:.4f} m off the registered edge, from "
                f"{c['gap_before']:.4f} m")
        if c["correction_err"] > CORRECTION_ATOL \
                or c["map_err"] > DEFORM_ATOL_M or c["pool_err"] > DEFORM_ATOL_M \
                or c["rot_err"] > DEFORM_ROT_ATOL or c["moved_rows"] == 0:
            raise AssertionError(f"[loop] the deformation is not the "
                                 f"correction of each row's timestamp: {c}")
    first = diags[0]["frame"]
    if first + 1 >= n or not (pending[first] == cfg.post_loop_iter_boost
                              and pending[first + 1] == 0):
        raise AssertionError(
            f"[loop] the training boost of the closure at frame {first} was "
            f"not consumed by the next frame (pending after each frame: "
            f"{pending[first:first + 2]})")
    cnt = int(system.state.count)
    if not bool((system.state.orientations[:cnt, 1:] != 0).any()):
        raise AssertionError("[loop] the map carries no deformation")

    pgo = system.pgo_poses[:n]
    odom = system.odom_poses[:n]
    if not np.isfinite(pgo).all():
        raise AssertionError("[loop] non-finite PGO pose")
    ate_odom, _ = absolute_error(poses[:n], odom, align_on=False)
    ate_pgo, _ = absolute_error(poses[:n], pgo, align_on=False)
    err = np.linalg.norm(pgo[:, :3, 3] - poses[:n, :3, 3], axis=1)
    stage = np.asarray(system.timings)[:, 2] * 1e3
    closing = np.isin(np.arange(n), [d["frame"] for d in diags])
    log(f"[loop] steady state: {steady_s * 1e3:.1f} ms/frame = "
        f"{1 / steady_s:.3f} fps over {n - WARMUP} frames; ATE (RMSE, no "
        f"alignment) of the odometry chain {ate_odom * 100:.2f} cm, of the "
        f"PGO poses {ate_pgo * 100:.2f} cm, max PGO pose error "
        f"{err.max() * 100:.2f} cm; PGO stage median "
        f"{np.median(stage[closing]):.1f} ms over {int(closing.sum())} "
        f"closure frames, {np.median(stage[~closing]):.2f} ms over the "
        f"others; knn_join launches {launches} ({launches / n:.1f} per "
        f"frame); {cnt} map points; peak device memory {peak:.2f} GiB")
    slack = min(LOOP_ATE_SLACK_M, LOOP_ATE_SLACK_OF_CORRECTION
                * max(d["pgo_correction_m"] for d in diags))
    if ate_pgo > ate_odom + slack:
        raise AssertionError(
            f"[loop] PGO made the trajectory worse: ATE {ate_pgo:.4f} m > "
            f"{ate_odom:.4f} m + {slack:.4f} m")
    check_drift(err)
    if launches <= 0:
        raise AssertionError("the loop path never launched the knn_join "
                             "kernel")

    # one closure's consequences, timed on the device at the run's sizes
    diffs = torch.as_tensor(
        loop_mgr.pgm.get_pose_diff().astype(np.float32), device=dev)
    state, pool = system.state, system.pool
    deform_ms = cuda_time_ms(lambda: npm.deform_map(
        state, diffs, use_mid_ts=cfg.use_mid_ts), 5)
    rehash_ms = cuda_time_ms(lambda: npm.rehash(
        state, n - 1, resolution=cfg.voxel_size_m,
        use_mid_ts=cfg.use_mid_ts), 5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pool_ms = cuda_time_ms(lambda: transform_points_by_ts(
        pool.coord, pool.ts, diffs), 5)
    pool_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    log(f"[loop] one closure's consequences on the device: deform "
        f"{deform_ms:.3f} ms ({state.capacity} map rows), rehash "
        f"{rehash_ms:.3f} ms, replay-pool transform {pool_ms:.3f} ms "
        f"({pool.capacity} rows, {int(pool.count)} written; peak "
        f"{pool_peak:.1f} MiB above the resident state)")
    return launches, dict(fps=1 / steady_s, ate_odom_m=ate_odom,
                          ate_pgo_m=ate_pgo, closures=len(diags),
                          deform_ms=deform_ms, rehash_ms=rehash_ms,
                          pool_ms=pool_ms)


def ncd_config(Config):
    """config/lidar_slam/run_ncd_128_s.yaml as shipped."""
    return Config().load(os.path.join(ROOT, "config", "lidar_slam",
                                      "run_ncd_128_s.yaml"))


def make_ncd_sequence(n_frames=BA_FRAMES):
    """An NCD-128-like hand-held walk: an Ouster OS0-128 (1024 x 128 rays
    over +-45 deg, 50 m of range) carried at NCD_STEP_M a frame round the
    island of make_sequence's room on a circle of NCD_RADIUS_M, the heading
    following it (1.34 deg a frame), after a 4-frame ease-in. The room's
    walls lie 24-46 m out, beyond the configuration's 15 m range; the floor
    and ceiling 6 m below and above, the island and the pillar ring hold
    the pose."""
    from pin_slam_tpu_torch.dataset.synthetic import (
        SyntheticSequence, circle_trajectory, default_scene,
        lidar_directions)
    ramp = np.linspace(0.0, 1.0, 5)[1:]
    vel = np.ones(n_frames)
    vel[:4] = ramp * ramp * (3 - 2 * ramp)
    arc = NCD_STEP_M * vel[:-1].sum()
    return SyntheticSequence(
        scene_sdf=default_scene(half_extent=(40.0, 30.0,
                                             BAG_ROOM_HALF_HEIGHT_M)),
        poses=circle_trajectory(n_frames, radius=NCD_RADIUS_M,
                                revolutions=arc / (2 * np.pi * NCD_RADIUS_M),
                                ease_in_frames=4),
        dirs=lidar_directions(1024, 128, el_range=(-45.0, 45.0)),
        max_range=50.0)


def _ncd_frame(i):
    return make_ncd_sequence().frame(i)


# the ouster_ros package's point layout: (name, offset, PointField datatype)
OUSTER_FIELDS = (("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("intensity", 16, 7),
                 ("t", 20, 6), ("reflectivity", 24, 4), ("ring", 26, 4),
                 ("ambient", 28, 4), ("range", 32, 6))
OUSTER_POINT_STEP = 48


def ouster_cloud(xyz, t_ns):
    """An organised H x W sensor_msgs/PointCloud2 in the ouster_ros
    package's layout (OUSTER_FIELDS, point_step 48): xyz [H, W, 3] float32,
    (0, 0, 0) where a ray has no return; t_ns [W] uint32, each column's
    time from the scan's start; range in mm, ring the row, intensity,
    reflectivity and ambient made from the range."""
    from pin_slam_tpu_torch.utils import point_cloud2 as pc2
    h, w = xyz.shape[:2]
    fields = [pc2._Field(n, o, d) for n, o, d in OUSTER_FIELDS]
    arr = np.zeros((h, w), pc2.fields_to_dtype(fields, OUSTER_POINT_STEP))
    for i, c in enumerate("xyz"):
        arr[c] = xyz[..., i]
    mm = np.round(np.linalg.norm(xyz.astype(np.float64), axis=-1) * 1e3)
    arr["range"] = mm
    arr["t"] = np.broadcast_to(np.asarray(t_ns, np.uint32), (h, w))
    arr["ring"] = np.arange(h)[:, None]
    arr["intensity"] = (mm % 1000.0).astype(np.float32)
    arr["reflectivity"] = mm % 255
    arr["ambient"] = mm % 4096
    msg = pc2.SimplePointCloud2.__new__(pc2.SimplePointCloud2)
    msg.fields, msg.height, msg.width = fields, h, w
    msg.is_bigendian = False
    msg.point_step, msg.row_step = OUSTER_POINT_STEP, OUSTER_POINT_STEP * w
    msg.data = arr.tobytes()
    return msg


def mos_config(Config):
    """config/lidar_slam/run_kitti_mos.yaml with the visibility test on as
    eval/eval_gauntlet_long.py --dynamic sets it, and two cuts: the floor
    kept (min_z -7 m, as `[loop]`) and a local set sized as `[loop]` sizes
    it."""
    cfg = Config().load(os.path.join(ROOT, "config", "lidar_slam",
                                     "run_kitti_mos.yaml"))
    cfg.visibility_filter_on = True
    cfg.visibility_hist_offsets = (10, 30, 60)
    cfg.min_z = -7.0
    cfg.local_set_cap = 1 << 18
    return cfg


def make_mos_sequence(n_frames=DYN_FRAMES):
    """make_sequence's HDL-64 frames on its circle in its room, plus three
    spheres of MOVER_RADIUS_M crossing the room at 0.15 m a frame. Returns
    the sequence and the movers' centres [T, 3, 3]."""
    from pin_slam_tpu_torch.dataset.synthetic import (
        SyntheticSequence, circle_trajectory, default_scene,
        lidar_directions, moving_spheres_scene)
    static = default_scene(half_extent=(40.0, 30.0, 6.0))
    scene_t, centers = moving_spheres_scene(static, n_frames,
                                            radius=MOVER_RADIUS_M)
    seq = SyntheticSequence(
        scene_sdf=static, scene_sdf_t=scene_t,
        poses=circle_trajectory(n_frames, radius=6.0,
                                revolutions=0.008 * n_frames,
                                ease_in_frames=4),
        dirs=lidar_directions(1800, 64), max_range=80.0)
    return seq, centers


def _mos_frame(i):
    return make_mos_sequence()[0].frame(i)


def rot_deg(R):
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2,
                                              -1.0, 1.0))))


def _clone_fields(obj):
    """A copy of a state dataclass; fields it does not hold stay None."""
    import dataclasses
    return obj.replace(**{
        f.name: None if getattr(obj, f.name) is None
        else getattr(obj, f.name).clone() for f in dataclasses.fields(obj)})


def record_ba(system, dev):
    """Wraps slam/ba.make_ba_loop so that each BA run keeps its inputs'
    pose chain, a sample of POOL_SAMPLE pool rows, its outputs and its
    device time. The first run also keeps a copy of everything it read, so
    that it can be run again after the frames (`repeat_first_ba`). Returns
    the list the records go to."""
    import torch
    from pin_slam_tpu_torch.slam import ba

    make, records = ba.make_ba_loop, []
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def make_and_keep(qp, **kw):
        run = make(qp, **kw)

        def run_and_keep(state, pool, feats, mlp, base, first_opt,
                         generator, lf, draws=None, info=None):
            n = base.shape[0]
            prow = torch.randint(0, pool.capacity, (POOL_SAMPLE,),
                                 device=dev, generator=gen)
            before = dict(chain=system.pgo_poses[:n].copy(),
                          pcount=int(pool.count), prow=prow,
                          pcoord=pool.coord[prow].clone(),
                          pts=pool.ts[prow].clone())
            _, scount = ba.collect_surface_samples(pool,
                                                   ba.SURFACE_SAMPLE_CAP)
            draws = ba.draw_ba_indices(generator, scount,
                                       n_iters=kw["n_iters"], bs=kw["bs"])
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = run(state, pool, feats, mlp, base, first_opt, generator,
                      lf, draws=draws, info=info)
            e1.record()
            torch.cuda.synchronize()
            # copies: the system trains the returned features in place
            rec = dict(frame=n - 1, window=n - first_opt, before=before,
                       out=tuple(t.clone() for t in out),
                       ms=e0.elapsed_time(e1),
                       samples=int(scount))
            if not records:
                rec["replay"] = (run, (
                    _clone_fields(state), _clone_fields(pool), feats.clone(),
                    mlp, base.clone(), first_opt, None, lf), draws)
            records.append(rec)
            return out

        return run_and_keep

    ba.make_ba_loop = make_and_keep
    return records


def repeat_first_ba(records):
    """The first BA again, from the copy of its inputs and with its draws:
    True when every output has the same bits."""
    import torch
    run, args, draws = records[0].pop("replay")
    again = run(*args, draws=draws)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(records[0]["out"], again))


def check_ba(rec, system):
    """Right after a BA frame: the chain is BA's output and the sampled
    pool rows moved by the correction of their timestamp (float64 host
    evaluation). Returns the figures."""
    b = rec["before"]
    n = b["chain"].shape[0]
    poses = rec["out"][0].cpu().numpy().astype(np.float64)
    D = np.stack([poses[i] @ np.linalg.inv(b["chain"][i]) for i in range(n)])
    live = b["prow"].cpu().numpy() < b["pcount"]
    ts = np.clip(b["pts"].cpu().numpy().astype(np.int64)[live], 0, n - 1)
    q0 = b["pcoord"].cpu().numpy().astype(np.float64)[live]
    want = np.einsum("nij,nj->ni", D[ts, :3, :3], q0) + D[ts, :3, 3]
    got = system.pool.coord[b["prow"]].cpu().numpy().astype(np.float64)[live]
    return dict(
        chain_equal=bool(np.array_equal(system.pgo_poses[:n], poses)
                         and np.array_equal(system.cur_pose_ref, poses[-1])),
        pool_rows=int(live.sum()), pool_err=float(np.abs(got - want).max()),
        max_move_m=float(np.linalg.norm(D[:, :3, 3], axis=1).max()),
        max_turn_deg=max(rot_deg(d[:3, :3]) for d in D))


def phase_ba(frames, poses, dev):
    """run_ncd_128_s.yaml through process_frame with the loop manager's
    hook: sliding-window bundle adjustment every 20 frames. Returns the k-NN
    launches and the figures."""
    import torch
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.slam import ba
    from pin_slam_tpu_torch.slam.loop import LoopPgoManager
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem
    from pin_slam_tpu_torch.utils.eval_traj import absolute_error

    cfg = ncd_config(Config)
    n = len(frames)
    due = [f for f in range(n) if (f + 1) % cfg.ba_freq_frame == 0]
    system = PinSLAMSystem(cfg, device=dev)
    system.set_gt_poses(poses)
    loop_mgr = LoopPgoManager(cfg, system)
    make_ba_loop = ba.make_ba_loop
    records = record_ba(system, dev)
    checks, frame_s = [], []

    def after(fid):
        if len(records) > len(checks):
            checks.append(check_ba(records[-1], system))

    torch.cuda.reset_peak_memory_stats()
    kj.LAUNCHES = 0
    try:
        est, steady_s = run_frames(system, frames, poses, "ba",
                                   loop_mgr=loop_mgr, on_frame=after,
                                   frame_s=frame_s)
    finally:
        ba.make_ba_loop = make_ba_loop
    launches = kj.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ba_at = [r["frame"] for r in records]
    repeated = bool(records) and repeat_first_ba(records)
    for r, c in zip(records, checks):
        f, losses = r["frame"], r["out"][2].cpu().numpy()
        m = f + 1
        ate0, _ = absolute_error(poses[:m], r["before"]["chain"],
                                 align_on=False)
        ate1, _ = absolute_error(
            poses[:m], r["out"][0].cpu().numpy().astype(np.float64),
            align_on=False)
        r.update(ate_before=ate0, ate_after=ate1, first=float(losses[0]),
                 last=float(losses[-1]))
        log(f"[ba] BA at frame {f}: window {r['window']} frames, "
            f"{r['samples']} surface samples, {len(losses)} iterations in "
            f"{r['ms']:.1f} ms on the device; loss {losses[0]:.6f} -> "
            f"{losses[-1]:.6f} (every 10th: "
            + " ".join(f"{v:.6f}" for v in losses[::10]) + "); largest pose "
            f"change {c['max_move_m'] * 100:.3f} cm, {c['max_turn_deg']:.4f} "
            f"deg; ATE over its frames {ate0 * 100:.3f} -> "
            f"{ate1 * 100:.3f} cm; chain = BA's output: {c['chain_equal']}; "
            f"pool rows against the float64 evaluation: max |err| "
            f"{c['pool_err']:.3g} m over {c['pool_rows']} sampled rows")
    ba_ms = [frame_s[f] * 1e3 for f in ba_at]
    other = [t * 1e3 for f, t in enumerate(frame_s)
             if f not in ba_at and f >= WARMUP]
    err = np.linalg.norm(est[:, :3, 3] - poses[:n, :3, 3], axis=1)
    ate, _ = absolute_error(poses[:n], system.pgo_poses[:n], align_on=False)
    log(f"[ba] {n} frames, {frames[0].shape[0]} points in frame 0: "
        f"ms/frame on BA frames " + ", ".join(f"{v:.1f}" for v in ba_ms)
        + f", median of the other steady frames {np.median(other):.1f} "
        f"(steady state with BA {steady_s * 1e3:.1f} ms/frame); ATE (RMSE, "
        f"no alignment) {ate * 100:.2f} cm, max {err.max() * 100:.2f} cm; "
        f"first BA repeated bit for bit: {repeated}; "
        f"knn_join launches {launches}; point-cap overflow frames "
        f"{system.cap_overflow_frames} (max ratio "
        f"{system.cap_overflow_max_ratio:.2f}); {int(system.state.count)} "
        f"map points; peak device memory {peak:.2f} GiB")
    if ba_at != due:
        raise AssertionError(f"[ba] BA ran on frames {ba_at}, not {due}")
    for r, c in zip(records, checks):
        if not (np.isfinite(r["last"]) and r["last"] < r["first"]):
            raise AssertionError(f"[ba] BA at frame {r['frame']} did not "
                                 f"lower its loss: {r['first']} -> "
                                 f"{r['last']}")
        if not c["chain_equal"]:
            raise AssertionError(f"[ba] the chain after BA at frame "
                                 f"{r['frame']} is not BA's output")
        if c["pool_err"] > BA_POOL_ATOL_M or c["pool_rows"] == 0:
            raise AssertionError(f"[ba] the pool rows did not move by their "
                                 f"timestamp's correction: {c}")
    if not repeated:
        raise AssertionError("[ba] BA from the same state and draws gave "
                             "other bits")
    check_drift(err, 0.09 * n)
    if launches <= 0:
        raise AssertionError("the BA path never launched the knn_join "
                             "kernel")
    return launches, dict(ba_ms=[r["ms"] for r in records],
                          frame_ms_ba=ba_ms, frame_ms_other=np.median(other),
                          ate_m=ate)


def mover_truth(train_pts, n, pose, centers):
    """Training points (sensor frame) within MOVER_RADIUS_M +
    MOVER_MARGIN_M of a mover's centre, on the true pose."""
    w = train_pts[:n] @ pose[:3, :3].T + pose[:3, 3]
    d = np.linalg.norm(w[:, None, :] - centers[None], axis=-1)
    return (d < MOVER_RADIUS_M + MOVER_MARGIN_M).any(1)


def phase_dynamic(frames, poses, centers, dev):
    """run_kitti_mos.yaml (visibility test on) through process_frame with
    the loop manager's hook, over a room with movers. Returns both kernels'
    launches on this path and the figures."""
    import torch
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.ops import fused_decode as fd
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.slam import map_query as mq
    from pin_slam_tpu_torch.slam.loop import LoopPgoManager
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem
    from pin_slam_tpu_torch.utils.eval_traj import absolute_error

    cfg = mos_config(Config)
    n = len(frames)
    system = PinSLAMSystem(cfg, device=dev)
    system.set_gt_poses(poses)
    loop_mgr = LoopPgoManager(cfg, system)
    real, judged, check = system.dynamic_filter, [], {}

    def filt(pts_world, mask, lf, hist_origins=None, fused=None):
        out = real(pts_world, mask, lf, hist_origins, fused)
        judged.append(system.cur_frame)
        if system.cur_frame == DYN_CHECK_FRAME:
            # both routes on this frame's inputs; these launches are the
            # comparison's, not the path's
            n0 = fd.LAUNCHES
            with torch.no_grad():
                a = mq.query_decode(system.params["geo_features"],
                                    system.params["geo_mlp"], pts_world,
                                    system.qp, state=system.state, lf=lf,
                                    fused=True)
                b = mq.query_decode(system.params["geo_features"],
                                    system.params["geo_mlp"], pts_world,
                                    system.qp, state=system.state, lf=lf)
            plain = real(pts_world, mask, lf, hist_origins, fused=False)
            v = cfg.voxel_size_m
            near = torch.zeros_like(mask)
            for t in (cfg.dynamic_sdf_ratio_thre * v, 1.5 * v, -1.5 * v):
                near |= (b.sdf - t).abs() <= FUSED_ATOL
            check.update(
                rows=int(mask.sum()),
                sdf_err=float((a.sdf - b.sdf)[mask].abs().max()),
                differ=int((out != plain).sum()),
                differ_off_threshold=int(((out != plain) & ~near).sum()),
                ms=cuda_time_ms(lambda: real(pts_world, mask, lf,
                                             hist_origins), 5),
                plain_ms=cuda_time_ms(lambda: real(
                    pts_world, mask, lf, hist_origins, fused=False), 5),
                decode_ms=cuda_time_ms(lambda: mq.query_decode(
                    system.params["geo_features"], system.params["geo_mlp"],
                    pts_world, system.qp, state=system.state, lf=lf,
                    fused=True), 5))
            fd.LAUNCHES = n0
        return out

    system.dynamic_filter = filt
    kept = []

    def after(fid):
        if system.last_static_mask is not None and judged \
                and judged[-1] == fid:
            kept.append((fid, system.last_static_mask.clone(),
                         system.last_train_pts.clone(),
                         system.last_train_n.clone()))

    torch.cuda.reset_peak_memory_stats()
    kj.LAUNCHES = 0
    fd.LAUNCHES = 0
    est, steady_s = run_frames(system, frames, poses, "dynamic",
                               loop_mgr=loop_mgr, on_frame=after)
    knn_launches, fd_launches = kj.LAUNCHES, fd.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    tot = dict(static=0, false=0, movers=0, caught=0, caught_late=0)
    for fid, sm, tp, tn in kept:
        m = int(tn)
        static = sm[:m].cpu().numpy()
        mover = mover_truth(tp.cpu().numpy(), m, poses[fid], centers[fid])
        flagged = ~static
        tp_, fp_ = int((flagged & mover).sum()), int((flagged & ~mover).sum())
        tot["static"] += int((~mover).sum())
        tot["false"] += fp_
        tot["movers"] += int(mover.sum())
        tot["caught"] += tp_
        if fid > 10:
            tot["caught_late"] += tp_
        prec = tp_ / max(tp_ + fp_, 1)
        rec = tp_ / max(int(mover.sum()), 1)
        log(f"[dynamic] frame {fid}: {m} points, {int(mover.sum())} on "
            f"movers, flagged {int(flagged.sum())}: precision {prec:.3f}, "
            f"recall {rec:.3f}, static flagged {fp_}")
    false_share = tot["false"] / max(tot["static"], 1)
    err = np.linalg.norm(est[:, :3, 3] - poses[:n, :3, 3], axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    ate_pgo, _ = absolute_error(poses[:n], system.pgo_poses[:n],
                                align_on=False)
    log(f"[dynamic] {len(kept)} frames judged; static measurements flagged "
        f"{tot['false']} of {tot['static']} = {false_share * 100:.3f} % "
        f"(bound {MAX_FALSE_DYNAMIC * 100:.1f} %); mover measurements "
        f"flagged {tot['caught']} of {tot['movers']} ({tot['caught_late']} "
        f"after frame 10); fused_decode launches {fd_launches}, knn_join "
        f"launches {knn_launches}")
    log(f"[dynamic] frame {DYN_CHECK_FRAME}'s filter ({check.get('rows')} "
        f"points): kernel SDF vs plain max |err| {check.get('sdf_err')}, "
        f"static masks differ on {check.get('differ')} rows "
        f"({check.get('differ_off_threshold')} off a threshold); filter on "
        f"the device {check.get('ms', float('nan')):.3f} ms through the "
        f"kernel, {check.get('plain_ms', float('nan')):.3f} ms through the "
        f"plain decode; probe + fused decode "
        f"{check.get('decode_ms', float('nan')):.3f} ms")
    log(f"[dynamic] steady state: {steady_s * 1e3:.1f} ms/frame = "
        f"{1 / steady_s:.3f} fps over {n - WARMUP} frames; ATE (RMSE, no "
        f"alignment) {ate * 100:.2f} cm (PGO poses {ate_pgo * 100:.2f} cm), "
        f"max {err.max() * 100:.2f} cm; {int(system.state.count)} map "
        f"points; point-cap overflow frames {system.cap_overflow_frames}; "
        f"peak device memory {peak:.2f} GiB")
    n_judged = len(kept)
    if n_judged != n - 1 or fd_launches != n_judged:
        raise AssertionError(
            f"[dynamic] {n_judged} frames judged, fused_decode launched "
            f"{fd_launches} times: one launch per judged frame expected")
    if not check or check["sdf_err"] > FUSED_ATOL \
            or check["differ_off_threshold"] > 0:
        raise AssertionError(f"[dynamic] the kernel route and the plain "
                             f"route disagree: {check}")
    if false_share > MAX_FALSE_DYNAMIC:
        raise AssertionError(f"[dynamic] {false_share * 100:.3f} % of the "
                             f"static measurements flagged dynamic")
    if tot["caught_late"] < 1:
        raise AssertionError("[dynamic] no mover measurement was flagged "
                             "after frame 10")
    check_drift(err, 0.09 * n)
    if knn_launches <= 0:
        raise AssertionError("the dynamic path never launched the knn_join "
                             "kernel")
    return knn_launches, fd_launches, dict(
        false_share=false_share, caught=tot["caught"], movers=tot["movers"],
        ms=steady_s * 1e3, ate_m=ate, filter=check)


def color_config(Config):
    """config/lidar_slam/run_kitti_color.yaml as shipped, the floor kept
    (min_z -7 m). Its 2^17-row local set holds the run's map (~90k
    points), so the set is not cut."""
    cfg = Config().load(os.path.join(ROOT, "config", "lidar_slam",
                                     "run_kitti_color.yaml"))
    cfg.min_z = -7.0
    return cfg


def make_color_sequence(n_frames=COLOR_FRAMES):
    """make_sequence's HDL-64 frames on its circle in its room, each point
    coloured by `procedural_color` ([N, 6]: x, y, z, r, g, b)."""
    from pin_slam_tpu_torch.dataset.synthetic import procedural_color
    seq = make_sequence(n_frames)
    seq.color_fn = procedural_color
    return seq


def _color_frame(i):
    return make_color_sequence().frame(i)


def sem_config(Config):
    """config/lidar_slam/run_demo_sem.yaml as shipped, the floor kept
    (min_z -7 m)."""
    cfg = Config().load(os.path.join(ROOT, "config", "lidar_slam",
                                     "run_demo_sem.yaml"))
    cfg.min_z = -7.0
    return cfg


def make_sem_sequence(n_frames=SEM_FRAMES):
    """make_sequence's HDL-64 frames on its circle in
    `default_scene_semantic`'s room (make_sequence's extent). Returns the
    sequence and the scene's label function (1: shell, 2: pillars, 3:
    spheres)."""
    from pin_slam_tpu_torch.dataset.synthetic import (
        SyntheticSequence, circle_trajectory, default_scene_semantic,
        lidar_directions)
    scene, label_fn = default_scene_semantic(half_extent=(40.0, 30.0, 6.0))
    seq = SyntheticSequence(
        scene_sdf=scene,
        poses=circle_trajectory(n_frames, radius=6.0,
                                revolutions=0.008 * n_frames,
                                ease_in_frames=4),
        dirs=lidar_directions(1800, 64), max_range=80.0)
    return seq, label_fn


def sem_frames_from(col_frames, poses, label_fn):
    """`[semantic]`'s frames from `[color]`'s: the two rooms have the same
    primitives, so the ray casts are the same; each point is labelled by
    the primitive it hit. Returns (frames [N, 3], labels [N])."""
    frames, labels = [], []
    for f, T in zip(col_frames, poses):
        pts = np.ascontiguousarray(f[:, :3])
        w = pts @ T[:3, :3].T + T[:3, 3]
        frames.append(pts)
        labels.append(label_fn(w.astype(np.float64)))
    return frames, labels


def gt_surface_points(frames, poses, n=SURFACE_PROBES):
    """n of the frames' ray-cast hits (exact surface points) in the world
    frame, drawn with seed 0."""
    world = np.concatenate([f[:, :3] @ p[:3, :3].T + p[:3, 3]
                            for f, p in zip(frames, poses)])
    sel = np.random.RandomState(0).permutation(len(world))[:n]
    return world[sel].astype(np.float32)


def decode_at(system, pts, **heads):
    """nn_count and the requested heads' outputs at the world points, in
    batches of 2^14 (as eval/eval_gauntlet.py scores)."""
    import torch
    from pin_slam_tpu_torch.slam import map_query as mq

    nn, outs = [], []
    with torch.no_grad():
        for b0 in range(0, len(pts), 1 << 14):
            q = torch.as_tensor(pts[b0: b0 + (1 << 14)], device=system.device)
            o = mq.query_decode(system.params["geo_features"],
                                system.params["geo_mlp"], q, system.qp,
                                state=system.state, **heads)
            nn.append(o.nn_count.cpu().numpy())
            outs.append((o.color if o.color is not None
                         else o.sem_log_prob.argmax(-1)).cpu().numpy())
    return np.concatenate(nn), np.concatenate(outs)


def path_mesher(system, cfg, **kw):
    """A Mesher built as `[mesh]` builds it (infer_bs_final, the
    configuration's mc_res_m, cluster filter off)."""
    from pin_slam_tpu_torch.slam.mesher import MeshConfig, Mesher
    return Mesher(system.qp, MeshConfig(
        mc_res_m=cfg.mc_res_m, pad_voxel=cfg.pad_voxel,
        skip_top_voxel=cfg.skip_top_voxel, mc_mask_on=cfg.mc_mask_on,
        mesh_min_nn=cfg.mesh_min_nn,
        min_cluster_vertices=cfg.min_cluster_vertices,
        infer_bs=cfg.infer_bs_final, chunk_m=cfg.mc_res_m * 200), **kw)


def phase_color(frames, poses, dev):
    """run_kitti_color.yaml through process_frame with the loop manager's
    hook: the uncached colour tracker (a k-NN probe every GN iteration),
    colour training, the colour of the map at ground-truth surface points,
    a colour mesh. Returns both kernels' launches on this path, the k-NN
    kernel at the colour tracker's shape, and the figures."""
    import torch
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.dataset.synthetic import procedural_color
    from pin_slam_tpu_torch.ops import fused_decode as fd
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.slam.loop import LoopPgoManager
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    cfg = color_config(Config)
    n = len(frames)
    system = PinSLAMSystem(cfg, device=dev)
    system.set_gt_poses(poses)
    if not system._use_color_track:
        raise AssertionError("[color] the colour tracker is off")
    loop_mgr = LoopPgoManager(cfg, system)
    iters, frame_s = [], []
    torch.cuda.reset_peak_memory_stats()
    kj.LAUNCHES = 0
    fd.LAUNCHES = 0
    est, steady_s = run_frames(
        system, frames, poses, "color", loop_mgr=loop_mgr, frame_s=frame_s,
        on_frame=lambda f: iters.append(system.last_track_iters))
    knn_launches, fd_frames = kj.LAUNCHES, fd.LAUNCHES
    err = np.linalg.norm(est[:, :3, 3] - poses[:n, :3, 3], axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    steady = slice(WARMUP, n)
    odo_ms = np.asarray(system.timings)[steady, 1] * 1e3
    track_share = float(np.sum(odo_ms) / (np.sum(frame_s[steady]) * 1e3))
    log(f"[color] steady state: {steady_s * 1e3:.1f} ms/frame = "
        f"{1 / steady_s:.3f} fps over {n - WARMUP} frames; GN iterations a "
        f"frame: mean {np.mean(iters[1:]):.1f}, max {max(iters)}; knn_join "
        f"launches {knn_launches} ({knn_launches / n:.1f} a frame, "
        f"{np.mean(iters[1:]) + 1:.1f} expected: one per GN iteration and "
        f"the training's); the tracker's share of the steady frames' host "
        f"time {track_share * 100:.1f} % (odometry median "
        f"{np.median(odo_ms):.1f} ms; it syncs every GN iteration); ATE "
        f"(RMSE, no alignment) {ate * 100:.2f} cm, max "
        f"{err.max() * 100:.2f} cm; {int(system.state.count)} map points; "
        f"point-cap overflow frames {system.cap_overflow_frames}")
    check_drift(err, 0.09 * n)
    if knn_launches <= 0:
        raise AssertionError("[color] the colour path never launched the "
                             "knn_join kernel")

    # the map's colour at ground-truth surface points (eval_gauntlet's score)
    probe = gt_surface_points(frames, poses)
    nn, pc = decode_at(system, probe,
                       color_features=system.params["color_features"],
                       color_mlp=system.params["color_mlp"], color_channel=3)
    gt_c = procedural_color(probe.astype(np.float64)).astype(np.float32)
    v = nn >= 6
    e = np.abs(pc[v] - gt_c[v])
    mae, p90 = float(e.mean()), float(np.percentile(e, 90))
    corr = float(np.corrcoef(pc[v].ravel(), gt_c[v].ravel())[0, 1])
    log(f"[color] colour at {len(probe)} ground-truth surface points: "
        f"coverage (>= 6 neighbours) {v.mean():.4f}, mean abs error "
        f"{mae:.4f}, p90 {p90:.4f}, correlation {corr:.4f} (bounds: mean "
        f"{COLOR_MAX_MAE}, correlation > {COLOR_MIN_CORR})")

    # the k-NN kernel at the colour tracker's shape: the last frame's
    # source cloud on its pose against the frame's tracking local set
    pre = system._run_preprocess(frames[-1])
    src, src_n = pre[3], int(pre[5])
    T = torch.as_tensor(est[-1], dtype=torch.float32, device=dev)
    rows = torch.arange(src.shape[0], device=dev) < src_n
    q = torch.where(rows[:, None], src @ T[:3, :3].T + T[:3, 3],
                    torch.full_like(src, kj.PAD))
    q = torch.cat([q, torch.full(((-len(q)) % kj.TQ, 3), kj.PAD,
                                 device=dev)])
    lset, _, _ = system.build_lset_track(
        system._tensor(system.travel_dist[: system.max_frames]), n - 1,
        system._tensor(est[-1][:3, 3]), system.reboot_ts)
    lp = lset.pts[:-1].contiguous()
    qs, tab, bbd, perm, md2f = kj.prepare(q, lp, system.qp.join_max_dist2,
                                          system.qp.resolution)
    shape = measure_knn("color_tracker", src.shape[0],
                        (qs, lp, tab, bbd, perm, system.qp.nn_k, md2f))

    # a colour mesh of the map, its vertices coloured by the map
    mesher = path_mesher(system, cfg, color_channel=3)
    n0 = fd.LAUNCHES
    t0 = time.time()
    verts, faces = mesher.recon_map_mesh(
        system.state, system.params["geo_features"],
        system.params["geo_mlp"], filter_isolated=False)
    colors, _ = mesher.vertex_attributes(
        system.state, system.params["geo_features"],
        system.params["geo_mlp"], verts,
        color_features=system.params["color_features"],
        color_mlp=system.params["color_mlp"], color_channel=3)
    torch.cuda.synchronize()
    mesh_s = time.time() - t0
    fd_mesh = fd.LAUNCHES - n0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ve = np.abs(colors - procedural_color(verts.astype(np.float64)))
    log(f"[color] colour mesh: {verts.shape[0]} vertices, {faces.shape[0]} "
        f"faces, {mesher.n_batches} grid batches on the "
        f"{mesher.decode_route} route, fused_decode launches {fd_mesh} "
        f"(frames: {fd_frames}); colour at the vertices: mean abs error "
        f"{ve.mean():.4f}, p90 {np.percentile(ve, 90):.4f}; mesh + "
        f"vertex colours {mesh_s:.2f} s; peak device memory {peak:.2f} GiB")
    if verts.shape[0] == 0 or not np.isfinite(colors).all():
        raise AssertionError("[color] the colour mesh is empty or "
                             "non-finite")
    if mesher.decode_route != "fused_decode" or fd_mesh != mesher.n_batches:
        raise AssertionError(
            f"[color] the mesher ran {mesher.n_batches} grid batches on the "
            f"{mesher.decode_route} route but the fused decode kernel was "
            f"launched {fd_mesh} times")
    if not (mae <= COLOR_MAX_MAE and corr > COLOR_MIN_CORR):
        raise AssertionError(f"[color] colour mean abs error {mae:.4f}, "
                             f"correlation {corr:.4f}")
    return knn_launches, fd_frames + fd_mesh, shape, dict(
        ms=steady_s * 1e3, ate_m=ate, gn_iters=float(np.mean(iters[1:])),
        knn_per_frame=knn_launches / n, track_share=track_share, mae=mae,
        p90=p90, corr=corr, coverage=float(v.mean()))


def phase_semantic(frames, labels, poses, label_fn, dev):
    """run_demo_sem.yaml through process_frame(sem_labels=...): semantic
    training, the map's labels at ground-truth surface points, a semantic
    mesh. Returns both kernels' launches on this path and the figures."""
    import torch
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.ops import fused_decode as fd
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem
    from pin_slam_tpu_torch.utils.semantic_kitti_utils import sem_kitti_color

    cfg = sem_config(Config)
    n = len(frames)
    system = PinSLAMSystem(cfg, device=dev)
    system.set_gt_poses(poses)
    torch.cuda.reset_peak_memory_stats()
    kj.LAUNCHES = 0
    fd.LAUNCHES = 0
    est, steady_s = run_frames(system, frames, poses, "semantic",
                               labels=labels)
    knn_launches = kj.LAUNCHES
    err = np.linalg.norm(est[:, :3, 3] - poses[:n, :3, 3], axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    log(f"[semantic] steady state: {steady_s * 1e3:.1f} ms/frame = "
        f"{1 / steady_s:.3f} fps over {n - WARMUP} frames; ATE (RMSE, no "
        f"alignment) {ate * 100:.2f} cm, max {err.max() * 100:.2f} cm; "
        f"knn_join launches {knn_launches} ({knn_launches / n:.1f} a "
        f"frame); {int(system.state.count)} map points")
    check_drift(err, 0.09 * n)
    if knn_launches <= 0:
        raise AssertionError("[semantic] the semantic path never launched "
                             "the knn_join kernel")

    probe = gt_surface_points(frames, poses)
    nn, pred = decode_at(system, probe, sem_mlp=system.params["sem_mlp"])
    gt = label_fn(probe.astype(np.float64))
    v = nn >= 6
    acc = float((pred[v] == gt[v]).mean())
    ious = {}
    for cls in (1, 2, 3):
        inter = float(((pred == cls) & (gt == cls) & v).sum())
        union = float((((pred == cls) | (gt == cls)) & v).sum())
        ious[cls] = inter / max(union, 1.0)
    log(f"[semantic] labels at {len(probe)} ground-truth surface points: "
        f"coverage {v.mean():.4f}, accuracy {acc:.4f} (bound "
        f">= {SEM_MIN_ACC}), IoU " + ", ".join(
            f"class {k} {x:.4f}" for k, x in ious.items())
        + f", mIoU {np.mean(list(ious.values())):.4f}")

    mesher = path_mesher(system, cfg, semantic_on=True)
    t0 = time.time()
    verts, faces = mesher.recon_map_mesh(
        system.state, system.params["geo_features"],
        system.params["geo_mlp"], filter_isolated=False)
    _, vlab = mesher.vertex_attributes(
        system.state, system.params["geo_features"],
        system.params["geo_mlp"], verts, sem_mlp=system.params["sem_mlp"])
    mesh_colors = sem_kitti_color(vlab)
    torch.cuda.synchronize()
    mesh_s = time.time() - t0
    fd_launches = fd.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vacc = float((vlab == label_fn(verts.astype(np.float64))).mean())
    log(f"[semantic] semantic mesh: {verts.shape[0]} vertices, "
        f"{faces.shape[0]} faces, {mesher.n_batches} grid batches on the "
        f"{mesher.decode_route} route; vertex labels' accuracy {vacc:.4f}; "
        f"mesh + labels {mesh_s:.2f} s; fused_decode launches "
        f"{fd_launches}; peak device memory {peak:.2f} GiB")
    if verts.shape[0] == 0 or mesh_colors.shape != (verts.shape[0], 3):
        raise AssertionError("[semantic] the semantic mesh is empty")
    if fd_launches != 0:
        raise AssertionError(f"[semantic] weighted_first=True, yet the "
                             f"fused decode launched {fd_launches} times")
    if acc < SEM_MIN_ACC:
        raise AssertionError(f"[semantic] accuracy {acc:.4f} at the "
                             f"ground-truth surface")
    return knn_launches, fd_launches, dict(
        ms=steady_s * 1e3, ate_m=ate, acc=acc, ious=ious,
        mesh_acc=vacc, coverage=float(v.mean()))


def make_run_sequence(n_frames=RUN_FRAMES):
    """make_sequence's HDL-64 frames on its circle in its room, scanned by a
    spinning sensor: each ray fires from the pose of its azimuth's instant
    between this frame's pose and the next (`sweep=True`). The sequence
    holds one pose more than the frames run, so the last frame moves
    during its sweep too."""
    seq = make_sequence(n_frames + 1)
    seq.sweep = True
    return seq


def _run_frame(i):
    return make_run_sequence().frame_with_ts(i)


def mid_scan_poses(seq):
    """The poses at each scan's middle instant: the frame the deskewed scan
    is expressed in (deskew's ts_mid_pose 0.5), so the ground truth."""
    return np.stack([seq._pose_at(i, 0.5) for i in range(len(seq))])


def write_ply_with_time(path, pts, ts):
    """Binary PLY with x, y, z (float) and a per-point `time` (double)."""
    arr = np.empty(len(pts), np.dtype([("xyz", "<f4", (3,)),
                                       ("time", "<f8")]))
    arr["xyz"], arr["time"] = pts, ts
    hdr = ("ply\nformat binary_little_endian 1.0\n"
           f"element vertex {len(pts)}\nproperty float x\nproperty float y\n"
           "property float z\nproperty double time\nend_header\n")
    with open(path, "wb") as f:
        f.write(hdr.encode("ascii"))
        f.write(arr.tobytes())


def write_run_dataset(root, frames, gt):
    """The sequence as a KITTI-style dataset on disk: PLY scans with their
    time field, written through the inverse of KITTI's vertical-angle
    correction (the reader's `kitti_correct` undoes it), poses.txt in the
    camera frame of a calib.txt whose Tr is not the identity (the reader's
    `apply_kitti_format_calib` moves them back into the LiDAR frame)."""
    from pin_slam_tpu_torch.dataset.io import write_kitti_format_poses
    from pin_slam_tpu_torch.dataset.slam_dataset import intrinsic_correct

    pc = os.path.join(root, "velodyne")
    os.makedirs(pc, exist_ok=True)
    for i, (pts, ts) in enumerate(frames):
        raw = intrinsic_correct(pts.astype(np.float64), -KITTI_CORRECT_DEG)
        write_ply_with_time(os.path.join(pc, f"{i:06d}.ply"), raw, ts)
    Tr = np.eye(4)        # KITTI's LiDAR -> camera axes, with an offset
    Tr[:3, :3] = [[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]
    Tr[:3, 3] = [-0.004, -0.076, -0.272]
    write_kitti_format_poses(os.path.join(root, "poses.txt"), np.stack(
        [Tr @ T @ np.linalg.inv(Tr) for T in gt]))
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write("Tr: " + " ".join(f"{v:.12e}" for v in Tr[:3].ravel())
                + "\n")
    return pc


def run_yaml(root, name, **setting):
    """config/lidar_slam/run_kitti.yaml as shipped, its paths pointed at
    the dataset under `root`, min_z -7 m (the floor kept, as `[loop]`),
    and `setting` entries added."""
    import yaml
    with open(os.path.join(ROOT, "config", "lidar_slam",
                           "run_kitti.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["setting"].update(pc_path=os.path.join(root, "velodyne"),
                          pose_path=os.path.join(root, "poses.txt"),
                          calib_path=os.path.join(root, "calib.txt"),
                          output_root=os.path.join(root, name), **setting)
    cfg["process"]["min_z_m"] = -7.0
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


class SystemSpy:
    """Records, while active, what the entry point's PinSLAMSystem did:
    the system itself, each frame's tracker validity, GN iterations and
    host seconds, the training runs, each bundle adjustment (frame, device
    ms, loss curve), the host seconds of the dataset's frame reads and
    deskews, and the meshers that meshed a map. Wraps the methods and
    restores them on exit."""

    def __enter__(self):
        from pin_slam_tpu_torch.dataset.slam_dataset import SLAMDataset
        from pin_slam_tpu_torch.slam import system as sysmod
        from pin_slam_tpu_torch.slam.mesher import Mesher
        from pin_slam_tpu_torch.slam.system import PinSLAMSystem
        self.cls = PinSLAMSystem
        self.saved = [(PinSLAMSystem, "process_frame"),
                      (PinSLAMSystem, "train"),
                      (sysmod, "run_bundle_adjustment"),
                      (SLAMDataset, "read_frame_sem"),
                      (SLAMDataset, "deskew"), (Mesher, "recon_map_mesh")]
        self.orig = [getattr(o, n) for o, n in self.saved]
        self.system, self.valid, self.iters, self.secs = None, [], [], []
        self.trains = 0
        self.ba, self.read_s, self.deskew_s, self.meshers = [], [], [], []
        spy = self
        pf, train, run_ba, read, deskew, recon = self.orig

        def process_frame(sysm, frame_id, *a, **k):
            spy.system = sysm
            t0 = time.time()
            out = pf(sysm, frame_id, *a, **k)
            tr = sysm.last_tracking
            spy.valid.append(frame_id == 0 or (tr is not None
                                               and bool(tr.valid)))
            spy.secs.append(time.time() - t0)
            spy.iters.append(sysm.last_track_iters)
            return out

        def train_(sysm, *a, **k):
            spy.trains += 1
            return train(sysm, *a, **k)

        def run_ba_(sysm, frame_id, *a, **k):
            import torch
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = run_ba(sysm, frame_id, *a, **k)
            e1.record()
            torch.cuda.synchronize()
            spy.ba.append(dict(frame=frame_id, ms=e0.elapsed_time(e1),
                               losses=sysm.last_ba_losses.cpu().numpy()))
            return out

        def timed(fn, out):
            def wrapped(*a, **k):
                t0 = time.time()
                res = fn(*a, **k)
                out.append(time.time() - t0)
                return res
            return wrapped

        def recon_(mesher, *a, **k):
            spy.meshers.append(mesher)
            return recon(mesher, *a, **k)

        for (o, n), f in zip(self.saved, (
                process_frame, train_, run_ba_, timed(read, self.read_s),
                staticmethod(timed(deskew, self.deskew_s)), recon_)):
            setattr(o, n, f)
        return self

    def __exit__(self, *exc):
        for (o, n), f in zip(self.saved, self.orig):
            setattr(o, n, staticmethod(f) if n == "deskew" else f)
        return False


def read_ply_vertices(path):
    from pin_slam_tpu_torch.dataset.io import read_ply
    d = read_ply(path)
    return np.stack([d["x"], d["y"], d["z"]], -1)


def pose_errors(path, gt):
    from pin_slam_tpu_torch.dataset.io import read_kitti_format_poses
    est = np.stack(read_kitti_format_poses(path))
    return est, np.linalg.norm(est[:, :3, 3] - gt[: len(est), :3, 3], axis=1)


def phase_run(frames, seq, root):
    """run_kitti.yaml through the entry point, as a user runs it:
    `python -m pin_slam_tpu_torch.run <yaml> -o <dir> -s -m --deskew`,
    in-process. Returns both kernels' launches and the figures."""
    import torch
    from pin_slam_tpu_torch import run as trun
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.dataset.slam_dataset import SLAMDataset
    from pin_slam_tpu_torch.ops import fused_decode as fd
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.vis_map import vis_pin_map

    n = len(frames)
    gt = mid_scan_poses(seq)[:n]
    write_run_dataset(root, frames, gt)
    cfg_path = run_yaml(root, "run")
    out_dir = os.path.join(root, "run_out")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with SystemSpy() as spy:
        kj.LAUNCHES = 0
        fd.LAUNCHES = 0
        metrics = trun.main([cfg_path, "-o", out_dir, "-s", "-m",
                             "--deskew"])
        knn_launches, fd_launches = kj.LAUNCHES, fd.LAUNCHES
    torch.cuda.synchronize()
    wall = time.time() - t0
    run_dir = os.path.join(out_dir, sorted(os.listdir(out_dir))[0])
    missing = [f for f in ("odom_poses_kitti.txt", "odom_poses_tum.txt",
                           "pose_eval.csv", "time_table.npy",
                           "model/pin_map.npz", "map/neural_points.ply",
                           "meta/config_all.yaml")
               if not os.path.exists(os.path.join(run_dir, f))]
    meshes = sorted(os.listdir(os.path.join(run_dir, "mesh")))
    if missing or not meshes:
        raise AssertionError(f"[run] missing artifacts: {missing}, meshes "
                             f"{meshes}")
    ate = metrics["Absoulte Trajectory Error [m]"]
    odom, err = pose_errors(os.path.join(run_dir, "odom_poses_kitti.txt"),
                            gt)
    _, slam_err = pose_errors(os.path.join(run_dir, "slam_poses_kitti.txt"),
                              gt)
    steady = np.asarray(spy.secs[WARMUP:]) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[run] run_kitti.yaml through the entry point: {n} frames in "
        f"{wall:.1f} s (the run, the final mesh and the saves); "
        f"process_frame median {np.median(steady):.1f} ms over the steady "
        f"frames ({1e3 / np.median(steady):.3f} fps); GN iterations a "
        f"frame mean {np.mean(spy.iters[1:]):.1f}; ATE (write_results, "
        f"aligned) {ate * 100:.2f} cm, max pose error (no alignment) "
        f"{err.max() * 100:.2f} cm (PGO chain {slam_err.max() * 100:.2f} "
        f"cm); knn_join launches {knn_launches} ({knn_launches / n:.1f} a "
        f"frame), fused_decode {fd_launches}; "
        f"{int(spy.system.state.count)} map points; trainings {spy.trains};"
        f" peak device memory {peak:.2f} GiB")
    if not all(spy.valid):
        raise AssertionError("[run] the tracker lost track in frames "
                             f"{[i for i, v in enumerate(spy.valid) if not v]}")
    check_drift(err, 0.09 * n)
    check_drift(slam_err, 0.09 * n)
    if not ate <= 0.09 * n:
        raise AssertionError(f"[run] ATE {ate} m past {0.09 * n} m")
    if knn_launches <= 0:
        raise AssertionError("[run] the run never launched the knn_join "
                             "kernel")
    if fd_launches != 0:
        raise AssertionError(f"[run] weighted_first=True, yet the fused "
                             f"decode launched {fd_launches} times")

    # the final mesh, against the true scene
    verts = read_ply_vertices(os.path.join(run_dir, "mesh", meshes[0]))
    med = float(np.median(np.abs(seq.scene_sdf(verts.astype(np.float64)))))
    log(f"[run] final mesh {meshes[0]}: {len(verts)} vertices, median "
        f"distance of its vertices to the scene {med:.4f} m (bound "
        f"{MAX_MESH_MEDIAN_M} m)")
    if len(verts) == 0 or med > MAX_MESH_MEDIAN_M:
        raise AssertionError(f"[run] mesh of {len(verts)} vertices, median "
                             f"{med} m off the scene")

    # deskew, as the run did it (with the relative motion of the two frames
    # before, read back from the written odometry): the deskewed scan
    # placed with the true mid-scan pose lies closer to the scene
    cfg = Config().load(cfg_path)
    cfg.deskew = True
    data = SLAMDataset(cfg)
    ratios = []
    for i in RUN_DESKEW_FRAMES:
        pts, ts = data.read_frame(i)
        tran = np.linalg.inv(odom[i - 2]) @ odom[i - 1]
        desk = data.deskew(pts, ts, tran)
        T = gt[i]
        d_raw = np.median(np.abs(seq.scene_sdf(pts @ T[:3, :3].T + T[:3, 3])))
        d_desk = np.median(np.abs(seq.scene_sdf(
            desk @ T[:3, :3].T + T[:3, 3])))
        ratios.append((i, float(d_raw), float(d_desk)))
    log("[run] deskew: median |scene SDF| on the true mid-scan pose, raw -> "
        "deskewed: " + ", ".join(f"frame {i} {a * 100:.2f} -> {b * 100:.2f} "
                                 f"cm" for i, a, b in ratios))
    if not all(b < a for _, a, b in ratios):
        raise AssertionError(f"[run] deskew does not bring the scans closer "
                             f"to the scene: {ratios}")

    t0 = time.time()
    verts, faces = vis_pin_map(run_dir, mc_res_m=cfg.mc_res_m)
    torch.cuda.synchronize()
    log(f"[run] vis_pin_map at {cfg.mc_res_m} m: {verts.shape[0]} "
        f"vertices, {faces.shape[0]} faces in {time.time() - t0:.2f} s")
    if verts.shape[0] == 0:
        raise AssertionError("[run] vis_pin_map gave an empty mesh")
    return knn_launches, fd_launches, run_dir, dict(
        ms=float(np.median(steady)), ate_m=ate, max_err_m=float(err.max()),
        gn_iters=float(np.mean(spy.iters[1:])), wall_s=wall)


def phase_localize(frames, seq, root, run_dir, run_ate):
    """The same YAML with load_model through run_pin_slam over the same
    frames: localization against `[run]`'s saved map. Then the k-NN kernel
    at the localization shape, against its plain version."""
    import torch
    from pin_slam_tpu_torch import run as trun
    from pin_slam_tpu_torch.ops import fused_decode as fd
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.slam.tracker import CAND_K

    n = len(frames)
    model = os.path.join(run_dir, "model", "pin_map.npz")
    cfg_path = run_yaml(root, "localize", load_model=True, model_path=model)
    with np.load(model) as z:
        saved = {k: z[k] for k in z.files}
    cnt = int(saved["positions"].shape[0])
    torch.cuda.reset_peak_memory_stats()
    with SystemSpy() as spy:
        kj.LAUNCHES = 0
        fd.LAUNCHES = 0
        metrics = trun.run_pin_slam(cfg_path, deskew=True)
        knn_launches, fd_launches = kj.LAUNCHES, fd.LAUNCHES
    torch.cuda.synchronize()
    system = spy.system
    ate = metrics["Absoulte Trajectory Error [m]"]
    steady = np.asarray(spy.secs[WARMUP:]) * 1e3
    lset = system._loc_lset
    log(f"[localize] {n} frames against the saved map ({cnt} points; the "
        f"frozen join set {lset.cap} rows, {int(lset.count)} live, built "
        f"once): process_frame median {np.median(steady):.1f} ms "
        f"({1e3 / np.median(steady):.3f} fps); GN iterations a frame mean "
        f"{np.mean(spy.iters[1:]):.1f}; knn_join launches {knn_launches} "
        f"({knn_launches / max(n - 1, 1):.2f} a tracked frame), "
        f"fused_decode {fd_launches}; trainings {spy.trains}; ATE "
        f"{ate * 100:.2f} cm (mapping run {run_ate * 100:.2f} cm); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        "GiB")
    if not (system.localization_mode and all(spy.valid)):
        raise AssertionError("[localize] frames lost: "
                             f"{[i for i, v in enumerate(spy.valid) if not v]}")
    s = system.state
    if int(s.count) != cnt:
        raise AssertionError(f"[localize] the map's count moved: {cnt} -> "
                             f"{int(s.count)}")
    for f in ("positions", "orientations", "geo_features", "ts_create",
              "ts_update", "certainty"):
        if not np.array_equal(getattr(s, f)[:cnt].cpu().numpy(),
                              saved[f][:cnt]):
            raise AssertionError(f"[localize] map {f} changed")
    for kind in ("w", "b"):
        for i, w in enumerate(system.params["geo_mlp"][kind]):
            if not np.array_equal(w.cpu().numpy(),
                                  saved[f"mlp/geo_mlp.{kind}.{i}"]):
                raise AssertionError("[localize] the decoder changed")
    if spy.trains or knn_launches <= 0 or fd_launches:
        raise AssertionError(f"[localize] trainings {spy.trains}, knn "
                             f"launches {knn_launches}, fused decode "
                             f"{fd_launches}")
    if ate > run_ate + LOC_ATE_SLACK_M:
        raise AssertionError(f"[localize] ATE {ate} m past the mapping "
                             f"run's {run_ate} m + {LOC_ATE_SLACK_M}")

    # the k-NN kernel at the localization shape: the last frame's source
    # cloud on its pose against the frozen whole-map set
    from pin_slam_tpu_torch.dataset.slam_dataset import SLAMDataset
    data = SLAMDataset(system.config)
    pts, ts = data.read_frame(n - 1)
    pts = data.deskew(pts, ts, system.last_odom_tran)
    pre = system._run_preprocess(pts)
    src, src_n = pre[3], int(pre[5])
    T = torch.as_tensor(system.cur_pose_ref, dtype=torch.float32,
                        device=system.device)
    rows = torch.arange(src.shape[0], device=src.device) < src_n
    q = torch.where(rows[:, None], src @ T[:3, :3].T + T[:3, 3],
                    torch.full_like(src, kj.PAD))
    q = torch.cat([q, torch.full(((-len(q)) % kj.TQ, 3), kj.PAD,
                                 device=src.device)])
    lp = lset.pts[:-1].contiguous()
    qs, tab, bbd, perm, md2f = kj.prepare(q, lp, system.qp.join_max_dist2,
                                          system.qp.resolution)
    shape = measure_knn("localize", src.shape[0],
                        (qs, lp, tab, bbd, perm, CAND_K, md2f))
    shape["set_rows"] = lset.cap
    return knn_launches, fd_launches, shape, dict(
        ms=float(np.median(steady)), ate_m=ate,
        gn_iters=float(np.mean(spy.iters[1:])),
        knn_per_frame=knn_launches / max(n - 1, 1))


def raycast_from(scene_sdf, origins, dirs, max_range, iters=96, tol=1e-4):
    """synthetic.raycast with an origin of its own for every ray: depths
    [N], np.inf where no hit within max_range."""
    t = np.zeros(dirs.shape[0])
    act = np.arange(dirs.shape[0])
    for _ in range(iters):
        d = scene_sdf(origins[act] + t[act, None] * dirs[act])
        ta = np.minimum(t[act] + np.maximum(d, 0.0) * 0.95, max_range * 1.01)
        t[act] = ta
        act = act[~((np.abs(d) < tol) | (ta >= max_range))]
        if act.size == 0:
            break
    hit = (np.abs(scene_sdf(origins + t[:, None] * dirs)) < 5e-3) \
        & (t < max_range)
    return np.where(hit, t, np.inf)


def bag_frame(i):
    """Frame i of the `[bag]` walk (make_ncd_sequence's, BAG_FRAMES + 1
    poses) as an Ouster OS0-128 gives it: an organised OS_ROWS x OS_COLS
    scan, the top beam first, column c fired at c / OS_COLS of the scan
    from the
    pose of that instant (the sensor moves during the sweep), points in
    the sensor frame of their instant and (0, 0, 0) where a ray has no
    return. Returns (xyz [OS_ROWS, OS_COLS, 3] float32, t_ns [OS_COLS]
    uint32)."""
    from pin_slam_tpu_torch.dataset.synthetic import lidar_directions
    seq = make_ncd_sequence(BAG_FRAMES + 1)
    dirs = lidar_directions(OS_COLS, OS_ROWS,
                            el_range=(-45.0, 45.0)).reshape(OS_COLS,
                                                            OS_ROWS, 3)
    frac = np.arange(OS_COLS) / OS_COLS
    T = np.stack([seq._pose_at(i, f) for f in frac])
    world = np.einsum("cij,crj->cri", T[:, :3, :3], dirs)
    org = np.broadcast_to(T[:, None, :3, 3], world.shape)
    depth = raycast_from(seq.scene_sdf, org.reshape(-1, 3),
                         world.reshape(-1, 3), seq.max_range)
    hit = np.isfinite(depth)
    xyz = np.where(hit[:, None], dirs.reshape(-1, 3)
                   * np.where(hit, depth, 0.0)[:, None], 0.0)
    xyz = xyz.astype(np.float32).reshape(OS_COLS, OS_ROWS, 3).transpose(
        1, 0, 2)
    return (np.ascontiguousarray(xyz[::-1]),
            np.round(frac * SCAN_NS).astype(np.uint32))


def read_back(loader, grids):
    """True when every frame of the loader is the written cloud: float32
    points as float64 in row-major order, `t` normalised to [0, 1] as
    read_point_cloud2 does."""
    if len(loader) != len(grids):
        return False
    for k, (xyz, t_ns) in enumerate(grids):
        d = loader[k]
        t = np.broadcast_to(t_ns.astype(np.float64), xyz.shape[:2]).ravel()
        if not (np.array_equal(d["points"],
                               xyz.reshape(-1, 3).astype(np.float64))
                and np.array_equal(d["point_ts"], (t - t.min())
                                   / (t.max() - t.min()))):
            return False
    return True


def phase_bag(grids, seq, root):
    """run_ncd_128_s.yaml through the entry point from a ROS1 bag, as a user
    runs it: `python -m pin_slam_tpu_torch.run <yaml> rosbag -i <dir> -o
    <out> -d --deskew -s -m`, in-process. Returns both kernels' launches
    and the figures."""
    import torch
    from pin_slam_tpu_torch import run as trun
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.dataset import mcap1
    from pin_slam_tpu_torch.dataset.dataloaders.mcap import McapDataloader
    from pin_slam_tpu_torch.dataset.dataloaders.rosbag import RosbagDataset
    from pin_slam_tpu_torch.dataset.slam_dataset import SLAMDataset
    from pin_slam_tpu_torch.ops import fused_decode as fd
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.utils.eval_traj import absolute_error

    n = len(grids)
    cfg_path = os.path.join(ROOT, "config", "lidar_slam",
                            "run_ncd_128_s.yaml")
    bag_dir = os.path.join(root, "bag")
    bag_mb = os.path.getsize(os.path.join(bag_dir, "ncd_walk.bag")) / 2**20
    # the truth: the mid-scan poses, in the frame of the first scan (the
    # run starts at the identity; a bag carries no ground truth)
    gt_abs = mid_scan_poses(seq)[:n]
    gt = np.linalg.inv(gt_abs[0]) @ gt_abs
    out_dir = os.path.join(root, "bag_out")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with SystemSpy() as spy:
        kj.LAUNCHES = 0
        fd.LAUNCHES = 0
        trun.main([cfg_path, "rosbag", "-i", bag_dir, "-o", out_dir, "-d",
                   "--deskew", "-s", "-m"])
        knn_launches, fd_launches = kj.LAUNCHES, fd.LAUNCHES
    torch.cuda.synchronize()
    wall = time.time() - t0
    run_dir = os.path.join(out_dir, sorted(os.listdir(out_dir))[0])
    cfg = Config().load(cfg_path)
    missing = [f for f in ("odom_poses_kitti.txt", "odom_poses_tum.txt",
                           "slam_poses_kitti.txt", "time_table.npy",
                           "model/pin_map.npz", "map/neural_points.ply",
                           "meta/config_all.yaml")
               if not os.path.exists(os.path.join(run_dir, f))]
    meshes = sorted(os.listdir(os.path.join(run_dir, "mesh")))
    if missing or not meshes:
        raise AssertionError(f"[bag] missing artifacts: {missing}, meshes "
                             f"{meshes}")
    # the YAML's pgo: section writes the PGO chain beside the odometry
    odom, err = pose_errors(os.path.join(run_dir, "odom_poses_kitti.txt"),
                            gt)
    slam, slam_err = pose_errors(
        os.path.join(run_dir, "slam_poses_kitti.txt"), gt)
    chains = [("odometry", odom, err), ("PGO", slam, slam_err)]
    ate = {name: absolute_error(gt, est, align_on=False)[0]
           for name, est, _ in chains}
    steady = np.asarray(spy.secs[min(WARMUP, n - 1):]) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mesher = spy.meshers[-1]     # the final mesh's (its file exists)
    log(f"[bag] run_ncd_128_s.yaml from the bag through the entry point: "
        f"{n} frames in {wall:.1f} s (the run, the final mesh and the "
        f"saves); process_frame median {np.median(steady):.1f} ms over the "
        f"steady frames ({1e3 / np.median(steady):.3f} fps); GN iterations "
        f"a frame mean {np.mean(spy.iters[1:]):.1f}; knn_join launches "
        f"{knn_launches} ({knn_launches / n:.1f} a frame), fused_decode "
        f"{fd_launches} (final mesh: "
        f"{mesher.n_batches} grid batches, route {mesher.decode_route}); "
        f"host bag read "
        f"{np.median(spy.read_s) * 1e3:.1f} ms and deskew "
        f"{np.median(spy.deskew_s) * 1e3:.1f} ms a frame (medians, apart "
        f"from process_frame); ATE (RMSE, no alignment, against the "
        f"mid-scan truth) " + ", ".join(
            f"{k} {v * 100:.2f} cm" for k, v in ate.items())
        + f", max pose error {err.max() * 100:.2f} cm; "
        f"{int(spy.system.state.count)} map points; trainings "
        f"{spy.trains}; peak device memory {peak:.2f} GiB")
    for b in spy.ba:
        ls = b["losses"]
        log(f"[bag] BA at frame {b['frame']}: {len(ls)} iterations in "
            f"{b['ms']:.1f} ms on the device; loss {ls[0]:.6f} -> "
            f"{ls[-1]:.6f}")
    if not all(spy.valid) or len(spy.valid) != n:
        raise AssertionError("[bag] the tracker lost track in frames "
                             f"{[i for i, v in enumerate(spy.valid) if not v]}")
    for _, _, e in chains:
        check_drift(e, 0.09 * n)
    due = [f for f in range(n) if (f + 1) % cfg.ba_freq_frame == 0]
    if [b["frame"] for b in spy.ba] != due or not due:
        raise AssertionError(f"[bag] BA ran on frames "
                             f"{[b['frame'] for b in spy.ba]}, not {due}")
    for b in spy.ba:
        if not (np.isfinite(b["losses"][-1])
                and b["losses"][-1] < b["losses"][0]):
            raise AssertionError(f"[bag] BA at frame {b['frame']} did not "
                                 f"lower its loss")
    if knn_launches <= 0:
        raise AssertionError("[bag] the run never launched the knn_join "
                             "kernel")
    if (mesher.decode_route != "fused_decode" or fd_launches <= 0
            or fd_launches != mesher.n_batches):
        raise AssertionError(
            f"[bag] the final mesh ran {mesher.n_batches} grid "
            f"batches on the {mesher.decode_route} route but the "
            f"fused decode kernel was launched {fd_launches} times")

    # the final mesh, moved into the scene's frame by the first truth pose
    verts = read_ply_vertices(os.path.join(run_dir, "mesh", meshes[0]))
    T0 = gt_abs[0]
    world = verts.astype(np.float64) @ T0[:3, :3].T + T0[:3, 3]
    med = float(np.median(np.abs(seq.scene_sdf(world))))
    log(f"[bag] final mesh {meshes[0]}: {len(verts)} vertices, median "
        f"distance of its vertices to the scene {med:.4f} m (bound "
        f"{MAX_MESH_MEDIAN_M} m); marching "
        f"{mesher.marching_seconds:.2f} s")
    if len(verts) == 0 or med > MAX_MESH_MEDIAN_M:
        raise AssertionError(f"[bag] mesh of {len(verts)} vertices, median "
                             f"{med} m off the scene")

    # the readers: every frame as written; the first three again as MCAP
    t0 = time.time()
    same_bag = read_back(RosbagDataset(bag_dir), grids)
    read_s = time.time() - t0
    mcap_path = os.path.join(root, "first3.mcap")
    mcap1.write_mcap(mcap_path, [ouster_cloud(*g) for g in grids[:3]],
                     topic=BAG_TOPIC)
    same_mcap = read_back(McapDataloader(mcap_path), grids[:3])
    log(f"[bag] the loader's frames equal the written clouds: bag "
        f"{same_bag} ({n} frames read in {read_s:.2f} s), MCAP of the "
        f"first 3 {same_mcap}")
    if not (same_bag and same_mcap):
        raise AssertionError("[bag] a reader did not return the clouds "
                             "that were written")

    # deskew, as the run did it (the relative motion of the two frames
    # before, from the written odometry): the deskewed scan placed with the
    # true mid-scan pose lies closer to the scene than the raw scan. Scored
    # on the returns within the crop's range off the floor and ceiling:
    # the walk moves along those planes, so no motion distorts them.
    cfg.use_dataloader, cfg.data_loader_name = True, "rosbag"
    cfg.data_loader_seq, cfg.pc_path = "", bag_dir
    data = SLAMDataset(cfg)
    ratios = []
    for i in BAG_DESKEW_FRAMES:
        if i >= n:
            continue
        pts, ts = data.read_frame(i)
        desk = data.deskew(pts, ts, np.linalg.inv(odom[i - 2]) @ odom[i - 1])
        T = gt_abs[i]
        raw_w, desk_w = (p @ T[:3, :3].T + T[:3, 3] for p in (pts, desk))
        r = np.linalg.norm(pts, axis=1)
        keep = (r > cfg.min_range) & (r < cfg.max_range) \
            & (np.abs(raw_w[:, 2]) < BAG_ROOM_HALF_HEIGHT_M - 0.3)
        d_raw, d_desk = (float(np.median(np.abs(seq.scene_sdf(w[keep]))))
                         for w in (raw_w, desk_w))
        ratios.append((i, d_raw, d_desk, int(keep.sum())))
    log("[bag] deskew: median |scene SDF| on the true mid-scan pose, raw -> "
        "deskewed, over the returns off the floor and ceiling: " + ", ".join(
            f"frame {i} {a * 100:.2f} -> {b * 100:.2f} cm ({m} returns)"
            for i, a, b, m in ratios))
    if not ratios or not all(b < a for _, a, b, _ in ratios):
        raise AssertionError(f"[bag] deskew does not bring the scans closer "
                             f"to the scene: {ratios}")
    return knn_launches, fd_launches, dict(
        ms=float(np.median(steady)), ate_m=ate,
        gn_iters=float(np.mean(spy.iters[1:])),
        knn_per_frame=knn_launches / n, ba_ms=[b["ms"] for b in spy.ba],
        read_ms=float(np.median(spy.read_s) * 1e3),
        deskew_ms=float(np.median(spy.deskew_s) * 1e3), bag_mib=bag_mb,
        wall_s=wall, peak_gib=peak)


def write_ncd_bag(grids, bag_dir):
    """The `[bag]` walk's organised Ouster clouds as one ROS1 bag on
    BAG_TOPIC under `bag_dir`, written by the port's `write_bag1`; returns
    its path."""
    from pin_slam_tpu_torch.dataset import rosbag1

    os.makedirs(bag_dir)
    path = os.path.join(bag_dir, "ncd_walk.bag")
    t0 = time.time()
    rosbag1.write_bag1(path, [ouster_cloud(*g) for g in grids],
                       topic=BAG_TOPIC)
    log(f"[bag] wrote {len(grids)} organised {grids[0][0].shape[0]} x "
        f"{grids[0][0].shape[1]} Ouster clouds (point_step "
        f"{OUSTER_POINT_STEP}, {int((grids[0][0] != 0).any(-1).sum())} "
        f"returns in frame 0) on {BAG_TOPIC}: "
        f"{os.path.getsize(path) / 2 ** 20:.1f} MiB in "
        f"{time.time() - t0:.1f} s")
    return path


def probes_config(Config, mode, **options):
    """bench_config with weighted_first=False and the floor kept (min_z -7
    m, as `[loop]`), under `probe_mode` `mode`, with `options` (training
    flags) set. The join probe's local set is sized to the run's map
    (2^17 rows, as `[color]`): bench.py's 2^16 holds its cropped scene."""
    cfg = bench_config(Config, weighted_first=False)
    cfg.min_z = -7.0
    cfg.local_set_cap = 1 << 17
    cfg.probe_mode = mode
    for k, v in options.items():
        setattr(cfg, k, v)
    return cfg.finalize()


def run_probe_mode(mode, frames, poses, dev, **options):
    """One 20-frame run of the bench configuration under `mode`. Returns
    (system, figures)."""
    import torch
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.ops import fused_decode as fd
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    tag = f"probes:{mode}" if not options else "options"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    system = PinSLAMSystem(probes_config(Config, mode, **options),
                           device=dev)
    system.set_gt_poses(poses)
    iters, frame_s = [], []
    kj.LAUNCHES = 0
    fd.LAUNCHES = 0
    est, steady_s = run_frames(
        system, frames, poses, tag, frame_s=frame_s,
        on_frame=lambda f: iters.append(system.last_track_iters))
    d = est[:, :3, 3] - poses[: len(est), :3, 3]
    err = np.linalg.norm(d, axis=1)
    check_drift(err)
    s = system.state
    res = dict(
        mode=mode, ms=float(np.median(frame_s[WARMUP:]) * 1e3),
        steady_ms=steady_s * 1e3, gn_iters=float(np.mean(iters[1:])),
        ate_m=float(np.sqrt(np.mean(err ** 2))), max_err_m=float(err.max()),
        z_last_m=float(d[-1, 2]), knn=kj.LAUNCHES, fd=fd.LAUNCHES,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        btable_bytes=s.btable.numel() * s.btable.element_size(),
        map_points=int(s.count))
    log(f"[{tag}] {mode}: {res['ms']:.1f} ms/frame (median of the steady "
        f"frames; {steady_s * 1e3:.1f} wall), GN iterations "
        f"{res['gn_iters']:.1f} a frame, ATE {res['ate_m'] * 100:.2f} cm "
        f"(max {res['max_err_m'] * 100:.2f}, z at frame "
        f"{len(frames) - 1} {res['z_last_m'] * 100:+.2f} cm), knn_join "
        f"launches {res['knn']} ({res['knn'] / len(frames):.2f} a frame), "
        f"fused_decode launches {res['fd']}, map {res['map_points']} "
        f"points, brick table {res['btable_bytes']} B, peak device memory "
        f"{res['peak_gib']:.2f} GiB")
    return system, res


def time_probes(system, frames, est, dev):
    """On `system`'s final map (kept with its brick cache): the cell probe,
    the brick probe and the join probe (the set build, then the k-NN
    kernel) at the tracker's source cloud (the last frame's, on its pose;
    travel window and sensor radius, k = nn_k, or 12 candidates on the
    join), one training batch (16384 pool samples; travel window, k =
    nn_k, or nn_k + 2 candidates) and the mesher's batch (524288 points of
    its first grid batch, no filter, k = 6). Prints their device ms and
    the share of queries whose neighbours differ between brick and cells;
    fails past the JAX package's bounds (tests/test_ops.py: nn_count
    differs on < 15 %, the sets agree on > 90 %) at the tracker's and the
    training shapes. Returns the table."""
    import torch
    from pin_slam_tpu_torch.models import neural_points as npm
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.ops.transforms import transform_points
    from pin_slam_tpu_torch.slam.mesher import MeshConfig, Mesher

    c, qp, s = system.config, system.qp, system.state
    fid = len(frames) - 1
    pre = system._run_preprocess(frames[fid])
    src = transform_points(pre[3][: int(pre[5])],
                           system._tensor(est[fid]))
    g = torch.Generator(device=dev).manual_seed(5)
    rows = torch.randint(0, int(system.pool.count), (c.bs,), generator=g,
                         device=dev)
    batch = system.pool.coord[rows]
    cnt = int(s.count)
    pos = s.positions[:cnt]
    mesher = Mesher(qp, MeshConfig(mc_res_m=c.mc_res_m,
                                   infer_bs=c.infer_bs_final))
    lo, hi = mesher.split_chunks(pos.amin(0).cpu().numpy(),
                                 pos.amax(0).cpu().numpy(),
                                 c.mc_res_m * 200)[0]
    origin, dims = mesher.aabb_grid(lo, hi)
    grid = mesher.grid_coords(origin, dims, 0,
                              min(c.infer_bs_final, int(np.prod(dims))), dev)
    lf = system._lf(fid, sensor_pos=est[fid][:3, 3])
    filt = dict(time_filter=True, travel_dist=lf.travel_dist,
                cur_ts=lf.cur_ts, local_window_dist=lf.local_window_dist,
                reboot_ts=lf.reboot_ts, use_mid_ts=qp.use_mid_ts)
    travel = system._tensor(system.travel_dist[: system.max_frames])
    live = torch.arange(s.capacity, device=dev) < cnt

    def whole_set():
        return kj.build_local_set(s.positions, live, c.voxel_size_m,
                                  max(1, -(-cnt // kj.TL)) * kj.TL)

    shapes = (
        ("tracker", src, dict(filt, radius_filter=True,
                              sensor_pos=lf.sensor_pos,
                              local_map_radius=lf.local_map_radius), 12,
         lambda: system.build_lset_track(travel, fid, lf.sensor_pos,
                                         system.reboot_ts)[0]),
        ("train", batch, filt, qp.nn_k + 2,
         lambda: system.build_lset_train(travel, fid, system.reboot_ts)),
        ("mesher", grid, {}, qp.nn_k, whole_set))
    table = []
    for name, q, kw, k_join, build in shapes:
        q = q.contiguous()

        def probe(mode):
            return npm.query_neighbors(
                s, q, offsets=qp.offsets_np, resolution=qp.resolution,
                nn_k=qp.nn_k, max_dist2=qp.max_dist2, probe_mode=mode, **kw)

        with torch.no_grad():
            cells, brick = probe("cells"), probe("brick")
            cells_ms = cuda_time_ms(lambda: probe("cells"), 5)
            brick_ms = cuda_time_ms(lambda: probe("brick"), 5)
            lset = build()
            build_ms = cuda_time_ms(build, 5)
            knn_ms = cuda_time_ms(lambda: npm.query_neighbors_join(
                q, lset, nn_k=k_join, max_dist2=qp.join_max_dist2,
                resolution=qp.resolution), 5)
        count_differs = float((cells.nn_count != brick.nn_count)
                              .float().mean())
        sets = [torch.sort(torch.where(r.valid, r.idx,
                                       torch.full_like(r.idx, -1)), 1)[0]
                for r in (cells, brick)]
        agree = float((sets[0] == sets[1]).all(1).float().mean())
        with_nn = float((brick.nn_count > 0).float().mean())
        row = dict(shape=name, n=int(q.shape[0]), k=qp.nn_k, k_join=k_join,
                   cells_ms=cells_ms, brick_ms=brick_ms,
                   join_build_ms=build_ms, join_knn_ms=knn_ms,
                   join_ms=build_ms + knn_ms, nn_count_differs=count_differs,
                   sets_agree=agree)
        table.append(row)
        log(f"[probes] {name}: N={row['n']} (k={qp.nn_k}; join k={k_join}; "
            f"{with_nn:.3f} with neighbours) | cells {cells_ms:.3f} ms, "
            f"brick {brick_ms:.3f} ms, join {row['join_ms']:.3f} ms (set "
            f"build {build_ms:.3f} + k-NN call {knn_ms:.3f}: query sort, "
            f"tile table and kernel) | brick vs cells: "
            f"nn_count differs on {count_differs:.4f}, sets agree on "
            f"{agree:.4f}")
        if name != "mesher" and not (count_differs < 0.15 and agree > 0.9):
            raise AssertionError(
                f"{name}: the brick and cell probes disagree past the JAX "
                f"package's bounds (nn_count {count_differs}, sets {agree})")
    return table


def phase_probes(frames, poses, scene_sdf, dev):
    """`[probes]`: the bench configuration (weighted_first=False, the floor
    kept) over the same frames under the join, cell and brick probes; the
    brick run's map meshed at 0.3 m through the fused decode (its
    lset-less queries through the brick probe); the three probes timed on
    that map. Returns (knn launches, fused-decode launches, figures)."""
    import torch
    from pin_slam_tpu_torch.ops import fused_decode as fd
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.slam.mesher import MeshConfig, Mesher
    from pin_slam_tpu_torch.utils.eval_mesh import sample_mesh_points

    runs, knn, fdl = {}, 0, 0
    for mode in ("join", "cells", "brick"):
        system, res = run_probe_mode(mode, frames, poses, dev)
        runs[mode] = res
        knn += res["knn"]
        fdl += res["fd"]
        if mode != "brick":
            del system
    if runs["cells"]["knn"] or runs["brick"]["knn"]:
        raise AssertionError("a hash-probe run launched the k-NN kernel")
    if runs["join"]["knn"] <= 0:
        raise AssertionError("the join run never launched the k-NN kernel")

    c = system.config
    mesher = Mesher(system.qp, MeshConfig(
        mc_res_m=c.mc_res_m, pad_voxel=c.pad_voxel,
        skip_top_voxel=c.skip_top_voxel, mc_mask_on=c.mc_mask_on,
        mesh_min_nn=c.mesh_min_nn,
        min_cluster_vertices=c.min_cluster_vertices,
        infer_bs=c.infer_bs_final, chunk_m=c.mc_res_m * 200))
    fd.LAUNCHES = 0
    kj.LAUNCHES = 0
    t0 = time.time()
    verts, faces = mesher.recon_map_mesh(
        system.state, system.params["geo_features"],
        system.params["geo_mlp"], filter_isolated=False)
    torch.cuda.synchronize()
    mesh_s = time.time() - t0
    mesh_fd = fd.LAUNCHES
    fdl += mesh_fd
    if kj.LAUNCHES or mesh_fd <= 0 or mesh_fd != mesher.n_batches \
            or mesher.decode_route != "fused_decode":
        raise AssertionError(
            f"the brick map's mesh ran {mesher.n_batches} batches on the "
            f"{mesher.decode_route} route with {mesh_fd} fused_decode and "
            f"{kj.LAUNCHES} knn_join launches")
    if verts.shape[0] == 0:
        raise AssertionError("the brick map's mesh is empty")
    dist = np.abs(scene_sdf(sample_mesh_points(verts, faces, MESH_SAMPLES,
                                               seed=0)))
    median = float(np.median(dist))
    log(f"[probes] mesh of the brick run's map at {c.mc_res_m} m: "
        f"{mesher.n_batches} grid batches = {mesh_fd} fused_decode "
        f"launches, {verts.shape[0]} vertices in {mesh_s:.2f} s (query "
        f"{mesher.query_seconds / mesher.n_batches * 1e3:.1f} ms/batch); "
        f"median distance to the scene {median:.4f} m (bound "
        f"{MAX_MESH_MEDIAN_M} m)")
    if median > MAX_MESH_MEDIAN_M:
        raise AssertionError(f"the brick map's mesh lies a median {median} "
                             "m from the scene")
    est = system.pgo_poses[: len(frames)]
    table = time_probes(system, frames, est, dev)
    del system
    torch.cuda.empty_cache()
    return knn, fdl, dict(runs=runs, probes=table, mesh_median_m=median)


def phase_options(frames, poses, dev):
    """`[options]`: the bench configuration of `[probes]` on the join probe
    with incidence labels (mode "label") and the consistency loss. Returns
    (knn launches, fused-decode launches, figures)."""
    import torch

    system, res = run_probe_mode("join", frames, poses, dev,
                                 incidence_label_on=True,
                                 incidence_mode="label",
                                 consistency_loss_on=True)
    if res["knn"] <= 0:
        raise AssertionError("[options] never launched the k-NN kernel")
    cos, mask = system.last_incidence
    cos = cos[mask]
    c = system.config
    below = float((cos < 1.0).float().mean())
    at_floor = float((cos <= c.incidence_cos_floor).float().mean())
    median = float(cos.median())
    cons = system.last_train_terms["consistency_loss"]
    res.update(cos_below_1=below, cos_median=median, cos_at_floor=at_floor,
               consistency_last=float(cons[-1]))
    log(f"[options] frame {len(frames) - 1}'s training cloud: "
        f"{int(mask.sum())} points, incidence cos < 1 on {below:.4f}, "
        f"median {median:.4f}, at the floor {c.incidence_cos_floor} on "
        f"{at_floor:.4f}; consistency term at the last iteration "
        f"{float(cons[-1]):.5f} (first {float(cons[0]):.5f}, weight "
        f"{c.weight_c}, {c.consistency_count} samples)")
    if not (0.0 < below and np.isfinite(median)
            and bool(torch.isfinite(cons).all())):
        raise AssertionError("[options]: no incidence correction or a "
                             "non-finite consistency term")
    del system
    torch.cuda.empty_cache()
    return res["knn"], res["fd"], res


def phase_dp(slice_system, mesh_system, mesh_mesher, frames, poses, dev):
    """Data parallelism on the one card, with DP_REPLICAS replicas on it
    (`["cuda:0"] * 2`, parallel/dp.make_mesh):
    1. the DP training loop (`make_train_loop(mesh=)`, the whole-map route:
       bench bs 16384 a replica, DP_ITERS iterations, every tensor trained)
       on `[slice]`'s final map, held against a sequential mimic of
       tests/test_parallel.py's: each replica's gradient on its own draws,
       their average, one Adam step (losses, features and decoder to rtol
       1e-4 / atol 1e-5, certainty to 1e-4, update timestamps equal), and
       timed against one replica's loop at the same effective batch;
    2. the sharded Mesher over `[mesh]`'s map: every grid of its mesh
       equal, bit for bit, to the unsharded mesher's, the fused decode
       launched DP_REPLICAS times a grid batch;
    3. a `dp_on` system over VIEWER_FRAMES bench frames with one visible
       card: `mesh` None, its poses and map bit-equal to a system without
       `dp_on`.
    Returns both kernels' launches on this path and the figures."""
    import torch
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.models import neural_points as npm
    from pin_slam_tpu_torch.ops import fused_decode as fd
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.parallel import dp
    from pin_slam_tpu_torch.slam import mapper as mp
    from pin_slam_tpu_torch.slam.mesher import Mesher
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    reps = dp.make_mesh(devices=[dev] * DP_REPLICAS)
    sysm, c = slice_system, slice_system.config
    R = len(reps)
    kw = sysm._loss_kwargs
    lf = sysm._lf(sysm.cur_frame - 1)
    pool = sysm.pool
    use_new = torch.tensor(False, device=dev)
    draws = [mp.draw_train_indices(
        torch.Generator(device=dev).manual_seed(100 + r), pool,
        n_iters=DP_ITERS, bs=c.bs, bs_new=0, subset_hist=0, whole_map=True)
        for r in range(R)]

    def fresh():
        st = _clone_fields(sysm.state)
        return {"geo_features": st.geo_features,
                "geo_mlp": {k: [t.clone() for t in v] for k, v in
                            sysm.params["geo_mlp"].items()}}, st

    kj.LAUNCHES = 0
    fd.LAUNCHES = 0
    loop = mp.make_train_loop(sysm.qp, lr=c.lr, adam_eps=c.adam_eps,
                              n_iters=DP_ITERS, bs=c.bs, bs_new=0,
                              train_decoder=True, loss_kwargs=kw, mesh=reps)
    p_dp, st_dp = fresh()
    p_dp, st_dp, losses_dp = loop(p_dp, st_dp, pool, None, use_new, None,
                                  draws=draws, lf=lf)
    # the sequential mimic: R gradients on the replicas' draws, averaged,
    # one Adam step; each replica's certainty added in turn
    p_m, st_m = fresh()
    feats = st_m.geo_features.detach().clone().requires_grad_(True)
    mlp = {k: [t.clone().requires_grad_(True) for t in v]
           for k, v in p_m["geo_mlp"].items()}
    leaves = [feats] + mlp["w"] + mlp["b"]
    opt = torch.optim.Adam(leaves, lr=c.lr, betas=(0.9, 0.999),
                           eps=c.adam_eps)
    losses_m = []
    for i in range(DP_ITERS):
        gsum, lsum = None, 0.0
        for r in range(R):
            idx = draws[r]["hist"][i]
            batch = {"coord": pool.coord[idx],
                     "sdf_label": pool.sdf_label[idx],
                     "weight": pool.weight[idx], "ts": pool.ts[idx]}
            loss, aux = mp.mapping_loss(feats, mlp, batch, idx < pool.count,
                                        None, None, None, sysm.qp,
                                        state=st_m, lf=lf, **kw)
            g = torch.autograd.grad(loss, leaves)
            gsum = list(g) if gsum is None else [a + b for a, b in
                                                 zip(gsum, g)]
            lsum += float(loss.detach())
            with torch.no_grad():
                npm.accumulate_certainty(st_m, aux["qn"], aux["w"].detach(),
                                         aux["ts"])
        for leaf, g in zip(leaves, gsum):
            leaf.grad = g / R
        opt.step()
        losses_m.append(lsum / R)
    torch.cuda.synchronize()

    def close(a, b, rtol, atol):
        a, b = (torch.as_tensor(x, device=dev).float() for x in (a, b))
        excess = (a - b).abs() - (atol + rtol * b.abs())
        return float(excess.max()) <= 0.0, float((a - b).abs().max())

    checks = {"losses": close(losses_dp, losses_m, 1e-4, 1e-5),
              "features": close(st_dp.geo_features, feats.detach(), 1e-4,
                                1e-5),
              "decoder": min((close(a, b.detach(), 1e-4, 1e-5) for a, b in
                              zip(p_dp["geo_mlp"]["w"] + p_dp["geo_mlp"]["b"],
                                  mlp["w"] + mlp["b"])),
                             key=lambda t: t[0]),
              "certainty": close(st_dp.certainty, st_m.certainty, 1e-4,
                                 1e-4),
              "ts_update": (bool(torch.equal(st_dp.ts_update,
                                             st_m.ts_update)), 0.0)}
    log(f"[dp] DP loop, {R} replicas on {dev} x {c.bs} samples, "
        f"{DP_ITERS} iterations, whole-map route, losses "
        f"{[round(float(v), 6) for v in losses_dp]}; against the "
        f"sequential mimic: " + ", ".join(
            f"{k} {'ok' if ok else 'DIFFERS'} (max |diff| {d:.3g})"
            for k, (ok, d) in checks.items()))
    if not all(ok for ok, _ in checks.values()):
        raise AssertionError(f"[dp] the DP loop departs from the mimic: "
                             f"{checks}")
    single = mp.make_train_loop(sysm.qp, lr=c.lr, adam_eps=c.adam_eps,
                                n_iters=DP_ITERS, bs=R * c.bs, bs_new=0,
                                train_decoder=True, loss_kwargs=kw)
    draws1 = mp.draw_train_indices(
        torch.Generator(device=dev).manual_seed(99), pool,
        n_iters=DP_ITERS, bs=R * c.bs, bs_new=0, subset_hist=0,
        whole_map=True)
    p_t, st_t = fresh()
    dp_ms = cuda_time_ms(lambda: loop(p_t, st_t, pool, None, use_new, None,
                                      draws=draws, lf=lf), 3)
    one_ms = cuda_time_ms(lambda: single(p_t, st_t, pool, None, use_new,
                                         None, draws=draws1, lf=lf), 3)
    log(f"[dp] a {DP_ITERS}-iteration training run (CUDA events around the "
        f"call): {R} replicas x {c.bs} samples {dp_ms:.2f} ms, one replica "
        f"x {R * c.bs} samples {one_ms:.2f} ms")
    del p_dp, st_dp, p_m, st_m, feats, mlp, leaves, opt, p_t, st_t

    # the sharded mesher over [mesh]'s map, grid by grid
    ms = mesh_system
    args = (ms.state, ms.params["geo_features"], ms.params["geo_mlp"])
    plain = Mesher(ms.qp, mesh_mesher.mc)
    sharded = Mesher(ms.qp, mesh_mesher.mc, mesh=reps)
    cnt = int(ms.state.count)
    pos = ms.state.positions[:cnt]
    chunks = plain.split_chunks(pos.amin(0).cpu().numpy(),
                                pos.amax(0).cpu().numpy(), plain.mc.chunk_m)
    same, n_grid, t_plain, t_sharded, fd_sharded = True, 0, 0.0, 0.0, 0
    for lo, hi in chunks:
        origin, dims = plain.aabb_grid(lo, hi)
        n_grid += int(np.prod(dims))
        t0 = time.time()
        a = plain.query_sdf_grid(*args, origin, dims)
        torch.cuda.synchronize()
        t1 = time.time()
        f0 = fd.LAUNCHES
        b = sharded.query_sdf_grid(*args, origin, dims)
        torch.cuda.synchronize()
        fd_sharded += fd.LAUNCHES - f0
        t_plain += t1 - t0
        t_sharded += time.time() - t1
        same &= all(np.array_equal(x, y) for x, y in zip(a, b))
    log(f"[dp] sharded mesher over [mesh]'s map ({cnt} points, "
        f"{len(chunks)} chunks, {n_grid} grid points): {sharded.n_batches} "
        f"grid batches, {fd_sharded} fused_decode launches "
        f"({R} a batch: {fd_sharded == R * sharded.n_batches}), grids "
        f"bit-equal to the unsharded mesher's: {same}; query and pull "
        f"{t_sharded:.3f} s sharded, {t_plain:.3f} s unsharded")
    if not same:
        raise AssertionError("[dp] the sharded mesher's grid differs from "
                             "the unsharded one")
    if sharded.decode_route != "fused_decode" \
            or fd_sharded != R * sharded.n_batches:
        raise AssertionError(f"[dp] {fd_sharded} fused decode launches for "
                             f"{sharded.n_batches} batches of {R} replicas")
    del plain, sharded

    # dp_on with one visible card is the single-card run
    runs = {}
    for on in (True, False):
        cfg = bench_config(Config)
        cfg.dp_on = on
        system = PinSLAMSystem(cfg, device=dev)
        system.set_gt_poses(poses)
        est = [system.process_frame(f, frames[f], next_points=frames[f + 1])
               for f in range(VIEWER_FRAMES)]
        runs[on] = (system, np.stack(est))
    (s_on, est_on), (s_off, est_off) = runs[True], runs[False]
    cnt = int(s_on.state.count)
    same_map = cnt == int(s_off.state.count) and all(
        torch.equal(getattr(s_on.state, f)[:cnt], getattr(s_off.state, f)[:cnt])
        for f in ("positions", "geo_features", "certainty", "ts_update")) \
        and all(torch.equal(a, b) for a, b in zip(
            s_on.params["geo_mlp"]["w"] + s_on.params["geo_mlp"]["b"],
            s_off.params["geo_mlp"]["w"] + s_off.params["geo_mlp"]["b"]))
    knn_launches, fd_launches = kj.LAUNCHES, fd.LAUNCHES
    log(f"[dp] dp_on with {torch.cuda.device_count()} visible card(s) over "
        f"{VIEWER_FRAMES} bench frames: mesh {s_on.mesh}, poses bit-equal "
        f"to dp_on off: {np.array_equal(est_on, est_off)}, map and decoder "
        f"bit-equal: {same_map} ({cnt} points); path launches knn_join "
        f"{knn_launches}, fused_decode {fd_launches}")
    if s_on.mesh is not None or not np.array_equal(est_on, est_off) \
            or not same_map:
        raise AssertionError("[dp] dp_on on one card is not the single-card "
                             "run")
    return knn_launches, fd_launches, dict(dp_ms=dp_ms, one_ms=one_ms,
                                           checks=checks)


def viewer_yaml(root):
    """run_yaml's run_kitti.yaml with the file visualizer on (its local
    meshes and, where matplotlib is installed, its SDF slices every
    VIEWER_FREQ frames)."""
    import yaml
    path = run_yaml(root, "viewer")
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg.setdefault("eval", {}).update(
        mesh_default_on=True, mesh_freq_frame=VIEWER_FREQ,
        sdf_default_on=has_matplotlib(), sdf_freq_frame=VIEWER_FREQ)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def has_matplotlib():
    import importlib.util
    return importlib.util.find_spec("matplotlib") is not None


def phase_viewer(frames, seq, root):
    """run_kitti.yaml through the entry point with the viewer: `python -m
    pin_slam_tpu_torch.run <yaml> -o <dir> -v --range 0 10 1` over `[run]`'s
    swept frames on disk, mesh_default_on and (with matplotlib)
    sdf_default_on every VIEWER_FREQ frames. Returns both kernels'
    launches and the figures."""
    import torch
    import pin_slam_tpu_torch.gui as tgui
    from pin_slam_tpu_torch import run as trun
    from pin_slam_tpu_torch.ops import fused_decode as fd
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.slam.mesher import MeshConfig, Mesher

    n = len(frames)
    gt = mid_scan_poses(seq)[:n]
    write_run_dataset(root, frames, gt)
    mpl = has_matplotlib()
    cfg_path = viewer_yaml(root)
    out_dir = os.path.join(root, "viewer_out")
    seen = {"procs": [], "packets": []}
    start = tgui.start_viewer

    def start_checked(*a, **k):
        proc, q_m2v, q_v2m = start(*a, **k)
        seen["procs"].append(proc)

        class Checked:
            def put(self, pkt):
                seen["packets"].append(packet_host_only(pkt))
                q_m2v.put(pkt)
        return proc, Checked(), q_v2m

    log(f"[viewer] matplotlib {'installed' if mpl else 'not installed'}: "
        + ("PNG renders and SDF slices on" if mpl else
           "the viewer writes gui/latest.npz without PNG renders, "
           "sdf_default_on is left off; the SDF slice is checked through "
           "Mesher.sdf_slice after the run"))
    aabb = Mesher.recon_aabb_mesh

    def recon_aabb(mesher, *a, **k):
        seen.setdefault("meshers", []).append(mesher)
        return aabb(mesher, *a, **k)

    t0 = time.time()
    tgui.start_viewer = start_checked
    Mesher.recon_aabb_mesh = recon_aabb
    try:
        with SystemSpy() as spy:
            kj.LAUNCHES = 0
            fd.LAUNCHES = 0
            trun.main([cfg_path, "-o", out_dir, "-v", "--range", "0",
                       str(n), "1"])
            knn_launches, fd_launches = kj.LAUNCHES, fd.LAUNCHES
    finally:
        tgui.start_viewer = start
        Mesher.recon_aabb_mesh = aabb
    torch.cuda.synchronize()
    wall = time.time() - t0
    vm = seen["meshers"][0]
    run_dir = os.path.join(out_dir, sorted(os.listdir(out_dir))[0])
    system = spy.system
    proc, = seen["procs"]
    latest = np.load(os.path.join(run_dir, "gui", "latest.npz"))
    odom, err = pose_errors(os.path.join(run_dir, "odom_poses_kitti.txt"),
                            gt)
    vis = sorted(os.listdir(os.path.join(run_dir, "vis")))
    gui = sorted(os.listdir(os.path.join(run_dir, "gui")))
    mesh_path = os.path.join(run_dir, "vis", f"mesh_{VIEWER_FREQ:05d}.ply")
    from pin_slam_tpu_torch.dataset.io import read_ply
    verts = read_ply_vertices(mesh_path) if os.path.exists(mesh_path) \
        else np.zeros((0, 3))
    med = float(np.median(np.abs(seq.scene_sdf(verts.astype(np.float64))))) \
        if len(verts) else float("inf")
    npts = len(read_ply(os.path.join(run_dir, "vis",
                                     "neural_points_pca.ply"))["x"])
    steady = np.asarray(spy.secs[1:]) * 1e3
    log(f"[viewer] run_kitti.yaml with -v through the entry point: {n} "
        f"frames in {wall:.1f} s (the run, the local meshes, the viewer's "
        f"start and stop); process_frame median {np.median(steady):.1f} ms; "
        f"packets sent {len(seen['packets'])} (frames "
        f"{[p for p in seen['packets'] if p is not None]}), all numpy; viewer "
        f"process alive after stop_viewer: {proc.is_alive()} (exit code "
        f"{proc.exitcode}); latest.npz frame {int(latest['frame_id'])}; "
        f"vis/ {vis}; gui/ {gui}; knn_join launches {knn_launches}, "
        f"fused_decode {fd_launches}; local mesh at frame {VIEWER_FREQ}: "
        f"{vm.n_batches} grid batches of <= {vm.mc.infer_bs}, query "
        f"{vm.query_seconds:.2f} s, marching {vm.marching_seconds:.2f} s, "
        f"{len(verts)} vertices, median distance to the scene {med:.4f} m "
        f"(bound {MAX_MESH_MEDIAN_M} m); neural_points_pca.ply {npts} points,"
        f" map {int(system.state.count)}")
    if proc.is_alive():
        raise AssertionError("[viewer] the viewer process outlived "
                             "stop_viewer")
    if int(latest["frame_id"]) != n - 1 or not np.allclose(
            latest["odom_poses"], odom, atol=1e-6, rtol=0):
        raise AssertionError("[viewer] latest.npz does not hold the last "
                             "frame's odometry")
    if len(verts) == 0 or med > MAX_MESH_MEDIAN_M:
        raise AssertionError(f"[viewer] local mesh of {len(verts)} vertices,"
                             f" median {med} m off the scene")
    if npts != int(system.state.count):
        raise AssertionError(f"[viewer] neural_points_pca.ply holds {npts} "
                             f"points, the map {int(system.state.count)}")
    if knn_launches <= 0:
        raise AssertionError("[viewer] the run never launched the knn_join "
                             "kernel")
    check_drift(err, 0.09 * n)
    if mpl:
        want_png = [f"sdf_slice_{f:05d}.png" for f in range(0, n,
                                                             VIEWER_FREQ)]
        if not set(want_png) <= set(vis) or not any(
                g.startswith("view_") for g in gui):
            raise AssertionError(f"[viewer] PNGs missing: {vis}, {gui}")
    else:
        c = system.config
        mesher = Mesher(system.qp, MeshConfig(mc_res_m=c.mc_res_m,
                                              infer_bs=c.infer_bs_final))
        center = system.cur_pose_ref[:3, 3]
        xs, ys, sdf = mesher.sdf_slice(
            system.state, system.params["geo_features"],
            system.params["geo_mlp"], center, extent=20.0,
            height=center[2] + c.sdf_slice_height, res=c.vis_sdf_res_m)
        log(f"[viewer] SDF slice through Mesher.sdf_slice: {sdf.shape}, "
            f"finite {bool(np.isfinite(sdf).all())}, range "
            f"{sdf.min():.3f} .. {sdf.max():.3f} m")
        if not np.isfinite(sdf).all():
            raise AssertionError("[viewer] the SDF slice is not finite")
    return knn_launches, fd_launches, dict(
        wall_s=wall, ms=float(np.median(steady)), mesh_vertices=len(verts),
        mesh_median_m=med, matplotlib=mpl)


def packet_host_only(pkt):
    """The packet's frame id, after checking that no field holds a torch
    tensor (a pickled one would import torch in the viewer process)."""
    import torch

    def walk(obj, path):
        if isinstance(obj, torch.Tensor):
            raise AssertionError(f"[viewer] {path} is a torch tensor")
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{path}[{i}]")
        elif hasattr(obj, "__dict__"):
            for k, v in vars(obj).items():
                walk(v, f"{path}.{k}")
    walk(pkt, "packet")
    return pkt.frame_id


class RosMsg:
    """A ROS message stand-in: keyword fields, nested fields made on first
    access."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        v = RosMsg()
        setattr(self, name, v)
        return v


def ros_stub_modules(log_):
    """Stand-ins for rospy, nav_msgs, geometry_msgs, sensor_msgs, tf2_ros
    and std_srvs (the card's machine has no ROS): publishers, the TF
    broadcaster and the services record into `log_`, the subscriber's
    callback lands in log_["callback"]."""
    import types
    rospy = types.ModuleType("rospy")

    class Publisher:
        def __init__(self, name, kind, queue_size=1):
            self.name = name
            log_.setdefault(name, [])

        def publish(self, msg):
            log_[self.name].append(msg)

    def subscriber(topic, kind, callback, queue_size=1):
        log_["callback"] = callback

    def service(name, kind, handler):
        log_.setdefault("services", {})[name] = handler

    rospy.init_node = lambda name: None
    rospy.Publisher = Publisher
    rospy.Subscriber = subscriber
    rospy.Service = service
    rospy.Timer = lambda period, fn: None
    rospy.Duration = lambda sec: sec
    rospy.Time = types.SimpleNamespace(now=lambda: 0.0)
    rospy.signal_shutdown = lambda why: None
    rospy.spin = lambda: None

    class Broadcaster:
        def sendTransform(self, t):
            log_.setdefault("tf", []).append(t)

    tf2 = types.ModuleType("tf2_ros")
    tf2.TransformBroadcaster = Broadcaster
    mods = {"rospy": rospy, "tf2_ros": tf2}
    for pkg, sub, kinds in (
            ("nav_msgs", "msg", ("Odometry", "Path")),
            ("geometry_msgs", "msg", ("PoseStamped", "TransformStamped")),
            ("sensor_msgs", "msg", ("PointCloud2", "PointField")),
            ("std_srvs", "srv", ("Trigger", "TriggerResponse"))):
        mod = types.ModuleType(f"{pkg}.{sub}")
        for k in kinds:
            setattr(mod, k, type(k, (RosMsg,), {}))
        mods[pkg] = types.ModuleType(pkg)
        setattr(mods[pkg], sub, mod)
        mods[f"{pkg}.{sub}"] = mod
    return mods


def phase_ros(bag_path, seq, root, dev):
    """The ROS node (`PINSLAMRosNode`, config/lidar_slam/run_ncd_128_s.yaml
    as shipped) fed the first ROS_FRAMES PointCloud2 messages of `[bag]`'s
    bag through its frame callback, under the stand-in ROS modules of
    `ros_stub_modules`. Returns both kernels' launches and the figures."""
    import torch
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.dataset import rosbag1
    from pin_slam_tpu_torch.ops import fused_decode as fd
    from pin_slam_tpu_torch.ops import knn_join as kj
    from pin_slam_tpu_torch.ops.transforms import np_rotmat_to_quat
    from pin_slam_tpu_torch.utils.map_io import load_implicit_map

    reader = rosbag1.Bag1Reader(bag_path)
    msgs = []
    for _, raw in reader.iter_topic(BAG_TOPIC):
        msgs.append(rosbag1.deserialize_pointcloud2(raw))
        if len(msgs) == ROS_FRAMES:
            break
    gt_abs = mid_scan_poses(seq)[:ROS_FRAMES]
    gt = np.linalg.inv(gt_abs[0]) @ gt_abs
    log_ = {}
    stubs = ros_stub_modules(log_)
    saved = {k: sys.modules.get(k) for k in stubs}
    sys.modules.update(stubs)
    try:
        from pin_slam_tpu_torch.pin_slam_ros import PINSLAMRosNode
        cfg = Config().load(os.path.join(ROOT, "config", "lidar_slam",
                                         "run_ncd_128_s.yaml"))
        cfg.run_path = os.path.join(root, "ros_out")
        torch.cuda.reset_peak_memory_stats()
        node = PINSLAMRosNode(cfg, BAG_TOPIC)
        poses, secs, lost = [], [], []
        kj.LAUNCHES = 0
        fd.LAUNCHES = 0
        for i, m in enumerate(msgs):
            t0 = time.time()
            log_["callback"](m)
            secs.append(time.time() - t0)
            poses.append(node.system.cur_pose_ref.copy())
            if i > 0 and not bool(node.system.last_tracking.valid):
                lost.append(i)
        knn_launches, fd_launches = kj.LAUNCHES, fd.LAUNCHES
        res = log_["services"]["~save_results"](None)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    poses = np.stack(poses)
    err = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    odom = log_["~odometry"]
    same_pose = len(odom) == ROS_FRAMES and all(
        (o.pose.pose.position.x, o.pose.pose.position.y,
         o.pose.pose.position.z) == tuple(T[:3, 3])
        and [o.pose.pose.orientation.w, o.pose.pose.orientation.x,
             o.pose.pose.orientation.y, o.pose.pose.orientation.z]
        == [float(v) for v in np_rotmat_to_quat(T[:3, :3])]
        for o, T in zip(odom, poses))
    state = node.system.state
    cnt = int(state.count)
    st, dec, _ = load_implicit_map(os.path.join(cfg.run_path, "pin_map.npz"),
                                   device=dev)
    same_map = int(st.count) == cnt and all(
        torch.equal(getattr(st, f)[:cnt], getattr(state, f)[:cnt])
        for f in ("positions", "orientations", "geo_features", "ts_create",
                  "ts_update", "certainty")) and all(
        torch.equal(a, b) for a, b in zip(
            dec["geo_mlp"]["w"] + dec["geo_mlp"]["b"],
            node.system.params["geo_mlp"]["w"]
            + node.system.params["geo_mlp"]["b"]))
    log(f"[ros] PINSLAMRosNode with run_ncd_128_s.yaml, {ROS_FRAMES} "
        f"PointCloud2 messages of the bag through frame_callback: "
        f"{np.median(secs[1:]) * 1e3:.1f} ms a message (median after the "
        f"first); published {len(odom)} Odometry, {len(log_['~path'])} "
        f"Path, {len(log_.get('tf', []))} TF, "
        f"{len(log_['~neural_points'])} map and {len(log_['~frame'])} "
        f"frame clouds; Odometry = the system's pose and np_rotmat_to_quat: "
        f"{same_pose}; pose error against the mid-scan truth max "
        f"{err.max() * 100:.2f} cm (gate {0.09 * ROS_FRAMES * 100:.0f} cm);"
        f" knn_join launches {knn_launches}, fused_decode {fd_launches}; "
        f"save_results: {res.success}, pin_map.npz reads back bit-equal: "
        f"{same_map} ({cnt} points); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if lost:
        raise AssertionError(f"[ros] the tracker lost track in messages "
                             f"{lost}")
    if not same_pose:
        raise AssertionError("[ros] a published Odometry is not the "
                             "system's pose")
    check_drift(err, 0.09 * ROS_FRAMES)
    if knn_launches <= 0:
        raise AssertionError("[ros] the node never launched the knn_join "
                             "kernel")
    if not (res.success and same_map):
        raise AssertionError("[ros] save_results did not write the map")
    return knn_launches, fd_launches, dict(
        ms=float(np.median(secs[1:]) * 1e3), max_err_m=float(err.max()))


def make_frames(pool, fn, args):
    """fn over args in the pool's spawned worker processes (frame i of a
    sequence)."""
    t0 = time.time()
    frames = pool.map(fn, args)
    first = frames[0][0] if isinstance(frames[0], tuple) else frames[0]
    log(f"[data] {len(frames)} frames of {fn.__name__}, "
        f"{int(np.prod(first.shape[:-1]))} points in frame 0, "
        f"{time.time() - t0:.1f} s")
    return frames


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="comma-separated phases (slice, mesh, dp, probes, "
                    "options, loop, ba, dynamic, color, semantic, run, "
                    "localize, viewer, bag, ros) after the kernel checks; "
                    "prints no result")
    only = [p for p in ap.parse_args().only.split(",") if p]
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pin_slam_tpu_torch.ops import cuda_build

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

    # one pool of spawned workers ray-casts every phase's frames
    pool = get_context("spawn").Pool(min(8, os.cpu_count() or 1))
    try:
        return run_phases(only, dev, pool)
    finally:
        pool.terminate()
        pool.join()


def run_phases(only, dev, pool):
    """The kernel checks and the phases (all, or those `only` names), then
    the result lines when all ran."""
    import torch

    def want(phase):
        return not only or phase in only

    seq = make_sequence(N_FRAMES)
    frames = make_frames(pool, _frame, range(N_FRAMES))
    kres = phase_kernels(frames, seq.poses, dev)
    fres = phase_fused_decode(dev)
    out = {}
    if want("slice") or want("dp"):
        out["slice"], slice_res = phase_slice(frames, seq.poses, dev)
    if want("mesh") or want("dp"):
        knn_me, fd_me, mesh_system, mesh_mesher = phase_mesh(
            frames, seq.poses, seq.scene_sdf, dev)
        out["mesh"] = (knn_me, fd_me)
    if want("dp"):
        knn_dp, fd_dp, _ = phase_dp(slice_res["system"], mesh_system,
                                    mesh_mesher, frames, seq.poses, dev)
        out["dp"] = (knn_dp, fd_dp)
    if want("slice") or want("dp"):
        del slice_res
    if want("mesh") or want("dp"):
        del mesh_system, mesh_mesher
    torch.cuda.empty_cache()
    if want("probes"):
        knn_pr, fd_pr, _ = phase_probes(frames, seq.poses, seq.scene_sdf,
                                        dev)
        out["probes"] = (knn_pr, fd_pr)
    if want("options"):
        knn_op, fd_op, _ = phase_options(frames, seq.poses, dev)
        out["options"] = (knn_op, fd_op)
    del frames
    torch.cuda.empty_cache()
    if want("loop"):
        lseq = make_loop_sequence()
        loop_frames = make_frames(pool, _loop_frame,
                                  [(i, {}) for i in range(LOOP_FRAMES)])
        out["loop"], _ = phase_loop(loop_frames, lseq.poses, dev)
        del loop_frames
        torch.cuda.empty_cache()
    if want("ba"):
        ba_frames = make_frames(pool, _ncd_frame, range(BA_FRAMES))
        out["ba"], _ = phase_ba(ba_frames, make_ncd_sequence().poses, dev)
        del ba_frames
        torch.cuda.empty_cache()
    if want("dynamic"):
        mseq, centers = make_mos_sequence()
        dyn_frames = make_frames(pool, _mos_frame, range(DYN_FRAMES))
        knn_dyn, fd_dyn, _ = phase_dynamic(dyn_frames, mseq.poses, centers,
                                           dev)
        out["dynamic"] = (knn_dyn, fd_dyn)
        del dyn_frames
        torch.cuda.empty_cache()
    if want("color") or want("semantic"):
        col_frames = make_frames(pool, _color_frame, range(COLOR_FRAMES))
    if want("color"):
        knn_col, fd_col, col_shape, _ = phase_color(
            col_frames, make_color_sequence().poses, dev)
        out["color"] = (knn_col, fd_col)
        kres.append(col_shape)
        torch.cuda.empty_cache()
    if want("semantic"):
        sseq, label_fn = make_sem_sequence()
        sem_frames, labels = sem_frames_from(col_frames, sseq.poses,
                                             label_fn)
        knn_sem, fd_sem, _ = phase_semantic(sem_frames, labels, sseq.poses,
                                            label_fn, dev)
        out["semantic"] = (knn_sem, fd_sem)
        del sem_frames
        torch.cuda.empty_cache()
    if want("color") or want("semantic"):
        del col_frames
    if want("run") or want("localize"):
        rseq = make_run_sequence()
        rframes = make_frames(pool, _run_frame, range(RUN_FRAMES))
        root = os.path.join(ROOT, "build", "chip_smoke_run")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        knn_run, fd_run, run_dir, run_res = phase_run(rframes, rseq, root)
        out["run"] = (knn_run, fd_run)
        torch.cuda.empty_cache()
        if want("localize"):
            knn_loc, fd_loc, loc_shape, _ = phase_localize(
                rframes, rseq, root, run_dir, run_res["ate_m"])
            out["localize"] = (knn_loc, fd_loc)
            kres.append(loc_shape)
        shutil.rmtree(root, ignore_errors=True)
    if want("viewer"):
        if not (want("run") or want("localize")):
            rseq = make_run_sequence()
            rframes = make_frames(pool, _run_frame, range(VIEWER_FRAMES))
        root = os.path.join(ROOT, "build", "chip_smoke_viewer")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        knn_vis, fd_vis, _ = phase_viewer(rframes[:VIEWER_FRAMES], rseq,
                                          root)
        out["viewer"] = (knn_vis, fd_vis)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    if want("run") or want("localize") or want("viewer"):
        del rframes
    if want("bag") or want("ros"):
        grids = make_frames(pool, bag_frame, range(
            BAG_FRAMES if want("bag") else ROS_FRAMES))
        root = os.path.join(ROOT, "build", "chip_smoke_bag")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        bag_path = write_ncd_bag(grids, os.path.join(root, "bag"))
        if want("bag"):
            knn_bag, fd_bag, _ = phase_bag(
                grids, make_ncd_sequence(BAG_FRAMES + 1), root)
            out["bag"] = (knn_bag, fd_bag)
        if want("ros"):
            knn_ros, fd_ros, _ = phase_ros(
                bag_path, make_ncd_sequence(BAG_FRAMES + 1), root, dev)
            out["ros"] = (knn_ros, fd_ros)
        del grids
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    if only:
        log(f"[only] {', '.join(only)}: done; a partial run prints no "
            "result")
        return 0

    tr = next(r for r in kres if r["shape"] == "tracker")
    me = next(r for r in fres if r["shape"] == "mesher")
    kernels = [{
        "name": "knn_join",
        "route": "cuda",
        "source": "pin_slam_tpu_torch/csrc/knn_join.cu",
        "replaces": "pin_slam_tpu/ops/knn_join.py:142",
        "launches": out["slice"],
        "max_abs_err": max(r["max_abs_err"] for r in kres),
        "ms": tr["ms"], "plain_ms": tr["plain_ms"],
        "bound_ms": tr["bound_ms"], "bound_by": tr["bound_by"],
        "library_ms": None,
        "max_visits": tr["max_visits"],
        "launches_mesh_path": out["mesh"][0],
        "launches_loop_path": out["loop"],
        "launches_ba_path": out["ba"],
        "launches_dynamic_path": out["dynamic"][0],
        "launches_color_path": out["color"][0],
        "launches_semantic_path": out["semantic"][0],
        "launches_run_path": out["run"][0],
        "launches_localize_path": out["localize"][0],
        "launches_bag_path": out["bag"][0],
        "launches_probes_path": out["probes"][0],
        "launches_options_path": out["options"][0],
        "launches_viewer_path": out["viewer"][0],
        "launches_dp_path": out["dp"][0],
        "launches_ros_path": out["ros"][0],
        "shapes": {r["shape"]: {k: r[k] for k in (
            "n", "k", "visits", "max_visits", "distances",
            "longest_row_distances", "ms", "plain_ms", "bound_ms",
            "bound_by")}
            for r in kres},
    }, {
        "name": "fused_decode",
        "route": "cuda",
        "source": "pin_slam_tpu_torch/csrc/fused_decode.cu",
        "replaces": "pin_slam_tpu/ops/pallas_decode.py:31",
        "launches": out["mesh"][1],
        "launches_dynamic_path": out["dynamic"][1],
        "launches_color_path": out["color"][1],
        "launches_semantic_path": out["semantic"][1],
        "launches_run_path": out["run"][1],
        "launches_localize_path": out["localize"][1],
        "launches_bag_path": out["bag"][1],
        "launches_probes_path": out["probes"][1],
        "launches_options_path": out["options"][1],
        "launches_viewer_path": out["viewer"][1],
        "launches_dp_path": out["dp"][1],
        "launches_ros_path": out["ros"][1],
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
