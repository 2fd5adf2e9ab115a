"""The port's entry point (pin_slam_tpu_torch.run) end to end on the CPU:
tests/test_cli_e2e.py's dataset on disk (6 frames, 256 x 16 rays, PLY
scans, KITTI poses) -> run_pin_slam(cpu_only=True, save_map=True,
save_mesh=True) -> the same artifacts as the JAX package's CLI, ATE below
its 0.3 m bound, poses that round-trip, offline remeshing with vis_pin_map,
a saved map that the JAX package loads, localization against that map
through `load_model`, and a run from a ROS1 bag of swept scans with deskew
(`rosbag -i <dir> -d --deskew`).

The YAML is test_cli_e2e.py's with the training cut for the CPU: batch 1024
(4096), 10 iterations a frame and 20x on the first (12, 20x), a 4096-point
training subset and a 2048-point source cloud (the port's plain k-NN walks
every training query on the CPU), source voxel 0.5 m (0.4) and mc_res_m
0.5 m (0.3, a 30 cm final mesh)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from pin_slam_tpu.utils.map_io import load_implicit_map as j_load
from pin_slam_tpu_torch import run as trun
from pin_slam_tpu_torch.dataset.io import (
    read_kitti_format_poses,
    write_kitti_format_poses,
    write_ply_points,
)
from pin_slam_tpu_torch.dataset.rosbag1 import write_bag1
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence,
    circle_trajectory,
    default_scene,
    lidar_directions,
)

ATE_BOUND_M = 0.3      # tests/test_cli_e2e.py's
BAG_FRAMES = 5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def disk_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_torch")
    pc_dir = root / "ply"
    pc_dir.mkdir()
    seq = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(6, radius=6.0, revolutions=0.05,
                                ease_in_frames=3),
        dirs=lidar_directions(256, 16),
        max_range=60.0)
    for i in range(len(seq)):
        write_ply_points(str(pc_dir / f"{i:06d}.ply"), seq.frame(i))
    write_kitti_format_poses(str(root / "poses.txt"), seq.poses)
    cfg = {
        "setting": {"name": "cli_e2e", "output_root": str(root / "out"),
                    "pc_path": str(pc_dir),
                    "pose_path": str(root / "poses.txt")},
        "process": {"min_range_m": 0.5, "max_range_m": 60.0,
                    "vox_down_m": 0.08},
        "sampler": {"surface_sample_range_m": 0.25},
        "neuralpoints": {"voxel_size_m": 0.3},
        "loss": {"sigma_sigmoid_m": 0.1, "loss_weight_on": True},
        "optimizer": {"iters": 10, "init_iter_ratio": 20,
                      "batch_size": 1024, "train_subset_hist": 4096},
        "tracker": {"source_vox_down_m": 0.5, "iter_n": 30},
        "eval": {"mesh_min_nn": 6, "mc_res_m": 0.5},
        "tpu": {"map_capacity": 1 << 16, "hash_table_size": 1 << 19,
                "frame_point_cap": 1 << 13, "source_point_cap": 1 << 11,
                "max_frames": 64},
        "continual": {"pool_capacity": 1_000_000,
                      "batch_size_new_sample": 1024},
    }
    cfg_path = root / "run_synth.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    return root, cfg, cfg_path, seq


@pytest.fixture(scope="module")
def cli_run(disk_dataset):
    root, _, cfg_path, seq = disk_dataset
    metrics = trun.run_pin_slam(str(cfg_path), cpu_only=True,
                                save_map=True, save_mesh=True)
    runs = sorted((root / "out").iterdir())
    assert len(runs) == 1
    return runs[0], metrics, seq


def test_metrics_reasonable(cli_run):
    _, metrics, _ = cli_run
    assert metrics, "gt poses provided, metrics must be computed"
    assert metrics["Absoulte Trajectory Error [m]"] < ATE_BOUND_M


def test_artifacts_written(cli_run):
    run_dir, _, _ = cli_run
    for f in ("odom_poses_kitti.txt", "odom_poses_tum.txt", "pose_eval.csv",
              "time_table.npy", "model/pin_map.npz", "map/neural_points.ply",
              "meta/config_all.yaml", "mesh/mesh_30cm.ply"):
        assert (run_dir / f).exists(), f
    assert np.load(str(run_dir / "time_table.npy")).shape == (6, 5)


def test_written_poses_roundtrip(cli_run):
    run_dir, _, seq = cli_run
    poses = read_kitti_format_poses(str(run_dir / "odom_poses_kitti.txt"))
    assert len(poses) == len(seq)
    err = np.linalg.norm(poses[-1][:3, 3] - seq.poses[-1][:3, 3])
    assert err < ATE_BOUND_M


def test_offline_vis_map(cli_run):
    run_dir, _, _ = cli_run
    from pin_slam_tpu_torch.vis_map import vis_pin_map

    verts, faces = vis_pin_map(str(run_dir), mc_res_m=0.3,
                               export_points=True, mesh_min_nn=6,
                               device="cpu")
    assert verts.shape[0] > 1000 and faces.shape[0] > 1000
    assert (run_dir / "mesh" / "mesh_30cm_offline.ply").exists()


def test_saved_map_loads_in_jax(cli_run):
    run_dir, _, _ = cli_run
    path = str(run_dir / "model" / "pin_map.npz")
    from pin_slam_tpu_torch.utils.map_io import load_implicit_map

    ts, tm, tmeta = load_implicit_map(path, device="cpu")
    js, jm, jmeta = j_load(path, with_btable=False)
    cnt = int(ts.count)
    assert cnt == int(js.count) > 1000 and tmeta == jmeta
    np.testing.assert_array_equal(ts.positions[:cnt].numpy(),
                                  np.asarray(js.positions)[:cnt])
    np.testing.assert_array_equal(ts.geo_features[:cnt].numpy(),
                                  np.asarray(js.geo_features)[:cnt])
    np.testing.assert_array_equal(ts.table.numpy(), np.asarray(js.table))
    for a, b in zip(tm["geo_mlp"]["w"], jm["geo_mlp"]["w"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_localization_through_load_model(cli_run, disk_dataset, tmp_path):
    """The same YAML with load_model: the first three frames localized
    against the saved map, which the run leaves as it found it."""
    run_dir, metrics, _ = cli_run
    _, cfg, _, _ = disk_dataset
    cfg = dict(cfg, setting=dict(
        cfg["setting"], load_model=True, output_root=str(tmp_path),
        model_path=str(run_dir / "model" / "pin_map.npz")),
        eval=dict(cfg["eval"], log_freq_frame=1))
    path = tmp_path / "loc.yaml"
    path.write_text(yaml.safe_dump(cfg))
    loc = trun.run_pin_slam(str(path), cpu_only=True, save_map=True,
                            log_on=True, frame_range=(0, 3, 1))
    assert loc["Absoulte Trajectory Error [m]"] < ATE_BOUND_M
    loc_dir = next(tmp_path.glob("cli_e2e_*"))
    # the logger's per-frame rows: no training loss in localization mode
    rows = [json.loads(r) for r in
            (loc_dir / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    assert all(r["map_memory_mb"] > 0 and r["lose_track"] == 0
               and "loss" not in r for r in rows[:3])
    assert len(list((loc_dir / "log").glob("odom_poses_*.npy"))) == 3
    out = loc_dir / "model" / "pin_map.npz"
    with np.load(str(run_dir / "model" / "pin_map.npz")) as a, \
            np.load(str(out)) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_main_parses_the_argument_vector(monkeypatch):
    seen = {}
    monkeypatch.setattr(trun, "run_pin_slam",
                        lambda *a, **k: seen.update(args=a, kw=k) or {})
    trun.main(["c.yaml", "kitti", "00", "-i", "in", "-o", "out", "--range",
               "1", "9", "2", "--seed", "7", "-d", "-c", "-l", "-s", "-m",
               "-p", "--deskew"])
    assert seen["args"] == ("c.yaml", "kitti", "00", "in", "out", (1, 9, 2),
                            7, True, True, True, True, True, True, True,
                            False)
    trun.main(["c.yaml"])
    assert seen["args"] == ("c.yaml", None, None, None, None, None, 42,
                            False, False, False, False, False, False, False,
                            False)


def test_the_card_is_the_default_and_the_viewer_raises(disk_dataset,
                                                       monkeypatch,
                                                       tmp_path):
    """Without a card the entry point refuses before any output; with `-c
    -v` the viewer process runs beside the frames and mirrors the last
    frame to gui/latest.npz (two frames of the YAML with 3 training
    iterations a frame and 6 on the first: the viewer is what is checked)."""
    _, cfg, cfg_path, _ = disk_dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main([str(cfg_path), "-o", str(tmp_path)])
    assert not list(tmp_path.iterdir())     # refused before any output
    cut = tmp_path.parent / "viewer_cut.yaml"
    cut.write_text(yaml.safe_dump(dict(cfg, optimizer=dict(
        cfg["optimizer"], iters=3, init_iter_ratio=2))))
    trun.main([str(cut), "-c", "-v", "--range", "0", "2", "1",
               "-o", str(tmp_path)])
    run_dir, = tmp_path.iterdir()
    latest = np.load(run_dir / "gui" / "latest.npz")
    assert int(latest["frame_id"]) == 1
    np.testing.assert_allclose(
        latest["odom_poses"],
        np.stack(read_kitti_format_poses(
            str(run_dir / "odom_poses_kitti.txt"))), atol=1e-5)
    assert (run_dir / "vis" / "neural_points_pca.ply").exists()


@pytest.fixture(scope="module")
def bag_run(disk_dataset, tmp_path_factory):
    """The same cut YAML with `deskew: true` over BAG_FRAMES swept scans
    (each ray fired from the pose of its instant) written as one ROS1 bag
    of PointCloud2 messages with a per-point time field, run as
    `python -m pin_slam_tpu_torch.run <yaml> rosbag -i <dir> -d --deskew
    -s -m -c` runs it. Records each frame's tracker validity."""
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    _, cfg, _, _ = disk_dataset
    root = tmp_path_factory.mktemp("bag_run")
    seq = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(BAG_FRAMES + 1, radius=6.0,
                                revolutions=0.05, ease_in_frames=3),
        dirs=lidar_directions(256, 16), max_range=60.0, sweep=True)
    (root / "bag").mkdir()
    write_bag1(str(root / "bag" / "walk.bag"),
               [seq.frame_with_ts(i) for i in range(BAG_FRAMES)],
               topic="/os_cloud_node/points")
    cfg = dict(cfg, setting=dict(cfg["setting"], deskew=True,
                                 output_root=str(root / "out")))
    path = root / "bag.yaml"
    path.write_text(yaml.safe_dump(cfg))
    valid, orig = [], PinSLAMSystem.process_frame

    def process_frame(system, fid, *a, **k):
        out = orig(system, fid, *a, **k)
        valid.append(fid == 0 or bool(system.last_tracking.valid))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PinSLAMSystem, "process_frame", process_frame)
        metrics = trun.run_pin_slam(str(path), "rosbag",
                                    input_path=str(root / "bag"),
                                    data_loader_on=True, deskew=True,
                                    cpu_only=True, save_map=True,
                                    save_mesh=True)
    # a deskewed scan is expressed in its mid-scan frame; the run starts
    # at the identity, in the first scan's frame
    gt = np.stack([seq._pose_at(i, 0.5) for i in range(BAG_FRAMES)])
    gt = np.linalg.inv(gt[0]) @ gt
    run_dir = next((root / "out").iterdir())
    return run_dir, metrics, valid, gt


def test_run_from_a_ros1_bag(bag_run):
    """Every frame valid, the written odometry within the file's ATE bound
    of the mid-scan truth (a bag carries no ground truth, so the run
    itself computes no metrics), and the artifacts written."""
    from pin_slam_tpu_torch.utils.eval_traj import absolute_error

    run_dir, metrics, valid, gt = bag_run
    assert metrics == {}
    assert len(valid) == BAG_FRAMES and all(valid), valid
    est = np.stack(read_kitti_format_poses(
        str(run_dir / "odom_poses_kitti.txt")))
    ate, _ = absolute_error(gt, est, align_on=False)
    assert est.shape == (BAG_FRAMES, 4, 4) and ate < ATE_BOUND_M, ate
    assert Path(run_dir).name.startswith("cli_e2e_rosbag_")
    for f in ("odom_poses_tum.txt", "time_table.npy", "model/pin_map.npz",
              "map/neural_points.ply", "meta/config_all.yaml",
              "mesh/mesh_30cm.ply"):
        assert (run_dir / f).exists(), f
