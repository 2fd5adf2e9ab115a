"""The port's viewer (gui/), file visualizer (utils/visualizer.py) and
plots (utils/plots.py) against the JAX package's, on the CPU.

* `feature_pca` is bit-equal to the JAX package's.
* The VisPacket, ControlPacket, apply_control and get_latest_queue cases of
  tests/test_gui_and_replay.py pass on the port's copies; a packet built
  from torch tensors holds numpy arrays and Python scalars only.
* The Open3D panel runs against test_gui_and_replay.py's stand-in open3d.
* `write_results(loop_edges=)` writes the plot files the JAX package
  writes.
* `run_pin_slam` with `-v`, `mesh_default_on` and `sdf_default_on` over a
  3-frame synthetic dataset in both packages: the same file names under
  vis/ (SDF slices every frame, the local mesh of frame 2, the live
  trajectory, the PCA-coloured neural points); under gui/ both viewers
  mirror the last frame to latest.npz and render PNGs named for the frames
  they drew (latest-wins: a viewer may skip a frame's packet when the next
  one is already queued). The port's run is also the spawned viewer end to
  end: every packet it sends holds no torch tensor, and latest.npz holds
  the last frame's odometry.
"""

import queue as q_mod
import sys
import threading
import time

import numpy as np
import pytest
import torch
import yaml

from pin_slam_tpu.utils.visualizer import feature_pca as j_feature_pca
from pin_slam_tpu_torch.dataset.io import (
    read_kitti_format_poses,
    write_kitti_format_poses,
    write_ply_points,
)
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence,
    circle_trajectory,
    default_scene,
    lidar_directions,
)
from pin_slam_tpu_torch.gui import (ControlPacket, VisPacket, apply_control,
                                    get_latest_queue)
from pin_slam_tpu_torch.utils.visualizer import feature_pca

N_FRAMES = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_tensor(obj, path="pkt"):
    """Every leaf of a packet is numpy, a Python scalar, a string or None."""
    if isinstance(obj, torch.Tensor):
        raise AssertionError(f"{path} is a torch tensor")
    if isinstance(obj, dict):
        for k, v in obj.items():
            _no_tensor(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _no_tensor(v, f"{path}[{i}]")
    elif hasattr(obj, "__dict__"):
        for k, v in vars(obj).items():
            _no_tensor(v, f"{path}.{k}")
    else:
        assert obj is None or isinstance(
            obj, (np.ndarray, np.generic, int, float, bool, str)), (
            path, type(obj))


def test_feature_pca_is_bit_equal():
    rng = np.random.RandomState(0)
    f = rng.randn(3001, 8).astype(np.float32)
    c_t, pc_t = feature_pca(f)
    c_j, pc_j = j_feature_pca(f)
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(pc_t, pc_j)
    c_t2, _ = feature_pca(f[::3], principal_components=pc_t)
    c_j2, _ = j_feature_pca(f[::3], principal_components=pc_j)
    np.testing.assert_array_equal(c_t2, c_j2)


def test_get_latest_queue_latest_wins():
    q = q_mod.Queue()
    for i in range(5):
        q.put(i)
    assert get_latest_queue(q) == 4
    assert get_latest_queue(q) is None


def test_vispacket_fields_roundtrip():
    pkt = VisPacket(frame_id=3, travel_dist=12.5, cur_fps=9.0)
    pkt.add_scan(np.random.rand(10, 3))
    pkt.add_mesh(np.random.rand(4, 3), np.array([[0, 1, 2]]))
    pkt.add_traj(np.tile(np.eye(4), (3, 1, 1)))
    pkt.add_neural_points_data(np.random.rand(20, 3), count=20,
                               map_memory_mb=1.0, resolution=0.3,
                               pca_color_on=False)
    assert pkt.slam_poses is not None          # defaults to odom
    assert pkt.has_neural_points
    assert pkt.mesh_faces.dtype == np.int32
    assert not pkt.finish


def test_vispacket_from_torch_tensors_holds_numpy():
    """Every add_* converts torch tensors (and tensor scalars) to numpy on
    the host: a packet pickled to the viewer process never imports torch
    there, nor initialises CUDA."""
    pkt = VisPacket(frame_id=1, travel_dist=torch.tensor(2.5),
                    cur_fps=torch.tensor(9.0),
                    mem_usage_gb=torch.tensor(1.5))
    pkt.add_scan(torch.rand(10, 3), torch.rand(10, 3))
    pkt.add_mesh(torch.rand(4, 3), torch.tensor([[0, 1, 2]]))
    pkt.add_traj(torch.eye(4).repeat(3, 1, 1), None,
                 torch.eye(4).repeat(3, 1, 1),
                 loop_edges=[torch.tensor([0, 2])])
    pkt.add_sdf_slice(torch.rand(5, 3), torch.rand(5, 3))
    pkt.add_sdf_training_pool(torch.rand(5, 3), torch.rand(5, 3))
    pkt.add_neural_points_data(torch.rand(40, 3), torch.randn(40, 8),
                               stability=torch.rand(40),
                               ts=torch.arange(40), count=torch.tensor(40),
                               map_memory_mb=torch.tensor(3.0),
                               resolution=0.3)
    _no_tensor(pkt)
    assert pkt.loop_edges == [(0, 2)]
    assert pkt.neural_points_data["color_pca_geo"].shape == (40, 3)
    assert pkt.mesh_faces.dtype == np.int32


def test_apply_control_pause_until_resumed():
    q = q_mod.Queue()
    paused = ControlPacket()
    paused.flag_pause = True
    paused.mesh_freq_frame = 7
    q.put(paused)

    def resume():
        time.sleep(0.3)
        cp = ControlPacket()
        cp.flag_pause = False
        q.put(cp)

    t = threading.Thread(target=resume)
    t.start()
    t0 = time.time()
    state = apply_control(q, {}, sleep_s=0.05, max_pause_s=5.0)
    elapsed = time.time() - t0
    t.join()
    assert 0.2 < elapsed < 3.0                 # actually blocked, then woke
    assert state["mesh_freq_frame"] == 7


def test_viewer_draws_the_last_frame_before_finishing(tmp_path):
    """Two frames and the finish packet queued before the viewer drains:
    the viewer still mirrors and draws frame 1 before it exits (the JAX
    package's viewer, draining latest-wins, takes the finish packet and
    exits without either)."""
    from pin_slam_tpu_torch.gui.gui_utils import ParamsGUI
    from pin_slam_tpu_torch.gui.slam_viewer import viewer_main

    q = q_mod.Queue()
    for fid in range(2):
        pkt = VisPacket(frame_id=fid)
        pkt.add_scan(np.random.rand(20, 3))
        pkt.add_traj(np.tile(np.eye(4), (fid + 1, 1, 1)))
        q.put(pkt)
    q.put(VisPacket(finish=True))
    params = ParamsGUI(q_main2vis=q, run_path=str(tmp_path))
    params.backend = "png"
    viewer_main(params)                   # returns on the finish packet
    assert int(np.load(tmp_path / "gui" / "latest.npz")["frame_id"]) == 1
    assert (tmp_path / "gui" / "view_000001.png").exists()
    assert not (tmp_path / "gui" / "view_000000.png").exists()


def test_o3d_panel_render_control_and_finish(monkeypatch):
    """tests/test_gui_and_replay.py's Open3D panel case on the port's
    backend, against the same stand-in open3d."""
    import test_gui_and_replay as g
    for name, mod in g.TestO3DViewerMocked()._fake_open3d().items():
        monkeypatch.setitem(sys.modules, name, mod)
    from pin_slam_tpu_torch.gui.gui_utils import ParamsGUI
    from pin_slam_tpu_torch.gui.o3d_gui import _O3DViewer

    q_m2v, q_v2m = q_mod.Queue(), q_mod.Queue()
    v = _O3DViewer(ParamsGUI(q_main2vis=q_m2v, q_vis2main=q_v2m,
                             mesh_default_on=True))
    kids = v.panel.children
    assert sum(1 for c in kids if hasattr(c, "on_checked")) == 6
    sliders = [c for c in kids if hasattr(c, "on_value")]
    assert len(sliders) == 3 and v.cb_mesh.checked is True
    v.cb_pause.on_checked(True)
    assert q_v2m.get_nowait().flag_pause is True
    sliders[0].on_value(0.42)
    assert abs(q_v2m.get_nowait().mc_res_m - 0.42) < 1e-9

    pkt = VisPacket(frame_id=3, cur_fps=7.5,
                    current_pointcloud_xyz=torch.rand(40, 3),
                    mesh_verts=np.random.rand(9, 3),
                    mesh_faces=np.arange(9).reshape(3, 3))
    pkt.add_traj(slam_poses=np.stack([np.eye(4)] * 5), loop_edges=[(0, 4)])
    pkt.add_neural_points_data(np.random.rand(64, 3), count=64,
                               map_memory_mb=1.5, pca_color_on=False)
    pkt.add_sdf_slice(np.random.rand(16, 3), np.random.rand(16, 3))
    v.cb_sdf.checked = True
    v.cb_np.checked = True
    q_m2v.put(pkt)
    assert v._on_tick() is True
    geoms = v.widget3d.scene.geoms
    for name in (v.NP_NAME, v.SCAN_NAME, v.MESH_NAME, v.SDF_NAME,
                 v.TRAJ_NAME, v.LOOP_NAME):
        assert name in geoms, name
    assert "frame 3" in v.stats.text and "64 neural points" in v.stats.text
    v.cb_mesh.checked = False
    q_m2v.put(pkt)
    assert v._on_tick() is True
    assert v.MESH_NAME not in geoms
    q_m2v.put(VisPacket(finish=True))
    assert v._on_tick() is False
    assert v.gui.Application.instance.quit_called


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Three synthetic frames on disk (PLY scans, KITTI poses) and a YAML
    small enough for the CPU, with the viewer's options on: SDF slices
    every frame, a local mesh every second frame."""
    root = tmp_path_factory.mktemp("viewer")
    (root / "ply").mkdir()
    seq = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(N_FRAMES, radius=6.0, revolutions=0.03,
                                ease_in_frames=3),
        dirs=lidar_directions(256, 16), max_range=60.0)
    for i in range(N_FRAMES):
        write_ply_points(str(root / "ply" / f"{i:06d}.ply"), seq.frame(i))
    write_kitti_format_poses(str(root / "poses.txt"), seq.poses)
    cfg = {
        "setting": {"name": "viewer", "pc_path": str(root / "ply"),
                    "pose_path": str(root / "poses.txt")},
        "process": {"min_range_m": 0.5, "max_range_m": 30.0,
                    "vox_down_m": 0.08},
        "sampler": {"surface_sample_range_m": 0.25},
        "neuralpoints": {"voxel_size_m": 0.3},
        "loss": {"sigma_sigmoid_m": 0.1, "loss_weight_on": True},
        "optimizer": {"iters": 6, "init_iter_ratio": 10,
                      "batch_size": 1024, "train_subset_hist": 4096},
        "tracker": {"source_vox_down_m": 0.5, "iter_n": 30},
        "eval": {"mesh_min_nn": 6, "mc_res_m": 0.5,
                 "mesh_default_on": True, "mesh_freq_frame": 2,
                 "sdf_default_on": True, "sdf_freq_frame": 1,
                 "o3d_vis_on": True, "gui_backend": "png"},
        "tpu": {"map_capacity": 1 << 16, "hash_table_size": 1 << 19,
                "frame_point_cap": 1 << 13, "source_point_cap": 1 << 11,
                "max_frames": 64, "probe_mode": "cells"},
        "continual": {"pool_capacity": 1_000_000,
                      "batch_size_new_sample": 512},
    }
    return root, cfg, seq


def test_write_results_writes_the_jax_plots(dataset, tmp_path):
    """The same trajectories, timings and loop edges through both
    packages' write_results: the same plot files."""
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.dataset.slam_dataset import SLAMDataset as JDataset
    from pin_slam_tpu_torch.config import Config as TConfig
    from pin_slam_tpu_torch.dataset.slam_dataset import SLAMDataset

    root, cfg, seq = dataset
    path = tmp_path / "plots.yaml"
    path.write_text(yaml.safe_dump(cfg))
    odom = seq.poses.copy()
    odom[:, 0, 3] += 0.05
    timings = np.full((N_FRAMES, 5), 0.01)
    names = {}
    for tag, cls, Data in (("jax", JConfig, JDataset),
                           ("torch", TConfig, SLAMDataset)):
        out = tmp_path / tag
        data = Data(cls().load(str(path)))
        data.write_results(str(out), odom, seq.poses, timings,
                           loop_edges=[np.array([0, 2])])
        names[tag] = sorted(p.name for p in out.glob("*.png"))
    assert names["torch"] == names["jax"] == [
        "loop_plot.png", "timing_details.png", "traj_plot_2d.png",
        "traj_plot_3d.png"]
    assert data.plot_status.startswith("written")


def _file_names(run_dir, sub):
    return sorted(p.name for p in (run_dir / sub).iterdir())


@pytest.fixture(scope="module")
def viewer_runs(dataset, tmp_path_factory):
    """run_pin_slam with the viewer in both packages; the port's packets
    are checked for tensors as they are sent."""
    import pin_slam_tpu_torch.gui as tgui
    from pin_slam_tpu.run import run_pin_slam as j_run
    from pin_slam_tpu_torch.run import run_pin_slam as t_run

    root, cfg, _ = dataset
    out = {}
    sent = []
    start = tgui.start_viewer

    class Checked:
        def __init__(self, q):
            self.q = q

        def put(self, pkt):
            _no_tensor(pkt)
            sent.append(pkt.frame_id)
            self.q.put(pkt)

    def start_checked(*a, **k):
        proc, q_m2v, q_v2m = start(*a, **k)
        out["proc"] = proc
        return proc, Checked(q_m2v), q_v2m

    for tag, run in (("jax", j_run), ("torch", t_run)):
        path = root / f"{tag}.yaml"
        path.write_text(yaml.safe_dump(dict(cfg, setting=dict(
            cfg["setting"], output_root=str(root / tag)))))
        tgui.start_viewer = start_checked
        try:
            kw = {"cpu_only": True} if tag == "torch" else {}
            run(str(path), visualize=True, **kw)
        finally:
            tgui.start_viewer = start
        out[tag], = (root / tag).iterdir()
    out["sent"] = sent
    return out


def test_viewer_run_writes_the_jax_files(viewer_runs):
    j, t = viewer_runs["jax"], viewer_runs["torch"]
    assert _file_names(t, "vis") == _file_names(j, "vis") == [
        "mesh_00002.ply", "neural_points_pca.ply", "sdf_slice_00000.png",
        "sdf_slice_00001.png", "sdf_slice_00002.png", "traj_live.png"]
    frames = {f"view_{i:06d}.png" for i in range(N_FRAMES)}
    for run in (j, t):
        names = set(_file_names(run, "gui"))
        assert "latest.npz" in names
        assert names - {"latest.npz"} <= frames and names & frames, names


def test_viewer_process_end_to_end(viewer_runs):
    """The port's spawned viewer got one numpy-only packet a frame, exited
    on the finish packet, and mirrored the last frame's state."""
    t = viewer_runs["torch"]
    assert viewer_runs["sent"][:N_FRAMES] == list(range(N_FRAMES))
    assert viewer_runs["sent"][N_FRAMES:] == [None]     # the finish packet
    assert not viewer_runs["proc"].is_alive()
    latest = np.load(t / "gui" / "latest.npz")
    assert int(latest["frame_id"]) == N_FRAMES - 1
    odom = np.stack(read_kitti_format_poses(str(t / "odom_poses_kitti.txt")))
    np.testing.assert_allclose(latest["odom_poses"], odom, atol=1e-5)
    assert latest["mesh_verts"].shape[0] > 0
    assert latest["current_pointcloud_xyz"].shape[1] == 3
