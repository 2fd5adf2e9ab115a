"""The port's config against the JAX package's: same defaults, and every
YAML of the repo loads to the same values in every field the port keeps."""

import dataclasses
import glob
import os

import pytest

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu_torch.config import Config as TConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "config", "*", "*.yaml")))


def _fields(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(TConfig)}


def test_defaults_match():
    assert _fields(TConfig().finalize()) == _fields(JConfig().finalize())
    assert TConfig().sdf_scale == JConfig().sdf_scale
    assert TConfig().all_sample_n == JConfig().all_sample_n


@pytest.mark.parametrize("path", YAMLS,
                         ids=[os.path.relpath(p, ROOT) for p in YAMLS])
def test_yaml_loads_alike(path):
    t, j = TConfig().load(path), JConfig().load(path)
    assert _fields(t) == _fields(j)
    assert t.sdf_scale == j.sdf_scale


MESH_FIELDS = ("mc_res_m", "pad_voxel", "skip_top_voxel", "mc_mask_on",
               "mesh_min_nn", "min_cluster_vertices", "infer_bs",
               "infer_bs_final", "save_mesh", "mesh_freq_frame")


@pytest.mark.parametrize("field", MESH_FIELDS)
def test_mesh_field_kept_and_loaded_alike(field):
    """Each field the mesher reads is a field of the port's Config, and
    over every YAML of the repo it loads to the JAX package's value."""
    assert field in {f.name for f in dataclasses.fields(TConfig)}
    seen = set()
    for path in YAMLS:
        t, j = TConfig().load(path), JConfig().load(path)
        assert getattr(t, field) == getattr(j, field), path
        seen.add(getattr(t, field))
    assert seen


LOOP_FIELDS = (
    "global_loop_on", "local_map_context", "loop_with_feature",
    "min_loop_travel_dist_ratio", "local_map_context_latency",
    "loop_local_map_by_travel_dist", "loop_local_map_time_window",
    "local_loop_dist_thre", "context_shape", "npmc_max_dist",
    "context_cosdist_threshold", "context_virtual_side_count",
    "context_virtual_step_m", "loop_z_check_on",
    "loop_dist_drift_ratio_thre", "pgo_on", "pgo_freq", "pgo_max_iter",
    "pgo_tran_std", "pgo_rot_std",
    "pgo_loop_tran_std", "pgo_loop_rot_std", "use_reg_cov_mat",
    "pgo_error_thre_frame", "post_loop_iter_boost")


@pytest.mark.parametrize("field", LOOP_FIELDS)
def test_loop_field_kept_and_loaded_alike(field):
    """Each field the loop-closure path reads is a field of the port's
    Config with the JAX package's default, and over every YAML of the repo
    it loads to the JAX package's value."""
    assert field in {f.name for f in dataclasses.fields(TConfig)}
    assert getattr(TConfig().finalize(), field) == \
        getattr(JConfig().finalize(), field)
    for path in YAMLS:
        t, j = TConfig().load(path), JConfig().load(path)
        assert getattr(t, field) == getattr(j, field), path


def test_pgo_section_turns_loop_closure_on():
    """16 shipped files have a `pgo:` section; with a tracker section each
    sets pgo_on, in both packages alike (run_kitti.yaml among them)."""
    on = [os.path.relpath(p, ROOT) for p in YAMLS
          if TConfig().load(p).pgo_on]
    assert "config/lidar_slam/run_kitti.yaml" in on
    assert on == [os.path.relpath(p, ROOT) for p in YAMLS
                  if JConfig().load(p).pgo_on]
    assert TConfig().load(os.path.join(
        ROOT, "config/lidar_slam/run_kitti.yaml")).pgo_freq == 20


OPTION_FIELDS = (
    "incidence_label_on", "incidence_cos_floor", "incidence_mode",
    "incidence_bins_az", "incidence_bins_el", "incidence_range_gate_m",
    "consistency_loss_on", "weight_c", "consistency_count",
    "consistency_range", "proj_correction_on", "use_gaussian_pe",
    "pos_encoding_freq", "pos_encoding_band", "pos_input_dim",
    "pos_encoding_base", "probe_mode")


@pytest.mark.parametrize("field", OPTION_FIELDS)
def test_option_field_kept_and_loaded_alike(field):
    """Each field of the training options and the probe choice is a field
    of the port's Config with the JAX package's default, and over every
    YAML of the repo it loads to the JAX package's value."""
    assert field in {f.name for f in dataclasses.fields(TConfig)}
    assert getattr(TConfig().finalize(), field) == \
        getattr(JConfig().finalize(), field)
    for path in YAMLS:
        t, j = TConfig().load(path), JConfig().load(path)
        assert getattr(t, field) == getattr(j, field), path


def test_option_keys_parse_alike(tmp_path):
    """The YAML keys of the options parse into both packages alike, and the
    consistency count follows bs / 4."""
    path = tmp_path / "opts.yaml"
    path.write_text(
        "setting:\n  name: opts\n"
        "sampler:\n  surface_sample_range_m: 0.3\n"
        "  incidence_label_on: True\n  incidence_cos_floor: 0.2\n"
        "loss:\n  consistency_loss_on: True\n"
        "optimizer:\n  batch_size: 4096\n"
        "tpu:\n  probe_mode: brick\n")
    t, j = TConfig().load(str(path)), JConfig().load(str(path))
    assert (t.incidence_label_on, t.incidence_cos_floor,
            t.consistency_loss_on, t.probe_mode) == (True, 0.2, True,
                                                      "brick")
    assert t.consistency_count == 1024 == j.consistency_count
    assert _fields(t) == _fields(j)


def test_infer_bs_final_follows_bs():
    c = TConfig()
    c.bs = 16384
    assert c.finalize().infer_bs_final == 32 * 16384 == 524288


@pytest.mark.parametrize("mode", ["auto", "join", "cells"])
def test_probe_modes_accepted_by_query_params(mode):
    from pin_slam_tpu_torch.slam.map_query import make_query_params

    c = TConfig()
    c.probe_mode = mode
    qp = make_query_params(c.finalize())
    assert qp.probe_mode == ("cells" if mode == "cells" else "join")
    assert len(qp.offsets) == 33


def test_brick_probe_is_refused():
    """The brick probe, once refused, is accepted as the JAX package
    accepts it; an unknown probe name is refused."""
    from pin_slam_tpu_torch.slam.map_query import make_query_params

    c = TConfig()
    c.probe_mode = "brick"
    assert make_query_params(c.finalize()).probe_mode == "brick"
    c.probe_mode = "bricks"
    with pytest.raises(ValueError, match="bricks"):
        make_query_params(c.finalize())


def test_unported_yaml_features_are_refused():
    """Every shipped YAML loads into the port's Config, and no flag a YAML
    can set refuses a system any more: data parallelism, the last one,
    builds a system (single-device without a second device, the JAX
    package's rule)."""
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    assert len(YAMLS) == 20
    for path in YAMLS:
        TConfig().load(path)
    c = TConfig()
    c.map_capacity, c.buffer_size, c.pool_capacity = 1 << 12, 1 << 14, 4096
    c.dp_on = True
    assert PinSLAMSystem(c.finalize(), device="cpu").mesh is None


VIEWER_DP_ROS_FIELDS = (
    "gui_backend", "sdfslice_freq_frame", "vis_sdf_slice_v",
    "sdf_slice_height", "vis_sdf_res_m", "timeout_duration_s", "dp_devices",
    "dp_on", "mesh_freq_frame")


@pytest.mark.parametrize("field", VIEWER_DP_ROS_FIELDS)
def test_viewer_dp_ros_field_kept_and_loaded_alike(field):
    """Each field the viewer, the file visualizer, data parallelism and the
    ROS node read is a field of the port's Config with the JAX package's
    default, and over every YAML of the repo it loads to the JAX package's
    value (vis_sdf_res_m follows the voxel size, as finalize() sets it)."""
    assert field in {f.name for f in dataclasses.fields(TConfig)}
    assert getattr(TConfig().finalize(), field) == \
        getattr(JConfig().finalize(), field)
    for path in YAMLS:
        t, j = TConfig().load(path), JConfig().load(path)
        assert getattr(t, field) == getattr(j, field), path


def test_viewer_and_dp_keys_parse_alike(tmp_path):
    """The YAML keys of the viewer and of data parallelism parse into both
    packages alike."""
    path = tmp_path / "vis.yaml"
    path.write_text(
        "setting:\n  name: vis\n"
        "mapper:\n  voxel_size_m: 0.5\n"
        "eval:\n  o3d_vis_on: True\n  gui_backend: png\n"
        "  mesh_default_on: True\n  mesh_freq_frame: 5\n"
        "  sdf_default_on: True\n  sdf_freq_frame: 5\n"
        "  sdf_slice_height: 0.4\n"
        "tpu:\n  dp_on: True\n  dp_devices: 2\n")
    t, j = TConfig().load(str(path)), JConfig().load(str(path))
    assert (t.o3d_vis_on, t.gui_backend, t.mesh_default_on,
            t.mesh_freq_frame, t.sdf_default_on, t.sdfslice_freq_frame,
            t.sdf_slice_height, t.dp_on, t.dp_devices) == (
        True, "png", True, 5, True, 5, 0.4, True, 2)
    assert t.vis_sdf_res_m == j.vis_sdf_res_m
    assert _fields(t) == _fields(j)


COLOR_SEM_FIELDS = (
    "semantic_on", "sem_class_count", "sem_label_decimation",
    "freespace_label_on", "color_map_on", "color_on", "color_channel",
    "weight_s", "weight_i", "sem_mlp_level", "sem_mlp_hidden_dim",
    "color_mlp_level", "color_mlp_hidden_dim", "photometric_loss_on",
    "photometric_loss_weight", "consist_wieght_on")


@pytest.mark.parametrize("field", COLOR_SEM_FIELDS)
def test_color_semantic_field_kept_and_loaded_alike(field):
    """Each colour and semantic field is a field of the port's Config with
    the JAX package's default, and over every YAML of the repo it loads to
    the JAX package's value."""
    assert field in {f.name for f in dataclasses.fields(TConfig)}
    assert getattr(TConfig().finalize(), field) == \
        getattr(JConfig().finalize(), field)
    for path in YAMLS:
        t, j = TConfig().load(path), JConfig().load(path)
        assert getattr(t, field) == getattr(j, field), path


def _cut(c):
    """The static capacities (and the first frame's training) cut down, so
    a test holds little memory and time."""
    c.map_capacity, c.buffer_size = 1 << 12, 1 << 14
    c.pool_capacity, c.frame_point_cap = 20_000, 1 << 10
    c.source_point_cap, c.max_frames = 1 << 8, 64
    c.local_set_cap, c.bs, c.bs_new_sample = 1 << 12, 256, 64
    c.iters, c.init_iter_ratio = 1, 2
    return c


@pytest.mark.parametrize("name,check", [
    ("lidar_slam/run_kitti_color.yaml", lambda c: c.color_on
     and c.color_channel == 3 and not c.weighted_first
     and c.consist_wieght_on and not c.photometric_loss_on),
    ("rgbd_slam/run_replica.yaml", lambda c: c.color_on
     and c.color_channel == 3 and not c.photometric_loss_on),
    ("lidar_slam/run_demo_sem.yaml", lambda c: c.semantic_on
     and c.sem_class_count == 20 and c.weighted_first),
])
def test_color_and_semantic_yamls_run_a_frame(name, check):
    """The shipped colour and semantic files build a system and run a
    frame through process_frame (with sem_labels for the semantic one), as
    shipped apart from their static capacities and iterations (the colour
    tracker and a semantic run are held to the JAX package in
    tests/test_torch_color_track.py and test_torch_semantic.py)."""
    import numpy as np

    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    c = TConfig().load(os.path.join(ROOT, "config", name))
    assert check(c)
    system = PinSLAMSystem(_cut(c), device="cpu")
    assert ("color_mlp" in system.params) == c.color_on
    assert ("sem_mlp" in system.params) == c.semantic_on
    rng = np.random.RandomState(0)
    d = rng.randn(600, 3)
    pts = d / np.linalg.norm(d, axis=1, keepdims=True) * 3.0 * c.min_range
    if c.color_on:
        pts = np.hstack([pts, rng.rand(600, 3)])
    kw = {}
    if c.semantic_on:
        kw["sem_labels"] = rng.randint(0, 20, 600)
    system.process_frame(0, pts.astype(np.float32), **kw)
    assert int(system.state.count) > 0
    n = int(system.pool.count)
    if c.semantic_on:
        assert int(system.pool.sem_label[:n].max()) > 0
    if c.color_on:
        assert float(system.pool.color_label[:n].max()) > 0


@pytest.mark.parametrize("name,check", [
    ("run_ncd_128_s.yaml", lambda c: c.ba_freq_frame == 20 and c.pgo_on
     and (c.ba_frame, c.ba_iters, c.ba_bs) == (50, 80, 16384)),
    ("run_kitti_mos.yaml", lambda c: c.dynamic_filter_on
     and not c.weighted_first),
])
def test_ba_and_dynamic_yamls_build_a_system(name, check):
    """The shipped bundle-adjustment and dynamic-filter files build a
    system on the CPU as shipped, apart from their static capacities, cut
    down so the test holds little memory."""
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    c = TConfig().load(os.path.join(ROOT, "config", "lidar_slam", name))
    assert check(c)
    c.map_capacity, c.buffer_size = 1 << 12, 1 << 14
    c.pool_capacity, c.frame_point_cap = 20_000, 1 << 10
    c.source_point_cap, c.max_frames = 1 << 8, 64
    system = PinSLAMSystem(c, device="cpu")
    assert system.state.capacity == 1 << 12


SETTING_FIELDS = (
    "name", "run_name", "output_root", "pc_path", "pose_path", "calib_path",
    "label_path", "use_dataloader", "data_loader_name", "data_loader_seq",
    "load_model", "model_path", "begin_frame", "end_frame", "step_frame",
    "kitti_correction_on", "correction_deg", "stop_frame_thre", "deskew",
    "lidar_type_guess", "filter_moving_object", "save_map",
    "save_merged_pc", "save_mesh", "log_freq_frame", "silence",
    "wandb_vis_on", "o3d_vis_on", "mesh_default_on", "sdf_default_on",
    "eval_traj_align", "run_path")


@pytest.mark.parametrize("field", SETTING_FIELDS)
def test_setting_and_eval_field_kept_and_loaded_alike(field):
    """Each `setting:` / `eval:` field the entry point and the dataset
    layer read is a field of the port's Config with the JAX package's
    default, and over every YAML of the repo it loads to the JAX package's
    value (finalize() sets run_name to name, as the JAX package does)."""
    assert field in {f.name for f in dataclasses.fields(TConfig)}
    assert getattr(TConfig().finalize(), field) == \
        getattr(JConfig().finalize(), field)
    for path in YAMLS:
        t, j = TConfig().load(path), JConfig().load(path)
        assert getattr(t, field) == getattr(j, field), path


def test_deskew_and_kitti_correction_parse():
    """Eight shipped files turn deskew on; run_kitti.yaml corrects KITTI's
    vertical angle by 0.195 deg and names its data paths."""
    on = [p for p in YAMLS if TConfig().load(p).deskew]
    assert len(on) == 8
    c = TConfig().load(os.path.join(ROOT, "config", "lidar_slam",
                                    "run_kitti.yaml"))
    assert c.kitti_correction_on and c.correction_deg == 0.195
    assert c.name == c.run_name == "kitti"
    assert c.pc_path.endswith("velodyne") and c.calib_path
