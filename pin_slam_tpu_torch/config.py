"""Configuration of the PyTorch port.

The port's own copy of the part of `pin_slam_tpu/config.py` that the
port reads: the track+map loop with its colour and semantic mapping, its
mesher, loop closure and pose-graph optimisation, sliding-window bundle
adjustment, the map-based dynamic filter, the dataset layer, the entry
point (`run.py`: paths, frame range, deskew, saving, localization), the
viewer (`gui/`, `utils/visualizer.py`), data parallelism and the ROS node:
the same field names, defaults and YAML schema, so every config file of
the repo loads into both packages and gives the same values for the fields
kept here. Keys no module of the port reads are ignored.
The `tpu` YAML section keeps its name; its static capacities size the
port's fixed-capacity tensors the same way.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import yaml


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class Config:
    # ------------------------------------------------------------------ setting
    name: str = "dummy"
    run_name: str = "dummy"
    run_path: str = ""
    output_root: str = "./experiments"
    pc_path: str = ""
    pose_path: str = ""
    calib_path: str = ""
    label_path: str = ""

    use_dataloader: bool = False
    data_loader_name: str = "generic"
    data_loader_seq: str = ""

    load_model: bool = False
    model_path: str = "/"

    first_frame_ref: bool = False
    begin_frame: int = 0
    end_frame: int = 100000
    step_frame: int = 1

    seed: int = 42

    kitti_correction_on: bool = False
    correction_deg: float = 0.0
    stop_frame_thre: int = 20

    deskew: bool = False
    lidar_type_guess: str = "velodyne"

    # semantic
    semantic_on: bool = False
    sem_class_count: int = 20
    sem_label_decimation: int = 1
    freespace_label_on: bool = False
    filter_moving_object: bool = True

    # color / intensity
    color_map_on: bool = True
    color_on: bool = False
    color_channel: int = 0

    # ------------------------------------------------------------------ process
    min_range: float = 2.5
    max_range: float = 60.0
    adaptive_range_on: bool = False
    min_z: float = -5.0
    max_z: float = 80.0
    rand_downsample: bool = False
    vox_down_m: float = 0.05
    rand_down_r: float = 1.0
    reboot_frame_thre: int = 5

    # map-based dynamic filtering
    dynamic_filter_on: bool = False
    dynamic_certainty_thre: float = 1.0
    dynamic_sdf_ratio_thre: float = 0.5
    dynamic_min_grad_norm_thre: float = 0.25
    # multi-viewpoint visibility test (ops/visibility.py), judged from the
    # sensor origins visibility_hist_offsets frames in the past
    visibility_filter_on: bool = False
    visibility_bins_az: int = 512
    visibility_bins_el: int = 64
    visibility_margin_m: float = 0.4
    visibility_rel_margin: float = 0.05
    visibility_min_votes: int = 2
    visibility_min_certainty: float = 1.0
    visibility_range_ratio: float = 0.9   # judge only within this * max_range
    visibility_hist_offsets: tuple = (10, 30, 60)
    visibility_el_slack_deg: float = 2.0

    # ------------------------------------------------------------- neural points
    voxel_size_m: float = 0.3
    weighted_first: bool = True
    layer_norm_on: bool = False
    num_nei_cells: int = 2
    query_nn_k: int = 6
    use_mid_ts: bool = False
    search_alpha: float = 0.2
    idw_index: int = 2
    buffer_size: int = int(5e7)  # hash table size (rounded up to a power of 2)
    feature_dim: int = 8
    from_sample_points: bool = True
    from_all_samples: bool = False
    map_surface_ratio: float = 0.5
    local_map_travel_dist_ratio: float = 5.0
    local_map_radius: float = 50.0
    prune_map_on: bool = False
    max_prune_certainty: float = 3.0
    prune_freq_frame: int = 100

    # ------------------------------------------------------------------ sampler
    surface_sample_range_m: float = 0.25
    surface_sample_n: int = 3
    free_sample_begin_ratio: float = 0.3
    free_sample_end_dist_m: float = 1.0
    free_front_n: int = 2
    free_behind_n: int = 1
    # incidence-weighted projective labels (ops/range_image.py): scale the
    # free-space samples' labels ("label") or loss weights ("weight") by
    # the geometric |cos| of their ray's incidence
    incidence_label_on: bool = False
    incidence_cos_floor: float = 0.1
    incidence_mode: str = "label"
    incidence_bins_az: int = 512
    incidence_bins_el: int = 64
    incidence_range_gate_m: float = 0.5

    # ------------------------------------------------------------ replay pool
    window_radius: float = 50.0
    pool_capacity: int = int(1e7)
    bs_new_sample: int = 2048
    new_certainty_thre: float = 1.0
    pool_filter_freq: int = 10

    # ------------------------------------------------------------------ decoder
    mlp_bias_on: bool = True
    mlp_leaky_relu: bool = False
    geo_mlp_level: int = 1
    geo_mlp_hidden_dim: int = 64
    sem_mlp_level: int = 1
    sem_mlp_hidden_dim: int = 64
    color_mlp_level: int = 1
    color_mlp_hidden_dim: int = 64
    decoder_freezed: bool = False
    freeze_after_frame: int = 40

    # positional encoding of the offsets (models/pos_encoding.py; band 0:
    # the raw offsets)
    use_gaussian_pe: bool = False
    pos_encoding_freq: int = 200
    pos_encoding_band: int = 0
    pos_input_dim: int = 3
    pos_encoding_base: int = 2

    # --------------------------------------------------------------------- loss
    main_loss_type: str = "bce"
    sigma_sigmoid_m: float = 0.1
    logistic_gaussian_ratio: float = 0.55
    # scale the projective SDF label by |cos(learned gradient, ray)|
    proj_correction_on: bool = False
    loss_weight_on: bool = False
    behind_dropoff_on: bool = False
    dist_weight_on: bool = True
    dist_weight_scale: float = 0.8
    numerical_grad: bool = True
    gradient_decimation: int = 10
    num_grad_step_ratio: float = 0.2
    ekional_loss_on: bool = True
    weight_e: float = 0.5
    weight_s: float = 1.0
    weight_i: float = 1.0
    # gradient consistency between a batch's first samples and points
    # shifted by up to consistency_range (count = bs / 4, see finalize)
    consistency_loss_on: bool = False
    weight_c: float = 0.5
    consistency_count: int = 1000
    consistency_range: float = 0.05

    # ---------------------------------------------------------------- optimizer
    mapping_freq_frame: int = 1
    iters: int = 12
    init_iter_ratio: int = 40
    bs: int = 16384
    # per-frame training history subset (slam/mapper.py make_train_loop):
    # probed once per frame and reused epoch-style by the iterations
    train_subset_hist: int = 65536
    lr: float = 0.01
    lr_pose: float = 1e-4
    lr_ba_map: float = 0.01
    adam_eps: float = 1e-15
    adaptive_iters: bool = False
    new_sample_ratio_less: float = 0.02
    new_sample_ratio_more: float = 0.15
    new_sample_ratio_restart: float = 0.3

    # bundle adjustment
    ba_freq_frame: int = 0
    ba_frame: int = 50
    ba_iters: int = 80
    ba_bs: int = 16384

    # ------------------------------------------------------------------ tracker
    track_on: bool = False
    source_vox_down_m: float = 0.8
    uniform_motion_on: bool = True
    # Initial-guess motion model: "full" extrapolates the whole last relative
    # motion (the reference's behaviour), "translation" only its translation,
    # "damped" the translation fully and `motion_damping` of the rotation.
    motion_model: str = "damped"
    motion_damping: float = 0.5
    reg_min_grad_norm: float = 0.5
    reg_max_grad_norm: float = 2.0
    # colour in the tracker (color_on only): the photometric term, or else
    # the intensity-consistency weight
    photometric_loss_on: bool = False
    photometric_loss_weight: float = 0.01
    consist_wieght_on: bool = True  # (sic) the reference's key spelling
    track_mask_query_nn_k: int = 6
    max_sdf_std_ratio: float = 1.0
    reg_GM_dist_m: float = 0.3
    reg_GM_grad: float = 0.1
    reg_lm_lambda: float = 1e-4
    reg_iter_n: int = 50
    reg_term_thre_deg: float = 0.01
    reg_term_thre_m: float = 0.001
    eigenvalue_check: bool = True
    eigenvalue_ratio_thre: float = 0.005
    final_residual_ratio_thre: float = 0.6

    # ------------------------------------------------------------- loop closure
    global_loop_on: bool = True
    local_map_context: bool = False
    loop_with_feature: bool = False
    min_loop_travel_dist_ratio: float = 4.0
    local_map_context_latency: int = 5
    loop_local_map_by_travel_dist: bool = False
    loop_local_map_time_window: int = 100
    local_loop_dist_thre: float = 2.0
    context_shape: list = field(default_factory=lambda: [20, 60])
    npmc_max_dist: float = 60.0
    context_cosdist_threshold: float = 0.2
    context_virtual_side_count: int = 5
    context_virtual_step_m: float = 2.0
    loop_z_check_on: bool = False
    loop_dist_drift_ratio_thre: float = 2.0

    # ---------------------------------------------------------------------- pgo
    pgo_on: bool = False         # run a LoopPgoManager beside the system
    pgo_freq: int = 30
    pgo_max_iter: int = 50
    pgo_tran_std: float = 0.04
    pgo_rot_std: float = 0.01
    # loop edges are priced apart from odometry edges (slam/pgo.py)
    pgo_loop_tran_std: float = 0.05
    pgo_loop_rot_std: float = 0.5
    use_reg_cov_mat: bool = False
    pgo_error_thre_frame: float = 500.0
    # extra mapping iterations of the first training after an accepted loop
    # closure, to re-converge the SDF around the deformed map
    post_loop_iter_boost: int = 15

    # --------------------------------------------------------------------- eval
    wandb_vis_on: bool = False
    silence: bool = True
    o3d_vis_on: bool = False           # the spawned viewer process
    # viewer backend: 'auto' (Open3D window when available, else headless
    # PNG), 'o3d', or 'png'
    gui_backend: str = "auto"
    log_freq_frame: int = 2000
    # the file visualizer's local meshes and SDF slices (utils/visualizer.py)
    mesh_default_on: bool = False
    mesh_freq_frame: int = 20
    sdf_default_on: bool = False
    sdfslice_freq_frame: int = 1
    vis_sdf_slice_v: bool = False
    sdf_slice_height: float = -1.0
    vis_sdf_res_m: float = 0.2
    eval_traj_align: bool = True

    # --------------------------------------------------------------------- mesh
    mc_res_m: float = 0.3
    pad_voxel: int = 3
    skip_top_voxel: int = 2
    mc_mask_on: bool = True
    mesh_min_nn: int = 8
    min_cluster_vertices: int = 300
    infer_bs: int = 4096

    # ------------------------------------------------------------------- saving
    save_map: bool = False
    save_merged_pc: bool = False
    save_mesh: bool = False

    # -------------------------------------------------------------------- ROS
    # the node exits after this many seconds without a point cloud
    timeout_duration_s: int = 30

    # ---------------------------------------------------------- static shapes
    map_capacity: int = 1 << 20
    frame_point_cap: int = 1 << 16
    source_point_cap: int = 1 << 13
    max_frames: int = 1 << 14
    # kNN probe layout: 'join' (the tiled spatial-join k-NN over a per-frame
    # local set; 'auto' resolves to it), 'cells' (the hash-table probe of
    # the 33-cell ball over the whole map) or 'brick' (the brick-cache
    # probe over the whole map). Queries without a local set (the
    # mesher's, BA's, the dynamic filter's) take 'cells' under 'join'.
    probe_mode: str = "auto"
    # capacity of the per-frame compacted local point set (join probe)
    local_set_cap: int = 1 << 17
    # data parallelism (parallel/dp.py): the training batches and the
    # mesher's grid batches split over dp_devices replica devices (0 = every
    # visible card); with one visible card the run is the single-card run
    dp_on: bool = False
    dp_devices: int = 0

    # derived (filled by finalize())
    infer_bs_final: int = 131072

    def finalize(self):
        """Compute derived parameters (reference: utils/config.py:556-562)."""
        self.run_name = self.name
        self.infer_bs_final = self.bs * 32
        self.consistency_count = int(self.bs / 4)
        self.window_radius = max(self.max_range, 6.0)
        self.local_map_radius = self.max_range + 2.0
        self.vis_sdf_res_m = self.voxel_size_m * 0.3
        self.buffer_size = _next_pow2(int(self.buffer_size))
        self.map_capacity = _next_pow2(int(self.map_capacity))
        self.pool_capacity = int(self.pool_capacity)
        if not self.numerical_grad:
            self.gradient_decimation = 1
        return self

    @property
    def sdf_scale(self) -> float:
        """SDF output scaling (reference: model/decoder.py:54-56)."""
        if self.main_loss_type == "bce":
            return self.logistic_gaussian_ratio * self.sigma_sigmoid_m
        return 1.0

    @property
    def all_sample_n(self) -> int:
        return self.surface_sample_n + self.free_front_n + self.free_behind_n + 1

    def load(self, config_file: str) -> "Config":
        """Load YAML overrides using the reference schema
        (reference: utils/config.py:318-555)."""
        with open(os.path.abspath(config_file)) as f:
            args = yaml.safe_load(f) or {}
        return self.load_dict(args)

    def load_dict(self, args: dict) -> "Config":
        s = args.get("setting", {})
        if s:
            self.name = s.get("name", "pin_slam")
            self.use_dataloader = s.get("use_kiss_icp_dataloader", False)
            self.output_root = s.get("output_root", "./experiments")
            self.pc_path = s.get("pc_path", "")
            self.pose_path = s.get("pose_path", "")
            self.calib_path = s.get("calib_path", "")
            self.semantic_on = s.get("semantic_on", self.semantic_on)
            if self.semantic_on:
                self.label_path = s.get("label_path", "./demo_data/labels")
            self.color_map_on = s.get("color_map_on", self.color_map_on)
            self.color_channel = s.get("color_channel", 0)
            self.color_on = bool(self.color_channel in (1, 3)
                                 and self.color_map_on)
            self.load_model = s.get("load_model", self.load_model)
            if self.load_model:
                self.model_path = s.get("model_path", "")
            self.first_frame_ref = s.get("first_frame_ref", self.first_frame_ref)
            self.begin_frame = s.get("begin_frame", 0)
            self.end_frame = s.get("end_frame", self.end_frame)
            self.step_frame = s.get("step_frame", 1)
            self.seed = s.get("random_seed", self.seed)
            self.kitti_correction_on = s.get("kitti_correct",
                                             self.kitti_correction_on)
            if self.kitti_correction_on:
                self.correction_deg = s.get("correct_deg",
                                            self.correction_deg)
            self.stop_frame_thre = s.get("stop_frame_thre", self.stop_frame_thre)
            self.deskew = s.get("deskew", self.deskew)

        p = args.get("process", {})
        if p:
            self.min_range = p.get("min_range_m", self.min_range)
            self.max_range = p.get("max_range_m", self.max_range)
            self.min_z = p.get("min_z_m", self.min_z)
            self.max_z = p.get("max_z_m", self.max_z)
            self.rand_downsample = p.get("rand_downsample", self.rand_downsample)
            if self.rand_downsample:
                self.rand_down_r = p.get("rand_down_r", self.rand_down_r)
            else:
                self.vox_down_m = p.get("vox_down_m", self.max_range * 1e-3)
            self.adaptive_range_on = p.get("adaptive_range_on", self.adaptive_range_on)
            self.dynamic_filter_on = p.get("dynamic_filter_on", self.dynamic_filter_on)
            self.dynamic_certainty_thre = p.get(
                "dynamic_certainty_thre", self.dynamic_certainty_thre)
            self.dynamic_sdf_ratio_thre = p.get(
                "dynamic_sdf_ratio_thre", self.dynamic_sdf_ratio_thre)
            self.dynamic_min_grad_norm_thre = p.get(
                "dynamic_min_grad_norm_thre", self.dynamic_min_grad_norm_thre)
            self.visibility_filter_on = p.get(
                "visibility_filter_on", self.visibility_filter_on)
            self.visibility_margin_m = p.get(
                "visibility_margin_m", self.visibility_margin_m)
            self.visibility_min_certainty = p.get(
                "visibility_min_certainty", self.visibility_min_certainty)
            if "visibility_hist_offsets" in p:
                self.visibility_hist_offsets = tuple(
                    int(x) for x in p["visibility_hist_offsets"])

        sa = args.get("sampler", {})
        if sa:
            self.surface_sample_range_m = sa.get(
                "surface_sample_range_m", self.vox_down_m * 3.0)
            self.free_sample_begin_ratio = sa.get(
                "free_sample_begin_ratio", self.free_sample_begin_ratio)
            self.free_sample_end_dist_m = sa.get(
                "free_sample_end_dist_m", self.surface_sample_range_m * 4.0)
            self.surface_sample_n = sa.get("surface_sample_n", self.surface_sample_n)
            self.free_front_n = sa.get("free_front_sample_n", self.free_front_n)
            self.free_behind_n = sa.get("free_behind_sample_n", self.free_behind_n)
            self.incidence_label_on = sa.get(
                "incidence_label_on", self.incidence_label_on)
            self.incidence_cos_floor = sa.get(
                "incidence_cos_floor", self.incidence_cos_floor)

        npt = args.get("neuralpoints", {})
        if npt:
            self.voxel_size_m = npt.get("voxel_size_m", self.vox_down_m * 5.0)
            self.query_nn_k = npt.get("query_nn_k", self.query_nn_k)
            self.num_nei_cells = npt.get("num_nei_cells", self.num_nei_cells)
            self.search_alpha = npt.get("search_alpha", self.search_alpha)
            self.feature_dim = npt.get("feature_dim", self.feature_dim)
            self.weighted_first = npt.get("weighted_first", self.weighted_first)
            self.from_sample_points = npt.get(
                "from_sample_points", self.from_sample_points)
            if self.from_sample_points:
                self.map_surface_ratio = npt.get(
                    "map_surface_ratio", self.map_surface_ratio)
            self.prune_map_on = npt.get("prune_map_on", self.prune_map_on)
            self.max_prune_certainty = npt.get(
                "max_prune_certainty", self.max_prune_certainty)
            self.use_mid_ts = npt.get("use_mid_ts", self.use_mid_ts)
            self.local_map_travel_dist_ratio = npt.get(
                "local_map_travel_dist_ratio", self.local_map_travel_dist_ratio)

        d = args.get("decoder", {})
        if d:
            self.geo_mlp_level = d.get("mlp_level", self.geo_mlp_level)
            self.geo_mlp_hidden_dim = d.get("mlp_hidden_dim", self.geo_mlp_hidden_dim)
            self.freeze_after_frame = d.get(
                "freeze_after_frame", self.freeze_after_frame)
        self.color_mlp_level = self.geo_mlp_level
        self.color_mlp_hidden_dim = self.geo_mlp_hidden_dim
        self.sem_mlp_level = self.geo_mlp_level
        self.sem_mlp_hidden_dim = self.geo_mlp_hidden_dim

        lo = args.get("loss", {})
        if lo:
            self.main_loss_type = lo.get("main_loss_type", "bce")
            self.sigma_sigmoid_m = lo.get("sigma_sigmoid_m", self.vox_down_m)
            self.loss_weight_on = lo.get("loss_weight_on", self.loss_weight_on)
            if self.loss_weight_on:
                self.dist_weight_scale = lo.get(
                    "dist_weight_scale", self.dist_weight_scale)
                self.behind_dropoff_on = lo.get(
                    "behind_dropoff_on", self.behind_dropoff_on)
            self.ekional_loss_on = lo.get("ekional_loss_on", self.ekional_loss_on)
            self.weight_e = float(lo.get("weight_e", self.weight_e))
            self.numerical_grad = lo.get("numerical_grad_on", self.numerical_grad)
            if not self.numerical_grad:
                self.gradient_decimation = 1
            else:
                self.gradient_decimation = lo.get(
                    "grad_decimation", self.gradient_decimation)
                self.num_grad_step_ratio = lo.get(
                    "num_grad_step_ratio", self.num_grad_step_ratio)
            self.consistency_loss_on = lo.get(
                "consistency_loss_on", self.consistency_loss_on)

        c = args.get("continual", {})
        if c:
            self.pool_capacity = int(float(c.get("pool_capacity", self.pool_capacity)))
            self.bs_new_sample = int(c.get("batch_size_new_sample", self.bs_new_sample))
            self.new_certainty_thre = float(
                c.get("new_certainty_thre", self.new_certainty_thre))
            self.pool_filter_freq = c.get("pool_filter_freq", 1)

        t = args.get("tracker", {})
        if t:
            self.track_on = True
            if self.color_on:
                self.photometric_loss_on = t.get("photo_loss",
                                                 self.photometric_loss_on)
                if self.photometric_loss_on:
                    self.photometric_loss_weight = float(
                        t.get("photo_weight", self.photometric_loss_weight))
                self.consist_wieght_on = t.get("consist_wieght",
                                               self.consist_wieght_on)
            self.uniform_motion_on = t.get("uniform_motion_on", self.uniform_motion_on)
            self.motion_model = t.get("motion_model", self.motion_model)
            self.motion_damping = t.get("motion_damping",
                                        self.motion_damping)
            self.source_vox_down_m = t.get("source_vox_down_m", self.vox_down_m * 10.0)
            self.reg_iter_n = t.get("iter_n", self.reg_iter_n)
            self.track_mask_query_nn_k = t.get("valid_nn_k", self.query_nn_k)
            self.reg_min_grad_norm = t.get("min_grad_norm", self.reg_min_grad_norm)
            self.reg_max_grad_norm = t.get("max_grad_norm", self.reg_max_grad_norm)
            self.reg_GM_grad = t.get("GM_grad", self.reg_GM_grad)
            self.reg_GM_dist_m = t.get("GM_dist", self.reg_GM_dist_m)
            self.reg_lm_lambda = float(t.get("lm_lambda", self.reg_lm_lambda))
            self.reg_term_thre_deg = float(t.get("term_deg", self.reg_term_thre_deg))
            self.reg_term_thre_m = float(t.get("term_m", self.reg_term_thre_m))
            self.eigenvalue_check = t.get("eigenvalue_check", self.eigenvalue_check)
            self.eigenvalue_ratio_thre = t.get(
                "eigenvalue_ratio_thre", self.eigenvalue_ratio_thre)
            self.final_residual_ratio_thre = float(
                t.get("final_residual_ratio_thre", self.final_residual_ratio_thre))

        if self.track_on and "pgo" in args:
            g = args["pgo"] or {}
            self.pgo_on = True
            self.local_map_context = g.get("map_context", self.local_map_context)
            self.loop_with_feature = g.get("loop_with_feature", self.loop_with_feature)
            self.local_map_context_latency = g.get(
                "local_map_latency", self.local_map_context_latency)
            self.context_virtual_side_count = g.get(
                "virtual_side_count", self.context_virtual_side_count)
            self.context_virtual_step_m = g.get(
                "virtual_step_m", self.voxel_size_m * 4.0)
            self.npmc_max_dist = g.get("npmc_max_dist", self.max_range * 0.7)
            self.pgo_freq = g.get("pgo_freq_frame", self.pgo_freq)
            self.pgo_tran_std = float(g.get("tran_std", self.pgo_tran_std))
            self.pgo_rot_std = float(g.get("rot_std", self.pgo_rot_std))
            self.pgo_loop_tran_std = float(
                g.get("loop_tran_std", self.pgo_loop_tran_std))
            self.pgo_loop_rot_std = float(
                g.get("loop_rot_std", self.pgo_loop_rot_std))
            self.use_reg_cov_mat = g.get("use_reg_cov", False)
            self.pgo_error_thre_frame = float(
                g.get("pgo_error_thre_frame", self.pgo_error_thre_frame))
            self.pgo_max_iter = g.get("pgo_max_iter", self.pgo_max_iter)
            self.context_cosdist_threshold = g.get(
                "context_cosdist", self.context_cosdist_threshold)
            self.min_loop_travel_dist_ratio = g.get(
                "min_loop_travel_ratio", self.min_loop_travel_dist_ratio)
            self.post_loop_iter_boost = int(g.get(
                "post_loop_iter_boost", self.post_loop_iter_boost))
            self.loop_dist_drift_ratio_thre = g.get(
                "max_loop_dist_ratio", self.loop_dist_drift_ratio_thre)
            self.local_loop_dist_thre = g.get(
                "local_loop_dist_thre", self.voxel_size_m * 5.0)

        o = args.get("optimizer", {})
        if o:
            self.mapping_freq_frame = o.get("mapping_freq_frame", 1)
            self.adaptive_iters = o.get("adaptive_iters", self.adaptive_iters)
            self.iters = o.get("iters", self.iters)
            self.init_iter_ratio = o.get("init_iter_ratio", self.init_iter_ratio)
            self.bs = o.get("batch_size", self.bs)
            self.train_subset_hist = int(o.get(
                "train_subset_hist", self.train_subset_hist))
            self.lr = float(o.get("learning_rate", self.lr))
            self.ba_freq_frame = o.get("ba_freq_frame", 0)
            self.ba_frame = o.get("ba_local_frame", self.ba_frame)
            self.lr_pose = float(o.get("lr_pose_ba", self.lr_pose))
            self.lr_ba_map = float(o.get("lr_map_ba", self.lr))
            self.ba_iters = int(o.get("ba_iters", self.ba_iters))
            self.ba_bs = int(o.get("ba_bs", self.ba_bs))
            if self.ba_freq_frame > 0:
                self.stop_frame_thre = self.end_frame

        e = args.get("eval", {})
        if e:
            self.wandb_vis_on = e.get("wandb_vis_on", self.wandb_vis_on)
            self.silence = e.get("silence_log", self.silence)
            self.o3d_vis_on = e.get("o3d_vis_on", self.o3d_vis_on)
            self.gui_backend = e.get("gui_backend", self.gui_backend)
            self.log_freq_frame = e.get("log_freq_frame", self.log_freq_frame)
            self.mesh_freq_frame = e.get("mesh_freq_frame", self.mesh_freq_frame)
            self.sdf_default_on = e.get("sdf_default_on", self.sdf_default_on)
            self.sdfslice_freq_frame = e.get(
                "sdf_freq_frame", self.sdfslice_freq_frame)
            self.sdf_slice_height = e.get("sdf_slice_height",
                                          self.sdf_slice_height)
            self.mesh_default_on = e.get("mesh_default_on",
                                         self.mesh_default_on)
            self.mesh_min_nn = e.get("mesh_min_nn", self.mesh_min_nn)
            self.skip_top_voxel = e.get("skip_top_voxel", self.skip_top_voxel)
            self.min_cluster_vertices = e.get(
                "min_cluster_vertices", self.min_cluster_vertices)
            self.mc_res_m = e.get("mc_res_m", self.voxel_size_m)
            self.save_map = e.get("save_map", self.save_map)
            self.save_merged_pc = e.get("save_merged_pc", self.save_merged_pc)
            self.save_mesh = e.get("save_mesh", self.save_mesh)

        # static shapes (absent in the reference configs)
        tp = args.get("tpu", {})
        if tp:
            self.map_capacity = int(tp.get("map_capacity", self.map_capacity))
            self.frame_point_cap = int(tp.get("frame_point_cap", self.frame_point_cap))
            self.source_point_cap = int(
                tp.get("source_point_cap", self.source_point_cap))
            self.max_frames = int(tp.get("max_frames", self.max_frames))
            self.buffer_size = int(tp.get("hash_table_size", self.buffer_size))
            self.probe_mode = tp.get("probe_mode", self.probe_mode)
            self.local_set_cap = int(tp.get("local_set_cap",
                                            self.local_set_cap))
            self.dp_on = tp.get("dp_on", self.dp_on)
            self.dp_devices = int(tp.get("dp_devices", self.dp_devices))

        return self.finalize()
