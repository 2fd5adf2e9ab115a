"""Configuration of the PyTorch port.

The port's own copy of the part of `pin_slam_tpu/config.py` that its
join-mode geometry loop and its mesher read: the same field names, defaults
and YAML schema, so every config file of the repo loads into both packages
and gives the same values for the fields kept here. Keys of features the
port has not ported yet (loop closure and PGO, visualisation, map saving,
ROS) are ignored; the flags of features whose results it would change
(semantics, colour, dynamic filter, bundle adjustment, consistency loss,
incidence labels, data parallelism) are loaded so that `PinSLAMSystem`
refuses them.
The `tpu` YAML section keeps its name; its static capacities size the
port's fixed-capacity tensors the same way.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import yaml


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class Config:
    # ------------------------------------------------------------------ setting
    first_frame_ref: bool = False
    end_frame: int = 100000
    seed: int = 42
    stop_frame_thre: int = 20
    semantic_on: bool = False          # not ported: refused
    color_on: bool = False             # not ported: refused

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
    dynamic_filter_on: bool = False    # not ported: refused

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
    incidence_label_on: bool = False   # not ported: refused

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
    decoder_freezed: bool = False
    freeze_after_frame: int = 40
    pos_input_dim: int = 3

    # --------------------------------------------------------------------- loss
    main_loss_type: str = "bce"
    sigma_sigmoid_m: float = 0.1
    logistic_gaussian_ratio: float = 0.55
    loss_weight_on: bool = False
    behind_dropoff_on: bool = False
    dist_weight_on: bool = True
    dist_weight_scale: float = 0.8
    numerical_grad: bool = True
    gradient_decimation: int = 10
    num_grad_step_ratio: float = 0.2
    ekional_loss_on: bool = True
    weight_e: float = 0.5
    consistency_loss_on: bool = False  # not ported: refused

    # ---------------------------------------------------------------- optimizer
    mapping_freq_frame: int = 1
    iters: int = 12
    init_iter_ratio: int = 40
    bs: int = 16384
    # per-frame training history subset (slam/mapper.py make_train_loop):
    # probed once per frame and reused epoch-style by the iterations
    train_subset_hist: int = 65536
    lr: float = 0.01
    adam_eps: float = 1e-15
    adaptive_iters: bool = False
    new_sample_ratio_less: float = 0.02
    new_sample_ratio_more: float = 0.15
    new_sample_ratio_restart: float = 0.3
    ba_freq_frame: int = 0             # bundle adjustment, not ported: refused

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

    # --------------------------------------------------------------------- eval
    silence: bool = True
    mesh_freq_frame: int = 20

    # --------------------------------------------------------------------- mesh
    mc_res_m: float = 0.3
    pad_voxel: int = 3
    skip_top_voxel: int = 2
    mc_mask_on: bool = True
    mesh_min_nn: int = 8
    min_cluster_vertices: int = 300
    infer_bs: int = 4096
    save_mesh: bool = False

    # ---------------------------------------------------------- static shapes
    map_capacity: int = 1 << 20
    frame_point_cap: int = 1 << 16
    source_point_cap: int = 1 << 13
    max_frames: int = 1 << 14
    # kNN probe layout: 'join' (the tiled spatial-join k-NN over a per-frame
    # local set; 'auto' resolves to it) drives the track+map loop, 'cells'
    # (the hash-table probe of the 33-cell ball) serves queries without a
    # local set, such as the mesher's; 'brick' raises NotImplementedError.
    probe_mode: str = "auto"
    # capacity of the per-frame compacted local point set (join probe)
    local_set_cap: int = 1 << 17
    dp_on: bool = False                # data parallelism, not ported: refused

    # derived (filled by finalize())
    infer_bs_final: int = 131072

    def finalize(self):
        """Compute derived parameters (reference: utils/config.py:556-562)."""
        self.infer_bs_final = self.bs * 32
        self.window_radius = max(self.max_range, 6.0)
        self.local_map_radius = self.max_range + 2.0
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
            self.semantic_on = s.get("semantic_on", self.semantic_on)
            self.color_on = bool(s.get("color_channel", 0) in (1, 3)
                                 and s.get("color_map_on", True))
            self.first_frame_ref = s.get("first_frame_ref", self.first_frame_ref)
            self.end_frame = s.get("end_frame", self.end_frame)
            self.seed = s.get("random_seed", self.seed)
            self.stop_frame_thre = s.get("stop_frame_thre", self.stop_frame_thre)

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
            if self.ba_freq_frame > 0:
                self.stop_frame_thre = self.end_frame

        e = args.get("eval", {})
        if e:
            self.silence = e.get("silence_log", self.silence)
            self.mesh_freq_frame = e.get("mesh_freq_frame", self.mesh_freq_frame)
            self.mesh_min_nn = e.get("mesh_min_nn", self.mesh_min_nn)
            self.skip_top_voxel = e.get("skip_top_voxel", self.skip_top_voxel)
            self.min_cluster_vertices = e.get(
                "min_cluster_vertices", self.min_cluster_vertices)
            self.mc_res_m = e.get("mc_res_m", self.voxel_size_m)
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

        return self.finalize()
