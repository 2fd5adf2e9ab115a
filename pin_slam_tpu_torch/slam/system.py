"""PIN-SLAM system orchestrator: the per-frame track+map loop. Port of
`pin_slam_tpu/slam/system.py`:

  I.   preprocess   — range/z crop + train/source voxel downsample
  II.  odometry     — GN registration + pose selection: against a local set
                      under the join probe, against the whole map state
                      through its hash table under `probe_mode` cells or
                      brick
  III. loop closure — the caller's `loop_hook` (slam/loop.LoopPgoManager
                      .after_frame) after the frame's host pull
  IV.  mapping      — the map-based dynamic filter (`dynamic_filter_on`,
                      with the visibility test of ops/visibility.py under
                      `visibility_filter_on`), sample + map insert + pool
                      append + new-sample detection, then the per-frame
                      training run, preceded every `ba_freq_frame` frames
                      by sliding-window bundle adjustment (slam/ba.py);
                      the training runs over compact local features under
                      the join probe and over the whole map otherwise

With `color_on` the points carry colour columns ([N, 3 + color_channel]):
the map keeps colour features and a colour decoder, the tracker takes its
uncached colour path (against a local set built each frame under the join
probe), and the samples train the colour head. With `semantic_on`, `process_frame(sem_labels=...)`
labels the points and the samples train the semantic head. The training
options `incidence_label_on` (geometric incidence labels,
ops/range_image.py), `consistency_loss_on` and `proj_correction_on` work
under every probe.

In localization mode (`load_map`) the decoders and the map are frozen:
every frame is tracked against the whole loaded map without the travel
window (through a join set built once under the join probe), and no
mapping, training, pruning or pool filtering is dispatched.

The host keeps float64 pose chains and travel distance; the device works in
float32 with a per-frame anchor (the last sensor position). The map grows
its capacity when it passes 90 % of it. With `dp_on` and more than one
replica device (the visible cards, `dp_devices` of them, or the `mesh`
argument) the training runs data-parallel (`mapper.make_train_loop(mesh=)`)
and `self.mesh` holds the replica devices for the meshers; otherwise
`self.mesh` is None and the run is the single-device run, as the JAX
package's rule has it. Under the brick probe the map keeps its brick
cache; under the join and cell probes it keeps none (the JAX package
maintains one under cells too, which no probe of that mode reads).

Host syncs per frame: one per GN iteration of the tracker (its stop flag)
and one batched pull after the mapping dispatches (pose, validity,
iteration count, overflow counts).

Each frame is a `frame` span of `utils/tracing.py`, with stage spans
inside it; `timings` is read from the stage spans (`TIMING_COLUMNS`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pin_slam_tpu_torch.config import Config
from pin_slam_tpu_torch.device import resolve_device
from pin_slam_tpu_torch.models import neural_points as npm
from pin_slam_tpu_torch.models.decoder import init_mlp_params
from pin_slam_tpu_torch.models.sampler import sample_training_points
from pin_slam_tpu_torch.ops import knn_join as kj
from pin_slam_tpu_torch.ops.range_image import estimate_scan_incidence
from pin_slam_tpu_torch.ops.transforms import (
    np_rotation_angle_deg,
    np_se3_inv,
    np_slerp_rotmats,
    transform_points,
)
from pin_slam_tpu_torch.ops.visibility import (
    render_min_range_bins,
    visibility_free_mask,
)
from pin_slam_tpu_torch.ops.voxel import voxel_down_sample_hash_mask
from pin_slam_tpu_torch.parallel import dp
from pin_slam_tpu_torch.slam import map_query as mq
from pin_slam_tpu_torch.slam import mapper as mp
from pin_slam_tpu_torch.slam import tracker as tk
from pin_slam_tpu_torch.slam.ba import run_bundle_adjustment
from pin_slam_tpu_torch.utils import tracing

# the stage spans summed into each `timings` column: preprocess, odometry,
# pgo, map-prep, map-opt
TIMING_COLUMNS = (("frame.preprocess",), ("frame.odometry", "frame.pull"),
                  ("loop.after_frame",), ("frame.map_update",),
                  ("mapper.train", "ba.run"))


def compute_init_guess(uniform_motion: bool, motion_model: str,
                       last_pose: np.ndarray, last_tran: np.ndarray,
                       damping: float = 0.5) -> np.ndarray:
    """Tracker initial guess. "full" extrapolates the whole last relative
    motion; "translation" extrapolates the translation but keeps the last
    orientation; "damped" extrapolates the translation fully and only
    `damping` of the rotation."""
    if not uniform_motion:
        return last_pose.copy()
    if motion_model == "translation":
        init = last_pose.copy()
        init[:3, 3] = (last_pose @ last_tran)[:3, 3]
        return init
    if motion_model == "damped":
        tran = last_tran.copy()
        tran[:3, :3] = np_slerp_rotmats(
            last_tran[:3, :3], np.array([damping]))[0]
        init = last_pose @ tran
        init[:3, 3] = (last_pose @ last_tran)[:3, 3]
        return init
    return last_pose @ last_tran


def _pad_points(pts: np.ndarray, cap: int, attr_dim: int = 0):
    """Pad [N, 3 + attr] to [cap, 3] and [cap, max(attr_dim, 1)] (the loop
    closure passes x, y, z only: its attributes are 0); returns (padded,
    attributes, n)."""
    n = min(pts.shape[0], cap)
    out = np.zeros((cap, 3), np.float32)
    out[:n] = pts[:n, :3]
    attr = np.zeros((cap, max(attr_dim, 1)), np.float32)
    k = min(attr_dim, pts.shape[1] - 3)     # absent columns stay 0
    if k > 0:
        attr[:n, :k] = pts[:n, 3: 3 + k]
    return out, attr, n


class PinSLAMSystem:
    """Host-side orchestrator owning all device state."""

    def __init__(self, config: Config, device=None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        self.config = c = config
        self.device = resolve_device(device)
        # data parallelism (`dp_on`): the replica devices of the training
        # loop and the meshers; `mesh` names them (tests: ["cpu"] * 8),
        # else the visible cards. One replica is the single-device run.
        self.mesh = None
        if c.dp_on:
            if mesh is None and self.device.type == "cuda" \
                    and torch.cuda.device_count() > 1:
                mesh = dp.make_mesh(c.dp_devices or None)
            if mesh is not None and len(mesh) > 1:
                self.mesh = dp.make_mesh(devices=mesh)
        # one explicit generator drives every random draw of the system
        self.gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(c.seed)
        self.qp = mq.make_query_params(c)
        # kept for the JAX package's API: the offset rotation by point
        # orientations is always on (identity until the first deformation)
        self.after_pgo = False

        # the join probe queries per-frame local sets; the cell and brick
        # probes query the whole map state through its hash table
        self._use_join = self.qp.probe_mode == "join"
        dev = self.device
        self.state = npm.init_map_state(
            c.map_capacity, c.buffer_size, c.feature_dim,
            color_on=c.color_on, device=dev,
            with_btable=self.qp.probe_mode == "brick")
        self.pool = mp.init_pool(c.pool_capacity,
                                 c.frame_point_cap * c.all_sample_n,
                                 semantic_on=c.semantic_on,
                                 color_channel=(c.color_channel
                                                if c.color_on else 0),
                                 device=dev)
        init_gen = torch.Generator().manual_seed(c.seed)
        in_dim = c.feature_dim + c.pos_input_dim
        self.params = {
            "geo_mlp": init_mlp_params(
                init_gen, in_dim, c.geo_mlp_hidden_dim, c.geo_mlp_level, 1,
                c.mlp_bias_on, device=dev),
        }
        if c.color_on:
            self.params["color_mlp"] = init_mlp_params(
                init_gen, in_dim, c.color_mlp_hidden_dim, c.color_mlp_level,
                c.color_channel, c.mlp_bias_on, device=dev)
        if c.semantic_on:
            self.params["sem_mlp"] = init_mlp_params(
                init_gen, in_dim, c.sem_mlp_hidden_dim, c.sem_mlp_level,
                c.sem_class_count, c.mlp_bias_on, device=dev)
        self.sync_feature_params()

        # ------------------------------------------------ host state
        self.max_frames = c.max_frames
        self.odom_poses = np.zeros((self.max_frames, 4, 4))
        self.pgo_poses = np.zeros((self.max_frames, 4, 4))
        self.gt_poses: Optional[np.ndarray] = None
        self.travel_dist = np.zeros(self.max_frames)
        self.cur_pose_ref = np.eye(4)
        self.last_pose_ref = np.eye(4)
        self.last_odom_tran = np.eye(4)
        self.cur_frame = 0
        self.lose_track = False
        self.cap_overflow_frames = 0
        self.cap_overflow_max_ratio = 0.0
        self.stop_status = False
        self.stop_count = 0
        self.consecutive_lose_track_frame = 0
        self.reboot_ts = 0
        self.decoder_freezed = c.decoder_freezed
        self.last_tracking = None
        self.last_train_losses = None
        # the last training's {"loss": device scalar}, read by the logger
        self.last_train_metrics = None
        # the last training's per-iteration terms ({"consistency_loss":
        # [iters]}) and the last frame's incidence cosines and their rows
        self.last_train_terms = None
        self.last_incidence = None
        self.last_ba_losses = None
        # iterations and surface samples of the last BA run (slam/ba.py)
        self.last_ba_iters = 0
        self.last_ba_samples = 0
        self.last_track_iters = -1
        # the dynamic filter's last verdict over the train cloud (rows <
        # last_train_n), kept to score it against mover ground truth
        self.last_static_mask = None
        self.last_train_pts = None
        self.last_train_n = None
        # per-frame [preprocess, odometry, pgo, map-prep, map-opt] seconds
        # of host time, from the frame's stage spans (TIMING_COLUMNS)
        self.timings = []
        self.new_obs_ratio = 1.0
        self.adaptive_iter_offset = 0
        self.last_did_map = False
        self.last_pull_block = 0.0
        # localization mode (load_map): the frozen map's join set, built
        # once, and its compact geometry and colour (or None) features
        self.localization_mode = False
        self._loc_lset = None
        self._loc_feats = None
        self._loc_cfeats = None
        # post-train local set + trained compact features, reused as the
        # next frame's tracker search structure
        self._cur_lset = None
        self._cur_track_feats = None
        self._prefetch = None
        self._train_loops = {}
        # the captured whole-map iteration of the last map shape, shared by
        # the loops above
        self._train_graph = {}
        # False until the first elastic deformation: until then every
        # orientation is the identity and the training local set carries
        # none, so its decodes skip the offset rotation
        self._map_deformed = False
        # extra mapping iterations requested by an accepted loop closure,
        # consumed by the next training run
        self.post_loop_iter_boost_pending = 0

        self.local_window_dist = c.local_map_radius * \
            c.local_map_travel_dist_ratio
        self._loss_kwargs = dict(
            # the BCE sharpness is the SCALED sigma (the decoder's scale)
            sigma_sigmoid_m=c.sdf_scale,
            loss_weight_on=c.loss_weight_on,
            ekional_loss_on=c.ekional_loss_on,
            weight_e=c.weight_e,
            numerical_grad_eps=c.voxel_size_m * c.num_grad_step_ratio,
            gradient_decimation=c.gradient_decimation,
            main_loss_type=c.main_loss_type,
            surface_sample_range_m=c.surface_sample_range_m,
            semantic_on=c.semantic_on,
            weight_s=c.weight_s,
            freespace_label_on=c.freespace_label_on,
            sem_label_decimation=c.sem_label_decimation,
            color_on=c.color_on,
            weight_i=c.weight_i,
            color_channel=c.color_channel,
            proj_correction_on=c.proj_correction_on,
            consistency_loss_on=c.consistency_loss_on,
            weight_c=c.weight_c,
            consistency_count=c.consistency_count,
            consistency_range=c.consistency_range,
        )
        tp = tk.TrackerParams(
            reg_iter_n=c.reg_iter_n,
            min_grad_norm=c.reg_min_grad_norm,
            max_grad_norm=c.reg_max_grad_norm,
            gm_dist=c.reg_GM_dist_m,
            gm_grad=c.reg_GM_grad,
            lm_lambda=c.reg_lm_lambda,
            term_thre_deg=c.reg_term_thre_deg,
            term_thre_m=c.reg_term_thre_m,
            max_sdf_std=c.surface_sample_range_m * c.max_sdf_std_ratio,
            max_valid_residual_cm=(
                c.surface_sample_range_m * c.final_residual_ratio_thre
                * 100.0),
            min_valid_ratio=0.2,
            min_valid_points=30,
            mask_min_nn_count=c.track_mask_query_nn_k,
            eigenvalue_check=c.eigenvalue_check,
            eigenvalue_ratio_thre=c.eigenvalue_ratio_thre,
            weighted_first=c.weighted_first,
            color_mode=(2 if (c.color_on and c.photometric_loss_on)
                        else 1 if (c.color_on and c.consist_wieght_on)
                        else 0),
            photometric_weight=c.photometric_loss_weight,
            color_channel=max(c.color_channel, 1),
        )
        self._use_color_track = tp.color_mode > 0
        self._track = tk.make_tracker(self.qp, tp)
        # a loop closure's re-registration accepts a smaller valid share
        self._track_loop = tk.make_tracker(
            self.qp, tp._replace(min_valid_ratio=0.15))

    # ------------------------------------------------------------ stages

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def sync_feature_params(self):
        """Point params["geo_features"] (and "color_features") at the map's
        arrays; called wherever the map state is replaced."""
        self.params["geo_features"] = self.state.geo_features
        if self.state.color_features is not None:
            self.params["color_features"] = self.state.color_features

    def build_lset_track(self, travel, cur_ts, sensor_pos, reboot_ts):
        """Tracking local set (travel window + sensor radius) and its
        compact geometry and colour (or None) features."""
        c = self.config
        s = self.state
        m = npm.local_map_mask(
            s, travel, cur_ts, self.local_window_dist,
            sensor_pos=sensor_pos, local_map_radius=c.local_map_radius,
            reboot_ts=reboot_ts, use_mid_ts=c.use_mid_ts)
        ls = kj.build_local_set(s.positions, m, c.voxel_size_m,
                                c.local_set_cap, certainty=s.certainty,
                                orientations=s.orientations)
        cfeats = (None if s.color_features is None
                  else s.color_features[ls.gidx])
        return ls, self.params["geo_features"][ls.gidx], cfeats

    def build_lset_train(self, travel, cur_ts, reboot_ts):
        """Training local set (travel window), with certainty and update
        timestamps. Until the first map deformation all orientations are
        identity, so the set carries none and every decode skips the
        rotation; after it the set carries them."""
        c = self.config
        s = self.state
        m = npm.local_map_mask(s, travel, cur_ts, self.local_window_dist,
                               reboot_ts=reboot_ts, use_mid_ts=c.use_mid_ts)
        return kj.build_local_set(
            s.positions, m, c.voxel_size_m, c.local_set_cap,
            certainty=s.certainty, ts_update=s.ts_update,
            orientations=s.orientations if self._map_deformed else None)

    def select_pose(self, valid, iters, pose_a, T_init_a, anchor, td, fid):
        """Device-side pose pick (the initial guess on an early failure),
        travel-distance extension and mapping gate (teleport check)."""
        c = self.config
        use_pose = valid | (iters >= 10)
        Ta = torch.where(use_pose, pose_a, T_init_a)
        tran = torch.linalg.norm(Ta[:3, 3])
        td_new = td.clone()
        td_new[fid] = td[fid - 1] + tran
        teleport = tran > c.surface_sample_range_m * 20.0
        T_world = Ta.clone()
        T_world[:3, 3] += anchor
        return T_world, td_new, valid & ~teleport

    def track_chain(self, src_pts, src_n, T_init, anchor, fid, travel,
                    sensor_pos, src_attr=None):
        """Local-set build + GN registration + pose selection (first
        frames, whenever no post-train set is cached, and every frame of
        colour tracking, whose set carries the colour features)."""
        lset, feats, cfeats = self.build_lset_track(
            travel, fid - 1, sensor_pos, self.reboot_ts)
        return self.track_chain_cached(feats, src_pts, src_n, T_init,
                                       travel, anchor, fid, lset,
                                       cfeats=cfeats, src_attr=src_attr)

    def track_chain_cached(self, feats, src_pts, src_n, T_init, td, anchor,
                           fid, lset, cfeats=None, src_attr=None, state=None,
                           lf=None):
        """GN registration against a given local set (or, with `lset=None`,
        against the map `state` under the LocalFilter `lf`: the cell and
        brick probes) + pose selection. Colour tracking takes the colour
        features `cfeats` aligned with `feats` and the source points'
        colours `src_attr`."""
        c = self.config
        mask = torch.arange(src_pts.shape[0], device=self.device) < src_n
        color_kw = {}
        if self._use_color_track:
            cols = src_attr[:, : c.color_channel]
            color_kw = dict(src_intensity=tk.intensity(cols,
                                                        c.color_channel),
                            color_features=cfeats,
                            color_mlp=self.params["color_mlp"])
        res = self._track(feats, self.params["geo_mlp"], src_pts, mask,
                          T_init, anchor, lset, state=state, lf=lf,
                          **color_kw)
        T32, td_new, mapok = self.select_pose(
            res.valid, res.iterations, res.pose, T_init, anchor, td, fid)
        return res, T32, td_new, mapok

    def preprocess(self, raw: torch.Tensor, attr: torch.Tensor,
                   n_valid: int, max_range_eff: float, train_vox: float,
                   source_vox: float):
        """Range/z crop, train and source voxel downsample, and compaction
        to the static caps; the attribute columns (colour, semantic label)
        follow their points. Past a cap the cloud thins UNIFORMLY (a prefix
        cut would blind a fixed azimuth wedge); the pre-cap totals are
        returned so overflow is counted, never silent."""
        c = self.config
        dev = raw.device
        cap_r = raw.shape[0]
        mask = torch.arange(cap_r, device=dev) < n_valid
        d = torch.linalg.norm(raw, dim=1)
        mask &= (d > c.min_range) & (d < max_range_eff)
        mask &= (raw[:, 2] > c.min_z) & (raw[:, 2] < c.max_z)
        if c.rand_downsample:
            train_keep = mask & (torch.rand(cap_r, generator=self.gen,
                                            device=dev) < c.rand_down_r)
        else:
            train_keep = voxel_down_sample_hash_mask(
                raw, mask, train_vox, 1 << 21) & mask

        def compact(keep, cap):
            order = torch.cumsum(keep.to(torch.int64), 0) - 1
            total = torch.clamp(order[-1] + 1, min=1)
            stride = torch.div(total + cap - 1, cap, rounding_mode="floor")
            keep = keep & (torch.remainder(order, stride) == 0)
            order = torch.cumsum(keep.to(torch.int64), 0) - 1
            ok = keep & (order < cap)
            dest = torch.where(ok, order, torch.full_like(order, cap))
            out = torch.zeros((cap + 1, 3), device=dev)
            out[dest] = raw     # dropped rows land in the discarded row cap
            a_out = torch.zeros((cap + 1, attr.shape[1]), device=dev)
            a_out[dest] = attr
            return out[:cap], a_out[:cap], ok.sum(), total

        train_pts, train_attr, train_n, train_total = compact(
            train_keep, c.frame_point_cap)
        src_keep = voxel_down_sample_hash_mask(
            raw, train_keep, source_vox, 1 << 18) & train_keep
        src_pts, src_attr, src_n, src_total = compact(src_keep,
                                                      c.source_point_cap)
        return (train_pts, train_attr, train_n, src_pts, src_attr, src_n,
                train_total, src_total)

    def _run_preprocess(self, points: np.ndarray,
                        sem_labels: Optional[np.ndarray] = None,
                        cap: Optional[int] = None):
        """Pad to `cap` rows (default: the next power of two; a longer cloud
        is cut to `cap`), upload, and run stage I. The attribute columns
        are the colour (`color_channel` columns after x, y, z) and then the
        semantic label."""
        c = self.config
        if cap is None:
            cap = 1 << int(np.ceil(np.log2(max(points.shape[0], 2))))
        attr_dim = (c.color_channel if c.color_on else 0) + int(c.semantic_on)
        pts_in = np.asarray(points, np.float32)
        if c.semantic_on and sem_labels is not None:
            pts_in = np.hstack([pts_in[:, : 3 + attr_dim - 1],
                                np.asarray(sem_labels, np.float32)[:, None]])
        raw, attr, n_raw = _pad_points(pts_in, cap, attr_dim)
        max_range_eff = c.max_range
        if c.adaptive_range_on:
            pts = raw[:n_raw]
            mx, mn = pts.max(0), pts.min(0)
            max_x_y_min_range = max(min(abs(mx[0]), abs(mn[0])),
                                    min(abs(mx[1]), abs(mn[1])))
            max_range_eff = float(min(c.max_range, 2.0 * max_x_y_min_range))
        ratio = max_range_eff / c.max_range
        return self.preprocess(
            self._tensor(raw), self._tensor(attr), n_raw, max_range_eff,
            c.vox_down_m * ratio, c.source_vox_down_m * ratio)

    def frame_update(self, train_pts, train_n, T, cur_ts, travel_dist,
                     force_all_new: bool, do_map, insert_cap: int,
                     noise=None, static_mask=None, train_attr=None):
        """Sample along the rays, insert map points, append to the pool and
        mark the new samples. `do_map` is a device-side gate: when False
        every sample mask is cleared and the update changes no counts.
        `static_mask` (the dynamic filter's verdict) drops the rows it
        clears. `train_attr` carries the points' colours and semantic
        labels (see `_run_preprocess`). `noise` replaces the sampler's
        random draws (parity tests)."""
        c = self.config
        dev = self.device
        colors = sem = None
        if c.color_on:
            colors = train_attr[:, : c.color_channel]
        if c.semantic_on:
            sem = train_attr[:, c.color_channel if c.color_on else 0].to(
                torch.int32)
        mask = (torch.arange(train_pts.shape[0], device=dev) < train_n) \
            & do_map
        if static_mask is not None:
            mask = mask & static_mask
        cos_inc = None
        if c.incidence_label_on:
            cos_inc = estimate_scan_incidence(
                train_pts, mask, n_az=c.incidence_bins_az,
                n_el=c.incidence_bins_el,
                range_gate_m=c.incidence_range_gate_m,
                cos_floor=c.incidence_cos_floor)
            self.last_incidence = (cos_inc, mask)
        smp = sample_training_points(
            self.gen, train_pts, mask,
            surface_sample_range_m=c.surface_sample_range_m,
            surface_sample_n=c.surface_sample_n,
            free_front_n=c.free_front_n, free_behind_n=c.free_behind_n,
            free_sample_begin_ratio=c.free_sample_begin_ratio,
            free_sample_end_dist_m=c.free_sample_end_dist_m,
            max_range=c.max_range, dist_weight_on=c.dist_weight_on,
            dist_weight_scale=c.dist_weight_scale,
            behind_dropoff_on=c.behind_dropoff_on, noise=noise,
            sem_labels=sem, colors=colors, cos_inc=cos_inc,
            incidence_mode=c.incidence_mode)
        world = transform_points(smp.points, T)
        # ONE near-surface compaction feeds both the map-insert candidates
        # and the new-sample detection
        ki, kvalid, kpts, ksdf = mp.compact_near_surface(
            world, smp.sdf_label, smp.mask,
            surface_sample_range_m=c.surface_sample_range_m,
            cap=min(world.shape[0], 1 << 17))
        if c.from_sample_points and not c.from_all_samples:
            upd_pts = kpts
            upd_mask = kvalid & (torch.abs(ksdf) < c.surface_sample_range_m
                                 * c.map_surface_ratio)
        else:
            upd_pts, upd_mask = world, smp.mask
        self.state, new_ratio = npm.insert_points(
            self.state, upd_pts, upd_mask, cur_ts, travel_dist,
            resolution=c.voxel_size_m,
            local_window_dist=self.local_window_dist,
            force_all_new=force_all_new, insert_cap=insert_cap,
            maintain_btable=not self._use_join)
        frame_start = mp.append_start(self.pool, world.shape[0])
        self.pool = mp.append_samples(self.pool, world, smp.sdf_label,
                                      smp.weight, smp.mask, cur_ts,
                                      sem_label=smp.sem_label,
                                      color_label=smp.color_label)
        self.pool = mp.detect_new_samples_compact(
            self.state, self.pool, kpts, kvalid, frame_start + ki,
            resolution=c.voxel_size_m,
            new_certainty_thre=c.new_certainty_thre)
        new_obs_ratio = (self.pool.new_count.to(torch.float32)
                         / torch.clamp(smp.mask.sum(), min=1))
        return new_ratio, new_obs_ratio

    def prune_and_rehash(self, cur_ts, travel_dist):
        c = self.config
        state, n = npm.prune_map(
            self.state, cur_ts, travel_dist,
            prune_certainty_thre=c.max_prune_certainty,
            local_window_dist=self.local_window_dist)
        self.state = npm.rehash(state, cur_ts, resolution=c.voxel_size_m,
                                use_mid_ts=c.use_mid_ts)
        self.sync_feature_params()
        return n

    def filter_pool(self, origin):
        self.pool = mp.filter_pool(self.pool, origin, self.config.window_radius)

    def dynamic_filter(self, pts_world, mask, lf, hist_origins=None,
                       fused: Optional[bool] = None):
        """Map-based dynamic filter: [N] bool, True for the rows of `mask`
        judged static. A measurement where the map decodes confident
        positive SDF lies in free space and is dynamic. With
        `visibility_filter_on` and `hist_origins` ([1 + H, 3]: the current
        origin, which bounds the elevation band, then H historic origins)
        the visibility test also flags measurements in space the historic
        scans saw through, except where the map confidently decodes a known
        surface. Under weighted_first=False the SDF goes through the fused
        decode kernel (`fused=False` forces the plain decode, for
        comparisons)."""
        c = self.config
        s = self.state
        if fused is None:
            fused = not self.qp.weighted_first
        with torch.no_grad():
            out = mq.query_decode(self.params["geo_features"],
                                  self.params["geo_mlp"], pts_world, self.qp,
                                  state=s, lf=lf, fused=fused)
            static = (out.certainty < c.dynamic_certainty_thre) | (
                out.sdf < c.dynamic_sdf_ratio_thre * c.voxel_size_m)
            if c.visibility_filter_on and hist_origins is not None:
                d0 = pts_world - hist_origins[0]
                r0 = torch.linalg.norm(d0, dim=1)
                el0 = torch.asin(torch.clamp(
                    d0[:, 2] / torch.clamp(r0, min=1e-6), -1.0, 1.0))
                el_lo = torch.where(mask, el0,
                                    torch.full_like(el0, 1e9)).amin()
                el_hi = torch.where(mask, el0,
                                    torch.full_like(el0, -1e9)).amax()
                pvalid = ((torch.arange(s.capacity + 1, device=s.count.device)
                           < s.count)
                          & (s.certainty >= c.visibility_min_certainty))
                img = render_min_range_bins(
                    hist_origins[1:], s.positions, pvalid,
                    n_az=c.visibility_bins_az, n_el=c.visibility_bins_el,
                    el_lo=el_lo, el_hi=el_hi)
                dyn = visibility_free_mask(
                    hist_origins[1:], img, pts_world, mask,
                    margin_m=c.visibility_margin_m,
                    rel_margin=c.visibility_rel_margin,
                    min_judge_range=c.min_range,
                    max_judge_range=c.visibility_range_ratio * c.max_range,
                    el_lo=el_lo, el_hi=el_hi,
                    el_slack=float(np.radians(c.visibility_el_slack_deg)),
                    min_votes=c.visibility_min_votes)
                # a measurement the map confidently decodes as near-surface
                # is an established static surface, whatever the coarse
                # visibility bins say
                known_surface = ((out.certainty >= c.dynamic_certainty_thre)
                                 & (torch.abs(out.sdf)
                                    < 1.5 * c.voxel_size_m))
                static = static & ~(dyn & ~known_surface)
        return mask & static

    # -------------------------------------------------------------- helpers

    def _get_train_loop(self, iters: int, train_decoder: bool):
        k = (iters, train_decoder)
        if k not in self._train_loops:
            c = self.config
            self._train_loops[k] = mp.make_train_loop(
                self.qp, lr=c.lr, adam_eps=c.adam_eps, n_iters=iters,
                bs=c.bs, bs_new=c.bs_new_sample, train_decoder=train_decoder,
                loss_kwargs=self._loss_kwargs,
                subset_hist=c.train_subset_hist, mesh=self.mesh,
                graph=self._train_graph)
        return self._train_loops[k]

    def _lf(self, cur_ts: int, sensor_pos=None) -> mq.LocalFilter:
        """The travel-window filter of lset-less queries of the whole map
        (the tracker and the training under the cell and brick probes,
        bundle adjustment, the dynamic filter) at frame `cur_ts`, with the
        sensor origins of the frames under `proj_correction_on`."""
        c = self.config
        return mq.LocalFilter(
            travel_dist=self._tensor(self.travel_dist[: self.max_frames]),
            cur_ts=int(cur_ts), local_window_dist=self.local_window_dist,
            sensor_pos=None if sensor_pos is None
            else self._tensor(sensor_pos),
            local_map_radius=c.local_map_radius, reboot_ts=self.reboot_ts,
            sensor_origins=self._tensor(
                self.pgo_poses[: self.max_frames, :3, 3])
            if c.proj_correction_on else None)

    def set_gt_poses(self, gt: np.ndarray):
        self.gt_poses = gt

    def grow_map_capacity(self, factor: int = 2):
        """Multiply the map capacity by `factor` when the map nears it. The
        cached local sets, training loops and captured iterations refer to
        the old capacity and are dropped."""
        c = self.config
        new_cap = c.map_capacity * factor
        if not c.silence:
            print(f"map capacity {c.map_capacity} -> {new_cap} "
                  f"(count {int(self.state.count)})")
        self.state = npm.grow_capacity(self.state, new_cap)
        c.map_capacity = new_cap
        self.sync_feature_params()
        self._train_loops = {}
        self._train_graph.clear()
        self._cur_lset = None
        self._cur_track_feats = None

    def set_after_pgo(self, on: bool):
        """The offset rotation by point orientations is always on (identity
        quaternions make it a no-op until the first deformation); kept for
        the JAX package's API."""
        self.after_pgo = on

    def map_memory_mb(self) -> float:
        """Neural-point map memory in MB: the per-point tensors count at
        count/capacity of their rows (the reference's grow-on-demand
        equivalent), the hash table whole."""
        s = self.state
        per_point = sum(
            a.element_size() * int(np.prod(a.shape[1:])) * (a.shape[0] - 1)
            for a in (s.positions, s.orientations, s.geo_features,
                      s.ts_create, s.ts_update, s.certainty,
                      s.color_features) if a is not None)
        aux = s.table.element_size() * s.table.numel() + (
            0 if s.btable is None
            else s.btable.element_size() * s.btable.numel())
        frac = int(s.count) / max(s.capacity, 1)
        return (per_point * frac + aux) / (1024.0 ** 2)

    def load_map(self, path: str):
        """Enter localization mode with a saved map (`utils/map_io`): the
        map and the decoders are frozen, no mapping runs, and every frame
        is tracked against the whole map (no travel window): through a join
        set built here once over all live rows under the join probe, else
        through the map's hash table (with its brick cache, rebuilt here,
        under the brick probe)."""
        from pin_slam_tpu_torch.utils.map_io import load_implicit_map

        c = self.config
        state, mlps, _ = load_implicit_map(
            path, capacity=c.map_capacity, device=self.device,
            with_btable=self.qp.probe_mode == "brick")
        self.state = state
        self.params["geo_mlp"] = mlps["geo_mlp"]
        for name, on in (("color_mlp", c.color_on),
                         ("sem_mlp", c.semantic_on)):
            if on and name in mlps:
                self.params[name] = mlps[name]
        self.sync_feature_params()
        self.decoder_freezed = True
        self.localization_mode = True
        # a saved map may carry deformed orientations
        self._map_deformed = bool((state.orientations[:, 1:4] != 0).any())
        if not self._use_join:
            return
        cnt = int(state.count)
        cap = max(1, -(-cnt // kj.TL)) * kj.TL
        live = torch.arange(state.capacity, device=self.device) < cnt
        self._loc_lset = kj.build_local_set(
            state.positions, live, c.voxel_size_m, cap,
            certainty=state.certainty,
            orientations=state.orientations if self._map_deformed else None)
        self._loc_feats = self.params["geo_features"][self._loc_lset.gidx]
        self._loc_cfeats = (None if state.color_features is None
                            else state.color_features[self._loc_lset.gidx])

    # ------------------------------------------------------------ main loop

    def process_frame(self, frame_id: int, points: np.ndarray,
                      point_ts: Optional[np.ndarray] = None,
                      gt_pose: Optional[np.ndarray] = None,
                      loop_hook=None,
                      sem_labels: Optional[np.ndarray] = None,
                      next_points: Optional[np.ndarray] = None,
                      next_sem_labels: Optional[np.ndarray] = None):
        """Run preprocess, odometry and mapping for one frame. `points` is
        [N, 3] in the sensor frame, [N, 3 + color_channel] with colour in
        [0, 1] when `color_on`; `sem_labels` [N] int when `semantic_on`
        (0: unlabeled). `next_points` (optional) is the NEXT frame's raw
        cloud (and `next_sem_labels` its labels): its preprocess is
        dispatched before this frame's host pull and reused when the caller
        passes the same cloud as frame_id+1's `points`.
        `loop_hook(frame_id)` runs after the frame's host pull (the loop
        closure + PGO slot, `timings` column 2). Returns the pose estimate
        (4x4 float64). The frame runs inside a `frame` span; its row of
        `timings` sums its stage spans (TIMING_COLUMNS)."""
        with tracing.frame(frame_id):
            pose = self._process_frame(frame_id, points, loop_hook,
                                       sem_labels, next_points,
                                       next_sem_labels)
        st = tracing.TRACER.stage_s
        self.timings.append([sum(st.get(n, 0.0) for n in col)
                             for col in TIMING_COLUMNS])
        return pose

    def _process_frame(self, frame_id, points, loop_hook, sem_labels,
                       next_points, next_sem_labels):
        c = self.config
        dev = self.device

        # ---- initial guess
        if frame_id == 0:
            if self.gt_poses is not None and not c.first_frame_ref:
                self.cur_pose_ref = self.gt_poses[0]
            self.odom_poses[0] = self.cur_pose_ref
            self.pgo_poses[0] = self.cur_pose_ref
            self.travel_dist[0] = 0.0
            self.last_pose_ref = self.cur_pose_ref
            init_guess = self.cur_pose_ref
        else:
            init_guess = compute_init_guess(
                c.uniform_motion_on and not self.lose_track,
                c.motion_model, self.last_pose_ref, self.last_odom_tran,
                damping=c.motion_damping)
            if not c.track_on and self.gt_poses is not None:
                init_guess = self.gt_poses[frame_id]

        # ---- invalid frame guard
        if points.shape[0] < 10:
            self.odom_poses[frame_id] = init_guess
            self.pgo_poses[frame_id] = init_guess
            self.cur_pose_ref = init_guess
            self.travel_dist[frame_id] = self.travel_dist[max(frame_id - 1,
                                                              0)]
            self.cur_frame = frame_id + 1
            return init_guess.copy()

        # ---- I. preprocess (reuse the one dispatched ahead, if any)
        with tracing.stage("frame.preprocess"):
            if self._prefetch is not None and self._prefetch[0] == frame_id:
                pre = self._prefetch[1]
            else:
                pre = self._run_preprocess(points, sem_labels)
            self._prefetch = None
        (train_pts, train_attr, train_n, src_pts, src_attr, src_n,
         train_total, src_total) = pre

        # ---- II. odometry
        with tracing.stage("frame.odometry"):
            td_host = self._tensor(self.travel_dist[: self.max_frames])
            if frame_id > 0 and c.track_on:
                anchor = self.last_pose_ref[:3, 3].copy()
                T_init = init_guess.copy()
                T_init[:3, 3] -= anchor
                T_init_d = self._tensor(T_init)
                anchor_d = self._tensor(anchor)
                if not self._use_join:
                    # the whole map through its hash table, every GN iteration;
                    # localization mode drops the travel window
                    res, T32_dev, td_dev, mapok_dev = self.track_chain_cached(
                        self.params["geo_features"], src_pts, src_n, T_init_d,
                        td_host, anchor_d, frame_id, None,
                        cfeats=self.params.get("color_features"),
                        src_attr=src_attr, state=self.state,
                        lf=None if self.localization_mode else self._lf(
                            frame_id - 1,
                            sensor_pos=self.last_pose_ref[:3, 3] - anchor))
                elif self.localization_mode:
                    # the frozen map's join set, built once by load_map
                    res, T32_dev, td_dev, mapok_dev = self.track_chain_cached(
                        self._loc_feats, src_pts, src_n, T_init_d, td_host,
                        anchor_d, frame_id, self._loc_lset,
                        cfeats=self._loc_cfeats, src_attr=src_attr)
                elif self._cur_lset is not None and not self._use_color_track:
                    # register against the previous frame's post-train
                    # local set
                    res, T32_dev, td_dev, mapok_dev = self.track_chain_cached(
                        self._cur_track_feats, src_pts, src_n, T_init_d,
                        td_host, anchor_d, frame_id, self._cur_lset)
                else:
                    res, T32_dev, td_dev, mapok_dev = self.track_chain(
                        src_pts, src_n, T_init_d, anchor_d, frame_id, td_host,
                        self._tensor(self.last_pose_ref[:3, 3]),
                        src_attr=src_attr)
                self.last_tracking = res
                tracked = True
            elif frame_id > 0:
                if self.gt_poses is None:
                    raise ValueError("mapping mode requires gt poses")
                self._update_odom_pose(frame_id, init_guess)
                tracked = False
            else:
                self.cur_pose_ref = init_guess
                tracked = False

        # ---- IV. mapping, gated on the device by tracker validity
        with tracing.stage("frame.map_update"):
            # ---- reboot check (uses the lose-track counter of the previous
            # frame so mapping needs no tracker result on the host)
            system_rebooted = False
            if self.consecutive_lose_track_frame >= c.reboot_frame_thre:
                self.pool.count = torch.zeros_like(self.pool.count)
                self.pool.new_count = torch.zeros_like(self.pool.new_count)
                self.reboot_ts = frame_id
                system_rebooted = True
                self.consecutive_lose_track_frame = 0
                self.decoder_freezed = False

            stop_prev = self.stop_status
            host_force = frame_id < 5 or system_rebooted
            if not tracked:
                T32_dev = self._tensor(self.cur_pose_ref)
                td_dev = td_host
                mapok_dev = torch.tensor(not self.lose_track, device=dev)
            do_map_dev = torch.tensor(host_force, device=dev) | (
                mapok_dev & (not stop_prev))
            # localization mode dispatches no mapping, training, prune or pool
            # filter
            dispatched_map = not self.localization_mode
            pool_cadence = (frame_id + 1) % c.pool_filter_freq == 0
            # prune inactive low-certainty points; half-period phase offset so
            # it never lands on a pool-filter frame
            if dispatched_map and c.prune_map_on and (
                    frame_id + 1 + c.prune_freq_frame // 2) \
                    % c.prune_freq_frame == 0:
                with tracing.span("mapper.prune"):
                    self.prune_and_rehash(frame_id, td_dev)
            static_mask = None
            if dispatched_map and c.dynamic_filter_on and frame_id > 0:
                # judge valid rows only (pad rows sit at the sensor origin
                # after the transform and would widen the elevation band)
                rows = torch.arange(c.frame_point_cap, device=dev) < train_n
                hist = None
                if c.visibility_filter_on:
                    # row 0: the current origin (elevation band only); then the
                    # historic origins, clamped to frame 0 early on
                    orig = np.stack(
                        [self.pgo_poses[max(frame_id - off, 0)][:3, 3]
                         for off in c.visibility_hist_offsets])
                    hist = torch.cat([T32_dev[:3, 3][None],
                                      self._tensor(orig)])
                with tracing.span("mapper.dynamic_filter"):
                    static_mask = self.dynamic_filter(
                        transform_points(train_pts, T32_dev), rows,
                        self._lf(frame_id - 1), hist)
                self.last_static_mask = static_mask
                self.last_train_pts = train_pts
                self.last_train_n = train_n
            if dispatched_map:
                with tracing.span("mapper.frame_update"):
                    _, new_obs_ratio = self.frame_update(
                        train_pts, train_n, T32_dev, frame_id, td_dev,
                        force_all_new=system_rebooted, do_map=do_map_dev,
                        insert_cap=(1 << 16) if host_force else (1 << 14),
                        static_mask=static_mask, train_attr=train_attr)
                    self.sync_feature_params()
                if pool_cadence:
                    with tracing.span("mapper.pool_filter"):
                        self.filter_pool(T32_dev[:3, 3])

        # ---- training: dispatched before the frame's host pull; its host
        # gates (lose-track, stop, adaptive iterations) lag one frame
        def run_training():
            did_map = dispatched_map and (
                host_force or (not self.lose_track and not stop_prev))
            self.last_did_map = did_map
            if frame_id % c.mapping_freq_frame == 0 and did_map:
                cur_iters = (c.iters * c.init_iter_ratio
                             if (frame_id == 0 or system_rebooted)
                             else c.iters)
                if self.stop_status:
                    cur_iters = max(1, cur_iters - 10)
                cur_iters = max(1, cur_iters + self.adaptive_iter_offset)
                if self.post_loop_iter_boost_pending:
                    # re-converge the SDF around just-deformed geometry
                    cur_iters += self.post_loop_iter_boost_pending
                    self.post_loop_iter_boost_pending = 0
                if (frame_id - self.reboot_ts) == c.freeze_after_frame:
                    self.decoder_freezed = True
                if ba_due:
                    run_bundle_adjustment(self, frame_id)
                # the host travel_dist[frame_id] and pose are not set before
                # the pull: pass the device copies select_pose made
                self.train(cur_iters, frame_id,
                           td_dev=td_dev if lag_pull else None,
                           T_dev=T32_dev if lag_pull else None)

        ba_due = (c.track_on and c.ba_freq_frame > 0
                  and (frame_id + 1) % c.ba_freq_frame == 0)
        # bundle adjustment needs this frame's pulled pose
        lag_pull = dispatched_map and not ba_due
        if lag_pull:
            run_training()

        # next frame's stage I rides ahead of the blocking pull
        if next_points is not None and next_points.shape[0] >= 10:
            with tracing.span("frame.prefetch"):
                self._prefetch = (frame_id + 1,
                                  self._run_preprocess(next_points,
                                                       next_sem_labels))

        # ---- the frame's batched host pull
        pull = []
        if tracked:
            pull += [res.valid, res.iterations, res.pose]
        if dispatched_map and c.adaptive_iters:
            pull.append(new_obs_ratio)
        if dispatched_map and pool_cadence:
            pull.append(self.state.count)
        pull += [train_total, src_total]
        with tracing.stage("frame.pull") as pull_span:
            flat = torch.cat([torch.as_tensor(t, device=dev).reshape(-1)
                              .to(torch.float64) for t in pull]).cpu().numpy()
        self.last_pull_block = pull_span.seconds
        tt, st = int(flat[-2]), int(flat[-1])
        flat = flat[:-2]
        if tt > c.frame_point_cap or st > c.source_point_cap:
            self.cap_overflow_frames += 1
            self.cap_overflow_max_ratio = max(
                self.cap_overflow_max_ratio, tt / c.frame_point_cap,
                st / c.source_point_cap)
            if not c.silence and self.cap_overflow_frames == 1:
                print(f"[warn] frame {frame_id}: point caps exceeded "
                      f"(train {tt}/{c.frame_point_cap}, source "
                      f"{st}/{c.source_point_cap}); thinning uniformly")
        if tracked:
            valid, iters = bool(flat[0]), int(flat[1])
            pose_d = flat[2:18].reshape(4, 4)
            flat = flat[18:]
            self.last_track_iters = iters
            if not valid and iters < 10:
                cur_pose = init_guess      # keep the guess
            else:
                cur_pose = np.array(pose_d, np.float64)
                cur_pose[:3, 3] += anchor
            self.lose_track = not valid
            self._update_odom_pose(frame_id, cur_pose)

        self.adaptive_iter_offset = 0
        if dispatched_map and c.adaptive_iters:
            self.new_obs_ratio = float(flat[0])
            flat = flat[1:]
            if self.new_obs_ratio < c.new_sample_ratio_less:
                self.adaptive_iter_offset = -5
            elif self.new_obs_ratio > c.new_sample_ratio_more:
                self.adaptive_iter_offset = 5
                if (frame_id > c.freeze_after_frame
                        and self.new_obs_ratio > c.new_sample_ratio_restart):
                    self.adaptive_iter_offset = 10
        if dispatched_map and pool_cadence \
                and int(flat[0]) > 0.9 * c.map_capacity:
            # capacity watchdog: grow before inserts start dropping points
            self.grow_map_capacity()

        # ---- III. loop closure + PGO, after the pull: the current frame is
        # already in the map with ts=frame_id, so a closure's deformation
        # corrects it like every other frame
        if loop_hook is not None:
            loop_hook(frame_id)

        if not lag_pull:
            run_training()
        self.cur_frame = frame_id + 1
        return self.cur_pose_ref.copy()

    @tracing.spanned("mapper.train", is_stage=True)
    def train(self, iters: int, frame_id: int, td_dev=None, T_dev=None,
              draws=None):
        """Run `iters` mapping iterations with a fresh optimizer. Under the
        join probe they run over the frame's training local set, and the
        set and its trained compact features become the next frame's
        tracking structure; under the cell and brick probes over the whole
        map. `td_dev` / `T_dev` are the device's travel distances and pose
        of this frame when the host's are not pulled yet. `draws` replaces
        the training loop's random draws (parity tests)."""
        lf = self._lf(frame_id)
        if td_dev is not None:
            lf = lf._replace(travel_dist=td_dev)
        if T_dev is not None and lf.sensor_origins is not None:
            origins = lf.sensor_origins.clone()
            origins[frame_id] = T_dev[:3, 3]
            lf = lf._replace(sensor_origins=origins)
        lset = None
        if self._use_join:
            lset = self.build_lset_train(lf.travel_dist, frame_id,
                                         self.reboot_ts)
        use_new = torch.tensor(not (self.lose_track or self.stop_status),
                               device=self.device)
        loop = self._get_train_loop(iters, not self.decoder_freezed)
        terms = {}
        self.params, self.state, losses = loop(
            self.params, self.state, self.pool, self.gen, use_new, lset,
            draws=draws, lf=lf, terms=terms)
        if lset is not None:
            self._cur_lset = lset
            self._cur_track_feats = self.state.geo_features[lset.gidx]
        self.last_train_losses = losses
        self.last_train_terms = terms
        self.last_train_metrics = {"loss": losses[-1]}
        return self.last_train_metrics

    def _update_odom_pose(self, frame_id: int, cur_pose: np.ndarray):
        c = self.config
        # project the tracker's float32 rotation back onto SO(3): its small
        # scale/shear would otherwise compound through the pose chain
        U, _, Vt = np.linalg.svd(cur_pose[:3, :3])
        if np.linalg.det(U) * np.linalg.det(Vt) < 0:
            U[:, 2] *= -1.0
        cur_pose = cur_pose.copy()
        cur_pose[:3, :3] = U @ Vt
        self.cur_pose_ref = cur_pose
        self.last_odom_tran = np_se3_inv(self.last_pose_ref) @ cur_pose

        rot_close = np_rotation_angle_deg(self.last_odom_tran) < 0.057
        tran_close = np.linalg.norm(
            self.last_odom_tran[:3, 3]) < c.voxel_size_m * 0.1
        if rot_close and tran_close:
            self.stop_count += 1
        else:
            self.stop_count = 0
        self.stop_status = self.stop_count > c.stop_frame_thre

        self.pgo_poses[frame_id] = cur_pose
        self.odom_poses[frame_id] = (
            self.odom_poses[frame_id - 1] @ self.last_odom_tran)

        if self.lose_track:
            self.consecutive_lose_track_frame += 1
        else:
            self.consecutive_lose_track_frame = 0

        tran_dist = np.linalg.norm(self.last_odom_tran[:3, 3])
        if tran_dist > c.surface_sample_range_m * 20.0:
            self.lose_track = True
            self.consecutive_lose_track_frame = c.reboot_frame_thre

        self.travel_dist[frame_id] = self.travel_dist[frame_id - 1] + \
            tran_dist
        self.last_pose_ref = self.cur_pose_ref
