"""PIN-SLAM system orchestrator: the per-frame track+map loop. Port of
`pin_slam_tpu/slam/system.py`, the join-mode geometry slice:

  I.   preprocess   — range/z crop + train/source voxel downsample
  II.  odometry     — local-set build + GN registration + pose selection
  IV.  mapping      — sample + map insert + pool append + new-sample
                      detection, then the per-frame training run

The host keeps float64 pose chains and travel distance; the device works in
float32 with a per-frame anchor (the last sensor position). Loop closure
and PGO, bundle adjustment, the dynamic filter, colour, semantics and
localization mode are not ported yet and raise NotImplementedError.

Host syncs per frame: one per GN iteration of the tracker (its stop flag)
and one batched pull after the mapping dispatches (pose, validity,
iteration count, overflow counts).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from pin_slam_tpu_torch.config import Config
from pin_slam_tpu_torch.device import resolve_device
from pin_slam_tpu_torch.models import neural_points as npm
from pin_slam_tpu_torch.models.decoder import init_mlp_params
from pin_slam_tpu_torch.models.sampler import sample_training_points
from pin_slam_tpu_torch.ops import knn_join as kj
from pin_slam_tpu_torch.ops.transforms import (
    np_rotation_angle_deg,
    np_se3_inv,
    np_slerp_rotmats,
    transform_points,
)
from pin_slam_tpu_torch.ops.voxel import voxel_down_sample_hash_mask
from pin_slam_tpu_torch.slam import map_query as mq
from pin_slam_tpu_torch.slam import mapper as mp
from pin_slam_tpu_torch.slam import tracker as tk


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


def _pad_points(pts: np.ndarray, cap: int):
    """Pad [N, 3+] to [cap, 3]; returns (padded, n)."""
    n = min(pts.shape[0], cap)
    out = np.zeros((cap, 3), np.float32)
    out[:n] = pts[:n, :3]
    return out, n


def _check_supported(c: Config) -> None:
    off = {
        "semantic_on": c.semantic_on, "color_on": c.color_on,
        "dynamic_filter_on": c.dynamic_filter_on,
        "ba_freq_frame > 0": c.ba_freq_frame > 0,
        "consistency_loss_on": c.consistency_loss_on,
        "incidence_label_on": c.incidence_label_on,
        "dp_on": c.dp_on,
    }
    on = [k for k, v in off.items() if v]
    if on:
        raise NotImplementedError(
            f"not ported yet: {', '.join(on)} (the port runs the join-mode "
            "geometry loop only)")
    if c.probe_mode not in ("auto", "join"):
        raise NotImplementedError(
            f"probe_mode={c.probe_mode!r}: the track+map loop implements "
            "only the join probe (the cells probe serves queries without a "
            "local set, such as the mesher's)")


class PinSLAMSystem:
    """Host-side orchestrator owning all device state."""

    def __init__(self, config: Config, device=None,
                 generator: Optional[torch.Generator] = None,
                 sync_timing: bool = False):
        _check_supported(config)
        self.config = c = config
        self.device = resolve_device(device)
        # one explicit generator drives every random draw of the system
        self.gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(c.seed)
        # synchronize after each stage so `timings` attribute device time
        # to the right stage (profiling). As in the JAX reference, this also
        # runs the frame's training after its host pull instead of before,
        # so a synced run's frame time is not the default loop's.
        self._sync_timing = sync_timing
        self.qp = mq.make_query_params(c)

        dev = self.device
        self.state = npm.init_map_state(c.map_capacity, c.buffer_size,
                                        c.feature_dim, device=dev)
        self.pool = mp.init_pool(c.pool_capacity,
                                 c.frame_point_cap * c.all_sample_n,
                                 device=dev)
        init_gen = torch.Generator().manual_seed(c.seed)
        self.params = {
            "geo_features": self.state.geo_features,
            "geo_mlp": init_mlp_params(
                init_gen, c.feature_dim + c.pos_input_dim,
                c.geo_mlp_hidden_dim, c.geo_mlp_level, 1, c.mlp_bias_on,
                device=dev),
        }

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
        self.last_track_iters = -1
        # per-frame [preprocess, odometry, pgo, map-prep, map-opt] seconds
        self.timings = []
        self.new_obs_ratio = 1.0
        self.adaptive_iter_offset = 0
        self.last_did_map = False
        self.last_pull_block = 0.0
        # post-train local set + trained compact features, reused as the
        # next frame's tracker search structure
        self._cur_lset = None
        self._cur_track_feats = None
        self._prefetch = None
        self._train_loops = {}

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
        )
        self._track = tk.make_tracker(self.qp, tk.TrackerParams(
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
        ))

    # ------------------------------------------------------------ stages

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _sync(self):
        if self._sync_timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build_lset_track(self, travel, cur_ts, sensor_pos, reboot_ts):
        """Tracking local set (travel window + sensor radius) and its
        compact features."""
        c = self.config
        s = self.state
        m = npm.local_map_mask(
            s, travel, cur_ts, self.local_window_dist,
            sensor_pos=sensor_pos, local_map_radius=c.local_map_radius,
            reboot_ts=reboot_ts, use_mid_ts=c.use_mid_ts)
        ls = kj.build_local_set(s.positions, m, c.voxel_size_m,
                                c.local_set_cap, certainty=s.certainty,
                                orientations=s.orientations)
        return ls, self.params["geo_features"][ls.gidx]

    def build_lset_train(self, travel, cur_ts, reboot_ts):
        """Training local set (travel window), with certainty and update
        timestamps. Without map deformation all orientations are identity,
        so the set carries none and every decode skips the rotation."""
        c = self.config
        s = self.state
        m = npm.local_map_mask(s, travel, cur_ts, self.local_window_dist,
                               reboot_ts=reboot_ts, use_mid_ts=c.use_mid_ts)
        return kj.build_local_set(s.positions, m, c.voxel_size_m,
                                  c.local_set_cap, certainty=s.certainty,
                                  ts_update=s.ts_update)

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
                    sensor_pos):
        """Local-set build + GN registration + pose selection (first
        frames, or whenever no post-train set is cached)."""
        lset, feats = self.build_lset_track(travel, fid - 1, sensor_pos,
                                            self.reboot_ts)
        return self.track_chain_cached(feats, src_pts, src_n, T_init,
                                       travel, anchor, fid, lset)

    def track_chain_cached(self, feats, src_pts, src_n, T_init, td, anchor,
                           fid, lset):
        """GN registration against a given local set + pose selection."""
        mask = torch.arange(src_pts.shape[0], device=self.device) < src_n
        res = self._track(feats, self.params["geo_mlp"], src_pts, mask,
                          T_init, anchor, lset)
        T32, td_new, mapok = self.select_pose(
            res.valid, res.iterations, res.pose, T_init, anchor, td, fid)
        return res, T32, td_new, mapok

    def preprocess(self, raw: torch.Tensor, n_valid: int,
                   max_range_eff: float, train_vox: float,
                   source_vox: float):
        """Range/z crop, train and source voxel downsample, and compaction
        to the static caps. Past a cap the cloud thins UNIFORMLY (a prefix
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
            return out[:cap], ok.sum(), total

        train_pts, train_n, train_total = compact(train_keep,
                                                  c.frame_point_cap)
        src_keep = voxel_down_sample_hash_mask(
            raw, train_keep, source_vox, 1 << 18) & train_keep
        src_pts, src_n, src_total = compact(src_keep, c.source_point_cap)
        return train_pts, train_n, src_pts, src_n, train_total, src_total

    def _run_preprocess(self, points: np.ndarray):
        """Pad to a power of two, upload, and run stage I."""
        c = self.config
        raw, n_raw = _pad_points(
            np.asarray(points, np.float32),
            1 << int(np.ceil(np.log2(max(points.shape[0], 2)))))
        max_range_eff = c.max_range
        if c.adaptive_range_on:
            pts = raw[:n_raw]
            mx, mn = pts.max(0), pts.min(0)
            max_x_y_min_range = max(min(abs(mx[0]), abs(mn[0])),
                                    min(abs(mx[1]), abs(mn[1])))
            max_range_eff = float(min(c.max_range, 2.0 * max_x_y_min_range))
        ratio = max_range_eff / c.max_range
        return self.preprocess(
            self._tensor(raw), n_raw, max_range_eff,
            c.vox_down_m * ratio, c.source_vox_down_m * ratio)

    def frame_update(self, train_pts, train_n, T, cur_ts, travel_dist,
                     force_all_new: bool, do_map, insert_cap: int,
                     noise=None):
        """Sample along the rays, insert map points, append to the pool and
        mark the new samples. `do_map` is a device-side gate: when False
        every sample mask is cleared and the update changes no counts.
        `noise` replaces the sampler's random draws (parity tests)."""
        c = self.config
        dev = self.device
        mask = (torch.arange(train_pts.shape[0], device=dev) < train_n) \
            & do_map
        smp = sample_training_points(
            self.gen, train_pts, mask,
            surface_sample_range_m=c.surface_sample_range_m,
            surface_sample_n=c.surface_sample_n,
            free_front_n=c.free_front_n, free_behind_n=c.free_behind_n,
            free_sample_begin_ratio=c.free_sample_begin_ratio,
            free_sample_end_dist_m=c.free_sample_end_dist_m,
            max_range=c.max_range, dist_weight_on=c.dist_weight_on,
            dist_weight_scale=c.dist_weight_scale,
            behind_dropoff_on=c.behind_dropoff_on, noise=noise)
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
            force_all_new=force_all_new, insert_cap=insert_cap)
        frame_start = mp.append_start(self.pool, world.shape[0])
        self.pool = mp.append_samples(self.pool, world, smp.sdf_label,
                                      smp.weight, smp.mask, cur_ts)
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
        self.params["geo_features"] = self.state.geo_features
        return n

    def filter_pool(self, origin):
        self.pool = mp.filter_pool(self.pool, origin, self.config.window_radius)

    # -------------------------------------------------------------- helpers

    def _get_train_loop(self, iters: int, train_decoder: bool):
        k = (iters, train_decoder)
        if k not in self._train_loops:
            c = self.config
            self._train_loops[k] = mp.make_train_loop(
                self.qp, lr=c.lr, adam_eps=c.adam_eps, n_iters=iters,
                bs=c.bs, bs_new=c.bs_new_sample, train_decoder=train_decoder,
                loss_kwargs=self._loss_kwargs,
                subset_hist=c.train_subset_hist)
        return self._train_loops[k]

    def set_gt_poses(self, gt: np.ndarray):
        self.gt_poses = gt

    def load_map(self, path: str):
        raise NotImplementedError("localization mode is not ported yet")

    # ------------------------------------------------------------ main loop

    def process_frame(self, frame_id: int, points: np.ndarray,
                      point_ts: Optional[np.ndarray] = None,
                      gt_pose: Optional[np.ndarray] = None,
                      loop_hook=None,
                      sem_labels: Optional[np.ndarray] = None,
                      next_points: Optional[np.ndarray] = None,
                      next_sem_labels: Optional[np.ndarray] = None):
        """Run preprocess, odometry and mapping for one frame. `points` is
        [N, 3] in the sensor frame. `next_points` (optional) is the NEXT
        frame's raw cloud: its preprocess is dispatched before this frame's
        host pull and reused when the caller passes the same cloud as
        frame_id+1's `points`. Returns the pose estimate (4x4 float64)."""
        if loop_hook is not None or sem_labels is not None:
            raise NotImplementedError(
                "loop closure and semantics are not ported yet")
        c = self.config
        dev = self.device
        t0 = time.time()

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
            self.timings.append([0.0] * 5)
            self.cur_frame = frame_id + 1
            return init_guess.copy()

        # ---- I. preprocess (reuse the one dispatched ahead, if any)
        if self._prefetch is not None and self._prefetch[0] == frame_id:
            pre = self._prefetch[1]
        else:
            pre = self._run_preprocess(points)
        self._prefetch = None
        train_pts, train_n, src_pts, src_n, train_total, src_total = pre
        self._sync()
        t1 = time.time()

        # ---- II. odometry
        td_host = self._tensor(self.travel_dist[: self.max_frames])
        if frame_id > 0 and c.track_on:
            anchor = self.last_pose_ref[:3, 3].copy()
            T_init = init_guess.copy()
            T_init[:3, 3] -= anchor
            T_init_d = self._tensor(T_init)
            anchor_d = self._tensor(anchor)
            if self._cur_lset is not None:
                # register against the previous frame's post-train local set
                res, T32_dev, td_dev, mapok_dev = self.track_chain_cached(
                    self._cur_track_feats, src_pts, src_n, T_init_d, td_host,
                    anchor_d, frame_id, self._cur_lset)
            else:
                res, T32_dev, td_dev, mapok_dev = self.track_chain(
                    src_pts, src_n, T_init_d, anchor_d, frame_id, td_host,
                    self._tensor(self.last_pose_ref[:3, 3]))
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
        self._sync()
        t2 = time.time()

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

        # ---- IV. mapping, gated on the device by tracker validity
        stop_prev = self.stop_status
        host_force = frame_id < 5 or system_rebooted
        if not tracked:
            T32_dev = self._tensor(self.cur_pose_ref)
            td_dev = td_host
            mapok_dev = torch.tensor(not self.lose_track, device=dev)
        do_map_dev = torch.tensor(host_force, device=dev) | (
            mapok_dev & (not stop_prev))
        pool_cadence = (frame_id + 1) % c.pool_filter_freq == 0
        # prune inactive low-certainty points; half-period phase offset so
        # it never lands on a pool-filter frame
        if c.prune_map_on and (frame_id + 1 + c.prune_freq_frame // 2) \
                % c.prune_freq_frame == 0:
            self.prune_and_rehash(frame_id, td_dev)
        new_ratio, new_obs_ratio = self.frame_update(
            train_pts, train_n, T32_dev, frame_id, td_dev,
            force_all_new=system_rebooted, do_map=do_map_dev,
            insert_cap=(1 << 16) if host_force else (1 << 14))
        self.params["geo_features"] = self.state.geo_features
        if pool_cadence:
            self.filter_pool(T32_dev[:3, 3])
        self._sync()

        # ---- training: dispatched before the frame's host pull; its host
        # gates (lose-track, stop, adaptive iterations) lag one frame
        def run_training():
            did_map = host_force or (not self.lose_track and not stop_prev)
            self.last_did_map = did_map
            if frame_id % c.mapping_freq_frame == 0 and did_map:
                cur_iters = (c.iters * c.init_iter_ratio
                             if (frame_id == 0 or system_rebooted)
                             else c.iters)
                if self.stop_status:
                    cur_iters = max(1, cur_iters - 10)
                cur_iters = max(1, cur_iters + self.adaptive_iter_offset)
                if (frame_id - self.reboot_ts) == c.freeze_after_frame:
                    self.decoder_freezed = True
                # the host travel_dist[frame_id] is not set before the pull:
                # pass the device copy select_pose already extended
                self.train(cur_iters, frame_id,
                           td_dev=td_dev if lag_pull else None)

        lag_pull = not self._sync_timing
        if lag_pull:
            run_training()

        # next frame's stage I rides ahead of the blocking pull
        if next_points is not None and next_points.shape[0] >= 10:
            self._prefetch = (frame_id + 1, self._run_preprocess(next_points))

        # ---- the frame's batched host pull
        pull = []
        if tracked:
            pull += [res.valid, res.iterations, res.pose]
        if c.adaptive_iters:
            pull.append(new_obs_ratio)
        if pool_cadence:
            pull.append(self.state.count)
        pull += [train_total, src_total]
        t_pull0 = time.time()
        flat = torch.cat([torch.as_tensor(t, device=dev).reshape(-1)
                          .to(torch.float64) for t in pull]).cpu().numpy()
        self.last_pull_block = time.time() - t_pull0
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
        if c.adaptive_iters:
            self.new_obs_ratio = float(flat[0])
            flat = flat[1:]
            if self.new_obs_ratio < c.new_sample_ratio_less:
                self.adaptive_iter_offset = -5
            elif self.new_obs_ratio > c.new_sample_ratio_more:
                self.adaptive_iter_offset = 5
                if (frame_id > c.freeze_after_frame
                        and self.new_obs_ratio > c.new_sample_ratio_restart):
                    self.adaptive_iter_offset = 10
        if pool_cadence and int(flat[0]) > 0.9 * c.map_capacity:
            raise NotImplementedError(
                f"map count {int(flat[0])} is past 90% of map_capacity "
                f"{c.map_capacity}: capacity growth is not ported yet")
        t4 = time.time()
        t3 = time.time()     # no loop closure stage in the port yet

        if not lag_pull:
            run_training()
        self._sync()
        t5 = time.time()

        self.timings.append([t1 - t0, t2 - t1, t3 - t4, t4 - t2, t5 - t3])
        self.cur_frame = frame_id + 1
        return self.cur_pose_ref.copy()

    def train(self, iters: int, frame_id: int, td_dev=None):
        """Run `iters` mapping iterations with a fresh optimizer over the
        frame's training local set; the set and its trained compact features
        become the next frame's tracking structure."""
        travel = td_dev if td_dev is not None else \
            self._tensor(self.travel_dist[: self.max_frames])
        lset = self.build_lset_train(travel, frame_id, self.reboot_ts)
        use_new = torch.tensor(not (self.lose_track or self.stop_status),
                               device=self.device)
        loop = self._get_train_loop(iters, not self.decoder_freezed)
        self.params, self.state, losses = loop(
            self.params, self.state, self.pool, self.gen, use_new, lset)
        self._cur_lset = lset
        self._cur_track_feats = self.state.geo_features[lset.gidx]
        self.last_train_losses = losses
        return {"loss": losses[-1]}

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
