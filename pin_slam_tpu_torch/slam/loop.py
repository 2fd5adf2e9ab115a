"""Loop closure + pose-graph optimisation for the SLAM loop. Port of
`pin_slam_tpu/slam/loop.py`.

Per frame (`after_frame`, run as `PinSLAMSystem.process_frame`'s
`loop_hook`): a descriptor node, the odometry factor and the drift
estimate; every `pgo_freq` frames at most, a local (distance) or global
(scan context) loop candidate. A candidate is refined by registering the
scan against the map around the loop frame (the hash table re-anchored
there), held to a deviation budget, added to the pose graph and solved on
the host. An accepted closure deforms the map elastically, rehashes it at
the current frame, moves the replay pool by the same per-frame corrections,
updates the poses and schedules a training boost.

Host pulls per closure: the local-map context (mask count and points, when
`local_map_context` is on) and one batched pull of the registration result.

Spans (`utils/tracing.py`): `loop.after_frame` holds `loop.descriptor`,
`loop.graph`, `loop.detect` and, for a candidate, `loop.close` with
`loop.register`, `loop.pgo` and `loop.deform`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pin_slam_tpu_torch.models import neural_points as npm
from pin_slam_tpu_torch.ops.transforms import transform_points_by_ts
from pin_slam_tpu_torch.slam.loop_detector import (
    ScanContextManager,
    detect_local_loop,
)
from pin_slam_tpu_torch.slam.pgo import PoseGraphManager
from pin_slam_tpu_torch.utils import tracing


class LoopPgoManager:
    def __init__(self, config, system):
        self.config = config
        self.system = system
        self.silence = config.silence
        self.detector = ScanContextManager(config)
        self.pgm = PoseGraphManager(config)
        self.loop_reg_failed_count = 0
        self._candidate_kind = None     # "local" / "global" of the candidate

    # ------------------------------------------------- device-side consequences

    def _rehash(self, ts: int):
        c = self.config
        sysm = self.system
        sysm.state = npm.rehash(sysm.state, ts, resolution=c.voxel_size_m,
                                use_mid_ts=c.use_mid_ts)

    def _apply_deformation(self, diffs: torch.Tensor, rehash_ts: int):
        """Deform the map by the per-frame corrections `diffs` [T, 4, 4],
        rehash it at `rehash_ts` and move the replay pool alike."""
        sysm = self.system
        sysm.state = npm.deform_map(sysm.state, diffs,
                                    use_mid_ts=self.config.use_mid_ts)
        self._rehash(rehash_ts)
        sysm.pool = sysm.pool.replace(coord=transform_points_by_ts(
            sysm.pool.coord, sysm.pool.ts, diffs))
        sysm.sync_feature_params()
        # the cached post-train local set holds the old positions, and the
        # orientations are no longer the identity: training sets carry them
        sysm._cur_lset = None
        sysm._cur_track_feats = None
        sysm._map_deformed = True

    # ------------------------------------------------------------ map context

    def _local_map_context(self, lm_fid: int):
        """Local-map points (world frame) and optionally their geo features
        around the pose of `lm_fid`."""
        c = self.config
        sysm = self.system
        s = sysm.state
        pose = sysm.pgo_poses[lm_fid]
        m = npm.local_map_mask(
            s, sysm._tensor(sysm.travel_dist[: sysm.max_frames]), lm_fid,
            sysm.local_window_dist,
            by_travel_dist=c.loop_local_map_by_travel_dist,
            time_window=c.loop_local_map_time_window,
            sensor_pos=sysm._tensor(pose[:3, 3]),
            local_map_radius=c.local_map_radius, use_mid_ts=c.use_mid_ts)
        if int(m.sum()) < 100:          # too few: fall back to all alive
            m = torch.arange(s.capacity, device=m.device) < s.count
        pts = s.positions[:-1][m].cpu().numpy()
        feats = None
        if c.loop_with_feature:
            feats = sysm.params["geo_features"][:-1][m].detach().cpu().numpy()
        return pts, feats, pose

    # --------------------------------------------------------------- per-frame

    @tracing.spanned("loop.after_frame", is_stage=True)
    def after_frame(self, frame_id: int, points: np.ndarray) -> bool:
        """The loop-closure block after odometry and mapping of `frame_id`.
        Returns True if a loop was closed and poses and map corrected."""
        c = self.config
        sysm = self.system

        valid_flag = not (sysm.lose_track or sysm.stop_status)
        self._ctx_pc_global = None
        self._ctx_features = None
        with tracing.span("loop.descriptor"):
            if c.local_map_context and c.global_loop_on and \
                    frame_id >= c.local_map_context_latency:
                # local-map context: descriptor from the neural points
                # around the (delayed) frame, in that frame's sensor frame
                lm_fid = frame_id - c.local_map_context_latency
                pts_w, feats, lm_pose = self._local_map_context(lm_fid)
                Tinv = np.linalg.inv(lm_pose)
                pts_local = pts_w @ Tinv[:3, :3].T + Tinv[:3, 3]
                self.detector.add_node(lm_fid, pts_local, feats, valid_flag)
                self._ctx_pc_global = pts_w
                self._ctx_features = feats
            else:
                # scan context: descriptor from the current scan (sensor
                # frame)
                self.detector.add_node(frame_id, points[:, :3],
                                       valid_flag=valid_flag)

        with tracing.span("loop.graph"):
            self.pgm.add_frame_node(frame_id, sysm.pgo_poses[frame_id])
            if frame_id == 0:
                return False
            self.pgm.add_odometry_factor(
                frame_id, frame_id - 1, sysm.last_odom_tran,
                cov=sysm.last_tracking.cov.cpu().numpy()
                if (c.use_reg_cov_mat and sysm.last_tracking is not None)
                else None)
            travel_dist = sysm.travel_dist[: frame_id + 1]
            self.pgm.estimate_drift(travel_dist, frame_id)

        if frame_id - self.pgm.last_loop_idx <= c.pgo_freq or \
                sysm.stop_status:
            return False

        cand_mask = (travel_dist[-1] - travel_dist) > (
            c.min_loop_travel_dist_ratio * c.local_map_radius)
        if not np.any(cand_mask):
            return False

        with tracing.span("loop.detect"):
            pgo_poses = sysm.pgo_poses[: frame_id + 1]
            loop_id, loop_dist, loop_transform = detect_local_loop(
                pgo_poses, cand_mask, self.pgm.drift_radius, frame_id,
                self.loop_reg_failed_count, c.local_loop_dist_thre,
                c.local_loop_dist_thre * 3.0, self.silence)
            self._candidate_kind = "local"
            if loop_id is None and c.global_loop_on:
                detect_global = self.detector.detect_global_loop
                loop_id, _, loop_transform = detect_global(
                    pgo_poses,
                    self.pgm.drift_radius * c.loop_dist_drift_ratio_thre,
                    cand_mask,
                    context_pc_global=self._ctx_pc_global,
                    context_features=self._ctx_features)
                self._candidate_kind = "global"
        if loop_id is None:
            return False
        if not self.detector.valid_flags.get(int(loop_id), False):
            return False                # the loop node is invalid

        if c.loop_z_check_on and abs(loop_transform[2, 3]) > \
                c.voxel_size_m * 4.0:
            return False

        return self._close_loop(frame_id, int(loop_id), loop_transform,
                                points)

    # ---------------------------------------------------------- registration

    def _register(self, points: np.ndarray, pose_init: np.ndarray,
                  lset_ts: int):
        """Register the scan against the local map around `lset_ts`,
        starting from `pose_init`, through the loop tracker variant: a
        tracking local set under the join probe, else the whole map state
        under the travel window and sensor radius of `lset_ts`. Returns
        (valid, refined pose (float64, world), registration covariance
        [6, 6], residual in cm, valid point count), pulled to the host in
        one batch."""
        sysm = self.system
        pre = sysm._run_preprocess(points[:, :3],
                                   cap=sysm.config.source_point_cap * 4)
        src_pts, src_n = pre[3], pre[5]
        anchor = pose_init[:3, 3].copy()
        T_init = pose_init.copy()
        T_init[:3, 3] -= anchor
        mask = torch.arange(src_pts.shape[0], device=sysm.device) < src_n
        if sysm._use_join:
            lset, feats, _ = sysm.build_lset_track(
                sysm._tensor(sysm.travel_dist[: sysm.max_frames]), lset_ts,
                sysm._tensor(pose_init[:3, 3]), sysm.reboot_ts)
            res = sysm._track_loop(feats, sysm.params["geo_mlp"], src_pts,
                                   mask, sysm._tensor(T_init),
                                   sysm._tensor(anchor), lset)
        else:
            res = sysm._track_loop(
                sysm.params["geo_features"], sysm.params["geo_mlp"], src_pts,
                mask, sysm._tensor(T_init), sysm._tensor(anchor), None,
                state=sysm.state,
                lf=sysm._lf(lset_ts, sensor_pos=pose_init[:3, 3] - anchor))
        flat = torch.cat([t.reshape(-1).to(torch.float64) for t in (
            res.valid, res.residual_cm, res.valid_count, res.pose,
            res.cov)]).cpu().numpy()
        pose = flat[3:19].reshape(4, 4).copy()
        pose[:3, 3] += anchor
        cov = flat[19:].reshape(6, 6).astype(np.float32)
        return bool(flat[0]), pose, cov, float(flat[1]), int(flat[2])

    # -------------------------------------------------------------- loop close

    @tracing.spanned("loop.close")
    def _close_loop(self, frame_id: int, loop_id: int,
                    loop_transform: np.ndarray, points: np.ndarray) -> bool:
        c = self.config
        sysm = self.system

        with tracing.span("loop.register"):
            # 1. re-anchor the hash table at the loop frame so that the
            #    registration sees the old geometry
            self._rehash(loop_id)

            # 2. scan-to-map refinement from the loop's initial guess
            pose_init = sysm.pgo_poses[loop_id] @ loop_transform
            reg_valid, pose_refined, cov, residual_cm, valid_count = \
                self._register(points, pose_init, loop_id)

        if reg_valid:
            # refinement-deviation gate: the registration may move the pose
            # only within the detector's own uncertainty budget; a refinement
            # that slid further latched onto aliased geometry, which the
            # graph would absorb by warping the whole trajectory
            dev = float(np.linalg.norm(pose_refined[:3, 3]
                                       - pose_init[:3, 3]))
            dev_budget = max(
                self.pgm.drift_radius * c.loop_dist_drift_ratio_thre,
                4.0 * c.voxel_size_m)
            if dev > dev_budget:
                if not self.silence:
                    print(f"loop refinement rejected: moved {dev:.2f} m "
                          f"> budget {dev_budget:.2f} m")
                reg_valid = False
        if reg_valid:
            loop_transform = np.linalg.inv(
                sysm.pgo_poses[loop_id]) @ pose_refined
            with tracing.span("loop.pgo"):
                reg_valid = self.pgm.add_loop_factor(
                    frame_id, loop_id, loop_transform,
                    cov=cov if c.use_reg_cov_mat else None)
                reg_valid = reg_valid and self.pgm.optimize_pose_graph()

        if not reg_valid:
            # restore the hash anchored at the current frame
            self._rehash(frame_id)
            self.loop_reg_failed_count += 1
            if not self.silence:
                print("loop registration failed, candidate rejected")
            return False

        # 3. the consequences
        self.pgm.loop_edges.append(np.array([loop_id, frame_id]))
        self.pgm.loop_trans.append(loop_transform)
        pose_diff = self.pgm.get_pose_diff()                 # [T, 4, 4]
        dmag = np.linalg.norm(pose_diff[: frame_id + 1, :3, 3], axis=1)
        moved = float(np.linalg.norm(pose_refined[:3, 3] - pose_init[:3, 3]))
        # per-closure diagnostics: the refined edge, the pre-solve chain
        # edge (whose deviation from ground truth is the drift) and the
        # registration's covariance diagonal
        self.pgm.loop_diags.append(dict(
            frame=frame_id, loop=loop_id, kind=self._candidate_kind,
            T_edge=np.asarray(loop_transform, np.float64).copy(),
            T_chain=np.linalg.inv(self.pgm.init_poses[loop_id])
            @ self.pgm.init_poses[frame_id],
            cov_diag=np.diag(cov.astype(np.float64)).copy(),
            residual_cm=residual_cm,
            refine_moved_m=moved,
            pgo_correction_m=float(dmag[frame_id])))
        if not self.silence:
            print(f"  reg: residual {residual_cm:.2f} cm, "
                  f"valid {valid_count}, moved {moved:.3f} m; "
                  f"pgo diff |t| max {dmag.max():.3f} m "
                  f"(argmax {int(dmag.argmax())}), cur {dmag[frame_id]:.3f} m")
        with tracing.span("loop.deform"):
            diffs = torch.as_tensor(pose_diff.astype(np.float32),
                                    device=sysm.device)
            self._apply_deformation(diffs, frame_id)
        sysm.post_loop_iter_boost_pending = max(
            sysm.post_loop_iter_boost_pending, c.post_loop_iter_boost)

        n = frame_id + 1
        sysm.pgo_poses[:n] = self.pgm.pgo_poses[:n]
        sysm.cur_pose_ref = sysm.pgo_poses[frame_id]
        sysm.last_pose_ref = sysm.cur_pose_ref
        sysm.set_after_pgo(True)

        self.pgm.last_loop_idx = frame_id
        self.pgm.min_loop_idx = min(self.pgm.min_loop_idx, loop_id)
        self.loop_reg_failed_count = 0
        if not self.silence:
            print(f"loop closed: {frame_id} --- {loop_id}")
        return True

    # ---------------------------------------------------------------- finalize

    def final_refine(self, frames, n_frames: int, *,
                     dev_budget_m: Optional[float] = None,
                     train_boost: Optional[int] = None) -> int:
        """End-of-run map-consistency pass: re-register every frame's scan
        against the final map, deform map and replay pool by the per-frame
        corrections, then boost-train. `frames(fid) -> [N, 3+]` returns the
        clouds the run processed. Frame 0 stays fixed (gauge). Returns the
        number of frames whose pose was refined."""
        c = self.config
        sysm = self.system
        old = sysm.pgo_poses[:n_frames].copy()
        refined = old.copy()
        if dev_budget_m is None:
            # the refinement corrects residual drift, not gross error
            dev_budget_m = max(4.0 * c.voxel_size_m, 0.3)
        n_ok = 0
        for fid in range(1, n_frames):
            ok, pose_r = self._register(frames(fid), refined[fid], fid)[:2]
            if not ok:
                continue
            if np.linalg.norm(pose_r[:3, 3] - refined[fid][:3, 3]) \
                    > dev_budget_m:
                continue
            refined[fid] = pose_r
            n_ok += 1

        if n_ok == 0:
            return 0
        diffs_n = np.einsum("nab,nbc->nac", refined, np.linalg.inv(old))
        diffs = np.tile(np.eye(4, dtype=np.float32), (sysm.max_frames, 1, 1))
        diffs[:n_frames] = diffs_n.astype(np.float32)
        self._apply_deformation(torch.as_tensor(diffs, device=sysm.device),
                                n_frames - 1)
        sysm.pgo_poses[:n_frames] = refined
        sysm.cur_pose_ref = refined[n_frames - 1]
        sysm.last_pose_ref = sysm.cur_pose_ref
        for i in range(n_frames):
            self.pgm.nodes[i] = refined[i]
        sysm.set_after_pgo(True)
        if train_boost is None:
            train_boost = 4 * c.iters
        if train_boost > 0:
            sysm.train(train_boost, n_frames - 1)
        if not self.silence:
            mag = np.linalg.norm(diffs_n[:, :3, 3], axis=1)
            print(f"final refine: {n_ok}/{n_frames - 1} frames, "
                  f"|t| mean {mag.mean()*100:.2f} cm, "
                  f"max {mag.max()*100:.2f} cm")
        return n_ok

    # ---------------------------------------------------------------------- io

    @property
    def pgo_count(self):
        return self.pgm.pgo_count

    def write_g2o(self, path: str):
        self.pgm.write_g2o(path)

    def write_loops(self, path: str):
        self.pgm.write_loops(path)
