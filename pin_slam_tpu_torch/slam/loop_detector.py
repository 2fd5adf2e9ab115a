"""Loop closure detection: scan-context / neural-point-map context. The
port's own copy of `pin_slam_tpu/slam/loop_detector.py` (numpy only).

Rebuilds the reference `NeuralPointMapContextManager`
(reference: utils/loop_detector.py:18-576): polar BEV descriptor of max-z
per (ring, sector) bin, ring-key retrieval (L1), column-shifted cosine
distance for yaw estimation, virtual lateral sensor nodes for translation
invariance, plus the distance-based local loop detector (:443-479).

Host-side NumPy: descriptor shapes are tiny (20x60), retrieval over a few
thousand frames is microseconds of matmuls — control flow dominates, which
is exactly what should not live on the device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np


def ptcloud2sc(ptcloud: np.ndarray, sc_shape, max_length: float) -> np.ndarray:
    """Polar max-z context [R, S] (reference: utils/loop_detector.py:482-545,
    deterministic np.maximum.at replacing CUDA scatter amax)."""
    num_ring, num_sector = sc_shape
    pts = ptcloud[:, :3]
    r = np.linalg.norm(pts[:, :2], axis=1)
    keep = (r < max_length) & np.isfinite(r)
    pts, r = pts[keep], r[keep]
    gap_ring = max_length / num_ring
    gap_sector = 360.0 / num_sector
    theta = np.degrees(np.arctan2(pts[:, 1], pts[:, 0])) + 180.0
    idx_ring = np.clip((r // gap_ring).astype(np.int64), 0, num_ring - 1)
    idx_sector = np.clip((theta // gap_sector).astype(np.int64), 0,
                         num_sector - 1)
    sc = np.full(num_ring * num_sector, -1e9)
    np.maximum.at(sc, idx_ring * num_sector + idx_sector, pts[:, 2])
    sc[sc < -1e8] = 0.0
    return sc.reshape(num_ring, num_sector)


def ptcloud2sc_feature(ptcloud: np.ndarray, features: np.ndarray,
                       sc_shape, max_length: float) -> np.ndarray:
    """Feature-enhanced context [R, S, D]: mean neural-point feature per
    (ring, sector) bin (reference: utils/loop_detector.py:501-543, scatter
    mean replaced by np.add.at + bincount)."""
    num_ring, num_sector = sc_shape
    pts = ptcloud[:, :3]
    r = np.linalg.norm(pts, axis=1)
    keep = (r < max_length) & np.isfinite(r)
    pts, r, feats = pts[keep], r[keep], features[keep]
    gap_ring = max_length / num_ring
    gap_sector = 360.0 / num_sector
    theta = np.degrees(np.arctan2(pts[:, 1], pts[:, 0])) + 180.0
    idx_ring = np.clip((r // gap_ring).astype(np.int64), 0, num_ring - 1)
    idx_sector = np.clip((theta // gap_sector).astype(np.int64), 0,
                         num_sector - 1)
    flat = idx_ring * num_sector + idx_sector
    d = feats.shape[1]
    acc = np.zeros((num_ring * num_sector, d), feats.dtype)
    np.add.at(acc, flat, feats)
    cnt = np.bincount(flat, minlength=num_ring * num_sector)[:, None]
    acc = acc / np.maximum(cnt, 1)
    return acc.reshape(num_ring, num_sector, d)


def sc2rk(sc: np.ndarray) -> np.ndarray:
    """Ring key = sector mean per ring (reference :548). Works for both
    max-z contexts [R,S] -> [R] and feature contexts [R,S,D] -> [R,D]."""
    return sc.mean(axis=1)


def distance_sc(sc1: np.ndarray, sc2: np.ndarray) -> Tuple[float, int]:
    """Min cosine distance over all sector shifts of sc1 + best shift
    (reference: utils/loop_detector.py:553-576), vectorized over shifts."""
    num_sector = sc1.shape[1]
    # all shifted copies [S, R, S]
    shifted = np.stack(
        [np.roll(sc1, s + 1, axis=1) for s in range(num_sector)])
    num = (shifted * sc2[None]).sum(axis=1)                 # [S, S] col dots
    den = (np.linalg.norm(shifted, axis=1)
           * np.linalg.norm(sc2, axis=0)[None] + 1e-12)
    cossim = (num / den).mean(axis=1)                       # [S]
    best = int(np.argmax(cossim))
    return float(1.0 - cossim[best]), best + 1


def distance_sc_feature(sc1: np.ndarray, sc2: np.ndarray) -> Tuple[float, int]:
    """Feature-context distance: min over sector shifts of (1 - mean cosine
    similarity along the ring axis of the [R, S*D] flattened descriptors)
    (reference: utils/loop_detector.py:580-606), vectorized over shifts."""
    num_ring, num_sector, d = sc1.shape
    shifted = np.stack(
        [np.roll(sc1, s + 1, axis=1) for s in range(num_sector)])  # [S,R,S,D]
    shifted = shifted.reshape(num_sector, num_ring, num_sector * d)
    flat2 = sc2.reshape(num_ring, num_sector * d)
    num = (shifted * flat2[None]).sum(axis=1)               # [S, S*D]
    den = (np.linalg.norm(shifted, axis=1)
           * np.linalg.norm(flat2, axis=0)[None] + 1e-12)
    cossim = (num / den).mean(axis=1)                       # [S]
    best = int(np.argmax(cossim))
    return float(1.0 - cossim[best]), best + 1


def detect_local_loop(
    pgo_poses: np.ndarray,
    loop_candidate_mask: np.ndarray,
    cur_drift: float,
    cur_frame_id: int,
    loop_reg_failed_count: int = 0,
    dist_thre: float = 1.0,
    drift_thre: float = 3.0,
    silence: bool = True,
):
    """(reference: utils/loop_detector.py:443-479)"""
    if not np.any(loop_candidate_mask):
        return None, None, None
    dist_to_past = np.linalg.norm(
        pgo_poses[:, :3, 3] - pgo_poses[-1, :3, 3], axis=1)
    masked = np.where(loop_candidate_mask, dist_to_past, np.inf)
    loop_id = int(np.argmin(masked))
    min_dist = float(masked[loop_id])
    if min_dist < dist_thre and cur_drift < drift_thre \
            and loop_reg_failed_count < 3:
        loop_transform = np.linalg.inv(pgo_poses[loop_id]) @ pgo_poses[-1]
        if not silence:
            print(f"local loop candidate: {cur_frame_id} --- {loop_id} "
                  f"({min_dist:.2f} m)")
        return loop_id, min_dist, loop_transform
    return None, None, None


class ScanContextManager:
    """Descriptor store + retrieval (reference class at
    utils/loop_detector.py:18-372). Supports the plain max-z scan/map
    context and the feature-enhanced map context (`loop_with_feature`:
    mean neural-point feature per bin, cosine ring-key retrieval)."""

    def __init__(self, config):
        self.config = config
        self.silence = config.silence
        self.des_shape = tuple(config.context_shape)
        self.max_length = config.npmc_max_dist
        self.ringkey_dist_thre = 0.25 * self.max_length
        self.sc_cosdist_threshold = config.context_cosdist_threshold
        # looser acceptance for map contexts, tighter ring-key gate for
        # feature mode (reference: utils/loop_detector.py:31-36)
        if getattr(config, "local_map_context", False):
            self.sc_cosdist_threshold += 0.08
            if getattr(config, "loop_with_feature", False):
                self.sc_cosdist_threshold += 0.08
                self.ringkey_dist_thre = 0.25  # cosine distance
        self.virtual_side_count = config.context_virtual_side_count
        self.virtual_step_m = config.context_virtual_step_m

        self.contexts: Dict[int, np.ndarray] = {}
        self.ringkeys: Dict[int, np.ndarray] = {}
        self.contexts_feature: Dict[int, np.ndarray] = {}
        self.ringkeys_feature: Dict[int, np.ndarray] = {}
        self.valid_flags: Dict[int, bool] = {}
        self.curr_node_idx = -1
        self.query_contexts: List[np.ndarray] = []
        self.tran_from_frame: List[np.ndarray] = []

    def add_node(self, frame_id: int, ptcloud: np.ndarray,
                 features: Optional[np.ndarray] = None,
                 valid_flag: bool = True):
        """(reference :59-82) — ptcloud in the (virtual) sensor frame;
        `features` [N, D] switches on the feature-context descriptor."""
        sc = ptcloud2sc(ptcloud, self.des_shape, self.max_length)
        self.curr_node_idx = frame_id
        self.contexts[frame_id] = sc
        self.ringkeys[frame_id] = sc2rk(sc)
        if features is not None:
            scf = ptcloud2sc_feature(ptcloud, features, self.des_shape,
                                     self.max_length)
            self.contexts_feature[frame_id] = scf
            self.ringkeys_feature[frame_id] = sc2rk(scf)
        self.valid_flags[frame_id] = valid_flag
        self.query_contexts = []
        self.tran_from_frame = []

    def set_virtual_nodes(self, ptcloud_global: np.ndarray,
                          frame_pose: np.ndarray,
                          last_frame_pose: Optional[np.ndarray],
                          features: Optional[np.ndarray] = None):
        """Augment laterally shifted virtual sensor positions
        (reference :84-155)."""
        use_feature = features is not None
        if last_frame_pose is not None:
            d = frame_pose[:3, 3] - last_frame_pose[:3, 3]
            n = np.linalg.norm(d)
            unit = d / n if n > 1e-9 else np.array([1.0, 0, 0])
            lat = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]) @ unit
        else:
            lat = np.array([0.0, 1.0, 0.0])
        for k in range(-self.virtual_side_count, self.virtual_side_count + 1):
            tran = np.eye(4)
            tran[:3, 3] = lat * (k * self.virtual_step_m)
            if k == 0:
                sc = (self.contexts_feature if use_feature
                      else self.contexts)[self.curr_node_idx]
            else:
                virtual_pose = frame_pose @ np.linalg.inv(tran)
                local = (ptcloud_global - virtual_pose[:3, 3]) \
                    @ virtual_pose[:3, :3]
                if use_feature:
                    sc = ptcloud2sc_feature(local, features, self.des_shape,
                                            self.max_length)
                else:
                    sc = ptcloud2sc(local, self.des_shape, self.max_length)
            self.query_contexts.append(sc)
            self.tran_from_frame.append(tran)

    def detect_global_loop(
        self, cur_pgo_poses: np.ndarray, dist_thre: float,
        loop_candidate_mask: np.ndarray,
        context_pc_global: Optional[np.ndarray] = None,
        context_features: Optional[np.ndarray] = None,
    ):
        """(reference :158-229). context_pc_global (world frame) enables the
        virtual-node augmentation; None falls back to the plain context.
        context_features switches retrieval to the feature descriptors."""
        cur = self.curr_node_idx
        use_feature = context_features is not None
        dist_to_past = np.linalg.norm(
            cur_pgo_poses[:, :3, 3] - cur_pgo_poses[cur, :3, 3], axis=1)
        cand = np.where(loop_candidate_mask & (dist_to_past < dist_thre))[0]
        store = self.contexts_feature if use_feature else self.contexts
        cand = np.array([i for i in cand
                         if self.valid_flags.get(i, False) and i in store],
                        np.int64)
        if cand.shape[0] == 0:
            return None, None, None

        if context_pc_global is not None:
            last_pose = cur_pgo_poses[cur - 1] if cur > 0 else None
            self.set_virtual_nodes(
                context_pc_global, cur_pgo_poses[cur], last_pose,
                features=context_features)
        loop_id, cosdist, T = self.detect_loop(cand, use_feature=use_feature)
        if loop_id is not None and cur != len(cur_pgo_poses) - 1:
            # descriptor node lags the current frame (map-context latency):
            # chain T_l<-c' = T_l<-c @ T_c<-w @ T_w<-c'
            # (reference: utils/loop_detector.py:207-213)
            T = T @ np.linalg.inv(cur_pgo_poses[cur]) @ cur_pgo_poses[-1]
        return loop_id, cosdist, T

    def detect_loop(self, candidate_idx: np.ndarray,
                    use_feature: bool = False):
        """(reference :231-347). Feature mode retrieves by cosine distance
        of flattened [R*D] feature ring keys (reference :240-277)."""
        if candidate_idx.shape[0] == 0:
            return None, None, None
        if use_feature:
            rk_hist = np.stack([
                self.ringkeys_feature[i].reshape(-1)
                for i in candidate_idx])                     # [H, R*D]
        else:
            rk_hist = np.stack([self.ringkeys[i] for i in candidate_idx])

        if not self.query_contexts:
            self.query_contexts = [
                (self.contexts_feature if use_feature
                 else self.contexts)[self.curr_node_idx]]
            self.tran_from_frame = [np.eye(4)]

        min_dist, min_loop_idx, min_query = 1e5, None, 0
        for qi, qc in enumerate(self.query_contexts):
            qrk = sc2rk(qc).reshape(-1)
            if use_feature:
                den = (np.linalg.norm(rk_hist, axis=1)
                       * np.linalg.norm(qrk) + 1e-12)
                d = 1.0 - (rk_hist @ qrk) / den             # cosine dist
            else:
                d = np.abs(qrk[None] - rk_hist).sum(axis=1)  # L1 ring key
            j = int(np.argmin(d))
            if d[j] < min_dist:
                min_dist = float(d[j])
                min_loop_idx = int(candidate_idx[j])
                min_query = qi
        if min_loop_idx is None or min_dist > self.ringkey_dist_thre:
            return None, None, None

        if use_feature:
            cosdist, yaw_diff = distance_sc_feature(
                self.contexts_feature[min_loop_idx],
                self.query_contexts[min_query])
        else:
            cosdist, yaw_diff = distance_sc(
                self.contexts[min_loop_idx], self.query_contexts[min_query])
        if cosdist >= self.sc_cosdist_threshold:
            return None, None, None

        yaw = math.radians(yaw_diff * 360.0 / self.des_shape[1])
        T = np.eye(4)
        T[0, 0] = math.cos(yaw)
        T[0, 1] = math.sin(yaw)
        T[1, 0] = -math.sin(yaw)
        T[1, 1] = math.cos(yaw)
        T = T @ self.tran_from_frame[min_query]             # T_l<-c
        if not self.silence:
            print(f"global loop candidate: {self.curr_node_idx} --- "
                  f"{min_loop_idx} (cosdist {cosdist:.3f})")
        return min_loop_idx, cosdist, T

    def save_context_dict(self, path: str, poses: np.ndarray):
        extra = {}
        if self.contexts_feature:
            fk = sorted(self.contexts_feature)
            extra = {
                "feat_idx": np.array(fk),
                "contexts_feature": np.stack(
                    [self.contexts_feature[k] for k in fk]),
                "ringkeys_feature": np.stack(
                    [self.ringkeys_feature[k] for k in fk]),
            }
        np.savez_compressed(
            path,
            idx=np.array(sorted(self.contexts.keys())),
            contexts=np.stack([self.contexts[k]
                               for k in sorted(self.contexts)]),
            ringkeys=np.stack([self.ringkeys[k]
                               for k in sorted(self.ringkeys)]),
            poses=poses, **extra)

    def load_context_dict(self, path: str) -> np.ndarray:
        z = np.load(path)
        for i, k in enumerate(z["idx"]):
            self.contexts[int(k)] = z["contexts"][i]
            self.ringkeys[int(k)] = z["ringkeys"][i]
            self.valid_flags[int(k)] = True
        if "feat_idx" in z.files:
            for i, k in enumerate(z["feat_idx"]):
                self.contexts_feature[int(k)] = z["contexts_feature"][i]
                self.ringkeys_feature[int(k)] = z["ringkeys_feature"][i]
        return z["poses"]


class GTLoopManager:
    """Ground-truth loop oracle for debugging the PGO path in isolation
    (reference: utils/loop_detector.py:376-440). Detects a loop when the
    trajectory revisits a GT position it travelled far away from, and
    returns the GT relative transform — so detector errors can be ruled
    out when diagnosing pose-graph or deformation issues."""

    def __init__(self, config=None, max_loop_dist: float = 10.0,
                 min_travel_dist_ratio: float = 2.5,
                 exclude_recent_nodes: int = 30,
                 min_travel_dist: float = 30.0):
        self.max_loop_dist = max_loop_dist
        self.min_travel_dist_ratio = min_travel_dist_ratio
        self.exclude_recent_nodes = exclude_recent_nodes
        self.min_travel_dist = min_travel_dist
        self.gt_position: list = []
        self.gt_pose: list = []
        self.travel_dist: list = []
        self.min_loop_idx = int(1e9)
        self.curr_node_idx = 0

    def add_node(self, node_idx: int, gt_pose: np.ndarray):
        gt_pose = np.asarray(gt_pose, np.float64)
        assert node_idx == len(self.gt_pose), "nodes must be added in order"
        self.curr_node_idx = node_idx
        self.gt_position.append(gt_pose[:3, 3])
        self.gt_pose.append(gt_pose)
        if node_idx == 0:
            self.travel_dist.append(0.0)
        else:
            step = float(np.linalg.norm(
                self.gt_position[node_idx] - self.gt_position[node_idx - 1]))
            self.travel_dist.append(self.travel_dist[node_idx - 1] + step)

    def detect_loop(self):
        """Returns (loop_index, loop_dist, T_loop<-current) or
        (None, None, None)."""
        valid_recent = self.curr_node_idx - self.exclude_recent_nodes
        if valid_recent <= 0:
            return None, None, None
        past = np.stack(self.gt_position[:valid_recent])
        dist_to_past = np.linalg.norm(
            self.gt_position[self.curr_node_idx] - past, axis=1)
        travel_to_past = (self.travel_dist[self.curr_node_idx]
                          - np.asarray(self.travel_dist[:valid_recent]))
        cand = ((travel_to_past > self.min_travel_dist_ratio * dist_to_past)
                & (travel_to_past > self.min_travel_dist))
        cand_idx = np.where(cand)[0]
        if cand_idx.size == 0:
            return None, None, None
        best = cand_idx[np.argmin(dist_to_past[cand])]
        loop_dist = float(dist_to_past[best])
        if loop_dist >= self.max_loop_dist:
            return None, None, None
        loop_trans = (np.linalg.inv(self.gt_pose[best])
                      @ self.gt_pose[self.curr_node_idx])
        self.min_loop_idx = min(self.min_loop_idx, int(best))
        return int(best), loop_dist, loop_trans
