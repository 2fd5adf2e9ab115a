"""Pose-graph optimization: sparse Gauss-Newton over SE(3), on the host.
The port's own copy of `pin_slam_tpu/slam/pgo.py` (numpy and scipy only);
its `write_g2o` takes the quaternion from a numpy function instead of the
device one.

* residual per edge (i, j, Z): r = [so3_log(R_err), t_err] of
  E = Z^-1 (T_i^-1 T_j), weighted by the per-edge sqrt information
  (fixed tran/rot stds or the registration covariance),
* ANALYTIC right-perturbation Jacobians (standard SE(3) adjoint forms,
  batched over all edges):
      d r_rot / d xi_j  = [Jr^-1(r_rot), 0]
      d r_tran/ d xi_j  = [0,            R_E]
      d r_rot / d xi_i  = [-Jr^-1(r_rot) Ra^T, 0]
      d r_tran/ d xi_i  = [R_Z^T [t_A]x,      -R_Z^T]
  with A = T_i^-1 T_j, E = Z^-1 A, and Jr the SO(3) right Jacobian,
* normal equations assembled block-sparse and solved with scipy's sparse LU,
* INCREMENTAL WINDOWING: with the gauge fixed at node 0, nodes earlier than
  the earliest loop-edge endpoint feel no net force (the odometry chain is
  self-consistent), so the exact GN solution leaves them unchanged — the
  solve runs only over [earliest loop endpoint, newest node], fixing the
  window's first node.

Loops are rare (every `pgo_freq` frames at most), so the solve runs on the
host; the heavy consequences (elastic map deformation, pool transform) run
on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from pin_slam_tpu_torch.ops.transforms import np_rotmat_to_quat


def so3_log_batch(R: np.ndarray) -> np.ndarray:
    """[..., 3, 3] -> [..., 3] axis-angle (numerically safe)."""
    tr = np.trace(R, axis1=-2, axis2=-1)
    cos = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    w = 0.5 * np.stack(
        [R[..., 2, 1] - R[..., 1, 2],
         R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    s = np.sin(theta)
    factor = np.where(theta < 1e-6, 1.0 + theta**2 / 6.0, theta / np.where(
        np.abs(s) < 1e-12, 1.0, s))
    return w * factor[..., None]


def _so3_exp(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3) + _skew(w)
    k = w / theta
    K = _skew(k)
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _apply_tangent(T: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """Right perturbation: T' = T * [exp(xi_rot), xi_tran]."""
    D = np.eye(4)
    D[:3, :3] = _so3_exp(xi[:3])
    D[:3, 3] = xi[3:]
    return T @ D


def _skew_batch(v: np.ndarray) -> np.ndarray:
    """[..., 3] -> [..., 3, 3]."""
    z = np.zeros_like(v[..., 0])
    return np.stack([
        np.stack([z, -v[..., 2], v[..., 1]], -1),
        np.stack([v[..., 2], z, -v[..., 0]], -1),
        np.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _jr_inv_batch(phi: np.ndarray) -> np.ndarray:
    """Inverse SO(3) right Jacobian, batched [..., 3] -> [..., 3, 3]:
    Jr^-1 = I + 1/2 [phi]x + (1/th^2 - (1+cos th)/(2 th sin th)) [phi]x^2."""
    theta = np.linalg.norm(phi, axis=-1)
    K = _skew_batch(phi)
    K2 = np.einsum("...ab,...bc->...ac", K, K)
    small = theta < 1e-6
    th = np.where(small, 1.0, theta)
    coef = np.where(
        small, 1.0 / 12.0,
        1.0 / th**2 - (1.0 + np.cos(th)) / (2.0 * th * np.sin(
            np.where(small, 1.0, th))))
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + 0.5 * K + coef[..., None, None] * K2


class PoseGraphManager:
    """API mirrors the reference PoseGraphManager (utils/pgo.py:18-338)."""

    def __init__(self, config):
        self.config = config
        self.silence = config.silence
        self.tran_std = config.pgo_tran_std
        self.rot_std = np.radians(config.pgo_rot_std)
        # Loop edges are priced SEPARATELY from odometry edges. A loop
        # edge's dominant error is systematic: the local map it was
        # registered against carries the accumulated drift of the anchor
        # segment (measured in the long gauntlet: 0.35-1.2 deg / 0.7-2.0 m
        # actual edge error vs GT while the registration covariance claims
        # ~0.01 deg / ~3 mm). Pricing loops at the odometry stds made the
        # solver warp a near-perfect odometry rotation chain to satisfy
        # slightly-wrong loop rotations (ARE 0.22 -> 3.2 deg). Honest
        # pricing: rotation at ~degree scale, translation floored by the
        # drift estimate at closure time (see add_loop_factor).
        self.loop_tran_std = getattr(config, "pgo_loop_tran_std", 0.05)
        self.loop_rot_std = np.radians(
            getattr(config, "pgo_loop_rot_std", 0.5))
        self.max_iter = config.pgo_max_iter
        self.error_thre_frame = config.pgo_error_thre_frame

        self.nodes: Dict[int, np.ndarray] = {}
        self.edges: List[dict] = []  # {i, j, Z, sqrt_w[6], is_loop}
        self.pgo_poses: Optional[np.ndarray] = None
        self.init_poses: Optional[np.ndarray] = None
        self.cur_pose: Optional[np.ndarray] = None

        self.last_loop_idx = 0
        self.min_loop_idx = int(1e9)
        self.last_error = 0.0
        self.pgo_count = 0
        self.drift_radius = 0.0
        self.loop_edges: List[np.ndarray] = []
        self.loop_trans: List[np.ndarray] = []
        self.loop_diags: List[dict] = []   # per-closure diagnostics

    # ------------------------------------------------------------- factors

    def add_frame_node(self, idx: int, pose: np.ndarray):
        self.nodes[idx] = np.asarray(pose, np.float64)

    def _sqrt_w(self, cov: Optional[np.ndarray],
                is_loop: bool = False) -> np.ndarray:
        if is_loop:
            # translation floor scales with the drift estimate at closure
            # time: the map the edge was refined against is itself offset
            # by roughly the anchor segment's accumulated drift
            tran_s = max(self.loop_tran_std, 0.3 * self.drift_radius)
            floor = np.array([self.loop_rot_std] * 3 + [tran_s] * 3)
        else:
            floor = np.array([self.rot_std] * 3 + [self.tran_std] * 3)
        if cov is not None and self.config.use_reg_cov_mat:
            d = np.sqrt(np.clip(np.diag(cov), 1e-12, None))
            # registration covariances model i.i.d. point noise only and
            # are overconfident about systematic error — floors still apply
            return 1.0 / np.maximum(d, floor)
        return 1.0 / floor

    def add_odometry_factor(self, cur: int, prev: int, T_rel: np.ndarray,
                            cov: Optional[np.ndarray] = None):
        """T_rel = T_prev<-cur (reference: utils/pgo.py:119-142)."""
        self.edges.append(dict(
            i=prev, j=cur, Z=np.asarray(T_rel, np.float64),
            sqrt_w=self._sqrt_w(cov), is_loop=False))

    def add_loop_factor(self, cur: int, loop: int, T_rel: np.ndarray,
                        cov: Optional[np.ndarray] = None) -> bool:
        """T_rel = T_loop<-cur. Applies the PRE-optimization error-budget
        outlier rejection (reference: utils/pgo.py:144-188): the graph
        error at the CURRENT estimates with the new edge added must stay
        within last_error + frame_gap * pgo_error_thre_frame. Checking
        before the solve matters — a wrong loop edge can be absorbed by
        warping the whole trajectory, so the post-solve error of a bad
        graph is not discriminative. Removes the edge and returns False
        on rejection."""
        edge = dict(i=loop, j=cur, Z=np.asarray(T_rel, np.float64),
                    # the budget check runs at the FIXED odometry pricing:
                    # discriminative, and independent of the honest (much
                    # looser) loop pricing swapped in below for the solve —
                    # loosening solver weights must not loosen rejection
                    sqrt_w=self._sqrt_w(cov), is_loop=True)
        self.edges.append(edge)
        n = max(self.nodes.keys()) + 1
        poses = np.stack([self.nodes[i] for i in range(n)])
        cur_error = self.total_error(poses)
        budget = self.last_error + \
            (cur - self.last_loop_idx) * self.error_thre_frame
        if cur_error > budget:
            self.edges.pop()
            if not self.silence:
                print(f"loop edge rejected: graph error {cur_error:.1f} "
                      f"> budget {budget:.1f}")
            return False
        edge["sqrt_w"] = self._sqrt_w(cov, is_loop=True)
        return True

    def estimate_drift(self, travel_dist, cur_id: int,
                       correct_ratio: float = 0.01):
        """Drift proportional to travel since the last loop
        (reference: utils/pgo.py:323-338)."""
        d_since = travel_dist[cur_id] - travel_dist[min(
            self.last_loop_idx, cur_id)]
        self.drift_radius = d_since * correct_ratio
        if self.pgo_count > 0:
            self.drift_radius += travel_dist[cur_id] * 0.001
        return self.drift_radius

    # ------------------------------------------------------------ residual

    def _residuals(self, poses: np.ndarray, ii, jj, Zinv, sqrt_w):
        rel = np.einsum("eab,ebc->eac", _inv_batch(poses[ii]), poses[jj])
        E = np.einsum("eab,ebc->eac", Zinv, rel)
        r = np.concatenate([so3_log_batch(E[:, :3, :3]), E[:, :3, 3]], axis=1)
        return (r * sqrt_w).reshape(-1)

    def total_error(self, poses: np.ndarray) -> float:
        if not self.edges:
            return 0.0
        ii, jj, Zinv, sqrt_w = self._edge_arrays()
        r = self._residuals(poses, ii, jj, Zinv, sqrt_w)
        return float(0.5 * np.dot(r, r))

    def _edge_arrays(self):
        ii = np.array([e["i"] for e in self.edges])
        jj = np.array([e["j"] for e in self.edges])
        Zinv = _inv_batch(np.stack([e["Z"] for e in self.edges]))
        sqrt_w = np.stack([e["sqrt_w"] for e in self.edges])
        return ii, jj, Zinv, sqrt_w

    # ------------------------------------------------------------ optimize

    def _jacobian_blocks(self, poses, ii, jj, Zinv, sqrt_w):
        """Analytic per-edge Jacobian blocks. Returns (r0 [ne*6],
        Ji [ne,6,6], Jj [ne,6,6]) with the sqrt-information weights already
        folded in."""
        A = np.einsum("eab,ebc->eac", _inv_batch(poses[ii]), poses[jj])
        E = np.einsum("eab,ebc->eac", Zinv, A)
        r_rot = so3_log_batch(E[:, :3, :3])
        r = np.concatenate([r_rot, E[:, :3, 3]], axis=1) * sqrt_w

        ne = len(ii)
        JrI = _jr_inv_batch(r_rot)                      # [ne,3,3]
        Ra_T = np.swapaxes(A[:, :3, :3], -1, -2)
        Rz_T = Zinv[:, :3, :3]                          # Z^-1's rotation
        R_E = E[:, :3, :3]
        ta_x = _skew_batch(A[:, :3, 3])

        Ji = np.zeros((ne, 6, 6))
        Jj = np.zeros((ne, 6, 6))
        Jj[:, :3, :3] = JrI
        Jj[:, 3:, 3:] = R_E
        Ji[:, :3, :3] = -np.einsum("eab,ebc->eac", JrI, Ra_T)
        Ji[:, 3:, :3] = np.einsum("eab,ebc->eac", Rz_T, ta_x)
        Ji[:, 3:, 3:] = -Rz_T
        # row weighting by sqrt information
        Ji *= sqrt_w[:, :, None]
        Jj *= sqrt_w[:, :, None]
        return r.reshape(-1), Ji, Jj

    def optimize_pose_graph(self, fixed_node: int = 0) -> bool:
        """Gauss-Newton solve with analytic SE(3) Jacobians (replaces the
        reference's GTSAM ISAM2/LM, utils/pgo.py:190-234). Work is bounded
        ISAM2-style by solving only the affected window
        [earliest loop endpoint, newest node] — exact, see module docstring.
        Updates self.pgo_poses / cur_pose. Applies the loop error budget;
        returns False (and reverts the last loop edge) on rejection."""
        n = max(self.nodes.keys()) + 1
        poses = np.stack([self.nodes[i] for i in range(n)])
        init_err = self.total_error(poses)
        ii, jj, Zinv, sqrt_w = self._edge_arrays()

        # affected window: nodes < base are untouched by the exact solution
        loop_lo = [min(e["i"], e["j"]) for e in self.edges if e["is_loop"]]
        base = max(fixed_node, min(loop_lo) if loop_lo else fixed_node)
        nw = n - base                       # window size (incl. fixed base)
        if nw < 2:
            nw, base = n, fixed_node

        er6 = (np.arange(len(ii) * 6).reshape(-1, 6, 1)
               + np.zeros((1, 1, 6), np.intp))          # [ne,6,6] row ids
        lam = 0.0                                       # GN; LM on demand
        for _ in range(self.max_iter):
            r0, Ji, Jj = self._jacobian_blocks(poses, ii, jj, Zinv, sqrt_w)
            ci = (ii[:, None, None] - base) * 6 + np.arange(6)[None, None, :]
            cj = (jj[:, None, None] - base) * 6 + np.arange(6)[None, None, :]
            ci = np.broadcast_to(ci, Ji.shape)
            cj = np.broadcast_to(cj, Jj.shape)
            # drop blocks of nodes outside the window or the fixed base node
            mi = (ii >= base + 1)[:, None, None] & np.ones_like(ci, bool)
            mj = (jj >= base + 1)[:, None, None] & np.ones_like(cj, bool)
            rows = np.concatenate([np.broadcast_to(er6, Ji.shape)[mi],
                                   np.broadcast_to(er6, Jj.shape)[mj]])
            cols = np.concatenate([ci[mi], cj[mj]]) - 6  # base node removed
            vals = np.concatenate([Ji[mi], Jj[mj]])
            ncols = (nw - 1) * 6
            J = sp.coo_matrix((vals, (rows, cols)),
                              shape=(len(ii) * 6, ncols)).tocsr()
            H = (J.T @ J).tocsc() + (1e-6 + lam) * sp.eye(ncols, format="csc")
            g = -J.T @ r0
            dx = spla.spsolve(H, g)
            D = np.tile(np.eye(4), (n - base - 1, 1, 1))
            dxb = dx.reshape(-1, 6)
            for k in range(n - base - 1):
                D[k, :3, :3] = _so3_exp(dxb[k, :3])
            D[:, :3, 3] = dxb[:, 3:]
            poses[base + 1:] = np.einsum("nab,nbc->nac", poses[base + 1:], D)
            # GN converges in a handful of iterations with analytic
            # Jacobians; stop once the update is below solver noise
            if float(np.max(np.abs(dx))) < 1e-6:
                break

        final_err = self.total_error(poses)
        # post-solve divergence backstop (the discriminative pre-solve
        # budget lives in add_loop_factor, reference :174-188)
        if final_err > self.error_thre_frame * n and final_err > init_err:
            if self.edges and self.edges[-1]["is_loop"]:
                self.edges.pop()
            if not self.silence:
                print(f"pgo rejected: error {final_err:.1f}")
            return False
        self.last_error = final_err

        self.init_poses = np.stack([self.nodes[i] for i in range(n)])
        self.pgo_poses = poses
        for i in range(n):
            self.nodes[i] = poses[i]
        self.cur_pose = poses[-1]
        self.pgo_count += 1
        return True

    def get_pose_diff(self) -> np.ndarray:
        """Per-frame correction transforms for the elastic map deformation
        (reference: utils/pgo.py:318-321): diff[i] = T_new[i] @ T_old[i]^-1."""
        return np.einsum("nab,nbc->nac", self.pgo_poses,
                         _inv_batch(self.init_poses))

    # ---------------------------------------------------------------- io

    def write_g2o(self, path: str):
        """(reference: utils/pgo.py:237-239)"""
        n = max(self.nodes.keys()) + 1
        with open(path, "w") as f:
            for i in range(n):
                T = self.nodes[i]
                q = np_rotmat_to_quat(T[:3, :3])
                t = T[:3, 3]
                f.write(f"VERTEX_SE3:QUAT {i} {t[0]} {t[1]} {t[2]} "
                        f"{q[1]} {q[2]} {q[3]} {q[0]}\n")
            for e in self.edges:
                Z = e["Z"]
                q = np_rotmat_to_quat(Z[:3, :3])
                t = Z[:3, 3]
                info = " ".join(["100 0 0 0 0 0", "100 0 0 0 0",
                                 "100 0 0 0", "100 0 0", "100 0", "100"])
                f.write(f"EDGE_SE3:QUAT {e['i']} {e['j']} "
                        f"{t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]} "
                        f"{info}\n")

    def write_loops(self, path: str):
        """(reference: utils/pgo.py:241-250)"""
        with open(path, "w") as f:
            for (edge, T) in zip(self.loop_edges, self.loop_trans):
                f.write(f"{edge[0]} {edge[1]} "
                        + " ".join(str(v) for v in T.reshape(-1)) + "\n")

    def read_loops(self, path: str, subsample_rate: int = 1) -> bool:
        """Read a loop log written by write_loops (reference:
        utils/pgo.py:252-282 reads its own 5-line format; ours is one
        line per loop: `loop_id frame_id T00 T01 ... T33`)."""
        self.loop_edges = []
        self.loop_trans = []
        try:
            with open(path) as f:
                lines = f.readlines()
        except IOError:
            return False
        for line in lines[::max(subsample_rate, 1)]:
            vals = line.split()
            if len(vals) < 2 + 16:
                continue
            self.loop_edges.append(
                np.array([int(vals[0]), int(vals[1])]))
            self.loop_trans.append(
                np.array([float(v) for v in vals[2:18]],
                         np.float64).reshape(4, 4))
        return True

    def offline_pgo(self, odom_poses: np.ndarray) -> np.ndarray:
        """Replay pose-graph optimization from an odometry trajectory plus
        loaded loop data — the reference's loop-closure debugging workflow
        (reference: utils/pgo.py:284-314). Returns the optimized poses."""
        odom_poses = np.asarray(odom_poses, np.float64)
        self.nodes = {}
        self.edges = []
        n = len(odom_poses)
        for i in range(n):
            self.add_frame_node(i, odom_poses[i])
        for i in range(n - 1):
            T_rel = np.linalg.inv(odom_poses[i]) @ odom_poses[i + 1]
            self.add_odometry_factor(i + 1, i, T_rel)
        for (edge, T) in zip(self.loop_edges, self.loop_trans):
            # replayed edges were already accepted online — append
            # directly, skipping the online pre-optimization error budget
            # (a replay against a different/drifted odometry would wrongly
            # re-reject known-good loops)
            self.edges.append(dict(
                i=int(edge[0]), j=int(edge[1]), Z=np.asarray(T, np.float64),
                sqrt_w=self._sqrt_w(None, is_loop=True), is_loop=True))
        self.optimize_pose_graph()
        return self.pgo_poses


def _inv_batch(T: np.ndarray) -> np.ndarray:
    out = np.zeros_like(T)
    Rt = np.swapaxes(T[..., :3, :3], -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ab,...b->...a", Rt, T[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out
