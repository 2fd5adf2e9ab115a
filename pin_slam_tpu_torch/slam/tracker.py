"""Correspondence-free point-to-SDF registration (odometry). Port of
`pin_slam_tpu/slam/tracker.py`: cached candidates for geometry-only
tracking against a local set, and the uncached path, which probes the map
every iteration: the colour tracking's (it weighs each point by how well
the map's colour agrees with the point's, `color_mode` 1, or adds a
photometric term, `color_mode` 2), and every registration without a local
set, which probes the whole map state through its hash table
(`probe_mode` cells or brick) with the travel-window filter.

Gauss-Newton/LM in float32 in a sensor-anchored frame: transform -> SDF
and its analytic gradient from the map -> Geman-McClure weights -> 6x6
solve -> pose update -> failure and convergence checks. The JAX package
runs the iterations in one `lax.while_loop` on the device; here they are a
Python loop that reads the stop flag on the host once per iteration (one
device sync per GN iteration; a CUDA graph of the loop body is later work).
A registration is a `tracker.track` span (`utils/tracing.py`), each GN
iteration with the read of its stop flag a `tracker.iter` span inside it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pin_slam_tpu_torch.ops import knn_join as kj
from pin_slam_tpu_torch.models import neural_points as npm
from pin_slam_tpu_torch.ops.transforms import rotation_angle, so3_exp
from pin_slam_tpu_torch.slam import map_query as mq
from pin_slam_tpu_torch.utils import tracing

CAND_K = 12


class TrackerParams(NamedTuple):
    """Registration parameters (the JAX package's defaults)."""

    reg_iter_n: int = 50
    min_grad_norm: float = 0.5
    max_grad_norm: float = 2.0
    gm_dist: float = 0.3
    gm_grad: float = 0.1
    lm_lambda: float = 1e-4
    term_thre_deg: float = 0.01
    term_thre_m: float = 0.001
    max_sdf_std: float = 0.25
    max_valid_residual_cm: float = 15.0
    min_valid_ratio: float = 0.2
    min_valid_points: int = 30
    mask_min_nn_count: int = 6
    eigenvalue_check: bool = True
    eigenvalue_ratio_thre: float = 0.005
    max_increment_residual_ratio: float = 1.1
    weighted_first: bool = True
    # minimum GN iterations before the small-update termination may fire
    min_iter_n: int = 2
    # graduated non-convexity of the GM scales (1.0 = off)
    gm_anneal: float = 1.0
    # colour: 0 = geometry only, 1 = colour-consistency weight, 2 =
    # photometric term (robust GM weight photometric_gm on the intensity
    # residual)
    color_mode: int = 0
    photometric_weight: float = 0.01
    photometric_gm: float = 0.02
    color_channel: int = 1


class TrackResult(NamedTuple):
    pose: torch.Tensor          # [4, 4] f32, anchored world frame
    cov: torch.Tensor           # [6, 6]
    valid: torch.Tensor         # scalar bool
    residual_cm: torch.Tensor   # scalar
    valid_count: torch.Tensor   # scalar
    iterations: torch.Tensor    # scalar i64
    eigenvalues: torch.Tensor   # [3] translation-part eigenvalues
    weights: torch.Tensor       # [S] per-point robust weights
    valid_mask: torch.Tensor    # [S]
    fail_code: torch.Tensor     # bitmask: 1=residual blow-up, 2=too few
    #                             valid, 4=final residual, 8=eigenvalues


def intensity(color: torch.Tensor, channels: int) -> torch.Tensor:
    """[N, C] colour -> [N] intensity (luma of RGB)."""
    if channels == 3:
        return (0.299 * color[:, 0] + 0.587 * color[:, 1]
                + 0.114 * color[:, 2])
    return color[:, 0]


def make_tracker(qp: mq.QueryParams, tp: TrackerParams):
    """Returns track(geo_features, geo_mlp, src, src_mask, init_T, anchor,
    lset, loop_reg=False, src_intensity=None, color_features=None,
    color_mlp=None, state=None, lf=None) -> TrackResult. With a local set,
    `geo_features` (and `color_features`) are the compact [L+1, F] arrays
    aligned with `lset`; with `lset=None` they are the map's [C+1, F]
    arrays and every iteration probes `state` under the LocalFilter `lf`.
    With `color_mode` > 0 and `color_mlp` given the registration takes the
    uncached path; calls without the colour arguments (the loop closure's)
    register on geometry alone."""

    def weigh(pts, sdf, grad, nn_count, std, src_mask, gm_scale,
              color_w=None):
        """Validity, Geman-McClure weights (times `color_w` where given,
        before the validity mask) and the normal equations."""
        grad_norm = torch.linalg.norm(grad, dim=-1)
        valid = (src_mask & (nn_count >= tp.mask_min_nn_count)
                 & (grad_norm > tp.min_grad_norm)
                 & (grad_norm < tp.max_grad_norm))
        if not tp.weighted_first and std is not None:
            valid = valid & (std.detach() < tp.max_sdf_std)

        residual = sdf
        grad_anomaly = grad_norm - 1.0
        gm_g = tp.gm_grad * gm_scale
        gm_d = tp.gm_dist * gm_scale
        w_grad = (gm_g / (gm_g + grad_anomaly ** 2)) ** 2
        w_res = (gm_d / (gm_d + residual ** 2)) ** 2
        w = w_grad * w_res
        if color_w is not None:
            w = w * color_w
        w = torch.where(valid, w, torch.zeros_like(residual))
        vcount = valid.sum()
        vc = torch.clamp(vcount.to(torch.float32), min=1.0)
        w = w / (2.0 * (w.sum() / vc) + 1e-12)

        cross = torch.linalg.cross(pts, grad, dim=-1)
        J = torch.cat([cross, grad], dim=-1)               # [S, 6]
        Jw = J * w[:, None]
        H = Jw.T @ J
        g = -(Jw.T @ residual)
        res_cm = (torch.where(valid, residual.abs(),
                              torch.zeros_like(residual)).sum() / vc * 100.0)
        mse = (w * residual ** 2).sum() / vc
        return H, g, res_cm, vcount, mse, w, valid

    def quantities(geo_mlp, pts, src_mask, anchor, lset, cand, cvalid,
                   gm_scale, rows):
        p = pts.detach().requires_grad_(True)
        with torch.enable_grad():
            sdf, nn_count, std = mq.decode_sdf_candidates(
                lset, geo_mlp, p + anchor, cand, cvalid, qp, rows,
                with_std=not tp.weighted_first)
            (grad,) = torch.autograd.grad(sdf.sum(), p)
        return weigh(pts, sdf.detach(), grad, nn_count, std, src_mask,
                     gm_scale)

    def quantities_uncached(geo_features, geo_mlp, pts, src_mask, anchor,
                            gm_scale, lset, state, lf, qperm,
                            src_intensity, color_features, color_mlp):
        """One probe (of the local set, or of the map state) serves the SDF
        decode and, with `color_mlp`, the colour decode, and the gradients
        of both w.r.t. the points (the JAX package probes twice; the probe
        is deterministic)."""
        p = pts.detach().requires_grad_(True)
        with torch.enable_grad():
            out = mq.query_decode(
                geo_features, geo_mlp, p, qp, lset=lset, state=state, lf=lf,
                anchor=anchor, with_std=not tp.weighted_first, qperm=qperm,
                color_features=color_features, color_mlp=color_mlp,
                color_channel=tp.color_channel)
            (grad,) = torch.autograd.grad(out.sdf.sum(), p,
                                          retain_graph=color_mlp is not None)
            if color_mlp is not None:
                inten = intensity(out.color, tp.color_channel)
                (int_grad,) = torch.autograd.grad(inten.sum(), p)
        if color_mlp is None:
            return weigh(pts, out.sdf.detach(), grad, out.nn_count,
                         out.sdf_std, src_mask, gm_scale)
        int_pred = inten.detach()
        color_w = (torch.exp(-torch.abs(int_pred - src_intensity))
                   if tp.color_mode == 1 else None)
        H, g, res_cm, vcount, mse, w, valid = weigh(
            pts, out.sdf.detach(), grad, out.nn_count, out.sdf_std,
            src_mask, gm_scale, color_w)
        if tp.color_mode == 2:
            # photometric term, robust to the colour residual and annealed
            # with the geometric scales
            res_c = int_pred - src_intensity
            w_c = (tp.photometric_gm / (tp.photometric_gm + res_c ** 2)) ** 2
            photo_fac = tp.photometric_weight / (gm_scale * gm_scale)
            Jc = torch.cat([torch.linalg.cross(pts, int_grad, dim=-1),
                            int_grad], dim=-1)
            Jcw = Jc * (w * w_c)[:, None]
            H = H + photo_fac * (Jcw.T @ Jc)
            g = g - photo_fac * (Jcw.T @ res_c)
        return H, g, res_cm, vcount, mse, w, valid

    @tracing.spanned("tracker.track")
    def track(geo_features, geo_mlp, src: torch.Tensor,
              src_mask: torch.Tensor, init_T: torch.Tensor,
              anchor: torch.Tensor, lset, loop_reg: bool = False,
              src_intensity=None, color_features=None, color_mlp=None,
              state=None, lf=None) -> TrackResult:
        dev = src.device
        S = src.shape[0]
        src_count = torch.clamp(src_mask.sum(), min=1)
        min_ratio = 0.15 if loop_reg else tp.min_valid_ratio
        use_color = tp.color_mode > 0 and color_mlp is not None

        qperm0 = None
        if lset is not None:
            # one Morton sort per track: the source moves rigidly by
            # centimeters between GN iterations and the k-NN recomputes
            # tile bounding boxes from the true points on every probe, so
            # results stay exact
            pad0 = (-S) % kj.TQ
            q0 = torch.where(src_mask[:, None],
                             src @ init_T[:3, :3].T + init_T[:3, 3] + anchor,
                             torch.full_like(src, kj.PAD))
            q0 = torch.cat([q0, torch.full((pad0, 3), kj.PAD, device=dev)])
            qperm0 = kj._sort_by_morton(
                q0, torch.cat([src_mask, torch.zeros(pad0, dtype=torch.bool,
                                                     device=dev)]),
                qp.resolution * 4.0)

        def probe(pts_abs):
            qn = npm.query_neighbors_join(
                pts_abs, lset, nn_k=CAND_K, max_dist2=qp.join_max_dist2,
                resolution=qp.resolution, local_ids=True, qperm=qperm0)
            return qn.idx, qn.valid

        eye6 = torch.eye(6, device=dev)
        st = dict(T=init_T, i=0, last_res=torch.tensor(1e5, device=dev),
                  valid=torch.tensor(True, device=dev),
                  converged=torch.tensor(False, device=dev),
                  stop=torch.tensor(False, device=dev), H=eye6,
                  res_cm=torch.tensor(0.0, device=dev),
                  vcount=torch.tensor(0, device=dev),
                  mse=torch.tensor(0.0, device=dev),
                  fail=torch.tensor(0, device=dev),
                  w=torch.zeros(S, device=dev),
                  vmask=torch.zeros(S, dtype=torch.bool, device=dev))

        def gn_update(q):
            H, g, res_cm, vcount, mse, w_pts, vmask = q
            H_lm = H + tp.lm_lambda * torch.diag(torch.diag(H))
            enough = vcount >= 10
            H_safe = torch.where(enough, H_lm, eye6)
            delta = torch.linalg.solve(
                H_safe, torch.where(enough, g, torch.zeros_like(g)))
            dR = so3_exp(delta[:3])
            dT = torch.eye(4, device=dev)
            dT[:3, :3] = dR
            dT[:3, 3] = delta[3:]
            T_new = torch.where(enough, dT @ st["T"], st["T"])

            last_res = st["last_res"]
            inc_fail = (res_cm - last_res) / last_res \
                > tp.max_increment_residual_ratio
            few_fail = (vcount < tp.min_valid_points) | (
                vcount.to(torch.float32) / src_count.to(torch.float32)
                < min_ratio)
            valid_new = st["valid"] & ~inc_fail & ~few_fail
            fail_new = (st["fail"] | torch.where(inc_fail, 1, 0)
                        | torch.where(few_fail, 2, 0))
            stop_new = (~valid_new) | st["converged"]
            rot_deg = rotation_angle(dR) * 180.0 / torch.pi
            tran_m = torch.linalg.norm(delta[3:])
            i = st["i"]
            small = ((rot_deg.abs() < tp.term_thre_deg)
                     & (tran_m < tp.term_thre_m) & (i + 1 >= tp.min_iter_n))
            converged_new = st["converged"] | small | (i == tp.reg_iter_n - 2)
            st.update(T=T_new, i=i + 1,
                      last_res=torch.where(inc_fail, last_res, res_cm),
                      valid=valid_new, converged=converged_new,
                      stop=stop_new, H=H, res_cm=res_cm, vcount=vcount,
                      mse=mse, fail=fail_new, w=w_pts, vmask=vmask)

        def gm_scale(i):
            return max(1.0, tp.gm_anneal * 0.5 ** i)

        def stopped():
            """The host's read of the stop flag (a device sync), skipped
            once the iteration budget is spent."""
            return st["i"] >= tp.reg_iter_n or bool(st["stop"])

        def iterate(q_of):
            """One GN iteration on the quantities `q_of(pts)` at the
            current pose, and the read of its stop flag."""
            with tracing.span("tracker.iter"):
                pts = src @ st["T"][:3, :3].T + st["T"][:3, 3]
                gn_update(q_of(pts))
                return stopped()

        def finish():
            """The final residual and eigenvalue checks."""
            res_ok = st["res_cm"] <= tp.max_valid_residual_cm
            valid_flag = st["valid"] & res_ok
            fail = st["fail"] | torch.where(res_ok, 0, 4)
            H_raw = st["H"]
            eig = torch.linalg.eigvalsh(H_raw[3:, 3:])
            if tp.eigenvalue_check:
                eig_ok = eig[0] >= st["vcount"].to(torch.float32) \
                    * tp.eigenvalue_ratio_thre
                valid_flag = valid_flag & eig_ok
                fail = fail | torch.where(eig_ok, 0, 8)
            cov = torch.linalg.inv(H_raw + 1e-9 * eye6) * st["mse"]
            return TrackResult(
                pose=st["T"], cov=cov, valid=valid_flag,
                residual_cm=st["res_cm"], valid_count=st["vcount"],
                iterations=torch.tensor(st["i"], device=dev), eigenvalues=eig,
                weights=st["w"], valid_mask=st["vmask"], fail_code=fail)

        if use_color or lset is None:
            # uncached: a probe and a decode every iteration (of both heads
            # when tracking colour)
            if not use_color:
                color_mlp = color_features = None
            stop = stopped()
            while not stop:
                stop = iterate(lambda pts: quantities_uncached(
                    geo_features, geo_mlp, pts, src_mask, anchor,
                    gm_scale(st["i"]), lset, state, lf, qperm0,
                    src_intensity, color_features, color_mlp))
            return finish()

        # PROBED phase: a fresh candidate probe per GN step (the pose moves
        # most in the first iterations); once stopped, the state is final
        track_pack = mq.pack_lset_rows(lset, geo_features)
        n_probed = 5 if loop_reg else 3
        cand = cvalid = rows = None

        def cached(pts):
            return quantities(geo_mlp, pts, src_mask, anchor, lset, cand,
                              cvalid, gm_scale(st["i"]), rows)

        def probed(pts):
            nonlocal cand, cvalid, rows
            cand, cvalid = probe(pts + anchor)
            rows = track_pack[torch.where(cvalid, cand,
                                          torch.full_like(cand, lset.cap))]
            return cached(pts)

        stop = False
        for _ in range(n_probed):
            stop = iterate(probed)
            if stop:
                break
        # CACHED phase: the last probe's candidates, re-ranked exactly to
        # the top nn_k every iteration
        while not stop:
            stop = iterate(cached)
        return finish()

    return track
