"""Sliding-window bundle adjustment: joint pose + map refinement. Port of
`pin_slam_tpu/slam/ba.py`.

Optimises the last `window` poses (right-multiplied se(3) tangent deltas on
frozen base poses) together with the map features against the squared SDF
at the measured surface points, with Adam and separate pose and map
learning rates; the decoder is frozen. The map is queried through the cell
probe under the system's travel-window filter.

Every float sum with repeated indices in the backward pass (the features'
gather, the per-sample pose gather) is order-free
(`map_query.gather_rows_exact`), so a run repeats bit for bit on the card.

On the card, iterations 2..n of a run replay iteration 2's loss and
gradient from a CUDA graph captured for that run (the map, the pool, the
poses and the filter stay put through a run; each iteration's draws go in
by one device copy), and Adam steps eagerly after each, so the run repeats
the eager loop bit for bit with one graph launch in place of the many
kernel launches of the loss and its backward pass.

A run is a `ba.run` stage span (`utils/tracing.py`) holding `ba.collect`
(the surface-sample list and the draws), one `ba.iter` per iteration with
`ba.loss` and `ba.backward` inside it (within `ba.capture` on the one
iteration captured), or `ba.replay`, and `ba.step`, and `ba.writeback` (the
pose chain, the replay pool and the map features). The system keeps the
run's iteration and surface-sample counts in `last_ba_iters` and
`last_ba_samples`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pin_slam_tpu_torch.ops.transforms import (
    np_se3_inv,
    so3_exp,
    transform_points_by_ts,
)
from pin_slam_tpu_torch.slam import map_query as mq
from pin_slam_tpu_torch.slam import mapper as mp
from pin_slam_tpu_torch.utils import tracing

SURFACE_SAMPLE_CAP = 1 << 18


def collect_surface_samples(pool: mp.PoolState, cap: int):
    """Pool rows of the first `cap` exact-endpoint samples (sdf label == 0),
    in pool order. Returns (idx [cap], count)."""
    P = pool.capacity
    dev = pool.coord.device
    rows = torch.arange(P + 1, device=dev)
    is_surf = (rows < pool.count) & (torch.abs(pool.sdf_label) < 1e-9)
    order = torch.cumsum(is_surf.to(torch.int64), 0) - 1
    ok = is_surf & (order < cap)
    dest = torch.where(ok, order, torch.full_like(order, cap))
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    # every kept row has its own destination; only the dump row repeats
    idx[dest] = rows
    return idx[:cap], ok.sum()


def apply_delta(base_poses: torch.Tensor, deltas: torch.Tensor,
                first_opt: int) -> torch.Tensor:
    """pose_i = base_i @ Exp(delta_{i - first_opt}) for i >= first_opt,
    base_i before. base [T, 4, 4], deltas [W, 6] with T - first_opt = W."""
    W = deltas.shape[0]
    dev, dt = base_poses.device, base_poses.dtype
    top = torch.cat([so3_exp(deltas[:, :3]), deltas[:, 3:, None]], dim=-1)
    # [0, 0, 0, 1] made on the device: a host copy cannot be captured
    bottom = torch.zeros((W, 1, 4), dtype=dt, device=dev)
    bottom[..., 3] = 1.0
    D = torch.cat([top, bottom], dim=1)                    # [W, 4, 4]
    eye = torch.eye(4, dtype=dt, device=dev).expand(first_opt, 4, 4)
    return base_poses @ torch.cat([eye, D])


def draw_ba_indices(generator, scount: torch.Tensor, *, n_iters: int,
                    bs: int) -> torch.Tensor:
    """The random draws of one BA run: [n_iters, bs] slots into the
    surface-sample list, uniform below max(scount, 1)."""
    return mp._randint(generator, n_iters * bs, scount,
                       scount.device).reshape(n_iters, bs)


def _capture(fn):
    """`fn()` captured as a CUDA graph on a side stream (nothing runs).
    Returns (graph, what `fn` returned: tensors the replays write). Unlike
    `torch.cuda.graph` it neither waits for the device nor empties the
    allocator's cache, which a capture in every BA run would pay for in
    the frames after it."""
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            out = fn()
        finally:
            graph.capture_end()
    cur.wait_stream(side)
    return graph, out


def make_ba_loop(qp: mq.QueryParams, *, n_iters: int, bs: int, window: int,
                 lr_pose: float, lr_map: float, adam_eps: float = 1e-15,
                 _eager: bool = False):
    """One BA run over base poses [T, 4, 4] (float32; the last `window` are
    optimised) and the map features.

    Returns run(state, pool, geo_features, geo_mlp, base_poses, first_opt,
    generator, lf, draws=None, info=None) -> (poses [T, 4, 4], features,
    losses [n_iters]); `draws` (from `draw_ba_indices`) replaces the
    generator's draws; a dict `info` receives the surface-sample count the
    draws were taken below (a device scalar) under "samples". On the card
    iterations 2..n are replayed from a graph captured at iteration 2;
    `_eager` runs every iteration eagerly (the card test's reference)."""

    def run(state, pool: mp.PoolState, geo_features, geo_mlp, base_poses,
            first_opt: int, generator, lf,
            draws: Optional[torch.Tensor] = None,
            info: Optional[dict] = None):
        T = base_poses.shape[0]
        if T - first_opt != window:
            raise ValueError(f"BA window {window} does not cover frames "
                             f"{first_opt}..{T - 1}")
        with tracing.span("ba.collect"):
            sidx, scount = collect_surface_samples(pool, SURFACE_SAMPLE_CAP)
            if draws is None:
                draws = draw_ba_indices(generator, scount, n_iters=n_iters,
                                        bs=bs)
        if info is not None:
            info["samples"] = scount
        dev = base_poses.device
        deltas = torch.zeros((window, 6), device=dev, requires_grad=True)
        feats = geo_features.detach().clone().requires_grad_(True)
        mlp = {"w": [w.detach() for w in geo_mlp["w"]],
               "b": [b.detach() for b in geo_mlp["b"]]}
        # optax.adam(lr, eps) per group; the decoder takes no update
        opt = torch.optim.Adam(
            [{"params": [deltas], "lr": lr_pose},
             {"params": [feats], "lr": lr_map}],
            betas=(0.9, 0.999), eps=adam_eps)
        # the draws of the iteration under way, read by the loss
        cur = draws[0].clone()

        def iterate():
            """The loss of the draws in `cur` and its gradient for the
            deltas and the features."""
            with tracing.span("ba.loss"):
                rows = sidx[cur]
                world = pool.coord[rows]
                ts = pool.ts[rows].long()
                base_T = base_poses[ts]
                # coordinates in the frame's sensor frame under the BASE
                # pose, re-projected through the optimised pose
                local = torch.einsum("nba,nb->na", base_T[:, :3, :3],
                                     world - base_T[:, :3, 3])
                poses = apply_delta(base_poses, deltas, first_opt)
                opt_T = mq.gather_rows_exact(poses.reshape(T, 16), ts
                                             ).reshape(-1, 4, 4)
                coord = torch.einsum("nab,nb->na", opt_T[:, :3, :3],
                                     local) + opt_T[:, :3, 3]
                out = mq.query_decode(feats, mlp, coord, qp, state=state,
                                      lf=lf)
                loss = torch.mean(out.sdf ** 2)
            with tracing.span("ba.backward"):
                grads = torch.autograd.grad(loss, (deltas, feats))
            return loss.detach(), grads

        replay = dev.type == "cuda" and not _eager
        graph = captured = None
        losses = torch.empty(n_iters, device=dev)
        for i in range(n_iters):
            with tracing.span("ba.iter"):
                if i:
                    cur.copy_(draws[i])
                if replay and i == 1:
                    with tracing.span("ba.capture"):
                        graph, captured = _capture(iterate)
                if graph is None:
                    loss, grads = iterate()
                else:
                    with tracing.span("ba.replay"):
                        graph.replay()
                    loss, grads = captured
                with tracing.span("ba.step"):
                    opt.zero_grad(set_to_none=True)
                    deltas.grad, feats.grad = grads
                    opt.step()
                losses[i].copy_(loss)
        with torch.no_grad():
            poses = apply_delta(base_poses, deltas, first_opt)
        return poses, feats.detach(), losses

    return run


@tracing.spanned("ba.run", is_stage=True)
def run_bundle_adjustment(system, frame_id: int,
                          draws: Optional[torch.Tensor] = None) -> float:
    """Bundle adjustment over the last min(ba_frame, frame_id + 1) frames of
    `system`: updates its pose chain (pgo_poses with pgo_on, else
    odom_poses), current and last pose, map features and the replay pool
    (each row moved by the correction of its own timestamp) in place.
    `draws` replaces the random draws (parity tests). Returns the last
    loss; the whole curve is left in `system.last_ba_losses`."""
    c = system.config
    n = frame_id + 1
    window = min(c.ba_frame, n)
    first_opt = n - window
    loop = make_ba_loop(system.qp, n_iters=c.ba_iters, bs=c.ba_bs,
                        window=window, lr_pose=c.lr_pose, lr_map=c.lr_ba_map,
                        adam_eps=c.adam_eps)
    chain = system.pgo_poses if c.pgo_on else system.odom_poses
    base = chain[:n].copy()
    info = {}
    poses, feats, losses = loop(
        system.state, system.pool, system.params["geo_features"],
        system.params["geo_mlp"], system._tensor(base), first_opt,
        system.gen, system._lf(frame_id), draws=draws, info=info)
    with tracing.span("ba.writeback"):
        poses_np = poses.cpu().numpy().astype(np.float64)

        # the replay pool's world coordinates follow each frame's correction
        diffs = np.stack([poses_np[i] @ np_se3_inv(base[i])
                          for i in range(n)])
        pool = system.pool
        system.pool = pool.replace(coord=transform_points_by_ts(
            pool.coord, pool.ts, system._tensor(diffs)))

        chain[:n] = poses_np
        system.cur_pose_ref = poses_np[-1]
        system.last_pose_ref = poses_np[-1]
        system.state = system.state.replace(geo_features=feats)
        system.sync_feature_params()
    system.last_ba_losses = losses
    system.last_ba_iters = int(losses.shape[0])
    system.last_ba_samples = int(info["samples"])
    return float(losses[-1])
