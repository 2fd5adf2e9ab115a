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
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dt,
                          device=dev).expand(W, 1, 4)
    D = torch.cat([top, bottom], dim=1)                    # [W, 4, 4]
    eye = torch.eye(4, dtype=dt, device=dev).expand(first_opt, 4, 4)
    return base_poses @ torch.cat([eye, D])


def draw_ba_indices(generator, scount: torch.Tensor, *, n_iters: int,
                    bs: int) -> torch.Tensor:
    """The random draws of one BA run: [n_iters, bs] slots into the
    surface-sample list, uniform below max(scount, 1)."""
    return mp._randint(generator, n_iters * bs, scount,
                       scount.device).reshape(n_iters, bs)


def make_ba_loop(qp: mq.QueryParams, *, n_iters: int, bs: int, window: int,
                 lr_pose: float, lr_map: float, adam_eps: float = 1e-15):
    """One BA run over base poses [T, 4, 4] (float32; the last `window` are
    optimised) and the map features.

    Returns run(state, pool, geo_features, geo_mlp, base_poses, first_opt,
    generator, lf, draws=None) -> (poses [T, 4, 4], features, losses
    [n_iters]); `draws` (from `draw_ba_indices`) replaces the generator's
    draws."""

    def run(state, pool: mp.PoolState, geo_features, geo_mlp, base_poses,
            first_opt: int, generator, lf,
            draws: Optional[torch.Tensor] = None):
        T = base_poses.shape[0]
        if T - first_opt != window:
            raise ValueError(f"BA window {window} does not cover frames "
                             f"{first_opt}..{T - 1}")
        sidx, scount = collect_surface_samples(pool, SURFACE_SAMPLE_CAP)
        if draws is None:
            draws = draw_ba_indices(generator, scount, n_iters=n_iters, bs=bs)
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
        losses = []
        for i in range(n_iters):
            rows = sidx[draws[i]]
            world = pool.coord[rows]
            ts = pool.ts[rows].long()
            base_T = base_poses[ts]
            # coordinates in the frame's sensor frame under the BASE pose,
            # re-projected through the optimised pose
            local = torch.einsum("nba,nb->na", base_T[:, :3, :3],
                                 world - base_T[:, :3, 3])
            opt.zero_grad(set_to_none=True)
            poses = apply_delta(base_poses, deltas, first_opt)
            opt_T = mq.gather_rows_exact(poses.reshape(T, 16), ts
                                         ).reshape(-1, 4, 4)
            coord = torch.einsum("nab,nb->na", opt_T[:, :3, :3], local) \
                + opt_T[:, :3, 3]
            out = mq.query_decode(feats, mlp, coord, qp, state=state, lf=lf)
            loss = torch.mean(out.sdf ** 2)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        with torch.no_grad():
            poses = apply_delta(base_poses, deltas, first_opt)
        return poses, feats.detach(), torch.stack(losses)

    return run


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
    poses, feats, losses = loop(
        system.state, system.pool, system.params["geo_features"],
        system.params["geo_mlp"], system._tensor(base), first_opt,
        system.gen, system._lf(frame_id), draws=draws)
    poses_np = poses.cpu().numpy().astype(np.float64)

    # the replay pool's world coordinates follow each frame's correction
    diffs = np.stack([poses_np[i] @ np_se3_inv(base[i]) for i in range(n)])
    pool = system.pool
    system.pool = pool.replace(coord=transform_points_by_ts(
        pool.coord, pool.ts, system._tensor(diffs)))

    chain[:n] = poses_np
    system.cur_pose_ref = poses_np[-1]
    system.last_pose_ref = poses_np[-1]
    system.state = system.state.replace(geo_features=feats)
    system.sync_feature_params()
    system.last_ba_losses = losses
    return float(losses[-1])
