"""Map query + decode. Port of `pin_slam_tpu/slam/map_query.py`: the join
path (queries against a per-frame local set) and the lset-less path
(queries against the whole map through the cell-table or the brick-cache
probe: the track+map loop under `probe_mode` cells or brick, and offline
consumers such as the mesher), with the colour and semantic heads.

Query points may be given in an anchored frame (world minus a host-side
anchor) for float32 conditioning; `anchor` is added back where absolute
coordinates are needed (the k-NN against map positions).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from pin_slam_tpu_torch.models import neural_points as npm
from pin_slam_tpu_torch.models.decoder import (
    color_apply,
    sdf_apply,
    sem_log_prob_apply,
    weighted_reduce,
)
from pin_slam_tpu_torch.ops import fused_decode, hash3d
from pin_slam_tpu_torch.ops.scatter import index_add_exact
from pin_slam_tpu_torch.ops.transforms import quat_rotate


class QueryParams(NamedTuple):
    """Static query configuration."""

    offsets: tuple            # neighborhood cell offsets as nested tuples
    resolution: float
    nn_k: int
    max_dist2: float
    sdf_scale: float
    weighted_first: bool
    # offsets are always rotated by the stored point orientations (identity
    # until the first map deformation)
    after_pgo: bool = True
    layer_norm_on: bool = False
    probe_mode: str = "join"
    idw_index: int = 2
    mlp_leaky_relu: bool = False
    use_mid_ts: bool = False
    # radius bound of the join probe: the reference's candidates are the
    # points stored in cells of the (num_nei_cells+alpha)-ball, i.e. at
    # distances up to ~(ball_r + sqrt(3)/2) cells
    join_max_dist2: float = 0.0

    @property
    def offsets_np(self) -> np.ndarray:
        return np.asarray(self.offsets, np.int32)


def _resolve_probe_mode(mode: str) -> str:
    """'auto' is the join probe: the port runs on the card, where the JAX
    package picks the join probe for its accelerator (off it the JAX
    package picks 'cells'; a stated departure). 'cells' and 'brick' are the
    hash-table probes."""
    if mode in ("auto", "join"):
        return "join"
    if mode in ("cells", "brick"):
        return mode
    raise ValueError(f"unknown probe_mode {mode!r}")


def make_query_params(config, after_pgo: bool = True) -> QueryParams:
    offs = hash3d.neighbor_offsets(config.num_nei_cells, config.search_alpha)
    ball_r = math.sqrt(hash3d.neighbor_offsets_max_r2(
        config.num_nei_cells, config.search_alpha))
    join_r = (ball_r + math.sqrt(3.0) / 2.0) * config.voxel_size_m
    max_d2 = hash3d.max_valid_dist2(config.num_nei_cells, config.voxel_size_m)
    return QueryParams(
        offsets=tuple(map(tuple, offs.tolist())),
        resolution=config.voxel_size_m,
        nn_k=config.query_nn_k,
        max_dist2=max_d2,
        sdf_scale=config.sdf_scale,
        weighted_first=config.weighted_first,
        after_pgo=after_pgo,
        layer_norm_on=config.layer_norm_on,
        probe_mode=_resolve_probe_mode(getattr(config, "probe_mode", "auto")),
        idw_index=config.idw_index,
        mlp_leaky_relu=config.mlp_leaky_relu,
        use_mid_ts=config.use_mid_ts,
        join_max_dist2=float(min(max_d2, join_r ** 2)),
    )


class LocalFilter(NamedTuple):
    """Arguments of the query-time local-map masking of the hash-table
    probes, and the per-frame sensor origins of the projective label
    correction."""

    travel_dist: torch.Tensor    # [maxT] f32
    cur_ts: object               # int or scalar tensor
    local_window_dist: float
    sensor_pos: Optional[torch.Tensor] = None  # [3] anchored frame
    local_map_radius: float = 0.0
    reboot_ts: object = 0
    # [maxT, 3] world sensor origins (proj_correction_on)
    sensor_origins: Optional[torch.Tensor] = None


class QueryOut(NamedTuple):
    sdf: torch.Tensor             # [N]
    sdf_std: Optional[torch.Tensor]
    nn_count: torch.Tensor        # [N]
    certainty: torch.Tensor       # [N]
    neighbors: npm.QueryNeighbors
    weights: torch.Tensor         # [N, k]
    color: Optional[torch.Tensor] = None         # [N, C]
    sem_log_prob: Optional[torch.Tensor] = None  # [N, S]


def _maybe_layer_norm(x, on: bool):
    if not on:
        return x
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5)


def rerank_candidates(cand: torch.Tensor, cvalid: torch.Tensor,
                      qp: QueryParams) -> npm.QueryNeighbors:
    """Exact top-nn_k from a cached candidate set: the k-NN emits
    candidates sorted ascending by distance and map positions do not move
    during a frame's training, so the top-nn_k are the first nn_k columns."""
    k = qp.nn_k
    return npm.QueryNeighbors(
        idx=cand[:, :k], dist2=torch.zeros(cand[:, :k].shape,
                                           device=cand.device),
        valid=cvalid[:, :k], nn_count=cvalid.sum(-1, dtype=torch.int32))


def pack_lset_rows(lset, geo_features: torch.Tensor) -> torch.Tensor:
    """Per-row [pts(3) | quat(4, when the set carries them) | feats(F)]."""
    parts = [lset.pts]
    if lset.quat is not None:
        parts.append(lset.quat)
    parts.append(geo_features)
    return torch.cat(parts, dim=1)


def pack_lset_nodiff(lset) -> torch.Tensor:
    """The non-differentiated row columns [pts(3) | quat(4, when present)]
    for gather_rows_splitgrad."""
    if lset.quat is not None:
        return torch.cat([lset.pts, lset.quat], dim=1)
    return lset.pts


class _GatherSplitGrad(torch.autograd.Function):
    """Forward: `cat([nodiff_cols, feats], -1)[idx]` split back into
    (nodiff rows, feature rows). Backward: scatter-adds ONLY the feature
    cotangent, in an order-free sum (`ops.scatter.index_add_exact`); the
    nodiff columns take no gradient."""

    @staticmethod
    def forward(ctx, nodiff_cols, feats, idx):
        nd = nodiff_cols.shape[-1]
        g = torch.cat([nodiff_cols, feats], dim=-1)[idx]
        ctx.save_for_backward(idx)
        ctx.fshape = feats.shape
        return g[..., :nd], g[..., nd:]

    @staticmethod
    def backward(ctx, ct_nd, ct_f):
        (idx,) = ctx.saved_tensors
        d_feats = None
        if ctx.needs_input_grad[1] and ct_f is not None:
            d_feats = index_add_exact(
                torch.zeros(ctx.fshape, dtype=ct_f.dtype, device=ct_f.device),
                idx.reshape(-1), ct_f.reshape(-1, ctx.fshape[-1]))
        return None, d_feats, None


def gather_rows_splitgrad(nodiff_cols: torch.Tensor, feats: torch.Tensor,
                          idx: torch.Tensor):
    """One packed row gather with a FEATURE-ONLY backward scatter."""
    return _GatherSplitGrad.apply(nodiff_cols, feats, idx)


class _GatherExact(torch.autograd.Function):
    """Forward: `feats[idx]`. Backward: the cotangent scatter-added back to
    the rows in an order-free sum (`ops.scatter.index_add_exact`), so
    repeated indices sum to the same bits on every run and a row only small
    cotangents reach keeps them (Adam steps on their sign): scaled per
    destination row, or with one scale where it keeps float32's bits and
    per destination elsewhere."""

    @staticmethod
    def forward(ctx, feats, idx, per_destination):
        ctx.save_for_backward(idx)
        ctx.fshape = feats.shape
        ctx.per_destination = per_destination
        return feats[idx]

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        d_feats = None
        if ctx.needs_input_grad[0]:
            d_feats = index_add_exact(
                torch.zeros(ctx.fshape, dtype=ct.dtype, device=ct.device),
                idx.reshape(-1), ct.reshape(-1, ctx.fshape[-1]),
                per_destination=ctx.per_destination)
        return d_feats, None, None


def gather_rows_exact(feats: torch.Tensor, idx: torch.Tensor,
                      per_destination: bool = True) -> torch.Tensor:
    """`feats[idx]` whose backward is order-free. Bundle adjustment
    differentiates the whole map's features through it with the scale of
    each destination; the training's colour features take the one scale,
    re-summing only the destinations it cannot resolve
    (`per_destination=False`)."""
    return _GatherExact.apply(feats, idx, per_destination)


def topk_select_mask(d2m: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k-smallest selection mask over the last axis with argmin
    first-index ties: rank_i = #candidates that beat i (strictly smaller,
    or equal at a lower index); selected = rank < k."""
    K = d2m.shape[-1]
    a = d2m[..., :, None]
    b = d2m[..., None, :]
    ii = torch.arange(K, device=d2m.device)
    beats = (b < a) | ((b == a) & (ii[None, :] < ii[:, None]))
    return beats.sum(-1) < k


def _idw_raw(d2: torch.Tensor, idw_index: int) -> torch.Tensor:
    if idw_index == 2:
        return 1.0 / (d2 + 1e-15)
    return 1.0 / (torch.sqrt(torch.clamp(d2, min=0.0)) ** idw_index + 1e-15)


def query_decode(
    geo_features: torch.Tensor,      # [L+1, F] compact with lset, else [C+1, F]
    geo_mlp,
    qpts: torch.Tensor,              # [N, 3] anchored world frame
    qp: QueryParams,
    *,
    lset=None,                       # ops.knn_join.LocalSet (spatial join)
    state: Optional[npm.MapState] = None,   # whole map (cell-table probe)
    anchor: Optional[torch.Tensor] = None,
    lf: Optional[LocalFilter] = None,
    with_std: bool = False,
    cand=None,                       # ([N, K] ids, [N, K] valid) cached
    cand_pack=None,                  # (nodiff cols, feature array)
    qperm: Optional[torch.Tensor] = None,   # Morton order of the queries
    fused: bool = False,
    color_features: Optional[torch.Tensor] = None,  # aligned as geo's
    color_mlp=None,
    sem_mlp=None,
    color_channel: int = 0,
) -> QueryOut:
    """k-NN neural points of `qpts`, then the SDF decode, and with
    `color_mlp` + `color_features` the colour head (its first
    max(color_channel, 1) outputs), with `sem_mlp` the semantic head
    (log-probabilities). Differentiable w.r.t. qpts, geo_features,
    color_features and the MLP params.

    With `lset` the neighbour search is the spatial join over the local set
    (its filters are baked into the set, `lf` is ignored) and
    `geo_features` is the COMPACT [L+1, F] array aligned with the set rows;
    with `cand` the k-NN is skipped and the cached candidates are re-ranked.
    Without `lset`, `state` is probed through its hash table, by the
    probe `qp.probe_mode` names (a "join" configuration keeps no brick
    cache, so it maps to the "cells" probe), positions, orientations and
    certainty come from the state, and `geo_features` is the full [C+1, F]
    array.

    `fused=True` is for forward-only callers: the `weighted_first=False`
    decode then runs in the fused kernel of `ops/fused_decode.py`, or the
    call raises (with `weighted_first=True`, with `with_std`, or with a
    decoder the kernel does not compute: it takes one hidden layer and a
    ReLU). The plain decode is never substituted for it. The colour and
    semantic heads are plain torch on either route: the colour head's
    sigmoid per neighbour and the semantic head's log-softmax are not the
    kernel's function."""
    if fused and (qp.weighted_first or with_std):
        raise ValueError(
            "query_decode: fused=True is the weighted_first=False decode "
            "without the std; got weighted_first="
            f"{qp.weighted_first}, with_std={with_std}")
    q_abs = qpts if anchor is None else qpts + anchor
    if cand is not None:
        qn = rerank_candidates(cand[0], cand[1], qp)
    elif lset is not None:
        qn = npm.query_neighbors_join(
            q_abs, lset, nn_k=qp.nn_k, max_dist2=qp.join_max_dist2,
            resolution=qp.resolution, local_ids=True, qperm=qperm)
    elif state is not None:
        kwargs = {}
        if lf is not None:
            kwargs = dict(
                time_filter=True, travel_dist=lf.travel_dist,
                cur_ts=lf.cur_ts, local_window_dist=lf.local_window_dist,
                reboot_ts=lf.reboot_ts, use_mid_ts=qp.use_mid_ts)
            if lf.sensor_pos is not None:
                kwargs.update(
                    radius_filter=True,
                    sensor_pos=(lf.sensor_pos if anchor is None
                                else lf.sensor_pos + anchor),
                    local_map_radius=lf.local_map_radius)
        probe = "cells" if qp.probe_mode == "join" else qp.probe_mode
        qn = npm.query_neighbors(
            state, q_abs, offsets=qp.offsets_np, resolution=qp.resolution,
            nn_k=qp.nn_k, max_dist2=qp.max_dist2, probe_mode=probe, **kwargs)
    else:
        raise ValueError("query_decode needs a local set or a map state")

    quat_src = lset.quat if lset is not None else state.orientations
    quat_g = None
    if cand_pack is not None:
        nd_g, feats_raw = gather_rows_splitgrad(cand_pack[0], cand_pack[1],
                                                qn.idx)
        pos = nd_g[..., :3].detach()
        if quat_src is not None:
            quat_g = nd_g[..., 3:7].detach()
    else:
        pos = (lset.pts if lset is not None else state.positions)[qn.idx]
        if quat_src is not None:
            quat_g = quat_src[qn.idx]
        feats_raw = gather_rows_exact(geo_features, qn.idx)
    pos_a = pos if anchor is None else pos - anchor
    diff = qpts[:, None, :] - pos_a                      # [N, k, 3]
    dist2 = torch.sum(diff * diff, dim=-1)
    dist2 = torch.where(qn.valid, dist2,
                        torch.full_like(dist2, npm.BIG_DIST2))
    qn = npm.QueryNeighbors(idx=qn.idx, dist2=dist2, valid=qn.valid,
                            nn_count=qn.nn_count)
    w = npm.idw_weights(qn, idw_index=qp.idw_index)

    vec = diff
    if qp.after_pgo and quat_g is not None:
        vec = quat_rotate(quat_g, vec)
    vec = torch.where(qn.valid[..., None], vec, torch.zeros_like(vec))
    feats = _maybe_layer_norm(feats_raw, qp.layer_norm_on)
    geo_vec = torch.cat([feats, vec], dim=-1)            # [N, k, F+3]

    cert_src = lset.cert if lset is not None else state.certainty
    if cert_src is not None:
        cert = torch.where(qn.valid, cert_src[qn.idx],
                           torch.zeros_like(dist2))
    else:
        cert = torch.zeros_like(dist2)
    certainty = torch.sum(cert * w, dim=1)

    if qp.weighted_first:
        wsum = torch.sum(geo_vec * w[..., None], dim=1)   # [N, F+3]
        sdf = sdf_apply(geo_mlp, wsum, qp.sdf_scale, qp.mlp_leaky_relu)
        std = torch.zeros_like(sdf) if with_std else None
    elif fused:
        sdf = fused_decode.decode_weighted_sdf_mlp(
            geo_vec, w, geo_mlp, qp.sdf_scale, qp.mlp_leaky_relu)
        std = None
    else:
        per = sdf_apply(geo_mlp, geo_vec, qp.sdf_scale, qp.mlp_leaky_relu)
        sdf, std = weighted_reduce(per, w, with_std=with_std)

    leaky = qp.mlp_leaky_relu
    sem_log_prob = color = None
    if sem_mlp is not None:
        if qp.weighted_first:
            sem_log_prob = sem_log_prob_apply(sem_mlp, wsum, leaky)
        else:
            sem_log_prob, _ = weighted_reduce(
                sem_log_prob_apply(sem_mlp, geo_vec, leaky), w)
    if color_mlp is not None and color_features is not None:
        cfeats = _maybe_layer_norm(
            gather_rows_exact(color_features, qn.idx, per_destination=False),
            qp.layer_norm_on)
        color_vec = torch.cat([cfeats, vec], dim=-1)
        if qp.weighted_first:
            color = color_apply(
                color_mlp, torch.sum(color_vec * w[..., None], dim=1), leaky)
        else:
            color, _ = weighted_reduce(
                color_apply(color_mlp, color_vec, leaky), w)
        color = color[:, :max(color_channel, 1)]
    return QueryOut(sdf=sdf, sdf_std=std, nn_count=qn.nn_count,
                    certainty=certainty, neighbors=qn, weights=w,
                    color=color, sem_log_prob=sem_log_prob)


def query_sdf_and_grad(geo_features, geo_mlp, qpts: torch.Tensor,
                       qp: QueryParams, **kwargs):
    """SDF + analytical spatial gradient at qpts through autograd. Returns
    (sdf, grad [N, 3], aux QueryOut)."""
    with torch.enable_grad():
        p = qpts.detach().requires_grad_(True)
        out = query_decode(geo_features, geo_mlp, p, qp, **kwargs)
        (grad,) = torch.autograd.grad(out.sdf.sum(), p)
    return out.sdf.detach(), grad, out


def _shifts6(eps: float, like: torch.Tensor) -> torch.Tensor:
    return npm.device_constant(
        np.array([[eps, 0, 0], [-eps, 0, 0], [0, eps, 0],
                  [0, -eps, 0], [0, 0, eps], [0, 0, -eps]], np.float64),
        like.dtype, like.device)


def _central_diff(s: torch.Tensor, eps: float) -> torch.Tensor:
    """[6, M] SDF at the +-eps shifts -> gradient [M, 3]."""
    return torch.stack([(s[0] - s[1]) / (2 * eps), (s[2] - s[3]) / (2 * eps),
                        (s[4] - s[5]) / (2 * eps)], dim=-1)


def numerical_grad_from_neighbors(
    state: npm.MapState,
    geo_features: torch.Tensor,   # [C+1, F]
    geo_mlp,
    qpts: torch.Tensor,           # [M, 3] base (decimated) points
    qn: npm.QueryNeighbors,       # their neighbors from the main query
    eps: float,
    qp: QueryParams,
):
    """Two-sided numerical SDF gradient reusing the base points' neighbor
    sets for the +-eps shifted queries (eps << voxel size, so the k-NN set
    is unchanged). Weights and offsets are recomputed per shifted position.
    Returns grad [M, 3]."""
    m = qpts.shape[0]
    k = qn.idx.shape[1]
    pos = state.positions[qn.idx]                     # [M, k, 3]
    feats = _maybe_layer_norm(gather_rows_exact(geo_features, qn.idx),
                              qp.layer_norm_on)
    q6 = qpts[None, :, :] + _shifts6(eps, qpts)[:, None, :]   # [6, M, 3]
    diff = q6[:, :, None, :] - pos[None]              # [6, M, k, 3]
    d2 = torch.sum(diff * diff, dim=-1)
    valid = qn.valid[None] & (d2 <= qp.join_max_dist2)
    d2 = torch.where(valid, d2, torch.full_like(d2, npm.BIG_DIST2))
    w = torch.where(valid, _idw_raw(d2, qp.idw_index), torch.zeros_like(d2))
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-15)
    vec = torch.where(valid[..., None], diff, torch.zeros_like(diff))
    gv = torch.cat([feats[None].expand(6, m, k, feats.shape[-1]), vec],
                   dim=-1)
    if qp.weighted_first:
        wsum = torch.sum(gv * w[..., None], dim=2)    # [6, M, F+3]
        s = sdf_apply(geo_mlp, wsum, qp.sdf_scale, qp.mlp_leaky_relu)
    else:
        per = sdf_apply(geo_mlp, gv, qp.sdf_scale, qp.mlp_leaky_relu)
        s = torch.sum(per * w, dim=-1)
    return _central_diff(s, eps)


def query_sdf_numerical_grad(geo_features, geo_mlp, qpts: torch.Tensor,
                             eps: float, qp: QueryParams, **kwargs):
    """Two-sided numerical SDF gradient from six full queries.
    Differentiable w.r.t. features/params, so it can drive the eikonal
    loss. Returns grad [M, 3]."""
    m = qpts.shape[0]
    pts6 = (qpts[None, :, :] + _shifts6(eps, qpts)[:, None, :]).reshape(-1, 3)
    out = query_decode(geo_features, geo_mlp, pts6, qp, **kwargs)
    return _central_diff(out.sdf.reshape(6, m), eps)


def _unpack_rows(g: torch.Tensor, has_quat: bool):
    """Split a pack_lset_rows gather -> (pos, quat, feats); pos/quat take
    no gradient (map geometry is not trained)."""
    pos = g[..., :3].detach()
    if has_quat:
        return pos, g[..., 3:7].detach(), g[..., 7:]
    return pos, None, g[..., 3:]


def decode_sdf_candidates(
    lset,
    geo_mlp,
    qpts_abs: torch.Tensor,      # [N, 3] absolute world
    cand: torch.Tensor,          # [N, K] local candidate ids
    cvalid: torch.Tensor,        # [N, K]
    qp: QueryParams,
    rows: torch.Tensor,          # [N, K, 3(+4)+F] pack_lset_rows[cand]
    with_std: bool = False,
):
    """SDF decode from a CACHED candidate set with exact top-nn_k re-ranking
    by true distance. The candidate rows are gathered once per probe by the
    caller (they do not change while only the pose moves). Differentiable
    w.r.t. qpts_abs. Returns (sdf [N], nn_count [N], std or None)."""
    pos, quat_g, feats_raw = _unpack_rows(rows, lset.quat is not None)
    diff = qpts_abs[:, None, :] - pos
    d2 = torch.sum(diff * diff, dim=-1)
    use = cvalid & (d2 <= qp.join_max_dist2)
    d2m = torch.where(use, d2, torch.full_like(d2, npm.BIG_DIST2))
    nn_count = use.sum(-1, dtype=torch.int32)
    use = use & topk_select_mask(d2m.detach(), qp.nn_k)

    w = torch.where(use, _idw_raw(d2, qp.idw_index), torch.zeros_like(d2))
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-15)
    vec = torch.where(use[..., None], diff, torch.zeros_like(diff))
    if qp.after_pgo and quat_g is not None:
        vec = quat_rotate(quat_g, vec)
        vec = torch.where(use[..., None], vec, torch.zeros_like(vec))
    feats = _maybe_layer_norm(feats_raw, qp.layer_norm_on)
    gv = torch.cat([feats, vec], dim=-1)
    if qp.weighted_first:
        fused = torch.sum(gv * w[..., None], dim=1)
        return (sdf_apply(geo_mlp, fused, qp.sdf_scale, qp.mlp_leaky_relu),
                nn_count, None)
    per = sdf_apply(geo_mlp, gv, qp.sdf_scale, qp.mlp_leaky_relu)
    sdf, std = weighted_reduce(per, w, with_std=with_std)
    return sdf, nn_count, std


def numerical_grad_shared_join(
    lset,
    geo_features: torch.Tensor,  # [L+1, F] compact
    geo_mlp,
    qpts: torch.Tensor,          # [M, 3] decimated base points
    eps: float,
    qp: QueryParams,
    cand_k: int = 12,
    cand=None,                   # optional cached ([M, K] ids, [M, K] valid)
    cand_pack=None,              # (nodiff cols, feature array)
):
    """Two-sided numerical SDF gradient sharing ONE candidate k-NN across
    the six +-eps shifted queries, each re-ranked to its exact top-nn_k.
    Returns grad [M, 3]; differentiable w.r.t. geo_features/geo_mlp."""
    m = qpts.shape[0]
    if cand is not None:
        cand_k = cand[0].shape[1]
        qn = npm.QueryNeighbors(
            idx=torch.where(cand[1], cand[0],
                            torch.full_like(cand[0], lset.cap)),
            dist2=torch.zeros(cand[0].shape, device=qpts.device),
            valid=cand[1], nn_count=cand[1].sum(-1, dtype=torch.int32))
    else:
        qn = npm.query_neighbors_join(
            qpts.detach(), lset, nn_k=cand_k, max_dist2=qp.join_max_dist2,
            resolution=qp.resolution, local_ids=True)
    quat_g = None
    if cand_pack is not None:
        nd_g, feats_raw = gather_rows_splitgrad(cand_pack[0], cand_pack[1],
                                                qn.idx)
        pos = nd_g[..., :3].detach()
        if lset.quat is not None:
            quat_g = nd_g[..., 3:7].detach()
    else:
        pos = lset.pts[qn.idx]
        feats_raw = geo_features[qn.idx]
        if lset.quat is not None:
            quat_g = lset.quat[qn.idx]
    feats = _maybe_layer_norm(feats_raw, qp.layer_norm_on)

    q6 = qpts[None, :, :] + _shifts6(eps, qpts)[:, None, :]   # [6, M, 3]
    diff = q6[:, :, None, :] - pos[None]                # [6, M, K, 3]
    d2 = torch.sum(diff * diff, dim=-1)
    valid = qn.valid[None] & (d2 <= qp.join_max_dist2)
    d2m = torch.where(valid, d2, torch.full_like(d2, npm.BIG_DIST2))
    use = valid & topk_select_mask(d2m.detach(), qp.nn_k)
    w = torch.where(use, _idw_raw(d2, qp.idw_index), torch.zeros_like(d2))
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-15)
    vec = torch.where(use[..., None], diff, torch.zeros_like(diff))
    if qp.after_pgo and quat_g is not None:
        vec = quat_rotate(quat_g[None], vec)
        vec = torch.where(use[..., None], vec, torch.zeros_like(vec))
    gv = torch.cat([feats[None].expand(6, m, cand_k, feats.shape[-1]), vec],
                   dim=-1)
    if qp.weighted_first:
        fused = torch.sum(gv * w[..., None], dim=2)     # [6, M, F+3]
        s = sdf_apply(geo_mlp, fused, qp.sdf_scale, qp.mlp_leaky_relu)
    else:
        per = sdf_apply(geo_mlp, gv, qp.sdf_scale, qp.mlp_leaky_relu)
        s = torch.sum(per * w, dim=-1)
    return _central_diff(s, eps)
