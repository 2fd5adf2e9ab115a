"""Online mapping: replay pool + per-frame training of the neural map.
Port of `pin_slam_tpu/slam/mapper.py` (one device), with the colour and
semantic terms, the gradient-consistency term and the projective label
correction.

* The replay pool is a fixed-capacity RING of sample tensors; a frame's
  samples land as one contiguous block and the ring wrap overwrites the
  oldest blocks. The window filter marks out-of-window samples dead
  (weight = 0) instead of compacting.
* With a local set (the join probe) each frame trains on COMPACT local
  features: the rows of the map that the frame's local set holds are
  gathered once, trained with a fresh Adam (the reference creates a new
  optimizer per mapping call), and scattered back once. Every iteration's
  neighbor candidates come from ONE batched k-NN probe: map positions do
  not move during a frame's training.
* Without one (`probe_mode` cells or brick) each iteration queries the
  whole map state through its hash table under the travel window, a fresh
  Adam steps the whole [C+1, F] feature array, and each iteration adds its
  certainty to the map.
* Colour features train beside the geometry features, and the colour and
  semantic decoders beside the SDF decoder; all three decoders freeze
  together (`train_decoder=False`).
* On the card, one replica's whole-map route replays the loss, gradient
  and certainty of its iterations 2..n from a CUDA graph of one
  iteration, captured once per map shape (`_WholeMapGraph`, the last
  shape's kept across iteration counts); Adam steps eagerly after each.
  Iteration 1 of every frame runs eagerly, as on the other routes; the
  graph reads only buffers it owns, refreshed by device copies before a
  frame's replays, with the frame id and the reboot frame as device
  scalars. The join route, the data-parallel replicas and the CPU run
  every iteration eagerly.
* A training run's spans (`utils/tracing.py`): `mapper.setup` (draws,
  copies, Adam), one `mapper.iter` per iteration holding `mapper.loss`,
  `mapper.backward`, `mapper.step` and `mapper.certainty` (an eager
  iteration; the captured route takes the certainty before the step), or
  `mapper.replay` (a replayed one, after `mapper.capture` where the graph
  is captured) and `mapper.step`, then `mapper.writeback`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from pin_slam_tpu_torch.models import losses as L
from pin_slam_tpu_torch.models import neural_points as npm
from pin_slam_tpu_torch.ops import hash3d
from pin_slam_tpu_torch.ops.scatter import index_add_exact
from pin_slam_tpu_torch.ops.voxel import compact_rows
from pin_slam_tpu_torch.parallel import dp
from pin_slam_tpu_torch.slam import map_query as mq
from pin_slam_tpu_torch.utils import tracing

PROBE_CHUNK = 196608   # queries per k-NN call in the training probe


@dataclass
class PoolState:
    """Replay pool; row `capacity` is the dump row."""

    coord: torch.Tensor        # [P+1, 3] world-frame sample coords
    sdf_label: torch.Tensor    # [P+1]
    weight: torch.Tensor       # [P+1] signed weight
    ts: torch.Tensor           # [P+1] i32 frame id
    count: torch.Tensor        # [] high-water mark of written rows
    new_idx: torch.Tensor      # [NEW_CAP+1] pool rows of the frame's new
    new_count: torch.Tensor    # [] samples, and their count
    write_pos: torch.Tensor    # [] ring position of the next append
    sem_label: Optional[torch.Tensor] = None    # [P+1] i32 (semantic_on)
    color_label: Optional[torch.Tensor] = None  # [P+1, Cc] (color_on)

    @property
    def capacity(self) -> int:
        return self.coord.shape[0] - 1

    def replace(self, **kw) -> "PoolState":
        return replace(self, **kw)


def init_pool(capacity: int, new_cap: int, semantic_on: bool = False,
              color_channel: int = 0, device=None) -> PoolState:
    p1 = capacity + 1
    z = dict(dtype=torch.int64, device=device)
    return PoolState(
        sem_label=torch.zeros(p1, dtype=torch.int32, device=device)
        if semantic_on else None,
        color_label=torch.zeros((p1, color_channel), device=device)
        if color_channel > 0 else None,
        coord=torch.zeros((p1, 3), device=device),
        sdf_label=torch.zeros(p1, device=device),
        weight=torch.zeros(p1, device=device),
        ts=torch.zeros(p1, dtype=torch.int32, device=device),
        count=torch.zeros((), **z),
        new_idx=torch.zeros(new_cap + 1, **z),
        new_count=torch.zeros((), **z),
        write_pos=torch.zeros((), **z),
    )


def append_start(pool: PoolState, block_size: int) -> torch.Tensor:
    """Row where `append_samples` places a block of `block_size`: the ring
    position, wrapped to 0 when the block would overrun."""
    return torch.where(pool.write_pos + block_size <= pool.capacity,
                       pool.write_pos, torch.zeros_like(pool.write_pos))


def append_samples(pool: PoolState, coord, sdf_label, weight, mask,
                   cur_ts, sem_label=None, color_label=None) -> PoolState:
    """Append this frame's samples as one contiguous block (in place).
    Masked-out rows are stored as DEAD rows with weight 0. The labels are
    stored where the pool keeps them."""
    P = pool.capacity
    S = coord.shape[0]
    dev = coord.device
    idxs = torch.arange(S, device=dev)
    n_rows = torch.where(mask, idxs + 1, torch.zeros_like(idxs)).max()
    start = append_start(pool, S)
    rows = start + idxs
    pool.coord.index_copy_(0, rows, coord)
    pool.sdf_label.index_copy_(0, rows, sdf_label)
    pool.weight.index_copy_(0, rows, torch.where(mask, weight,
                                                 torch.zeros_like(weight)))
    pool.ts.index_copy_(0, rows, torch.as_tensor(
        cur_ts, dtype=torch.int32, device=dev).expand(S))
    if sem_label is not None and pool.sem_label is not None:
        pool.sem_label.index_copy_(0, rows, sem_label.to(torch.int32))
    if color_label is not None and pool.color_label is not None:
        pool.color_label.index_copy_(0, rows, color_label)
    grown = n_rows > 0
    pool.count = torch.where(
        grown, torch.maximum(pool.count, torch.clamp(start + n_rows, max=P)),
        pool.count)
    pool.write_pos = torch.where(grown, start + S, pool.write_pos)
    return pool


def filter_pool(pool: PoolState, origin: torch.Tensor,
                window_radius: float) -> PoolState:
    """Window filter: mark samples outside the radius dead (weight = 0)."""
    d2 = torch.sum((pool.coord - origin) ** 2, dim=-1)
    pool.weight.copy_(torch.where(d2 < window_radius * window_radius,
                                  pool.weight,
                                  torch.zeros_like(pool.weight)))
    return pool


def compact_near_surface(frame_coord, frame_sdf, frame_mask, *,
                         surface_sample_range_m: float, cap: int):
    """Uniformly thin + compact the near-surface samples (|sdf| < 3x surface
    range) to a `cap`-row buffer (stride-uniform, never a prefix cut).
    Returns (kidx [cap] original rows, kvalid, kpts, ksdf)."""
    S = frame_coord.shape[0]
    near = frame_mask & (torch.abs(frame_sdf) < surface_sample_range_m * 3.0)
    order = torch.cumsum(near.to(torch.int64), 0) - 1
    total = torch.clamp(order[-1] + 1, min=1)
    stride = torch.div(total + cap - 1, cap, rounding_mode="floor")
    keep = near & (torch.remainder(order, stride) == 0)
    kidx = compact_rows(keep, cap, S)
    kvalid = kidx < S
    ki = torch.where(kvalid, kidx, torch.zeros_like(kidx))
    return ki, kvalid, frame_coord[ki], frame_sdf[ki]


def detect_new_samples_compact(state: npm.MapState, pool: PoolState, kpts,
                               kvalid, pool_pos, *, resolution: float,
                               new_certainty_thre: float) -> PoolState:
    """Mark low-certainty samples as "new" (center-voxel certainty probe)."""
    C = state.capacity
    B = state.table_size
    h = hash3d.hash_grid(hash3d.grid_coords(kpts, resolution), B)
    idx = state.table[torch.where(kvalid, h, torch.full_like(h, B))]
    valid = idx >= 0
    idx_c = torch.where(valid, idx, torch.full_like(idx, C))
    d2 = torch.sum((state.positions[idx_c] - kpts) ** 2, dim=-1)
    valid = valid & (d2 <= hash3d.max_valid_dist2(1, resolution))
    cert = torch.where(valid, state.certainty[idx_c], torch.zeros_like(d2))
    is_new = kvalid & (cert < new_certainty_thre)
    new_cap = pool.new_idx.shape[0] - 1
    order = torch.cumsum(is_new.to(torch.int64), 0) - 1
    ok = is_new & (order < new_cap)
    dest = torch.where(ok, order, torch.full_like(order, new_cap))
    new_idx = torch.zeros_like(pool.new_idx)
    new_idx[dest] = torch.where(ok, pool_pos, torch.zeros_like(pool_pos))
    new_idx[new_cap] = 0
    return pool.replace(new_idx=new_idx, new_count=ok.sum())


def mapping_loss(geo_features, geo_mlp, batch: dict, mask, cand, cvalid,
                 lset, qp: mq.QueryParams, *, sigma_sigmoid_m: float,
                 loss_weight_on: bool, ekional_loss_on: bool,
                 weight_e: float, numerical_grad_eps: float,
                 gradient_decimation: int, main_loss_type: str = "bce",
                 surface_sample_range_m: float = 0.25,
                 semantic_on: bool = False, weight_s: float = 1.0,
                 freespace_label_on: bool = False,
                 sem_label_decimation: int = 1, color_on: bool = False,
                 weight_i: float = 1.0, color_channel: int = 0,
                 color_features=None, color_mlp=None, sem_mlp=None,
                 state: Optional[npm.MapState] = None,
                 lf: Optional[mq.LocalFilter] = None,
                 eik_shared_neighbors: bool = False,
                 proj_correction_on: bool = False,
                 consistency_loss_on: bool = False, weight_c: float = 0.5,
                 consistency_count: int = 1000,
                 consistency_range: float = 0.05, cons_u=None):
    """One training batch's loss: the SDF loss, the eikonal term, and with
    `semantic_on` the NLL of the labelled samples (label > 0, or >= 0 with
    `freespace_label_on`), with `color_on` the L1 colour loss of the
    surface samples, with `consistency_loss_on` the gradient-consistency
    term (1 - cos between the numerical SDF gradients at the first
    min(consistency_count, bs) samples and at those samples shifted by
    (2 `cons_u` - 1) * consistency_range, `cons_u` [m, 3] uniforms), and
    with `proj_correction_on` the projective labels scaled by |cos| between
    the learned numerical gradient and the sample's ray from
    `lf.sensor_origins`.

    With `lset` the features are the compact [L+1, F] arrays aligned with
    the set and `cand`/`cvalid` its cached candidates (the join route);
    with `lset=None` they are the map's [C+1, F] arrays and every query
    probes `state` under `lf` (the state route), the eikonal term through
    six shifted queries, or through the base query's neighbors with
    `eik_shared_neighbors`. Returns (loss, aux) with aux carrying the
    certainty-update neighbor info."""
    coord = batch["coord"]
    sdf_label = batch["sdf_label"]
    weight = torch.abs(batch["weight"])
    mask = mask & (weight > 0.0)    # weight == 0 marks dead pool rows
    eps = numerical_grad_eps
    heads = dict(color_features=color_features,
                 color_mlp=color_mlp if color_on else None,
                 sem_mlp=sem_mlp if semantic_on else None,
                 color_channel=color_channel)
    # the probe of every further query of this batch
    where = dict(lset=lset) if lset is not None else dict(state=state, lf=lf)

    cand_pack = None
    if lset is not None:
        cand_pack = (mq.pack_lset_nodiff(lset), geo_features)
        out = mq.query_decode(geo_features, geo_mlp, coord, qp, lset=lset,
                              cand=(cand, cvalid), cand_pack=cand_pack,
                              **heads)
    else:
        out = mq.query_decode(geo_features, geo_mlp, coord, qp, state=state,
                              lf=lf, **heads)
    if proj_correction_on and lf is not None \
            and lf.sensor_origins is not None:
        g_all = mq.query_sdf_numerical_grad(geo_features, geo_mlp, coord,
                                            eps, qp, **where)
        origins = lf.sensor_origins
        ray = coord - origins[torch.clamp(batch["ts"].long(), 0,
                                          origins.shape[0] - 1)]
        cos = torch.abs(torch.sum(g_all * ray, -1)) / (
            torch.linalg.norm(g_all, dim=-1) * torch.linalg.norm(ray, dim=-1)
            + 1e-12)
        sdf_label = sdf_label * cos
    if main_loss_type == "bce":
        sdf_loss = L.sdf_bce_loss(out.sdf, sdf_label, sigma_sigmoid_m,
                                  weight, mask, weighted=loss_weight_on)
    elif main_loss_type == "zhong":
        sdf_loss = L.sdf_zhong_loss(out.sdf, sdf_label, None, weight, mask,
                                    weighted=loss_weight_on)
    elif main_loss_type == "sdf_l1":
        sdf_loss = L.sdf_diff_loss(out.sdf, sdf_label, weight, mask, l2=False)
    else:
        sdf_loss = L.sdf_diff_loss(out.sdf, sdf_label, weight, mask, l2=True)
    total = sdf_loss
    eik_loss = torch.zeros((), device=coord.device)
    if ekional_loss_on and weight_e > 0:
        d = gradient_decimation
        if eik_shared_neighbors:
            # the base query's neighbors serve the shifted queries (an
            # approximation the JAX package keeps off by default)
            qn = out.neighbors
            g = mq.numerical_grad_from_neighbors(
                state, geo_features, geo_mlp, coord[::d],
                npm.QueryNeighbors(idx=qn.idx[::d], dist2=qn.dist2[::d],
                                   valid=qn.valid[::d],
                                   nn_count=qn.nn_count[::d]), eps, qp)
        elif lset is not None:
            g = mq.numerical_grad_shared_join(
                lset, geo_features, geo_mlp, coord[::d], eps, qp,
                cand=(cand[::d], cvalid[::d]), cand_pack=cand_pack)
        else:
            g = mq.query_sdf_numerical_grad(geo_features, geo_mlp,
                                            coord[::d], eps, qp, state=state,
                                            lf=lf)
        eik_loss = L.eikonal_loss(g, mask[::d])
        total = total + weight_e * eik_loss
    if consistency_loss_on:
        if cons_u is None:
            raise ValueError("mapping_loss: consistency_loss_on needs the "
                             "shift draws cons_u")
        m = min(consistency_count, coord.shape[0])
        base = coord[:m]
        shift = (cons_u * 2.0 - 1.0) * consistency_range
        g_base = mq.query_sdf_numerical_grad(geo_features, geo_mlp, base,
                                             eps, qp, **where)
        g_near = mq.query_sdf_numerical_grad(geo_features, geo_mlp,
                                             base + shift, eps, qp, **where)
        cos = torch.sum(g_base * g_near, -1) / (
            torch.linalg.norm(g_base, dim=-1)
            * torch.linalg.norm(g_near, dim=-1) + 1e-12)
        mm = mask[:m]
        cons = (torch.where(mm, 1.0 - cos, torch.zeros_like(cos)).sum()
                / torch.clamp(mm.sum().to(torch.float32), min=1.0))
        total = total + weight_c * cons
    else:
        cons = torch.zeros((), device=coord.device)
    zero = torch.zeros((), device=coord.device)
    sem_loss = color_loss = zero
    if semantic_on and out.sem_log_prob is not None:
        sem_label = batch["sem_label"]
        labeled = sem_label >= 0 if freespace_label_on else sem_label > 0
        d = sem_label_decimation
        sem_loss = L.sem_nll_loss(out.sem_log_prob[::d], sem_label[::d],
                                  (mask & labeled)[::d])
        total = total + weight_s * sem_loss
    if color_on and out.color is not None:
        surface = torch.abs(sdf_label) < surface_sample_range_m
        color_loss = L.color_l1_loss(out.color, batch["color_label"],
                                     weight, mask & surface,
                                     weighted=loss_weight_on)
        total = total + weight_i * color_loss
    aux = {"qn": out.neighbors, "w": out.weights, "ts": batch["ts"],
           "sdf_loss": sdf_loss, "eikonal_loss": eik_loss,
           "sem_loss": sem_loss, "color_loss": color_loss,
           "consistency_loss": cons}
    return total, aux


def accumulate_certainty_sorted(cert, ts_upd, idx, w, ts, cap: int):
    """Apply many (neighbor id, weight, ts) contributions at once: certainty
    sums and last-update maxima per local row (out of place; dump row
    `cap` reset). The JAX package sorts and segment-sums because a TPU
    scatter is slow; on the GPU one scatter-add and one amax scatter do it.
    The sums are order-free (`ops.scatter.index_add_exact`), so they are
    the same from run to run."""
    cert = index_add_exact(cert, idx, w)
    cert[cap] = 0.0
    ts_upd = ts_upd.clone().scatter_reduce_(0, idx, ts.to(ts_upd.dtype),
                                            reduce="amax")
    ts_upd[cap] = 0
    return cert, ts_upd


def accumulate_certainty_local(cert, ts_upd, aux, cap: int):
    """Certainty/ts side effects of one iteration against COMPACT local
    tensors (dump row `cap`)."""
    qn = aux["qn"]
    idx = torch.where(qn.valid, qn.idx, torch.full_like(qn.idx, cap))
    tsb = aux["ts"][:, None].expand(qn.idx.shape)
    return accumulate_certainty_sorted(
        cert, ts_upd, idx.reshape(-1),
        torch.where(qn.valid, aux["w"], torch.zeros_like(aux["w"])).reshape(-1),
        torch.where(qn.valid, tsb, torch.zeros_like(tsb)).reshape(-1), cap)


def _randint(generator, n: int, high: torch.Tensor, device) -> torch.Tensor:
    """n uniform integers in [0, max(high, 1)) with a device-side bound (no
    host sync): float64 uniforms scaled and floored."""
    hi = torch.clamp(high, min=1).to(torch.float64)
    u = torch.rand(n, generator=generator, dtype=torch.float64,
                   device=device)
    return torch.minimum(torch.floor(u * hi).to(torch.int64),
                         hi.to(torch.int64) - 1)


def draw_train_indices(generator, pool: PoolState, *, n_iters: int, bs: int,
                       bs_new: int, subset_hist: int, whole_map: bool = False,
                       cons_m: int = 0):
    """All random draws of one `make_train_loop` run: the history indices
    ([S_h] for the subset path of a local set, [n_iters, bs] otherwise),
    the new-sample slots [n_iters, bs_new] into pool.new_idx and, with
    `cons_m` > 0, the consistency term's uniform shifts [n_iters, cons_m,
    3]."""
    dev = pool.coord.device
    if n_iters <= 32 and subset_hist >= bs and not whole_map:
        S_h = max(bs, min(subset_hist, n_iters * bs))
        hist = _randint(generator, S_h, pool.count, dev)
    else:
        hist = _randint(generator, n_iters * bs, pool.count,
                        dev).reshape(n_iters, bs)
    new_sel = _randint(generator, n_iters * bs_new, pool.new_count,
                       dev).reshape(n_iters, bs_new)
    draws = {"hist": hist, "new_sel": new_sel}
    if cons_m > 0:
        draws["cons_u"] = torch.rand((n_iters, cons_m, 3),
                                     generator=generator, device=dev)
    return draws


def whole_map_rows(pool: PoolState, draws: dict, slot: torch.Tensor,
                   bs: int, bs_new: int) -> torch.Tensor:
    """[n_iters, bs] pool rows of each iteration of the whole-map route:
    the history draws, with the tail's `slot`s taken by the frame's new
    samples."""
    hist = draws["hist"]
    if bs_new == 0:
        return hist
    tail = torch.where(slot[None], pool.new_idx[draws["new_sel"]],
                       hist[:, :bs_new])
    return torch.cat([hist[:, :bs - bs_new], tail], dim=1)


def _replays(dev: torch.device) -> bool:
    """Whether one replica's whole-map route trains over a
    `_WholeMapGraph`: on the card, where it is captured and replayed. (A
    function, so that the CPU tests can send the route through the graph's
    buffers, which then call the iteration eagerly.)"""
    return dev.type == "cuda"


class _WholeMapGraph:
    """One whole-map training iteration's loss, gradient and certainty
    over tensors it owns: copies of the map rows a query reads and the
    certainty writes, the trained leaves, a batch of packed pool rows and
    its mask, and a travel-window filter whose frame id and reboot frame
    are device scalars. `load` refreshes them from a frame's map,
    parameters and filter by device copies. On the card the iteration is
    captured once as a CUDA graph (`capture`) and replayed; elsewhere
    `run` calls it eagerly. Adam's step stays outside: the optimizer's own
    step bakes each step's bias corrections into its kernels as host
    numbers, and its capturable form computes them in float32, where 1 -
    0.999 keeps four digits (every first step 6.4e-6 short)."""

    def __init__(self, state: npm.MapState, params: dict,
                 lf: mq.LocalFilter, *, qp: mq.QueryParams, loss_kwargs: dict,
                 unpack, train_decoder: bool, bs: int, n_cols: int,
                 cons_m: int):
        dev = state.positions.device
        e = torch.empty_like
        self.qp, self.loss_kwargs, self.unpack = qp, loss_kwargs, unpack
        with torch.no_grad():
            self.feat = e(params["geo_features"]).requires_grad_(True)
            self.cfeat = None
            if loss_kwargs.get("color_on", False) \
                    and params.get("color_features") is not None:
                self.cfeat = e(params["color_features"]).requires_grad_(True)
            self.mlps = {
                name: {k: [e(t).requires_grad_(train_decoder)
                           for t in params[name][k]] for k in ("w", "b")}
                for name in ("geo_mlp", "color_mlp", "sem_mlp")
                if params.get(name) is not None}
            brick = qp.probe_mode == "brick"
            self.state = npm.MapState(
                positions=e(state.positions),
                orientations=e(state.orientations),
                geo_features=self.feat.detach(), ts_create=e(state.ts_create),
                ts_update=e(state.ts_update), certainty=e(state.certainty),
                count=e(state.count), table=e(state.table),
                btable=e(state.btable) if brick else None)
            self.lf = lf._replace(
                travel_dist=e(lf.travel_dist),
                cur_ts=torch.zeros((), dtype=torch.int64, device=dev),
                reboot_ts=torch.zeros((), dtype=torch.int64, device=dev),
                sensor_pos=None if lf.sensor_pos is None
                else e(lf.sensor_pos),
                sensor_origins=None if lf.sensor_origins is None
                else e(lf.sensor_origins))
            self.packed = torch.zeros((bs, n_cols), device=dev)
            self.mask = torch.zeros(bs, dtype=torch.bool, device=dev)
            self.cons_u = (torch.zeros((cons_m, 3), device=dev)
                           if cons_m > 0 else None)
        self.train_vars = [self.feat] + (
            [self.cfeat] if self.cfeat is not None else [])
        if train_decoder:
            for m in self.mlps.values():
                self.train_vars += m["w"] + m["b"]
        self.graph = None
        self.out = None

    def load(self, params: dict, state: npm.MapState, lf: mq.LocalFilter):
        """A frame's map, parameters and filter into the owned tensors."""
        with torch.no_grad():
            s = self.state
            for name in ("positions", "orientations", "ts_create",
                         "ts_update", "certainty", "count", "table"):
                getattr(s, name).copy_(getattr(state, name))
            if s.btable is not None:
                s.btable.copy_(state.btable)
            self.feat.copy_(params["geo_features"])
            if self.cfeat is not None:
                self.cfeat.copy_(params["color_features"])
            for name, m in self.mlps.items():
                for k in ("w", "b"):
                    for a, b in zip(m[k], params[name][k]):
                        a.copy_(b)
            f = self.lf
            f.travel_dist.copy_(lf.travel_dist)
            f.cur_ts.fill_(lf.cur_ts)
            f.reboot_ts.fill_(lf.reboot_ts)
            if f.sensor_pos is not None:
                f.sensor_pos.copy_(lf.sensor_pos)
            if f.sensor_origins is not None:
                f.sensor_origins.copy_(lf.sensor_origins)

    def iterate(self, batch: dict, mask: torch.Tensor, cons_u,
                lf: mq.LocalFilter):
        """One iteration's loss (`mapping_loss`, looked up when called),
        its gradient and the certainty on the owned leaves and map copy.
        Returns (the gradient of each trained leaf, [loss, consistency
        term])."""
        with tracing.span("mapper.loss"):
            loss, aux = mapping_loss(
                self.feat, self.mlps["geo_mlp"], batch, mask, None, None,
                None, self.qp, color_features=self.cfeat,
                color_mlp=self.mlps.get("color_mlp"),
                sem_mlp=self.mlps.get("sem_mlp"), cons_u=cons_u,
                state=self.state, lf=lf, **self.loss_kwargs)
        with tracing.span("mapper.backward"):
            grads = torch.autograd.grad(loss, self.train_vars,
                                        allow_unused=True)
        # the certainty and update timestamps of the iteration's neighbors,
        # before the next iteration's query (Adam's step reads neither)
        with tracing.span("mapper.certainty"), torch.no_grad():
            npm.accumulate_certainty(self.state, aux["qn"], aux["w"].detach(),
                                     aux["ts"])
        return list(grads), torch.stack([loss.detach(),
                                         aux["consistency_loss"].detach()])

    def capture(self):
        """Capture one iteration on the owned batch (nothing runs)."""
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = self.iterate(self.unpack(self.packed), self.mask,
                                    self.cons_u, self.lf)

    def run(self):
        """One iteration on the owned batch, replayed where captured, else
        called: (gradients, [loss, consistency term])."""
        if self.graph is None:
            return self.iterate(self.unpack(self.packed), self.mask,
                                self.cons_u, self.lf)
        with tracing.span("mapper.replay"):
            self.graph.replay()
        return self.out


def _graph_key(qp, loss_kwargs, state: npm.MapState, params: dict,
               lf: mq.LocalFilter, *, train_decoder: bool, bs: int,
               bs_new: int, n_cols: int, cons_m: int) -> tuple:
    """What a captured iteration is built for: the shapes of the map, the
    features, the decoders, the batch and the filter, whether the decoders
    train, and the constants the iteration bakes in (the query and loss
    settings, the window). Not the iteration count, nor any address."""
    def shape(t):
        return None if t is None else tuple(t.shape)
    mlps = tuple((name, tuple(shape(t) for k in ("w", "b")
                              for t in params[name][k]))
                 for name in ("geo_mlp", "color_mlp", "sem_mlp")
                 if params.get(name) is not None)
    return (qp, tuple(sorted(loss_kwargs.items())), state.capacity,
            state.table_size,
            shape(state.btable) if qp.probe_mode == "brick" else None,
            shape(params["geo_features"]), shape(params.get("color_features")),
            mlps, train_decoder, bs, bs_new, n_cols, cons_m,
            shape(lf.travel_dist), shape(lf.sensor_pos),
            shape(lf.sensor_origins), lf.local_window_dist,
            lf.local_map_radius)


def make_train_loop(qp: mq.QueryParams, *, lr: float, adam_eps: float,
                    n_iters: int, bs: int, bs_new: int, train_decoder: bool,
                    loss_kwargs: dict, subset_hist: int = 0, mesh=None,
                    graph: Optional[dict] = None, _eager: bool = False):
    """Whole per-frame training run (`n_iters` mapping iterations).

    With a local set and n_iters <= 32 and subset_hist >= bs (the
    steady-state frames) it draws ONE history subset, probes it once, and
    lets each iteration take a rotating contiguous window of it plus a
    per-iteration new-sample tail; otherwise (the long first-frame run)
    each iteration draws its own batch, and all batches are probed up front
    in chunks. Without a local set (`lset=None`) each iteration draws its
    own batch and queries the whole map state under the LocalFilter `lf`.

    With `mesh` (a list of R replica devices, `parallel/dp.make_mesh`) the
    run is data-parallel, as the JAX package's `shard_map` loop: replica r
    holds the map, pool and local set on its device (tensors already there
    are not copied), draws its own batches (its own generator, from the
    frame's generator and r; or `draws[r]`) and computes its loss and
    gradients; the gradients come to the first device, are summed in
    replica order and divided by R, and one Adam step there updates the
    trained tensors, which are copied back to the other devices, so every
    replica steps from the same values (the JAX loop's `pmean`). The loss
    is the replicas' mean. Every replica's certainty and update-timestamp
    contributions go through one order-free `index_add_exact` pass and one
    max on the first device (the JAX loop's `psum` / `pmax`). The effective
    batch of an iteration is R x bs.

    Without a local set or `mesh`, on the card, iterations 2..n replay a
    captured iteration's loss, gradient and certainty (`_WholeMapGraph`),
    captured after iteration 1 of the first frame of its key; Adam steps
    after each. The results are the eager loop's, bit for bit. `graph` is
    the slot of the last key's graph, `{key: graph}`, that a system's loops
    of every iteration count share (the loop's own when None); a new key
    replaces it. `_eager` keeps that route eager (the card test's
    reference).

    Returns loop(params, state, pool, generator, use_new, lset, draws=None,
    lf=None, terms=None) -> (params, state, losses [n_iters]); `draws`
    (from `draw_train_indices`; a list of one per replica with `mesh`)
    replaces the generator's draws; `lf` carries the sensor origins of the
    projective correction on either route; a `terms` dict receives the
    per-iteration consistency term ("consistency_loss" [n_iters])."""
    pre_gather = n_iters <= 32
    use_subset = pre_gather and subset_hist >= bs
    cand_k = qp.nn_k + 2
    semantic_on = loss_kwargs.get("semantic_on", False)
    color_on = loss_kwargs.get("color_on", False)
    cons_m = (min(loss_kwargs.get("consistency_count", 1000), bs)
              if loss_kwargs.get("consistency_loss_on", False) else 0)
    replicas = None if mesh is None else [torch.device(d) for d in mesh]
    graph = {} if graph is None else graph

    def probe_chunked(coords, lset):
        idx_parts, val_parts = [], []
        for s in range(0, coords.shape[0], PROBE_CHUNK):
            qn = npm.query_neighbors_join(
                coords[s:s + PROBE_CHUNK], lset, nn_k=cand_k,
                max_dist2=qp.join_max_dist2, resolution=qp.resolution,
                local_ids=True)
            idx_parts.append(qn.idx)
            val_parts.append(qn.valid)
        return torch.cat(idx_parts), torch.cat(val_parts)

    def pack_pool_rows(pool, idx):
        # the labels ride in the same rows: [coord | sdf | weight | ts |
        # sem label | colour]
        parts = [pool.coord[idx], pool.sdf_label[idx, None],
                 pool.weight[idx, None], pool.ts[idx, None].to(torch.float32)]
        if semantic_on and pool.sem_label is not None:
            parts.append(pool.sem_label[idx, None].to(torch.float32))
        if color_on and pool.color_label is not None:
            parts.append(pool.color_label[idx])
        return torch.cat(parts, dim=1)

    def unpack(packed):
        batch = {"coord": packed[:, :3], "sdf_label": packed[:, 3],
                 "weight": packed[:, 4], "ts": packed[:, 5].to(torch.int32)}
        col = 6
        if semantic_on and packed.shape[1] > col:
            batch["sem_label"] = packed[:, col].to(torch.int32)
            col += 1
        if color_on and packed.shape[1] > col:
            batch["color_label"] = packed[:, col:]
        return batch

    def batches(pool: PoolState, lset, draws: dict, slot: torch.Tensor):
        """One replica's batches: batch_of(i) -> (batch, mask, cand,
        cvalid) of iteration i, and the subset path's rows, candidates and
        window starts (None on the other paths)."""
        dev = pool.coord.device
        if lset is None or not use_subset:
            idx_all = whole_map_rows(pool, draws, slot, bs, bs_new)
        if lset is None:
            def batch_of(i):
                return (unpack(pack_pool_rows(pool, idx_all[i])),
                        idx_all[i] < pool.count, None, None)
            return batch_of, None
        if not use_subset:
            mask_all = idx_all < pool.count
            cand_flat, cval_flat = probe_chunked(
                pool.coord[idx_all.reshape(-1)], lset)
            cand_all = cand_flat.reshape(n_iters, bs, cand_k)
            cval_all = cval_flat.reshape(n_iters, bs, cand_k)

            def batch_of(i):
                return (unpack(pack_pool_rows(pool, idx_all[i])),
                        mask_all[i], cand_all[i], cval_all[i])
            return batch_of, None
        S_h = draws["hist"].shape[0]
        new_rows = pool.new_idx[draws["new_sel"]]         # [n_iters, bs_new]
        sub_idx = torch.cat([draws["hist"], new_rows.reshape(-1)])
        packed = pack_pool_rows(pool, sub_idx)
        # row validity folded into the weight: dead rows never train
        packed[:, 4] = torch.where(sub_idx < pool.count, packed[:, 4],
                                   torch.zeros_like(packed[:, 4]))
        cand_sub, cval_sub = probe_chunked(packed[:, :3], lset)
        ph2 = torch.cat([packed[:S_h], packed[:S_h]])
        ch2 = torch.cat([cand_sub[:S_h], cand_sub[:S_h]])
        cv2 = torch.cat([cval_sub[:S_h], cval_sub[:S_h]])
        stride = bs + max(bs // 4, 1)
        starts = [(i * stride) % S_h for i in range(n_iters)]
        ones = torch.ones(bs, dtype=torch.bool, device=dev)

        def batch_of(i):
            st = starts[i]
            hp, hc, hv = ph2[st:st + bs], ch2[st:st + bs], cv2[st:st + bs]
            if bs_new > 0:
                a, b = S_h + i * bs_new, S_h + (i + 1) * bs_new
                s = slot[:, None]
                hp = torch.cat([hp[:bs - bs_new],
                                torch.where(s, packed[a:b], hp[:bs_new])])
                hc = torch.cat([hc[:bs - bs_new],
                                torch.where(s, cand_sub[a:b], hc[:bs_new])])
                hv = torch.cat([hv[:bs - bs_new],
                                torch.where(s, cval_sub[a:b], hv[:bs_new])])
            return unpack(hp), ones, hc, hv
        return batch_of, (packed, cand_sub, cval_sub, S_h, starts)

    def subset_contribs(sub, lset, slot):
        """A subset row's neighbors and IDW weights are frame-constant, so
        its total certainty contribution is multiplicity x weight; the
        multiplicity follows from the window schedule, corrected for the
        tail slots the new-sample mix takes over."""
        packed, cand_sub, cval_sub, S_h, starts = sub
        dev = packed.device
        k_nn = qp.nn_k
        idx6 = cand_sub[:, :k_nn]
        val6 = cval_sub[:, :k_nn]
        pos6 = lset.pts[torch.where(val6, idx6,
                                    torch.full_like(idx6, lset.cap))]
        diff6 = packed[:, None, :3] - pos6
        d2 = torch.sum(diff6 * diff6, dim=-1)
        d2 = torch.where(val6, d2, torch.full_like(d2, npm.BIG_DIST2))
        w6 = npm.idw_weights(npm.QueryNeighbors(
            idx=idx6, dist2=d2, valid=val6,
            nn_count=val6.sum(-1, dtype=torch.int32)),
            idw_index=qp.idw_index)
        base = np.zeros(S_h, np.float32)
        for st_ in starts:
            for e_ in (st_ + bs - bs_new, st_ + min(bs_new, bs)):
                base[st_:min(e_, S_h)] += 1
                if e_ > S_h:
                    base[: e_ - S_h] += 1
        mult_hist = torch.as_tensor(base, device=dev)
        if bs_new > 0:
            tmask = slot.to(torch.float32)
            heads = torch.as_tensor(
                [[(st_ + j) % S_h for j in range(bs_new)]
                 for st_ in starts], device=dev)
            mult_hist = mult_hist.index_add(
                0, heads.reshape(-1), -tmask.repeat(n_iters))
            mult = torch.cat([mult_hist, tmask.repeat(n_iters)])
        else:
            mult = mult_hist
        ts_sub = packed[:, 5].to(torch.int32)
        ci = torch.where(val6, idx6, torch.full_like(idx6, lset.cap))
        cw = torch.where(val6, w6, torch.zeros_like(w6)) * mult[:, None]
        cts = torch.where((mult[:, None] > 0.5) & val6, ts_sub[:, None],
                          torch.zeros_like(ts_sub)[:, None])
        return ci, cw, cts

    def iteration_contribs(aux, cap: int):
        qn = aux["qn"]
        return (torch.where(qn.valid, qn.idx, torch.full_like(qn.idx, cap)),
                torch.where(qn.valid, aux["w"].detach(),
                            torch.zeros_like(aux["w"])),
                torch.where(qn.valid, aux["ts"][:, None],
                            torch.zeros_like(qn.idx, dtype=torch.int32)))

    def graph_loop(params, state: npm.MapState, pool: PoolState, generator,
                   use_new: torch.Tensor, draws, lf: mq.LocalFilter,
                   terms: Optional[dict]):
        """The whole-map route of one replica over a `_WholeMapGraph`:
        iteration 1 eager on a freshly gathered batch and the caller's
        filter, iterations 2..n on the graph's batch, each refreshed by
        one device copy of its rows; every iteration's step by a fresh
        Adam of the frame, as on the other routes."""
        with tracing.span("mapper.setup"):
            dev = state.positions.device
            if draws is None:
                draws = draw_train_indices(generator, pool, n_iters=n_iters,
                                           bs=bs, bs_new=bs_new,
                                           subset_hist=subset_hist,
                                           whole_map=True, cons_m=cons_m)
            slot = use_new.to(dev) & (torch.arange(bs_new, device=dev)
                                      < pool.new_count)
            idx_all = whole_map_rows(pool, draws, slot, bs, bs_new)
            cons = draws.get("cons_u")
            packed0 = pack_pool_rows(pool, idx_all[0])
            key = _graph_key(qp, loss_kwargs, state, params, lf,
                             train_decoder=train_decoder, bs=bs,
                             bs_new=bs_new, n_cols=packed0.shape[1],
                             cons_m=cons_m)
            g = graph.get(key)
            if g is None:
                graph.clear()       # the last key's buffers and memory pool
                g = graph[key] = _WholeMapGraph(
                    state, params, lf, qp=qp, loss_kwargs=loss_kwargs,
                    unpack=unpack, train_decoder=train_decoder, bs=bs,
                    n_cols=packed0.shape[1], cons_m=cons_m)
            g.load(params, state, lf)
            # a fresh Adam per frame, matched to optax.adam(lr, eps)
            opt = torch.optim.Adam(g.train_vars, lr=lr, betas=(0.9, 0.999),
                                   eps=adam_eps)
            if n_iters > 1:
                # every replayed iteration's rows, gathered at once
                packed_all = pack_pool_rows(pool, idx_all[1:].reshape(-1)
                                            ).reshape(n_iters - 1, bs, -1)
                mask_all = idx_all[1:] < pool.count
                outs = torch.empty((n_iters - 1, 2), device=dev)

        def step(grads):
            with tracing.span("mapper.step"):
                opt.zero_grad(set_to_none=True)
                for p, gr in zip(g.train_vars, grads):
                    p.grad = gr
                opt.step()

        with tracing.span("mapper.iter"):
            grads, first = g.iterate(unpack(packed0), idx_all[0] < pool.count,
                                     None if cons is None else cons[0], lf)
            step(grads)
        for i in range(1, n_iters):
            with tracing.span("mapper.iter"):
                g.packed.copy_(packed_all[i - 1])
                g.mask.copy_(mask_all[i - 1])
                if cons is not None:
                    g.cons_u.copy_(cons[i])
                if dev.type == "cuda" and g.graph is None:
                    with tracing.span("mapper.capture"):
                        g.capture()
                grads, out = g.run()
                step(grads)
                outs[i - 1].copy_(out)

        with tracing.span("mapper.writeback"):
            res = first[None] if n_iters == 1 else torch.cat([first[None],
                                                              outs])
            if terms is not None:
                terms["consistency_loss"] = res[:, 1]
            new_params = dict(params)
            for name, m in g.mlps.items():
                new_params[name] = {k: [t.detach().clone() for t in m[k]]
                                    for k in ("w", "b")}
            # the trained features, certainty and update timestamps replace
            # the map's in place
            with torch.no_grad():
                state.geo_features.copy_(g.feat)
                if g.cfeat is not None:
                    state.color_features.copy_(g.cfeat)
                state.certainty.copy_(g.state.certainty)
                state.ts_update.copy_(g.state.ts_update)
            new_params["geo_features"] = state.geo_features
            if g.cfeat is not None:
                new_params["color_features"] = state.color_features
            return new_params, state, res[:, 0]

    def loop(params, state: npm.MapState, pool: PoolState, generator,
             use_new: torch.Tensor, lset, draws=None,
             lf: Optional[mq.LocalFilter] = None,
             terms: Optional[dict] = None):
        if lset is None and replicas is None and lf is not None \
                and not _eager and _replays(state.positions.device):
            return graph_loop(params, state, pool, generator, use_new,
                              draws, lf, terms)
        with tracing.span("mapper.setup"):
            dev = state.positions.device
            C = state.capacity
            whole = lset is None
            devs = [dev] if replicas is None else replicas
            R = len(devs)
            # each replica's map, pool, local set and filter on its device
            # (the caller's tensors where they already are there)
            reps = [dict(state=dp.replicate(state, d) if whole else None,
                         pool=dp.replicate(pool, d),
                         lset=dp.replicate(lset, d),
                         lf=dp.replicate(lf, d)) for d in devs]
            if draws is None:
                gens = ([generator] if replicas is None
                        else dp.replica_generators(generator, devs))
                draws = [draw_train_indices(g, rp["pool"], n_iters=n_iters,
                                            bs=bs, bs_new=bs_new,
                                            subset_hist=subset_hist,
                                            whole_map=whole, cons_m=cons_m)
                         for g, rp in zip(gens, reps)]
            elif replicas is None:
                draws = [draws]
            draws = [dp.replicate(d, dv) for d, dv in zip(draws, devs)]
            # the trained feature rows: the local set's, or the whole map's
            rows_of = (lambda a: a) if whole else (lambda a: a[lset.gidx])
            lfeat = rows_of(params["geo_features"]).detach().clone()
            lfeat.requires_grad_(True)
            lcfeat = None
            if color_on and params.get("color_features") is not None:
                lcfeat = rows_of(params["color_features"]).detach().clone()
                lcfeat.requires_grad_(True)
            mlps = {}
            for name in ("geo_mlp", "color_mlp", "sem_mlp"):
                if params.get(name) is None:
                    continue
                mlps[name] = {
                    k: [t.detach().clone().requires_grad_(train_decoder)
                        for t in params[name][k]] for k in ("w", "b")}

            def trainable(feat, cfeat, ms):
                out = [feat] + ([cfeat] if cfeat is not None else [])
                if train_decoder:
                    for m in ms.values():
                        out += m["w"] + m["b"]
                return out

            train_vars = trainable(lfeat, lcfeat, mlps)
            # a fresh Adam per frame, matched to optax.adam(lr, eps)
            opt = torch.optim.Adam(train_vars, lr=lr, betas=(0.9, 0.999),
                                   eps=adam_eps)

            # each replica's own leaves: aliases of the trained tensors on
            # their device (Adam's in-place step reaches them), copies on
            # another device
            def leaf(t, d):
                return t.detach().to(d).requires_grad_(t.requires_grad)
            rvars = [(leaf(lfeat, d),
                      None if lcfeat is None else leaf(lcfeat, d),
                      {n: {k: [leaf(t, d) for t in m[k]] for k in ("w", "b")}
                       for n, m in mlps.items()}) for d in devs]
            for rp, dr, d in zip(reps, draws, devs):
                # min(new_count, bs_new) fresh slots per iteration, none when
                # the new-sample mix is disabled
                rp["slot"] = (use_new.to(d) & (torch.arange(bs_new, device=d)
                                               < rp["pool"].new_count))
                rp["batch_of"], rp["sub"] = batches(rp["pool"], rp["lset"],
                                                    dr, rp["slot"])
                rp["cons_u"] = dr.get("cons_u")

        def replica_loss(r, i):
            rp, (feat, cfeat, rm) = reps[r], rvars[r]
            batch, bmask, cnd, cnv = rp["batch_of"](i)
            extra = dict(lf=rp["lf"])
            if whole:
                extra["state"] = rp["state"]
            return mapping_loss(
                feat, rm["geo_mlp"], batch, bmask, cnd, cnv, rp["lset"], qp,
                color_features=cfeat, color_mlp=rm.get("color_mlp"),
                sem_mlp=rm.get("sem_mlp"),
                cons_u=None if rp["cons_u"] is None else rp["cons_u"][i],
                **extra, **loss_kwargs)

        losses = []
        cons_terms = []
        contribs = []
        for i in range(n_iters):
            with tracing.span("mapper.iter"):
                # the replicas' gradients summed on the first device in
                # replica order and averaged: one Adam step for every replica
                gsum, lsum, csum, auxs = None, None, None, []
                for r in range(R):
                    with tracing.span("mapper.loss"):
                        loss_r, aux_r = replica_loss(r, i)
                    with tracing.span("mapper.backward"):
                        g = torch.autograd.grad(loss_r, trainable(*rvars[r]),
                                                allow_unused=True)
                        g = [None if x is None else x.to(dev) for x in g]
                        gsum = g if gsum is None else [
                            b if a is None else a if b is None else a + b
                            for a, b in zip(gsum, g)]
                        lr_ = loss_r.detach().to(dev)
                        cr_ = aux_r["consistency_loss"].detach().to(dev)
                        lsum = lr_ if lsum is None else lsum + lr_
                        csum = cr_ if csum is None else csum + cr_
                        auxs.append(dp.replicate(aux_r, dev))
                with tracing.span("mapper.step"):
                    opt.zero_grad(set_to_none=True)
                    for p, g in zip(train_vars, gsum):
                        p.grad = None if g is None else g / R
                    opt.step()
                    with torch.no_grad():
                        for r, d in enumerate(devs):
                            if d != dev:
                                for a, b in zip(trainable(*rvars[r]),
                                                train_vars):
                                    a.copy_(b)
                    losses.append(lsum / R)
                    cons_terms.append(csum / R)
                if whole:
                    # the certainty and update timestamps of every
                    # iteration's neighbors, before the next iteration's query
                    with tracing.span("mapper.certainty"), torch.no_grad():
                        qn = [a["qn"] for a in auxs]
                        npm.accumulate_certainty(
                            state, npm.QueryNeighbors(
                                idx=torch.cat([q.idx for q in qn]),
                                dist2=torch.cat([q.dist2 for q in qn]),
                                valid=torch.cat([q.valid for q in qn]),
                                nn_count=torch.cat([q.nn_count
                                                    for q in qn])),
                            torch.cat([a["w"].detach() for a in auxs]),
                            torch.cat([a["ts"] for a in auxs]))
                elif not use_subset:
                    with tracing.span("mapper.certainty"):
                        contribs += [iteration_contribs(a, lset.cap)
                                     for a in auxs]

        with tracing.span("mapper.writeback"):
            if terms is not None:
                terms["consistency_loss"] = torch.stack(cons_terms)
            new_params = dict(params)
            for name, m in mlps.items():
                new_params[name] = {k: [t.detach() for t in m[k]]
                                    for k in ("w", "b")}
            if whole:
                # the trained whole-map features replace the map's in place
                with torch.no_grad():
                    state.geo_features.copy_(lfeat.detach())
                    if lcfeat is not None:
                        state.color_features.copy_(lcfeat.detach())
                new_params["geo_features"] = state.geo_features
                if lcfeat is not None:
                    new_params["color_features"] = state.color_features
                return new_params, state, torch.stack(losses)

            if use_subset:
                contribs = [dp.replicate(subset_contribs(
                    rp["sub"], rp["lset"], rp["slot"]), dev) for rp in reps]
            ci = torch.cat([c[0].reshape(-1) for c in contribs])
            cw = torch.cat([c[1].reshape(-1) for c in contribs])
            cts = torch.cat([c[2].reshape(-1) for c in contribs])
            cert_l, ts_l = accumulate_certainty_sorted(
                lset.cert, lset.ts_upd, ci, cw, cts, lset.cap)

            # scatter the trained local rows back once (padded rows all point
            # at the dump row C, which is reset afterwards)
            gidx = lset.gidx
            with torch.no_grad():
                state.geo_features[gidx] = lfeat.detach()
                state.geo_features[C] = 0.0
                if lcfeat is not None:
                    state.color_features[gidx] = lcfeat.detach()
                    state.color_features[C] = 0.0
                state.certainty[gidx] = cert_l
                state.certainty[C] = 0.0
                state.ts_update[gidx] = ts_l
                state.ts_update[C] = 0
            new_params["geo_features"] = state.geo_features
            if lcfeat is not None:
                new_params["color_features"] = state.color_features
            return new_params, state, torch.stack(losses)

    return loop
