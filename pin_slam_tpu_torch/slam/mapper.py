"""Online mapping: replay pool + per-frame training of the neural map.
Port of `pin_slam_tpu/slam/mapper.py` on the join path (geometry only,
one device).

* The replay pool is a fixed-capacity RING of sample tensors; a frame's
  samples land as one contiguous block and the ring wrap overwrites the
  oldest blocks. The window filter marks out-of-window samples dead
  (weight = 0) instead of compacting.
* Each frame trains on COMPACT local features: the rows of the map that the
  frame's local set holds are gathered once, trained with a fresh Adam
  (the reference creates a new optimizer per mapping call), and scattered
  back once. Every iteration's neighbor candidates come from ONE batched
  k-NN probe: map positions do not move during a frame's training.
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
from pin_slam_tpu_torch.slam import map_query as mq

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

    @property
    def capacity(self) -> int:
        return self.coord.shape[0] - 1

    def replace(self, **kw) -> "PoolState":
        return replace(self, **kw)


def init_pool(capacity: int, new_cap: int, device=None) -> PoolState:
    p1 = capacity + 1
    z = dict(dtype=torch.int64, device=device)
    return PoolState(
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
                   cur_ts) -> PoolState:
    """Append this frame's samples as one contiguous block (in place).
    Masked-out rows are stored as DEAD rows with weight 0."""
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
                 gradient_decimation: int, main_loss_type: str = "bce"):
    """One training batch's loss against the compact local features
    (join path with cached candidates). Returns (loss, aux) with aux
    carrying the certainty-update neighbor info."""
    coord = batch["coord"]
    sdf_label = batch["sdf_label"]
    weight = torch.abs(batch["weight"])
    mask = mask & (weight > 0.0)    # weight == 0 marks dead pool rows

    cand_pack = (mq.pack_lset_nodiff(lset), geo_features)
    out = mq.query_decode(geo_features, geo_mlp, coord, qp, lset=lset,
                          cand=(cand, cvalid), cand_pack=cand_pack)
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
        g = mq.numerical_grad_shared_join(
            lset, geo_features, geo_mlp, coord[::d], numerical_grad_eps, qp,
            cand=(cand[::d], cvalid[::d]), cand_pack=cand_pack)
        eik_loss = L.eikonal_loss(g, mask[::d])
        total = total + weight_e * eik_loss
    aux = {"qn": out.neighbors, "w": out.weights, "ts": batch["ts"],
           "sdf_loss": sdf_loss, "eikonal_loss": eik_loss}
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
                       bs_new: int, subset_hist: int):
    """All random draws of one `make_train_loop` run: the history indices
    ([S_h] for the subset path, [n_iters, bs] otherwise) and the new-sample
    slots [n_iters, bs_new] into pool.new_idx."""
    dev = pool.coord.device
    if n_iters <= 32 and subset_hist >= bs:
        S_h = max(bs, min(subset_hist, n_iters * bs))
        hist = _randint(generator, S_h, pool.count, dev)
    else:
        hist = _randint(generator, n_iters * bs, pool.count,
                        dev).reshape(n_iters, bs)
    new_sel = _randint(generator, n_iters * bs_new, pool.new_count,
                       dev).reshape(n_iters, bs_new)
    return {"hist": hist, "new_sel": new_sel}


def make_train_loop(qp: mq.QueryParams, *, lr: float, adam_eps: float,
                    n_iters: int, bs: int, bs_new: int, train_decoder: bool,
                    loss_kwargs: dict, subset_hist: int = 0):
    """Whole per-frame training run (`n_iters` mapping iterations).

    With n_iters <= 32 and subset_hist >= bs (the steady-state frames) it
    draws ONE history subset, probes it once, and lets each iteration take
    a rotating contiguous window of it plus a per-iteration new-sample
    tail; otherwise (the long first-frame run) each iteration draws its own
    batch, and all batches are probed up front in chunks.

    Returns loop(params, state, pool, generator, use_new, lset, draws=None)
    -> (params, state, losses [n_iters]); `draws` (from
    `draw_train_indices`) replaces the generator's draws."""
    pre_gather = n_iters <= 32
    use_subset = pre_gather and subset_hist >= bs
    cand_k = qp.nn_k + 2

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
        return torch.cat([pool.coord[idx], pool.sdf_label[idx, None],
                          pool.weight[idx, None],
                          pool.ts[idx, None].to(torch.float32)], dim=1)

    def unpack(packed):
        return {"coord": packed[:, :3], "sdf_label": packed[:, 3],
                "weight": packed[:, 4], "ts": packed[:, 5].to(torch.int32)}

    def loop(params, state: npm.MapState, pool: PoolState, generator,
             use_new: torch.Tensor, lset, draws: Optional[dict] = None):
        dev = state.positions.device
        C = state.capacity
        if draws is None:
            draws = draw_train_indices(generator, pool, n_iters=n_iters,
                                       bs=bs, bs_new=bs_new,
                                       subset_hist=subset_hist)
        gidx = lset.gidx
        lfeat = params["geo_features"][gidx].detach().clone()
        lfeat.requires_grad_(True)
        mlp = {"w": [w.detach().clone().requires_grad_(train_decoder)
                     for w in params["geo_mlp"]["w"]],
               "b": [b.detach().clone().requires_grad_(train_decoder)
                     for b in params["geo_mlp"]["b"]]}
        train_vars = [lfeat]
        if train_decoder:
            train_vars += mlp["w"] + mlp["b"]
        # a fresh Adam per frame, matched to optax.adam(lr, eps)
        opt = torch.optim.Adam(train_vars, lr=lr, betas=(0.9, 0.999),
                               eps=adam_eps)
        # min(new_count, bs_new) fresh slots per iteration, none when the
        # new-sample mix is disabled
        slot = use_new & (torch.arange(bs_new, device=dev) < pool.new_count)
        new_rows = pool.new_idx[draws["new_sel"]]         # [n_iters, bs_new]

        if use_subset:
            S_h = draws["hist"].shape[0]
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
                                    torch.where(s, cand_sub[a:b],
                                                hc[:bs_new])])
                    hv = torch.cat([hv[:bs - bs_new],
                                    torch.where(s, cval_sub[a:b],
                                                hv[:bs_new])])
                return unpack(hp), ones, hc, hv
        else:
            hist = draws["hist"]                           # [n_iters, bs]
            if bs_new > 0:
                tail = torch.where(slot[None], new_rows, hist[:, :bs_new])
                idx_all = torch.cat([hist[:, :bs - bs_new], tail], dim=1)
            else:
                idx_all = hist
            mask_all = idx_all < pool.count
            cand_flat, cval_flat = probe_chunked(
                pool.coord[idx_all.reshape(-1)], lset)
            cand_all = cand_flat.reshape(n_iters, bs, cand_k)
            cval_all = cval_flat.reshape(n_iters, bs, cand_k)

            def batch_of(i):
                return (unpack(pack_pool_rows(pool, idx_all[i])),
                        mask_all[i], cand_all[i], cval_all[i])

        losses = []
        contribs = []
        for i in range(n_iters):
            batch, bmask, cnd, cnv = batch_of(i)
            opt.zero_grad(set_to_none=True)
            loss, aux = mapping_loss(lfeat, mlp, batch, bmask, cnd, cnv, lset,
                                     qp, **loss_kwargs)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if not use_subset:
                qn = aux["qn"]
                contribs.append((
                    torch.where(qn.valid, qn.idx,
                                torch.full_like(qn.idx, lset.cap)),
                    torch.where(qn.valid, aux["w"].detach(),
                                torch.zeros_like(aux["w"])),
                    torch.where(qn.valid, aux["ts"][:, None],
                                torch.zeros_like(qn.idx,
                                                 dtype=torch.int32))))

        if use_subset:
            # a subset row's neighbors and IDW weights are frame-constant,
            # so its total certainty contribution is multiplicity x weight;
            # the multiplicity follows from the window schedule, corrected
            # for the tail slots the new-sample mix takes over
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
        else:
            ci = torch.cat([c[0] for c in contribs])
            cw = torch.cat([c[1] for c in contribs])
            cts = torch.cat([c[2] for c in contribs])
        cert_l, ts_l = accumulate_certainty_sorted(
            lset.cert, lset.ts_upd, ci.reshape(-1), cw.reshape(-1),
            cts.reshape(-1), lset.cap)

        # scatter the trained local rows back once (padded rows all point
        # at the dump row C, which is reset afterwards)
        with torch.no_grad():
            state.geo_features[gidx] = lfeat.detach()
            state.geo_features[C] = 0.0
            state.certainty[gidx] = cert_l
            state.certainty[C] = 0.0
            state.ts_update[gidx] = ts_l
            state.ts_update[C] = 0
        new_params = dict(params)
        new_params["geo_features"] = state.geo_features
        new_params["geo_mlp"] = {"w": [w.detach() for w in mlp["w"]],
                                 "b": [b.detach() for b in mlp["b"]]}
        return new_params, state, torch.stack(losses)

    return loop
