"""Fixed-capacity neural point map. Port of
`pin_slam_tpu/models/neural_points.py`: the join-mode main path with its
colour features, the
cell-table probe that queries without a local set (the mesher's) uses, and
the map maintenance of loop closure (elastic deformation, capacity growth).

Point attribute tensors are preallocated at `capacity` + 1 rows; the last
row is a DUMP row for masked writes and invalid gathers. A power-of-two
voxel hash table stores the latest point index per cell. The layout is the
JAX package's, so indices compare 1:1. The brick probe cache of the JAX
package's hash probes is not kept: neither the join probe nor the cell
probe reads it, and the brick probe is not ported.

Tensors are updated in place where the JAX code builds a new array: the
map is the single owner of its storage.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from pin_slam_tpu_torch.ops import hash3d
from pin_slam_tpu_torch.ops.scatter import index_add_exact, scatter_set_last
from pin_slam_tpu_torch.ops.transforms import (
    quat_multiply,
    quat_rotate,
    rotmat_to_quat,
    transform_points_by_ts,
)
from pin_slam_tpu_torch.ops.voxel import (
    compact_rows,
    voxel_down_sample_hash_mask,
    voxel_down_sample_min_value_mask,
)

BIG_DIST2 = 9e3  # sentinel distance


@dataclass
class MapState:
    """Global neural point map. Row `capacity` of each per-point tensor is
    a dump row."""

    positions: torch.Tensor       # [C+1, 3] f32 world coords
    orientations: torch.Tensor    # [C+1, 4] f32 quaternion (w,x,y,z)
    geo_features: torch.Tensor    # [C+1, F] f32
    ts_create: torch.Tensor       # [C+1] i32
    ts_update: torch.Tensor       # [C+1] i32
    certainty: torch.Tensor       # [C+1] f32
    count: torch.Tensor           # [] i64 number of valid points
    table: torch.Tensor           # [B+1] i64 hash table (-1 empty)
    color_features: Optional[torch.Tensor] = None  # [C+1, F] or None

    @property
    def capacity(self) -> int:
        return self.positions.shape[0] - 1

    @property
    def table_size(self) -> int:
        return self.table.shape[0] - 1

    def replace(self, **kw) -> "MapState":
        return replace(self, **kw)


@dataclass
class QueryNeighbors:
    """k nearest neural points per query."""

    idx: torch.Tensor       # [N, k] i64 point indices (dump row when invalid)
    dist2: torch.Tensor     # [N, k] f32
    valid: torch.Tensor     # [N, k] bool
    nn_count: torch.Tensor  # [N] i32 valid-neighbor count before top-k


def init_map_state(capacity: int, table_size: int, feature_dim: int,
                   color_on: bool = False, device=None) -> MapState:
    c1 = capacity + 1
    orient = torch.zeros((c1, 4), dtype=torch.float32, device=device)
    orient[:, 0] = 1.0
    return MapState(
        positions=torch.zeros((c1, 3), dtype=torch.float32, device=device),
        orientations=orient,
        geo_features=torch.zeros((c1, feature_dim), dtype=torch.float32,
                                 device=device),
        ts_create=torch.zeros(c1, dtype=torch.int32, device=device),
        ts_update=torch.zeros(c1, dtype=torch.int32, device=device),
        certainty=torch.zeros(c1, dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
        table=torch.full((table_size + 1,), -1, dtype=torch.int64,
                         device=device),
        color_features=torch.zeros((c1, feature_dim), dtype=torch.float32,
                                   device=device) if color_on else None,
    )


def _travel_window_ts_lo(travel_dist: torch.Tensor, cur_ts,
                         window: float, strict: bool = False) -> torch.Tensor:
    """Smallest timestamp still inside the travel-distance window (the
    count of timestamps <= cur_ts whose travel lies at or below — or
    strictly below with `strict` — travel[cur_ts] - window)."""
    t = torch.arange(travel_dist.shape[0], device=travel_dist.device)
    lim = travel_dist[cur_ts] - window
    below = (travel_dist < lim) if strict else (travel_dist <= lim)
    return (below & (t <= cur_ts)).sum()


def insert_points(
    state: MapState,
    points: torch.Tensor,   # [M, 3] candidate new neural points (world)
    mask: torch.Tensor,     # [M] validity
    cur_ts,                 # int or scalar tensor
    travel_dist: torch.Tensor,  # [maxT] f32 cumulative travel distance
    *,
    resolution: float,
    local_window_dist: float,
    use_reobs_rule: bool = True,
    force_all_new=False,    # bool or scalar bool tensor
    insert_cap: int = 1 << 16,
):
    """Voxel-downsample candidates, compact the voxel winners to a small
    fixed buffer, probe the hash table on them, and append the new points
    at consecutive slots. Returns (state, new_point_ratio)."""
    C = state.capacity
    B = state.table_size
    M = points.shape[0]
    dev = points.device

    vds_size = min(B, 1 << 22)
    vmask = voxel_down_sample_hash_mask(points, mask, resolution,
                                        vds_size) & mask
    sampled = torch.clamp(vmask.sum(), min=1)

    # ---- compact voxel winners to at most `probe_cap` rows
    probe_cap = min(M, insert_cap * 2)
    cand = compact_rows(vmask, probe_cap, M)
    cvalid = cand < M
    ci = torch.where(cvalid, cand, torch.zeros_like(cand))
    cpts = points[ci]

    # ---- probe existing occupants
    grid = hash3d.grid_coords(cpts, resolution)
    h = hash3d.hash_grid(grid, B)
    existing = state.table[torch.where(cvalid, h, torch.full_like(h, B))]
    exist_valid = existing >= 0
    existing_c = torch.where(exist_valid, existing,
                             torch.full_like(existing, C))
    epos = state.positions[existing_c]
    d2 = torch.sum((epos - cpts) ** 2, dim=-1)
    collide = d2 > 3.0 * resolution * resolution

    is_new = cvalid & (~exist_valid | collide)
    if use_reobs_rule:
        ts_lo = _travel_window_ts_lo(travel_dist, cur_ts, local_window_dist,
                                     strict=True)
        is_new = is_new | (cvalid & exist_valid
                           & (state.ts_update[existing_c] < ts_lo))
    is_new = torch.where(torch.as_tensor(force_all_new, device=dev), cvalid,
                         is_new)

    # ---- compact the new rows to `icap` and give them consecutive slots
    icap = min(probe_cap, insert_cap, C)
    sel = compact_rows(is_new, icap, probe_cap)
    svalid = sel < probe_cap
    si = torch.where(svalid, sel, torch.zeros_like(sel))

    npts = cpts[si]
    nh = h[si]
    j = torch.arange(icap, device=dev)
    n_avail = C - state.count
    ok = svalid & (j < n_avail)
    accepted = ok.sum()
    new_ratio = accepted.to(torch.float32) / sampled.to(torch.float32)
    dest = torch.where(ok, state.count + j, torch.full_like(j, C))

    # ---- block writes at the append cursor: new rows occupy consecutive
    # slots [count, count+accepted); near capacity the block start is
    # clamped and overlapped live rows keep their old values
    start = torch.clamp(state.count, 0, C - icap)
    off = state.count - start
    gi = torch.clamp(j - off, 0, icap - 1)
    write = (j >= off) & ok[gi]
    rows = start + j                                     # [icap] slots

    def blend(arr, new_block):
        old = arr[rows]
        w = write.reshape((icap,) + (1,) * (arr.dim() - 1))
        arr[rows] = torch.where(w, new_block[gi].to(arr.dtype), old)

    ts_new = torch.as_tensor(cur_ts, dtype=torch.int32,
                             device=dev).expand(icap)
    ident_q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).expand(icap, 4)
    blend(state.positions, npts)
    blend(state.orientations, ident_q)
    blend(state.ts_create, ts_new)
    blend(state.ts_update, ts_new)
    blend(state.certainty, torch.zeros(icap, device=dev))
    feat_init = torch.zeros((icap, state.geo_features.shape[1]), device=dev)
    blend(state.geo_features, feat_init)
    if state.color_features is not None:
        blend(state.color_features, feat_init)

    # hash-table updates for the NEW rows only (voxel winners occupy
    # distinct slots, so no index repeats among the accepted rows)
    h_eff = torch.where(ok, nh, torch.full_like(nh, B))
    state.table[h_eff] = torch.where(ok, dest, torch.full_like(dest, -1))
    state.table[B] = -1
    state.count = state.count + accepted
    return state, new_ratio


def query_neighbors(
    state: MapState,
    qpts: torch.Tensor,          # [N, 3] absolute world frame
    *,
    offsets: np.ndarray,         # [K, 3] from hash3d.neighbor_offsets
    resolution: float,
    nn_k: int,
    max_dist2: float,
    time_filter: bool = False,   # travel-distance local-map window
    travel_dist: Optional[torch.Tensor] = None,
    cur_ts=0,
    local_window_dist: float = 0.0,
    radius_filter: bool = False,  # local-map radius around the sensor
    sensor_pos: Optional[torch.Tensor] = None,
    local_map_radius: float = 0.0,
    reboot_ts=0,
    use_mid_ts: bool = False,    # window by (create+update)/2
    probe_mode: str = "cells",
) -> QueryNeighbors:
    """k nearest neural points of each query through the voxel hash table.
    "cells" gathers the table at every cell of the neighborhood ball; the
    brick-cache probe of the JAX package belongs to part B of this module
    and is not ported yet."""
    if probe_mode == "brick":
        raise NotImplementedError(
            "probe_mode='brick': the brick-cache probe is part B of "
            "models/neural_points.py and is not ported yet")
    if probe_mode != "cells":
        raise ValueError(f"query_neighbors: unknown probe_mode {probe_mode!r}")
    return _query_neighbors_cells(
        state, qpts, offsets=offsets, resolution=resolution, nn_k=nn_k,
        max_dist2=max_dist2, time_filter=time_filter,
        travel_dist=travel_dist, cur_ts=cur_ts,
        local_window_dist=local_window_dist, radius_filter=radius_filter,
        sensor_pos=sensor_pos, local_map_radius=local_map_radius,
        reboot_ts=reboot_ts, use_mid_ts=use_mid_ts)


def _query_neighbors_cells(
    state: MapState,
    qpts: torch.Tensor,
    *,
    offsets: np.ndarray,
    resolution: float,
    nn_k: int,
    max_dist2: float,
    time_filter: bool = False,
    travel_dist: Optional[torch.Tensor] = None,
    cur_ts=0,
    local_window_dist: float = 0.0,
    radius_filter: bool = False,
    sensor_pos: Optional[torch.Tensor] = None,
    local_map_radius: float = 0.0,
    reboot_ts=0,
    use_mid_ts: bool = False,
) -> QueryNeighbors:
    """Per-cell probe: table gather, then position/timestamp gathers, then
    the k smallest distances. Candidates are ranked by a STABLE sort, so
    equal distances keep the lower offset column first, as `lax.top_k`
    does on the JAX side (`torch.topk` promises no tie order)."""
    C = state.capacity
    B = state.table_size
    dev = qpts.device
    qpts = qpts.detach()
    offs = torch.as_tensor(np.asarray(offsets), dtype=torch.int32, device=dev)

    grid = hash3d.grid_coords(qpts, resolution)            # [N, 3]
    cells = grid[:, None, :] + offs[None, :, :]            # [N, K, 3]
    idx = state.table[hash3d.hash_grid(cells, B)]          # [N, K]
    valid = idx >= 0
    idx_c = torch.where(valid, idx, torch.full_like(idx, C))

    pos = state.positions[idx_c]                           # [N, K, 3]
    d2 = torch.sum((pos - qpts[:, None, :]) ** 2, dim=-1)
    valid = valid & (d2 <= max_dist2)

    if time_filter:
        tsc = state.ts_create[idx_c]
        if use_mid_ts:
            tsc = torch.div(tsc + state.ts_update[idx_c], 2,
                            rounding_mode="floor")
        ts_lo = _travel_window_ts_lo(travel_dist, cur_ts, local_window_dist)
        valid = valid & (tsc >= ts_lo) & (tsc >= reboot_ts)
    if radius_filter and sensor_pos is not None:
        d2s = torch.sum((pos - sensor_pos[None, None, :]) ** 2, dim=-1)
        valid = valid & (d2s < local_map_radius * local_map_radius)

    nn_count = valid.sum(-1, dtype=torch.int32)
    d2 = torch.where(valid, d2, torch.full_like(d2, BIG_DIST2))

    sd, order = torch.sort(d2, dim=1, stable=True)
    dist2_k, arg = sd[:, :nn_k], order[:, :nn_k]
    valid_k = torch.gather(valid, 1, arg)
    idx_k = torch.where(valid_k, torch.gather(idx_c, 1, arg),
                        torch.full_like(arg, C))
    return QueryNeighbors(idx=idx_k, dist2=dist2_k, valid=valid_k,
                          nn_count=nn_count)


def query_neighbors_join(
    qpts: torch.Tensor,          # [N, 3] absolute world frame
    lset,                        # ops.knn_join.LocalSet
    *,
    nn_k: int,
    max_dist2: float,
    resolution: float,
    capacity: Optional[int] = None,
    local_ids: bool = True,
    qperm: Optional[torch.Tensor] = None,
) -> QueryNeighbors:
    """Neighbor search through the tiled spatial-join k-NN over a prebuilt
    LocalSet. With local_ids=True the returned indices are LOCAL rows of
    the set (dump = lset.cap); otherwise global map rows (dump =
    `capacity`)."""
    from pin_slam_tpu_torch.ops import knn_join as kj

    n = qpts.shape[0]
    q = qpts.detach()
    npad = (-n) % kj.TQ
    if npad:
        q = torch.cat([q, torch.full((npad, 3), kj.PAD, dtype=q.dtype,
                                     device=q.device)])
    li, d2, cnt = kj.knn_join(q, lset.pts[:-1], k=nn_k, max_dist2=max_dist2,
                              resolution=resolution, qperm=qperm)
    li, d2, cnt = li[:n].long(), d2[:n], cnt[:n]
    valid = li >= 0
    if local_ids:
        idx = torch.where(valid, li, torch.full_like(li, lset.cap))
    else:
        idx = torch.where(valid, lset.gidx[torch.clamp(li, min=0)],
                          torch.full_like(li, capacity))
    return QueryNeighbors(idx=idx, dist2=d2, valid=valid, nn_count=cnt)


def local_map_mask(
    state: MapState,
    travel_dist: torch.Tensor,        # [maxT] f32
    cur_ts,
    local_window_dist: float,
    *,
    by_travel_dist: bool = True,
    time_window: int = 100,
    sensor_pos: Optional[torch.Tensor] = None,
    local_map_radius: float = 0.0,
    reboot_ts=0,
    use_mid_ts: bool = False,
) -> torch.Tensor:
    """Row-level [C] mask of the local map: travel-distance (or time)
    window, reboot cut and sensor radius."""
    C = state.capacity
    rows = torch.arange(C, device=state.positions.device)
    alive = rows < state.count
    tsc = state.ts_create[:C]
    if use_mid_ts:
        tsc = torch.div(tsc + state.ts_update[:C], 2, rounding_mode="floor")
    if by_travel_dist:
        ts_lo = _travel_window_ts_lo(travel_dist, cur_ts, local_window_dist)
        m = alive & (tsc >= ts_lo)
    else:
        m = alive & (torch.abs(cur_ts - tsc) < time_window)
    m = m & (tsc >= reboot_ts)
    if sensor_pos is not None and local_map_radius > 0.0:
        d2 = torch.sum((state.positions[:C] - sensor_pos[None, :]) ** 2,
                       dim=-1)
        m = m & (d2 < local_map_radius * local_map_radius)
    return m


def idw_weights(qn: QueryNeighbors, eps: float = 1e-15,
                idw_index: int = 2) -> torch.Tensor:
    """Normalized inverse-distance weights [N, k]; rows without a valid
    neighbor get all-zero weights."""
    if idw_index == 2:
        w = 1.0 / (qn.dist2 + eps)
    elif idw_index % 2 == 0:
        w = 1.0 / (qn.dist2 ** (idw_index // 2) + eps)
    else:
        w = 1.0 / (torch.sqrt(torch.clamp(qn.dist2, min=0.0)) ** idw_index
                   + eps)
    w = torch.where(qn.valid, w, torch.zeros_like(w))
    return w / (torch.sum(w, dim=1, keepdim=True) + eps)


def gather_feature_vectors(state: MapState, qn: QueryNeighbors,
                           qpts: torch.Tensor, *, color: bool = False,
                           rotate_by_orientation: bool = False):
    """Per-neighbour decoder inputs: ([N, k, F+3] geometry vectors, [N, k,
    F+3] colour vectors or None). Each holds the neighbour's feature and
    the offset (query - neighbour position), rotated into the neighbour's
    frame after a map deformation; zero offsets for invalid neighbours.
    The colour vectors come with `color` when the map has colour
    features."""
    feats = state.geo_features[qn.idx]
    vec = qpts[:, None, :] - state.positions[qn.idx]
    if rotate_by_orientation:
        vec = quat_rotate(state.orientations[qn.idx], vec)
    vec = torch.where(qn.valid[..., None], vec, torch.zeros_like(vec))
    color_vec = None
    if color and state.color_features is not None:
        color_vec = torch.cat([state.color_features[qn.idx], vec], dim=-1)
    return torch.cat([feats, vec], dim=-1), color_vec


def queried_certainty(state: MapState, qn: QueryNeighbors,
                      w: torch.Tensor) -> torch.Tensor:
    """IDW-interpolated certainty at the queries [N]."""
    cert = torch.where(qn.valid, state.certainty[qn.idx],
                       torch.zeros_like(w))
    return torch.sum(cert * w, dim=1)


def accumulate_certainty(state: MapState, qn: QueryNeighbors,
                         w: torch.Tensor, query_ts=None) -> MapState:
    """Add the IDW weights into the neighbors' certainty and raise their
    last-update timestamps (in place)."""
    C = state.capacity
    idx = torch.where(qn.valid, qn.idx, torch.full_like(qn.idx, C)).reshape(-1)
    state.certainty.copy_(index_add_exact(
        state.certainty, idx,
        torch.where(qn.valid, w, torch.zeros_like(w)).reshape(-1)))
    state.certainty[C] = 0.0
    if query_ts is not None:
        ts_b = query_ts[:, None].expand(qn.idx.shape).reshape(-1)
        state.ts_update.scatter_reduce_(
            0, idx, torch.where(qn.valid.reshape(-1), ts_b.to(torch.int32),
                                torch.zeros_like(ts_b, dtype=torch.int32)),
            reduce="amax")
        state.ts_update[C] = 0
    return state


# ---------------------------------------------------------------------------
# map maintenance
# ---------------------------------------------------------------------------


def _compact(state: MapState, keep: torch.Tensor) -> MapState:
    """Pack `keep`-selected rows ([C+1], dump never kept) to the front;
    rows keep relative order. Dropped rows all target the dump row, where
    the last one wins as in the JAX reference."""
    C = state.capacity
    keep = keep[:-1]
    order = torch.cumsum(keep.to(torch.int64), 0) - 1
    dest = torch.where(keep, order, torch.full_like(order, C))

    def move(arr, fill_first=None):
        base = torch.zeros_like(arr)
        if fill_first is not None:
            base[:, 0] = fill_first
        return scatter_set_last(base, dest, arr[:-1])

    return state.replace(
        positions=move(state.positions),
        orientations=move(state.orientations, fill_first=1.0),
        geo_features=move(state.geo_features),
        color_features=None if state.color_features is None
        else move(state.color_features),
        ts_create=move(state.ts_create),
        ts_update=move(state.ts_update),
        certainty=move(state.certainty),
        count=keep.sum(),
    )


def prune_map(state: MapState, cur_ts, travel_dist: torch.Tensor, *,
              prune_certainty_thre: float, local_window_dist: float,
              global_prune: bool = False):
    """Drop inactive low-certainty points. Caller must rehash afterwards.
    Returns (state, prune_count)."""
    C = state.capacity
    row_valid = torch.arange(C + 1, device=state.positions.device) \
        < state.count
    low_cert = state.certainty < prune_certainty_thre
    if global_prune:
        prune = low_cert
    else:
        ts_lo = _travel_window_ts_lo(travel_dist, cur_ts, local_window_dist,
                                     strict=True)
        prune = low_cert & (state.ts_update < ts_lo)
    prune = prune & row_valid
    keep = row_valid & ~prune
    return _compact(state, keep), prune.sum()


def rehash(state: MapState, cur_ts, *, resolution: float, use_mid_ts: bool,
           merge: bool = False) -> MapState:
    """Rebuild the hash table, preferring per voxel the point whose
    timestamp is closest to `cur_ts`. With merge=True, duplicate points in
    the same voxel are dropped entirely."""
    C = state.capacity
    dev = state.positions.device
    row_valid = torch.arange(C + 1, device=dev) < state.count
    ts_used = (torch.div(state.ts_create + state.ts_update, 2,
                         rounding_mode="floor")
               if use_mid_ts else state.ts_create)
    ts_diff = torch.abs(ts_used - cur_ts).to(torch.float32)
    winner = voxel_down_sample_min_value_mask(
        state.positions, row_valid, resolution, ts_diff)
    if merge:
        state = _compact(state, winner & row_valid)
        row_valid = torch.arange(C + 1, device=dev) < state.count
        winner = row_valid

    B = state.table_size
    h = hash3d.hash_grid(hash3d.grid_coords(state.positions, resolution), B)
    h = torch.where(winner & row_valid, h, torch.full_like(h, B))
    # colliding voxels: the highest row wins (the reference's scatter order)
    table = torch.full_like(state.table, -1)
    table.scatter_reduce_(0, h, torch.arange(C + 1, device=dev),
                          reduce="amax")
    table[B] = -1
    return state.replace(table=table)


def deform_map(state: MapState, pose_diff: torch.Tensor, *,
               use_mid_ts: bool) -> MapState:
    """Elastic deformation after a pose-graph solve: each neural point
    moves by the correction pose_diff [T, 4, 4] of its (mid-)timestamp,
    clipped to T-1, and its orientation is pre-multiplied by that
    correction's rotation. The caller rehashes afterwards."""
    T = pose_diff.shape[0]
    ts = (torch.div(state.ts_create + state.ts_update, 2,
                    rounding_mode="floor")
          if use_mid_ts else state.ts_create)
    ts = torch.clamp(ts.long(), 0, T - 1)
    positions = transform_points_by_ts(state.positions, ts, pose_diff)
    dq = rotmat_to_quat(pose_diff[:, :3, :3])
    orientations = quat_multiply(dq[ts], state.orientations)
    return state.replace(positions=positions, orientations=orientations)


def grow_capacity(state: MapState, new_capacity: int) -> MapState:
    """Reallocate every per-point tensor at `new_capacity` + 1 rows: the
    live rows stay in place, the new rows are zero (orientations too, as
    in the JAX package: an insert writes the identity) and the dump row
    stays last. The hash table keeps its size and its row indices."""
    pad = new_capacity - state.capacity

    def grow(arr):
        tail = torch.zeros((pad,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                           device=arr.device)
        return torch.cat([arr[:-1], tail, arr[-1:]], dim=0)

    return state.replace(
        positions=grow(state.positions),
        orientations=grow(state.orientations),
        geo_features=grow(state.geo_features),
        color_features=None if state.color_features is None
        else grow(state.color_features),
        ts_create=grow(state.ts_create),
        ts_update=grow(state.ts_update),
        certainty=grow(state.certainty),
    )
