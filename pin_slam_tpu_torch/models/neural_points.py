"""Fixed-capacity neural point map. Port of
`pin_slam_tpu/models/neural_points.py`: insertion with its colour features,
the three neighbour probes (the join probe over a local set, the cell-table
probe and the brick-cache probe over the whole map), and the map
maintenance of loop closure (elastic deformation, capacity growth).

Point attribute tensors are preallocated at `capacity` + 1 rows; the last
row is a DUMP row for masked writes and invalid gathers. A power-of-two
voxel hash table stores the latest point index per cell. The brick cache
(`MapState.btable`) holds the same cells grouped into 4x4x4-cell bricks, so
a probe reads 8 brick rows instead of 33 cells; it is kept only where the
brick probe reads it. The layout is the JAX package's, so indices compare
1:1.

Tensors are updated in place where the JAX code builds a new array: the
map is the single owner of its storage.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from pin_slam_tpu_torch.ops import hash3d
from pin_slam_tpu_torch.ops.knn_join import _fma
from pin_slam_tpu_torch.ops.scatter import index_add_exact, set_last_
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
    # brick cache: int32 [Nb+1, 64, 3] of (idx, ts_create, packed 3 x u8
    # cell-local position) per cell slot of 4x4x4-cell bricks hashed by
    # brick coordinate, row Nb the dump brick; [1, 64, 3] (the dump brick
    # alone) or None where no brick probe reads it
    btable: Optional[torch.Tensor] = None

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
                   color_on: bool = False, device=None,
                   with_btable: bool = True) -> MapState:
    """`with_btable=False` allocates the dump brick alone: the join and
    cell probes never read the brick cache, which takes ~400 MB at a 2^23
    table. The brick probe requires True."""
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
        btable=_empty_btable(_brick_count(table_size) if with_btable else 0,
                             device),
    )


# brick layout
BRICK_EDGE = 4                      # cells per brick edge
CELLS_PER_BRICK = BRICK_EDGE ** 3
_BRICK_FIELDS = 3                   # idx, ts_create, packed local position
# brick-corner offsets covering any 5-cell span (the 33-cell ball)
_BRICK_NEI = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                      -1).reshape(8, 3)
# cell offset of each slot within its brick; slot = x * 16 + y * 4 + z
_SLOT_XYZ = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(4),
                                 indexing="ij"), -1).reshape(64, 3)
# queries per chunk of the brick probe: a query gathers 8 brick rows
# (6 KiB) and ranks 512 candidates
BRICK_QUERY_CHUNK = 1 << 16


def _brick_count(table_size: int) -> int:
    """Brick rows for a per-cell table size (4x the cell capacity)."""
    return max(table_size >> 4, 1 << 10)


def _empty_btable(n_bricks: int, device=None) -> torch.Tensor:
    return torch.full((n_bricks + 1, CELLS_PER_BRICK, _BRICK_FIELDS), -1,
                      dtype=torch.int32, device=device)


def has_btable(state: MapState) -> bool:
    """True when the state keeps a brick cache beyond the dump brick."""
    return state.btable is not None and state.btable.shape[0] > 1


def _pack_local(pos: torch.Tensor, grid: torch.Tensor, resolution: float,
                contract: bool) -> torch.Tensor:
    """The cell-local position quantized to 3 x u8 in one int32 (~res/256:
    it only ranks candidates; consumers recompute exact distances from
    `positions`). The fraction pos / res - grid rounds as in the JAX
    package's jitted code, where XLA multiplies by 1 / res: contracted into
    fma(pos, 1 / res, -grid) in the insert (`contract`), rounded after the
    product in the rehash."""
    rec = torch.full((), float(np.float32(1.0) / np.float32(resolution)),
                     device=pos.device)
    gf = grid.to(torch.float32)
    frac = _fma(pos, rec, -gf) if contract else pos * rec - gf
    q = torch.clamp((frac * 256.0).to(torch.int32), 0, 255)
    return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)


def _brick_write(btable: torch.Tensor, grid: torch.Tensor, idx: torch.Tensor,
                 ts: torch.Tensor, pos: torch.Tensor, resolution: float,
                 write_mask: torch.Tensor, contract: bool = True
                 ) -> torch.Tensor:
    """Scatter (idx, ts, packed pos) records into brick slots, in place;
    masked rows land in the dump brick, which no query reads. Records that
    alias one slot (two bricks with one brick hash) resolve as XLA's CPU
    scatter does: the last record in row order wins. `contract`: see
    `_pack_local`."""
    n_bricks = btable.shape[0] - 1
    hb = hash3d.hash_grid(grid >> 2, n_bricks)
    slot = ((grid[..., 0] & 3) * 16 + (grid[..., 1] & 3) * 4
            + (grid[..., 2] & 3))
    flat_idx = torch.where(write_mask, hb * CELLS_PER_BRICK + slot,
                           torch.full_like(hb, n_bricks * CELLS_PER_BRICK))
    rec = torch.stack([idx.to(torch.int32), ts.to(torch.int32),
                       _pack_local(pos, grid, resolution, contract)], dim=-1)
    set_last_(btable.view(-1, _BRICK_FIELDS), flat_idx, rec)
    return btable


def rebuild_probe_cache(state: MapState, resolution: float) -> MapState:
    """Recompute the brick cache from (table, positions, ts_create), after
    any operation that moves points or rewrites the table wholesale
    (deform, rehash, prune): only the points the cell table points at are
    written, so the bricks agree with `table`. A no-op without a cache."""
    if not has_btable(state):
        return state
    C = state.capacity
    rows = torch.arange(C + 1, device=state.positions.device)
    alive = rows < state.count
    grid = hash3d.grid_coords(state.positions, resolution)
    h = hash3d.hash_grid(grid, state.table_size)
    is_winner = alive & (state.table[h] == rows)
    btable = _empty_btable(state.btable.shape[0] - 1,
                           state.positions.device)
    return state.replace(btable=_brick_write(
        btable, grid, rows, state.ts_create, state.positions, resolution,
        is_winner, contract=False))


_DEVICE_CONSTANTS: dict = {}


def device_constant(values: np.ndarray, dtype: torch.dtype,
                    device) -> torch.Tensor:
    """`torch.as_tensor(values, dtype, device)`, uploaded once per values,
    dtype and device and shared after that: an upload from host memory
    makes the host wait for the device, and a CUDA graph cannot capture
    it. Callers never write to the tensor."""
    a = np.ascontiguousarray(values)
    key = (a.tobytes(), a.shape, a.dtype.str, dtype, torch.device(device))
    t = _DEVICE_CONSTANTS.get(key)
    if t is None:
        t = _DEVICE_CONSTANTS[key] = torch.as_tensor(a, dtype=dtype,
                                                     device=device)
    return t


def _travel_window_ts_lo(travel_dist: torch.Tensor, cur_ts,
                         window: float, strict: bool = False) -> torch.Tensor:
    """Smallest timestamp still inside the travel-distance window (the
    count of timestamps <= cur_ts whose travel lies at or below — or
    strictly below with `strict` — travel[cur_ts] - window). `cur_ts` is
    an int or an integer device scalar (read on the device, no sync)."""
    t = torch.arange(travel_dist.shape[0], device=travel_dist.device)
    if torch.is_tensor(cur_ts):
        lim = travel_dist.index_select(0, cur_ts.reshape(1).long()
                                       ).reshape(()) - window
    else:
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
    maintain_btable: bool = True,  # False where no brick probe reads it
):
    """Voxel-downsample candidates, compact the voxel winners to a small
    fixed buffer, probe the hash table on them, and append the new points
    at consecutive slots (and their records to the brick cache, where the
    state keeps one). Returns (state, new_point_ratio)."""
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
    ngrid = grid[si]
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
    if maintain_btable and has_btable(state):
        _brick_write(state.btable, ngrid, dest, ts_new, npts, resolution, ok)
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
    "cells" gathers the table at every cell of the neighborhood ball;
    "brick" gathers the 8 bricks of the brick cache that cover the ball
    (which the state must keep, see `init_map_state`), in chunks of
    BRICK_QUERY_CHUNK queries."""
    kw = dict(offsets=offsets, resolution=resolution, nn_k=nn_k,
              max_dist2=max_dist2, time_filter=time_filter,
              travel_dist=travel_dist, cur_ts=cur_ts,
              local_window_dist=local_window_dist,
              radius_filter=radius_filter, sensor_pos=sensor_pos,
              local_map_radius=local_map_radius, reboot_ts=reboot_ts,
              use_mid_ts=use_mid_ts)
    if probe_mode == "cells":
        return _query_neighbors_cells(state, qpts, **kw)
    if probe_mode != "brick":
        raise ValueError(f"query_neighbors: unknown probe_mode {probe_mode!r}")
    if not has_btable(state):
        raise ValueError("query_neighbors: probe_mode='brick' needs a map "
                         "state with a brick cache (with_btable=True)")
    n = qpts.shape[0]
    if n <= BRICK_QUERY_CHUNK:
        return _query_neighbors_brick(state, qpts, **kw)
    parts = [_query_neighbors_brick(state, qpts[s:s + BRICK_QUERY_CHUNK],
                                    **kw)
             for s in range(0, n, BRICK_QUERY_CHUNK)]
    return QueryNeighbors(*(torch.cat([getattr(p, f) for p in parts])
                            for f in ("idx", "dist2", "valid", "nn_count")))


def _ball_columns(offsets: np.ndarray):
    """The ball's cells among the 512 slots of the 8 bricks that cover it:
    (per-offset brick corner j [K, 3] in {0, 1}, the offsets [K, 3], and
    the ball's squared radius and radius in cells), for the offsets of the
    ball {o : |o|^2 <= max |o|^2} that the 8 bricks reach. The ball is the
    cell probe's search: `offsets` is a full ball of integer radii."""
    offs = np.asarray(offsets).astype(np.int64)
    ball_r2 = int(np.max((offs ** 2).sum(-1)))
    ball_r = int(np.floor(np.sqrt(ball_r2)))
    r = np.arange(-ball_r, ball_r + 1)
    ball = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    ball = ball[(ball ** 2).sum(-1) <= ball_r2]
    return ball, ball_r2, ball_r


def _query_neighbors_brick(
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
    """Brick probe: the 8 bricks (4x4x4 cells each) that cover the ball of
    `offsets` around each query's cell are gathered whole ([N, 8, 64, 3]
    records), the ball's cells are taken out of their 512 slots (the cell
    probe's search), and the candidates are ranked by the distance to
    their quantized cell-local positions. The JAX package masks the 512
    slots to the ball and runs k rounds of argmin over them (ties to the
    lower slot); here the ball's slots are gathered and ranked by a top-k
    over unique (distance bits, slot) keys, which orders them the same.
    The distances round as the JAX package's jitted probe does on the CPU,
    where XLA contracts the position and the squared norms into FMAs.
    `dist2` is that ranking distance."""
    C = state.capacity
    dev = qpts.device
    qpts = qpts.detach()
    n = qpts.shape[0]
    n_bricks = state.btable.shape[0] - 1
    ball, ball_r2, ball_r = _ball_columns(offsets)
    ball_t = device_constant(ball, torch.int32, dev)

    grid = hash3d.grid_coords(qpts, resolution)             # [N, 3] i32
    b0 = (grid - ball_r) >> 2                               # arithmetic
    bcs = b0[:, None, :] + device_constant(_BRICK_NEI, torch.int32,
                                           dev)[None]
    rows = state.btable[hash3d.hash_grid(bcs, n_bricks)]    # [N, 8, 64, 3]

    # the ball's cells: their brick among the 8 and their slot in it
    cell = grid[:, None, :] + ball_t[None]                  # [N, K, 3]
    j = (cell >> 2) - b0[:, None, :]
    reach = ((j >= 0) & (j <= 1)).all(-1)
    jf = (j[..., 0] * 4 + j[..., 1] * 2 + j[..., 2]).clamp(0, 7)
    slot = ((cell[..., 0] & 3) * 16 + (cell[..., 1] & 3) * 4
            + (cell[..., 2] & 3))
    col = (jf * CELLS_PER_BRICK + slot).long()              # [N, K] in 512
    rec = torch.gather(rows.reshape(n, 8 * CELLS_PER_BRICK, _BRICK_FIELDS),
                       1, col[..., None].expand(-1, -1, _BRICK_FIELDS))
    idx, tsc, packed = rec.unbind(-1)

    # the record's position: fma(u8 + 0.5, res / 256, cell * res)
    step = torch.full((), resolution / 256.0, device=dev)
    base = cell.to(torch.float32) * resolution
    pos = [_fma(((packed >> (8 * a)) & 0xFF).to(torch.float32) + 0.5, step,
                base[..., a]) for a in range(3)]
    dx, dy, dz = (pos[a] - qpts[:, None, a] for a in range(3))
    d2 = _fma(dz, dz, _fma(dx, dx, dy * dy))                # [N, K]
    valid = (idx >= 0) & reach & (d2 <= max_dist2)

    if time_filter:
        ts_lo = _travel_window_ts_lo(travel_dist, cur_ts, local_window_dist)
        ts_eff = tsc
        if use_mid_ts:
            ts_eff = torch.div(
                tsc + state.ts_update[torch.where(
                    idx >= 0, idx.long(), torch.full_like(idx, C).long())],
                2, rounding_mode="floor")
        valid = valid & (ts_eff >= ts_lo) & (ts_eff >= reboot_ts)
    if radius_filter and sensor_pos is not None:
        sx, sy, sz = (pos[a] - sensor_pos[a] for a in range(3))
        d2s = _fma(sz, sz, _fma(sx, sx, sy * sy))
        valid = valid & (d2s < local_map_radius * local_map_radius)

    nn_count = valid.sum(1, dtype=torch.int32)
    d2 = torch.where(valid, d2, torch.full_like(d2, BIG_DIST2))
    # unique keys: a non-negative float's bits order as the float; the slot
    # breaks ties to the lower one, as argmin's first index does
    key = (d2.view(torch.int32).long() << 10) | col
    if key.shape[1] < nn_k:          # fewer ball cells than k: pad
        pad = torch.full((n, nn_k - key.shape[1]), 1 << 9, dtype=torch.long,
                         device=dev)
        pad |= torch.tensor(BIG_DIST2, dtype=torch.float32).view(
            torch.int32).long().item() << 10
        key = torch.cat([key, pad], 1)
        idx = torch.cat([idx, torch.full_like(pad, -1, dtype=idx.dtype)], 1)
        valid = torch.cat([valid, torch.zeros_like(pad, dtype=torch.bool)],
                          1)
    top, arg = torch.topk(key, nn_k, dim=1, largest=False, sorted=True)
    dist2_k = (top >> 10).to(torch.int32).view(torch.float32)
    valid_k = torch.gather(valid, 1, arg)
    idx_k = torch.where(valid_k, torch.gather(idx, 1, arg).long(),
                        torch.full_like(arg, C))
    return QueryNeighbors(idx=idx_k, dist2=dist2_k, valid=valid_k,
                          nn_count=nn_count)


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
    offs = device_constant(np.asarray(offsets), torch.int32, dev)

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
    # the dump row reset through a slice: assigning to one element of a
    # device tensor uploads the value from the host, a sync
    state.certainty[C:].zero_()
    if query_ts is not None:
        ts_b = query_ts[:, None].expand(qn.idx.shape).reshape(-1)
        state.ts_update.scatter_reduce_(
            0, idx, torch.where(qn.valid.reshape(-1), ts_b.to(torch.int32),
                                torch.zeros_like(ts_b, dtype=torch.int32)),
            reduce="amax")
        state.ts_update[C:].zero_()
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
        return set_last_(base, dest, arr[:-1])

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
    return rebuild_probe_cache(state.replace(table=table), resolution)


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
