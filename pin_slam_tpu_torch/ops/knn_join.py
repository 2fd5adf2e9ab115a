"""Tiled spatial-join k-NN. Port of `pin_slam_tpu/ops/knn_join.py`.

Exact radius-bounded k-NN (d2 <= max_dist2) of a query batch against a
COMPACTED, MORTON-SORTED local point set:

  1. queries and local points are sorted by voxel Morton code, so a tile of
     either side is spatially coherent;
  2. a per-query-tile table of candidate local tiles, nearest first by
     bounding-box distance, is built in plain torch (`_build_pair_rows`);
  3. the walk over that table with a running top-k per query runs in the
     hand-written CUDA kernel `csrc/knn_join.cu` for CUDA tensors, and in
     the plain torch version `_knn_walk_plain` for CPU tensors.

Both walks stop early exactly as the TPU kernel does, so `cnt` (in-radius
candidates seen) undercounts only for queries whose top-k is already full.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from pin_slam_tpu_torch.ops.hash3d import true_div

TQ = 128          # queries per tile
TL = 512          # local points per tile
ROW_CAP = 32      # max candidate local tiles per query tile
BIG = 9e3
PAD = 1e9
MAX_K = 16        # the CUDA kernel keeps the top-k in registers


class LocalSet(NamedTuple):
    """Morton-sorted compacted local point set (built once per frame).

    Row L (the last row) of every tensor is the DUMP row for invalid local
    indices: pts[L]=0, gidx[L]=C. The k-NN walk consumes pts[:L]. With
    attributes, `cert`/`ts_upd`/`quat` carry compacted per-point state."""

    pts: torch.Tensor      # [L+1, 3] f32, padded rows = 1e9, dump row = 0
    gidx: torch.Tensor     # [L+1] i64 global indices, padded/dump = C
    count: torch.Tensor    # [] i64 number of valid rows
    cert: Optional[torch.Tensor] = None     # [L+1] f32
    ts_upd: Optional[torch.Tensor] = None   # [L+1] i32
    quat: Optional[torch.Tensor] = None     # [L+1, 4] f32

    @property
    def cap(self) -> int:
        return self.pts.shape[0] - 1


def _morton10(g: torch.Tensor) -> torch.Tensor:
    """Interleave 10 bits/axis of non-negative int32 grid coords -> int32
    (Python-int operands keep every shift in int32)."""
    def spread(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        return x

    return (spread(g[..., 0]) | (spread(g[..., 1]) << 1)
            | (spread(g[..., 2]) << 2))


def _morton_codes(pts: torch.Tensor, valid: torch.Tensor,
                  cell: float) -> torch.Tensor:
    """Morton code per row relative to the valid minimum (so the world
    position never overflows the 10-bit range); invalid rows 0x7FFFFFFF."""
    inf = torch.full_like(pts, float("inf"))
    ref = torch.amin(torch.where(valid[:, None], pts, inf), dim=0)
    ref = torch.where(torch.isfinite(ref), ref, torch.zeros_like(ref))
    grid = torch.clamp(torch.floor(true_div(pts - ref, cell)), 0, 1023).to(
        torch.int32)
    return torch.where(valid, _morton10(grid),
                       torch.full_like(grid[:, 0], 0x7FFFFFFF))


def _sort_by_morton(pts: torch.Tensor, valid: torch.Tensor,
                    cell: float) -> torch.Tensor:
    """Stable permutation sorting valid pts by Morton code (pads last)."""
    return torch.argsort(_morton_codes(pts, valid, cell), stable=True)


def build_local_set(
    positions: torch.Tensor,      # [C+1, 3] map positions
    mask: torch.Tensor,           # [C] row mask (local-map criteria)
    resolution: float,
    cap: int,
    certainty: Optional[torch.Tensor] = None,   # [C+1]
    ts_update: Optional[torch.Tensor] = None,   # [C+1]
    orientations: Optional[torch.Tensor] = None,  # [C+1, 4]
) -> LocalSet:
    """Compact + Morton-sort the masked map rows into a fixed-size LocalSet.
    One stable sort by (masked-out?, morton) compacts and orders at once."""
    cap = ((cap + TL - 1) // TL) * TL      # the walk needs L % TL == 0
    C = positions.shape[0] - 1
    # a map smaller than the requested cap: clamp to C rounded UP to the
    # tile size (rounding down would drop valid rows); the tail of `sel`
    # is dump-padded with index C
    if cap > C:
        cap = max(((C + TL - 1) // TL) * TL, TL)
    dev = positions.device
    code = _morton_codes(positions[:C], mask, resolution * 4.0)
    perm = torch.argsort(code, stable=True)
    n_valid = mask.sum()
    take = torch.minimum(n_valid, torch.tensor(cap, device=dev))
    if cap <= C:
        sel = perm[:cap]
    else:
        sel = torch.cat([perm, torch.full((cap - C,), C, dtype=perm.dtype,
                                          device=dev)])
    valid = torch.arange(cap, device=dev) < take
    gidx = torch.cat([torch.where(valid, sel, torch.full_like(sel, C)),
                      torch.full((1,), C, dtype=sel.dtype, device=dev)])
    pts = torch.where(valid[:, None], positions[gidx[:cap]],
                      torch.full((1, 3), PAD, dtype=positions.dtype,
                                 device=dev))
    pts = torch.cat([pts, torch.zeros((1, 3), dtype=pts.dtype, device=dev)])
    return LocalSet(
        pts=pts, gidx=gidx, count=n_valid,
        cert=None if certainty is None else certainty[gidx],
        ts_upd=None if ts_update is None else ts_update[gidx],
        quat=None if orientations is None else orientations[gidx])


def _build_pair_rows(qs: torch.Tensor, lpts: torch.Tensor, max_dist2: float,
                     tq: int = TQ, tl: int = TL, row_cap: int = ROW_CAP):
    """Per-query-tile candidate local-tile table [nq, row_cap] (i32, -1 =
    none), nearest-first by tile-bbox distance, and those distances
    [nq, row_cap] f32 (BIG = none)."""
    nq = qs.shape[0] // tq
    npt = lpts.shape[0] // tl
    qt = qs.reshape(nq, tq, 3)
    pt = lpts.reshape(npt, tl, 3)
    q_real = torch.abs(qt[:, :, 0]) < 1e8
    p_real = torch.abs(pt[:, :, 0]) < 1e8
    inf = float("inf")
    qmin = torch.where(q_real[..., None], qt, inf).amin(1)
    qmax = torch.where(q_real[..., None], qt, -inf).amax(1)
    pmin = torch.where(p_real[..., None], pt, inf).amin(1)
    pmax = torch.where(p_real[..., None], pt, -inf).amax(1)
    gap = torch.clamp(torch.maximum(qmin[:, None] - pmax[None],
                                    pmin[None] - qmax[:, None]), min=0.0)
    bb2 = torch.where(torch.isfinite(gap), gap * gap, inf).sum(-1)
    key = torch.where(bb2 <= max_dist2, bb2, inf)         # [nq, npt]
    r = min(npt, row_cap)
    order = torch.argsort(key, dim=1, stable=True)[:, :r]
    kv = torch.gather(key, 1, order)
    act = torch.isfinite(kv)
    tab = torch.where(act, order, -1).to(torch.int32)
    bbd = torch.where(act, kv, BIG).to(torch.float32)
    if r < row_cap:
        tab = torch.cat([tab, torch.full((nq, row_cap - r), -1,
                                         dtype=torch.int32, device=qs.device)],
                        1)
        bbd = torch.cat([bbd, torch.full((nq, row_cap - r), BIG,
                                         dtype=torch.float32,
                                         device=qs.device)], 1)
    return tab.contiguous(), bbd.contiguous()


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32 (the product of two floats is exact
    in float64). The distance uses the rounding of XLA's CPU code for the
    JAX kernel, fma(dz, dz, fma(dx, dx, dy * dy)), which the CUDA kernel
    repeats with __fmaf_rn."""
    ad = a.double()
    prod = ad * ad if b is a else ad * b.double()
    return prod.add_(c.double()).float()


def _knn_walk_plain(qs, lpts, tab, bbd, perm, k: int, max_dist2: float):
    """Plain torch version of the kernel: the same walk over the tile
    table, the same merge (a stable sort of [kept | new] equals the TPU
    kernel's k argmin rounds with first-index ties), the same exit rule.
    Returns (idx [N,k] i32, d2 [N,k] f32, cnt [N] i32, visits [nq] i32),
    rows in original (un-sorted) order."""
    dev = qs.device
    nq, row_cap = tab.shape
    qt = qs.reshape(nq, TQ, 3)
    pt = lpts.reshape(-1, TL, 3)
    bd = torch.full((nq, TQ, k), BIG, dtype=torch.float32, device=dev)
    bi = torch.full((nq, TQ, k), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros((nq, TQ), dtype=torch.int32, device=dev)
    visits = torch.zeros(nq, dtype=torch.int32, device=dev)
    active = torch.ones(nq, dtype=torch.bool, device=dev)
    cols = torch.arange(TL, dtype=torch.int32, device=dev)
    pos = torch.arange(k + TL, dtype=torch.int64, device=dev)
    for r in range(row_cap):
        active &= bbd[:, r] < bd[:, :, k - 1].amax(1)
        tiles = torch.nonzero(active).squeeze(1)
        if tiles.numel() == 0:
            break
        visits[tiles] += 1
        pid = tab[tiles, r].long()
        p = pt[pid]                                        # [a, TL, 3]
        q = qt[tiles]                                      # [a, TQ, 3]
        dx = q[:, :, None, 0] - p[:, None, :, 0]
        dy = q[:, :, None, 1] - p[:, None, :, 1]
        dz = q[:, :, None, 2] - p[:, None, :, 2]
        d2 = _fma(dz, dz, _fma(dx, dx, dy * dy))           # [a, TQ, TL]
        in_r = d2 <= max_dist2
        cnt[tiles] += in_r.sum(-1, dtype=torch.int32)
        d2m = torch.where(in_r, d2, BIG)
        cat_d = torch.cat([bd[tiles], d2m], -1)
        col = (pid[:, None].to(torch.int32) * TL + cols[None])[:, None, :]
        cat_i = torch.cat([bi[tiles], col.expand(-1, TQ, -1)], -1)
        # the k smallest of a stable sort: d2 >= 0, so its float32 bits
        # order like its values, and the position breaks ties
        key = (cat_d.view(torch.int32).to(torch.int64) << 10) | pos
        order = torch.topk(key, k, dim=-1, largest=False, sorted=True)[1]
        nd = torch.gather(cat_d, -1, order)
        ni = torch.gather(cat_i, -1, order)
        bd[tiles] = nd
        bi[tiles] = torch.where(nd < BIG, ni, -1)
    n = qs.shape[0]
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_c = torch.empty(n, dtype=torch.int32, device=dev)
    out_i[perm] = bi.reshape(n, k)
    out_d[perm] = bd.reshape(n, k)
    out_c[perm] = cnt.reshape(n)
    return out_i, out_d, out_c, visits


# number of kernel launches since the last reset (read by chip_smoke.py to
# prove the main path went through the CUDA kernel)
LAUNCHES = 0


def _knn_walk_cuda(qs, lpts, tab, bbd, perm, k: int, max_dist2: float):
    """Launch csrc/knn_join.cu on the current stream. Same contract as
    `_knn_walk_plain`."""
    global LAUNCHES
    from pin_slam_tpu_torch.ops import cuda_build

    dev = qs.device
    n = qs.shape[0]
    nq, row_cap = tab.shape
    for name, t, dt in (("qs", qs, torch.float32),
                        ("lpts", lpts, torch.float32),
                        ("tab", tab, torch.int32),
                        ("bbd", bbd, torch.float32),
                        ("perm", perm, torch.int64)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"knn_join: {name} must be a contiguous {dt} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")
    if qs.shape != (nq * TQ, 3) or lpts.dim() != 2 or lpts.shape[1] != 3 \
            or lpts.shape[0] % TL or perm.shape != (n,) \
            or bbd.shape != tab.shape:
        raise ValueError("knn_join: inconsistent shapes "
                         f"{tuple(qs.shape)} {tuple(lpts.shape)} "
                         f"{tuple(tab.shape)} {tuple(perm.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_join: k={k} outside 1..{MAX_K}")
    if lpts.data_ptr() % 16:
        raise ValueError("knn_join: the local set must start on a 16-byte "
                         "boundary (the kernel stages it in 16-byte copies)")
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_c = torch.empty(n, dtype=torch.int32, device=dev)
    visits = torch.empty(nq, dtype=torch.int32, device=dev)
    fn = cuda_build.load("knn_join").knn_join_launch
    if fn.argtypes is None:     # pointers must not pass as 32-bit ints
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_float] + [ctypes.c_void_p] * 5)
    err = fn(qs.data_ptr(), lpts.data_ptr(), tab.data_ptr(), bbd.data_ptr(),
             perm.data_ptr(), nq, row_cap, k, max_dist2,
             out_i.data_ptr(), out_d.data_ptr(), out_c.data_ptr(),
             visits.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_join kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out_i, out_d, out_c, visits


def prepare(qpts: torch.Tensor, lset_pts: torch.Tensor, max_dist2: float,
            resolution: float, qperm: Optional[torch.Tensor] = None):
    """Everything `knn_join` does before the walk: query sort and the tile
    table. Returns (qs, tab, bbd, perm, max_dist2 as an f32-exact float)."""
    n = qpts.shape[0]
    L = lset_pts.shape[0]
    if n % TQ or L % TL:
        raise ValueError(f"knn_join: {n} queries / {L} local points are not "
                         f"whole tiles of {TQ} / {TL}")
    # the bound as the float32 both walks compare against
    md2 = float(np.float32(max_dist2))
    if qperm is None:
        qvalid = torch.abs(qpts[:, 0]) < 1e8
        qperm = _sort_by_morton(qpts, qvalid, resolution * 4.0)
    qs = qpts[qperm].contiguous()
    tab, bbd = _build_pair_rows(qs, lset_pts, md2)
    return qs, tab, bbd, qperm.contiguous(), md2


def knn_join(
    qpts: torch.Tensor,        # [N, 3] f32, N a multiple of TQ (pad 1e9)
    lset_pts: torch.Tensor,    # [L, 3] Morton-sorted local points (L % TL = 0)
    k: int,
    max_dist2: float,
    resolution: float,
    qperm: Optional[torch.Tensor] = None,  # [N] precomputed query sort
):
    """Exact radius-bounded k-NN of qpts against the local set. On a CUDA
    tensor it launches the CUDA kernel; on a CPU tensor it runs the plain
    version. Returns (idx [N,k] i32 with -1 = none, d2 [N,k] f32 with BIG
    for missing, cnt [N] i32 in-radius candidate count)."""
    qpts = qpts.detach().contiguous()
    lset_pts = lset_pts.detach().contiguous()
    qs, tab, bbd, perm, md2 = prepare(qpts, lset_pts, max_dist2, resolution,
                                      qperm)
    walk = _knn_walk_cuda if qpts.is_cuda else _knn_walk_plain
    idx, d2, cnt, _ = walk(qs, lset_pts, tab, bbd, perm, k, md2)
    return idx, d2, cnt
