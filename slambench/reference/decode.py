"""The neural-point SDF in plain PyTorch, float64: the reference the
harness holds the program's outputs to.

A query's neighbours are found as PIN-SLAM finds them: the map's voxel
hash table (worked out here from the map rows) is looked up at every voxel
of the cell ball round the query's voxel; the candidates within the cell
probe's distance bound (and, for a query of the tracker or the training,
within the travel window and the local-map radius) are ranked by distance
and the `nn_k` nearest kept. Inverse-squared-distance weights, offsets
rotated by the points' orientation quaternions, and the decoder MLP
follow, per neighbour or on the weighted mean, as the configuration's
`weighted_first` says.

`prec="tf32"` is the control: float32 with every matrix product's operands
rounded to TF32's 10-bit mantissa, as the card's TF32 mode computes them,
in the gradient's products too.
A query whose neighbour set float32 rounding could change (a squared
distance within float32's reach of a bound, or of the next candidate's at
the k-th place), or that looks up an ambiguous slot of the table, is
flagged ambiguous and left out of the widest-gap comparisons.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from slambench.reference.settings import Settings

BIG = 1e30
AMBIG_REL = 1e-5


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, nearest)."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with every product's operands rounded to TF32, in the
    backward pass as well (the gradient's products, as the card's TF32
    mode computes them)."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ar, br)
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = tf32_round(g)
        return gr @ tf32_round(br.transpose(-1, -2)), \
            tf32_round(ar.transpose(-1, -2)) @ gr


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f64":
        return a.double() @ b.double()
    if prec == "tf32":
        if a.dim() > 2:
            return _TF32MatMul.apply(a.reshape(-1, a.shape[-1]).float(),
                                     b.float()).reshape(
                *a.shape[:-1], b.shape[-1])
        return _TF32MatMul.apply(a.float(), b.float())
    raise ValueError(prec)


def cast(x: torch.Tensor, prec: str) -> torch.Tensor:
    return x.double() if prec == "f64" else x.float()


def mlp(params, x: torch.Tensor, prec: str) -> torch.Tensor:
    """ReLU MLP with W [in, out]; returns the first output."""
    ws, bs = params
    h = cast(x, prec)
    for i in range(len(ws)):
        h = matmul(h, ws[i], prec) + cast(bs[i], prec)
        if i + 1 < len(ws):
            h = torch.relu(h)
    return h[..., 0]


class Neighbours(NamedTuple):
    idx: torch.Tensor      # [N, k] int64 map rows, -1 where none
    d2: torch.Tensor       # [N, k] float64 (BIG where none)
    ambiguous: torch.Tensor  # [N] bool


P1, P2, P3 = 73856093, 19349669, 83492791   # PIN-SLAM's voxel hash


def cells_of(p: torch.Tensor, res: float) -> torch.Tensor:
    """Voxel of each point, from its float32 coordinates divided as IEEE
    division rounds."""
    p32 = p.float()
    return torch.floor(p32 / torch.full((), res, dtype=torch.float32,
                                        device=p.device)).long()


def voxel_hash(cells: torch.Tensor, table_size: int) -> torch.Tensor:
    """The prime multiply-sum hash of int voxels [..., 3] in wrap-around
    32-bit arithmetic, into a power-of-two table."""
    u = cells & 0xFFFFFFFF
    return (u[..., 0] * P1 + u[..., 1] * P2 + u[..., 2] * P3) \
        & (table_size - 1)


class CellTable:
    """The map's voxel hash table worked out from its rows: a slot holds
    the last row inserted into it (map rows are appended in insertion
    order, and a later point takes over its slot from an earlier one).
    Rows created in the same frame that share a slot were written into the
    table at once, and which of them holds the slot is not defined: such
    a slot is ambiguous."""

    def __init__(self, pts: torch.Tensor, ts: torch.Tensor, st: Settings):
        slots = voxel_hash(cells_of(pts, st.voxel_m), st.table_size)
        order = torch.argsort(slots, stable=True)
        s = slots[order]
        last = torch.ones_like(s, dtype=torch.bool)
        last[:-1] = s[1:] != s[:-1]
        prev_same = torch.zeros_like(s, dtype=torch.bool)
        prev_same[1:] = s[1:] == s[:-1]
        t = ts[order]
        tie = torch.zeros_like(s, dtype=torch.bool)
        tie[1:] = prev_same[1:] & (t[1:] == t[:-1])
        self.slots = s[last]
        self.rows = order[last]
        self.tied = tie[last]
        self.size = st.table_size

    def lookup(self, slots: torch.Tensor):
        """(row [..] or -1, ambiguous [..]) of each slot."""
        if self.slots.numel() == 0:
            return (torch.full_like(slots, -1),
                    torch.zeros_like(slots, dtype=torch.bool))
        i = torch.searchsorted(self.slots, slots).clamp(
            max=self.slots.numel() - 1)
        found = self.slots[i] == slots
        return (torch.where(found, self.rows[i], torch.full_like(slots, -1)),
                found & self.tied[i])


class Filter(NamedTuple):
    """The travel-window filter of a whole-map query: a candidate's
    creation frame must lie in the window of frames whose travel is more
    than `window` metres below frame `cur_ts`'s, and at or after
    `reboot_ts`; with `sensor`, it must lie within `radius` of it."""
    travel: torch.Tensor      # [T] float32 travel distance of each frame
    cur_ts: int
    window: float
    reboot_ts: int
    ts: torch.Tensor          # [M] creation frame of each map row
    sensor: Optional[torch.Tensor] = None
    radius: float = 0.0

    def ts_lo(self) -> int:
        t = torch.arange(self.travel.shape[0], device=self.travel.device)
        lim = self.travel[self.cur_ts] - torch.tensor(
            self.window, dtype=self.travel.dtype, device=self.travel.device)
        return int(((self.travel <= lim) & (t <= self.cur_ts)).sum())


def neighbours(q: torch.Tensor, pts: torch.Tensor, table: CellTable,
               st: Settings, filt: Optional[Filter] = None,
               k: Optional[int] = None,
               q_cell: Optional[torch.Tensor] = None) -> Neighbours:
    """The k nearest candidates of each query q [N, 3] (world coordinates)
    among map points pts [M, 3]: the rows the hash table holds for the
    voxels of the cell ball round the query's voxel, within the cell
    probe's distance bound and the filter. The voxel is that of `q_cell`
    where given (the float32 world coordinates the probe hashes, of a
    query given in float64)."""
    k = k or st.nn_k
    offs = torch.as_tensor(st.offsets, dtype=torch.long, device=q.device)
    qc = cells_of(q if q_cell is None else q_cell, st.voxel_m)
    cells = qc[:, None, :] + offs[None]                       # [N, K, 3]
    rows, tied = table.lookup(voxel_hash(cells, table.size))
    ok = rows >= 0
    rc = rows.clamp(min=0)
    d2 = ((pts.double()[rc] - q.double()[:, None, :]) ** 2).sum(-1)
    # how far float32 rounding can move a squared distance: a relative
    # AMBIG_REL, and twice the distance times the float32 spacing of the
    # coordinates (the program rounds the query and the points to float32)
    ulp = q.double().abs().amax(1, keepdim=True) * 2.0 ** -22

    def tol(x):
        return AMBIG_REL * x + 4.0 * torch.sqrt(x.clamp(min=0)) * ulp

    bound = st.cell_dist2
    near = (d2 - bound).abs() <= tol(torch.full_like(d2, bound))
    ok = ok & (d2 <= bound)
    if filt is not None:
        ts = filt.ts[rc]
        ok = ok & (ts >= filt.ts_lo()) & (ts >= filt.reboot_ts)
        if filt.sensor is not None:
            r2 = filt.radius * filt.radius
            ds = ((pts.double()[rc] - filt.sensor.double()) ** 2).sum(-1)
            near = near | ((ds - r2).abs() <= tol(torch.full_like(ds, r2)))
            ok = ok & (ds < r2)
    near = near & (rows >= 0)
    d2m = torch.where(ok, d2, torch.full_like(d2, BIG))
    top, ti = torch.sort(d2m, dim=1, stable=True)
    amb = near.any(1) | tied.any(1)
    if top.shape[1] > k:
        a, b = top[:, k - 1], top[:, k]
        amb = amb | ((b < BIG) & ((b - a) <= tol(b[:, None])[:, 0]))
    top, ti = top[:, :k], ti[:, :k]
    idx = torch.gather(rows, 1, ti)
    idx = torch.where(top < BIG, idx, torch.full_like(idx, -1))
    return Neighbours(idx, top, amb)


def quat_rotate(qt: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v [..., 3] by unit quaternions (w, x, y, z) [..., 4]."""
    w = qt[..., :1]
    u = qt[..., 1:4]
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def sdf(q: torch.Tensor, nb: Neighbours, pts: torch.Tensor,
        feats: torch.Tensor, params, st: Settings,
        quats: Optional[torch.Tensor] = None, prec: str = "f64"
        ) -> torch.Tensor:
    """The SDF at q [N, 3] from its neighbours `nb` among map points
    pts [M, 3] with features feats [M, F] and decoder `params`
    ([W...], [b...])."""
    valid = nb.idx >= 0
    gi = nb.idx.clamp(min=0)
    p = cast(pts, prec)[gi]
    diff = cast(q, prec)[:, None, :] - p                    # [N, k, 3]
    d2 = (diff * diff).sum(-1)
    w = torch.where(valid, 1.0 / (d2 + 1e-15), torch.zeros_like(d2))
    w = w / (w.sum(1, keepdim=True) + 1e-15)
    vec = diff
    if quats is not None:
        vec = quat_rotate(cast(quats, prec)[gi], vec)
    vec = torch.where(valid[..., None], vec, torch.zeros_like(vec))
    f = torch.where(valid[..., None], cast(feats, prec)[gi],
                    torch.zeros_like(cast(feats, prec)[gi]))
    x = torch.cat([f, vec], -1)                             # [N, k, F + 3]
    if st.weighted_first:
        return mlp(params, (x * w[..., None]).sum(1), prec) * st.sdf_scale
    per = mlp(params, x, prec) * st.sdf_scale
    return (per * w).sum(1)
