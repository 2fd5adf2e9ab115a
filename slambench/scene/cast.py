"""Closed-form ray casting of the town (`scene/route.py`) in PyTorch, on
the device. `scene/cast_np.py` is the same arithmetic in NumPy, which the
CPU tests hold this file to.

Each ray takes the nearest hit among the boxes, the vertical cylinders and
the ground plane z = 0; a ray with no hit gets +inf.
"""

from __future__ import annotations

import torch

PRIM_CHUNK = 64        # primitives per pass: [rays, 64] temporaries
EPS_T = 1e-6           # hits closer than this are the ray's own origin


def _safe(v: torch.Tensor) -> torch.Tensor:
    """v with zero components moved off zero (slab and plane divisions)."""
    tiny = torch.full_like(v, 1e-12)
    return torch.where(v.abs() < 1e-12, torch.where(v < 0, -tiny, tiny), v)


def hit_boxes(o: torch.Tensor, d: torch.Tensor, boxes: torch.Tensor
              ) -> torch.Tensor:
    """Nearest hit [N] of rays (o, d [N, 3]) with boxes [P, 7] (cx, cy, z0,
    z1, half_len, half_wid, yaw), +inf where none."""
    best = torch.full(o.shape[:1], float("inf"), dtype=o.dtype,
                      device=o.device)
    for s in range(0, boxes.shape[0], PRIM_CHUNK):
        b = boxes[s:s + PRIM_CHUNK]
        c, sn = torch.cos(b[:, 6]), torch.sin(b[:, 6])
        dx = o[:, None, 0] - b[None, :, 0]
        dy = o[:, None, 1] - b[None, :, 1]
        lx = c * dx + sn * dy
        ly = -sn * dx + c * dy
        lz = o[:, None, 2] - 0.5 * (b[None, :, 2] + b[None, :, 3])
        vx = _safe(c * d[:, None, 0] + sn * d[:, None, 1])
        vy = _safe(-sn * d[:, None, 0] + c * d[:, None, 1])
        vz = _safe(d[:, None, 2].expand_as(vx))
        hz = 0.5 * (b[None, :, 3] - b[None, :, 2])
        tn = torch.full_like(lx, -float("inf"))
        tf = torch.full_like(lx, float("inf"))
        for l, v, h in ((lx, vx, b[None, :, 4]), (ly, vy, b[None, :, 5]),
                        (lz, vz, hz)):
            t1 = (-h - l) / v
            t2 = (h - l) / v
            tn = torch.maximum(tn, torch.minimum(t1, t2))
            tf = torch.minimum(tf, torch.maximum(t1, t2))
        hit = (tn <= tf) & (tn > EPS_T)
        t = torch.where(hit, tn, torch.full_like(tn, float("inf")))
        best = torch.minimum(best, t.amin(1))
    return best


def hit_cylinders(o: torch.Tensor, d: torch.Tensor, cyl: torch.Tensor
                  ) -> torch.Tensor:
    """Nearest hit [N] with vertical cylinders [Q, 5] (cx, cy, r, z0, z1):
    the side and the top cap, +inf where none."""
    best = torch.full(o.shape[:1], float("inf"), dtype=o.dtype,
                      device=o.device)
    inf = float("inf")
    for s in range(0, cyl.shape[0], PRIM_CHUNK):
        q = cyl[s:s + PRIM_CHUNK]
        dx = o[:, None, 0] - q[None, :, 0]
        dy = o[:, None, 1] - q[None, :, 1]
        vx, vy, vz = d[:, None, 0], d[:, None, 1], d[:, None, 2]
        a = vx * vx + vy * vy
        b = 2.0 * (dx * vx + dy * vy)
        c = dx * dx + dy * dy - q[None, :, 2] ** 2
        disc = b * b - 4.0 * a * c
        ok = (disc >= 0) & (a > 1e-12)
        t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (
            2.0 * torch.clamp(a, min=1e-12))
        z = o[:, None, 2] + t * vz
        side = ok & (t > EPS_T) & (z >= q[None, :, 3]) & (z <= q[None, :, 4])
        t_side = torch.where(side, t, torch.full_like(t, inf))
        # the top cap, seen from above
        vzs = _safe(vz.expand_as(dx))
        tc = (q[None, :, 4] - o[:, None, 2]) / vzs
        cx = dx + tc * vx
        cy = dy + tc * vy
        cap = ((vz < 0) & (o[:, None, 2] > q[None, :, 4]) & (tc > EPS_T)
               & (cx * cx + cy * cy <= q[None, :, 2] ** 2))
        t_cap = torch.where(cap, tc, torch.full_like(tc, inf))
        best = torch.minimum(best, torch.minimum(t_side, t_cap).amin(1))
    return best


def hit_ground(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Hit [N] with the plane z = 0 from above, +inf where none."""
    t = -o[:, 2] / _safe(d[:, 2])
    return torch.where((d[:, 2] < 0) & (t > EPS_T), t,
                       torch.full_like(t, float("inf")))


def cast(o: torch.Tensor, d: torch.Tensor, boxes: torch.Tensor,
         cyl: torch.Tensor) -> torch.Tensor:
    """Depth [N] along unit directions d [N, 3] from origins o [N, 3]."""
    t = hit_ground(o, d)
    if boxes.shape[0]:
        t = torch.minimum(t, hit_boxes(o, d, boxes))
    if cyl.shape[0]:
        t = torch.minimum(t, hit_cylinders(o, d, cyl))
    return t
