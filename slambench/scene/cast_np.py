"""The ray caster of `scene/cast.py` in NumPy: the same closed forms, for
the CPU tests to hold the device caster to."""

from __future__ import annotations

import numpy as np

EPS_T = 1e-6


def _safe(v):
    tiny = np.full_like(v, 1e-12)
    return np.where(np.abs(v) < 1e-12, np.where(v < 0, -tiny, tiny), v)


def hit_boxes(o, d, boxes):
    c, sn = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    dx = o[:, None, 0] - boxes[None, :, 0]
    dy = o[:, None, 1] - boxes[None, :, 1]
    lx = c * dx + sn * dy
    ly = -sn * dx + c * dy
    lz = o[:, None, 2] - 0.5 * (boxes[None, :, 2] + boxes[None, :, 3])
    vx = _safe(c * d[:, None, 0] + sn * d[:, None, 1])
    vy = _safe(-sn * d[:, None, 0] + c * d[:, None, 1])
    vz = _safe(np.broadcast_to(d[:, None, 2], vx.shape))
    hz = 0.5 * (boxes[None, :, 3] - boxes[None, :, 2])
    tn = np.full(lx.shape, -np.inf)
    tf = np.full(lx.shape, np.inf)
    for l, v, h in ((lx, vx, boxes[None, :, 4]), (ly, vy, boxes[None, :, 5]),
                    (lz, vz, hz)):
        t1 = (-h - l) / v
        t2 = (h - l) / v
        tn = np.maximum(tn, np.minimum(t1, t2))
        tf = np.minimum(tf, np.maximum(t1, t2))
    hit = (tn <= tf) & (tn > EPS_T)
    return np.where(hit, tn, np.inf).min(1)


def hit_cylinders(o, d, cyl):
    dx = o[:, None, 0] - cyl[None, :, 0]
    dy = o[:, None, 1] - cyl[None, :, 1]
    vx, vy, vz = d[:, None, 0], d[:, None, 1], d[:, None, 2]
    a = vx * vx + vy * vy
    b = 2.0 * (dx * vx + dy * vy)
    c = dx * dx + dy * dy - cyl[None, :, 2] ** 2
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0) & (a > 1e-12)
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * np.maximum(a, 1e-12))
    z = o[:, None, 2] + t * vz
    side = ok & (t > EPS_T) & (z >= cyl[None, :, 3]) & (z <= cyl[None, :, 4])
    t_side = np.where(side, t, np.inf)
    vzs = _safe(np.broadcast_to(vz, dx.shape))
    tc = (cyl[None, :, 4] - o[:, None, 2]) / vzs
    cx = dx + tc * vx
    cy = dy + tc * vy
    cap = ((vz < 0) & (o[:, None, 2] > cyl[None, :, 4]) & (tc > EPS_T)
           & (cx * cx + cy * cy <= cyl[None, :, 2] ** 2))
    t_cap = np.where(cap, tc, np.inf)
    return np.minimum(t_side, t_cap).min(1)


def hit_ground(o, d):
    t = -o[:, 2] / _safe(d[:, 2])
    return np.where((d[:, 2] < 0) & (t > EPS_T), t, np.inf)


def cast(o, d, boxes, cyl):
    t = hit_ground(o, d)
    if boxes.shape[0]:
        t = np.minimum(t, hit_boxes(o, d, boxes))
    if cyl.shape[0]:
        t = np.minimum(t, hit_cylinders(o, d, cyl))
    return t
