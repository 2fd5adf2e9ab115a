"""The route a sensor travels and the town built along it (NumPy, host).

A traffic file fixes the route: straight pieces joined by 90-degree arcs
that turn left and right in turn, so the route never comes back to a
place, and the speed on straights and in turns. The traffic file's own
`layout_seed` draws a short catalogue of street widths, blocks and street
furniture; the run's seed draws where in each catalogue's cycle the town
starts. A run passes every catalogue several times, so every seed builds
its town of the same parts in the same cyclic order and the work per run
stays the same.

The town is made of three kinds of primitives, all closed-form for the ray
caster (`scene/cast.py`, `scene/cast_np.py`):

- boxes [cx, cy, z0, z1, half_len, half_wid, yaw]: façades, parked cars,
  benches;
- vertical cylinders [cx, cy, r, z0, z1]: poles and tree trunks;
- the ground plane z = 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

# catalogue sizes: a run's window passes each catalogue several times,
# so that every seed builds its town of the same parts in the same cyclic
# order, from another starting point
N_BLOCKS = 8
N_FURNITURE = 16
N_WIDTHS = 4


@dataclass
class Route:
    """Arc-length samples of the route: position [M, 2], heading [M],
    half-width of the street at that sample [M], and the sample spacing."""

    xy: np.ndarray
    heading: np.ndarray
    half_width: np.ndarray
    ds: float

    def at(self, s: np.ndarray):
        """Position [.., 2] and heading [..] at arc lengths s (linear
        interpolation between samples; headings do not wrap on this route,
        which only turns left and right in turn)."""
        s = np.asarray(s, np.float64)
        f = np.clip(s / self.ds, 0.0, self.xy.shape[0] - 1.000001)
        i = np.floor(f).astype(np.int64)
        a = (f - i)[..., None]
        xy = self.xy[i] * (1 - a) + self.xy[i + 1] * a
        b = a[..., 0]
        hd = self.heading[i] * (1 - b) + self.heading[i + 1] * b
        return xy, hd

    @property
    def length(self) -> float:
        return self.ds * (self.xy.shape[0] - 1)


def _pieces(route_cfg: dict, need_m: float):
    """(kind, length or angle, street index) pieces: straights from the
    traffic file's list (cycled until the route is `need_m` long), a 90
    degree arc between consecutive straights, left and right in turn."""
    straights = route_cfg["straights_m"]
    R = route_cfg["turn_radius_m"]
    out, total, k, sign = [], 0.0, 0, 1.0
    while total < need_m:
        L = float(straights[k % len(straights)])
        out.append(("straight", L, k))
        total += L
        out.append(("arc", sign * math.pi / 2, k))
        total += R * math.pi / 2
        sign = -sign
        k += 1
    return out


def build_route(traffic: dict, need_m: float, widths: List[float],
                ds: float = 0.05) -> Route:
    """The route's centreline, sampled every `ds` metres, at least
    `need_m` long; `widths[k]` is the width of street k."""
    rc = traffic["route"]
    R = rc["turn_radius_m"]
    x = y = th = 0.0
    xs, ys, hs, ws = [0.0], [0.0], [0.0], [widths[0] / 2]
    for kind, val, k in _pieces(rc, need_m + 50.0):
        hw_a = widths[k % len(widths)] / 2
        hw_b = widths[(k + 1) % len(widths)] / 2
        n = max(1, int(round((val if kind == "straight" else abs(val) * R)
                             / ds)))
        for j in range(1, n + 1):
            if kind == "straight":
                x += ds * math.cos(th)
                y += ds * math.sin(th)
                hw = hw_a
            else:
                dth = val / n
                # chord of the arc step, taken at the mid heading
                step = 2 * R * math.sin(abs(dth) / 2)
                x += step * math.cos(th + dth / 2)
                y += step * math.sin(th + dth / 2)
                th += dth
                hw = hw_a if j < n / 2 else hw_b
            xs.append(x)
            ys.append(y)
            hs.append(th)
            ws.append(hw)
    return Route(np.stack([xs, ys], -1), np.asarray(hs), np.asarray(ws), ds)


def frame_arclengths(traffic: dict, n_frames: int, route_len_hint: float,
                     start_m: float = 0.0):
    """Arc length of each frame's scan, from `start_m` on: from
    standstill over `start_frames`, then the straight speed on straights
    and the turn speed in arcs, eased over `speed_ramp_frames`. A driver
    slows down before a turn: the turn speed holds from
    `speed_ramp_frames` + 1 straight frames ahead of an arc on, so the
    heading turns at its steady rate from the arc's first frame."""
    rc = traffic["route"]
    R = rc["turn_radius_m"]
    v_st, v_tu = rc["speed_straight_m"], rc["speed_turn_m"]
    ramp = max(int(rc.get("speed_ramp_frames", 0)), 0)
    # where the arcs lie on the route
    arcs, s = [], 0.0
    for kind, val, _ in _pieces(rc, route_len_hint):
        L = val if kind == "straight" else abs(val) * R
        if kind == "arc":
            arcs.append((s, s + L))
        s += L

    look = (ramp + 1) * v_st

    def arc_near(s_):
        return any(s_ <= b and s_ + look >= a - 1e-9 for a, b in arcs)

    # a drive or walk starts from standstill, as recorded sequences do:
    # the speed eases in over `start_frames` (smoothstep)
    start = max(int(rc.get("start_frames", 0)), 0)
    s_list, v = [float(start_m)], v_st
    for i in range(n_frames):
        target = v_tu if arc_near(s_list[-1]) else v_st
        if i < start:
            u = (i + 1) / (start + 1)
            v = v_st * u * u * (3 - 2 * u)
        elif ramp and target != v:
            v = v + max(min(target - v, abs(v_st - v_tu) / ramp),
                        -abs(v_st - v_tu) / ramp)
        else:
            v = target
        s_list.append(s_list[-1] + v)
    return np.asarray(s_list[:-1])


def poses_at(route: Route, s: np.ndarray, height: float) -> np.ndarray:
    """Sensor poses [.., 4, 4] (x forward, y left, z up) at arc lengths s,
    `height` above the road."""
    xy, hd = route.at(s)
    T = np.zeros(np.shape(s) + (4, 4))
    c, sn = np.cos(hd), np.sin(hd)
    T[..., 0, 0], T[..., 0, 1] = c, -sn
    T[..., 1, 0], T[..., 1, 1] = sn, c
    T[..., 2, 2] = 1.0
    T[..., 3, 3] = 1.0
    T[..., 0, 3], T[..., 1, 3] = xy[..., 0], xy[..., 1]
    T[..., 2, 3] = height
    return T


def _catalogue(rng, spec: dict, n: int) -> np.ndarray:
    """n draws of each [lo, hi] range of `spec` (uniform), as columns."""
    return np.stack([rng.uniform(lo, hi, n) for lo, hi in spec], -1)


def build_town(traffic: dict, seed: int, need_m: float):
    """The route and the town along it. Returns (route, boxes [B, 7],
    cylinders [C, 5]). The traffic file's `layout_seed` draws the
    catalogues of street widths, buildings and furniture; `seed` draws
    where in each catalogue's cycle the route starts."""
    lay = np.random.default_rng(int(traffic["layout_seed"]))
    run = np.random.default_rng(int(seed))
    st = traffic["street"]
    # street widths: one range, or a list of ranges that the streets take
    # in turn (a walk's lanes and quads)
    ranges = st["width_m"]
    if not isinstance(ranges[0], list):
        ranges = [ranges]
    n_cat = N_WIDTHS
    cats = [np.roll(lay.uniform(lo, hi, n_cat), run.integers(n_cat))
            for lo, hi in ranges]
    widths = [float(cats[k % len(cats)][(k // len(cats)) % n_cat])
              for k in range(n_cat * len(cats))]
    route = build_route(traffic, need_m, widths)

    # façades: one catalogue of (length, setback, depth, height, gap)
    bcat = _catalogue(lay, [st["length_m"], st["setback_m"], st["depth_m"],
                            st["height_m"], st["gap_m"]], N_BLOCKS)
    bcat = np.roll(bcat, run.integers(N_BLOCKS), axis=0)
    fu = traffic["furniture"]
    nf = N_FURNITURE
    shift = run.integers(nf)
    fcat_gap = np.roll(lay.uniform(*fu["every_m"], nf), shift)
    fcat_kind = np.roll(lay.uniform(0.0, 1.0, nf), shift)
    fcat_size = np.roll(lay.uniform(0.0, 1.0, (nf, 3)), shift, axis=0)

    boxes, cyls = [], []
    s_total = route.length
    bi = fi = 0
    for side in (1.0, -1.0):
        # façades: walk along the route on this side
        s = 0.0
        while s < s_total:
            L, setback, depth, height, gap = bcat[bi % bcat.shape[0]]
            bi += 1
            sm = s + L / 2
            xy, hd = route.at(np.array([sm]))
            xy, hd = xy[0], hd[0]
            hw = float(route.half_width[min(int(sm / route.ds),
                                            route.xy.shape[0] - 1)])
            off = hw + setback + depth / 2
            nx, ny = -math.sin(hd) * side, math.cos(hd) * side
            boxes.append([xy[0] + nx * off, xy[1] + ny * off, 0.0, height,
                          L / 2, depth / 2, hd])
            s += L + gap
        # furniture at the curb: poles, tree trunks and parked cars
        s = 0.0
        while s < s_total:
            g = fcat_gap[fi % nf]
            kind = fcat_kind[fi % nf]
            u = fcat_size[fi % nf]
            fi += 1
            s += g
            xy, hd = route.at(np.array([s]))
            xy, hd = xy[0], hd[0]
            hw = float(route.half_width[min(int(s / route.ds),
                                            route.xy.shape[0] - 1)])
            nx, ny = -math.sin(hd) * side, math.cos(hd) * side
            curb = hw + fu["curb_offset_m"]
            if "lateral_m" in fu:
                # scattered across the street or square, not only at the
                # curb (a walk's quads hold trees and benches)
                lo_, hi_ = fu["lateral_m"]
                curb = min(curb, lo_ + u[2] * (hi_ - lo_))
            if kind < fu["pole_share"]:
                r = fu["pole_radius_m"][0] + u[0] * (
                    fu["pole_radius_m"][1] - fu["pole_radius_m"][0])
                h = fu["pole_height_m"][0] + u[1] * (
                    fu["pole_height_m"][1] - fu["pole_height_m"][0])
                off = curb
                cyls.append([xy[0] + nx * off, xy[1] + ny * off, r, 0.0, h])
            elif kind < fu["pole_share"] + fu["trunk_share"]:
                r = fu["trunk_radius_m"][0] + u[0] * (
                    fu["trunk_radius_m"][1] - fu["trunk_radius_m"][0])
                h = fu["trunk_height_m"][0] + u[1] * (
                    fu["trunk_height_m"][1] - fu["trunk_height_m"][0])
                off = curb + 0.5
                cyls.append([xy[0] + nx * off, xy[1] + ny * off, r, 0.0, h])
            else:
                bl, bw, bh = fu["box_size_m"]
                sc = 0.8 + 0.4 * u
                off = min(hw, curb) - bw * sc[1] / 2 - 0.3
                boxes.append([xy[0] + nx * off, xy[1] + ny * off, 0.0,
                              bh * sc[2], bl * sc[0] / 2, bw * sc[1] / 2, hd])
    boxes = np.asarray(boxes, np.float64)
    cyls = np.asarray(cyls, np.float64)
    boxes, cyls = _clear_route(route, boxes, cyls,
                               traffic["street"].get("clearance_m", 1.0),
                               fu.get("path_clear_m"))
    return route, boxes, cyls


def _clear_route(route: Route, boxes: np.ndarray, cyls: np.ndarray,
                 margin: float, path_clear: Optional[float] = None):
    """Drop what stands in the way of the route: a façade closer to any
    centreline sample than that street's half width (façades of one street
    that reach into the next street's corridor at a corner), a pole or
    trunk closer than the half width less `margin` (they stand at the
    curb), and a parked car or bench closer than `margin` + 1 m to the
    centreline (they stand inside the street, at its edge). Where the
    furniture is scattered across the street (`path_clear`), a pole or
    trunk only has to keep that far from the centreline."""
    pts = route.xy[::10]
    hw = route.half_width[::10]

    def box_dist(b):
        out = np.empty((b.shape[0], pts.shape[0]))
        for s in range(0, b.shape[0], 256):
            bb = b[s:s + 256]
            d = pts[None, :, :] - bb[:, None, :2]
            c, sn = np.cos(bb[:, 6])[:, None], np.sin(bb[:, 6])[:, None]
            u = np.abs(c * d[..., 0] + sn * d[..., 1]) - bb[:, 4][:, None]
            v = np.abs(-sn * d[..., 0] + c * d[..., 1]) - bb[:, 5][:, None]
            out[s:s + 256] = np.hypot(np.maximum(u, 0), np.maximum(v, 0))
        return out

    facade = boxes[:, 3] > 4.0       # cars and benches are low
    need = np.where(facade[:, None], hw[None, :], margin + 1.0)
    kb = (box_dist(boxes) >= need).all(1)
    d = np.linalg.norm(pts[None, :, :] - cyls[:, None, :2], axis=-1) \
        - cyls[:, 2][:, None]
    need_c = hw[None, :] - margin
    if path_clear is not None:
        need_c = np.minimum(need_c, path_clear)
    kc = (d >= need_c).all(1)
    return boxes[kb], cyls[kc]
