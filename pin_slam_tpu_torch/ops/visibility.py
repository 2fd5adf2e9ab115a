"""Multi-viewpoint map-visibility test for dynamic-measurement filtering.
Port of `pin_slam_tpu/ops/visibility.py`.

The map-based dynamic filter flags a measurement as dynamic when the map
decodes CONFIDENT positive SDF at its location, which only works near
mapped surfaces: a mover crossing open space has no neural points within
query radius, so its certainty is 0 and the filter keeps it. This test
complements it: render the neural-point map as a min-range spherical image
from a few HISTORICAL sensor origins; a measurement that, seen from one of
those origins, lies well inside the origin's observable range AND clearly
in front of every mapped surface in its direction bin sits in space that
past scans saw through, so it is dynamic.

Every quantisation bias points toward "static":
  * scatter-MIN per bin + 3x3 min-dilation: the rendered range is a lower
    bound of the surface range in the bin neighbourhood;
  * empty bins render +inf = UNJUDGEABLE (frontier geometry is kept);
  * range and elevation gates: a location a historic origin could not have
    observed is never judged from that origin;
  * historical (not current) origins: geometry revealed for the first time
    this frame was occluded from the historic viewpoints and renders behind
    the occluder's range.

The per-bin minimum is an `amin` scatter, which is order-free, so the image
is the same on every run. A point within float rounding of a bin edge may
land one bin over in another package or on another device (atan2 and asin
round differently); the dilation makes a neighbouring bin's range count
either way.
"""

from __future__ import annotations

import math

import torch

BIG = 3.0e38


def _spherical_bins(d: torch.Tensor, r: torch.Tensor, n_az: int, n_el: int,
                    el_lo, el_hi):
    """World-frame direction bins around an origin. Returns (bin ids [N],
    in-FOV mask [N]). `d` = points - origin, `r` = |d|."""
    safe_r = torch.clamp(r, min=1e-6)
    az = torch.atan2(d[:, 1], d[:, 0])
    el = torch.asin(torch.clamp(d[:, 2] / safe_r, -1.0, 1.0))
    in_fov = (el >= el_lo) & (el <= el_hi)
    ia = torch.clamp(((az + math.pi) / (2.0 * math.pi) * n_az).to(torch.int64),
                     0, n_az - 1)
    span = torch.clamp(torch.as_tensor(el_hi - el_lo, device=d.device),
                       min=1e-4)
    ie = torch.clamp(((el - el_lo) / span * n_el).to(torch.int64),
                     0, n_el - 1)
    return ie * n_az + ia, in_fov


def render_min_range_bins(
    origins: torch.Tensor,     # [H, 3] world-frame sensor origins
    pts: torch.Tensor,         # [M, 3] map (neural point) positions, world
    pt_valid: torch.Tensor,    # [M] bool: live, certainty-gated rows
    *,
    n_az: int = 512,
    n_el: int = 64,
    el_lo=-0.7,
    el_hi=0.7,
) -> torch.Tensor:
    """Min range per direction bin per origin, 3x3 min-dilated.
    Returns [H, n_el, n_az] float32, BIG where no map point projects."""
    dev = pts.device
    nb = n_el * n_az
    up = torch.clamp(torch.arange(n_el, device=dev) + 1, max=n_el - 1)
    dn = torch.clamp(torch.arange(n_el, device=dev) - 1, min=0)
    imgs = []
    for o in origins:
        d = pts - o
        r = torch.linalg.norm(d, dim=1)
        bins, in_fov = _spherical_bins(d, r, n_az, n_el, el_lo, el_hi)
        ok = pt_valid & in_fov & (r > 1e-3)
        img = torch.full((nb + 1,), BIG, dtype=torch.float32, device=dev)
        img.scatter_reduce_(0, torch.where(ok, bins, torch.full_like(bins, nb)),
                            torch.where(ok, r, torch.full_like(r, BIG)),
                            reduce="amin")
        img = img[:-1].reshape(n_el, n_az)
        # azimuth wraps, elevation clamps
        img = torch.minimum(img, torch.minimum(torch.roll(img, 1, 1),
                                               torch.roll(img, -1, 1)))
        img = torch.minimum(img, torch.minimum(img[up], img[dn]))
        imgs.append(img)
    return torch.stack(imgs)


def visibility_free_mask(
    origins: torch.Tensor,      # [H, 3]
    range_img: torch.Tensor,    # [H, n_el, n_az] from render_min_range_bins
    q: torch.Tensor,            # [N, 3] world-frame measurements
    q_mask: torch.Tensor,       # [N] rows to judge
    *,
    margin_m: float = 0.4,
    rel_margin: float = 0.05,
    min_judge_range: float = 1.0,
    max_judge_range: float = 22.0,
    el_lo=-0.7,
    el_hi=0.7,
    el_slack: float = 0.035,
    min_votes: int = 2,
) -> torch.Tensor:
    """[N] bool: True where at least `min_votes` origins judge the
    measurement seen-through (free), i.e. dynamic. Unjudgeable rows never
    vote, so they stay static."""
    H, n_el, n_az = range_img.shape
    votes = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    for o, img in zip(origins, range_img):
        d = q - o
        r = torch.linalg.norm(d, dim=1)
        bins, _ = _spherical_bins(d, r, n_az, n_el, el_lo, el_hi)
        safe_r = torch.clamp(r, min=1e-6)
        el = torch.asin(torch.clamp(d[:, 2] / safe_r, -1.0, 1.0))
        rmap = img.reshape(-1)[bins]
        margin = torch.clamp(rel_margin * r, min=margin_m)
        free = (q_mask
                & (r > min_judge_range) & (r < max_judge_range)
                & (el > el_lo + el_slack) & (el < el_hi - el_slack)
                & (rmap < BIG)
                & (r < rmap - margin))
        votes += free.to(torch.int32)
    return votes >= min(min_votes, H)
