"""Range-image scan normals and the incidence cosine. Port of
`pin_slam_tpu/ops/range_image.py`.

The incidence-weighted projective labels (`incidence_label_on`) scale a
sample's along-ray label by the geometric |cos| of its ray's incidence
angle. The angle comes from scan-local normals of a spherical range image
built from the scan itself, so the correction does not depend on the state
of the training.
"""

from __future__ import annotations

import math

import torch


def estimate_scan_incidence(
    points: torch.Tensor,      # [N, 3] sensor-frame points
    mask: torch.Tensor,        # [N] valid rows
    *,
    n_az: int = 512,
    n_el: int = 64,
    range_gate_m: float = 0.5,
    cos_floor: float = 0.1,
) -> torch.Tensor:
    """Per-point |cos| of the angle between the ray and the local surface
    normal, in [cos_floor, 1]:

    1. bin the scan into an az x el spherical grid keeping the MIN range
       per bin (an order-free scatter-min);
    2. inpaint isolated holes from the azimuth neighbours, and place a
       point per bin at the bin-centre direction times its range;
    3. normals from the cross product of the azimuth (wrapping) and
       elevation (clamped) central differences;
    4. each point reads its bin's normal; a point farther than
       `range_gate_m` from the bin's tangent plane, or whose bin
       neighbourhood is incomplete, keeps cos = 1 (no correction).

    atan2 and asin round differently in torch and XLA, so a point on a bin
    edge may fall into the neighbouring bin."""
    dev = points.device
    n_bins = n_el * n_az
    r = torch.linalg.norm(points, dim=1)
    safe_r = torch.clamp(r, min=1e-6)
    valid = mask & (r > 1e-6)

    az = torch.atan2(points[:, 1], points[:, 0])             # [-pi, pi]
    el = torch.asin(torch.clamp(points[:, 2] / safe_r, -1.0, 1.0))
    big = 1e9
    el_lo = torch.where(valid, el, torch.full_like(el, big)).min()
    el_hi = torch.where(valid, el, torch.full_like(el, -big)).max()
    el_span = torch.clamp(el_hi - el_lo, min=1e-4)

    ia = torch.clamp(((az + math.pi) / (2.0 * math.pi) * n_az).to(
        torch.int64), 0, n_az - 1)
    ie = torch.clamp(((el - el_lo) / el_span * n_el).to(torch.int64),
                     0, n_el - 1)
    bins = ie * n_az + ia

    grid_r = torch.full((n_bins + 1,), big, device=dev)
    grid_r.scatter_reduce_(
        0, torch.where(valid, bins, torch.full_like(bins, n_bins)),
        torch.where(valid, r, torch.full_like(r, big)), reduce="amin")
    grid_r = grid_r[:-1].reshape(n_el, n_az)
    # inpaint isolated holes (dropouts, azimuth-binning collisions) from
    # the azimuth neighbours, else the differences below would knock out a
    # 3-bin stripe per hole
    r_l, r_rt = torch.roll(grid_r, 1, 1), torch.roll(grid_r, -1, 1)
    ok_l, ok_rt = r_l < big, r_rt < big
    fill = torch.where(ok_l & ok_rt, 0.5 * (r_l + r_rt),
                       torch.where(ok_l, r_l, r_rt))
    hole = ~(grid_r < big) & (ok_l | ok_rt)
    grid_r = torch.where(hole, fill, grid_r)

    # bin-centre directions
    az_c = ((torch.arange(n_az, device=dev) + 0.5) / n_az * 2.0 * math.pi
            - math.pi)
    el_c = el_lo + (torch.arange(n_el, device=dev) + 0.5) / n_el * el_span
    ce, se = torch.cos(el_c), torch.sin(el_c)
    ca, sa = torch.cos(az_c), torch.sin(az_c)
    dirs = torch.stack([ce[:, None] * ca[None, :], ce[:, None] * sa[None, :],
                        se[:, None].expand(n_el, n_az)], -1)
    grid_ok = grid_r < big
    pgrid = dirs * torch.where(grid_ok, grid_r,
                               torch.zeros_like(grid_r))[..., None]

    # central differences: azimuth wraps, elevation clamps to the edge
    p_a1 = torch.roll(pgrid, -1, dims=1)
    p_a0 = torch.roll(pgrid, 1, dims=1)
    ok_a = torch.roll(grid_ok, -1, dims=1) & torch.roll(grid_ok, 1, dims=1)
    rows = torch.arange(n_el, device=dev)
    idx_up = torch.clamp(rows + 1, max=n_el - 1)
    idx_dn = torch.clamp(rows - 1, min=0)
    p_e1, p_e0 = pgrid[idx_up], pgrid[idx_dn]
    ok_e = grid_ok[idx_up] & grid_ok[idx_dn]

    nrm = torch.linalg.cross(p_a1 - p_a0, p_e1 - p_e0, dim=-1)
    nlen = torch.linalg.norm(nrm, dim=-1)
    n_ok = grid_ok & ok_a & ok_e & (nlen > 1e-9)
    nrm = nrm / torch.clamp(nlen, min=1e-9)[..., None]

    # per-point cosine against its bin's normal
    bin_n = nrm.reshape(-1, 3)[bins]
    bin_ok = n_ok.reshape(-1)[bins]
    bin_p = pgrid.reshape(-1, 3)[bins]
    cos = torch.abs(torch.sum(bin_n * (points / safe_r[:, None]), dim=-1))
    # same-surface test: the distance to the bin's tangent plane (robust at
    # grazing incidence, where the range varies past the gate within a bin)
    d_plane = torch.abs(torch.sum((points - bin_p) * bin_n, dim=-1))
    use = valid & bin_ok & (d_plane <= range_gate_m)
    return torch.where(use, torch.clamp(cos, min=cos_floor),
                       torch.ones_like(cos))
