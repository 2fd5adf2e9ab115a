"""Per-ray training-sample generation. Port of
`pin_slam_tpu/models/sampler.py`.

For each measured endpoint: 1 exact endpoint + `surface_sample_n` Gaussian
close-to-surface samples + `free_front_n` uniform free-space samples in
front + `free_behind_n` uniform samples behind the surface, with projective
SDF labels (positive in front of the surface) and distance weights whose
sign marks surface (+) vs free space (-). The endpoint and the surface
samples carry the point's semantic label and colour; the free-space samples
carry label 0 (unlabeled) and colour 0. With the incidence cosine of each
ray (`ops/range_image.py`), the free-space columns' labels ("label") or
loss weights ("weight") are scaled by it; the surface band never is. Output
is ray-major [N*A].
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class Samples(NamedTuple):
    points: torch.Tensor      # [N*A, 3] sample coords (sensor frame)
    sdf_label: torch.Tensor   # [N*A] projective SDF labels (m)
    weight: torch.Tensor      # [N*A] signed weights
    mask: torch.Tensor        # [N*A] validity
    sem_label: Optional[torch.Tensor] = None    # [N*A] i32 or None
    color_label: Optional[torch.Tensor] = None  # [N*A, C] or None


def draw_sample_noise(generator: torch.Generator, n: int, surface_n: int,
                      front_n: int, behind_n: int, device=None):
    """The random draws of `sample_training_points`: (N(0,1) [n, surface_n],
    U[0,1) [n, front_n], U[0,1) [n, behind_n]). The generator must live on
    `device`."""
    return (torch.randn((n, surface_n), generator=generator, device=device),
            torch.rand((n, front_n), generator=generator, device=device),
            torch.rand((n, behind_n), generator=generator, device=device))


def sample_training_points(
    generator: Optional[torch.Generator],
    points: torch.Tensor,          # [N, 3] in sensor frame
    mask: torch.Tensor,            # [N]
    *,
    surface_sample_range_m: float,
    surface_sample_n: int,
    free_front_n: int,
    free_behind_n: int,
    free_sample_begin_ratio: float,
    free_sample_end_dist_m: float,
    max_range: float,
    dist_weight_on: bool,
    dist_weight_scale: float,
    behind_dropoff_on: bool = False,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    sem_labels: Optional[torch.Tensor] = None,    # [N] int
    colors: Optional[torch.Tensor] = None,        # [N, C]
    cos_inc: Optional[torch.Tensor] = None,       # [N] |cos(incidence)|
    incidence_mode: str = "label",
) -> Samples:
    """The random draws come from `generator` (see `draw_sample_noise`)
    unless `noise` hands them over, as the parity tests do."""
    n = points.shape[0]
    s_n = surface_sample_n
    a = 1 + s_n + free_front_n + free_behind_n
    if noise is None:
        noise = draw_sample_noise(generator, n, s_n, free_front_n,
                                  free_behind_n, device=points.device)
    surf_n01, front_u, behind_u = noise
    sigma_ratio = 2.0
    dev = points.device

    dist = torch.linalg.norm(points, dim=1)
    safe_dist = torch.clamp(dist, min=1e-6)

    surf_disp = surf_n01 * surface_sample_range_m
    surf_ratio = surf_disp / safe_dist[:, None] + 1.0

    # scalar / tensor as a true division (torch's `c / t` multiplies by the
    # reciprocal, one rounding more than the JAX package's)
    def over_dist(c: float) -> torch.Tensor:
        return torch.full_like(safe_dist, c) / safe_dist

    front_max_ratio = 1.0 - over_dist(sigma_ratio * surface_sample_range_m)
    front_ratio = (front_u * (front_max_ratio - free_sample_begin_ratio)[:, None]
                   + free_sample_begin_ratio)
    front_disp = (front_ratio - 1.0) * safe_dist[:, None]

    behind_min_ratio = 1.0 + over_dist(sigma_ratio * surface_sample_range_m)
    behind_max_ratio = over_dist(free_sample_end_dist_m) + 1.0
    behind_ratio = (behind_u * (behind_max_ratio - behind_min_ratio)[:, None]
                    + behind_min_ratio[:, None])
    behind_disp = (behind_ratio - 1.0) * safe_dist[:, None]

    ones = torch.ones((n, 1), device=dev)
    ratio = torch.cat([ones, surf_ratio, front_ratio, behind_ratio], dim=1)
    disp = torch.cat([torch.zeros((n, 1), device=dev), surf_disp,
                      front_disp, behind_disp], dim=1)
    sample_pts = points[:, None, :] * ratio[..., None]       # [N, A, 3]

    weight = torch.ones((n, a), device=dev)
    if dist_weight_on:
        dist_w = (1.0 + dist_weight_scale * 0.5
                  - (dist / max_range) * dist_weight_scale)
        weight[:, : 1 + s_n] *= dist_w[:, None]
    if behind_dropoff_on:
        dropoff_min = 0.2 * free_sample_end_dist_m
        dropoff_max = free_sample_end_dist_m
        dw = (dropoff_max - disp) / (dropoff_max - dropoff_min)
        weight = weight * (torch.clamp(dw, 0.0, 1.0) * 0.8 + 0.2)
    weight[:, 1 + s_n:] *= -1.0
    sdf_label = -disp
    if cos_inc is not None:
        # free-space columns only: the surface band's labels are symmetric
        # about the endpoint, so its zero crossing is unbiased either way
        scale = torch.ones((n, a), device=dev)
        scale[:, 1 + s_n:] = cos_inc[:, None]
        if incidence_mode == "weight":
            weight = weight * scale
        else:
            sdf_label = sdf_label * scale

    sem_out = None
    if sem_labels is not None:
        sem = torch.zeros((n, a), dtype=torch.int32, device=dev)
        sem[:, : 1 + s_n] = sem_labels[:, None].to(torch.int32)
        sem_out = sem.reshape(-1)
    color_out = None
    if colors is not None:
        cc = colors.shape[1]
        col = torch.zeros((n, a, cc), dtype=colors.dtype, device=dev)
        col[:, : 1 + s_n, :] = colors[:, None, :]
        color_out = col.reshape(-1, cc)

    mask_out = mask[:, None].expand(n, a).reshape(-1)
    return Samples(points=sample_pts.reshape(-1, 3),
                   sdf_label=sdf_label.reshape(-1),
                   weight=weight.reshape(-1), mask=mask_out,
                   sem_label=sem_out, color_label=color_out)
