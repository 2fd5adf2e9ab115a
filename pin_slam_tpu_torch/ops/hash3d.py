"""Spatial voxel hashing. Port of `pin_slam_tpu/ops/hash3d.py`.

The same prime-multiply-sum hash in wrap-around 32-bit arithmetic into a
power-of-two table. torch has no usable uint32 multiply, so the coordinates
are taken modulo 2^32 in int64: each product stays below 2^59 and the sum
below 2^61, and masking with `table_size - 1` (a power of two <= 2^32)
gives exactly the uint32 result.
"""

from __future__ import annotations

import torch

P1 = 73856093
P2 = 19349669
P3 = 83492791
_U32 = 0xFFFFFFFF


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s rounded as IEEE division. CUDA divides by a Python scalar as
    a multiply by its reciprocal, which can differ by one ulp and move a
    point across a voxel boundary; a 0-dim device tensor divisor cannot."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def grid_coords(points: torch.Tensor, resolution: float) -> torch.Tensor:
    """[..., 3] float -> [..., 3] int32 voxel coordinates."""
    return torch.floor(true_div(points, resolution)).to(torch.int32)


def hash_grid(grid: torch.Tensor, table_size: int) -> torch.Tensor:
    """[..., 3] int32 grid coords -> [...] int64 slot in [0, table_size).
    table_size must be a power of two."""
    u = grid.to(torch.int64) & _U32
    h = u[..., 0] * P1 + u[..., 1] * P2 + u[..., 2] * P3
    return h & (table_size - 1)


def max_valid_dist2(num_nei_cells: int, resolution: float) -> float:
    """Distance-squared bound for a valid neighbor."""
    return 3.0 * ((num_nei_cells + 1) * resolution) ** 2


def neighbor_offsets_max_r2(num_nei_cells: int, search_alpha: float) -> int:
    """Largest squared cell offset of the sphere-pruned neighborhood
    ({o : |o| < num_nei_cells + search_alpha}), which sets the join probe's
    radius bound."""
    r = torch.arange(-num_nei_cells, num_nei_cells + 1, dtype=torch.float64)
    d2 = (r[:, None, None] ** 2 + r[None, :, None] ** 2
          + r[None, None, :] ** 2)
    return int(d2[d2 < (num_nei_cells + search_alpha) ** 2].max())
