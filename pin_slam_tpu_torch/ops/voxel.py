"""Deterministic, static-shape voxel downsampling. Port of
`pin_slam_tpu/ops/voxel.py` (the masks the slice uses).

All functions take and return fixed-shape tensors with validity masks.
"""

from __future__ import annotations

import torch

from pin_slam_tpu_torch.ops import hash3d
from pin_slam_tpu_torch.ops.scatter import last_writer

_GRID_SENTINEL = 2 ** 30


def _lexsort(keys) -> torch.Tensor:
    """Permutation sorting rows by keys[0], then keys[1], ... (all keys
    ascending; the original index breaks remaining ties), like a multi-key
    `lax.sort`: stable sorts from the least significant key up."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in reversed(keys):
        order = torch.argsort(k[perm], stable=True)
        perm = perm[order]
    return perm


def voxel_down_sample_min_value_mask(points: torch.Tensor,
                                     mask: torch.Tensor,
                                     voxel_size: float,
                                     value: torch.Tensor) -> torch.Tensor:
    """Keep, per occupied voxel, the valid point with the smallest `value`
    (ties broken by index)."""
    n = points.shape[0]
    grid = hash3d.grid_coords(points, voxel_size)
    grid = torch.where(mask[:, None], grid,
                       torch.full_like(grid, _GRID_SENTINEL))
    value = torch.where(mask, value.to(torch.float32),
                        torch.full_like(value, float("inf"),
                                        dtype=torch.float32))
    perm = _lexsort([grid[:, 0], grid[:, 1], grid[:, 2], value])
    sg = grid[perm]
    first = torch.ones(n, dtype=torch.bool, device=points.device)
    first[1:] = (sg[1:] != sg[:-1]).any(dim=1)
    keep_sorted = first & (sg[:, 0] != _GRID_SENTINEL)
    keep = torch.zeros(n, dtype=torch.bool, device=points.device)
    keep[perm] = keep_sorted
    return keep


def voxel_down_sample_hash_mask(points: torch.Tensor, mask: torch.Tensor,
                                voxel_size: float,
                                table_size: int) -> torch.Tensor:
    """Keep one valid point per occupied voxel hash slot: the LAST valid
    point that hashes to the slot (the JAX reference's scatter order).
    table_size must be a power of two."""
    h = hash3d.hash_grid(hash3d.grid_coords(points, voxel_size), table_size)
    h = torch.where(mask, h, torch.full_like(h, table_size))
    return last_writer(h, table_size + 1) & mask


def compact_mask(mask: torch.Tensor, cap: int):
    """Destination slots packing `mask`-selected rows to the front.
    Returns (dest [N] int64 with `cap` for dropped rows, count scalar)."""
    order = torch.cumsum(mask.to(torch.int64), 0) - 1
    keep = mask & (order < cap)
    dest = torch.where(keep, order, torch.full_like(order, cap))
    return dest, keep.sum()


def compact_rows(mask: torch.Tensor, cap: int, fill: int) -> torch.Tensor:
    """Row ids of the first `cap` True entries of `mask`, in order, padded
    with `fill` ([cap] i64)."""
    dest, _ = compact_mask(mask, cap)
    out = torch.full((cap + 1,), fill, dtype=torch.int64, device=mask.device)
    out[dest] = torch.arange(mask.shape[0], device=mask.device)
    return out[:cap]     # row `cap` collected the dropped rows
