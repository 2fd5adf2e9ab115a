"""Deterministic scatters.

JAX's `x.at[idx].set(v)` lets the last update win where indices repeat (on
the CPU backend the reference is tested on), and several map operations
rely on that. `index_put_` leaves the winner of a repeated index unspecified
on CUDA, so where repeats can occur the port resolves them explicitly: the
update with the highest position wins.
"""

from __future__ import annotations

import torch


def last_writer(idx: torch.Tensor, size: int) -> torch.Tensor:
    """[M] bool: True for the last occurrence of each index in `idx`."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    best = torch.full((size,), -1, dtype=pos.dtype, device=idx.device)
    best.scatter_reduce_(0, idx, pos, reduce="amax")
    return best[idx] == pos


def scatter_set_last(dst: torch.Tensor, idx: torch.Tensor,
                     src: torch.Tensor) -> torch.Tensor:
    """Out-of-place `dst.at[idx].set(src)` with last-writer-wins semantics."""
    keep = last_writer(idx, dst.shape[0])
    out = dst.clone()
    out[idx[keep]] = src[keep]
    return out
