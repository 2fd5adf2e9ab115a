"""Deterministic scatters.

JAX's `x.at[idx].set(v)` lets the last update win where indices repeat (on
the CPU backend the reference is tested on), and several map operations
rely on that. `index_put_` leaves the winner of a repeated index unspecified
on CUDA, so where repeats can occur the port resolves them explicitly: the
update with the highest position wins.

A float `index_add_` on CUDA sums repeated indices with atomics, in an order
that changes from run to run, and the track+map loop amplifies those last
bits (Adam divides a gradient by its own magnitude) into centimetres of pose
within a few frames. `index_add_exact` sums in 64-bit fixed point instead:
integer addition is associative, so the result is the same in any order.
"""

from __future__ import annotations

import torch

# the largest |value| is scaled to just below 2**FIXED_BITS, which leaves
# room for 2**(62 - FIXED_BITS) = 2**23 repeats of one index
FIXED_BITS = 39


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


def index_add_exact(dst: torch.Tensor, idx: torch.Tensor,
                    src: torch.Tensor) -> torch.Tensor:
    """Out-of-place `dst.index_add(0, idx, src)` whose sums do not depend on
    the order of the additions. Each value is rounded to a multiple of
    2**-FIXED_BITS of the largest |value| in `src` (finer than float32
    keeps a partial sum), the repeats are summed as int64, and the sum is
    rounded once to `dst`'s type and added to `dst`."""
    if src.numel() == 0:
        return dst.clone()
    _, exp = torch.frexp(src.detach().abs().amax().to(torch.float64))
    scale = torch.ldexp(torch.ones((), dtype=torch.float64,
                                   device=src.device), FIXED_BITS - exp)
    fixed = torch.round(src.to(torch.float64) * scale).to(torch.int64)
    acc = torch.zeros(dst.shape, dtype=torch.int64, device=dst.device)
    acc.index_add_(0, idx, fixed)
    return dst + (acc.to(torch.float64) / scale).to(dst.dtype)
