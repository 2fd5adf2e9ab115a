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
# a destination element whose largest |value| v has a binary exponent at
# least FIXED_BITS - 24 + 1 below the largest's keeps v / quantum < 2**23
# under the one scale: fewer than float32's 24 significant bits
SMALL_EXPONENT_GAP = FIXED_BITS - 24


def last_writer(idx: torch.Tensor, size: int) -> torch.Tensor:
    """[M] bool: True for the last occurrence of each index in `idx`."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    best = torch.full((size,), -1, dtype=pos.dtype, device=idx.device)
    best.scatter_reduce_(0, idx, pos, reduce="amax")
    return best[idx] == pos


def set_last_(dst: torch.Tensor, idx: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
    """In place `dst[idx] = src` where the last occurrence of a repeated
    index wins, with no host sync and no `dst`-sized scratch: every repeat
    writes the value of its run's last occurrence (a stable sort groups the
    runs), so the unordered writes of `index_put_` all agree."""
    n = idx.shape[0]
    order = torch.argsort(idx, stable=True)
    s = idx[order]
    pos = torch.arange(n, device=idx.device)
    run_end = torch.ones(n, dtype=torch.bool, device=idx.device)
    run_end[:-1] = s[1:] != s[:-1]
    last = torch.where(run_end, pos, torch.full_like(pos, n))
    last = torch.cummin(last.flip(0), 0).values.flip(0)
    dst[s] = src[order[last]]
    return dst


def _frexp_exponent(top: torch.Tensor) -> torch.Tensor:
    """e with top = m * 2**e, m in [0.5, 1) (frexp's convention), from the
    float64 exponent bits; a top of 0 takes e = 0. In place on one int64
    copy (the map-sized calls hold no more)."""
    e = top.view(torch.int64) >> 52
    return e.sub_(1022).masked_fill_(top <= 0, 0)


def _fixed_scales(e: torch.Tensor):
    """(2**(FIXED_BITS - e), its inverse) as float64."""
    return (((1023 + FIXED_BITS - e) << 52).view(torch.float64),
            ((1023 - FIXED_BITS + e) << 52).view(torch.float64))


def _fixed_sum(shape, idx, scaled, keep=None):
    """The int64 sums of round(scaled) per destination, over the inputs
    `keep` selects (all by default). `scaled` (float64 values times their
    scale) is rounded in place."""
    if keep is not None:
        scaled.masked_fill_(~keep, 0.0)
    fixed = scaled.round_().to(torch.int64)
    acc = torch.zeros(shape, dtype=torch.int64, device=scaled.device)
    acc.index_add_(0, idx, fixed)
    return acc


def index_add_exact(dst: torch.Tensor, idx: torch.Tensor,
                    src: torch.Tensor,
                    per_destination: bool = False) -> torch.Tensor:
    """Out-of-place `dst.index_add(0, idx, src)` whose sums do not depend on
    the order of the additions. Each value is rounded to a multiple of
    2**-FIXED_BITS of the largest |value| in `src` (finer than float32
    keeps a partial sum), the repeats are summed as int64, and the sum is
    rounded once to `dst`'s type and added to `dst`.

    That one scale gives a destination element whose largest |value| has a
    binary exponent more than SMALL_EXPONENT_GAP below the largest's fewer
    than float32's 24 bits of it (and sums below 2**-FIXED_BITS of the
    largest become 0), so those elements, and only those, are summed again
    with their own scale: the largest |value| landing on each (an
    order-free `amax` scatter). With `per_destination` every destination
    element takes its own scale, and only the touched rows are written."""
    if src.numel() == 0:
        return dst.clone()
    src64 = src.detach().to(torch.float64)
    top_d = torch.zeros(dst.shape, dtype=torch.float64, device=dst.device)
    top_d.scatter_reduce_(
        0, idx.view(-1, *[1] * (src.dim() - 1)).expand_as(src64),
        src64.abs(), "amax")
    if per_destination:
        scale, inv = _fixed_scales(_frexp_exponent(top_d[idx]))
        del top_d       # a map-sized buffer, not needed past here
        acc = _fixed_sum(dst.shape, idx, scale.mul_(src64))
        # every contribution to a destination writes the same value there
        out = dst.clone()
        out[idx] = dst[idx] + (acc[idx].to(torch.float64) * inv
                               ).to(dst.dtype)
        return out
    e = _frexp_exponent(top_d.amax())
    scale, inv = _fixed_scales(e)
    total = _fixed_sum(dst.shape, idx, src64 * scale).to(torch.float64) * inv
    e_d = _frexp_exponent(top_d)
    small = (top_d > 0) & (e_d < e - SMALL_EXPONENT_GAP)
    scale_d, inv_d = _fixed_scales(e_d)
    acc_d = _fixed_sum(dst.shape, idx, scale_d[idx].mul_(src64),
                       keep=small[idx])
    total = torch.where(small, acc_d.to(torch.float64) * inv_d, total)
    return dst + total.to(dst.dtype)
