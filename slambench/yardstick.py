"""The yardstick: the card's published peak and the model-FLOP counts
that the FLOP shares divide by. Each count follows from the configuration
and the run's own sizes, never from how the program computes them.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FP32_FLOPS = 67e12     # float32 outside the tensor cores (TF32 is off)


def mlp_flops(in_dim: int, hidden: int, levels: int, out: int = 1) -> int:
    """Multiply-adds (2 FLOPs each) and bias adds of one MLP evaluation."""
    dims = [in_dim] + [hidden] * levels + [out]
    return sum(2 * a * b + b for a, b in zip(dims[:-1], dims[1:]))


def decode_flops(st, queries: int) -> float:
    """Forward FLOPs of the SDF at `queries` points: the inverse-distance
    weights and offsets of nn_k neighbours, and the decoder once on the
    weighted mean (weighted_first) or once per neighbour."""
    k, f = st.nn_k, st.feature_dim
    mlp = mlp_flops(f + 3, st.mlp_hidden, st.mlp_level)
    per = k * (3 + 3 + 2 + 2 * (f + 3))        # offsets, d2, weight, sum
    per += mlp if st.weighted_first else k * mlp
    return float(queries) * per


def train_flops(st, iters: int, bs: int) -> float:
    """A frame's training: per iteration the SDF at bs samples and the
    eikonal term's six shifted decodes at every grad_decimation-th, each
    forward and backward (3x the forward)."""
    n = bs + (6 * -(-bs // st.grad_decimation) if st.eikonal_on else 0)
    return 3.0 * iters * decode_flops(st, n)


def track_flops(st, gn_iters: int, sources: int) -> float:
    """A frame's registration: per Gauss-Newton iteration the SDF and its
    gradient at the source points (2x the forward)."""
    return 2.0 * gn_iters * decode_flops(st, sources)


def p90(values) -> float:
    """Nearest-rank 90th percentile: the smallest value that at least 90 %
    of the values do not exceed."""
    v = np.sort(np.asarray(values, np.float64))
    return float(v[int(np.ceil(0.9 * v.size)) - 1])
