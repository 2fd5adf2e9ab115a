"""Tiny shared MLP decoders (SDF, occupancy, semantics, colour). Port of
`pin_slam_tpu/models/decoder.py`.

Parameters are a plain dict {'w': [W0, W1, ...], 'b': [b0, b1, ...]} with
W_i of shape [in, out] — the JAX package's layout, so the two convert 1:1.
"""

from __future__ import annotations

import math

import torch


def init_mlp_params(generator: torch.Generator, in_dim: int,
                    hidden_dim: int, hidden_level: int, out_dim: int,
                    bias_on: bool = True, device=None):
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) init (torch.nn.Linear's
    default), drawn from `generator` on the CPU and moved to `device`."""
    ws, bs = [], []
    dims = [in_dim] + [hidden_dim] * hidden_level + [out_dim]
    for i in range(len(dims) - 1):
        bound = 1.0 / math.sqrt(dims[i])
        w = (torch.rand((dims[i], dims[i + 1]), generator=generator) * 2
             - 1) * bound
        b = ((torch.rand((dims[i + 1],), generator=generator) * 2 - 1)
             * bound if bias_on else torch.zeros(dims[i + 1]))
        ws.append(w.to(device))
        bs.append(b.to(device))
    return {"w": ws, "b": bs}


def mlp_apply(params, x: torch.Tensor, leaky: bool = False) -> torch.Tensor:
    """Apply the MLP to [..., in_dim]."""
    h = x
    n = len(params["w"])
    for i in range(n - 1):
        h = h @ params["w"][i] + params["b"][i]
        h = torch.nn.functional.leaky_relu(h, 0.01) if leaky else torch.relu(h)
    return h @ params["w"][n - 1] + params["b"][n - 1]


def sdf_apply(params, feat: torch.Tensor, sdf_scale: float,
              leaky: bool = False) -> torch.Tensor:
    """Scaled SDF prediction [..., in] -> [...]."""
    return mlp_apply(params, feat, leaky)[..., 0] * sdf_scale


def occupancy_apply(params, feat: torch.Tensor, sdf_scale: float,
                    leaky: bool = False) -> torch.Tensor:
    """Occupancy probability sigmoid(-sdf / sdf_scale)."""
    return torch.sigmoid(sdf_apply(params, feat, sdf_scale, leaky)
                         / -sdf_scale)


def sem_log_prob_apply(params, feat: torch.Tensor,
                       leaky: bool = False) -> torch.Tensor:
    """Log-softmax class probabilities [..., S]."""
    return torch.log_softmax(mlp_apply(params, feat, leaky), dim=-1)


def color_apply(params, feat: torch.Tensor, leaky: bool = False
                ) -> torch.Tensor:
    """Sigmoid colour/intensity regression [..., C]."""
    return torch.sigmoid(mlp_apply(params, feat, leaky))


def weighted_reduce(per_nn: torch.Tensor, w: torch.Tensor,
                    with_std: bool = False):
    """Combine per-neighbor predictions [N, k] or [N, k, D] with IDW weights
    [N, k] (the weighted_first=False decode). Returns (mean, std or
    None)."""
    wb = w[..., None] if per_nn.dim() == 3 else w
    mean = torch.sum(per_nn * wb, dim=1)
    if not with_std:
        return mean, None
    var = torch.sum(wb * (per_nn - mean[:, None]) ** 2, dim=1)
    return mean, torch.sqrt(torch.clamp(var, min=0.0) + 1e-12)
