"""Positional encodings of the neighbour offset vectors. Port of
`pin_slam_tpu/models/pos_encoding.py`: log-scale sinusoidal bands and
Gaussian Fourier features. Both are off by default (zero bands: the raw
offsets); with bands on, the decoder's input is feature_dim + out_dim.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


class PositionalEncoder:
    """Log-scale sinusoidal encoding: out_dim = d * (2 * bands + 1), per
    input dimension the sines, the cosines, then the raw value."""

    def __init__(self, freq: float = 200.0, num_bands: int = 0,
                 dimensionality: int = 3, base: float = 2.0):
        self.num_bands = num_bands
        self.dimensionality = dimensionality
        self.out_dim = dimensionality * (2 * num_bands + 1)
        if num_bands > 0:
            exps = np.linspace(0.0, np.log(freq / 2) / np.log(base),
                               num_bands)
            self.scales = np.power(base, exps).astype(np.float32)
        else:
            self.scales = np.zeros((0,), np.float32)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.num_bands == 0:
            return x
        scales = torch.as_tensor(self.scales, device=x.device)
        xb = x[..., None] * scales * math.pi
        enc = torch.cat([torch.sin(xb), torch.cos(xb), x[..., None]], dim=-1)
        return enc.reshape(*x.shape[:-1], self.out_dim)


class GaussianFourierFeatures:
    """Random Fourier features: out_dim = 2 * bands + d, [x | sin | cos] of
    2 pi x B. `B` ([d, bands], N(0, 1) times `freq`) is drawn from
    `generator`, or handed over (`convert.gaussian_pe_from_jax` carries the
    JAX encoder's)."""

    def __init__(self, generator: Optional[torch.Generator],
                 freq: float = 200.0, num_bands: int = 0,
                 dimensionality: int = 3, B: Optional[torch.Tensor] = None,
                 device=None):
        self.num_bands = num_bands
        self.dimensionality = dimensionality
        self.out_dim = 2 * num_bands + dimensionality
        if num_bands == 0:
            self.B = None
        elif B is not None:
            self.B = B
        else:
            self.B = torch.randn((dimensionality, num_bands),
                                 generator=generator, device=device) * freq

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.num_bands == 0:
            return x
        # 2 pi x @ B as a sum over the d input dimensions in order, each
        # product rounded (the JAX package's XLA dot; a BLAS product fuses
        # them, and sin of a large argument shows the last bit)
        xs = 2.0 * math.pi * x
        proj = xs[..., 0:1] * self.B[0]
        for i in range(1, self.dimensionality):
            proj = proj + xs[..., i:i + 1] * self.B[i]
        return torch.cat([x, torch.sin(proj), torch.cos(proj)], dim=-1)
