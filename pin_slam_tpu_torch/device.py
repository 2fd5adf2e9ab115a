"""Device resolution and numerics settings.

The Gauss-Newton normal equations of the tracker and the tiny decoder
matmuls are numerically load-bearing: TF32 (about three decimal digits)
corrupts the 6x6 solves the same way the TPU's default bf16 passes did for
the JAX package. Every entry point therefore pins full-fp32 math.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def set_full_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means the first CUDA card. Asking for CUDA without a card
    raises: the port never falls back to the CPU on its own."""
    set_full_fp32()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
