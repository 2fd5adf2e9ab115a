"""Mapping losses. Port of `pin_slam_tpu/models/losses.py`. Every loss takes an explicit validity mask so padded batch
entries contribute nothing.
"""

from __future__ import annotations

from typing import Optional

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    denom = torch.clamp(mask.to(x.dtype).sum(), min=1.0)
    return torch.where(mask, x, torch.zeros_like(x)).sum() / denom


def sdf_bce_loss(pred, label, sigma: float, weight: Optional[torch.Tensor],
                 mask, weighted: bool = False):
    """BCE-with-logits between pred/sigma and sigmoid(label/sigma)."""
    logits = pred / sigma
    target = torch.sigmoid(label / sigma)
    per = (torch.clamp(logits, min=0.0) - logits * target
           + torch.log1p(torch.exp(-torch.abs(logits))))
    if weighted and weight is not None:
        per = per * weight
    return _masked_mean(per, mask)


def sdf_zhong_loss(pred, label, trunc_dist: Optional[float],
                   weight: Optional[torch.Tensor], mask,
                   weighted: bool = False):
    mid = label / 2.0
    shift_abs = torch.abs(pred - mid)
    mid_abs = torch.abs(mid)
    loss = torch.where(shift_abs > mid_abs, shift_abs - mid_abs,
                       torch.zeros_like(shift_abs))
    if trunc_dist is not None:
        loss = torch.where(torch.abs(label) < trunc_dist,
                           torch.abs(pred - label), loss)
    if weighted and weight is not None:
        loss = loss * weight
    return _masked_mean(loss, mask)


def sdf_diff_loss(pred, label, weight: Optional[torch.Tensor], mask,
                  l2: bool = True):
    """L1/L2 sdf regression."""
    diff = pred - label
    per = diff * diff if l2 else torch.abs(diff)
    if weight is not None:
        per = per * weight
    return _masked_mean(per, mask)


def eikonal_loss(grad: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(|grad| - 1)^2 with an epsilon-guarded norm: a zero gradient (a query
    without neighbors) must not give a NaN backward through sqrt(0)."""
    gn = torch.sqrt(torch.sum(grad * grad, dim=-1) + 1e-12)
    return _masked_mean((gn - 1.0) ** 2, mask)


def color_l1_loss(pred: torch.Tensor, label: torch.Tensor,
                  weight: Optional[torch.Tensor], mask: torch.Tensor,
                  weighted: bool = False) -> torch.Tensor:
    """L1 colour regression [N, C] over the rows of `mask`."""
    per = torch.abs(pred - label)
    if weighted and weight is not None:
        per = per * weight[:, None]
    return _masked_mean(per, mask[:, None].expand_as(per))


def sem_nll_loss(log_prob: torch.Tensor, label: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """NLL of the labels [N] under log_prob [N, S] over the rows of
    `mask`."""
    label_c = torch.clamp(label.long(), 0, log_prob.shape[-1] - 1)
    per = -torch.gather(log_prob, 1, label_c[:, None])[:, 0]
    return _masked_mean(per, mask)
