"""Losses and metrics with graph masking (x2gnn_tpu/train/loss.py).

The reference trains with smooth-L1 (beta=1, mean reduction;
trainer.py:41), which equals Huber with delta=1, and reports MAE scaled by
the unit calibration (trainer.py:52-58)."""

from __future__ import annotations

import torch


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Mean smooth-L1 over the real graphs (`mask`), as
    optax.losses.huber_loss(delta=1) computes it per graph:
    0.5 * min(|e|, 1)^2 + (|e| - min(|e|, 1))."""
    abs_err = (pred - target).abs()
    quadratic = torch.clamp(abs_err, max=1.0)
    per = 0.5 * quadratic ** 2 + (abs_err - quadratic)
    per = torch.where(mask, per, 0.0)
    return per.sum() / torch.clamp(mask.sum(), min=1)


def masked_mae(pred: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Sum of |pred - target| over the real graphs; the caller divides by
    the count and applies the calibration, as trainer.py:52-58 does."""
    return torch.where(mask, (pred - target).abs(), 0.0).sum()
