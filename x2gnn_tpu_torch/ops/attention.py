"""Blocked-layout gathers (x2gnn_tpu/ops/attention.py:29-62)."""

from __future__ import annotations

import torch


def injective_gather(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x[table], where `table` (N, D) lists each real row of x exactly once
    and pad slots point at row 0. Forward indexing only: the gather-shaped
    backward of the reference comes with the training slice."""
    return x[table]
