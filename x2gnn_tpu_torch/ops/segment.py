"""Masked segment sum (x2gnn_tpu/ops/segment.py:32-36): masked-out rows
contribute nothing regardless of their segment id, which keeps padding
(segment id 0 by convention) inert."""

from __future__ import annotations

from typing import Optional

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum `data` rows into `num_segments` buckets."""
    if mask is not None:
        data = torch.where(
            mask.reshape(mask.shape + (1,) * (data.dim() - mask.dim())),
            data, 0.0)
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return out.index_add_(0, segment_ids, data)
