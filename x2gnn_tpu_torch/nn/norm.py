"""Graph-wise LayerNorm (x2gnn_tpu/nn/norm.py:19-38): mean and variance
over all (rows x channels) elements of each molecule, biased variance,
eps inside the sqrt, no affine parameters."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from x2gnn_tpu_torch.ops.segment import segment_sum


class GraphLayerNorm(nn.Module):
    def __init__(self, eps: float = 1e-8):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, graph_ids: torch.Tensor,
                num_graphs: int, mask: Optional[torch.Tensor] = None,
                total: Optional[Callable] = None) -> torch.Tensor:
        """x: (E, C); graph_ids: (E,) molecule id; mask: (E,) valid rows.
        `total` maps the per-graph sums of these rows to the graphs' sums
        (the edge-partitioned model all-reduces them over its ranks, as a
        molecule's rows may lie on several)."""
        total = total or (lambda sums: sums)
        feat = x.shape[-1]
        ones = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
        count = total(segment_sum(ones, graph_ids, num_graphs, mask)) * feat
        count = torch.clamp(count, min=1.0)
        mean = total(segment_sum(x.sum(-1), graph_ids, num_graphs,
                                 mask)) / count
        centered = x - mean[graph_ids][:, None]
        var = total(segment_sum((centered * centered).sum(-1), graph_ids,
                                num_graphs, mask)) / count
        out = centered / torch.sqrt(var + self.eps)[graph_ids][:, None]
        if mask is not None:
            out = torch.where(mask[:, None], out, 0.0)
        return out
