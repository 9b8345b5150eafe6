"""Atom-wise readout (x2gnn_tpu/nn/readout.py:20-43): gate edge features
with a radial-basis filter, sum them into their source atoms, and map each
atom to a scalar with a SiLU MLP."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from x2gnn_tpu_torch.nn.layers import Dense, MLPHead
from x2gnn_tpu_torch.ops.segment import segment_sum


class AtomWiseReadout(nn.Module):
    def __init__(self, channels: int, rbf_dim: int, num_target: int = 1,
                 mlp_depth: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_rbf = Dense(rbf_dim, channels, generator=generator)
        self.mlp = MLPHead(channels, num_target, mlp_depth,
                           generator=generator)

    def forward(self, x: torch.Tensor, rbf: torch.Tensor,
                edge_src: torch.Tensor, num_atoms: int,
                edge_mask: Optional[torch.Tensor] = None,
                aggregate: Optional[Callable] = None) -> torch.Tensor:
        """x: (E, C) edge features; rbf: (E, K); edge_src: (E,) source atom.
        Returns (num_atoms, num_target). `aggregate` (E, C) -> (atoms, C)
        replaces the edges->atoms segment sum (the blocked layout passes a
        scatter-free out-table gather + row sum)."""
        out = self.lin_rbf(rbf) * x
        if aggregate is not None:
            out = aggregate(out)
        else:
            out = segment_sum(out, edge_src, num_atoms, mask=edge_mask)
        return self.mlp(out)
