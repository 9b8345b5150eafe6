"""Hierarchical readouts (x2gnn_tpu/nn/readout.py): gate edge features
with a radial-basis filter and sum them into their source atoms. The
atom-wise readout (:20-43) maps each atom to a scalar with a SiLU MLP (the
model sums atoms into molecules at the end, for extensive targets); the
molecule-wise one (:46-76) first pools the atoms into molecules, by mean
or sum, then applies an MLP left at torch's default init (intensive
targets)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from x2gnn_tpu_torch.nn.layers import Dense, MLPHead
from x2gnn_tpu_torch.ops.segment import segment_mean, segment_sum


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


class MolWiseReadout(nn.Module):
    def __init__(self, channels: int, rbf_dim: int, num_target: int = 1,
                 mlp_depth: int = 3, pool: str = "mean",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pool not in ("mean", "add"):
            raise ValueError(f"pool={pool!r}: 'mean' or 'add'")
        self.pool = pool
        self.lin_rbf = Dense(rbf_dim, channels, generator=generator)
        self.mlp = MLPHead(channels, num_target, mlp_depth,
                           torch_default_init=True, generator=generator)

    def forward(self, x: torch.Tensor, rbf: torch.Tensor,
                edge_src: torch.Tensor, atom_gid: torch.Tensor,
                num_atoms: int, num_graphs: int,
                edge_mask: Optional[torch.Tensor] = None,
                node_mask: Optional[torch.Tensor] = None,
                aggregate: Optional[Callable] = None) -> torch.Tensor:
        """As AtomWiseReadout, then the atoms' rows pooled into their
        molecules (`atom_gid`, real atoms `node_mask`) before the MLP.
        Returns (num_graphs, num_target)."""
        out = self.lin_rbf(rbf) * x
        if aggregate is not None:
            out = aggregate(out)
        else:
            out = segment_sum(out, edge_src, num_atoms, mask=edge_mask)
        pool = segment_mean if self.pool == "mean" else segment_sum
        return self.mlp(pool(out, atom_gid, num_graphs, mask=node_mask))
