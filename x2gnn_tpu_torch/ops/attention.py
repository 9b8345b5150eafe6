"""Blocked-layout gathers (x2gnn_tpu/ops/attention.py:29-62) and the
attention-dropout keep mask (:201-211)."""

from __future__ import annotations

from typing import Optional

import torch


class _InjectiveGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, inv_pos, row_mask):
        ctx.save_for_backward(inv_pos, row_mask)
        ctx.table_shape = tuple(table.shape)
        return x[table]

    @staticmethod
    def backward(ctx, g):
        inv_pos, row_mask = ctx.saved_tensors
        N, D = ctx.table_shape
        out = g.reshape((N * D,) + g.shape[2:])[inv_pos]
        mask = row_mask.reshape(row_mask.shape + (1,) * (out.dim() - 1))
        return torch.where(mask, out, 0.0), None, None, None


def injective_gather(x: torch.Tensor, table: torch.Tensor,
                     inv_pos: torch.Tensor,
                     row_mask: torch.Tensor) -> torch.Tensor:
    """x[table], where `table` (N, D) lists each real row of x (E, ...)
    exactly once (pad slots point at row 0) and `inv_pos` (E,) gives each
    row's flat slot n*D + d. The mapping is injective, so the backward is a
    gather of the cotangent at inv_pos, never a scatter-add; `row_mask`
    (E,) marks the real rows, whose inv_pos alone is meaningful (a pad
    row's points at slot 0), so pad rows get a zero gradient."""
    return _InjectiveGather.apply(x, table, inv_pos, row_mask)


def inverse_slots(table: torch.Tensor, table_mask: torch.Tensor,
                  num_rows: int) -> torch.Tensor:
    """(num_rows,) flat slot n*D + d of each row listed by `table` (N, D)
    at a real slot (`table_mask`), 0 for rows it does not list: the
    `inv_pos` of an injective gather through `table`. A scatter of slot
    numbers into distinct rows (pad slots write into an extra row that is
    dropped), so its result does not depend on the order of writes."""
    N, D = table.shape
    rows = torch.where(table_mask, table, num_rows).reshape(-1)
    out = torch.zeros(num_rows + 1, dtype=table.dtype, device=table.device)
    slots = torch.arange(N * D, dtype=table.dtype, device=table.device)
    return out.scatter_(0, rows, slots)[:num_rows]


def pair_dropout_mask(generator: Optional[torch.Generator], rate: float,
                      N: int, D: int, H: int,
                      device="cpu") -> torch.Tensor:
    """Attention-dropout keep mask (N, D, D, H) float32 in the canonical
    pair space (atom, in-slot, out-slot, head), pre-scaled by 1/keep: each
    element 1/(1 - rate) with probability 1 - rate, else 0
    (x2gnn_tpu/ops/attention.py:201-211). Drawn by torch.bernoulli from
    `generator` (None: torch's default generator), which must live on
    `device`. A conv draws one per call and cuts every attention window
    from it, so the tiered and the one-window model drop the same
    weights."""
    keep = 1.0 - rate
    mask = torch.empty((N, D, D, H), dtype=torch.float32, device=device)
    return mask.bernoulli_(keep, generator=generator).div_(keep)
