"""Edge-partitioned blocked attention, the op-level building block
(x2gnn_tpu/parallel/edge_partition.py): atoms, and with them the
attention's destination rows, are split contiguously over the mesh's
'data' axis; the per-edge projections are split by edges, and each rank
all-gathers them before it computes its own atoms' attention. The softmax
normalizes per destination row, so it stays local.

This is the reference's standalone op on the `G`/`cbf` formulation,
which reaches no Pallas kernel (its XLA einsums, :56-83): the port runs it
as PyTorch ops over all-gathers of the EP ranks. The full model
(`ep_model.py`) runs the fused kernel formulation instead.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist

from x2gnn_tpu_torch.parallel.ep_model import _Axis, all_gather_rows
from x2gnn_tpu_torch.parallel.mesh import Mesh

_NEG = -1e30


class _AllGather(torch.autograd.Function):
    """The ranks' row pieces stacked in rank order; the backward sums the
    cotangents over the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.rows = axis, x.shape[0]
        return all_gather_rows(x, axis)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        lo = ctx.axis.index * ctx.rows
        return g[lo:lo + ctx.rows], None


def make_ep_blocked_attention(mesh: Mesh, heads: int) -> Callable:
    """fn(q, k, v, e_atom, G, s_bias, cbf, in_edges, out_edges, pair_mask)
    -> out (Nl, D, H, C), this rank's atoms in the blocked (atom, slot)
    layout (:34-89). This rank's pieces:
      q, k, v:    (El, H, C) per-edge projections, edges split by rank
      G:          (El, L, H, C), split as q
      e_atom:     (Nl, H, C), atoms split by rank
      cbf:        (Nl, D, D, L)
      in_edges/out_edges: (Nl, D) GLOBAL edge ids
      pair_mask:  (Nl, D, D) bool
    and s_bias (H, C), the same on every rank."""
    axis = _Axis.of(mesh)

    def attend(q, k, v, e_atom, G, s_bias, cbf, in_edges, out_edges,
               pair_mask):
        if q.shape[1] != heads:
            raise ValueError(f"q has {q.shape[1]} heads, not {heads}")
        q_full, k_full, v_full, G_full = (
            _AllGather.apply(t, axis) for t in (q, k, v, G))
        C = q.shape[-1]
        q_blk = q_full[in_edges]
        k_blk = k_full[out_edges] + e_atom[:, None]
        v_blk = v_full[out_edges] + e_atom[:, None]
        scores = torch.einsum("nihc,nkhc->nikh", q_blk, k_blk) / math.sqrt(C)
        scores = torch.where(pair_mask[..., None], scores, _NEG)
        smax = torch.clamp(scores.amax(dim=2, keepdim=True), min=_NEG / 2)
        ex = torch.where(pair_mask[..., None], torch.exp(scores - smax), 0.0)
        alpha = ex / torch.clamp(ex.sum(dim=2, keepdim=True), min=1e-16)
        out = torch.einsum("nikh,nkhc->nihc", alpha, v_blk) * s_bias
        G_out = G_full[out_edges]                        # (Nl, D, L, H, C)
        for l in range(cbf.shape[-1]):
            wl = alpha * cbf[..., l][..., None]
            out = out + torch.einsum("nikh,nkhc->nihc", wl,
                                     v_blk * G_out[:, :, l])
        return out

    return attend
