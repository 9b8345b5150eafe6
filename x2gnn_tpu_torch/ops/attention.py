"""Line-graph attention primitives (x2gnn_tpu/ops/attention.py): the
blocked layout's injective gathers (:29-62), the segment and padded
layouts' attention (:90-101, :171-198), the attention-dropout keep mask in
the canonical pair space and its per-triplet positions (:201-226), and the
beta-gated skip (:229-237).

The flat layouts read each edge's rows once per triplet: q at the
triplet's destination edge, k and v at its source edge. Autograd would
give those gathers a scatter-add backward (float atomics on the card, so
another rounding on every run); here every gather with a gradient goes
through a `ops.segment.SegmentTable` of its rows (`TripletTables`), whose
backward is a gather and a dense sum over the table's width, and every
sum over triplets is such a sum. Real triplets are sorted by destination
edge, so the batch's `nbr_trip` is the destination table; the source
tables are built on the device, once per batch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from x2gnn_tpu_torch.ops.segment import (
    SegmentTable, gather_rows, segment_softmax, segment_table, table_sum)

_NEG = -1e30


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


class TripletTables(NamedTuple):
    """The flat layouts' gather tables of one batch (`triplet_tables`)."""

    dst: SegmentTable       # triplets by destination edge (nbr_trip)
    src: SegmentTable       # triplets by source edge
    nbr_src: SegmentTable   # the (E, D) neighbour slots by source edge
    trip_slot: torch.Tensor  # (T,) flat e*D + d slot of each triplet
    nbr_trip: torch.Tensor  # (E, D) triplet of each neighbour slot
    nbr_mask: torch.Tensor  # (E, D) real neighbour slots
    trip_mask: torch.Tensor  # (T,) real triplets


def triplet_tables(trip_src: torch.Tensor, trip_dst: torch.Tensor,
                   trip_mask: torch.Tensor, nbr_trip: torch.Tensor,
                   nbr_mask: torch.Tensor, nbr_src: torch.Tensor,
                   num_edges: int) -> TripletTables:
    """The gather tables of a batch's triplets. `nbr_trip` lists every
    real triplet once, in the row of its destination edge, so it is the
    destination table as it is. A source edge j->k feeds one triplet per
    other in-edge of j, so no source table is wider than the neighbour
    tables' D."""
    D = nbr_trip.shape[1]
    dst = SegmentTable(torch.where(trip_mask, trip_dst, 0), trip_mask,
                       nbr_trip, nbr_mask)
    src = segment_table(trip_src, num_edges, trip_mask, width=D)
    nbr_src_t = segment_table(nbr_src.reshape(-1), num_edges,
                              nbr_mask.reshape(-1), width=D)
    nbr_src_t = nbr_src_t._replace(ids=nbr_src_t.ids.reshape(nbr_src.shape))
    trip_slot = inverse_slots(nbr_trip, nbr_mask, trip_src.shape[0])
    return TripletTables(dst, src, nbr_src_t, trip_slot, nbr_trip,
                         nbr_mask, trip_mask)


def segment_attention(q, k, v, e, s, tables: TripletTables,
                      dropout_mask: Optional[torch.Tensor] = None,
                      return_weights: bool = False):
    """The segment layout (x2gnn_tpu/ops/attention.py:90-101,
    nn/conv.py:479-501): q/k/v (E, H, C), e/s (T, H, C) per-triplet
    edge-attribute and sbf projections, `tables` the batch's
    `triplet_tables`; scores q[dst].(k[src] + e) / sqrt(C), softmaxed over
    each destination edge's triplets, weigh the messages (v[src] + e) * s,
    summed into the destination edges. Returns (E, H, C).
    `dropout_mask` (T, H) scales the weights after the softmax;
    `return_weights` also returns the pre-dropout weights (T, H)."""
    C = q.shape[-1]
    dst, src = tables.dst, tables.src
    q_i = gather_rows(q, dst)
    k_j = gather_rows(k, src) + e
    alpha = (q_i * k_j).sum(-1) / math.sqrt(C)              # (T, H)
    alpha = segment_softmax(alpha, dst)
    weights = alpha
    if dropout_mask is not None:
        alpha = alpha * dropout_mask
    v_j = gather_rows(v, src) + e
    out = table_sum(v_j * s * alpha[..., None], dst)
    return (out, weights) if return_weights else out


def padded_attention(q, k, v, e, s, tables: TripletTables,
                     dropout_mask: Optional[torch.Tensor] = None):
    """The padded layout (x2gnn_tpu/ops/attention.py:171-198): per
    destination edge, its (E, D) neighbour slots make the segment softmax
    a masked softmax over D and the aggregation a dense sum. q/k/v
    (E, H, C), e/s (T, H, C), `tables` the batch's `triplet_tables`.
    Returns (E, H, C); an edge with no real neighbour gets 0.
    `dropout_mask` (E, D, H), pre-scaled by 1/keep, scales the weights
    after the softmax."""
    C = q.shape[-1]
    nbr_trip, nbr_mask = tables.nbr_trip, tables.nbr_mask
    e_n = injective_gather(e, nbr_trip, tables.trip_slot,
                           tables.trip_mask)                # (E, D, H, C)
    k_n = gather_rows(k, tables.nbr_src) + e_n
    v_n = gather_rows(v, tables.nbr_src) + e_n
    s_n = injective_gather(s, nbr_trip, tables.trip_slot, tables.trip_mask)
    mask = nbr_mask[..., None]
    alpha = torch.einsum("ehc,edhc->edh", q, k_n) / math.sqrt(C)
    alpha = torch.where(mask, alpha, _NEG)
    amax = torch.clamp(alpha.detach().amax(1, keepdim=True), min=_NEG / 2)
    ex = torch.where(mask, torch.exp(alpha - amax), 0.0)
    w = ex / torch.clamp(ex.sum(1, keepdim=True), min=1e-16)  # (E, D, H)
    if dropout_mask is not None:
        w = w * dropout_mask
    return (v_n * s_n * w[..., None]).sum(1)


def triplet_pair_positions(trip_dst, trip_src, edge_inpos, edge_outpos,
                           D: int) -> torch.Tensor:
    """Flat pair-space position (j*D*D + in_slot*D + out_slot) of every
    triplet: its destination edge (i->j) is in-slot `edge_inpos[dst] % D`
    of row j, its source edge (j->k) out-slot `edge_outpos[src] % D`
    (x2gnn_tpu/ops/attention.py:214-219)."""
    return edge_inpos[trip_dst] * D + edge_outpos[trip_src] % D


def pairs_to_triplet_weights(alpha_pairs: torch.Tensor,
                             pair_pos: torch.Tensor) -> torch.Tensor:
    """Per-pair weights (N, Di, Do, H) -> per-triplet weights (T, H), the
    segment layout's `return_attention_weights` shape (:222-226)."""
    N, Di, Do, H = alpha_pairs.shape
    return alpha_pairs.reshape(N * Di * Do, H)[pair_pos]


def beta_gate(out: torch.Tensor, skip: torch.Tensor,
              lin_beta) -> torch.Tensor:
    """The beta-gated skip (x2gnn_tpu/ops/attention.py:229-237,
    sbftransformer_conv.py:122-125): b*skip + (1-b)*out with b =
    sigmoid(lin_beta([out, skip, out - skip])), float32, one gate per row
    (per in-slot in the blocked layout). `lin_beta`: the bias-free
    (3C -> 1) linear layer."""
    out = out.float()
    b = torch.sigmoid(lin_beta(torch.cat([out, skip, out - skip], -1)))
    return b * skip + (1.0 - b) * out
