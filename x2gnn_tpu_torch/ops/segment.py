"""Masked segment primitives (x2gnn_tpu/ops/segment.py:32-71): masked-out
rows contribute nothing regardless of their segment id, which keeps
padding (segment id 0 by convention) inert.

The sum runs in a fixed order: each segment selects its rows with
`torch.where` from a (segments x rows) membership table, and a dense
reduction over the rows adds them, so a training step gives the same
bits on every run. A scatter-add (`index_add_`) lowers to float atomics
on CUDA, whose order, and so whose rounding, changes from run to run.
Rows need not be sorted by segment: a degree-sorted batch relabels its
atoms, so `atom_gid` is not monotone. A select, unlike a 0/1 matrix
product (0 * NaN = NaN), keeps each row in its own segment, as
jax.ops.segment_sum does: a NaN or inf spoils that segment's sum only,
and a non-finite cotangent reaches only that segment's rows.

The select holds segments x rows x features elements: 1.1 M for the
graph norm's sums (23,808 rows into 48 molecules, one feature). Larger
problems run in blocks of segments of at most `_BLOCK` elements each,
which bounds the memory, not the work.

The select costs segments x rows, so on the triplet axis (~1e4 edges x
~1e5 triplets) it cannot serve. There a `SegmentTable` lists each
segment's rows in a fixed order, (segments, W) with W the largest
segment: `table_sum` gathers the rows through it and sums over W, and
`gather_rows` (x[ids]) has that sum as its backward, where autograd's
would be a scatter-add. Both are gathers and dense sums, linear in the
rows, free of atomics, and give the same bits on every run.
`segment_softmax` normalizes through such a table; its max shift is an
order-free max and carries no gradient (the softmax does not depend on
it; the reference's gradient through it sums to zero up to rounding).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_BLOCK = 1 << 24            # elements of one select: 64 MiB of float32
_NEG_INF = -1e30


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum `data` rows into `num_segments` buckets, in a fixed order. Rows
    with an id outside [0, num_segments) belong to no bucket, as
    jax.ops.segment_sum drops them."""
    ids = torch.arange(num_segments, device=segment_ids.device)
    member = segment_ids[None, :] == ids[:, None]      # (segments, rows)
    if mask is not None:
        member = member & mask[None, :]
    rows = data.reshape(1, data.shape[0], -1)
    per = max(1, _BLOCK // max(rows.numel(), 1))
    out = torch.cat([torch.where(member[s:s + per, :, None], rows, 0.0).sum(1)
                     for s in range(0, num_segments, per)])
    return out.reshape((num_segments,) + data.shape[1:])


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean of `data` rows per segment, the count floored at 1 (an
    empty segment gives 0), in the fixed order of `segment_sum`
    (x2gnn_tpu/ops/segment.py:39-45, torch-scatter's scatter_mean)."""
    total = segment_sum(data, segment_ids, num_segments, mask)
    ones = torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
    count = torch.clamp(segment_sum(ones, segment_ids, num_segments, mask),
                        min=1.0)
    return total / count.reshape(count.shape + (1,) * (data.dim() - 1))


def _expand(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - mask.dim()))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max of `data` rows per segment, masked rows counting as -1e30; a
    segment with no rows gives -inf, and rows with an id outside [0,
    num_segments) are dropped, as jax.ops.segment_max does
    (x2gnn_tpu/ops/segment.py:48-52). A max does not depend on the order
    of its operands, so the scatter is exact and the same on every run."""
    if mask is not None:
        data = torch.where(_expand(mask, data.dim()), data, _NEG_INF)
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    ids = torch.where(keep, ids, num_segments)
    out = torch.full((num_segments + 1,) + data.shape[1:], -float("inf"),
                     dtype=data.dtype, device=data.device)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, index, data, "amax")[:num_segments]


class SegmentTable(NamedTuple):
    """Rows grouped into segments: `ids` (P,) the segment of each row (0
    where `mask` is False), `mask` (P,) the rows that belong to one,
    `table` (S, W) each segment's rows in a fixed order (0 at pad slots)
    and `table_mask` (S, W) its real slots. Every row of `mask` sits in
    exactly one real slot, of its own segment's row."""

    ids: torch.Tensor
    mask: torch.Tensor
    table: torch.Tensor
    table_mask: torch.Tensor


def segment_table(segment_ids: torch.Tensor, num_segments: int,
                  mask: Optional[torch.Tensor], width: int) -> SegmentTable:
    """The SegmentTable of `segment_ids` (rows of `mask` with an id in
    [0, num_segments)), each segment's rows in row order: a stable sort,
    a search for each segment's start and a scatter of row ids into
    distinct slots, so the table is the same on every run. `width` bounds
    the largest segment (the table's W): the caller knows it from the
    batch's shapes, so nothing is read back from the device."""
    ids = segment_ids.long().reshape(-1)
    rows = ids.shape[0]
    keep = (ids >= 0) & (ids < num_segments)
    if mask is not None:
        keep = keep & mask.reshape(-1)
    key = torch.where(keep, ids, num_segments)
    order = torch.sort(key, stable=True).indices
    sorted_key = key[order]
    bounds = torch.arange(num_segments + 1, device=ids.device)
    starts = torch.searchsorted(sorted_key, bounds)
    slot = torch.arange(rows, device=ids.device) - starts[sorted_key]
    table = torch.zeros((num_segments + 1) * width, dtype=torch.long,
                        device=ids.device)
    filled = torch.zeros_like(table, dtype=torch.bool)
    flat = torch.where(sorted_key < num_segments,
                       sorted_key * width + slot, num_segments * width)
    table = table.scatter(0, flat, order)
    filled = filled.scatter(0, flat, sorted_key < num_segments)
    table = table.reshape(num_segments + 1, width)[:num_segments]
    filled = filled.reshape(num_segments + 1, width)[:num_segments]
    # a pad slot points at row 0 (the scatter of the dropped rows wrote
    # into the extra row, and the zeros stay)
    return SegmentTable(torch.where(keep, ids, 0), keep,
                        torch.where(filled, table, 0), filled)


class _TableSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, table, table_mask, ids, mask):
        ctx.save_for_backward(ids, mask)
        rows = data[table]                             # (S, W, ...)
        return torch.where(_expand(table_mask, rows.dim()), rows,
                           0.0).sum(1)

    @staticmethod
    def backward(ctx, g):
        ids, mask = ctx.saved_tensors
        out = g[ids]
        return (torch.where(_expand(mask, out.dim()), out, 0.0), None, None,
                None, None)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids, table, table_mask):
        ctx.save_for_backward(table, table_mask)
        ctx.ids_shape = tuple(ids.shape)
        return x[ids]

    @staticmethod
    def backward(ctx, g):
        table, table_mask = ctx.saved_tensors
        tail = tuple(g.shape[len(ctx.ids_shape):])
        rows = g.reshape((-1,) + tail)[table]          # (S, W, ...)
        return (torch.where(_expand(table_mask, rows.dim()), rows,
                            0.0).sum(1), None, None, None)


def table_sum(data: torch.Tensor, seg: SegmentTable) -> torch.Tensor:
    """(S, ...) sums of the `data` rows (P, ...) of each segment, in the
    table's order; its backward gathers the cotangent at `seg.ids` (0 for
    rows outside `seg.mask`)."""
    return _TableSum.apply(data, seg.table, seg.table_mask, seg.ids,
                           seg.mask)


def gather_rows(x: torch.Tensor, seg: SegmentTable) -> torch.Tensor:
    """x[seg.ids] for `x` (S, ...), shaped seg.ids.shape + x.shape[1:];
    its backward sums each segment's cotangent rows through the table
    (rows outside `seg.mask` pass none back)."""
    return _GatherRows.apply(x, seg.ids, seg.table, seg.table_mask)


def segment_softmax(scores: torch.Tensor,
                    table: SegmentTable) -> torch.Tensor:
    """Softmax of `scores` (P, ...) within the segments of `table`
    (x2gnn_tpu/ops/segment.py:55-71): rows outside `table.mask` weigh 0
    and a segment with no rows gives zeros, not NaN."""
    keep = _expand(table.mask, scores.dim())
    rows = scores.detach()[table.table]
    seg_max = torch.where(_expand(table.table_mask, rows.dim()), rows,
                          _NEG_INF).amax(1)
    seg_max = torch.clamp(seg_max, min=_NEG_INF / 2)
    expd = torch.exp(torch.where(keep, scores, _NEG_INF)
                     - seg_max[table.ids])
    expd = torch.where(keep, expd, 0.0)
    denom = torch.clamp(table_sum(expd, table), min=1e-16)
    return expd / gather_rows(denom, table)
