"""Masked segment sum and mean (x2gnn_tpu/ops/segment.py:32-45):
masked-out rows contribute nothing regardless of their segment id, which
keeps padding (segment id 0 by convention) inert.

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
"""

from __future__ import annotations

from typing import Optional

import torch

_BLOCK = 1 << 24            # elements of one select: 64 MiB of float32


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
