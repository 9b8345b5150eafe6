"""Hybrid DP x EP on a 2-D rank layout ('dp', 'data')
(x2gnn_tpu/parallel/hybrid.py).

Each row of the layout (the ranks that share a 'dp' coordinate) holds its
own group of whole molecules, one batch per step, and splits that
batch's atoms over its ranks ('data', the EP axis: `ep_model.py`). The EP
forward runs unchanged in each row: its collectives use the row's
process group, so rows never meet inside the forward. The gradients meet
once per step, in one weighted all-reduce over every rank
(`data_parallel.weighted_all_reduce`), which divides by every rank's real
graph count: each row's graphs are counted once per EP rank, which is
what the EP backward's sums over the row need (`ep_model.py`'s
docstring). The loss is one masked mean over every real molecule of every
row: the single-device loss on the union of the groups (:14-21).

The reference stacks the groups' EPBatches on a leading axis and lays
the stack out on its mesh (`stack_ep_batches`, `shard_hybrid_batch`);
here each rank takes its row's EPBatch of the stack and its piece of the
atoms. The forward returns the predictions of this rank's row.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch.distributed as dist

from x2gnn_tpu_torch.parallel.ep_model import (
    AXIS, EPBatch, make_ep_eval_step, make_ep_forward, make_ep_train_step)
from x2gnn_tpu_torch.parallel.mesh import Mesh, layout_mesh

DP_AXIS = "dp"


def make_hybrid_mesh(dp: int, ep: int) -> Mesh:
    """A (dp, ep) layout with axes ('dp', 'data') over every rank: rank
    r sits at row r // ep, column r % ep, with one process group per row
    (EP) and per column (DP) (:52-59). Raises if dp * ep is not the world
    size."""
    world = dist.get_world_size()
    if dp * ep != world:
        raise ValueError(f"dp*ep = {dp * ep} != {world} ranks")
    return layout_mesh((dp, ep), (DP_AXIS, AXIS))


def stack_ep_batches(epbs: Sequence[EPBatch]) -> EPBatch:
    """The groups' host EPBatches stacked on a leading group axis; all
    must share shapes (one set of budgets, :62-74)."""
    return EPBatch(**{f.name: np.stack([np.asarray(getattr(b, f.name))
                                        for b in epbs])
                      for f in dataclasses.fields(EPBatch)})


def shard_hybrid_batch(stacked: EPBatch, mesh: Mesh, device) -> EPBatch:
    """This rank's row of `stacked` (one group per row) and its piece of
    that row's atoms, on `device` (:77-85)."""
    if stacked.y.shape[0] != mesh.axis_size(DP_AXIS):
        raise ValueError(f"{stacked.y.shape[0]} stacked groups for "
                         f"{mesh.axis_size(DP_AXIS)} rows: stack one "
                         "EPBatch per row")
    row = mesh.axis_index(DP_AXIS)
    group = EPBatch(**{f.name: getattr(stacked, f.name)[row]
                       for f in dataclasses.fields(EPBatch)})
    return group.shard(mesh.axis_index(AXIS),
                       mesh.axis_size(AXIS)).to(device)


def _check_mesh(mesh: Mesh) -> None:
    if mesh.axis_names != (DP_AXIS, AXIS):
        raise ValueError(f"mesh axes {mesh.axis_names}: a hybrid mesh has "
                         f"{(DP_AXIS, AXIS)} (make_hybrid_mesh)")


def make_hybrid_forward(mesh: Mesh,
                        kv_exchange: str = "allgather") -> Callable:
    """fn(model, epb, generator=None, dropout_masks=None) -> (G,)
    predictions of this rank's row (:88-129); dropout masks are drawn per
    rank."""
    _check_mesh(mesh)
    return make_ep_forward(mesh, kv_exchange)


def make_hybrid_train_step(model, optimizer, ema_decay: float, mesh: Mesh,
                           kv_exchange: str = "allgather",
                           rng_seed: int = 0) -> Callable:
    """step(state, epb, step=None) -> (state, loss, real graphs of every
    row): the mean loss over all rows' real molecules, the non-finite
    skip (:132-160)."""
    _check_mesh(mesh)
    return make_ep_train_step(model, optimizer, ema_decay, mesh,
                              kv_exchange, rng_seed)


def make_hybrid_eval_step(model, mesh: Mesh, std: float = 1.0,
                          kv_exchange: str = "allgather") -> Callable:
    """fn(ema_params, epb) -> (sum of |err|·std over every row's real
    molecules, their count) (:163-176)."""
    _check_mesh(mesh)
    return make_ep_eval_step(model, mesh, std, kv_exchange)
