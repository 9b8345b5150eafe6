"""Molecule-level data parallelism over the ranks of a `Mesh`
(x2gnn_tpu/parallel/data_parallel.py).

Each rank holds whole molecules: its own GraphBatch of a group of `world`
batches (`dp_batch_iterator`; the last ragged group is filled with
all-masked batches, `empty_like_batch`). A step runs the port's model
forward and autograd's backward on the rank's batch, then ONE all-reduce
of the flat gradient vector, the loss and the real graph count, each
weighted by the rank's real graph count: psum(g·cnt)/psum(cnt)
(:109-114), so a filler weighs nothing and the gradient is the
count-weighted mean of the ranks' gradients, the loss the mean over the
group's real molecules. (Each rank's embedding gradient divides by the
counts of its own batch, as torch's scale_grad_by_freq does per batch,
so it is not the gradient of the group padded into one batch.) Every
rank then applies the same update to its replica of the parameters, the
optimizer state and the EMA (`train/optim.py::
apply_update_skip_nonfinite`, with the non-finite skip, :117). At one
rank the weighting computes (g·cnt)/cnt, which rounds: a step at world
size 1 equals the plain Trainer's step within float32 rounding, not bit
for bit.

The reference stacks a group's batches on a leading device axis of one
process (`stack_batches`, `shard_batches`). A process per rank has no
such axis: each rank keeps the one member of each group that is its own
(`dp_batch_iterator(batches, n_dev, rank)`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from x2gnn_tpu_torch.data.batching import GraphBatch
from x2gnn_tpu_torch.ops.attention import dropout_generator
from x2gnn_tpu_torch.parallel.mesh import Mesh
from x2gnn_tpu_torch.train.ema import unflatten
from x2gnn_tpu_torch.train.loss import masked_mae, smooth_l1_loss
from x2gnn_tpu_torch.train.optim import apply_update_skip_nonfinite

_MASKS = ("node_mask", "edge_mask", "trip_mask", "graph_mask", "in_mask",
          "out_mask", "y")


def empty_like_batch(batch: GraphBatch) -> GraphBatch:
    """A copy of `batch` with every mask and the targets zeroed: the same
    shapes and no real graph (:45-56), which pads the last group of an
    epoch. Numpy or torch, as `batch` is."""
    def zeros(a):
        return (torch.zeros_like(a) if isinstance(a, torch.Tensor)
                else np.zeros_like(a))

    return dataclasses.replace(batch, **{f: zeros(getattr(batch, f))
                                         for f in _MASKS})


def dp_batch_iterator(batches: Iterable, n_dev: int, rank: int,
                      filler: Callable = empty_like_batch) -> Iterator:
    """This rank's member of each group of `n_dev` consecutive batches;
    in the last ragged group a rank beyond its batches gets `filler` of
    the group's last batch (:59-73)."""
    group = []
    for b in batches:
        group.append(b)
        if len(group) == n_dev:
            yield group[rank]
            group = []
    if group:
        yield group[rank] if rank < len(group) else filler(group[-1])


def weighted_all_reduce(grads: torch.Tensor, loss: torch.Tensor,
                        count: torch.Tensor, group=None):
    """psum(g·cnt)/psum(cnt) and the loss likewise (:109-114), in one
    all-reduce over `group` of [g·cnt, loss·cnt, cnt]: a rank without
    real graphs adds zeros. `grads` is the rank's flat gradient vector,
    `loss` its mean loss, `count` its real graph count. Returns (grads,
    loss, psum(cnt))."""
    cnt = count.to(torch.float32)
    buf = torch.cat([grads * cnt,
                     (torch.where(cnt > 0, loss, 0.0) * cnt).reshape(1),
                     cnt.reshape(1)])
    dist.all_reduce(buf, group=group)
    total = torch.clamp(buf[-1], min=1.0)
    return buf[:-2] / total, buf[-2] / total, buf[-1]


def reduced_gradients(loss, leaves, count, group=None):
    """The gradients of this rank's `loss` with respect to `leaves` (zeros
    for an unused one), flattened and reduced with the loss by
    `weighted_all_reduce` over `group`: (flat gradients, global loss,
    psum(cnt))."""
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return weighted_all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                               loss.detach(), count, group)


def reduce_and_update(state, loss, leaves, count, optimizer, ema_decay,
                      group=None):
    """The parallel steps' common tail: `reduced_gradients`, then the
    update with the non-finite skip on the global loss. state.params holds
    the model's parameters or one flat vector of them; the gradients take
    its layout. Returns (state, global loss, psum(cnt))."""
    flat, loss, total = reduced_gradients(loss, leaves, count, group)
    state, loss = apply_update_skip_nonfinite(
        state, loss, unflatten(flat, state.params), optimizer, ema_decay)
    return state, loss, total


def make_dp_train_step(model: torch.nn.Module, optimizer, ema_decay: float,
                       mesh: Mesh, dropout: float = 0.0,
                       rng_seed: int = 0) -> Callable:
    """step(state, batch, step=None) -> (state, loss, real graphs): the
    data-parallel step (:76-125) on this rank's batch. With `dropout` the
    masks come from `ops.attention.dropout_generator(rng_seed, step,
    rank)` (step: state.step's value, read from the device when not
    given): rank 0 draws what the single-device Trainer draws, the others
    other masks (the reference folds the mesh position into its key,
    :94-97)."""
    leaves = list(model.parameters())
    group, rank = mesh.group("data"), mesh.axis_index("data")

    def step(state, batch: GraphBatch, step: Optional[int] = None):
        if dropout > 0:
            if step is None:
                step = int(state.step)
            pred = model(batch, deterministic=False,
                         generator=dropout_generator(
                             rng_seed, step, batch.y.device, rank))
        else:
            pred = model(batch)
        loss = smooth_l1_loss(pred, batch.y, mask=batch.graph_mask)
        return reduce_and_update(state, loss, leaves,
                                 batch.graph_mask.sum(), optimizer,
                                 ema_decay, group)

    return step


def make_dp_eval_step(model: torch.nn.Module, mesh: Mesh,
                      std: float = 1.0) -> Callable:
    """fn(ema_params, batch) -> (sum of |err|·std, real graphs), both
    all-reduced over the ranks (:128-144); `ema_params` maps parameter
    names to tensors."""
    group = mesh.group("data")

    def evaluate(ema_params: dict, batch: GraphBatch):
        with torch.no_grad():
            pred = torch.func.functional_call(model, ema_params, (batch,))
            buf = torch.stack([masked_mae(pred, batch.y,
                                          mask=batch.graph_mask) * std,
                               batch.graph_mask.sum().to(torch.float32)])
        dist.all_reduce(buf, group=group)
        return buf[0], buf[1]

    return evaluate
