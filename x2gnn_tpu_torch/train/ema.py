"""Exponential moving average of parameters (x2gnn_tpu/train/ema.py).

torch.optim.swa_utils.AveragedModel semantics with
avg = decay * avg + (1 - decay) * param (train_ema.py:45-47): the first
update copies the parameters, later updates apply the decay. The EMA is a
list of tensors, one per parameter, or one flat vector (flat=True, the
fused update), in `torch.cat` order of the parameters.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch


class EmaState(NamedTuple):
    params: List[torch.Tensor]   # one per parameter, or [flat vector]
    count: torch.Tensor          # int32 scalar: updates applied


def ema_init(params: Sequence[torch.Tensor], flat: bool = False) -> EmaState:
    """Copies of `params` (detached), or their concatenation if flat."""
    with torch.no_grad():
        if flat:
            avg = [torch.cat([p.reshape(-1) for p in params])]
        else:
            avg = [p.detach().clone() for p in params]
    return EmaState(avg, torch.zeros((), dtype=torch.int32,
                                     device=avg[0].device))


def ema_update(state: EmaState, params: Sequence[torch.Tensor],
               decay: float) -> EmaState:
    """The next EMA state; `params` is the parameter list, or [flat
    vector] for a flat EMA. Computes new tensors (the caller selects
    between old and new state)."""
    first = state.count == 0
    with torch.no_grad():
        new = [torch.where(first, p, decay * avg + (1.0 - decay) * p)
               for avg, p in zip(state.params, params)]
    return EmaState(new, state.count + 1)


def unflatten(flat: torch.Tensor,
              like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Views of `flat` shaped like the tensors of `like`, in order."""
    sizes = [p.numel() for p in like]
    return [chunk.view(p.shape)
            for chunk, p in zip(torch.split(flat, sizes), like)]
