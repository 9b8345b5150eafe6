"""The numbers that decide `correct`, each against its limit.

Training: the program's first three steps, run by the window's own call
on its own feed, against the reference's three steps from the same
weights on the same molecules:
  * loss_gap: the largest |loss_p - loss_r| / |loss_r| over the steps;
  * grad_gap: by the worst leaf, | |g_p| - |g_r| | / max(|g_r|, median
    leaf |g_r|), g the first step's clipped gradient (the program's read
    back from its Adam state after one step: m = (1 - b1) g);
  * change_gap: the same of each leaf's change after three steps, over
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's (a leaf below that, such as a key bias under the
    softmax, moves under Adam by rounding alone);
  * ema_gap: the same of the moving average's change from the start
    after three steps, over the same leaves.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
MOVED_SHARE = 1e-3   # a leaf moves if its gradient is >= this x the median


def limits(cell: str) -> Dict[str, float]:
    """{number: limit} of the cell (limits/<cell>.json)."""
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in leaves.items()}


def _worst(prog: Dict[str, float], ref: Dict[str, float],
           names: Sequence[str]):
    """(the largest gap of norms, its leaf)."""
    med = float(np.median([ref[k] for k in names]))
    return max((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k)
               for k in names)


def train_numbers(prog_losses: Sequence[float],
                  prog_grad: Dict[str, torch.Tensor],
                  prog_change: Dict[str, torch.Tensor],
                  prog_ema: Dict[str, torch.Tensor],
                  ref_losses: Sequence[float],
                  ref_grad: Dict[str, torch.Tensor],
                  ref_change: Dict[str, torch.Tensor],
                  ref_ema: Dict[str, torch.Tensor]):
    """({number: value}, {number: the leaf that set it}); `*_change` and
    `*_ema` are the parameters' and the average's change from the
    start."""
    if len(prog_losses) != len(ref_losses):
        raise ValueError("the program and the reference took different "
                         "numbers of steps")
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               if np.isfinite(p) else np.inf
               for p, r in zip(prog_losses, ref_losses))
    gp, gr = _norms(prog_grad), _norms(ref_grad)
    names = sorted(gr)
    if sorted(gp) != names:
        raise ValueError("the program's and the reference's parameters "
                         "differ")
    med = float(np.median([gr[k] for k in names]))
    moved = [k for k in names if gr[k] >= MOVED_SHARE * med]
    grad, grad_leaf = _worst(gp, gr, names)
    change, change_leaf = _worst(_norms(prog_change), _norms(ref_change),
                                 moved)
    ema, ema_leaf = _worst(_norms(prog_ema), _norms(ref_ema), moved)
    return ({"loss_gap": loss, "grad_gap": grad, "change_gap": change,
             "ema_gap": ema},
            {"grad_gap": grad_leaf, "change_gap": change_leaf,
             "ema_gap": ema_leaf})


def verdict(numbers: Dict[str, float], lims: Dict[str, float]):
    """(correct, {number: {"value", "limit"}}): every number within its
    limit. A number that is not finite fails and reads as 1e300."""
    ok = all(np.isfinite(v) and v <= lims[k] for k, v in numbers.items())
    rows = {k: {"value": float(v) if np.isfinite(v) else 1e300,
                "limit": lims[k]} for k, v in numbers.items()}
    return ok, rows
