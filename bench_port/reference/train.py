"""Plain reference of one training step of the X2-GNN recipe: smooth-L1
loss averaged over the batch's molecules, gradients by autograd over
blocks of molecules, clipping by the global norm, Adam with bias
correction, the recipe's learning-rate schedule.

    loss  = mean over molecules of huber(pred - y, delta = 1)
    g     = g * max_grad / |g|   if |g| >= max_grad  (global L2 norm)
    m     = b1 m + (1 - b1) g,   v = b2 v + (1 - b2) g^2,   t = t + 1
    p     = p - lr(t - 1) * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

    lr(n) = max_lr                          ("plateau", never reduced
                                             within a few steps)
    lr(n) = max_lr min((n + 1) / warmup, 1) decay_rate^(n / decay_steps)
                                            ("warmup_exp")

    ema = p                  after the first step
    ema = d ema + (1 - d) p  after each later one (d: ema_decay)
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from bench_port.reference.model import (
    VOCAB, Molecule, blocks_of, forward, make_block)

B1, B2, EPS = 0.9, 0.999, 1e-8


class StepResult(NamedTuple):
    loss: float
    grads: Dict[str, torch.Tensor]   # clipped, as Adam takes them


class AdamState(NamedTuple):
    t: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def huber(err: torch.Tensor) -> torch.Tensor:
    a = err.abs()
    quad = torch.clamp(a, max=1.0)
    return 0.5 * quad * quad + (a - quad)


def loss_and_grads(p: Dict[str, torch.Tensor], mols: Sequence[Molecule],
                   m: dict, device, max_triplets: int = 400_000):
    """(mean loss, {name: gradient}) over `mols`, block by block; the
    embedding's gradient scaling counts the atomic numbers of all of
    `mols`."""
    leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
    grads = {k: torch.zeros_like(t) for k, t in p.items()}
    n = len(mols)
    z = np.bincount(np.concatenate([mol.numbers for mol in mols]),
                    minlength=VOCAB)
    z_counts = torch.as_tensor(z, dtype=torch.float32, device=device)
    total = 0.0
    for idx in blocks_of(mols, m["cutoff"], max_triplets):
        blk = make_block([mols[i] for i in idx], m, device)
        pred = forward(leaves, blk, m, z_counts)
        part = huber(pred - blk.y).sum() / n
        got = torch.autograd.grad(part, list(leaves.values()),
                                  allow_unused=True)
        for k, g in zip(leaves, got):
            if g is not None:
                grads[k] += g
        total += float(part.detach())
        del blk, pred, part, got
    return total, grads


def lr_at(n: int, t: dict) -> float:
    if t["scheduler"] == "plateau":
        return float(np.float32(t["max_lr"]))
    w = min((n + 1) / max(t["warmup_steps"], 1), 1.0)
    return t["max_lr"] * w * t["decay_rate"] ** (n / t["decay_steps"])


def adam_init(p: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(0, {k: torch.zeros_like(v) for k, v in p.items()},
                     {k: torch.zeros_like(v) for k, v in p.items()})


def train_step(p: Dict[str, torch.Tensor], st: AdamState,
               mols: Sequence[Molecule], m: dict, t: dict, device):
    """(new parameters, new Adam state, StepResult) of one step on `mols`
    (`m`, `t`: the configuration's "model" and "train" blocks)."""
    loss, g = loss_and_grads(p, mols, m, device)
    if t.get("grad_clip", True):
        norm = float(torch.sqrt(sum((x.double() ** 2).sum()
                                    for x in g.values())))
        if norm >= t["max_grad"]:
            g = {k: x / norm * t["max_grad"] for k, x in g.items()}
    n = st.t + 1
    bc1, bc2 = 1.0 - B1 ** n, 1.0 - B2 ** n
    lr = lr_at(st.t, t)
    new_m, new_v, new_p = {}, {}, {}
    for k in p:
        new_m[k] = B1 * st.m[k] + (1 - B1) * g[k]
        new_v[k] = B2 * st.v[k] + (1 - B2) * g[k] * g[k]
        new_p[k] = p[k] - lr * (new_m[k] / bc1) / (
            torch.sqrt(new_v[k] / bc2) + EPS)
    return new_p, AdamState(n, new_m, new_v), StepResult(loss, g)


def ema_step(ema, p: Dict[str, torch.Tensor], decay: float):
    """The average after a step that left the parameters `p`; `ema` is
    None before the first step."""
    if ema is None:
        return dict(p)
    return {k: decay * ema[k] + (1 - decay) * p[k] for k in p}


def run_steps(p0: Dict[str, torch.Tensor], batches: List[Sequence[Molecule]],
              m: dict, t: dict, device):
    """(parameters, their moving average, each step's StepResult) after
    the steps over `batches` from `p0`."""
    p, st, ema, results = dict(p0), adam_init(p0), None, []
    for mols in batches:
        p, st, res = train_step(p, st, mols, m, t, device)
        ema = ema_step(ema, p, t["ema_decay"])
        results.append(res)
    return p, ema, results
