"""Where the training step's time goes, by ablation (scripts/profile_step.py):

    python -m x2gnn_tpu_torch.scripts.profile_step [--batch 32] [--iters 40]
        [--device cpu]

Times the flagship's training step (blocked layout, random weights from
seed 0) on one batch of `synthetic_dataset(batch, mean_atoms=13, seed=5)`
on its default budgets (degree tiers: one attention launch per tier and
conv), then variants with one subsystem stubbed out, each from the same
parameters and a fresh optimizer state:

- `no_kernel`: the blocked attention returns zeros that still depend on q,
  k, v, e, W and the bias (the projections and gathers run; no attention
  kernel, and not its plain version either);
- `no_norm`: the graph LayerNorm is the identity;
- `readout_mlp_depth1`: the readout heads' MLPs of depth 1;
- `no_radial_sbf`: the radial factor of the 2D basis is ones;
- `opt_ema_only`: a constant loss, so zero gradients: clip, Adam and the
  EMA alone.

Each time is the median of 3 runs of --iters chained steps after 2
warm-up steps, by CUDA events on the card. Prints one JSON line
{"batch", "components": {name: {"ms", "delta_vs_full_ms"}}}; the attention
launches per step of each variant go to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import sys
import time
from unittest import mock

import numpy as np
import torch

from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.device import resolve_device
from x2gnn_tpu_torch.models import x2gnn as model_module
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.nn import conv as conv_module
from x2gnn_tpu_torch.nn.norm import GraphLayerNorm
from x2gnn_tpu_torch.ops import blocked_attn
from x2gnn_tpu_torch.train.optim import apply_update_skip_nonfinite
from x2gnn_tpu_torch.train.trainer import Trainer


def chain_time(step, state, batch, iters: int, device) -> float:
    """Median ms per step of 3 runs of `iters` chained steps, after 2."""
    for _ in range(2):
        state, _ = step(state, batch)
    cuda = device.type == "cuda"
    reps = []
    for _ in range(3):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            state, _ = step(state, batch)
        if cuda:
            end.record()
            torch.cuda.synchronize(device)
            reps.append(start.elapsed_time(end) / iters)
        else:
            reps.append((time.perf_counter() - t0) / iters * 1e3)
    return float(statistics.median(reps))


def zero_kernel(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids,
                heads, num_radial, dropout_mask=None, return_alpha=False):
    """The blocked attention's stand-in: zeros of the output's shape that
    depend on every differentiable input, so that their producers and
    gradients still run."""
    out = q * 0.0 + (k.sum(1, keepdim=True) + v.sum(1, keepdim=True)
                     + e_atom[:, None] + w_sbf.sum() + bias.sum()) * 0.0
    if return_alpha:
        N, DI, _ = q.shape
        return out, q.new_zeros((N, DI, k.shape[1], heads))
    return out


def ones_radial(d, num_spherical, num_radial, cutoff=5.0,
                envelope_exponent=5, edge_mask=None):
    """The radial factor's stand-in: ones, (E, L, K)."""
    return torch.ones(d.shape + (num_spherical, num_radial),
                      dtype=torch.float32, device=d.device) * (
        0.0 * d[..., None, None] + 1.0)


def identity_norm(self, x, graph_ids, num_graphs, mask=None, total=None):
    return x


def profile(batch_size: int = 32, iters: int = 40, device="cuda"):
    """({component: ms per step}, {component: attention launches per step
    {"fwd", "bwd"}}, attention windows of the batch per conv)."""
    device = resolve_device(device)
    graphs = synthetic_dataset(batch_size, mean_atoms=13, seed=5)
    host = pad_graphs(graphs, pad_budget_for(graphs, batch_size))
    batch = host.to(device)
    cfg = ModelConfig(attention_layout="blocked")
    tcfg = TrainConfig(batch_size=batch_size, warmup_steps=5)
    targets = np.zeros(len(graphs), np.float32)

    def trainer_of(mcfg):
        model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)
        return Trainer(model, mcfg, tcfg, graphs, targets, workdir="unused",
                       device=device)

    trainer = trainer_of(cfg)
    initial = [p.detach().clone() for p in trainer.model.parameters()]

    def fresh_state(tr=trainer):
        # the same parameters in every variant: stubs only skip compute
        if tr is trainer:
            with torch.no_grad():
                for p, v in zip(trainer.model.parameters(), initial):
                    p.copy_(v)
        return tr.init_state()

    ms, launches = {}, {}

    def run(name, step=None, tr=trainer, ctx=None):
        step = step or tr.train_step
        blocked_attn.reset_launch_counts()
        with ctx or contextlib.nullcontext():
            ms[name] = chain_time(step, fresh_state(tr), batch, iters,
                                  device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        steps = 2 + 3 * iters
        launches[name] = {
            "fwd": blocked_attn.blocked_attention.launches / steps,
            "bwd": blocked_attn.blocked_attention_bwd_partials.launches
            / steps}
        print(f"{name}: {ms[name]:.3f} ms, attention launches per step "
              f"{launches[name]}", file=sys.stderr, flush=True)

    run("full")
    run("no_kernel", ctx=mock.patch.object(conv_module, "blocked_attention",
                                           zero_kernel))
    run("no_norm", ctx=mock.patch.object(GraphLayerNorm, "forward",
                                         identity_norm))
    run("readout_mlp_depth1",
        tr=trainer_of(dataclasses.replace(cfg, mlp_depth=1)))
    # the model calls the name it imported: patch it there
    run("no_radial_sbf", ctx=mock.patch.object(
        model_module, "sbf_radial_part", ones_radial))

    leaves = list(trainer.model.parameters())

    def opt_only(state, b):
        loss = 0.0 * leaves[0].sum()
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return apply_update_skip_nonfinite(state, loss.detach(), list(grads),
                                           trainer.optimizer, tcfg.ema_decay)

    run("opt_ema_only", step=opt_only)
    windows = len(model_module.attention_windows(
        *host.in_edges.shape, host.n_hi, host.d_lo, host.tiers))
    return ms, launches, windows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ms, _, _ = profile(args.batch, args.iters, args.device)
    full = ms["full"]
    table = {k: {"ms": round(v, 3), "delta_vs_full_ms": round(full - v, 3)}
             for k, v in ms.items()}
    print(json.dumps({"batch": args.batch, "components": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
