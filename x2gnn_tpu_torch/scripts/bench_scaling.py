"""Weak-scaling efficiency of the parallel training steps
(scripts/bench_scaling.py):

    python -m x2gnn_tpu_torch.scripts.bench_scaling          # one card
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m x2gnn_tpu_torch.scripts.bench_scaling [--modes dp,ep,hybrid]
    python -m x2gnn_tpu_torch.scripts.bench_scaling --force-cpu-devices 4

Every rank gets the same work, so the ideal step time on N ranks is the
one-rank time, and efficiency = t(1) / t(N):

- `single`: rank 0 alone runs the plain step (no collectives) on its
  molecules, `synthetic_dataset(mols_per_device, mean_atoms, seed=0)`,
  padded to budgets over every rank's set;
- `dp`: each rank steps its own set (seed = rank) at those budgets,
  gradients all-reduced (`parallel/data_parallel.py`);
- `ep`: one batched graph of N copies of rank 0's molecules, its atoms
  split over the ranks (`parallel/ep_model.py`), every rank holding the
  single step's padded work;
- `hybrid`: 2 rows of N/2 EP ranks (N >= 4, even), each row a group of
  N/2 copies of its molecules (`parallel/hybrid.py`).

One process per rank: torch.distributed.run's, each on the card of its
LOCAL_RANK over NCCL (with --device cpu over gloo); without it a group of
one, which runs `single` only. --force-cpu-devices N starts N gloo ranks
on the CPU itself (one torch thread per core share); their numbers
measure core sharing, not an interconnect, and print with "virtual":
true, as every CPU run's do. Each step time is the mean over --iters
steps after 2, wall clock around a device synchronize. Rank 0 prints one
JSON line per (mode, n_devices); diagnostics go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.device import resolve_device
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.parallel import (
    initialize_distributed, make_dp_train_step, make_ep_batch,
    make_ep_train_step, make_hybrid_mesh, make_hybrid_train_step, make_mesh,
    shard_ep_batch, shard_hybrid_batch, stack_ep_batches)
from x2gnn_tpu_torch.train.ema import ema_init
from x2gnn_tpu_torch.train.loss import smooth_l1_loss
from x2gnn_tpu_torch.train.optim import (
    Optimizer, apply_update_skip_nonfinite)
from x2gnn_tpu_torch.train.trainer import TrainState


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default="dp,ep,hybrid")
    ap.add_argument("--force-cpu-devices", type=int, default=0,
                    help="start this many gloo ranks on the CPU")
    ap.add_argument("--mols-per-device", type=int, default=8)
    ap.add_argument("--mean-atoms", type=int, default=18)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_step(step, state, batch, device, iters=10, warmup=2):
    """(seconds per step over `iters` steps after `warmup`, state)."""
    for _ in range(warmup):
        state = step(state, batch)[0]
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state, batch)[0]
    _sync(device)
    return (time.perf_counter() - t0) / iters, state


def scale_budgets(b, k):
    """The budgets of k copies of a set: the counts, the split row and the
    tier rows k-fold, the degree budgets as they are, so that each of k
    shards pads to the one-copy work."""
    return b._replace(n_node=b.n_node * k, n_edge=b.n_edge * k,
                      n_trip=b.n_trip * k, n_hi=b.n_hi * k,
                      tiers=tuple((end * k, di, dk)
                                  for end, di, dk in b.tiers))


def run(args, device, virtual: bool) -> list:
    """Every mode this world size runs; rank 0's result records (the
    others return [])."""
    n_dev, rank = dist.get_world_size(), dist.get_rank()
    if rank == 0:
        log(f"{n_dev} {device.type} ranks (virtual={virtual})")
    mcfg = ModelConfig(attention_layout="blocked")
    tcfg = TrainConfig(batch_size=args.mols_per_device, warmup_steps=10)
    per = args.mols_per_device
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]

    def fresh():
        model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)
        opt = Optimizer(tcfg)
        leaves = list(model.parameters())
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return model, opt, TrainState(leaves, opt.init(leaves),
                                      ema_init(leaves), zero, zero.clone())

    def edges(batch):
        return int(np.asarray(batch.in_mask).sum())

    # budgets over the union of every rank's set: the single step and
    # every DP shard pad to the same shapes
    gsets = [synthetic_dataset(per, mean_atoms=args.mean_atoms, seed=i)
             for i in range(n_dev)]
    per_dev = pad_budget_for([g for gs in gsets for g in gs], per)
    graphs1 = gsets[0]
    results = []

    def record(mode, t, e, **extra):
        results.append({"mode": mode, "n_devices": n_dev if mode != "single"
                        else 1, **extra, "ms_per_step": round(t * 1e3, 3),
                        "edges_per_s": round(e / t),
                        "efficiency": 1.0 if mode == "single"
                        else round(t1 / t, 4), "virtual": virtual})

    t1 = None
    if rank == 0:
        b1 = pad_graphs(graphs1, per_dev)
        model, opt, state = fresh()
        leaves = list(model.parameters())

        def single_step(state, batch):
            # the parallel steps' body without the collectives
            loss = smooth_l1_loss(model(batch), batch.y,
                                  mask=batch.graph_mask)
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
            return apply_update_skip_nonfinite(state, loss.detach(),
                                               list(grads), opt,
                                               tcfg.ema_decay)

        t1, _ = time_step(single_step, state, b1.to(device), device,
                          args.iters)
        log(f"1-device baseline: {t1 * 1e3:.2f} ms/step, {edges(b1)} edges")
        record("single", t1, edges(b1))
    if n_dev > 1:
        dist.barrier()

    if "dp" in modes and n_dev > 1:
        mesh = make_mesh()
        batches = [pad_graphs(gs, per_dev) for gs in gsets]
        model, opt, state = fresh()
        step = make_dp_train_step(model, opt, tcfg.ema_decay, mesh)
        tN, _ = time_step(step, state, batches[rank].to(device), device,
                          args.iters)
        if rank == 0:
            log(f"dp x{n_dev}: {tN * 1e3:.2f} ms/step, efficiency "
                f"{t1 / tN:.1%}")
            record("dp", tN, sum(edges(b) for b in batches))

    if "ep" in modes and n_dev > 1:
        # one batched graph of n_dev copies of rank 0's molecules, its atoms
        # split over the ranks: each holds the single step's padded work
        mesh = make_mesh()
        big = pad_graphs([g for _ in range(n_dev) for g in graphs1],
                         scale_budgets(per_dev, n_dev))
        epb = make_ep_batch(big, n_dev)
        model, opt, state = fresh()
        step = make_ep_train_step(model, opt, tcfg.ema_decay, mesh)
        tN, _ = time_step(step, state, shard_ep_batch(epb, mesh, device),
                          device, args.iters)
        if rank == 0:
            log(f"ep x{n_dev}: {tN * 1e3:.2f} ms/step, efficiency "
                f"{t1 / tN:.1%}")
            record("ep", tN, int(np.asarray(epb.in_mask).sum()))

    if "hybrid" in modes and n_dev >= 4 and n_dev % 2 == 0:
        dp, ep_w = 2, n_dev // 2
        mesh = make_hybrid_mesh(dp, ep_w)
        # each row: ep_w copies of its molecules, so that every rank holds
        # the single step's work
        groups = [[g for _ in range(ep_w) for g in gsets[i]]
                  for i in range(dp)]
        budgets = scale_budgets(per_dev, ep_w)
        epbs = [make_ep_batch(pad_graphs(g, budgets), ep_w) for g in groups]
        model, opt, state = fresh()
        step = make_hybrid_train_step(model, opt, tcfg.ema_decay, mesh)
        tN, _ = time_step(step, state, shard_hybrid_batch(
            stack_ep_batches(epbs), mesh, device), device, args.iters)
        if rank == 0:
            log(f"hybrid {dp}x{ep_w}: {tN * 1e3:.2f} ms/step, efficiency "
                f"{t1 / tN:.1%}")
            record("hybrid", tN, int(sum(np.asarray(e.in_mask).sum()
                                         for e in epbs)), dp=dp, ep=ep_w)
    if rank == 0:
        for r in results:
            print(json.dumps(r), flush=True)
    return results


def _cpu_rank(rank, world, store, args):
    torch.set_num_threads(max((os.cpu_count() or 1) // world, 1))
    initialize_distributed(f"file://{store}", world, rank, device="cpu")
    try:
        run(args, torch.device("cpu"), virtual=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.force_cpu_devices:
        tmp = tempfile.mkdtemp()
        try:
            torch.multiprocessing.spawn(
                _cpu_rank, args=(args.force_cpu_devices,
                                 os.path.join(tmp, "store"), args),
                nprocs=args.force_cpu_devices, join=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return 0
    resolve_device(args.device)
    own_group = not dist.is_initialized()
    device = (initialize_distributed(device=args.device) if own_group
              else resolve_device(args.device,
                                  int(os.environ.get("LOCAL_RANK", 0))))
    try:
        run(args, device, virtual=device.type == "cpu")
    finally:
        if own_group:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
