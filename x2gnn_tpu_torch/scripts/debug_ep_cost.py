"""Where the edge-partitioned (EP) step's time goes, piece by piece, at
world size 1 (scripts/debug_ep_cost.py):

    python -m x2gnn_tpu_torch.scripts.debug_ep_cost [--device cpu]

On one batch of `synthetic_dataset(32, mean_atoms=13, seed=5)` (default
budgets) in the EP layout of one rank (`parallel/ep_model.py`), the
flagship model with random weights from seed 0, times by CUDA events on
the card (mean of 20 calls after one) and prints, one per line:

- `fwd_ms`: the EP forward (`make_ep_forward`);
- `blocked_fwd_ms`: the blocked model's forward on the same batch (its
  degree tiers, no collectives);
- `exchange_ms`: the row exchange of the features into the out-table;
- `norm_ms`: the graph LayerNorm on 128 feature columns, its sums
  all-reduced;
- `kernel_fullD_ms`: the forward kernel on the EP window (all N atoms,
  D x D slots, no tier split; random activations, the batch's masked
  ids);
- `geom_ms`: the geometry (all-gathered positions, distances, angles);
- `emb_ms`: the embedding block.

Joins a process group of one (NCCL on the card, gloo on the CPU) unless
one is initialized.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from x2gnn_tpu_torch.config import ModelConfig
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.device import resolve_device
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.nn.norm import GraphLayerNorm
from x2gnn_tpu_torch.ops.blocked_attn import blocked_attention
from x2gnn_tpu_torch.parallel import ep_model as epm
from x2gnn_tpu_torch.parallel.mesh import initialize_distributed, make_mesh


def timeit(fn, device, iters: int = 20) -> float:
    """Mean ms of one call of fn over `iters` calls after one."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def run(device, B: int = 32, iters: int = 20) -> dict:
    """The pieces' times {name: ms}, printed as they come."""
    graphs = synthetic_dataset(B, mean_atoms=13, seed=5)
    batch = pad_graphs(graphs, pad_budget_for(graphs, B))
    cfg = ModelConfig(attention_layout="blocked")
    model = X2GNN(cfg, torch.Generator().manual_seed(0), device=device)
    mesh = make_mesh(1)
    axis = epm._Axis.of(mesh)
    epb = epm.make_ep_batch(batch, 1)
    epbs = epm.shard_ep_batch(epb, mesh, device)
    Nl, D = epb.in_mask.shape
    print(f"N={Nl} D={D}", flush=True)
    times = {}

    def report(name, fn):
        with torch.no_grad():
            times[name] = timeit(fn, device, iters)
        print(name, times[name], flush=True)

    fwd = epm.make_ep_forward(mesh)
    report("fwd_ms", lambda: fwd(model, epbs))
    dev_batch = batch.to(device)
    report("blocked_fwd_ms", lambda: model(dev_batch))
    feat = epbs.feat_blk.reshape(Nl * D, -1).float()
    report("exchange_ms", lambda: epm.exchange(feat, epbs, axis).sum())
    norm = GraphLayerNorm()
    gid, mask = epbs.edge_gid_blk.reshape(-1), epbs.in_mask.reshape(-1)
    report("norm_ms", lambda: norm(
        feat[:, :128], gid, B, mask=mask,
        total=lambda s: epm.all_reduce_sum(s, axis)).sum())

    # the forward kernel on the EP window, random activations
    rng = np.random.default_rng(0)
    HC, H, L, K = cfg.in_channels, cfg.heads, cfg.sbf_dim, cfg.rbf_dim

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device)

    q, ea, rbf = normal(Nl, D, HC), normal(Nl, HC), normal(Nl, D, L * K)
    w, bias = normal(L * K, HC), normal(HC)
    z = torch.from_numpy(rng.uniform(-1, 1, size=(Nl, D, D)).astype(
        np.float32)).to(device)
    a_ids = torch.where(epbs.in_mask, epbs.edge_src_blk, -1).to(torch.int32)
    b_ids = torch.where(epbs.out_mask, epbs.out_dst_blk, -2).to(torch.int32)
    report("kernel_fullD_ms", lambda: blocked_attention(
        q, q, q, ea, rbf, w, bias, z, a_ids, b_ids, heads=H,
        num_radial=K).sum())

    def geom():
        pos_g = epm.all_gather_rows(epbs.positions, axis)
        own = epbs.positions[:, None, :]
        ji = pos_g[epbs.edge_src_blk] - own
        d = torch.sqrt(torch.clamp((ji * ji).sum(-1), min=1e-24))
        jk = pos_g[epbs.out_dst_blk] - own
        cos_a = torch.einsum("nid,nkd->nik", ji, jk)
        d_out = torch.sqrt(torch.clamp((jk * jk).sum(-1), min=1e-24))
        norm_ = torch.clamp(d[:, :, None] * d_out[:, None, :], min=1e-12)
        return torch.clamp(cos_a / norm_, -1.0, 1.0).sum()

    report("geom_ms", geom)
    report("emb_ms", lambda: model.emb_block(epbs.numbers).sum())
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    own_group = not dist.is_initialized()
    if own_group:
        device = initialize_distributed(device=args.device)
    try:
        run(device)
    finally:
        if own_group:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
