"""Serving throughput: batched Predictor inference (scripts/bench_infer.py).

    python -m x2gnn_tpu_torch.scripts.bench_infer [--molecules 256]
        [--mean-atoms 18] [--batch-size 32] [--iters 5] [--device cpu]

Steady-state molecules/s of the flagship model's forward (blocked layout,
random weights from seed 0) through the serving path (`infer.py::
Predictor.predict` on `synthetic_dataset(molecules, mean_atoms, seed=11)`),
host batch padding and copies included: one warm-up pass (which builds
the kernels), then the mean over --iters passes. Prints one JSON line
{"metric": "serving_throughput", "value", "unit", "vs_baseline"}; the
device and the edge and triplet rates go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from x2gnn_tpu_torch.config import ModelConfig
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.device import resolve_device
from x2gnn_tpu_torch.infer import Predictor
from x2gnn_tpu_torch.models.x2gnn import X2GNN


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--molecules", type=int, default=256)
    ap.add_argument("--mean-atoms", type=int, default=18)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    log("device: " + (f"cuda {torch.cuda.get_device_name(device)}"
                      if device.type == "cuda" else "cpu"))
    cfg = ModelConfig(attention_layout="blocked")
    graphs = synthetic_dataset(args.molecules, mean_atoms=args.mean_atoms,
                               seed=11)
    model = X2GNN(cfg, torch.Generator().manual_seed(0), device=device)
    pred = Predictor(cfg, model, batch_size=args.batch_size, device=device)

    n_edges = sum(g.num_edges for g in graphs)
    n_trip = sum(g.num_triplets for g in graphs)
    out = pred.predict(graphs)          # warm-up, builds the kernels
    assert out.shape == (args.molecules,)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = pred.predict(graphs)      # returns host arrays: synchronized
    dt = (time.perf_counter() - t0) / args.iters
    mols_s = args.molecules / dt
    log(f"{args.molecules} molecules in {dt * 1e3:.1f} ms -> {mols_s:.0f} "
        f"molecules/s, {n_edges / dt / 1e6:.2f} M edges/s, "
        f"{n_trip / dt / 1e6:.2f} M triplets/s")
    print(json.dumps({
        "metric": "serving_throughput",
        "value": round(mols_s, 1),
        "unit": "molecules/s/chip (incl. host batching)",
        "vs_baseline": None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
