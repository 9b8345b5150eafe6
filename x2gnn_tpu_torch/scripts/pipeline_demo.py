"""Epochs streamed from the host at scale (scripts/pipeline_demo.py):

    python -m x2gnn_tpu_torch.scripts.pipeline_demo \\
        [--cache processed/synthq134k_geo.npz] [--division 10000 20000] \\
        [--workdir runs/pipeline_demo] [--device cpu]

Trains 2 epochs of the flagship model (blocked layout, batch 32, fixed
budgets) on a geometry-only graph cache (`python -m
x2gnn_tpu_torch.data.make_synthetic --geometry-only`: zero features and
labels, so the batches have a featurized set's shapes and bytes) with the
batch cache off: every step's batch is assembled on the host in the
prefetch thread, pinned and copied to the card on a stream of its own
(`Trainer(cache_batches=False)`), its features float16. --division is
the test and validation split (the reference's 10k/10k/rest on 134k
molecules). Prints one JSON line: steps_per_epoch, epoch1_s (building the
kernels included), epoch2_s and ms_per_step_prefetch (epoch 2's seconds,
evaluation included, per training step).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.data.dataset import load_graph_cache
from x2gnn_tpu_torch.device import resolve_device
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.train.trainer import Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache", default="processed/synthq134k_geo.npz")
    ap.add_argument("--division", type=int, nargs=2,
                    default=(10000, 20000), metavar=("TEST", "VAL_END"))
    ap.add_argument("--workdir", default="runs/pipeline_demo")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.time()
    graphs = load_graph_cache(args.cache)
    print(f"loaded {len(graphs)} graphs in {time.time() - t0:.0f}s",
          file=sys.stderr, flush=True)
    y = np.zeros(len(graphs), np.float32)
    mcfg = ModelConfig(attention_layout="blocked")
    tcfg = TrainConfig(batch_size=32, division=tuple(args.division),
                       warmup_steps=3000, ckpt_after_epoch=10**9)
    model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)
    tr = Trainer(model, mcfg, tcfg, graphs, y, workdir=args.workdir,
                 cache_batches=False,        # the demo: the prefetch path
                 feat_dtype="float16", device=device)
    steps = tr.steps_per_epoch()
    print(f"steps/epoch = {steps}", file=sys.stderr, flush=True)
    tr.fit(epochs=2)
    with open(os.path.join(args.workdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f][-2:]   # this run's epochs
    print(json.dumps({
        "steps_per_epoch": steps,
        "epoch1_s": recs[0]["seconds"],     # building the kernels included
        "epoch2_s": recs[1]["seconds"],     # the streamed steady state
        "ms_per_step_prefetch": 1e3 * recs[1]["seconds"] / steps,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
