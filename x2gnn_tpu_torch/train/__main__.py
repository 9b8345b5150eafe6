"""Training CLI of the port, the single-device path of the reference's
train.py (:168-358):

    python -m x2gnn_tpu_torch.train --synthetic 512 --epochs 20 \\
        --workdir runs/smoke                     # on the card
    python -m x2gnn_tpu_torch.train --device cpu --synthetic 24 \\
        --epochs 2 --batch-size 8 --workdir /tmp/run   # on the CPU

The model is `ModelConfig` (or the `model` block of --config) in the
blocked layout, with random weights from seed 0. Synthetic molecules are
made with the model's edge feature width and cutoff. Writes
provenance.json, atomref.json (--atomref-fit), standardization.json
(--standardize), and through Trainer.fit args.json, metrics.jsonl,
train.log and the checkpoints. Prints the summary as one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

# flags of the reference CLI whose paths the port does not run yet
_UNPORTED = {
    "pack_mixed": ("--pack-mixed", "A8"),
    "data_parallel": ("--data-parallel", "A10"),
    "edge_partition": ("--edge-partition", "A10"),
    "resume": ("--resume", "A7"),
    "data": ("--data", "A7"),
    "data_npz": ("--data-npz", "A7"),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default=None,
                   help="a run's args.json or a reference config.json")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic molecules")
    p.add_argument("--target", type=int, default=None,
                   help="QM9 property index (overrides config)")
    p.add_argument("--workdir", default="./runs/run0")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--max-lr", type=float, default=None)
    p.add_argument("--scheduler", choices=["warmup_exp", "plateau"],
                   default=None)
    p.add_argument("--warmup-steps", type=int, default=None)
    p.add_argument("--ema-decay", type=float, default=None)
    p.add_argument("--patience", type=int, default=None)
    p.add_argument("--fused-update", action="store_true",
                   help="clip, Adam and EMA on one flat parameter vector")
    p.add_argument("--atomref-fit", action="store_true",
                   help="subtract a least-squares per-element reference "
                        "energy fitted on the train split")
    p.add_argument("--standardize", action="store_true",
                   help="z-score targets; the MAE is reported in physical "
                        "units")
    p.add_argument("--ckpt-every", type=int, default=None)
    p.add_argument("--ckpt-after-epoch", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "kernels)")
    p.add_argument("--pack-mixed", action="store_true")
    p.add_argument("--data-parallel", action="store_true")
    p.add_argument("--edge-partition", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--data", default=None)
    p.add_argument("--data-npz", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for field, (flag, item) in _UNPORTED.items():
        if getattr(args, field):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP {item})")
    if not args.synthetic:
        print("need --synthetic N (real datasets are not ported yet)",
              file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from x2gnn_tpu_torch.config import ModelConfig, TrainConfig, load_configs
    from x2gnn_tpu_torch.data.molecule import (
        EXTENSIVE_TARGETS, fit_linear_atomref)
    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    from x2gnn_tpu_torch.device import resolve_device
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.train.trainer import (
        Trainer, make_split, resolve_division)

    device = resolve_device(args.device)
    if args.config:
        mcfg, tcfg = load_configs(args.config)
    else:
        mcfg, tcfg = ModelConfig(), TrainConfig()
    overrides = {"target": args.target, "max_epoch": args.epochs,
                 "ckpt_after_epoch": args.ckpt_after_epoch,
                 "batch_size": args.batch_size,
                 "ckpt_every": args.ckpt_every, "max_lr": args.max_lr,
                 "warmup_steps": args.warmup_steps,
                 "ema_decay": args.ema_decay, "scheduler": args.scheduler,
                 "patience": args.patience,
                 "fused_update": True if args.fused_update else None}
    tcfg = dataclasses.replace(
        tcfg, **{k: v for k, v in overrides.items() if v is not None})
    # model dispatch by target family (train_ema.py:41-44)
    readout = ("atomwise" if tcfg.target in EXTENSIVE_TARGETS
               else "molwise_mean")
    mcfg = dataclasses.replace(mcfg, readout=readout,
                               attention_layout="blocked")

    graphs = synthetic_dataset(args.synthetic, cutoff=mcfg.cutoff,
                               edge_feat_dim=mcfg.edge_feat_dim)
    targets = np.array([g.y[0] for g in graphs], dtype=np.float32)
    std = 1.0
    os.makedirs(args.workdir, exist_ok=True)
    with open(os.path.join(args.workdir, "provenance.json"), "w") as f:
        json.dump({"basis": "synthetic-random"}, f)

    if args.atomref_fit:
        # the split the Trainer will build: the fit sees train molecules
        n = len(graphs)
        fit_idx, _, _ = make_split(n, tcfg.random_seed,
                                   resolve_division(n, tcfg.division))
        atomref_pred, table = fit_linear_atomref(
            [g.numbers for g in graphs], targets, fit_idx)
        targets = np.asarray(targets, np.float64) - atomref_pred
        print(f"atomref-fit: residual std {targets[fit_idx].std():.4f}",
              file=sys.stderr)
        with open(os.path.join(args.workdir, "atomref.json"), "w") as f:
            json.dump(table, f, indent=1)
    if args.standardize:
        mu, sigma = float(np.mean(targets)), float(np.std(targets) + 1e-12)
        targets = ((targets - mu) / sigma).astype(np.float32)
        std *= sigma
        print(f"standardized targets: mu={mu:.4f} sigma={sigma:.4f}",
              file=sys.stderr)
        with open(os.path.join(args.workdir, "standardization.json"),
                  "w") as f:
            json.dump({"mu": mu, "sigma": sigma}, f)

    model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)
    trainer = Trainer(model, mcfg, tcfg, graphs, targets,
                      workdir=args.workdir, std=std, device=device)
    _, summary = trainer.fit(epochs=tcfg.max_epoch)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
