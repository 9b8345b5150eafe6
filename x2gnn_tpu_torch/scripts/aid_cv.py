"""k-fold cross-validation on an AID-format xyz file (energies in kcal/mol)
against a linear-in-composition baseline (scripts/aid_cv.py):

    python -m x2gnn_tpu_torch.scripts.aid_cv --data AID_kcal.xyz \\
        --folds 5 --epochs 150 --workdir runs/aid_cv     # on the card
    python -m x2gnn_tpu_torch.scripts.aid_cv --data mols.xyz --folds 3 \\
        --epochs 2 --batch-size 4 --device cpu --workdir /tmp/cv

The molecules are featurized by `load_dataset` with --backend into a
cache under --cache-dir. Folds: a RandomState(--seed) permutation split
by np.array_split (:93-95); fold k tests on part k, validates on the
first max(len(rest) // 8, batch_size) of the rest and trains on the
others (:110-114). Each fold fits a per-element reference energy by least
squares on its train split (`fit_linear_atomref`), trains the flagship
model (blocked layout, atomwise readout, random weights from seed 0) on
the standardized residuals through `Trainer`, on its default budgets
(degree-sorted batches with tiers; windows with more than 40 slots run
the kernels' i-chunked walk), and predicts the fold's molecules with the
EMA weights of ckpt_best.pt, in test order: fixed budgets keep it, so
nothing is bucketed or packed (:140-152). The baseline is the atomref fit
alone. Writes <workdir>/fold_k/result.json (and the Trainer's files)
per fold; --fold k runs only fold k, the others' cached results count;
with every fold's result, <workdir>/summary.json and the means and
standard deviations on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.data.dataset import load_dataset
from x2gnn_tpu_torch.data.molecule import fit_linear_atomref
from x2gnn_tpu_torch.device import resolve_device
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.train.trainer import Trainer

SUMMARY_KEYS = ("test_mae_kcal", "test_mae_kcal_per_atom",
                "baseline_mae_kcal", "baseline_mae_kcal_per_atom")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True,
                    help="an AID-format xyz file, energies in kcal/mol")
    ap.add_argument("--cache-dir", default="./processed")
    ap.add_argument("--backend", default="native",
                    help="featurizer backend: 'native' (the x2sv stand-in) "
                         "or 'native6311' (the published 6-311+G(3df,2p))")
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--workdir", default="runs/aid_cv")
    ap.add_argument("--layout", default="blocked")
    ap.add_argument("--seed", type=int, default=41)
    ap.add_argument("--max-lr", type=float, default=1e-3)
    ap.add_argument("--warmup-steps", type=int, default=300)
    ap.add_argument("--fold", type=int, default=None,
                    help="run only this fold (resumable CV: fold results "
                         "are cached in fold_k/result.json)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def fold_splits(n: int, folds: int, seed: int) -> list:
    """The test molecules of each fold (:93-95)."""
    return np.array_split(np.random.RandomState(seed).permutation(n), folds)


def prepare_fold(graphs, y: np.ndarray, parts: list, k: int,
                 batch_size: int) -> dict:
    """Fold k's split (:110-114), its atomref fitted on the train split
    and its standardized residual targets (:118-123)."""
    test_idx = parts[k]
    rest = np.concatenate([parts[j] for j in range(len(parts)) if j != k])
    val_idx = rest[:max(len(rest) // 8, batch_size)]
    train_idx = rest[len(val_idx):]
    atomref, _ = fit_linear_atomref([g.numbers for g in graphs], y,
                                    train_idx)
    resid = y - atomref
    mu = float(resid[train_idx].mean())
    sigma = float(resid[train_idx].std() + 1e-12)
    return {"test_idx": test_idx, "val_idx": val_idx,
            "train_idx": train_idx, "atomref": atomref, "mu": mu,
            "sigma": sigma,
            "targets": ((resid - mu) / sigma).astype(np.float32)}


def fold_trainer(model, mcfg: ModelConfig, tcfg: TrainConfig, graphs,
                 fold: dict, workdir: str, device) -> Trainer:
    """A Trainer of the fold's targets with the CV split in place of the
    division's (:130-135)."""
    trainer = Trainer(model, mcfg, tcfg, graphs, fold["targets"],
                      workdir=workdir, std=fold["sigma"], device=device)
    trainer.train_idx = fold["train_idx"]
    trainer.val_idx = fold["val_idx"]
    trainer.test_idx = fold["test_idx"]
    return trainer


def fold_out_predictions(trainer: Trainer, state, fold: dict) -> np.ndarray:
    """Total energies of the fold's test molecules, in test order, from the
    EMA weights of `state`: the fitted atomref plus the de-standardized
    residual (:140-151). Fixed-budget batches keep the order; a planner's
    would not."""
    if trainer.packed:
        raise ValueError("fold-out predictions need unbucketed, unpacked "
                         "batches: planned batches reorder the molecules")
    ema = trainer.ema_parameters(state)
    preds = []
    with torch.no_grad():
        for batch in trainer.device_batches(fold["test_idx"]):
            p = torch.func.functional_call(trainer.model, ema, (batch,))
            preds.append(p[batch.graph_mask].cpu().numpy())
    pred_resid = (np.concatenate(preds)[:len(fold["test_idx"])]
                  * fold["sigma"] + fold["mu"])
    return fold["atomref"][fold["test_idx"]] + pred_resid


def run_fold(model, mcfg: ModelConfig, tcfg: TrainConfig, graphs,
             y: np.ndarray, fold: dict, k: int, fold_dir: str, epochs: int,
             device="cuda"):
    """Train fold k from `model`'s weights, then score its fold-out
    predictions and the composition baseline (:130-166). Returns (the
    fold's result.json record, the predictions)."""
    trainer = fold_trainer(model, mcfg, tcfg, graphs, fold, fold_dir,
                           device)
    _, summary = trainer.fit(epochs=epochs)
    best = trainer.restore(os.path.join(fold_dir, "ckpt_best.pt"))
    pred = fold_out_predictions(trainer, best, fold)
    test_idx = fold["test_idx"]
    n_atoms = np.array([graphs[i].num_atoms for i in test_idx])
    err = np.abs(pred - y[test_idx])
    base = np.abs(fold["atomref"][test_idx] - y[test_idx])
    return {
        "fold": k,
        "test_mae_kcal": float(err.mean()),
        "test_mae_kcal_per_atom": float((err / n_atoms).mean()),
        "baseline_mae_kcal": float(base.mean()),
        "baseline_mae_kcal_per_atom": float((base / n_atoms).mean()),
        "best_val_mae_resid_kcal": float(summary["best_val_mae"]),
        "n_train": int(len(fold["train_idx"])),
        "n_test": int(len(test_idx)),
    }, pred


def summarize(results: list) -> dict:
    """Mean and standard deviation of each score over the folds, and the
    folds' records (:172-181)."""
    def agg(key):
        v = np.array([r[key] for r in results])
        return {"mean": float(v.mean()), "std": float(v.std())}

    summary = {k: agg(k) for k in SUMMARY_KEYS}
    summary["folds"] = results
    return summary


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    graphs = load_dataset(args.data, cache_dir=args.cache_dir,
                          backend=args.backend)
    y = np.array([g.y[0] for g in graphs], dtype=np.float64)   # kcal/mol
    print(f"{len(graphs)} molecules, label range [{y.min():.1f}, "
          f"{y.max():.1f}] kcal/mol", file=sys.stderr)
    parts = fold_splits(len(graphs), args.folds, args.seed)
    mcfg = ModelConfig(attention_layout=args.layout, readout="atomwise")
    tcfg = TrainConfig(batch_size=args.batch_size, max_lr=args.max_lr,
                       warmup_steps=args.warmup_steps,
                       random_seed=args.seed, ckpt_after_epoch=0)
    os.makedirs(args.workdir, exist_ok=True)
    results = []
    for k in range(args.folds):
        if args.fold is not None and k != args.fold:
            continue
        fold_dir = os.path.join(args.workdir, f"fold_{k}")
        cache = os.path.join(fold_dir, "result.json")
        if os.path.exists(cache):
            with open(cache) as f:
                results.append(json.load(f))
            print(f"fold {k}: cached {results[-1]}", file=sys.stderr)
            continue
        fold = prepare_fold(graphs, y, parts, k, args.batch_size)
        model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)
        res, _ = run_fold(model, mcfg, tcfg, graphs, y, fold, k, fold_dir,
                          args.epochs, device)
        with open(cache, "w") as f:
            json.dump(res, f, indent=1)
        results.append(res)
        print(f"fold {k}: {res}", file=sys.stderr, flush=True)

    if len(results) == args.folds:
        summary = summarize(results)
        with open(os.path.join(args.workdir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps({k: summary[k] for k in summary if k != "folds"},
                         indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
