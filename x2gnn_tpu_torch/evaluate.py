"""Evaluation CLI of the port (evaluate.py:20-202): restore a trained
checkpoint and report its MAE on a dataset featurized as the training
data was.

    python -m x2gnn_tpu_torch.evaluate --ckpt runs/u0/ckpt_best.pt \\
        --data-npz cache.npz                 # on the card
    python -m x2gnn_tpu_torch.evaluate --ckpt runs/u0/ckpt_best.pt \\
        --data mols.xyz --backend native6311 # featurized as training does
    python -m x2gnn_tpu_torch.evaluate --ckpt runs/smoke/ckpt_best.pt \\
        --synthetic 64 --device cpu

The run's args.json, standardization.json and atomref.json are read from
the checkpoint's directory unless --config / --stats say otherwise.
--target picks the readout as the training CLI does (atomwise for the
extensive targets 6-11, else molwise_mean: a gap-recipe run takes
--target 4). The
data's featurization basis is held against the run's provenance.json
(--allow-basis-mismatch turns the refusal into a warning). The EMA
weights are evaluated unless --use-live-params. Prints one JSON line
{"mae", "count", "unit"}, and the seconds of its one (cold) pass on
stderr.
--data featurizes an xyz file as the training CLI does (--backend,
--cache-dir, --limit; `load_dataset`) before anything touches the card.
Layouts other than blocked are not ported yet (ROADMAP A8b).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", required=True, help="a checkpoint (.pt)")
    p.add_argument("--config", default=None,
                   help="the run's args.json or a reference config.json "
                        "(default: args.json beside the checkpoint)")
    p.add_argument("--data", default=None, help="concatenated xyz file")
    p.add_argument("--data-npz", default=None,
                   help="a graph cache (save_graph_cache npz)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "pyscf", "native", "native6311", "zero"],
                   help="integral featurizer backend for --data")
    p.add_argument("--cache-dir", default="./processed",
                   help="where --data's featurized cache is kept")
    p.add_argument("--limit", type=int, default=None,
                   help="use only the first N molecules")
    p.add_argument("--stats", default=None,
                   help="standardization.json of the training run (mu and "
                        "sigma applied to the targets; the MAE is reported "
                        "in physical units)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="evaluate on N synthetic molecules")
    p.add_argument("--target", type=int, default=7)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--layout", choices=["segment", "padded", "blocked"],
                   default="blocked")
    p.add_argument("--allow-basis-mismatch", action="store_true",
                   help="warn instead of refusing when the data's basis "
                        "differs from the run's provenance.json")
    p.add_argument("--use-live-params", action="store_true",
                   help="evaluate the live (non-EMA) weights")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "kernels)")
    return p.parse_args(argv)


def absolute_error(model, graphs, targets, batch_size: int):
    """(sum of |prediction - target|, molecule count) of `model` over
    `graphs`, in the targets' units, batch by batch on the model's
    device."""
    import torch

    from x2gnn_tpu_torch.data.batching import batch_iterator, pad_budget_for
    from x2gnn_tpu_torch.train.loss import masked_mae

    device = next(model.parameters()).device
    total, count = 0.0, 0
    budgets = pad_budget_for(graphs, batch_size)
    with torch.inference_mode():
        for batch in batch_iterator(graphs, batch_size, budgets=budgets,
                                    targets=targets):
            b = batch.to(device)
            total += float(masked_mae(model(b), b.y, mask=b.graph_mask))
            count += int(batch.graph_mask.sum())
    return total, count


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.layout != "blocked":
        raise NotImplementedError(
            f"--layout {args.layout} is not ported yet (ROADMAP A8b)")

    from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
    from x2gnn_tpu_torch.data.featurize import check_basis_compatible
    from x2gnn_tpu_torch.data.molecule import (
        EXTENSIVE_TARGETS, report_calibration)
    from x2gnn_tpu_torch.device import resolve_device
    from x2gnn_tpu_torch.infer import Predictor, load_run_configs

    # the run's archived configs and standardization beside the
    # checkpoint, as Predictor.from_run reads them: a run with another
    # cutoff or width evaluated with default configs would give garbage
    run_dir = os.path.dirname(os.path.abspath(args.ckpt))
    for field, name in (("config", "args.json"),
                        ("stats", "standardization.json")):
        cand = os.path.join(run_dir, name)
        if getattr(args, field) is None and os.path.exists(cand):
            setattr(args, field, cand)
            print(f"using {cand}", file=sys.stderr)
    if args.config:
        mcfg, tcfg = load_run_configs(args.config)
    else:
        mcfg, tcfg = ModelConfig(), TrainConfig()
    readout = ("atomwise" if args.target in EXTENSIVE_TARGETS
               else "molwise_mean")
    mcfg = dataclasses.replace(mcfg, readout=readout,
                               attention_layout=args.layout)

    multi = False
    if args.synthetic:
        from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
        graphs = synthetic_dataset(args.synthetic, cutoff=mcfg.cutoff,
                                   edge_feat_dim=mcfg.edge_feat_dim)
        targets = np.array([g.y[0] for g in graphs], dtype=np.float32)
        std = 1.0
        data_basis = "synthetic-random"
    elif args.data_npz:
        from x2gnn_tpu_torch.data.dataset import (
            load_graph_cache, prepare_targets, read_cache_basis)
        data_basis = read_cache_basis(args.data_npz)
        graphs = load_graph_cache(args.data_npz)
        if args.limit:
            graphs = graphs[:args.limit]
        targets = prepare_targets(graphs, args.target)
        multi = graphs[0].y.shape[0] == 12
        std = report_calibration(args.target) if multi else 1.0
    elif args.data:
        from x2gnn_tpu_torch.data.dataset import (
            load_dataset, prepare_targets)
        from x2gnn_tpu_torch.data.featurize import basis_provenance
        graphs = load_dataset(args.data, cache_dir=args.cache_dir,
                              cutoff=mcfg.cutoff, backend=args.backend,
                              limit=args.limit)
        targets = prepare_targets(graphs, args.target)
        multi = graphs[0].y.shape[0] == 12
        std = report_calibration(args.target) if multi else 1.0
        data_basis = basis_provenance(args.backend)
    else:
        print("need --data, --data-npz or --synthetic", file=sys.stderr)
        return 2

    # provenance guard: features of another quantum basis give silently
    # wrong predictions
    run_basis = None
    prov = os.path.join(run_dir, "provenance.json")
    if os.path.exists(prov):
        with open(prov) as f:
            run_basis = json.load(f).get("basis")
    check_basis_compatible(run_basis, data_basis,
                           allow=args.allow_basis_mismatch,
                           context=f" (ckpt {args.ckpt})")

    # a run trained with --atomref-fit predicts composition-subtracted
    # residuals: subtract the archived per-element table from the targets
    # (atomref first, then standardization, as the training CLI does)
    atomref_path = os.path.join(run_dir, "atomref.json")
    if os.path.exists(atomref_path):
        with open(atomref_path) as f:
            table = json.load(f)
        icept = float(table.pop("intercept", 0.0))
        refs = {int(z): float(c) for z, c in table.items()}
        # an element missing from the table would add 0.0 reference
        # energy: off by ~1e3 kcal/mol per atom
        missing = sorted({int(z) for g in graphs for z in g.numbers}
                         - set(refs))
        if missing:
            raise SystemExit(
                f"elements Z={missing} appear in the eval set but are "
                f"missing from {atomref_path} (not seen at training "
                "time); atomref residuals would be wrong by ~1e3 "
                "kcal/atom")
        targets = np.asarray(targets, np.float64) - np.array(
            [sum(refs[int(z)] for z in g.numbers) + icept for g in graphs])
        print(f"using {atomref_path} (reported MAE is on atomref "
              "residuals)", file=sys.stderr)
    if args.stats:
        with open(args.stats) as f:
            stats = json.load(f)
        targets = ((targets - stats["mu"]) / stats["sigma"]).astype(
            np.float32)
        std *= stats["sigma"]

    device = resolve_device(args.device)
    model = Predictor.from_checkpoint(
        args.ckpt, model_cfg=mcfg, use_ema=not args.use_live_params,
        device=device).model
    t0 = time.perf_counter()
    total, count = absolute_error(model, graphs, targets, args.batch_size)
    seconds = time.perf_counter() - t0
    mae = std * total / max(count, 1)
    # one pass in a fresh process: the first calls' set-up (library
    # handles, kernel loads, batch planning) is part of these seconds
    print(f"evaluated {count} molecules in {seconds:.3f} s, one cold pass",
          file=sys.stderr)
    # the eV -> kcal/mol calibration applies to 12-property QM9 energy
    # targets only; otherwise the MAE is in the dataset's label units
    calibrated = multi and report_calibration(args.target) != 1.0
    print(json.dumps({"mae": mae, "count": count,
                      "unit": ("kcal/mol" if calibrated
                               else "dataset label units")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
