"""Training CLI of the port, the single-device path of the reference's
train.py (:168-358):

    python -m x2gnn_tpu_torch.train --synthetic 512 --epochs 20 \\
        --workdir runs/smoke                     # on the card
    python -m x2gnn_tpu_torch.train --data mols.xyz --backend native6311 \\
        --config runs/flagship_r5_regression/args.json --pack-mixed \\
        --workdir runs/xyz          # featurize an xyz file, then train
    python -m x2gnn_tpu_torch.train --data-npz cache.npz \\
        --config runs/flagship_r5_regression/args.json --pack-mixed \\
        --workdir runs/packed      # a graph cache, the flagship recipe
    python -m x2gnn_tpu_torch.train --data-npz cache.npz \\
        --config runs/gap_r5_50k/args.json --pack-mixed \\
        --workdir runs/gap       # the gap recipe: molwise_mean, dropout
    python -m x2gnn_tpu_torch.train ... --auto-resume   # after a crash
    python -m x2gnn_tpu_torch.train --config \\
        runs/flagship_r5_regression/args.json --pack-mixed \\
        --compute-dtype bfloat16 --feat-dtype float16 --remat \\
        --accum-steps 2 ...          # the precision and memory options
    python -m x2gnn_tpu_torch.train --device cpu --synthetic 24 \\
        --epochs 2 --batch-size 8 --workdir /tmp/run   # on the CPU
    python -m x2gnn_tpu_torch.train --layout segment ...  # another layout

Data: --synthetic N molecules, made with the model's edge feature width
and cutoff; --data, a concatenated xyz file featurized by `load_dataset`
with --backend (native6311: the port's integral engine on the published
6-311+G(3df,2p) data; native: on the 'x2sv' stand-in; auto: pyscf if
installed, else native6311) into a cache under --cache-dir that later
runs reuse; or --data-npz, a graph cache (`data/dataset.py::
save_graph_cache`). --limit keeps the first N molecules; the targets come
from `prepare_targets`. Featurizing happens before the run touches the
card.

The model is `ModelConfig` (or the `model` block of --config) in the
--layout attention layout (blocked by default, as train.py:35-37; segment
and padded run the flat-edge model), with random weights from seed 0; the
target picks its readout (atomwise for the extensive targets 6-11, else
molwise_mean), and its attention dropout trains with a per-step mask. --resume CKPT continues
from a checkpoint; --auto-resume from the newest `ckpt_*.pt` of the
workdir if there is one. A resumed run trains the epochs left,
max_epoch - step // steps_per_epoch, and numbers them on from there.
Precision and memory (train.py:97-135): --compute-dtype bfloat16 runs
the conv stack in bf16 (parameters stay float32), --feat-dtype float16 or
int8 keeps the edge features so in the device batch cache, --remat
recomputes each conv in the backward, --accum-steps N applies the
optimizer every N micro-batches; a --config's compute_dtype, remat and
accum_steps hold unless a flag overrides them.
--cache-batches auto|on|off|host (train.py:317-322): keep the batches on
the card (on; auto is on up to 20,000 molecules), assemble and stream
them every epoch (off), or assemble them once in host memory and stream
them (host). --profile-dir DIR traces the second epoch into DIR.
--check-determinism runs the first training step twice before training
and exits 3 if the two differ in any bit.
Other flags: --dropout, --target, --epochs, --batch-size, --max-lr,
--scheduler, --warmup-steps, --ema-decay, --patience, --fused-update,
--atomref-fit, --standardize, --ckpt-every, --ckpt-after-epoch,
--bucket-shapes, --pack-budget, --pack-mixed, --device. --data-parallel,
--edge-partition and --dp-groups (ROADMAP A10) raise
NotImplementedError.

Writes provenance.json (the data's basis tag), atomref.json
(--atomref-fit), standardization.json (--standardize), and through
Trainer.fit args.json, metrics.jsonl, train.log and the checkpoints.
Prints the summary as one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

# flags of the reference CLI whose paths the port does not run yet; the
# values that leave them off
_UNPORTED = {
    "data_parallel": ("--data-parallel", "A10"),
    "edge_partition": ("--edge-partition", "A10"),
    "dp_groups": ("--dp-groups", "A10"),
}
_OFF = (None, False, 0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default=None,
                   help="a run's args.json or a reference config.json")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic molecules")
    p.add_argument("--data", default=None,
                   help="a concatenated xyz file, featurized into a cache")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "pyscf", "native", "native6311", "zero"],
                   help="integral featurizer backend for --data")
    p.add_argument("--cache-dir", default="./processed",
                   help="where --data's featurized cache is kept")
    p.add_argument("--data-npz", default=None,
                   help="a graph cache (save_graph_cache npz)")
    p.add_argument("--limit", type=int, default=None,
                   help="use only the first N molecules")
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
    p.add_argument("--resume", default=None,
                   help="checkpoint (.pt) to resume from")
    p.add_argument("--auto-resume", action="store_true",
                   help="resume from the workdir's newest ckpt_*.pt if "
                        "there is one")
    p.add_argument("--ckpt-every", type=int, default=None)
    p.add_argument("--ckpt-after-epoch", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "kernels)")
    p.add_argument("--bucket-shapes", type=int, default=None,
                   help="size-bucketed batch budgets: N classes of batch "
                        "shapes instead of one worst-case shape")
    p.add_argument("--pack-budget", action="store_true",
                   help="with --bucket-shapes: fill each batch to its "
                        "class budget (variable molecules per step)")
    p.add_argument("--pack-mixed", action="store_true",
                   help="mixed first-fit-decreasing packing: one batch "
                        "shape, every batch spans the size distribution")
    p.add_argument("--accum-steps", type=int, default=None,
                   help="gradient accumulation: apply the optimizer every "
                        "N micro-batches (effective batch = N*batch_size)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each attention conv in the backward "
                        "instead of keeping its activations")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default=None,
                   help="conv-stack compute dtype (parameters stay "
                        "float32; bfloat16 halves the kernels' q/k/v/e "
                        "bytes)")
    p.add_argument("--feat-dtype", choices=["float32", "float16", "int8"],
                   default="float32",
                   help="edge-feature dtype in the device batch cache "
                        "(int8 with per-edge scales); the model upcasts "
                        "to float32 at entry")
    p.add_argument("--dropout", type=float, default=None,
                   help="attention-weight dropout (reference "
                        "sbftransformer_conv.py:153)")
    p.add_argument("--cache-batches", choices=["auto", "on", "off", "host"],
                   default="auto",
                   help="where the batches live: on the card (on; auto = "
                        "on up to 20,000 molecules), assembled and streamed "
                        "every epoch (off), or assembled once in host memory "
                        "and streamed (host)")
    p.add_argument("--profile-dir", default=None,
                   help="trace the second epoch with torch.profiler here")
    p.add_argument("--check-determinism", action="store_true",
                   help="before training, run the first training step "
                        "twice and compare the states bitwise; exit 3 if "
                        "they differ")
    p.add_argument("--data-parallel", action="store_true")
    p.add_argument("--edge-partition", default=None)
    p.add_argument("--dp-groups", type=int, default=0)
    p.add_argument("--layout", choices=["segment", "padded", "blocked"],
                   default="blocked",
                   help="attention layout: blocked (the fused kernels), "
                        "segment (triplet rows) or padded (neighbour "
                        "tables)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for field, (flag, item) in _UNPORTED.items():
        if getattr(args, field) not in _OFF:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP {item})")
    if not (args.synthetic or args.data_npz or args.data):
        print("need --synthetic N, --data XYZ or --data-npz CACHE",
              file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from x2gnn_tpu_torch.config import ModelConfig, TrainConfig, load_configs
    from x2gnn_tpu_torch.data.molecule import (
        EXTENSIVE_TARGETS, fit_linear_atomref, report_calibration)
    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    from x2gnn_tpu_torch.device import resolve_device
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.train.checkpoint import latest_checkpoint
    from x2gnn_tpu_torch.train.trainer import (
        Trainer, make_split, resolve_division)

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
                 "bucket_shapes": args.bucket_shapes,
                 "pack_budget": True if args.pack_budget else None,
                 "pack_mixed": True if args.pack_mixed else None,
                 "fused_update": True if args.fused_update else None,
                 "accum_steps": args.accum_steps}
    tcfg = dataclasses.replace(
        tcfg, **{k: v for k, v in overrides.items() if v is not None})
    # model dispatch by target family (train_ema.py:41-44)
    readout = ("atomwise" if tcfg.target in EXTENSIVE_TARGETS
               else "molwise_mean")
    mcfg = dataclasses.replace(mcfg, readout=readout,
                               attention_layout=args.layout)
    if args.compute_dtype is not None:
        mcfg = dataclasses.replace(mcfg, compute_dtype=args.compute_dtype)
    if args.remat:
        mcfg = dataclasses.replace(mcfg, remat=True)
    if args.dropout is not None:
        mcfg = dataclasses.replace(mcfg, dropout=args.dropout)

    # the data first: featurizing runs a process pool of its own before
    # this process touches the card
    if args.synthetic:
        graphs = synthetic_dataset(args.synthetic, cutoff=mcfg.cutoff,
                                   edge_feat_dim=mcfg.edge_feat_dim)
        targets = np.array([g.y[0] for g in graphs], dtype=np.float32)
        std = 1.0
        data_basis = "synthetic-random"
    else:
        from x2gnn_tpu_torch.data.dataset import (
            load_dataset, load_graph_cache, prepare_targets,
            read_cache_basis)
        from x2gnn_tpu_torch.data.featurize import basis_provenance
        if args.data_npz:
            graphs = load_graph_cache(args.data_npz)
            if args.limit:
                graphs = graphs[:args.limit]
            data_basis = read_cache_basis(args.data_npz)
        else:
            graphs = load_dataset(args.data, cache_dir=args.cache_dir,
                                  cutoff=mcfg.cutoff, backend=args.backend,
                                  limit=args.limit)
            data_basis = basis_provenance(args.backend)
        targets = prepare_targets(graphs, tcfg.target)
        # the eV -> kcal/mol calibration applies to 12-property QM9 labels
        multi = graphs[0].y.shape[0] == 12
        std = report_calibration(tcfg.target) if multi else 1.0
    device = resolve_device(args.device)
    # the data's featurization basis beside the checkpoints: evaluation
    # refuses data of another basis
    os.makedirs(args.workdir, exist_ok=True)
    with open(os.path.join(args.workdir, "provenance.json"), "w") as f:
        json.dump({"basis": data_basis}, f)

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
    cache_batches = {"auto": None, "on": True, "off": False,
                     "host": "host"}[args.cache_batches]
    trainer = Trainer(model, mcfg, tcfg, graphs, targets,
                      workdir=args.workdir, std=std,
                      feat_dtype=args.feat_dtype, device=device,
                      cache_batches=cache_batches)
    state = None
    resume_from = args.resume
    if resume_from is None and args.auto_resume:
        # the newest whole TrainState: ckpt_last, or a later ckpt_best
        resume_from = latest_checkpoint(args.workdir)
    epochs = tcfg.max_epoch
    if resume_from:
        state = trainer.restore(resume_from)
        done = int(state.step) // trainer.steps_per_epoch()
        epochs = max(tcfg.max_epoch - done, 0)
        print(f"resumed from {resume_from} at step {int(state.step)} "
              f"(~epoch {done}); {epochs} epochs remaining",
              file=sys.stderr)
    if args.check_determinism:
        from x2gnn_tpu_torch.utils.determinism import (
            check_train_step_determinism)
        report = check_train_step_determinism(trainer, state=state)
        tag = "OK" if report["deterministic"] else "MISMATCH"
        print(f"determinism check: {tag}", file=sys.stderr)
        for m in report["mismatches"]:
            print(f"  {m}", file=sys.stderr)
        if not report["deterministic"]:
            return 3

    _, summary = trainer.fit(epochs=epochs, state=state,
                             profile_dir=args.profile_dir)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
