"""Regenerate tests/torch_port_curve_jax.json, the JAX Trainer's training
curve that chip_smoke.py's phase 15 holds the port's curve on the card
to (~30 min on 8 CPU cores: five JAX runs of ~6 min):

    env JAX_PLATFORMS=cpu python tests/torch_port_make_curve.py

The set is the first CURVE_MOLECULES molecules of the A12 set, built by
the port's builder as `python -m x2gnn_tpu_torch.data.make_synthetic
--n 1024 --basis 6311 --gap-label` builds them (seed 7, 13 mean atoms;
each molecule's geometry is seeded by (seed, index), so they are the
first 1,024 of synthq50k_6311). The recipe is
runs/flagship_r5_regression/args.json as written, with the atomref fit
and the standardization of train.py:257-270, for CURVE_EPOCHS epochs.
The initial weights are the port's: X2GNN(ModelConfig, torch.Generator()
.manual_seed(INIT_SEED)) on the CPU, moved into the JAX Trainer through
export_params_flat, the optimizer and EMA state started from them, and
`Trainer.fit(state=...)`. Four more JAX runs (the twins) start from those
weights times (1 + NOISE * z), z standard normal from
np.random.default_rng(seed) for each seed of NOISE_SEEDS, about the float32
rounding another summation order leaves after a step: their gaps to the
first run are what rounding alone makes of the curve, the yardstick of
phase 15's gate (chip_smoke.py::curve_gate).

The set's checksums are chip_smoke.py's `set_checksums`, the ones phase 15
checks. Not collected by pytest (its name has no test_ prefix). It
imports both packages; the port itself never imports the JAX package.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "torch_port_curve_jax.json")
RECIPE = "runs/flagship_r5_regression/args.json"
CURVE_MOLECULES = 1024
CURVE_EPOCHS = 10
BUILD = dict(seed=7, mean_atoms=13, basis="6311", gap_label=True)
INIT_SEED = 0
NOISE, NOISE_SEEDS = 1e-6, (12, 13, 14, 15)
RECORD_KEYS = ("epoch", "loss", "val_mae", "best_val_mae", "test_mae",
               "step", "bad_steps", "lr_scale", "occupancy_pairs")


def init_abs_sums(flat: dict) -> dict:
    """sum |w| of every initial parameter, by flax path."""
    return {k: float(np.abs(np.asarray(v, np.float64)).sum())
            for k, v in sorted(flat.items())}


def labels(graphs, tcfg, make_split, resolve_division, fit_linear_atomref,
           prepare_targets):
    """train.py:257-270: targets minus the atomref fit on the train split,
    standardized; returns (targets, std, atomref table, mu, sigma)."""
    targets = prepare_targets(graphs, tcfg.target)
    n = len(graphs)
    fit_idx, _, _ = make_split(n, tcfg.random_seed,
                               resolve_division(n, tcfg.division))
    pred, table = fit_linear_atomref([g.numbers for g in graphs], targets,
                                     fit_idx)
    targets = np.asarray(targets, np.float64) - pred
    mu, sigma = float(np.mean(targets)), float(np.std(targets) + 1e-12)
    targets = ((targets - mu) / sigma).astype(np.float32)
    return targets, sigma, {str(k): v for k, v in table.items()}, mu, sigma


def perturbed(flat: dict, seed: int) -> dict:
    """The weights `flat` times (1 + NOISE * z), z ~ N(0, 1) from
    np.random.default_rng(seed), leaf by leaf in sorted path order."""
    rng = np.random.default_rng(seed)
    return {k: (v * (1.0 + NOISE * rng.standard_normal(v.shape))
                ).astype(np.float32) for k, v in sorted(flat.items())}


def _nest(flat: dict) -> dict:
    tree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return {"params": tree}


def jax_curve(graphs, targets, std, flat, workdir):
    """CURVE_EPOCHS epochs of the JAX Trainer from the weights `flat`;
    its metrics.jsonl records."""
    import jax
    import jax.numpy as jnp
    from x2gnn_tpu.infer import load_run_configs
    from x2gnn_tpu.models import X2GNN
    from x2gnn_tpu.train.ema import ema_init
    from x2gnn_tpu.train.trainer import Trainer, TrainState
    mcfg, tcfg = load_run_configs(os.path.join(REPO, RECIPE))
    trainer = Trainer(X2GNN(mcfg), mcfg, tcfg, graphs, targets,
                      workdir=workdir, std=std)
    drawn = trainer.init_state()     # the flat EMA's unravel function
    params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.float32), _nest(flat))
    if (jax.tree_util.tree_structure(params)
            != jax.tree_util.tree_structure(drawn.params)):
        raise ValueError("the port's parameters do not form the JAX tree")
    # the train step donates its state: no two leaves may share a buffer
    state = TrainState(params, trainer.optimizer.init(params),
                       ema_init(params, flat=bool(tcfg.fused_update)),
                       jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    trainer.fit(epochs=CURVE_EPOCHS, state=state)
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return [{k: r.get(k) for k in RECORD_KEYS} for r in records]


def main() -> int:
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    from x2gnn_tpu.data.dataset import load_graph_cache, prepare_targets
    from x2gnn_tpu.infer import load_run_configs
    from x2gnn_tpu.data.molecule import fit_linear_atomref
    from x2gnn_tpu.train.trainer import make_split, resolve_division
    from x2gnn_tpu_torch.config import ModelConfig
    from x2gnn_tpu_torch.data.make_synthetic import build_dataset
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.utils.parity import export_params_flat
    from chip_smoke import set_checksums

    # the {model, train} json as train.py archives it (load_configs reads
    # the reference's flat config.json)
    mcfg, tcfg = load_run_configs(os.path.join(REPO, RECIPE))
    if not (tcfg.pack_mixed and tcfg.fused_update
            and tcfg.scheduler == "plateau"):
        raise ValueError(f"{RECIPE} read as {tcfg}")
    with tempfile.TemporaryDirectory() as work:
        t0 = time.time()
        path = build_dataset(CURVE_MOLECULES, "curve", chunk=CURVE_MOLECULES,
                             cache_dir=work, **BUILD)
        build_s = time.time() - t0
        graphs = load_graph_cache(path)
        targets, std, atomref, mu, sigma = labels(
            graphs, tcfg, make_split, resolve_division, fit_linear_atomref,
            prepare_targets)
        model = X2GNN(ModelConfig(attention_layout="blocked"),
                      torch.Generator().manual_seed(INIT_SEED), device="cpu")
        flat = export_params_flat(model)
        n = len(graphs)
        d0, d1 = resolve_division(n, tcfg.division)
        fixture = {
            "recipe": RECIPE, "epochs": CURVE_EPOCHS,
            "builder": {"n": CURVE_MOLECULES, **BUILD},
            "split": {"test": d0, "val": d1 - d0, "train": n - d1},
            "set": set_checksums(graphs),
            "atomref": atomref,
            "standardization": {"mu": mu, "sigma": sigma},
            "init": {"seed": INIT_SEED, "abs_sums": init_abs_sums(flat)},
            "noise": {"scale": NOISE, "seeds": list(NOISE_SEEDS)},
        }
        seconds = {"build": build_s}
        runs = {"jax": None, "perturbed": {}}
        for seed in (None,) + NOISE_SEEDS:
            t0 = time.time()
            weights = flat if seed is None else perturbed(flat, seed)
            name = "jax" if seed is None else f"jax_perturbed_{seed}"
            records = jax_curve(graphs, targets, std, weights,
                                os.path.join(work, name))
            if seed is None:
                runs["jax"] = records
            else:
                runs["perturbed"][str(seed)] = records
            seconds[name] = time.time() - t0
            print(f"{name}: {seconds[name]:.1f} s", file=sys.stderr)
        fixture.update(occupancy_pairs=runs["jax"][0]["occupancy_pairs"],
                       runs=runs, seconds=seconds, jax=jax.__version__)
    with open(FIXTURE, "w") as f:
        json.dump(fixture, f, indent=1)
        f.write("\n")
    print(FIXTURE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
