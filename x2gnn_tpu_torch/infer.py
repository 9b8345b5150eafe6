"""Serving API: batched predictions for featurized molecules
(x2gnn_tpu/infer.py).

Molecules are padded to a small geometric grid of static budgets
(`quantize_budgets`), run through X2GNN batch by batch on the model's
device, and returned de-standardized in input order. A trained run is
restored from its workdir (`Predictor.from_run`: ckpt_best.pt or
ckpt_last.pt, args.json and standardization.json) or from one checkpoint
(`from_checkpoint`), on the EMA weights by default:

    pred = Predictor.from_run("runs/u0")         # on the card
    energies = pred.predict(graphs)              # featurized MolGraphs
    energies = pred.predict_xyz("mols.xyz", backend="native6311")

`predict_xyz` and `predict_molecules` featurize molecules as training
does (`data/dataset.py`) and refuse a featurization basis other than
the run's provenance.json (x2gnn_tpu/infer.py:209-256).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from x2gnn_tpu_torch.config import ModelConfig
from x2gnn_tpu_torch.config import load_configs as load_run_configs
from x2gnn_tpu_torch.data.batching import (
    Budgets, batch_iterator, pad_budget_for)
from x2gnn_tpu_torch.data.graphs import MolGraph
from x2gnn_tpu_torch.device import resolve_device


def _round_up_pow2(v: int, floor: int = 8) -> int:
    v = max(int(v), floor)
    return 1 << (v - 1).bit_length()


def quantize_budgets(b: Budgets) -> Budgets:
    """Round budgets up to a geometric grid (powers of two; degree to a
    multiple of 8) so request compositions map to a small, closed set of
    shapes (x2gnn_tpu/infer.py:42-49). The degree split and the tiers are
    dropped: serving runs one attention window per layer."""
    return Budgets(_round_up_pow2(b.n_node), _round_up_pow2(b.n_edge),
                   _round_up_pow2(b.n_trip), -(-b.n_deg // 8) * 8, 0, 0)


class Predictor:
    """Batched inference with an X2GNN on `device`."""

    def __init__(self, model_cfg: ModelConfig, model: torch.nn.Module,
                 stats: Optional[dict] = None, batch_size: int = 32,
                 device="cuda", basis: Optional[str] = None,
                 allow_basis_mismatch: bool = False):
        """`basis`: the featurization basis of the training run (its
        provenance.json); `predict_xyz` and `predict_molecules` refuse
        another unless `allow_basis_mismatch`."""
        self.mcfg = model_cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.stats = stats              # {"mu": ..., "sigma": ...} or None
        self.batch_size = batch_size
        self.basis = basis
        self.allow_basis_mismatch = allow_basis_mismatch

    @classmethod
    def from_checkpoint(cls, ckpt_path: str,
                        model_cfg: Optional[ModelConfig] = None,
                        use_ema: bool = True, device="cuda",
                        **kw) -> "Predictor":
        """A Predictor on the EMA (or, use_ema=False, the live) weights of
        the checkpoint `ckpt_path`; `model_cfg` defaults to the args.json
        beside it. A flat EMA (fused_update runs) is cut back into the
        parameters (x2gnn_tpu/infer.py:157-177)."""
        from x2gnn_tpu_torch.models.x2gnn import X2GNN
        from x2gnn_tpu_torch.train.checkpoint import restore_checkpoint
        from x2gnn_tpu_torch.weights import load_parameter_list

        device = resolve_device(device)
        if model_cfg is None:
            model_cfg, _ = load_run_configs(os.path.join(
                os.path.dirname(os.path.abspath(ckpt_path)), "args.json"))
        raw = restore_checkpoint(ckpt_path)
        model = X2GNN(model_cfg, torch.Generator().manual_seed(0),
                      device=device)
        load_parameter_list(model, raw["ema"]["params"] if use_ema
                            else raw["params"])
        return cls(model_cfg, model, device=device, **kw)

    @classmethod
    def from_run(cls, workdir: str, use_ema: bool = True,
                 **kw) -> "Predictor":
        """Restore a training workdir: args.json, standardization.json
        and provenance.json (if any), and ckpt_best.pt, else
        ckpt_last.pt (ckpt_best exists only from ckpt_after_epoch on)
        (x2gnn_tpu/infer.py:179-206)."""
        mcfg, _ = load_run_configs(os.path.join(workdir, "args.json"))
        stats = None
        stats_path = os.path.join(workdir, "standardization.json")
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                stats = json.load(f)
        prov_path = os.path.join(workdir, "provenance.json")
        if "basis" not in kw and os.path.exists(prov_path):
            with open(prov_path) as f:
                kw["basis"] = json.load(f).get("basis")
        ckpt = os.path.join(workdir, "ckpt_best.pt")
        if not os.path.isfile(ckpt):
            ckpt = os.path.join(workdir, "ckpt_last.pt")
            if not os.path.isfile(ckpt):
                raise FileNotFoundError(
                    f"no checkpoint in {workdir}: neither ckpt_best.pt "
                    "(written from ckpt_after_epoch on, when val improves) "
                    "nor ckpt_last.pt (TrainConfig.ckpt_every) exists")
        return cls.from_checkpoint(ckpt, model_cfg=mcfg, use_ema=use_ema,
                                   stats=stats, **kw)

    def predict(self, graphs: Sequence[MolGraph],
                batch_size: Optional[int] = None) -> np.ndarray:
        """Per-molecule predictions (physical units), in input order."""
        bs = batch_size or self.batch_size
        budgets = quantize_budgets(pad_budget_for(graphs, bs))
        out = []
        with torch.inference_mode():
            for batch in batch_iterator(graphs, bs, budgets=budgets):
                pred = self.model(batch.to(self.device)).cpu().numpy()
                out.append(pred[batch.graph_mask])
        pred = np.concatenate(out) if out else np.zeros(0, np.float32)
        if self.stats is not None:
            pred = pred * self.stats["sigma"] + self.stats["mu"]
        return pred

    def _check_basis(self, backend: str) -> None:
        from x2gnn_tpu_torch.data.featurize import (
            basis_provenance, check_basis_compatible)
        check_basis_compatible(self.basis, basis_provenance(backend),
                               allow=self.allow_basis_mismatch)

    def predict_xyz(self, xyz_path: str, backend: str = "auto",
                    cache_dir: Optional[str] = "./processed",
                    limit: Optional[int] = None,
                    batch_size: Optional[int] = None) -> np.ndarray:
        """Featurize a concatenated-xyz file as training does (a cache
        under `cache_dir`, `load_dataset`) and predict."""
        self._check_basis(backend)
        from x2gnn_tpu_torch.data.dataset import load_dataset
        graphs = load_dataset(xyz_path, cache_dir=cache_dir,
                              cutoff=self.mcfg.cutoff, backend=backend,
                              limit=limit)
        return self.predict(graphs, batch_size=batch_size)

    def predict_molecules(self, molecules: Sequence,
                          backend: str = "auto",
                          batch_size: Optional[int] = None) -> np.ndarray:
        """Featurize in-memory `Molecule`s and predict."""
        self._check_basis(backend)
        from x2gnn_tpu_torch.data.dataset import featurize_molecules
        graphs = featurize_molecules(molecules, cutoff=self.mcfg.cutoff,
                                     backend=backend)
        return self.predict(graphs, batch_size=batch_size)
