"""Serving API: batched predictions for featurized molecules
(x2gnn_tpu/infer.py).

Molecules are padded to a small geometric grid of static budgets
(`quantize_budgets`), run through X2GNN batch by batch on the model's
device, and returned de-standardized in input order. Restoring a trained
run from a checkpoint comes with a later slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from x2gnn_tpu_torch.config import ModelConfig
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
                 device="cuda"):
        self.mcfg = model_cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.stats = stats              # {"mu": ..., "sigma": ...} or None
        self.batch_size = batch_size

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
