"""Model configuration (counterpart of x2gnn_tpu/config.py:18-72).

The dataclass keeps the reference's field names and defaults, so the
`model` block of a run's `args.json` loads unchanged. Training settings
wait for the training slice of the port.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (x2gnn_tpu/config.py:18-72)."""

    conv_layers: int = 4
    sbf_dim: int = 7            # number of spherical harmonics l=0..6
    rbf_dim: int = 6            # radial basis size
    in_channels: int = 128      # edge (line-graph node) feature width
    embedding_size: int = 128   # atom embedding width
    heads: int = 16
    cutoff: float = 5.0         # Angstrom radius-graph cutoff
    envelope_exponent: int = 5
    edge_feat_dim: int = 338    # symmetrized one-electron-integral features
    readout: str = "atomwise"
    mlp_depth: int = 3
    dropout: float = 0.0
    beta: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    attention_layout: str = "segment"
    # read for compatibility with the reference's args.json: the port
    # always runs the fused-kernel formulation of the blocked layout
    use_pallas: Optional[bool] = None
    variant: str = "v1"
    remat: bool = False

    @property
    def head_dim(self) -> int:
        assert self.in_channels % self.heads == 0
        return self.in_channels // self.heads


# reference config.json keys that configure the model
# (x2gnn_tpu/config.py:156-180, model entries only)
_REFERENCE_MODEL_KEYS = ("conv_layers", "sbf_dim", "rbf_dim", "in_channels",
                         "embedding_size", "heads", "cutoff")


def load_run_configs(path: str) -> ModelConfig:
    """ModelConfig of a run: the {model: ..., train: ...} json archived by
    the reference's train.py, or the reference's flat config.json
    (x2gnn_tpu/infer.py:52-60). Unknown keys of a flat file are ignored."""
    with open(path) as f:
        raw = json.load(f)
    if "model" in raw and "train" in raw:
        return ModelConfig(**raw["model"])
    return ModelConfig(**{k: raw[k] for k in _REFERENCE_MODEL_KEYS
                          if k in raw})
