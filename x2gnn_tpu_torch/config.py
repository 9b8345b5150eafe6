"""Model and training configuration (counterpart of
x2gnn_tpu/config.py:18-220).

The dataclasses keep the reference's field names and defaults, so a run's
`args.json` ({"model": ..., "train": ...}) and the reference's flat
`config.json` load unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


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


@dataclass(frozen=True)
class TrainConfig:
    """Optimization hyperparameters (x2gnn_tpu/config.py:76-153; the
    reference's config.json:11-30, train_ema.py:40-53, trainer.py:22-48).
    The port raises NotImplementedError on accum_steps > 1, which it does
    not run yet."""

    target: int = 7                       # QM9 property index (7 = U0)
    batch_size: int = 32
    random_seed: int = 41
    division: Tuple[int, int] = (10000, 20000)  # test / val split boundaries
    max_epoch: int = 800
    max_lr: float = 1e-3
    # 'warmup_exp' = LinearWarmupExponentialDecay; 'plateau' = epoch-level
    # val-MAE-driven reduction by reduce_factor, floored at decay_rate
    scheduler: str = "warmup_exp"
    warmup_steps: int = 3000
    decay_steps: int = 3_000_000
    decay_rate: float = 0.01
    reduce_factor: float = 0.7
    patience: int = 3
    grad_clip: bool = True
    max_grad: float = 100.0
    ema_decay: float = 0.95
    accum_steps: int = 1
    loss: str = "smooth_l1"
    eval_on_ema: bool = True
    ckpt_after_epoch: int = 100
    ckpt_every: int = 0                   # ckpt_last every N epochs; 0 off
    bucket_shapes: int = 0
    pack_budget: bool = False
    pack_mixed: bool = False
    # clip, Adam and EMA on one flat parameter vector
    fused_update: bool = False
    # read for compatibility with the reference's args.json; the port's
    # budgets come from pad_budget_for
    pad_nodes: int = 0
    pad_edges: int = 0
    pad_triplets: int = 0


# reference config.json key -> (dataclass, field) (x2gnn_tpu/config.py:156)
_REFERENCE_KEY_MAP = {
    **{k: ("model", k) for k in ("conv_layers", "sbf_dim", "rbf_dim",
                                 "in_channels", "embedding_size", "heads",
                                 "cutoff")},
    **{k: ("train", k) for k in ("target", "batch_size", "random_seed",
                                 "division", "scheduler", "warmup_steps",
                                 "decay_steps", "reduce_factor", "patience",
                                 "max_epoch", "grad_clip", "max_grad",
                                 "max_lr", "decay_rate", "ema_decay")},
}
_SCHEDULERS = {"LinearWarmupExponentialDecay": "warmup_exp",
               "ReduceLROnPlateau": "plateau",
               "warmup_exp": "warmup_exp", "plateau": "plateau"}


def load_configs(path_or_dict) -> Tuple[ModelConfig, TrainConfig]:
    """(ModelConfig, TrainConfig) from a run's {"model", "train"} json (as
    `dump_configs` writes it) or from the reference's flat config.json,
    whose unknown keys are ignored (x2gnn_tpu/config.py:182-209)."""
    if isinstance(path_or_dict, dict):
        raw = dict(path_or_dict)
    else:
        with open(path_or_dict) as f:
            raw = json.load(f)
    if "model" in raw and "train" in raw:
        train = dict(raw["train"])
        train["division"] = tuple(train.get("division",
                                            TrainConfig.division))
        return ModelConfig(**raw["model"]), TrainConfig(**train)
    kw: Dict[str, Dict[str, Any]] = {"model": {}, "train": {}}
    for key, value in raw.items():
        if key not in _REFERENCE_KEY_MAP:
            continue
        which, name = _REFERENCE_KEY_MAP[key]
        if name == "division":
            value = tuple(value)
        elif name == "scheduler":
            value = _SCHEDULERS[value]
        kw[which][name] = value
    return ModelConfig(**kw["model"]), TrainConfig(**kw["train"])


def dump_configs(model: ModelConfig, train: TrainConfig, path: str) -> None:
    """Archive the resolved configs as {"model": ..., "train": ...}
    (x2gnn_tpu/config.py:212-220)."""
    payload = {"model": dataclasses.asdict(model),
               "train": dataclasses.asdict(train)}
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)

