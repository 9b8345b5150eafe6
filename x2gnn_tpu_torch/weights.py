"""Load parameters from a flat flax parameter dict.

The dict is `{flax/path: np.ndarray}` as the reference's
`x2gnn_tpu.utils.parity.export_params_flat` writes it. The port's module
and parameter names follow the flax tree, so the mapping is mechanical:
  * the nested `Dense_0` of the reference's Dense/TorchDense wrappers
    drops out (`a/b/Dense_0/kernel` -> `a.b.weight`);
  * a flax `kernel` (in, out) becomes a torch `weight` (out, in),
    transposed, except for `LinearParams` (lin_sbf), whose `kernel` keeps
    the flax layout because the fused kernel contracts it as (L*K, HC);
  * every other leaf keeps its name (embedding, frequencies, bias).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def load_flax_params(model: nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Copy every flax leaf into `model`; raise on a leaf that maps to no
    parameter, a shape mismatch, or a parameter left unfilled."""
    params = dict(model.named_parameters())
    filled = set()
    for path, value in flat.items():
        parts = [p for p in path.split("/") if p != "Dense_0"]
        prefix, leaf = ".".join(parts[:-1]), parts[-1]
        value = np.array(value, dtype=np.float32)   # a writable copy
        if leaf == "kernel" and f"{prefix}.weight" in params:
            name, value = f"{prefix}.weight", value.T
        else:
            name = f"{prefix}.{leaf}" if prefix else leaf
        if name not in params:
            raise KeyError(f"flax leaf {path!r} maps to no port parameter "
                           f"({name!r})")
        param = params[name]
        if tuple(param.shape) != value.shape:
            raise ValueError(f"{path!r} has shape {value.shape}, port "
                             f"parameter {name!r} {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.ascontiguousarray(value)))
        filled.add(name)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"port parameters left unfilled: {missing}")
