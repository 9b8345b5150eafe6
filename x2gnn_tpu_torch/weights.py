"""Carry parameters between a flat flax parameter dict and the port.

The dict is `{flax/path: np.ndarray}` as the reference's
`x2gnn_tpu.utils.parity.export_params_flat` writes it. The port's module
and parameter names follow the flax tree, so the mapping is mechanical:
  * the nested `Dense_0` of the reference's Dense/TorchDense wrappers
    drops out (`a/b/Dense_0/kernel` -> `a.b.weight`);
  * a flax `kernel` (in, out) becomes a torch `weight` (out, in),
    transposed, except for `LinearParams` (lin_sbf), whose `kernel` keeps
    the flax layout because the fused kernel contracts it as (L*K, HC);
  * every other leaf keeps its name (embedding, frequencies, bias).
`export_flax_params` is the inverse: it gives back the flax path of every
port parameter, re-inserting `Dense_0` where the reference nests it
(every Dense/TorchDense but a conv's plain `lin_rbf`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from x2gnn_tpu_torch.train.ema import unflatten


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


def parameter_list(model: nn.Module,
                   tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """A checkpoint's parameter list as one tensor per parameter of
    `model`, in `model.parameters()` order: the list itself, or views of
    its one flat vector of them all (a `fused_update` run's state). Raises
    on a count or shape mismatch."""
    params = list(model.parameters())
    if len(tensors) == 1 and len(params) > 1:
        flat = tensors[0].reshape(-1)
        total = sum(p.numel() for p in params)
        if flat.numel() != total:
            raise ValueError(f"a flat vector of {flat.numel()} values for "
                             f"{total} parameter values")
        tensors = unflatten(flat, params)
    if len(tensors) != len(params):
        raise ValueError(f"{len(tensors)} tensors for {len(params)} "
                         "parameters")
    for (name, p), t in zip(model.named_parameters(), tensors):
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)}, "
                             f"model {tuple(p.shape)}")
    return list(tensors)


def load_parameter_list(model: nn.Module,
                        tensors: Sequence[torch.Tensor]) -> None:
    """Copy a checkpoint's parameter list (`parameter_list`) into
    `model`."""
    with torch.no_grad():
        for p, t in zip(model.parameters(), parameter_list(model, tensors)):
            p.copy_(t)


def _flax_path_of(model: nn.Module, name: str) -> Tuple[str, bool]:
    """(flax path, transposed) of the port parameter `name`: transposed
    is True where the flax kernel is the transpose of the torch weight."""
    from x2gnn_tpu_torch.nn.layers import _Linear
    prefix, _, leaf = name.rpartition(".")
    parts = prefix.split(".") if prefix else []
    module = model.get_submodule(prefix) if prefix else model
    transposed = False
    if isinstance(module, _Linear):
        parts += ["Dense_0"] if module.flax_nested else []
        if leaf == "weight":
            leaf, transposed = "kernel", True
    return "/".join(parts + [leaf]), transposed


def export_flax_params(model: nn.Module,
                       tensors: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, np.ndarray]:
    """{flax path: float32 ndarray} of the model's parameters, or of
    `tensors` ({port parameter name: tensor}, e.g. gradients), in the
    layout `load_flax_params` reads."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    out = {}
    for name, t in tensors.items():
        path, transposed = _flax_path_of(model, name)
        value = t.detach().cpu().numpy()
        out[path] = np.ascontiguousarray(value.T if transposed else value)
    return out
