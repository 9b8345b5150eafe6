"""Per-layer parity harness (x2gnn_tpu/utils/parity.py).

`dump_activations` runs one forward of the port's X2GNN with a forward
hook on every named submodule and returns {key: float32 ndarray}, keyed
as the JAX package's dump keys flax's `capture_intermediates`: the module
path with "/" for "." and "/__call__" appended (`conv_0/lin_query/
__call__`), ".0", ".1" for the members of a tuple output and for the
calls of a module called more than once, "__call__" for the model itself
and "__output__" for its output. The reference's Dense wrappers nest a
`Dense_0` whose output is the wrapper's own; the port has no such level
(weights.py) and writes no `.../Dense_0/__call__` twin.

`compare_dumps` compares two dumps entry by entry and names the keys that
only one of them has; `BY_DESIGN` lists, with its reason, every key in
which a port dump and a JAX dump of the same batch and weights differ by
construction, and `by_design(config)` expands it for one configuration.
`export_params_flat` is `weights.export_flax_params`: the port's
parameters under their flax paths.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch
from torch import nn

from x2gnn_tpu_torch.weights import export_flax_params

Dump = Dict[str, np.ndarray]


def _host(x):
    """A module output as host arrays: float tensors as float32 (bf16 is
    upcast: numpy has none), tuples and lists member by member."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    if isinstance(x, (tuple, list)):
        return tuple(_host(v) for v in x)
    return np.asarray(x)


def _flatten(x, key: str, out: Dump) -> None:
    # a 1-tuple adds no suffix, as the reference's walk
    if isinstance(x, tuple):
        for i, v in enumerate(x):
            _flatten(v, f"{key}.{i}" if len(x) > 1 else key, out)
    else:
        out[key] = x


def dump_activations(model: nn.Module, batch, path: str = None,
                     **forward_kwargs) -> Dump:
    """Every submodule's output of one `model(batch, **forward_kwargs)`
    under no_grad, in eval mode, as {key: ndarray} (see the module's
    docstring); also saved to the npz `path` when given. A module called
    more than once gets one entry per call, in call order."""
    calls: Dict[str, list] = {}
    handles = []
    for name, module in model.named_modules():
        key = f"{name.replace('.', '/')}/__call__" if name else "__call__"

        def hook(_module, _inputs, output, key=key):
            calls.setdefault(key, []).append(_host(output))
        handles.append(module.register_forward_hook(hook))
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            out = model(batch, **forward_kwargs)
    finally:
        for h in handles:
            h.remove()
        model.train(training)
    flat: Dump = {}
    for key, outputs in calls.items():
        _flatten(tuple(outputs), key, flat)
    _flatten(_host(out), "__output__", flat)
    if path is not None:
        np.savez(path, **flat)
    return flat


class Comparison(NamedTuple):
    """`entries`: (key, max_abs_err, ok) for every key both dumps have, in
    sorted order (a shape mismatch is (key, inf, False)); `only_a`,
    `only_b`: the keys that only one dump has."""

    entries: List[Tuple[str, float, bool]]
    only_a: List[str]
    only_b: List[str]

    @property
    def ok(self) -> bool:
        return all(ok for _, _, ok in self.entries)

    def failed(self) -> List[Tuple[str, float, bool]]:
        return [e for e in self.entries if not e[2]]


def _load(dump: Union[str, Dump]) -> Dump:
    if isinstance(dump, dict):
        return dump
    with np.load(dump) as f:
        return {k: f[k] for k in f.files}


def compare_dumps(a: Union[str, Dump], b: Union[str, Dump], rtol=1e-4,
                  atol=1e-5, max_scale=0.0) -> Comparison:
    """Entry by entry, `a` against the reference `b` (npz paths or dumps):
    ok where every element has |a - b| <= atol + rtol * |b| + max_scale *
    max|b| (the last term: a tolerance relative to the entry's largest
    magnitude, 0 by default as in the reference)."""
    a, b = _load(a), _load(b)
    entries = []
    for key in sorted(set(a) & set(b)):
        x = np.asarray(a[key], np.float64)
        y = np.asarray(b[key], np.float64)
        if x.shape != y.shape:
            entries.append((key, float("inf"), False))
            continue
        if not x.size:
            entries.append((key, 0.0, True))
            continue
        diff = np.abs(x - y)
        tol = atol + rtol * np.abs(y) + max_scale * np.abs(y).max()
        entries.append((key, float(diff.max()), bool(np.all(diff <= tol))))
    return Comparison(entries, sorted(set(a) - set(b)),
                      sorted(set(b) - set(a)))


def export_params_flat(model: nn.Module) -> Dict[str, np.ndarray]:
    """{flax path: float32 ndarray} of the port model's parameters, the
    reference's `export_params_flat` contract (x2gnn_tpu/utils/parity.py:
    62): what `weights.load_flax_params` and the JAX package read."""
    return export_flax_params(model)


def is_dense_twin(key: str) -> bool:
    """A reference key of the nested `Dense_0` of a Dense wrapper, whose
    output is the wrapper's own entry: the port has no such level."""
    return "/Dense_0/" in key


# Keys in which a port dump and a JAX dump of one batch and one set of
# weights differ by construction: (key, with {i} for each conv index; the
# configurations it applies to; why). Each is missing from the port's dump,
# has another shape there, or differs at padded rows only; every other key
# of either dump is in both, with the same shape, and compares.
def _blocked(cfg):
    return cfg.attention_layout == "blocked"


def _flat(cfg):
    return cfg.attention_layout != "blocked"


BY_DESIGN = (
    ("conv_{i}/lin_sbf/__call__.0", _blocked,
     "the blocked conv hands lin_sbf's kernel and bias to the fused "
     "kernel as parameters (nn/conv.py), so the module is never called; "
     "the reference calls its _LinearParams, which returns them"),
    ("conv_{i}/lin_sbf/__call__.1", _blocked,
     "the bias of the same (kernel, bias) pair"),
    ("conv_{i}/lin_sbf/__call__", _flat,
     "the flat conv computes sbf @ kernel + bias from lin_sbf's parameters "
     "without calling the module; the reference's returns that (T, C) "
     "product"),
    ("conv_{i}/lin_edge/__call__", _flat,
     "at padded triplet rows the reference projects atom 0's attributes "
     "(trip_j = 0) and the port's fixed-order gather another row; equal "
     "on real triplets"),
    ("edgenn_0/__call__", lambda cfg: _flat(cfg) and cfg.variant == "v1",
     "the port runs the v1 edge MLP once per atom, (N, emb), and gathers "
     "it per triplet; the reference runs it on atom_emb[trip_j], (T, emb) "
     "(x2gnn_tpu/models/x2gnn.py:189)"),
    ("edgenn_1/__call__", lambda cfg: _flat(cfg) and cfg.variant == "v1",
     "the second layer of the same MLP"),
    ("emb_block/__call__", lambda cfg: cfg.variant == "v2",
     "v2 never reads the atom embedding: the reference builds it and the "
     "port skips it"),
    ("emb_block/lin/__call__", lambda cfg: cfg.variant == "v2",
     "the embedding's dense layer, skipped with it"),
)


def by_design(config) -> Dict[str, str]:
    """{key: reason} of `BY_DESIGN` for one ModelConfig."""
    out = {}
    for key, applies, reason in BY_DESIGN:
        if applies(config):
            keys = ([key.format(i=i) for i in range(config.conv_layers)]
                    if "{i}" in key else [key])
            out.update(dict.fromkeys(keys, reason))
    return out
