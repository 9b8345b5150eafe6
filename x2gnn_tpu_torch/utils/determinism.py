"""Run-to-run determinism checks (x2gnn_tpu/utils/determinism.py).

Re-run a function on identical inputs and compare every output tensor
bitwise, naming the tensor that differs. On the card a scatter-add with
float atomics, an unseeded random draw or a buffer that aliases another
makes two runs differ; the port's kernels and segment sums sum in a fixed
order, so a training step is expected to repeat bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch


def copy_tree(tree: Any) -> Any:
    """Deep copy of the tensors and arrays of a nest of lists, tuples,
    NamedTuples (TrainState, AdamState, EmaState), dicts and dataclasses
    (GraphBatch); other leaves are shared."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, np.ndarray):
        return np.array(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(copy_tree(x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(copy_tree(x) for x in tree)
    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: copy_tree(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _leaves(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in order, named as jax.tree_util.keystr names a
    path: ".field" for a NamedTuple or dataclass field, "['key']" for a
    dict key, "[i]" for a list or tuple index."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name, x in zip(tree._fields, tree)
                for kv in _leaves(x, f"{path}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _leaves(x, f"{path}[{i}]")]
    if isinstance(tree, dict):
        return [kv for k, x in tree.items()
                for kv in _leaves(x, f"{path}[{k!r}]")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in dataclasses.fields(tree)
                for kv in _leaves(getattr(tree, f.name),
                                  f"{path}.{f.name}")]
    return [(path, tree)]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tree_bitwise_diff(a: Any, b: Any) -> List[str]:
    """Compare two nests leaf by leaf, bitwise. Returns one description
    per mismatch (empty == identical)."""
    la, lb = _leaves(a), _leaves(b)
    ta, tb = [n for n, _ in la], [n for n, _ in lb]
    if ta != tb:
        return [f"tree structure differs: {ta} vs {tb}"]
    diffs = []
    for (name, xa), (_, xb) in zip(la, lb):
        na, nb = _numpy(xa), _numpy(xb)
        if na.shape != nb.shape or na.dtype != nb.dtype:
            diffs.append(f"{name}: shape/dtype {na.shape}/{na.dtype} vs "
                         f"{nb.shape}/{nb.dtype}")
            continue
        ba, bb = na.tobytes(), nb.tobytes()
        if ba != bb:
            itemsize = max(na.dtype.itemsize, 1)
            bad = (np.frombuffer(ba, np.uint8) != np.frombuffer(bb, np.uint8))
            n_bad = int(bad.reshape(-1, itemsize).any(axis=1).sum())
            detail = ""
            if np.issubdtype(na.dtype, np.number):
                delta = np.abs(na.astype(np.float64)
                               - nb.astype(np.float64))
                finite = delta[np.isfinite(delta)]
                if finite.size:
                    detail = f", max |delta| = {float(finite.max()):.3e}"
                else:
                    # differing NaN/inf payloads: no finite delta exists
                    detail = ", non-finite-only mismatch (NaN/inf bits)"
            diffs.append(f"{name}: {n_bad} element(s) differ{detail}")
    return diffs


def check_determinism(fn: Callable, *args, repeats: int = 2,
                      **kwargs) -> Dict[str, Any]:
    """Run `fn(*args, **kwargs)` `repeats` times on deep-copied inputs and
    compare the outputs bitwise with the first run's.

    Returns {"deterministic": bool, "repeats": int, "mismatches": [...]}.
    The inputs are copied before every call, so a function that writes
    into its arguments is safe to check; its outputs must not alias state
    that the next call changes."""
    ref = fn(*copy_tree(args), **copy_tree(kwargs))
    mismatches: List[str] = []
    for r in range(1, repeats):
        out = fn(*copy_tree(args), **copy_tree(kwargs))
        for d in tree_bitwise_diff(ref, out):
            mismatches.append(f"run {r}: {d}")
    return {"deterministic": not mismatches, "repeats": repeats,
            "mismatches": mismatches}


def check_train_step_determinism(trainer, state=None,
                                 repeats: int = 2) -> Dict[str, Any]:
    """Re-run the trainer's training step on its first training batch (in
    plan order) and compare the resulting TrainState and loss bitwise.

    `train_step` updates the model's parameters in place, so each repeat
    first writes the parameters, the optimizer state and the EMA back from
    a copy of `state` (default `trainer.init_state()`), and the trainer's
    parameters hold `state`'s values again when the check returns."""
    state = state if state is not None else trainer.init_state()
    saved = copy_tree(state)
    batch = trainer.batches(trainer.train_idx)[0]

    def step(start):
        new, loss = trainer.train_step(trainer.use_state(start), batch)
        return {"state": copy_tree(new), "loss": loss.detach().clone()}

    try:
        return check_determinism(step, saved, repeats=repeats)
    finally:
        trainer.use_state(saved)
