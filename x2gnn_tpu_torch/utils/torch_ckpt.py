"""The reference X2-GNN's PyTorch state-dict naming
(x2gnn_tpu/utils/torch_ckpt.py:35-166): import a zfwangDP/X2-GNN `.pth`
checkpoint into the port's X2GNN, and export the port's weights under the
reference's names.

The reference saves {"model": state_dict, "optimizer", "scheduler",
"epoch"} (trainer.py:98-105). Its module tree maps one to one onto the
flax paths that the port's parameter names stand for
(`weights._flax_path_of`): the readout MLP interleaves SiLU modules, so
torch Linear j sits at `mlp.{2j}` and the output layer at
`mlp.{2 (depth-1)}`; a Linear weight is (out, in) in the reference and in
the port (the flax kernel is its transpose); `lin_sbf` keeps the flax
(L*K, HC) layout in the port and is transposed once; the embedding table
and the RBF frequencies carry over as they are. The reference's
`rbf_trans.*` parameters are never used in its forward (xgnn.py:30-32)
and are reported as dead, not as errors.

    python -m x2gnn_tpu_torch.utils.torch_ckpt --pth ckpt/U0_ckpt.pth \\
        --config config.json --out runs/imported [--device cpu]

writes a run directory (ckpt_best.pt + args.json) that
`Predictor.from_run` and `python -m x2gnn_tpu_torch.evaluate` read.
"""

from __future__ import annotations

import argparse
import pickle
import re
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from x2gnn_tpu_torch.weights import _flax_path_of, export_flax_params

# reference parameters that the port deliberately lacks
_KNOWN_DEAD = ("rbf_trans.",)


def _ref_key(path: str) -> str:
    """A flax parameter path -> the reference state_dict key (the
    readout's output layer as `mlp.__OUT__`, resolved by `name_map`)."""
    parts = [p for p in path.split("/") if p != "Dense_0"]
    leaf = parts[-1]
    name = ".".join(parts[:-1])

    if name == "emb_block" and leaf == "embedding":
        return "emb_block.embedding.weight"
    m = re.match(r"^edgenn_(\d+)_(\d+)$", name)          # v2 per-layer MLPs
    if m:
        name = f"fin_model.edgenn.{m.group(1)}.{2 * int(m.group(2))}"
    else:
        m = re.match(r"^edgenn_(\d+)$", name)            # v1 shared MLP
        if m:
            name = f"fin_model.edgenn.{2 * int(m.group(1))}"
    name = re.sub(r"^conv_(\d+)\.", r"fin_model.convs.\1.", name)
    name = re.sub(r"^readout_(\d+)\.", r"fin_model.readouts.\1.", name)
    m = re.match(r"^(fin_model\.readouts\.\d+)\.mlp\.mlp_(\d+)$", name)
    if m:
        name = f"{m.group(1)}.mlp.{2 * int(m.group(2))}"
    m = re.match(r"^(fin_model\.readouts\.\d+)\.mlp\.mlp_out$", name)
    if m:
        name = f"{m.group(1)}.mlp.__OUT__"
    name = re.sub(r"^bf_skip_(\d+)\.", r"fin_model.bf_skip.\1.", name)
    name = re.sub(r"^af_skip_(\d+)_(\d+)\.", r"fin_model.af_skip.\1.\2.",
                  name)
    name = re.sub(r"^dense_bf_skip_(\d+)$", r"fin_model.dense_bf_skip.\1",
                  name)
    m = re.match(r"^norm_(\d+)", name)
    if m:  # the reference's LayerNorm(affine=False) has no parameters
        name = f"fin_model.norms.{m.group(1)}"

    if name == "rbf_layer" and leaf == "frequencies":
        return "rbf_layer.frequencies"
    suffix = {"kernel": "weight", "bias": "bias"}.get(leaf, leaf)
    return f"{name}.{suffix}"


def name_map(model: nn.Module, mlp_depth: int = 3) -> Dict[str, str]:
    """{port parameter name: reference state_dict key} for every
    parameter of `model`."""
    out_idx = 2 * (mlp_depth - 1)
    return {name: _ref_key(_flax_path_of(model, name)[0]).replace(
                "mlp.__OUT__", f"mlp.{out_idx}")
            for name, _ in model.named_parameters()}


def _ref_transposed(path: str, a: np.ndarray) -> bool:
    # 2-D flax kernels are the transpose of the reference's Linear
    # weights; the embedding table is not
    return path.endswith("/kernel") and a.ndim == 2


def export_torch_state_dict(model: nn.Module,
                            tensors: Optional[Dict[str, torch.Tensor]]
                            = None, mlp_depth: int = 3
                            ) -> Dict[str, np.ndarray]:
    """The model's parameters, or `tensors` ({port parameter name:
    tensor}, e.g. the EMA), as a reference-named state_dict of numpy
    arrays: the inverse of `import_torch_state_dict`."""
    mapping = name_map(model, mlp_depth)
    if tensors is None:
        tensors = dict(model.named_parameters())
    flat = export_flax_params(model, tensors)
    sd = {}
    for name in tensors:
        path = _flax_path_of(model, name)[0]
        a = flat[path]
        sd[mapping[name]] = (np.ascontiguousarray(a.T)
                             if _ref_transposed(path, a) else a)
    return sd


def import_torch_state_dict(state_dict: Dict[str, Any], model: nn.Module,
                            mlp_depth: int = 3) -> Dict[str, list]:
    """Copy a reference state_dict (the checkpoint's "model" entry; an
    AveragedModel's `module.` prefix and `n_averaged` are handled) into
    `model`'s parameters. Returns the report {"missing": port parameters
    the checkpoint lacks (left as they were), "unused": checkpoint keys
    not consumed, "dead": the reference's unused parameters}. Raises on
    a shape mismatch (a config that does not match the checkpoint)."""
    sd = {}
    for k, v in state_dict.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k == "n_averaged":
            continue
        sd[k] = v.detach().cpu().numpy() if isinstance(
            v, torch.Tensor) else np.asarray(v)

    mapping = name_map(model, mlp_depth)
    used, missing = set(), []
    with torch.no_grad():
        for name, param in model.named_parameters():
            key = mapping[name]
            if key not in sd:
                missing.append(name)
                continue
            used.add(key)
            path, transposed = _flax_path_of(model, name)
            a = sd[key]
            a = a.T if _ref_transposed(path, a) else a     # -> flax layout
            a = a.T if transposed else a                   # -> port layout
            if tuple(a.shape) != tuple(param.shape):
                raise ValueError(
                    f"shape mismatch for {name} <- {key}: checkpoint "
                    f"{a.shape}, model {tuple(param.shape)}: config "
                    "mismatch?")
            param.copy_(torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.float32)))
    leftovers = [k for k in sd if k not in used]
    dead = [k for k in leftovers
            if any(k.startswith(d) for d in _KNOWN_DEAD)]
    unused = [k for k in leftovers if k not in dead]
    return {"missing": missing, "unused": unused, "dead": dead}


def main(argv=None) -> int:
    """Import a reference `.pth` into a port run directory
    (scripts/import_torch_ckpt.py)."""
    import dataclasses
    import os

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--pth", required=True, help="reference .pth file")
    ap.add_argument("--config", default=None,
                    help="reference config.json (model hyperparameters)")
    ap.add_argument("--out", required=True, help="output run directory")
    ap.add_argument("--target", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--trust-pickle", action="store_true",
                    help="unpickle the whole file, which runs any code it "
                         "holds (default: tensors and plain containers "
                         "only)")
    args = ap.parse_args(argv)

    from x2gnn_tpu_torch.config import (
        ModelConfig, TrainConfig, dump_configs, load_configs)
    from x2gnn_tpu_torch.device import resolve_device
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.train.checkpoint import save_checkpoint
    from x2gnn_tpu_torch.train.ema import ema_init
    from x2gnn_tpu_torch.train.optim import Optimizer
    from x2gnn_tpu_torch.train.trainer import TrainState

    device = resolve_device(args.device)
    if args.config:
        mcfg, tcfg = load_configs(args.config)
    else:
        mcfg, tcfg = ModelConfig(), TrainConfig()
    # extensive vs intensive dispatch (train_ema.py:41-44)
    readout = "atomwise" if args.target in range(6, 12) else "molwise_mean"
    mcfg = dataclasses.replace(mcfg, readout=readout,
                               attention_layout="blocked")

    # only the "model" state dict is read; the optimizer and scheduler
    # state dicts beside it are plain containers of tensors and numbers
    try:
        ckpt = torch.load(args.pth, map_location="cpu",
                          weights_only=not args.trust_pickle)
    except pickle.UnpicklingError as e:
        raise SystemExit(
            f"{args.pth} holds objects other than tensors and plain "
            f"containers ({e}); pass --trust-pickle to unpickle it whole, "
            "only for a file from a trusted source") from e
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = {k: v for k, v in sd.items()
          if hasattr(v, "shape") or k == "n_averaged"}
    # the integral feature width is hard-coded in the reference
    # (Linear(338, ...) at xgnn.py:26), not in config.json: read it from
    # the checkpoint so other widths import too
    mt = sd.get("mat_trans.weight", sd.get("module.mat_trans.weight"))
    if mt is not None and mt.shape[1] != mcfg.edge_feat_dim:
        mcfg = dataclasses.replace(mcfg, edge_feat_dim=int(mt.shape[1]))

    model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)
    report = import_torch_state_dict(sd, model, mlp_depth=mcfg.mlp_depth)
    for k in ("missing", "unused", "dead"):
        if report[k]:
            print(f"{k} ({len(report[k])}): {report[k][:6]}"
                  f"{' ...' if len(report[k]) > 6 else ''}",
                  file=sys.stderr)
    if report["missing"] or report["unused"]:
        print("WARNING: imperfect mapping: check that the config matches "
              "the checkpoint", file=sys.stderr)

    # the EMA starts at the imported weights with count 1 (the reference
    # checkpoint holds the raw model: evaluating the EMA evaluates it)
    params = list(model.parameters())
    ema = ema_init(params)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    state = TrainState(params, Optimizer(tcfg).init(params),
                       ema._replace(count=ema.count + 1), zero, zero.clone())
    os.makedirs(args.out, exist_ok=True)
    dump_configs(mcfg, tcfg, os.path.join(args.out, "args.json"))
    save_checkpoint(os.path.join(args.out, "ckpt_best.pt"), state)
    print(f"imported {len(params)} tensors -> {args.out}/ckpt_best.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
