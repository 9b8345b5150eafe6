"""PyTorch/CUDA port of x2gnn_tpu for NVIDIA Hopper (H100).

The JAX package `x2gnn_tpu` is the reference; this package mirrors its
module names so each counterpart is easy to find. It imports torch, numpy
and scipy only, never jax, flax or anything of `x2gnn_tpu`.

It covers what the reference does: every `ModelConfig` (`models.X2GNN`
in the blocked, segment and padded attention layouts, variants v1 and
v2, the beta gate, atom- and molecule-wise readouts, bf16 compute),
serving (`infer.Predictor`, `Predictor.from_run`, `predict_xyz`),
training (`train.trainer.Trainer`, the CLI `python -m
x2gnn_tpu_torch.train`: packing and degree tiers, dropout, resume,
float16/int8 features, remat, gradient accumulation), evaluation
(`python -m x2gnn_tpu_torch.evaluate`), the host data pipeline (xyz
files, the integral engine, graph caches), the reference's `.pth`
naming (`utils.torch_ckpt`), determinism checks and the parallel paths
on `torch.distributed` (`parallel`: data parallelism, edge partitioning
and the two composed). The fused attention runs through hand-written
CUDA kernels: `ops/csrc/blocked_attn_fwd.cu` forward,
`ops/csrc/blocked_attn_bwd.cu` backward.

`ModelConfig` and `TrainConfig` are imported with the package; `X2GNN`,
`Predictor` and `Trainer` on first use, as the reference gives them
(x2gnn_tpu/__init__.py:20-37).
"""

__version__ = "0.1.0"

from x2gnn_tpu_torch.config import ModelConfig, TrainConfig  # noqa: F401


def __getattr__(name):
    if name == "X2GNN":
        from x2gnn_tpu_torch.models.x2gnn import X2GNN
        return X2GNN
    if name == "Predictor":
        from x2gnn_tpu_torch.infer import Predictor
        return Predictor
    if name == "Trainer":
        from x2gnn_tpu_torch.train.trainer import Trainer
        return Trainer
    raise AttributeError(
        f"module 'x2gnn_tpu_torch' has no attribute {name!r}")
