"""PyTorch/CUDA port of x2gnn_tpu for NVIDIA Hopper (H100).

The JAX package `x2gnn_tpu` is the reference; this package mirrors its
module names so each counterpart is easy to find. It imports torch, numpy
and scipy only, never jax, flax or anything of `x2gnn_tpu`.

Ported so far, for the flagship configuration (`models.X2GNN` in the
atom-blocked layout): serving (`infer.Predictor`) and single-device
training on fixed budgets (`train.trainer.Trainer`, the CLI `python -m
x2gnn_tpu_torch.train`). The fused attention runs through hand-written
CUDA kernels: `ops/csrc/blocked_attn_fwd.cu` forward,
`ops/csrc/blocked_attn_bwd.cu` backward.
"""
