"""PyTorch/CUDA port of x2gnn_tpu for NVIDIA Hopper (H100).

The JAX package `x2gnn_tpu` is the reference; this package mirrors its
module names so each counterpart is easy to find. It imports torch, numpy
and scipy only, never jax, flax or anything of `x2gnn_tpu`.

Ported so far, for the flagship configuration (`models.X2GNN` in the
atom-blocked layout): serving (`infer.Predictor`, restored from a run by
`Predictor.from_run`), single-device training with the flagship's
packing and degree tiers (`train.trainer.Trainer`, the CLI `python -m
x2gnn_tpu_torch.train`, resumable), graph caches (`data.dataset`),
evaluation (`python -m x2gnn_tpu_torch.evaluate`), the reference's
`.pth` naming (`utils.torch_ckpt`) and run-to-run determinism checks
(`utils.determinism`). The fused attention runs through hand-written
CUDA kernels: `ops/csrc/blocked_attn_fwd.cu` forward,
`ops/csrc/blocked_attn_bwd.cu` backward.
"""
