"""PyTorch/CUDA port of x2gnn_tpu for NVIDIA Hopper (H100).

The JAX package `x2gnn_tpu` is the reference; this package mirrors its
module names so each counterpart is easy to find. It imports torch, numpy
and scipy only, never jax, flax or anything of `x2gnn_tpu`.

Ported so far: the serving path of the flagship configuration
(`infer.Predictor` over `models.X2GNN` in the atom-blocked layout), whose
fused attention runs through the hand-written CUDA kernel in
`ops/csrc/blocked_attn_fwd.cu`.
"""
