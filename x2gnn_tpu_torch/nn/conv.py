"""Atom-blocked line-graph attention convolution
(x2gnn_tpu/nn/conv.py:187-408), fused-kernel path.

Every per-edge activation lives in the in-table blocked layout (N, D, C):
row j holds atom j's incoming edges. The gated source features are
re-indexed into the out-table once, the key and value projections run in
the out layout (:257-271), and the fused attention runs as one call of
`ops.blocked_attn.blocked_attention` per attention window of the batch
(:293-371: one per degree tier, the two-tier split's two, or one), each
output padded back to D query slots and the rows concatenated; then the
skip projection is added (:397-402).

Attention dropout (:224-229, :285-292): with `dropout` > 0 and
`deterministic=False`, one canonical pair-space keep mask (N, D, D, H) is
drawn per call (`ops.attention.pair_dropout_mask`, looked up through its
module so that a test can replace it) and every window takes its cut of
it, so the tiered and the one-window conv drop the same weights. An
explicit `dropout_mask` replaces the draw (the tests and the card-vs-CPU
check hand both sides the same one). `return_attention_weights` also
returns the pre-dropout weights (N, D, D, H), each window's padded to D x D
and the rows concatenated (:321-334).

`dtype` (torch.bfloat16 for ModelConfig.compute_dtype "bfloat16"; None is
float32) is the computation dtype of the layers the reference gives it:
lin_rbf, lin_query, lin_edge, lin_key and lin_value (:232-270); lin_skip
and lin_sbf stay float32. `x_blk * lin_rbf(...)` promotes to float32, so
the injective gather runs in float32 and lin_key/lin_value cast again; q,
k, v and e reach the kernels in bf16 storage (their per-window cuts too)
and the attention output is float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from x2gnn_tpu_torch.nn.init import glorot_orthogonal_
from x2gnn_tpu_torch.nn.layers import Dense, TorchDense
from x2gnn_tpu_torch.ops import attention as attention_ops
from x2gnn_tpu_torch.ops.attention import injective_gather
from x2gnn_tpu_torch.ops.blocked_attn import blocked_attention


class LinearParams(nn.Module):
    """A (kernel, bias) pair in the flax layout (in, out): the fused kernel
    contracts the weight itself (the reference's `_LinearParams`)."""

    def __init__(self, features_in: int, features_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # glorot-orthogonal statistics are symmetric in (in, out)
        self.kernel = nn.Parameter(torch.empty(features_in, features_out))
        glorot_orthogonal_(self.kernel, generator=generator)
        self.bias = nn.Parameter(torch.zeros(features_out))


class BlockedEdgeAttentionConv(nn.Module):
    def __init__(self, channels: int, heads: int = 16, sbf_l: int = 7,
                 sbf_k: int = 6, rbf_dim: int = 6, emb_dim: int = 128,
                 dropout: float = 0.0, use_beta: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if use_beta:
            raise NotImplementedError(
                "the beta-gated skip is not ported yet (ROADMAP A8b)")
        self.channels, self.heads = channels, heads
        self.dropout = dropout
        self.sbf_l, self.sbf_k = sbf_l, sbf_k
        g = generator
        self.lin_rbf = Dense(rbf_dim, channels, use_bias=False, generator=g,
                             dtype=dtype)
        self.lin_rbf.flax_nested = False   # a plain nn.Dense in the reference
        self.lin_query = TorchDense(channels, channels, generator=g,
                                    dtype=dtype)
        self.lin_edge = TorchDense(emb_dim, channels, use_bias=False,
                                   generator=g, dtype=dtype)
        self.lin_sbf = LinearParams(sbf_l * sbf_k, channels, generator=g)
        self.lin_key = TorchDense(channels, channels, generator=g,
                                  dtype=dtype)
        self.lin_value = TorchDense(channels, channels, generator=g,
                                    dtype=dtype)
        self.lin_skip = TorchDense(channels, channels, generator=g)

    def forward(self, x_blk, rbf_blk, atom_edge_attr, out2in, in2out,
                in_mask_flat, windows, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                dropout_mask: Optional[torch.Tensor] = None,
                return_attention_weights: bool = False):
        """x_blk: (N, D, C) in-layout line-graph node features; rbf_blk:
        (N, D, K) radial basis (in-layout); atom_edge_attr: (N, emb);
        out2in: (N, D) flat in-slot of each out-slot's edge; in2out:
        (N*D,) its inverse; in_mask_flat: (N*D,) real in-slots; windows:
        the batch's `models.x2gnn.AttnWindow`s, whose rows cover [0, N) in
        order, each with its cut of the radial sbf factor of the out-table
        rows, cos(angle) and the masked atom-id tables. `generator` draws
        the dropout mask (on x_blk's device); `dropout_mask` (N, D, D, H)
        replaces it. Returns (N, D, C), or with return_attention_weights
        (out, alpha (N, D, D, H))."""
        N, D, _ = x_blk.shape
        if dropout_mask is None and self.dropout > 0.0 and not deterministic:
            dropout_mask = attention_ops.pair_dropout_mask(
                generator, self.dropout, N, D, self.heads, x_blk.device)
        x_src = x_blk * self.lin_rbf(rbf_blk)
        q = self.lin_query(x_blk)
        e_atom = self.lin_edge(atom_edge_attr)
        # pad rows of k_out/v_out carry the projections' bias, but every
        # pair with a pad key is masked, so the kernel's dk/dv there are
        # exactly 0 and the bias gradients are unaffected (:257-265)
        x_src_out = injective_gather(x_src.reshape(N * D, self.channels),
                                     out2in, in2out, in_mask_flat)
        k_out = self.lin_key(x_src_out)
        v_out = self.lin_value(x_src_out)
        # rows of a window beyond its di query slots hold no in-edge (the
        # degree sort guarantees it), so their output is the zero padding
        pieces, alphas = [], []
        for w in windows:
            rows = slice(w.b0, w.b1)
            drop = (None if dropout_mask is None
                    else dropout_mask[rows, :w.di, :w.dk].contiguous())
            o = blocked_attention(
                q[rows, :w.di].contiguous(), k_out[rows, :w.dk].contiguous(),
                v_out[rows, :w.dk].contiguous(), e_atom[rows].contiguous(),
                w.rbf_env_out, self.lin_sbf.kernel, self.lin_sbf.bias, w.z,
                w.a_ids, w.b_ids, heads=self.heads, num_radial=self.sbf_k,
                dropout_mask=drop, return_alpha=return_attention_weights)
            if return_attention_weights:
                o, a = o
                alphas.append(F.pad(a, (0, 0, 0, D - w.dk, 0, D - w.di)))
            pieces.append(F.pad(o, (0, 0, 0, D - w.di)) if w.di < D else o)
        out = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        out = out + self.lin_skip(x_blk)
        if return_attention_weights:
            return out, (alphas[0] if len(alphas) == 1
                         else torch.cat(alphas))
        return out
