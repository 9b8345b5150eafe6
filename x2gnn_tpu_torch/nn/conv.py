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

The flat conv takes per-edge rows (E, C), the per-triplet 2D basis and
edge attributes, and the batch's `ops.attention.TripletTables`, and runs
`segment_attention` or `padded_attention`. Its `dtype` also covers
lin_sbf (a plain dense layer there) and the attention itself, as the
reference's flat conv computes them in it (:420-501); the output is
float32 after the float32 skip. Dropout takes the same canonical
pair-space mask as the blocked conv, cut per triplet through
`drop_pair_pos` (:129-143, :153-165), so one mask drops the same weights
in all three layouts. The flat conv draws no mask of its own:
`X2GNN.forward` draws every conv's mask and hands it in.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from x2gnn_tpu_torch.nn.init import glorot_orthogonal_
from x2gnn_tpu_torch.nn.layers import Dense, TorchDense
from x2gnn_tpu_torch.ops import attention as attention_ops
from x2gnn_tpu_torch.ops.attention import (
    TripletTables, beta_gate, injective_gather, padded_attention,
    segment_attention)
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


class _ConvParameters(nn.Module):
    """The parameters both convs hold, in the reference's names and one
    registration order: lin_rbf, lin_query, lin_edge (emb_dim inputs: the
    embedding width in v1, in_channels in v2), lin_sbf (a flax-layout
    (L*K, C) kernel and bias), lin_key, lin_value, lin_skip and, with
    use_beta, lin_beta (3C -> 1, no bias, float32)."""

    def __init__(self, channels: int, heads: int = 16, sbf_l: int = 7,
                 sbf_k: int = 6, rbf_dim: int = 6, emb_dim: int = 128,
                 dropout: float = 0.0, use_beta: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.channels, self.heads = channels, heads
        self.dropout = dropout
        self.sbf_l, self.sbf_k = sbf_l, sbf_k
        self.dtype = dtype
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
        self.lin_beta = (TorchDense(3 * channels, 1, use_bias=False,
                                    generator=g) if use_beta else None)

    def skip(self, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The attention output plus the skip projection of the layer's
        input, or with use_beta the two blended by the beta gate."""
        skip = self.lin_skip(x)
        if self.lin_beta is not None:
            return beta_gate(out, skip, self.lin_beta)
        return out + skip


class BlockedEdgeAttentionConv(_ConvParameters):
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
        out = self.skip(out, x_blk)
        if return_attention_weights:
            return out, (alphas[0] if len(alphas) == 1
                         else torch.cat(alphas))
        return out


class EdgeAttentionConv(_ConvParameters):
    """The flat-edge conv of the `segment` and `padded` layouts
    (x2gnn_tpu/nn/conv.py:57-184); `layout` picks one."""

    def __init__(self, channels: int, heads: int = 16,
                 layout: str = "segment", **kw):
        if layout not in ("segment", "padded"):
            raise ValueError(f"layout={layout!r}: 'segment' or 'padded'")
        super().__init__(channels, heads, **kw)
        self.layout = layout

    def forward(self, x, rbf, sbf, edge_attr, tables: TripletTables,
                dropout_mask: Optional[torch.Tensor] = None,
                drop_pair_pos: Optional[torch.Tensor] = None,
                return_attention_weights: bool = False):
        """x: (E, C) line-graph node (= atom-graph edge) features; rbf:
        (E, K) radial basis per edge; sbf: (T, L*K) per-triplet 2D basis;
        edge_attr: (T, emb) media-atom attributes per triplet; tables: the
        batch's `triplet_tables`. The keep mask `dropout_mask`
        (N, D, D, H), in the canonical pair space (`X2GNN.forward` draws
        it), is cut per triplet at `drop_pair_pos`
        (`ops.attention.triplet_pair_positions`). Returns (E, C) float32,
        or with return_attention_weights (segment layout only)
        (out, (T, H))."""
        E = x.shape[0]
        H = self.heads
        C = self.channels // H
        dt = self.dtype
        if return_attention_weights and self.layout != "segment":
            raise ValueError("attention weights are only available in the "
                             "segment layout (x2gnn_tpu/nn/conv.py:511-515)")
        x_src = x * self.lin_rbf(rbf)
        q = self.lin_query(x).reshape(E, H, C)
        k = self.lin_key(x_src).reshape(E, H, C)
        v = self.lin_value(x_src).reshape(E, H, C)
        e = self.lin_edge(edge_attr).reshape(-1, H, C)
        kernel, bias = self.lin_sbf.kernel, self.lin_sbf.bias
        if dt is not None:
            sbf, kernel, bias = sbf.to(dt), kernel.to(dt), bias.to(dt)
        s = (sbf @ kernel + bias).reshape(-1, H, C)

        keep = None
        if dropout_mask is not None:
            per_trip = dropout_mask.reshape(-1, H)[drop_pair_pos]
            keep = (per_trip if self.layout == "segment"
                    else per_trip[tables.nbr_trip])

        weights = None
        if self.layout == "padded":
            out = padded_attention(q, k, v, e, s, tables, dropout_mask=keep)
        else:
            out = segment_attention(q, k, v, e, s, tables, dropout_mask=keep,
                                    return_weights=return_attention_weights)
            if return_attention_weights:
                out, weights = out
        out = self.skip(out.reshape(E, self.channels), x)
        return (out, weights) if return_attention_weights else out
