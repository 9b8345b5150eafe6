"""X2GNN in the atom-blocked layout (x2gnn_tpu/models/x2gnn.py).

The port covers attention_layout='blocked', variant 'v1', float32, the
atom-wise and both molecule-wise readouts and attention dropout (the
flagship and the gap recipe), on the fused-kernel formulation of the
reference (`z` = clip(cos/norm) and masked atom-id tables, the kernel
computes the Legendre harmonics) on every device. Anything else raises
NotImplementedError until its slice.

A batch's degree tiers or two-tier split (`GraphBatch.tiers`, `n_hi`,
`d_lo`) choose the attention windows of every conv, one kernel call each
(`attention_windows`). The reference honours them on its Pallas branch
only; the port always runs the kernel formulation, so it always does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from x2gnn_tpu_torch.config import ModelConfig
from x2gnn_tpu_torch.data.batching import GraphBatch
from x2gnn_tpu_torch.device import resolve_device
from x2gnn_tpu_torch.nn.conv import BlockedEdgeAttentionConv
from x2gnn_tpu_torch.nn.layers import (
    Dense, EmbeddingBlock, RadialBasisLayer, ResidualLayer)
from x2gnn_tpu_torch.nn.norm import GraphLayerNorm
from x2gnn_tpu_torch.nn.readout import AtomWiseReadout, MolWiseReadout
from x2gnn_tpu_torch.ops.attention import injective_gather, inverse_slots
from x2gnn_tpu_torch.ops.basis import poly_envelope, sbf_radial_part
from x2gnn_tpu_torch.ops.segment import segment_sum


class AttnWindow(NamedTuple):
    """One attention call: atom rows [b0, b1) in a di x dk window, with the
    layer-invariant tables cut to it (contiguous, as the kernels take)."""

    b0: int
    b1: int
    di: int
    dk: int
    rbf_env_out: torch.Tensor  # (b1-b0, dk, L*K)
    z: torch.Tensor            # (b1-b0, di, dk)
    a_ids: torch.Tensor        # (b1-b0, di)
    b_ids: torch.Tensor        # (b1-b0, dk)


def attention_windows(N: int, D: int, n_hi: int, d_lo: int,
                      tiers: tuple) -> list:
    """(b0, b1, di, dk) of each attention call over degree-sorted atoms
    (x2gnn_tpu/nn/conv.py:293-371): one per non-empty tier; else, with a
    two-tier split, (0, n_hi, D, D) and (n_hi, N, d_lo, d_lo); else one
    (0, N, D, D). The windows' rows cover [0, N) in order."""
    if tiers:
        out, b0 = [], 0
        for (b1, di, dk) in tiers:
            if b1 > b0:
                out.append((b0, b1, di, dk))
                b0 = b1
        return out
    if 0 < n_hi < N and 0 < d_lo < D:
        return [(0, n_hi, D, D), (n_hi, N, d_lo, d_lo)]
    return [(0, N, D, D)]


class BlockedGeometry(NamedTuple):
    """Per-batch geometry in the blocked layout, shared by every layer."""

    d_safe: torch.Tensor       # (N, D) in-edge lengths, 1.0 at pad slots
    env: torch.Tensor          # (N, D, 1) envelope, 0 at pad slots
    in_src: torch.Tensor       # (N, D) source atom of each in-edge
    out2in: torch.Tensor       # (N, D) flat in-slot of each out-slot's edge
    in2out: torch.Tensor       # (N*D,) flat out-slot of each in-slot's edge
    mask_flat: torch.Tensor    # (N*D,) real in-slots
    windows: tuple             # AttnWindow of each attention call


def blocked_geometry(batch: GraphBatch, cfg: ModelConfig) -> BlockedGeometry:
    """Edge lengths, envelope, and the fused kernel's pair tables
    (x2gnn_tpu/models/x2gnn.py:60-167, Pallas branch: the out-table's
    radial sbf factor, cos(angle) of in/out edge pairs, the in-edge source
    and out-edge destination atom ids, -1/-2 at pad slots), cut to the
    batch's attention windows."""
    N, D = batch.in_edges.shape
    pos = batch.positions
    edge_mask = batch.in_mask
    in_src = batch.edge_src[batch.in_edges]                  # (N, D)
    ji = pos[in_src] - pos[:, None, :]                       # (N, D, 3)
    d = torch.sqrt(torch.clamp((ji * ji).sum(-1), min=1e-24))
    # padded edges have d == 0; clamp away from the envelope's 1/x pole
    d_safe = torch.where(edge_mask, d, 1.0)
    env = poly_envelope(d_safe, cfg.cutoff, cfg.envelope_exponent)
    env = torch.where(edge_mask, env, 0.0)[..., None]
    rbf_env = sbf_radial_part(d_safe.reshape(-1), cfg.sbf_dim, cfg.rbf_dim,
                              cfg.cutoff, cfg.envelope_exponent,
                              edge_mask.reshape(-1))         # (N*D, L, K)
    # in->out re-index tables: out2in[n, s] = flat in-slot of atom n's
    # s-th out-edge; in2out is its inverse per in-slot (x2gnn.py:126-132)
    out2in = batch.edge_inpos[batch.out_edges]               # (N, D)
    in2out = inverse_slots(out2in, batch.out_mask, N * D)
    mask_flat = edge_mask.reshape(-1)
    rbf_env_out = injective_gather(
        rbf_env.reshape(N * D, cfg.sbf_dim * cfg.rbf_dim), out2in, in2out,
        mask_flat)
    out_dst = batch.edge_dst[batch.out_edges]                # (N, D)
    jk = pos[out_dst] - pos[:, None, :]
    cos_a = torch.einsum("nid,nkd->nik", ji, jk)
    d_out = torch.sqrt(torch.clamp((jk * jk).sum(-1), min=1e-24))
    norm = torch.clamp(d[:, :, None] * d_out[:, None, :], min=1e-12)
    z = torch.clamp(cos_a / norm, -1.0, 1.0)
    a_ids = torch.where(batch.in_mask, in_src, -1).to(torch.int32)
    b_ids = torch.where(batch.out_mask, out_dst, -2).to(torch.int32)
    windows = tuple(
        AttnWindow(b0, b1, di, dk,
                   rbf_env_out[b0:b1, :dk].contiguous(),
                   z[b0:b1, :di, :dk].contiguous(),
                   a_ids[b0:b1, :di].contiguous(),
                   b_ids[b0:b1, :dk].contiguous())
        for b0, b1, di, dk in attention_windows(N, D, batch.n_hi,
                                                batch.d_lo, batch.tiers))
    return BlockedGeometry(d_safe, env, in_src, out2in, in2out, mask_flat,
                           windows)


READOUTS = ("atomwise", "molwise_mean", "molwise_add")


def _check_config(cfg: ModelConfig) -> None:
    unsupported = {
        "attention_layout": (cfg.attention_layout, ("blocked",)),
        "variant": (cfg.variant, ("v1",)),
        "readout": (cfg.readout, READOUTS),
        "compute_dtype": (cfg.compute_dtype, ("float32",)),
        "param_dtype": (cfg.param_dtype, ("float32",)),
    }
    for name, (got, want) in unsupported.items():
        if got not in want:
            raise NotImplementedError(
                f"{name}={got!r} is not ported yet (only {want})")


class X2GNN(nn.Module):
    """Per-molecule predictions (G,) from a blocked-layout GraphBatch of
    torch tensors (`GraphBatch.to(device)`). `forward(batch,
    deterministic=False, generator=g)` trains with attention dropout, each
    conv drawing its mask from `g` in layer order (the reference's
    'dropout' rng stream); `dropout_masks`, one (N, D, D, H) mask per conv,
    replaces the draws (tests and the card-vs-CPU check). The default,
    deterministic=True, never drops: serving, evaluation and the Trainer's
    eval step."""

    def __init__(self, config: ModelConfig,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        _check_config(config)
        device = resolve_device(device)
        cfg = self.config = config
        g = generator
        emb, ch = cfg.embedding_size, cfg.in_channels
        self.mat_trans = Dense(cfg.edge_feat_dim, 2 * emb, generator=g)
        self.emb_trans = Dense(2 * emb, ch, generator=g)
        self.emb_block = EmbeddingBlock(emb, generator=g)
        self.rbf_layer = RadialBasisLayer(cfg.rbf_dim, cfg.cutoff)
        self.edgenn_0 = Dense(emb, emb, generator=g)
        self.edgenn_1 = Dense(emb, emb, generator=g)
        for i in range(cfg.conv_layers + 1):
            if cfg.readout == "atomwise":
                readout = AtomWiseReadout(ch, cfg.rbf_dim,
                                          mlp_depth=cfg.mlp_depth,
                                          generator=g)
            else:
                readout = MolWiseReadout(
                    ch, cfg.rbf_dim, mlp_depth=cfg.mlp_depth,
                    pool=cfg.readout[len("molwise_"):], generator=g)
            self.add_module(f"readout_{i}", readout)
        for i in range(cfg.conv_layers):
            self.add_module(f"conv_{i}", BlockedEdgeAttentionConv(
                ch, cfg.heads, sbf_l=cfg.sbf_dim, sbf_k=cfg.rbf_dim,
                rbf_dim=cfg.rbf_dim, emb_dim=emb, dropout=cfg.dropout,
                use_beta=cfg.beta, generator=g))
            self.add_module(f"norm_{i}", GraphLayerNorm())
            self.add_module(f"bf_skip_{i}", ResidualLayer(ch, generator=g))
            self.add_module(f"dense_bf_skip_{i}",
                            Dense(ch, ch, generator=g))
            self.add_module(f"af_skip_{i}_0", ResidualLayer(ch, generator=g))
            self.add_module(f"af_skip_{i}_1", ResidualLayer(ch, generator=g))
        self.to(device)

    def _layer(self, name: str) -> nn.Module:
        return getattr(self, name)

    def forward(self, batch: GraphBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        cfg = self.config
        if dropout_masks is not None and len(dropout_masks) != \
                cfg.conv_layers:
            raise ValueError(f"{len(dropout_masks)} dropout masks for "
                             f"{cfg.conv_layers} conv layers")
        N, D = batch.in_edges.shape
        num_graphs = batch.y.shape[0]
        geo = blocked_geometry(batch, cfg)
        mask_flat = geo.mask_flat
        src_flat = geo.in_src.reshape(-1)
        gid_flat = batch.edge_gid[batch.in_edges].reshape(-1)

        # ---- featurization (x2gnn.py:104-126) ----
        edge_feat = injective_gather(batch.edge_feat, batch.in_edges,
                                     batch.edge_inpos, batch.edge_mask)
        neo_x = F.silu(self.mat_trans(edge_feat * geo.env))
        neo_x = F.silu(self.emb_trans(neo_x))
        atom_emb = self.emb_block(batch.numbers)
        node_rbf = self.rbf_layer(geo.d_safe) * geo.env      # (N, D, K)
        # per-triplet edge_attr is a pure function of the media atom:
        # the edgenn MLP runs once per atom
        edge_attr = self.edgenn_1(F.silu(self.edgenn_0(atom_emb)))
        node_rbf_flat = node_rbf.reshape(-1, cfg.rbf_dim)
        out_mask3 = batch.out_mask[..., None]

        def edges_to_src_atoms(gated):
            # scatter-free readout aggregation (x2gnn.py:205-216): re-index
            # gated edge rows into the out-table and sum over the degree
            g_out = injective_gather(gated, geo.out2in, geo.in2out,
                                     mask_flat)
            return torch.where(out_mask3, g_out, 0.0).sum(dim=1)

        def run_readout(i: int, x):
            if cfg.readout == "atomwise":
                return self._layer(f"readout_{i}")(
                    x, node_rbf_flat, src_flat, N, edge_mask=mask_flat,
                    aggregate=edges_to_src_atoms)
            return self._layer(f"readout_{i}")(
                x, node_rbf_flat, src_flat, batch.atom_gid, N, num_graphs,
                edge_mask=mask_flat, node_mask=batch.node_mask,
                aggregate=edges_to_src_atoms)

        # ---- conv stack with deep supervision (x2gnn.py:228-274,312-328)
        out = neo_x.reshape(-1, cfg.in_channels)
        results = run_readout(0, out)
        for i in range(cfg.conv_layers):
            res0 = out
            out = self._layer(f"conv_{i}")(
                out.reshape(N, D, cfg.in_channels), node_rbf, edge_attr,
                geo.out2in, geo.in2out, mask_flat, geo.windows,
                deterministic=deterministic, generator=generator,
                dropout_mask=(None if dropout_masks is None
                              else dropout_masks[i]))
            out = out.reshape(-1, cfg.in_channels)
            out = self._layer(f"norm_{i}")(out, gid_flat, num_graphs,
                                           mask=mask_flat)
            out = self._layer(f"bf_skip_{i}")(out)
            out = F.silu(self._layer(f"dense_bf_skip_{i}")(out))
            out = out + res0
            out = self._layer(f"af_skip_{i}_0")(out)
            out = self._layer(f"af_skip_{i}_1")(out)
            results = results + run_readout(i + 1, out)

        if cfg.readout == "atomwise":
            # per-atom scalars -> molecule sums (the molecule-wise
            # readouts pooled already: x2gnn.py:322-325)
            results = segment_sum(results, batch.atom_gid, num_graphs,
                                  mask=batch.node_mask)
        return results.reshape(-1)
