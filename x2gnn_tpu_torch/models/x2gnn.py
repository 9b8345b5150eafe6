"""X2GNN (x2gnn_tpu/models/x2gnn.py) in all three attention layouts.

`attention_layout` "blocked" keeps every per-edge quantity in the atom
in-table (N, D, ...) and runs each conv's attention as the fused CUDA
kernels (`BlockedEdgeAttentionConv`); "segment" and "padded" keep them as
flat edge rows (E, ...), with the per-triplet 2D basis and edge
attributes (T, ...), and run `EdgeAttentionConv` as PyTorch ops (the
reference runs them as XLA ops, no Pallas kernel). One parameter set
serves all three. `variant` "v2" recomputes each layer's edge attributes
from the atoms' aggregated rows with a per-layer MLP (edgenn_{i}_0/1) and
divides the result by conv_layers (:117-126, :233-242, :326-327); `beta`
gates each conv's skip. The blocked layout runs the fused-kernel
formulation of the reference (`z` = clip(cos/norm) and masked atom-id
tables, the kernel computes the Legendre harmonics) on every device;
the flat layouts compute the angle with arctan2, as the reference's
(:177-187).

`param_dtype` is read and ignored, as the reference reads it nowhere;
`compute_dtype="bfloat16"` runs the conv stack in bf16.

Edge features may arrive float16, or int8 with per-edge scales
(`GraphBatch.edge_feat_scale`): they are upcast to float32 at entry and
dequantized (x2gnn_tpu/models/x2gnn.py:78-95).

A batch's degree tiers or two-tier split (`GraphBatch.tiers`, `n_hi`,
`d_lo`) choose the attention windows of every blocked conv, one kernel
call each (`attention_windows`). The reference honours them on its
Pallas branch only; the port always runs the kernel formulation, so it
always does. The flat layouts ignore them.

The flat layouts' sums over triplets and the backward of every gather of
edge rows into triplets go through fixed-order tables
(`ops.attention.TripletTables`), and the readouts' edges -> atoms sums
through the out-table, as in the blocked layout: no float atomics, so a
training step gives the same bits on every run in every layout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from x2gnn_tpu_torch.config import ModelConfig
from x2gnn_tpu_torch.data.batching import GraphBatch
from x2gnn_tpu_torch.device import resolve_device
from x2gnn_tpu_torch.nn.conv import (
    BlockedEdgeAttentionConv, EdgeAttentionConv)
from x2gnn_tpu_torch.nn.layers import (
    Dense, EmbeddingBlock, RadialBasisLayer, ResidualLayer)
from x2gnn_tpu_torch.nn.norm import GraphLayerNorm
from x2gnn_tpu_torch.nn.readout import AtomWiseReadout, MolWiseReadout
from x2gnn_tpu_torch.ops import attention as attention_ops
from x2gnn_tpu_torch.ops.attention import (
    TripletTables, injective_gather, inverse_slots, triplet_pair_positions,
    triplet_tables)
from x2gnn_tpu_torch.ops.basis import poly_envelope, sbf_2d, sbf_radial_part
from x2gnn_tpu_torch.ops.segment import (
    SegmentTable, gather_rows, segment_sum)


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


class FlatGeometry(NamedTuple):
    """Per-batch geometry of the flat layouts, shared by every layer."""

    d_safe: torch.Tensor       # (E,) edge lengths, 1.0 at pad edges
    env: torch.Tensor          # (E, 1) envelope, 0 at pad edges
    sbf: torch.Tensor          # (T, L*K) per-triplet 2D basis
    tables: TripletTables      # the triplets' gather tables
    atom_edges: SegmentTable   # edges by destination atom (the in-table)


def flat_geometry(batch: GraphBatch, cfg: ModelConfig) -> FlatGeometry:
    """Edge lengths, envelope, the per-triplet angle (arctan2) and 2D
    basis (x2gnn_tpu/models/x2gnn.py:73-79, :176-187), and the gather
    tables of a batch padded with triplets."""
    pos = batch.positions
    edge_mask = batch.edge_mask
    if batch.nbr_trip.shape[0] != edge_mask.shape[0]:
        raise ValueError("the segment and padded layouts need a batch "
                         "padded with triplets (pad_graphs(..., "
                         "with_triplets=True))")
    diff = pos[batch.edge_src] - pos[batch.edge_dst]
    d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-24))
    d_safe = torch.where(edge_mask, d, 1.0)
    env = poly_envelope(d_safe, cfg.cutoff, cfg.envelope_exponent)
    env = torch.where(edge_mask, env, 0.0)[..., None]
    ji = pos[batch.trip_i] - pos[batch.trip_j]
    jk = pos[batch.trip_k] - pos[batch.trip_j]
    cos_a = (ji * jk).sum(-1)
    cross = torch.linalg.cross(ji, jk, dim=-1)
    sin_a = torch.sqrt(torch.clamp((cross * cross).sum(-1), min=1e-24))
    sbf = sbf_2d(d_safe, torch.atan2(sin_a, cos_a), batch.trip_src_edge,
                 cfg.sbf_dim, cfg.rbf_dim, cfg.cutoff,
                 cfg.envelope_exponent, edge_mask=edge_mask)
    tables = triplet_tables(batch.trip_src_edge, batch.trip_dst_edge,
                            batch.trip_mask, batch.nbr_trip, batch.nbr_mask,
                            batch.nbr_src, edge_mask.shape[0])
    atom_edges = SegmentTable(torch.where(edge_mask, batch.edge_dst, 0),
                              edge_mask, batch.in_edges, batch.in_mask)
    return FlatGeometry(d_safe, env, sbf, tables, atom_edges)


LAYOUTS = ("segment", "padded", "blocked")


def needs_triplets(cfg: ModelConfig) -> bool:
    """Whether the model reads a batch's triplet arrays: the flat layouts
    do, the blocked one never does, so only the flat layouts' batches are
    padded with them (`pad_graphs(..., with_triplets=)`; the reference's
    trainer.py:122-128, infer.py:221-226)."""
    return cfg.attention_layout != "blocked"
VARIANTS = ("v1", "v2")
READOUTS = ("atomwise", "molwise_mean", "molwise_add")
# ModelConfig.compute_dtype -> the convs' computation dtype (None: float32)
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _check_config(cfg: ModelConfig) -> None:
    """Every layout, variant and readout of the reference; float32 or
    bfloat16 compute. `param_dtype` is not read: the reference reads it
    nowhere (x2gnn_tpu/config.py:48 is its only use)."""
    allowed = {
        "attention_layout": (cfg.attention_layout, LAYOUTS),
        "variant": (cfg.variant, VARIANTS),
        "readout": (cfg.readout, READOUTS),
        "compute_dtype": (cfg.compute_dtype, tuple(COMPUTE_DTYPES)),
    }
    for name, (got, want) in allowed.items():
        if got not in want:
            raise ValueError(f"{name}={got!r}: one of {want}")


class X2GNN(nn.Module):
    """Per-molecule predictions (G,) from a GraphBatch of torch tensors
    (`GraphBatch.to(device)`), padded with triplets for the segment and
    padded layouts. `forward(batch, deterministic=False, generator=g)`
    trains with attention dropout, each conv drawing its mask from `g` in
    layer order (the reference's 'dropout' rng stream), one canonical
    (N, D, D, H) pair-space mask per conv in every layout; `dropout_masks`,
    one such mask per conv, replaces the draws (tests and the card-vs-CPU
    check). The default, deterministic=True, never drops: serving,
    evaluation and the Trainer's eval step.

    `compute_dtype="bfloat16"` runs the convs' projections in bf16, the
    blocked attention kernels in bf16 storage and the flat layouts'
    attention in bf16; a conv's output is float32 (the float32 skip
    added), as the reference casts it (x2gnn_tpu/models/x2gnn.py:228-311).
    With dropout the model draws each conv's mask itself and hands it in,
    in every layout. `remat` recomputes each conv in the backward
    (torch.utils.checkpoint, non-reentrant) instead of keeping its
    activations; the checkpoint replays only the default generators, and
    the recompute uses the mask drawn before the checkpointed call.

    In v2 the atom embedding is built and unused, as in the reference, so
    its parameters get no gradient (`torch.autograd.grad(...,
    materialize_grads=True)` gives zeros, the reference's)."""

    def __init__(self, config: ModelConfig,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        _check_config(config)
        device = resolve_device(device)
        cfg = self.config = config
        g = generator
        emb, ch = cfg.embedding_size, cfg.in_channels
        v2 = cfg.variant == "v2"
        self.mat_trans = Dense(cfg.edge_feat_dim, 2 * emb, generator=g)
        self.emb_trans = Dense(2 * emb, ch, generator=g)
        self.emb_block = EmbeddingBlock(emb, generator=g)
        self.rbf_layer = RadialBasisLayer(cfg.rbf_dim, cfg.cutoff)
        if v2:
            # per-layer MLPs on the atoms' aggregated rows (:117-120)
            for i in range(cfg.conv_layers):
                for j in range(2):
                    self.add_module(f"edgenn_{i}_{j}",
                                    Dense(ch, ch, generator=g))
        else:
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
        conv_kw = dict(sbf_l=cfg.sbf_dim, sbf_k=cfg.rbf_dim,
                       rbf_dim=cfg.rbf_dim, emb_dim=ch if v2 else emb,
                       dropout=cfg.dropout, use_beta=cfg.beta, generator=g,
                       dtype=COMPUTE_DTYPES[cfg.compute_dtype])
        for i in range(cfg.conv_layers):
            if cfg.attention_layout == "blocked":
                conv = BlockedEdgeAttentionConv(ch, cfg.heads, **conv_kw)
            else:
                conv = EdgeAttentionConv(ch, cfg.heads,
                                         layout=cfg.attention_layout,
                                         **conv_kw)
            self.add_module(f"conv_{i}", conv)
            self.add_module(f"norm_{i}", GraphLayerNorm())
            self.add_module(f"bf_skip_{i}", ResidualLayer(ch, generator=g))
            self.add_module(f"dense_bf_skip_{i}",
                            Dense(ch, ch, generator=g))
            self.add_module(f"af_skip_{i}_0", ResidualLayer(ch, generator=g))
            self.add_module(f"af_skip_{i}_1", ResidualLayer(ch, generator=g))
        self.to(device)

    def _layer(self, name: str) -> nn.Module:
        return getattr(self, name)

    def _edgenn(self, h: torch.Tensor, tag: str = "") -> torch.Tensor:
        h = F.silu(self._layer(f"edgenn{tag}_0")(h))
        return self._layer(f"edgenn{tag}_1")(h)

    def forward(self, batch: GraphBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        cfg = self.config
        if dropout_masks is not None and len(dropout_masks) != \
                cfg.conv_layers:
            raise ValueError(f"{len(dropout_masks)} dropout masks for "
                             f"{cfg.conv_layers} conv layers")
        blocked = cfg.attention_layout == "blocked"
        v2 = cfg.variant == "v2"
        N, D = batch.in_edges.shape
        num_graphs = batch.y.shape[0]

        # ---- geometry (x2gnn.py:56-102): blocked rows are the in-table's
        # N*D slots, flat rows the E edges ----
        scale = batch.edge_feat_scale
        if blocked:
            geo = blocked_geometry(batch, cfg)
            mask_flat = geo.mask_flat
            src_flat = geo.in_src.reshape(-1)
            gid_flat = batch.edge_gid[batch.in_edges].reshape(-1)
            edge_feat = injective_gather(batch.edge_feat, batch.in_edges,
                                         batch.edge_inpos, batch.edge_mask)
            if scale is not None:
                scale = injective_gather(
                    scale.float().reshape(-1, 1), batch.in_edges,
                    batch.edge_inpos, batch.edge_mask)
            out_table, out_inv = geo.out2in, geo.in2out
        else:
            geo = flat_geometry(batch, cfg)
            mask_flat, src_flat, gid_flat = (batch.edge_mask, batch.edge_src,
                                             batch.edge_gid)
            edge_feat = batch.edge_feat
            if scale is not None:
                scale = scale.float()[:, None]
            out_table, out_inv = batch.out_edges, batch.edge_outpos

        # ---- featurization (x2gnn.py:78-126): float16 or int8 features
        # are gathered as they are, then upcast (and int8 dequantized by
        # its per-edge scale); all math runs float32 ----
        edge_feat = edge_feat.float()
        if scale is not None:
            edge_feat = edge_feat * scale
        neo_x = F.silu(self.mat_trans(edge_feat * geo.env))
        neo_x = F.silu(self.emb_trans(neo_x))
        node_rbf = self.rbf_layer(geo.d_safe) * geo.env      # (.., K)
        node_rbf_flat = node_rbf.reshape(-1, cfg.rbf_dim)
        out_mask3 = batch.out_mask[..., None]

        def edges_to_src_atoms(gated):
            # scatter-free aggregation into the source atoms (x2gnn.py:
            # 205-216): re-index the edge rows into the out-table and sum
            # over the degree; the flat layouts' segment_sum over
            # edge_src, in a fixed order
            g_out = injective_gather(gated, out_table, out_inv, mask_flat)
            return torch.where(out_mask3, g_out, 0.0).sum(dim=1)

        def per_triplet(x_atom):
            # the media atom's row for every triplet, x[trip_j]: atom ->
            # in-edge -> triplet, each gather's backward a fixed-order sum
            return gather_rows(gather_rows(x_atom, geo.atom_edges),
                               geo.tables.dst)

        edge_attr = None
        if not v2:
            # per-triplet edge_attr is a pure function of the media atom:
            # the edgenn MLP runs once per atom
            edge_attr = self._edgenn(self.emb_block(batch.numbers))
            if not blocked:
                edge_attr = per_triplet(edge_attr)

        def run_readout(i: int, x):
            if cfg.readout == "atomwise":
                return self._layer(f"readout_{i}")(
                    x, node_rbf_flat, src_flat, N, edge_mask=mask_flat,
                    aggregate=edges_to_src_atoms)
            return self._layer(f"readout_{i}")(
                x, node_rbf_flat, src_flat, batch.atom_gid, N, num_graphs,
                edge_mask=mask_flat, node_mask=batch.node_mask,
                aggregate=edges_to_src_atoms)

        drop = cfg.dropout > 0.0 and not deterministic
        drop_pair_pos = None
        if not blocked and (drop or dropout_masks is not None):
            drop_pair_pos = triplet_pair_positions(
                batch.trip_dst_edge, batch.trip_src_edge, batch.edge_inpos,
                batch.edge_outpos, D)

        # ---- conv stack with deep supervision (x2gnn.py:228-328)
        out = neo_x.reshape(-1, cfg.in_channels)
        results = run_readout(0, out)
        for i in range(cfg.conv_layers):
            res0 = out
            if v2:
                # V2 (model.py:136-140): this layer's edge_attr from the
                # aggregated atom rows of the media atom
                edge_attr = self._edgenn(edges_to_src_atoms(out), f"_{i}")
                if not blocked:
                    edge_attr = per_triplet(edge_attr)
            conv = self._layer(f"conv_{i}")
            mask = None if dropout_masks is None else dropout_masks[i]
            if drop and mask is None:
                # every conv's mask is drawn here, in layer order, in the
                # canonical pair space of every layout (a checkpoint's
                # recompute must not draw again)
                mask = attention_ops.pair_dropout_mask(
                    generator, cfg.dropout, N, D, cfg.heads,
                    batch.positions.device)
            kwargs = dict(dropout_mask=mask)
            if blocked:
                args = (out.reshape(N, D, cfg.in_channels), node_rbf,
                        edge_attr, geo.out2in, geo.in2out, mask_flat,
                        geo.windows)
            else:
                args = (out, node_rbf, geo.sbf, edge_attr, geo.tables)
                kwargs.update(drop_pair_pos=drop_pair_pos)
            if cfg.remat:
                out = torch.utils.checkpoint.checkpoint(
                    conv, *args, use_reentrant=False, **kwargs)
            else:
                out = conv(*args, **kwargs)
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
        if v2:
            results = results / cfg.conv_layers              # model.py:150
        return results.reshape(-1)
