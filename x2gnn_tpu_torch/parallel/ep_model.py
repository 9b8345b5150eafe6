"""Edge-partitioned X2GNN forward and training step
(x2gnn_tpu/parallel/ep_model.py): the activations of ONE batched graph
are split over the ranks of the mesh's 'data' axis, for graphs whose
activations outgrow one card.

Atoms are cut into contiguous pieces, one per rank (rank 0 gets the
first, highest-degree atoms of a degree-sorted batch), and every per-edge
activation lives in the blocked in-table layout (Nl, D, C) of the rank's
atoms, so the attention of each atom is local and runs as the port's
hand-written kernels (`ops/blocked_attn.py::blocked_attention`, one
window (Nl, D, D) per rank and conv; the EP path has no degree tiers, as
in the reference, :459-467). What crosses ranks:

  * the row exchange (:243-310, `_Exchange`): rows of the rank-sharded
    flat in-slot table gathered through the GLOBAL `out2in` table, by an
    all-gather of the table (`allgather`) or by rotating the shards
    around the ring with send/recv (`ring`, one remote shard in memory);
    each out-slot takes its row from its one owner and the others give
    exactly zero, so both modes give the same bits. Its backward is the
    same gather of the cotangents through the inverse table `in2out`
    (real in- and out-slots are in bijection): no scatter in either pass;
  * the positions, all-gathered once for the geometry;
  * sums over graphs (the graph norm's statistics, :220-235; the
    molecule-wise pooling, :404-416; the atom-wise sum into molecules,
    :530-535) and the embedding's frequency counts (:189-207, handed to
    `nn/layers.py::EmbeddingBlock`), all-reduced.

Gradients of replicated computation. An all-reduced sum feeds
computation that every rank repeats (the molecule-wise readout's MLP on
the pooled graphs, the loss). `_AllReduceSum`'s backward all-reduces the
cotangent: with every rank's backward seeded by its (replicated) loss,
each rank's cotangent of a local activation is the EP size times its
share of the true one, and so is every parameter gradient summed over
the EP ranks, the repeated tail's included. The step divides by that
count: `data_parallel.weighted_all_reduce` divides psum(g·cnt) by
psum(cnt), which counts each real graph once per EP rank. So one
all-reduce over every rank gives the true gradient of the mean loss, in
pure EP (cnt the batch's graphs on every rank) as in DP x EP.

The forward reads the parameters of the port's own `models/x2gnn.py::
X2GNN` (one parameter set, as the reference keeps one tree), so
`load_flax_params` and checkpoints work unchanged. It computes in
float32 (compute_dtype "bfloat16" is refused: the reference's EP forward
applies its parameters in float32, :159-169); int8 features are refused
(the layout pre-gathers features, :132-136), float16 ones are widened.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint

from x2gnn_tpu_torch.data.batching import GraphBatch
from x2gnn_tpu_torch.ops import attention as attention_ops
from x2gnn_tpu_torch.ops.attention import dropout_generator
from x2gnn_tpu_torch.ops.basis import poly_envelope, sbf_radial_part
from x2gnn_tpu_torch.ops.blocked_attn import blocked_attention
from x2gnn_tpu_torch.ops.segment import segment_sum
from x2gnn_tpu_torch.parallel.data_parallel import reduce_and_update
from x2gnn_tpu_torch.parallel.mesh import Mesh
from x2gnn_tpu_torch.train.loss import masked_mae, smooth_l1_loss

AXIS = "data"
KV_EXCHANGES = ("allgather", "ring")


@dataclasses.dataclass
class EPBatch:
    """A GraphBatch re-laid-out for edge partitioning (:68-91). The atom
    axis N leads every field but y and graph_mask, which every rank holds
    whole. D = degree budget, F = feature width. numpy from
    `make_ep_batch`; `shard` cuts a rank's atoms, `to` gives torch
    tensors (int32 fields as int64)."""

    numbers: np.ndarray        # (N,) int32
    positions: np.ndarray      # (N, 3) float32
    atom_ids: np.ndarray       # (N,) int32 global atom index (= arange)
    atom_gid: np.ndarray       # (N,) int32 graph id
    node_mask: np.ndarray      # (N,) bool
    edge_src_blk: np.ndarray   # (N, D) int32 source atom of in-edge slots
    edge_gid_blk: np.ndarray   # (N, D) int32 graph id per in-edge slot
    in_mask: np.ndarray        # (N, D) bool
    feat_blk: np.ndarray       # (N, D, F) float16/32 features, in-layout
    out_dst_blk: np.ndarray    # (N, D) int32 dst atom of out-edge slots
    out_mask: np.ndarray       # (N, D) bool
    out2in: np.ndarray         # (N, D) int32 GLOBAL flat in-slot of each
                               # out-slot's edge
    in2out: np.ndarray         # (N, D) int32 GLOBAL flat out-slot of each
                               # in-slot's edge (the inverse table)
    y: np.ndarray              # (G,)
    graph_mask: np.ndarray     # (G,) bool

    REPLICATED = ("y", "graph_mask")

    def _map(self, fn) -> "EPBatch":
        return EPBatch(**{f.name: fn(f.name, getattr(self, f.name))
                          for f in dataclasses.fields(self)})

    def shard(self, index: int, count: int) -> "EPBatch":
        """The rows of atom piece `index` of `count` (:137-150)."""
        n = self.numbers.shape[0]
        if n % count:
            raise ValueError(f"{n} atoms do not split into {count} pieces: "
                             "make_ep_batch pads them")
        lo, hi = index * n // count, (index + 1) * n // count
        return self._map(lambda f, a: a if f in self.REPLICATED
                         else a[lo:hi])

    def to(self, device, non_blocking: bool = False) -> "EPBatch":
        def conv(_, a):
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a)
                a = torch.from_numpy(a.astype(np.int64) if a.dtype
                                     == np.int32 else a)
            return a.to(device, non_blocking=non_blocking)
        return self._map(conv)

    def pin_memory(self) -> "EPBatch":
        return self.to("cpu")._map(lambda _, a: a.pin_memory())

    def arrays(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def make_ep_batch(batch: GraphBatch, n_dev: int) -> EPBatch:
    """The EP layout of a host GraphBatch (:94-134), the atom axis padded
    to a multiple of `n_dev`; float16 features stay float16, others ride
    as float32. An int8 batch (per-edge scales) is refused."""
    b = batch
    if b.edge_feat_scale is not None:
        raise ValueError("int8 features (edge_feat_scale) cannot ride the EP "
                         "layout, which gathers features per in-slot; use "
                         "float16")
    N, D = b.in_edges.shape
    pad = (-N) % n_dev

    def padN(x, fill=0):
        x = np.asarray(x)
        if pad == 0:
            return x
        width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, width, constant_values=fill)

    in_edges, in_mask = padN(b.in_edges), padN(b.in_mask)
    out_edges, out_mask = padN(b.out_edges), padN(b.out_mask)
    edge_feat = np.asarray(b.edge_feat)
    feat_dtype = (np.float16 if edge_feat.dtype == np.float16
                  else np.float32)
    feat_blk = np.where(in_mask[..., None], edge_feat[in_edges],
                        np.zeros((), edge_feat.dtype))
    return EPBatch(
        numbers=padN(b.numbers),
        positions=padN(np.asarray(b.positions, np.float32)),
        atom_ids=np.arange(N + pad, dtype=np.int32),
        atom_gid=padN(b.atom_gid),
        node_mask=padN(b.node_mask, fill=False),
        edge_src_blk=np.where(in_mask, b.edge_src[in_edges], 0).astype(
            np.int32),
        edge_gid_blk=np.where(in_mask, b.edge_gid[in_edges], 0).astype(
            np.int32),
        in_mask=in_mask, feat_blk=feat_blk.astype(feat_dtype),
        out_dst_blk=np.where(out_mask, b.edge_dst[out_edges], 0).astype(
            np.int32),
        out_mask=out_mask,
        out2in=np.where(out_mask, b.edge_inpos[out_edges], 0).astype(
            np.int32),
        in2out=np.where(in_mask, b.edge_outpos[in_edges], 0).astype(
            np.int32),
        y=np.asarray(b.y, np.float32), graph_mask=np.asarray(b.graph_mask))


def shard_ep_batch(epb: EPBatch, mesh: Mesh, device) -> EPBatch:
    """This rank's atoms of `epb` on `device`; y and graph_mask whole
    (:137-150)."""
    return epb.shard(mesh.axis_index(AXIS), mesh.axis_size(AXIS)).to(device)


# ---------------------------------------------------------------------------
# collectives over the EP ranks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Axis:
    """The EP ranks: their process group, global ranks in atom order, this
    rank's index among them and the row exchange's mode."""
    group: object
    ranks: tuple
    index: int
    mode: str

    @classmethod
    def of(cls, mesh: Mesh, mode: str = "allgather") -> "_Axis":
        if mode not in KV_EXCHANGES:
            raise ValueError(f"kv_exchange={mode!r}: one of {KV_EXCHANGES}")
        return cls(mesh.group(AXIS), mesh.axis_ranks(AXIS),
                   mesh.axis_index(AXIS), mode)


# torch 2.13 renames all_gather_into_tensor to all_gather_single and warns
# on the old name; earlier releases have only the old one
_all_gather_into = getattr(dist, "all_gather_single",
                           dist.all_gather_into_tensor)


def all_gather_rows(x: torch.Tensor, axis: _Axis) -> torch.Tensor:
    """The EP ranks' `x` (R, ...) stacked in rank order (len * R, ...)."""
    x = x.contiguous()
    out = x.new_empty((len(axis.ranks) * x.shape[0],) + x.shape[1:])
    _all_gather_into(out, x, group=axis.group)
    return out


def _gather_rows(x, ids, take, axis: _Axis):
    """Rows `ids` (GLOBAL row numbers, (Nl, D)) of the table whose rows are
    sharded over the EP ranks in order, this rank holding `x`; 0 where
    `take` is False. `allgather` assembles the table; `ring` passes the
    shards around (each rank sends its current shard to the next rank and
    receives the previous rank's) and selects each row from its owner's
    shard as it comes by (:243-263)."""
    if axis.mode == "allgather":
        return torch.where(take[..., None], all_gather_rows(x, axis)[ids],
                           0.0)
    n, me, rows = len(axis.ranks), axis.index, x.shape[0]
    out = x.new_zeros(ids.shape + x.shape[1:])
    buf = x.contiguous()
    for s in range(n):
        lo = ((me - s) % n) * rows        # the owner of the shard in buf
        mine = take & (ids >= lo) & (ids < lo + rows)
        out = torch.where(mine[..., None],
                          buf[torch.clamp(ids - lo, 0, rows - 1)], out)
        if s < n - 1:
            nxt = torch.empty_like(buf)
            for work in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, buf, axis.ranks[(me + 1) % n],
                               axis.group),
                    dist.P2POp(dist.irecv, nxt, axis.ranks[(me - 1) % n],
                               axis.group)]):
                work.wait()
            buf = nxt
    return out


class _Exchange(torch.autograd.Function):
    """x_flat (Nl*D, C), this rank's rows of the flat in-slot table ->
    (Nl, D, C): row out2in[n, s] at each out-slot taken by `out_mask`, 0
    elsewhere. Backward: the cotangents' own gather through the inverse
    table `in2out` at the real in-slots `in_mask` (:266-310)."""

    @staticmethod
    def forward(ctx, x_flat, out2in, in2out, out_mask, in_mask, axis):
        ctx.save_for_backward(in2out, out_mask, in_mask)
        ctx.axis = axis
        return _gather_rows(x_flat, out2in, out_mask, axis)

    @staticmethod
    def backward(ctx, g):
        in2out, out_mask, in_mask = ctx.saved_tensors
        g = torch.where(out_mask[..., None], g, 0.0)
        gf = g.reshape(-1, g.shape[-1])
        dx = _gather_rows(gf, in2out, in_mask, ctx.axis)
        return dx.reshape(gf.shape), None, None, None, None, None


def exchange(x_flat, epb: EPBatch, axis: _Axis) -> torch.Tensor:
    """`_Exchange` of the rows x_flat (Nl*D, C) into the out-table."""
    return _Exchange.apply(x_flat, epb.out2in, epb.in2out, epb.out_mask,
                           epb.in_mask, axis)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group; its backward all-reduces the cotangent (see
    the module docstring: the step divides by the EP size)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, axis: _Axis) -> torch.Tensor:
    if not x.requires_grad:
        x = x.clone()
        dist.all_reduce(x, group=axis.group)
        return x
    return _AllReduceSum.apply(x, axis.group)


# ---------------------------------------------------------------------------
# the per-rank forward
# ---------------------------------------------------------------------------

def _check_model(cfg) -> None:
    if cfg.compute_dtype != "float32":
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: the "
                         "edge-partitioned forward computes in float32, as "
                         "the reference's (x2gnn_tpu/parallel/ep_model.py:"
                         "159-169)")


def ep_forward(model, epb: EPBatch, axis: _Axis,
               generator: Optional[torch.Generator] = None,
               dropout_masks: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
    """(G,) predictions, the same on every EP rank, from this rank's atoms
    `epb` (torch tensors) and the parameters of `model` (:312-538). With
    `generator` and model.config.dropout > 0 each conv draws this rank's
    (Nl, D, D, H) keep mask from it; `dropout_masks` (one per conv)
    replace the draws."""
    cfg = model.config
    _check_model(cfg)
    Nl, D = epb.in_mask.shape
    G = epb.y.shape[0]
    HC, H, L, K = cfg.in_channels, cfg.heads, cfg.sbf_dim, cfg.rbf_dim
    in_mask, nm = epb.in_mask, epb.node_mask
    mask_flat = in_mask.reshape(-1)
    gid_flat = epb.edge_gid_blk.reshape(-1)
    v2 = cfg.variant == "v2"

    # ---- geometry on the all-gathered positions (in-layout) ----
    pos_g = all_gather_rows(epb.positions, axis)
    own = epb.positions[:, None, :]
    ji = pos_g[epb.edge_src_blk] - own                   # (Nl, D, 3)
    d = torch.sqrt(torch.clamp((ji * ji).sum(-1), min=1e-24))
    d_safe = torch.where(in_mask, d, 1.0)
    env = poly_envelope(d_safe, cfg.cutoff, cfg.envelope_exponent)
    env = torch.where(in_mask, env, 0.0)[..., None]      # (Nl, D, 1)
    rbf_env = sbf_radial_part(d_safe.reshape(-1), L, K, cfg.cutoff,
                              cfg.envelope_exponent, mask_flat).reshape(
                                  Nl * D, L * K)
    jk = pos_g[epb.out_dst_blk] - own                    # (Nl, D, 3)
    cos_a = torch.einsum("nid,nkd->nik", ji, jk)
    d_out = torch.sqrt(torch.clamp((jk * jk).sum(-1), min=1e-24))
    norm = torch.clamp(d[:, :, None] * d_out[:, None, :], min=1e-12)
    z = torch.clamp(cos_a / norm, -1.0, 1.0)
    a_ids = torch.where(in_mask, epb.edge_src_blk, -1).to(torch.int32)
    b_ids = torch.where(epb.out_mask, epb.out_dst_blk, -2).to(torch.int32)

    # ---- featurization ----
    neo_x = F.silu(model.mat_trans(epb.feat_blk.float() * env))
    neo_x = F.silu(model.emb_trans(neo_x))               # (Nl, D, HC)
    node_rbf = (model.rbf_layer(d_safe) * env).reshape(Nl * D, K)

    def edges_to_src_atoms(x_flat):
        """Edge rows into their source atoms (possibly remote): the
        exchange into the out-table and a sum over its slots."""
        return exchange(x_flat, epb, axis).sum(dim=1)    # (Nl, C)

    def reduce(sums):
        return all_reduce_sum(sums, axis)

    edge_attr = None
    if not v2:
        # the embedding's gradient divides by each element's count over
        # every rank's atoms (:189-207)
        vocab = model.emb_block.embedding.shape[0]
        counts = reduce(F.one_hot(epb.numbers, vocab).sum(0).to(
            torch.float32))
        edge_attr = model._edgenn(model.emb_block(epb.numbers, counts))

    def run_readout(i, x_flat):
        """The model's readout with the edges summed into their source
        atoms by the exchange; molecule-wise, its pooled sums all-reduced
        (:404-416): (Nl, 1) per atom, or (G, 1) per molecule."""
        rp = model._layer(f"readout_{i}")
        if cfg.readout == "atomwise":
            return rp(x_flat, node_rbf, None, Nl,
                      aggregate=edges_to_src_atoms)
        return rp(x_flat, node_rbf, None, epb.atom_gid, Nl, G, node_mask=nm,
                  aggregate=edges_to_src_atoms, total=reduce)

    def conv(i, x_flat, e_atom, mask):
        cp = model._layer(f"conv_{i}")
        x_blk = x_flat.reshape(Nl, D, HC)
        x_src = x_blk * cp.lin_rbf(node_rbf.reshape(Nl, D, K))
        q = cp.lin_query(x_blk)
        # K, V and the radial factors of the out-slots' edges, whose
        # in-slots may lie on other ranks: one exchange (:440-452)
        kvr = torch.cat([cp.lin_key(x_src).reshape(-1, HC),
                         cp.lin_value(x_src).reshape(-1, HC), rbf_env], -1)
        got = exchange(kvr, epb, axis)                   # (Nl, D, 2HC+LK)
        out = blocked_attention(
            q.contiguous(), got[..., :HC].contiguous(),
            got[..., HC:2 * HC].contiguous(),
            cp.lin_edge(e_atom).contiguous(),
            got[..., 2 * HC:].contiguous(), cp.lin_sbf.kernel,
            cp.lin_sbf.bias, z, a_ids, b_ids, heads=H, num_radial=K,
            dropout_mask=mask)
        return cp.skip(out, x_blk).reshape(Nl * D, HC)

    drop = generator is not None and cfg.dropout > 0
    out = neo_x.reshape(Nl * D, HC)
    results = run_readout(0, out)
    for i in range(cfg.conv_layers):
        res0 = out
        if v2:
            edge_attr = model._edgenn(edges_to_src_atoms(out), f"_{i}")
        mask = None if dropout_masks is None else dropout_masks[i]
        if drop and mask is None:
            # drawn before a checkpointed conv, whose recompute must not
            # draw again
            mask = attention_ops.pair_dropout_mask(
                generator, cfg.dropout, Nl, D, H, out.device)
        if cfg.remat:
            # the recompute runs the exchange again (:500-505)
            out = torch.utils.checkpoint.checkpoint(
                conv, i, out, edge_attr, mask, use_reentrant=False)
        else:
            out = conv(i, out, edge_attr, mask)
        # the graph norm's sums all-reduced: a molecule's rows may lie on
        # several ranks (:220-235)
        out = model._layer(f"norm_{i}")(out, gid_flat, G, mask=mask_flat,
                                        total=reduce)
        out = model._layer(f"bf_skip_{i}")(out)
        out = F.silu(model._layer(f"dense_bf_skip_{i}")(out))
        out = out + res0
        out = model._layer(f"af_skip_{i}_0")(out)
        out = model._layer(f"af_skip_{i}_1")(out)
        results = results + run_readout(i + 1, out)

    if cfg.readout == "atomwise":
        results = reduce(segment_sum(results, epb.atom_gid, G,
                                     mask=nm))           # (G, 1)
    if v2:
        results = results / cfg.conv_layers
    return results.reshape(-1)


def make_ep_forward(mesh: Mesh,
                    kv_exchange: str = "allgather") -> Callable:
    """fn(model, epb, generator=None, dropout_masks=None) -> (G,)
    predictions of a batch whose atoms are split over the mesh's 'data'
    axis, `epb` this rank's piece (:541-571). The model carries its
    config, so none is passed; a dropout forward takes a generator, not a
    separate function. The reference's `num_atoms_global` fixes its
    traced shapes; here each rank's piece has its own shape, and
    `make_ep_batch` pads every batch's atom axis to a multiple of the EP
    size, so there is no budget to pass."""
    axis = _Axis.of(mesh, kv_exchange)

    def fwd(model, epb: EPBatch, generator=None, dropout_masks=None):
        return ep_forward(model, epb, axis, generator, dropout_masks)

    return fwd


def make_ep_train_step(model, optimizer, ema_decay: float, mesh: Mesh,
                       kv_exchange: str = "allgather",
                       rng_seed: int = 0) -> Callable:
    """step(state, epb, step=None) -> (state, loss, real graphs): forward
    and backward through the split model, then one weighted all-reduce of
    the gradients over every rank of the mesh (module docstring) and the
    update with the non-finite skip (:574-604). With dropout the masks
    come from `dropout_generator(rng_seed, step, rank)` of this rank. A
    mesh with a 'dp' axis (`hybrid.make_hybrid_mesh`) is DP x EP: the
    loss is the mean over every group's real molecules."""
    _check_model(model.config)
    fwd = make_ep_forward(mesh, kv_exchange)
    leaves = list(model.parameters())
    ep = mesh.axis_size(AXIS)
    dropout = model.config.dropout > 0

    def step(state, epb: EPBatch, step: Optional[int] = None):
        generator = None
        if dropout:
            if step is None:
                step = int(state.step)
            generator = dropout_generator(rng_seed, step, epb.y.device,
                                          mesh.rank)
        pred = fwd(model, epb, generator)
        loss = smooth_l1_loss(pred, epb.y, mask=epb.graph_mask)
        state, loss, total = reduce_and_update(
            state, loss, leaves, epb.graph_mask.sum(), optimizer, ema_decay)
        return state, loss, total / ep

    return step


class _Bound(torch.nn.Module):
    """`fn(model, ...)` as a module holding `model`, so that
    torch.func.functional_call can run it on other parameters (the EMA)."""

    def __init__(self, model, fn):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def make_ep_eval_step(model, mesh: Mesh, std: float = 1.0,
                      kv_exchange: str = "allgather") -> Callable:
    """fn(ema_params, epb) -> (sum of |err|·std, real graphs) of the split
    batch, summed over the 'dp' axis if the mesh has one (the reference
    Trainer's `_ep_eval`, trainer.py:212-217; hybrid.py:163-176);
    `ema_params` maps parameter names to tensors."""
    bound = _Bound(model, make_ep_forward(mesh, kv_exchange))
    dp_group = mesh.group("dp") if "dp" in mesh.axis_names else None

    def evaluate(ema_params: dict, epb: EPBatch):
        with torch.no_grad():
            pred = torch.func.functional_call(
                bound, {f"model.{k}": v for k, v in ema_params.items()},
                (epb,))
            buf = torch.stack([masked_mae(pred, epb.y,
                                          mask=epb.graph_mask) * std,
                               epb.graph_mask.sum().to(torch.float32)])
        if dp_group is not None:
            dist.all_reduce(buf, group=dp_group)
        return buf[0], buf[1]

    return evaluate
