"""The port's segment and padded layouts against the JAX package on the
CPU: batches padded with triplets (bitwise), the per-triplet basis, the
segment primitives, both flat attentions and their gradients, the flat
conv, the whole model in each flat layout x {v1, v2} x {beta off, on} x
{atomwise, molwise_mean}, the three layouts against each other on the
port, a two-epoch packed Trainer run in the segment layout, serving and
evaluating a run in every layout, and the parameter maps of v2 and the
beta gate."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import x2gnn_tpu.nn.conv as jconv_mod
from test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.config import TrainConfig as JaxTrainConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.nn.conv import EdgeAttentionConv as JaxEdgeAttentionConv
from x2gnn_tpu.ops import attention as jattention
from x2gnn_tpu.ops import basis as jbasis
from x2gnn_tpu.ops import segment as jsegment
from x2gnn_tpu.train.loss import smooth_l1_loss as jsmooth_l1_loss
from x2gnn_tpu.train.trainer import Trainer as JaxTrainer
from x2gnn_tpu.utils import torch_ckpt as jtorch_ckpt
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.data.batching import (
    STATIC_FIELDS, pad_budget_for, pad_graphs)
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.nn.conv import EdgeAttentionConv
from x2gnn_tpu_torch.ops import attention, basis, segment
from x2gnn_tpu_torch.train.loss import smooth_l1_loss
from x2gnn_tpu_torch.train.trainer import Trainer
from x2gnn_tpu_torch.utils import torch_ckpt
from x2gnn_tpu_torch.weights import export_flax_params, load_flax_params

# small widths; embedding_size != in_channels, so a v2 lin_edge of the
# embedding's width would not load
FLAT = dict(conv_layers=2, in_channels=32, embedding_size=16, heads=4,
            sbf_dim=7, rbf_dim=6, edge_feat_dim=8)


def _graphs(n, seed):
    return synthetic_dataset(n, mean_atoms=7, seed=seed, edge_feat_dim=8,
                             target="random")


def _set():
    """24 small molecules whose batch-8 budgets plan tiers and a split."""
    return _graphs(24, seed=23)


def _flax_tree(module):
    """The flax parameter tree of a port module's weights (its
    export_flax_params paths nested), so that the JAX side needs no init
    of its own."""
    tree = {}
    for path, value in export_flax_params(module).items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return {"params": tree}


def _batches(graphs, bud):
    """The same molecules padded with triplets by both packages."""
    return (pad_graphs(graphs, bud, with_triplets=True),
            jbatching.pad_graphs(graphs, jbatching.Budgets(*bud),
                                 with_triplets=True))


# ---- batches ----------------------------------------------------------------

@pytest.mark.parametrize("variant", ["tiers+split", "tiers", "split",
                                     "neither"])
def test_pad_graphs_with_triplets_matches_reference(variant):
    """Every field bitwise, the triplets' atoms relabelled by the degree
    sort as the reference relabels them (batching.py:398-401)."""
    graphs = _set()
    bud = pad_budget_for(graphs, 8)
    bud = {"tiers+split": bud,
           "tiers": bud._replace(n_deg_lo=0, n_hi=0),
           "split": bud._replace(tiers=()),
           "neither": bud._replace(n_deg_lo=0, n_hi=0, tiers=())}[variant]
    targets = np.random.default_rng(31).normal(size=7).astype(np.float32)
    chunk = graphs[5:12]
    got = pad_graphs(chunk, bud, n_graph=9, targets=targets,
                     with_triplets=True)
    ref = jbatching.pad_graphs(chunk, jbatching.Budgets(*bud), n_graph=9,
                               targets=targets, with_triplets=True)
    for f in dataclasses.fields(got):
        x, y = getattr(got, f.name), getattr(ref, f.name)
        if f.name in STATIC_FIELDS or x is None:
            assert x == y, f.name
            continue
        y = np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)
    t0 = int(got.trip_mask.sum())
    assert t0 == sum(g.num_triplets for g in chunk) > 0
    # the media atom is the destination edge's head and the source edge's
    # tail, in the relabelled atoms
    np.testing.assert_array_equal(got.trip_j[:t0],
                                  got.edge_dst[got.trip_dst_edge[:t0]])
    np.testing.assert_array_equal(got.trip_j[:t0],
                                  got.edge_src[got.trip_src_edge[:t0]])
    if variant != "neither":
        assert not np.array_equal(got.numbers[:8], np.concatenate(
            [g.numbers for g in chunk])[:8])


def test_pad_graphs_refuses_a_degree_budget_below_the_triplets():
    graphs = _set()[:8]
    bud = pad_budget_for(graphs, 8)
    deg = max(int(np.bincount(g.triplet_index[1]).max()) for g in graphs)
    with pytest.raises(ValueError, match="max triplets/edge"):
        pad_graphs(graphs, bud._replace(n_deg=deg - 1, tiers=(),
                                        n_hi=0, n_deg_lo=0),
                   with_triplets=True)


# ---- basis and segment primitives -------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_sbf_2d_matches_reference(masked):
    rng = np.random.default_rng(3)
    d = rng.uniform(0.8, 4.9, size=40).astype(np.float32)
    theta = rng.uniform(0.0, np.pi, size=90).astype(np.float32)
    src = rng.integers(0, 40, size=90)
    mask = np.arange(40) % 7 != 0 if masked else None
    ref = np.asarray(jbasis.sbf_2d(
        jnp.asarray(d), jnp.asarray(theta), jnp.asarray(src), 7, 6, 5.0, 5,
        None if mask is None else jnp.asarray(mask)))
    got = basis.sbf_2d(torch.from_numpy(d), torch.from_numpy(theta),
                       torch.from_numpy(src), 7, 6, 5.0, 5,
                       None if mask is None else torch.from_numpy(mask))
    assert got.shape == (90, 42) and got.dtype == torch.float32
    # test_sbf_radial_part's tolerance (the Bessel recurrence's 1-ulp
    # sin/cos differences), relative to the basis' scale
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


def _segments(seed, rows=60, segments=9, features=(3,)):
    """Unsorted ids with an id past the last segment, an empty segment
    (4), a fully masked one (6) and masked rows elsewhere."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, segments, size=rows)
    ids[ids == 4] = 5
    ids[3] = segments + 2
    mask = rng.random(rows) > 0.2
    mask[ids == 6] = False
    data = rng.normal(size=(rows,) + features).astype(np.float32) * 3
    return data, ids, mask, segments


def _table(ids, mask, S):
    """The SegmentTable of (ids, mask), its width the largest segment."""
    keep = mask & (ids < S)
    width = int(np.bincount(ids[keep], minlength=S).max())
    return segment.segment_table(torch.from_numpy(ids), S,
                                 torch.from_numpy(mask), width=width)


@pytest.mark.parametrize("with_mask", [False, True])
def test_segment_max_matches_reference(with_mask):
    data, ids, mask, S = _segments(5)
    m = mask if with_mask else None
    ref = np.asarray(jsegment.segment_max(
        jnp.asarray(data), jnp.asarray(ids), S,
        None if m is None else jnp.asarray(m)))
    got = segment.segment_max(torch.from_numpy(data), torch.from_numpy(ids),
                              S, None if m is None else torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.isneginf(ref[4]).all()          # an empty segment
    if with_mask:
        assert (ref[6] == -1e30).all()        # a fully masked one


@pytest.mark.parametrize("features", [(), (4,)])
def test_segment_softmax_matches_reference(features):
    """Values, and the gradient of a weighted sum of them, with an empty
    and a fully masked segment (zeros, not NaN), through the segments'
    table."""
    data, ids, mask, S = _segments(7, features=features)
    w = np.random.default_rng(8).normal(size=data.shape).astype(np.float32)

    def jfn(x):
        return (jsegment.segment_softmax(x, jnp.asarray(ids), S,
                                         jnp.asarray(mask)) * w).sum()

    ref = np.asarray(jsegment.segment_softmax(
        jnp.asarray(data), jnp.asarray(ids), S, jnp.asarray(mask)))
    jgrad = np.asarray(jax.grad(jfn)(jnp.asarray(data)))
    table = _table(ids, mask, S)
    x = torch.from_numpy(data).requires_grad_()
    got = segment.segment_softmax(x, table)
    (g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(g.numpy(), jgrad, rtol=1e-5,
                               atol=1e-6 * np.abs(jgrad).max())
    assert (ref[~mask] == 0).all() and np.isfinite(ref).all()


def test_table_sum_and_gather_rows_are_each_others_backward():
    """table_sum equals jax.ops.segment_sum; gather_rows' backward is the
    segment sum of the cotangent, table_sum's the gather of it."""
    data, ids, mask, S = _segments(9, features=(2,))
    seg = _table(ids, mask, S)
    x = torch.from_numpy(data).requires_grad_()
    total = segment.table_sum(x, seg)
    ref = np.asarray(jsegment.segment_sum(jnp.asarray(data),
                                          jnp.asarray(ids), S,
                                          jnp.asarray(mask)))
    np.testing.assert_allclose(total.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-6)
    up = torch.randn(S, 2, generator=torch.Generator().manual_seed(0))
    (g,) = torch.autograd.grad((total * up).sum(), x)
    keep = mask & (ids < S)        # row 3's id is past the last segment
    want = np.where(keep[:, None], up.numpy()[np.where(keep, ids, 0)], 0)
    np.testing.assert_array_equal(g.numpy(), want)
    y = torch.from_numpy(ref.copy()).requires_grad_()
    rows = segment.gather_rows(y, seg)
    (gy,) = torch.autograd.grad((rows * x.detach()).sum(), y)
    np.testing.assert_allclose(gy.numpy(), ref, rtol=1e-6, atol=1e-6)


# ---- the flat attentions -----------------------------------------------------

def _attention_problem(seed, H=4, C=8):
    graphs = _set()[:6]
    pb, jb = _batches(graphs, pad_budget_for(graphs, 6))
    E, T = pb.edge_mask.shape[0], pb.trip_mask.shape[0]
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(n, H, C)).astype(np.float32)
              for n in (E, E, E, T, T)]
    return pb, jb, arrays


def _tables(b):
    """The batch's triplet_tables, as the flat model builds them."""
    return attention.triplet_tables(
        b.trip_src_edge, b.trip_dst_edge, b.trip_mask, b.nbr_trip,
        b.nbr_mask, b.nbr_src, b.edge_mask.shape[0])


def _flat_attention(layout, fn_args, drop=None):
    """(values, grads of a weighted sum wrt q, k, v, e, s) in both
    packages; `drop` (E, D, H) or (T, H) keep values."""
    pb, jb, arrays = fn_args
    w = np.random.default_rng(2).normal(
        size=(pb.edge_mask.shape[0],) + arrays[0].shape[1:]).astype(
            np.float32)

    def jfn(*xs):
        if layout == "padded":
            out = jattention.padded_attention(
                *xs, jnp.asarray(jb.nbr_trip), jnp.asarray(jb.nbr_src),
                jnp.asarray(jb.nbr_mask),
                dropout_mask=None if drop is None else jnp.asarray(drop))
        else:
            out = jattention.segment_attention(
                *xs, jnp.asarray(jb.trip_src_edge),
                jnp.asarray(jb.trip_dst_edge), jnp.asarray(jb.trip_mask),
                jb.edge_mask.shape[0])
        return (out * w).sum(), out

    (_, ref), jgrads = jax.value_and_grad(jfn, argnums=tuple(range(5)),
                                          has_aux=True)(
        *[jnp.asarray(a) for a in arrays])
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    fn = (attention.padded_attention if layout == "padded"
          else attention.segment_attention)
    out = fn(*xs, _tables(pb.to("cpu")),
             dropout_mask=None if drop is None else torch.from_numpy(drop))
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), xs)
    return ((out.detach().numpy(), [g.numpy() for g in grads]),
            (np.asarray(ref), [np.asarray(g) for g in jgrads]))


@pytest.mark.parametrize("layout", ["segment", "padded"])
def test_flat_attention_matches_reference(layout):
    (got, grads), (ref, jgrads) = _flat_attention(layout,
                                                  _attention_problem(4))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    for name, g, r in zip("qkves", grads, jgrads):
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max(),
                                   err_msg=name)


def test_padded_attention_with_a_dropout_mask_matches_reference():
    problem = _attention_problem(6)
    pb = problem[0]
    drop = (np.random.default_rng(12).random(
        pb.nbr_trip.shape + (4,)) > 0.3).astype(np.float32) / 0.7
    (got, grads), (ref, jgrads) = _flat_attention("padded", problem, drop)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    for g, r in zip(grads, jgrads):
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max())


def test_flat_attentions_agree_with_each_other():
    """The segment and padded attentions on the same inputs, under one
    per-triplet dropout mask laid out per slot for the padded one."""
    pb, _, arrays = _attention_problem(10)
    b = pb.to("cpu")
    xs = [torch.from_numpy(a) for a in arrays]
    keep = torch.from_numpy((np.random.default_rng(3).random(
        (b.trip_mask.shape[0], 4)) > 0.2).astype(np.float32) / 0.8)
    tables = _tables(b)
    seg = attention.segment_attention(*xs, tables, dropout_mask=keep)
    pad = attention.padded_attention(*xs, tables,
                                     dropout_mask=keep[b.nbr_trip])
    np.testing.assert_allclose(pad.numpy(), seg.numpy(), rtol=1e-5,
                               atol=1e-6 * float(seg.abs().max()))


# ---- the flat conv -----------------------------------------------------------

def _conv_problem(seed):
    graphs = _set()[:6]
    pb, jb = _batches(graphs, pad_budget_for(graphs, 6))
    E, T = pb.edge_mask.shape[0], pb.trip_mask.shape[0]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(E, 32)).astype(np.float32)
    rbf = rng.normal(size=(E, 6)).astype(np.float32)
    sbf = rng.normal(size=(T, 42)).astype(np.float32)
    edge_attr = rng.normal(size=(T, 16)).astype(np.float32)
    return pb, jb, (x, rbf, sbf, edge_attr)


@pytest.mark.parametrize("layout,beta,dropout", [
    ("segment", False, False), ("segment", True, False),
    ("segment", True, True), ("padded", False, False),
    ("padded", True, False), ("padded", False, True)])
def test_edge_attention_conv_matches_reference(layout, beta, dropout,
                                               monkeypatch):
    """The port's EdgeAttentionConv with the JAX conv's parameters, values
    and parameter gradients; with dropout both under one explicit
    pair-space mask (the JAX conv's draw replaced by it)."""
    pb, jb, inputs = _conv_problem(11)
    N, D = pb.in_edges.shape
    rate = 0.3 if dropout else 0.0
    mask = (np.random.default_rng(5).random((N, D, D, 4)) > rate).astype(
        np.float32) / (1.0 - rate)
    monkeypatch.setattr(jconv_mod, "pair_dropout_mask",
                        lambda *a: jnp.asarray(mask))
    jconv = JaxEdgeAttentionConv(32, 4, rate, layout=layout, use_beta=beta)
    pair_pos = np.asarray(jattention.triplet_pair_positions(
        jb.trip_dst_edge, jb.trip_src_edge, jb.edge_inpos, jb.edge_outpos,
        D))
    jargs = [jnp.asarray(a) for a in inputs] + [
        jnp.asarray(jb.trip_src_edge), jnp.asarray(jb.trip_dst_edge)]
    jkw = dict(trip_mask=jnp.asarray(jb.trip_mask),
               nbr_trip=jnp.asarray(jb.nbr_trip),
               nbr_src=jnp.asarray(jb.nbr_src),
               nbr_mask=jnp.asarray(jb.nbr_mask),
               deterministic=not dropout, drop_pair_pos=pair_pos,
               drop_space=(N, D))
    conv = EdgeAttentionConv(32, 4, layout=layout, sbf_l=7, sbf_k=6,
                             rbf_dim=6, emb_dim=16, dropout=rate,
                             use_beta=beta,
                             generator=torch.Generator().manual_seed(0))
    params = _flax_tree(conv)
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(jax.eval_shape(
            lambda: jconv.init({"params": jax.random.PRNGKey(0),
                                "dropout": jax.random.PRNGKey(1)},
                               *jargs, **jkw)))
    w = np.random.default_rng(6).normal(size=(pb.edge_mask.shape[0], 32))

    def jloss(p):
        out = jconv.apply(p, *jargs, **jkw,
                          rngs={"dropout": jax.random.PRNGKey(1)})
        return (out * w).sum(), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    b = pb.to("cpu")
    tables = _tables(b)
    out = conv(*[torch.from_numpy(a) for a in inputs], tables,
               dropout_mask=torch.from_numpy(mask) if dropout else None,
               drop_pair_pos=torch.from_numpy(pair_pos).long())
    names = [n for n, _ in conv.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(w).float()).sum(),
                                list(conv.parameters()))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    got = export_flax_params(conv, dict(zip(names, grads)))
    want = export_params_flat(jgrads)
    assert got.keys() == want.keys()
    assert ("lin_beta/Dense_0/kernel" in got) == beta
    for path, r in want.items():
        if path.endswith("lin_key/Dense_0/bias"):
            continue      # ~0 in both: the softmax ignores a key shift
        np.testing.assert_allclose(got[path], r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg=path)


def test_segment_conv_returns_the_attention_weights():
    """(T, H) weights in the segment layout, summing to 1 over each real
    edge's triplets; the padded layout refuses them, as the reference."""
    pb, _, inputs = _conv_problem(13)
    b = pb.to("cpu")
    tables = _tables(b)
    args = [torch.from_numpy(a) for a in inputs] + [tables]
    conv = EdgeAttentionConv(32, 4, emb_dim=16,
                             generator=torch.Generator().manual_seed(0))
    out, weights = conv(*args, return_attention_weights=True)
    assert weights.shape == (b.trip_mask.shape[0], 4)
    sums = segment.table_sum(weights.detach(), tables.dst)
    has = b.nbr_mask.any(1)
    np.testing.assert_allclose(sums[has].numpy(), 1.0, rtol=1e-5)
    assert (weights[~b.trip_mask] == 0).all()
    torch.testing.assert_close(out, conv(*args), rtol=0, atol=0)
    padded = EdgeAttentionConv(32, 4, layout="padded", emb_dim=16)
    with pytest.raises(ValueError, match="segment layout"):
        padded(*args, return_attention_weights=True)


# ---- the whole model -------------------------------------------------------

def _model_cfgs(layout, variant, beta, readout):
    kw = dict(FLAT, attention_layout=layout, variant=variant, beta=beta,
              readout=readout)
    return JaxModelConfig(use_pallas=True, **kw), ModelConfig(**kw)


def _grads_of(model, batch, **kw):
    names = [n for n, _ in model.named_parameters()]
    loss = smooth_l1_loss(model(batch, **kw), batch.y,
                          mask=batch.graph_mask)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                materialize_grads=True)
    return loss.item(), export_flax_params(model, dict(zip(names, grads)))


def _assert_grads(got, want, label=""):
    assert got.keys() == want.keys()
    top = max(float(np.abs(r).max()) for r in want.values())
    for path, ref in want.items():
        ref = np.asarray(ref, np.float32)
        if path.endswith("lin_key/Dense_0/bias"):
            assert np.abs(got[path]).max() < 1e-6 * top, path
            continue
        np.testing.assert_allclose(got[path], ref, rtol=1e-3,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=f"{label} {path}")


@pytest.mark.parametrize("layout,variant,beta,readout", [
    ("segment", "v1", False, "atomwise"),
    ("segment", "v1", True, "molwise_mean"),
    ("segment", "v2", False, "molwise_mean"),
    ("segment", "v2", True, "atomwise"),
    ("padded", "v1", False, "molwise_mean"),
    ("padded", "v1", True, "atomwise"),
    ("padded", "v2", False, "atomwise"),
    ("padded", "v2", True, "molwise_mean")])
def test_flat_model_matches_reference(layout, variant, beta, readout):
    """Predictions at rtol 1e-4 and every parameter's gradient of the
    smooth-L1 loss at the standing gates, on a degree-sorted batch: every
    flat layout x variant x beta, and each layout x variant with both
    readouts."""
    graphs = _set()[:8]
    pb, jb = _batches(graphs, pad_budget_for(graphs, 8))
    jcfg, cfg = _model_cfgs(layout, variant, beta, readout)
    jmodel = JaxX2GNN(jcfg)
    model = X2GNN(cfg, torch.Generator().manual_seed(2), device="cpu")
    params = _flax_tree(model)

    def jloss(p):
        pred = jmodel.apply(p, jb)
        return jsmooth_l1_loss(pred, jb.y, mask=jb.graph_mask), pred

    (jl, ref), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    b = pb.to("cpu")
    with torch.no_grad():
        got = model(b).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(ref)).max())
    loss, grads = _grads_of(model, b)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    _assert_grads(grads, export_params_flat(jg))
    if variant == "v2":
        assert "edgenn_1_1/Dense_0/kernel" in grads
        assert grads["conv_0/lin_edge/Dense_0/kernel"].shape == (32, 32)
        assert not np.abs(grads["emb_block/embedding"]).any()


@pytest.mark.parametrize("layout", ["segment", "padded"])
def test_flat_bf16_model_matches_reference(layout):
    """compute_dtype bfloat16 in the flat layouts against JAX's bf16
    model: predictions and the loss within tests/test_torch_port_bf16.py's
    1e-2 (measured 1.3e-03 / 5.0e-03 of max|pred|). Here the attention
    itself runs in bf16 on both sides (the reference's flat conv computes
    it in its dtype), which moves each side's gradients 3-5% of a leaf's
    max|g| from the float32 model's (measured: the port 5.3e-02 / 3.1e-02,
    JAX 4.4e-02 / 3.7e-02, segment / padded) and the two sides up to
    6.7e-02 apart (XLA adds bf16 scatters in bf16, torch accumulates bf16
    sums in float32): each leaf is held within 1e-1 of its max|g|, and the
    port's worst distance from the float32 model within twice JAX's."""
    graphs = _set()[:8]
    pb, jb = _batches(graphs, pad_budget_for(graphs, 8))
    jcfg, cfg = _model_cfgs(layout, "v1", False, "atomwise")
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    model = X2GNN(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                  torch.Generator().manual_seed(2), device="cpu")
    f32 = X2GNN(cfg, device="cpu")
    f32.load_state_dict(model.state_dict())

    def jloss(p):
        pred = JaxX2GNN(jcfg).apply(p, jb)
        return jsmooth_l1_loss(pred, jb.y, mask=jb.graph_mask), pred

    (jl, ref), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        _flax_tree(model))
    ref = np.asarray(ref)
    b = pb.to("cpu")
    with torch.no_grad():
        got = model(b).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
    loss, grads = _grads_of(model, b)
    assert abs(loss - float(jl)) <= 1e-2 * abs(float(jl))
    _, g32 = _grads_of(f32, b)
    want = export_params_flat(jg)
    top = max(float(np.abs(r).max()) for r in want.values())
    worst = {"port": 0.0, "jax": 0.0}
    for path, r in want.items():
        r = np.asarray(r, np.float32)
        if path.endswith("lin_key/Dense_0/bias"):
            assert np.abs(grads[path]).max() < 1e-3 * top, path
            continue
        scale = np.abs(r).max()
        assert np.abs(grads[path] - r).max() <= 1e-1 * scale, path
        ref32 = np.abs(g32[path]).max()
        worst["port"] = max(worst["port"],
                            np.abs(grads[path] - g32[path]).max() / ref32)
        worst["jax"] = max(worst["jax"], np.abs(r - g32[path]).max() / ref32)
    assert worst["port"] <= 2 * worst["jax"], worst


@pytest.mark.parametrize("variant,beta,dtype", [
    ("v1", False, "float32"), ("v2", True, "float32"),
    ("v1", True, "bfloat16")])
def test_three_layouts_agree_on_the_port(variant, beta, dtype):
    """One set of weights in the blocked, segment and padded models, on
    one degree-sorted batch with tiers: predictions within
    tests/test_model_v2.py's 5e-4 / 5e-5 (bf16: 1e-2 of the largest, the
    bf16 gate), and the same under one explicit dropout mask per conv;
    the float32 gradients at the standing gates, blocked against
    segment."""
    graphs = _set()[8:16]
    batch = pad_graphs(graphs, pad_budget_for(_set(), 8),
                       with_triplets=True).to("cpu")
    assert batch.tiers
    base = ModelConfig(**FLAT, variant=variant, beta=beta,
                       compute_dtype=dtype, dropout=0.1)
    models = {}
    for layout in ("blocked", "segment", "padded"):
        models[layout] = X2GNN(
            dataclasses.replace(base, attention_layout=layout),
            torch.Generator().manual_seed(3), device="cpu")
    N, D = batch.in_edges.shape
    g = torch.Generator().manual_seed(9)
    masks = [attention.pair_dropout_mask(g, 0.1, N, D, 4)
             for _ in range(2)]
    rtol, atol = (5e-4, 5e-5) if dtype == "float32" else (0.0, 1e-2)
    for kw in ({}, dict(deterministic=False, dropout_masks=masks)):
        with torch.no_grad():
            preds = {k: m(batch, **kw).numpy() for k, m in models.items()}
        scale = np.abs(preds["segment"]).max()
        for layout in ("blocked", "padded"):
            np.testing.assert_allclose(
                preds[layout], preds["segment"], rtol=rtol,
                atol=atol * (scale if dtype != "float32" else 1.0),
                err_msg=f"{layout} {kw.keys()}")
    if dtype == "float32":
        _, g_seg = _grads_of(models["segment"], batch)
        _, g_blk = _grads_of(models["blocked"], batch)
        _assert_grads(g_blk, g_seg)


def test_flat_layouts_match_the_reference_under_dropout(monkeypatch):
    """The JAX model's segment and padded layouts draw one pair-space
    mask per conv; with those draws replaced by given masks, the port
    under the same masks gives its predictions."""
    graphs = _set()[:8]
    pb, jb = _batches(graphs, pad_budget_for(graphs, 8))
    N, D = pb.in_edges.shape
    g = torch.Generator().manual_seed(8)
    masks = [attention.pair_dropout_mask(g, 0.2, N, D, 4) for _ in range(2)]
    for layout in ("segment", "padded"):
        jcfg, cfg = _model_cfgs(layout, "v1", False, "atomwise")
        jcfg = dataclasses.replace(jcfg, dropout=0.2)
        model = X2GNN(dataclasses.replace(cfg, dropout=0.2),
                      torch.Generator().manual_seed(4), device="cpu")
        drawn = iter(masks)
        monkeypatch.setattr(jconv_mod, "pair_dropout_mask",
                            lambda *a: jnp.asarray(next(drawn).numpy()))
        ref = np.asarray(jax.jit(lambda p: JaxX2GNN(jcfg).apply(
            p, jb, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(7)}))(_flax_tree(model)))
        with torch.no_grad():
            got = model(pb.to("cpu"), deterministic=False,
                        dropout_masks=masks).numpy()
            plain = model(pb.to("cpu")).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=layout)
        assert not np.allclose(got, plain, rtol=1e-3)


@pytest.mark.parametrize("layout", ["segment", "padded"])
def test_flat_remat_and_feature_dtypes(layout):
    """remat gives the same gradients bit for bit (the checkpoint's
    recompute draws no mask of its own); int8 features with their scales
    give the predictions of their dequantized float32 values."""
    from x2gnn_tpu_torch.train.trainer import cast_feat
    graphs = _set()[:8]
    host = pad_graphs(graphs, pad_budget_for(graphs, 8), with_triplets=True)
    batch = host.to("cpu")
    cfg = ModelConfig(**FLAT, attention_layout=layout, dropout=0.2)
    outs = []
    for remat in (False, True):
        model = X2GNN(dataclasses.replace(cfg, remat=remat),
                      torch.Generator().manual_seed(5), device="cpu")
        outs.append(_grads_of(model, batch, deterministic=False,
                              generator=torch.Generator().manual_seed(2)))
    assert outs[0][0] == outs[1][0]
    for path, g in outs[0][1].items():
        np.testing.assert_array_equal(outs[1][1][path], g, err_msg=path)
    q = cast_feat(host, "int8")
    deq = dataclasses.replace(host, edge_feat=(
        q.edge_feat.astype(np.float32) * q.edge_feat_scale[:, None]))
    with torch.no_grad():
        got = model(q.to("cpu")).numpy()
        ref = model(deq.to("cpu")).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


# ---- training, serving, evaluating ------------------------------------------

@pytest.fixture(scope="module")
def segment_runs(tmp_path_factory):
    """Two epochs of pack_mixed training in the segment layout in both
    packages, from the same weights and budgets."""
    mktemp = tmp_path_factory.mktemp
    graphs = _set()
    targets = np.array([g.y[0] for g in graphs], np.float32)
    bud = pad_budget_for(graphs, 8)
    kw = dict(batch_size=8, max_epoch=2, scheduler="plateau",
              ckpt_after_epoch=100, max_lr=1e-3, pack_mixed=True)
    jcfg, cfg = _model_cfgs("segment", "v1", False, "atomwise")
    jt = JaxTrainer(JaxX2GNN(jcfg), jcfg, JaxTrainConfig(**kw), graphs,
                    targets, workdir=str(mktemp("jax")),
                    budgets=jbatching.Budgets(*bud))
    jstate0 = jt.init_state()
    flat0 = export_params_flat(jstate0.params)
    jt.init_state = lambda: jax.tree_util.tree_map(jnp.copy, jstate0)
    jt.fit(epochs=2)
    jrecords = [json.loads(line) for line in
                open(f"{jt.workdir}/metrics.jsonl")]
    model = X2GNN(cfg, device="cpu")
    load_flax_params(model, flat0)
    pt = Trainer(model, cfg, TrainConfig(**kw), graphs, targets,
                 workdir=str(mktemp("port")), budgets=bud, device="cpu")
    pt.fit(epochs=2)
    precords = [json.loads(line) for line in
                open(f"{pt.workdir}/metrics.jsonl")]
    return jrecords, precords, pt


def test_segment_trainer_two_epochs_match_reference(segment_runs):
    jrec, prec, pt = segment_runs
    batches = pt.batches(pt.train_idx)
    assert len(batches) > 1
    assert all(b.trip_mask.shape[0] > 0
               and b.nbr_trip.shape[0] == b.edge_mask.shape[0]
               for b in batches)
    assert len(jrec) == len(prec) == 2
    for j, p in zip(jrec, prec):
        for key in ("loss", "val_mae", "best_val_mae"):
            np.testing.assert_allclose(p[key], j[key], rtol=1e-3,
                                       err_msg=key)
        for key in ("epoch", "step", "bad_steps", "lr_scale",
                    "occupancy_nodes", "occupancy_edges",
                    "occupancy_triplets", "budget_shapes"):
            assert p[key] == j[key], key


def test_segment_cache_modes_are_bitwise(tmp_path):
    """One packed epoch in the segment layout with the batches cached on
    the device, assembled and streamed, and cached on the host and
    streamed: the triplet arrays travel with every batch, and records and
    parameters are bitwise equal."""
    graphs = _graphs(16, seed=13)
    cfg = ModelConfig(**{**FLAT, "conv_layers": 1},
                      attention_layout="segment")
    tcfg = TrainConfig(batch_size=8, max_epoch=1, ckpt_after_epoch=0,
                       pack_mixed=True)
    runs = {}
    for mode in (True, False, "host"):
        model = X2GNN(cfg, torch.Generator().manual_seed(0), device="cpu")
        tr = Trainer(model, cfg, tcfg, graphs,
                     np.array([g.y[0] for g in graphs], np.float32),
                     workdir=str(tmp_path / str(mode)), device="cpu",
                     cache_batches=mode)
        tr.fit()
        records = [{k: v for k, v in json.loads(line).items()
                    if k != "seconds" and not k.endswith("_per_sec")}
                   for line in open(f"{tr.workdir}/metrics.jsonl")]
        runs[mode] = (records, [p.detach().clone()
                                for p in model.parameters()])
        assert tr.first_batch(tr.train_idx).trip_mask.shape[0] > 0
    for mode in (False, "host"):
        assert runs[mode][0] == runs[True][0], mode
        assert all(torch.equal(a, b) for a, b in zip(runs[mode][1],
                                                     runs[True][1])), mode


def test_a_run_serves_and_evaluates_in_every_layout(tmp_path, capsys):
    """A blocked-trained v2 + beta run (the training CLI) served by
    Predictor.from_run(layout=...) and evaluated with --layout in each
    layout: predictions within 5e-4 / 5e-5, the MAE within 1e-4
    relative."""
    from x2gnn_tpu_torch.evaluate import main as evaluate_main
    from x2gnn_tpu_torch.infer import Predictor
    from x2gnn_tpu_torch.train.__main__ import main
    config = tmp_path / "small.json"
    config.write_text(json.dumps({
        "model": dict(FLAT, variant="v2", beta=True),
        "train": {"batch_size": 8, "max_epoch": 1, "ckpt_after_epoch": 0}}))
    workdir = tmp_path / "run"
    assert main(["--device", "cpu", "--synthetic", "16", "--config",
                 str(config), "--workdir", str(workdir)]) == 0
    graphs = synthetic_dataset(16, edge_feat_dim=8)
    preds = {layout: Predictor.from_run(str(workdir), layout=layout,
                                        device="cpu").predict(graphs)
             for layout in ("blocked", "segment", "padded")}
    for layout in ("segment", "padded"):
        np.testing.assert_allclose(preds[layout], preds["blocked"],
                                   rtol=5e-4, atol=5e-5, err_msg=layout)
    maes = {}
    for layout in ("blocked", "segment", "padded"):
        capsys.readouterr()
        assert evaluate_main(["--ckpt", str(workdir / "ckpt_best.pt"),
                              "--synthetic", "16", "--layout", layout,
                              "--device", "cpu"]) == 0
        maes[layout] = json.loads(capsys.readouterr().out)["mae"]
    for layout in ("segment", "padded"):
        np.testing.assert_allclose(maes[layout], maes["blocked"],
                                   rtol=1e-4)


# ---- parameter maps ----------------------------------------------------------

def test_v2_beta_parameters_round_trip_flax_and_pth():
    """A v2 + beta model's parameters (edgenn_{i}_{j}, lin_beta, no v1
    edgenn) are the JAX model's leaf for leaf, come back bitwise through
    the flax map, and give the JAX package's reference-named .pth state
    dict, which imports back bitwise."""
    graphs = _set()[:4]
    _, jb = _batches(graphs, pad_budget_for(graphs, 4))
    jcfg, cfg = _model_cfgs("segment", "v2", True, "atomwise")
    shapes = export_params_flat(jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, x.dtype),
        jax.eval_shape(JaxX2GNN(jcfg).init, jax.random.PRNGKey(5), jb)))
    assert "edgenn_0" not in {k.split("/")[0] for k in shapes}
    for key in ("edgenn_1_0/Dense_0/kernel",
                "conv_1/lin_beta/Dense_0/kernel"):
        assert key in shapes, key
    model = X2GNN(cfg, torch.Generator().manual_seed(6), device="cpu")
    flat = export_flax_params(model)
    assert {k: v.shape for k, v in flat.items()} == {
        k: tuple(v.shape) for k, v in shapes.items()}
    fresh = X2GNN(cfg, device="cpu")
    load_flax_params(fresh, flat)
    for k, v in export_flax_params(fresh).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    assert model.conv_0.lin_beta.weight.shape == (1, 96)
    sd = torch_ckpt.export_torch_state_dict(model)
    ref = jtorch_ckpt.export_torch_state_dict(_flax_tree(model))
    assert sd.keys() == ref.keys()
    for k in ("fin_model.edgenn.1.2.weight",
              "fin_model.convs.0.lin_beta.weight"):
        assert k in sd, k
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k], np.asarray(v), err_msg=k)
    fresh = X2GNN(cfg, torch.Generator().manual_seed(1), device="cpu")
    report = torch_ckpt.import_torch_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, fresh)
    assert not report["missing"] and not report["unused"]
    for (name, p), q in zip(model.named_parameters(), fresh.parameters()):
        np.testing.assert_array_equal(q.detach().numpy(),
                                      p.detach().numpy(), err_msg=name)
