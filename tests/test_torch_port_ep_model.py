"""The port's edge-partitioned model (x2gnn_tpu_torch/parallel/ep_model.py,
edge_partition.py) on 2 and 4 gloo ranks on the CPU, against the port's
single-process model and the JAX package's EP forward (4 virtual
devices) with the same weights and batches: the counterparts of
tests/test_ep_model.py."""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_model import one_torch_thread  # noqa: F401
from torch_port_ranks import (
    Ranks, ep_attention_op, ep_cases, ep_exchange, ep_steps, jobs,
    trainer_fit)
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.ops import attention as jattention
from x2gnn_tpu.ops.attention import blocked_attention as jblocked_attention
from x2gnn_tpu.parallel import make_mesh as jmake_mesh
from x2gnn_tpu.parallel.edge_partition import (
    make_ep_blocked_attention as jmake_ep_blocked_attention)
from x2gnn_tpu.parallel.ep_model import (
    make_ep_batch as jmake_ep_batch, make_ep_forward as jmake_ep_forward,
    shard_ep_batch as jshard_ep_batch)
from x2gnn_tpu.train import loss as jloss
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import ModelConfig
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.parallel import make_ep_batch
from x2gnn_tpu_torch.parallel.ep_model import _check_model
from x2gnn_tpu_torch.train.loss import smooth_l1_loss
from x2gnn_tpu_torch.train.trainer import cast_feat
from x2gnn_tpu_torch.weights import export_flax_params

CFG = dict(conv_layers=2, in_channels=32, embedding_size=32, heads=4,
           sbf_dim=3, rbf_dim=4, edge_feat_dim=8, attention_layout="blocked")
CASES = {"atomwise": {}, "molwise_mean": {"readout": "molwise_mean"},
         "molwise_add": {"readout": "molwise_add"}, "v2": {"variant": "v2"},
         "beta": {"beta": True}}
WORLDS = (2, 4)
MODES = ("allgather", "ring")
DROP_RATE = 0.3

# The split model against the single-process one: the same float32 math,
# with each graph's sums (norm statistics, pooling, the atom-wise sum)
# added in pieces, one per rank, then across ranks: predictions within
# 1e-5 relative plus 1e-6 of the largest; each parameter's gradient within
# 1e-4 of its own magnitude plus 1e-5 of its largest, as the port holds
# its layouts' gradients against one another.
PRED_RTOL, PRED_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# Against the JAX package (other float32 orders in XLA's einsums and its
# one-hot sums): predictions at the port's model-parity tolerance
# (tests/test_torch_port_model.py), gradients at the training tests'.
JAX_PRED_RTOL, JAX_PRED_ATOL = 2e-5, 2e-6
JAX_GRAD_RTOL, JAX_GRAD_ATOL = 1e-3, 1e-4
# lin_key's bias: its gradient is 0 in exact arithmetic (the softmax
# ignores a shift shared by a query's keys), so both sides hold rounding
# noise of ~1e-9 that does not correlate; they are held to this absolute
# bound instead
NOISE_ATOL = 1e-6


def _graphs(seed=11, n=6):
    return synthetic_dataset(n, mean_atoms=8, seed=seed, edge_feat_dim=8)


def _batch(graphs, extra_atoms=0):
    """The graphs padded to their budgets (degree tiers, unused by the EP
    path, included), or with `extra_atoms` more atoms and no tiers."""
    bud = pad_budget_for(graphs, len(graphs))
    if extra_atoms:
        bud = bud._replace(n_node=bud.n_node + extra_atoms, tiers=(),
                           n_hi=0, n_deg_lo=0)
    return pad_graphs(graphs, bud)


def _flat(cfg_kw):
    return export_flax_params(X2GNN(ModelConfig(**cfg_kw),
                                    torch.Generator().manual_seed(0),
                                    device="cpu"))


def _flax_tree(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(value)
    return {"params": tree}


def _single(cfg_kw, flat, batch, masks=None):
    """The single-process port model: (predictions, loss, gradients by
    flax path)."""
    model = X2GNN(ModelConfig(**cfg_kw), device="cpu")
    from x2gnn_tpu_torch.weights import load_flax_params
    load_flax_params(model, flat)
    tb = batch.to("cpu")
    dm = None if masks is None else [torch.from_numpy(m) for m in masks]
    pred = model(tb, dropout_masks=dm)
    loss = smooth_l1_loss(pred, tb.y, mask=tb.graph_mask)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                materialize_grads=True)
    return (pred.detach().numpy(), float(loss.detach()),
            export_flax_params(model, dict(zip(names, grads))))


def _masks(batch, seed=5):
    N, D = batch.in_edges.shape
    rng = np.random.default_rng(seed)
    keep = 1.0 - DROP_RATE
    return [((rng.uniform(size=(N, D, D, CFG["heads"])) < keep)
             / keep).astype(np.float32) for _ in range(CFG["conv_layers"])]


def _assert_grads(got, want, rtol, atol, what):
    assert set(got) == set(want)
    for path in want:
        w, g = np.asarray(want[path]), np.asarray(got[path])
        scale = np.abs(w).max()
        if path.endswith("lin_key/Dense_0/bias"):
            np.testing.assert_allclose(g, w, atol=NOISE_ATOL,
                                       err_msg=f"{what} {path}")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * scale,
                                       err_msg=f"{what} {path}")


@pytest.fixture(scope="module")
def setup():
    graphs = _graphs()
    batch = _batch(graphs)
    # an atom axis that divides neither 2 nor 4 ranks: make_ep_batch pads
    odd = _batch(graphs, extra_atoms=1)
    assert batch.in_edges.shape[0] % 4 == 0 and odd.in_edges.shape[0] % 2
    cases = []
    for name, kw in CASES.items():
        cfg = {**CFG, **kw}
        cases.append(dict(name=name, cfg=cfg, flat=_flat(cfg), batch=batch,
                          modes=MODES))
    flat = cases[0]["flat"]
    cases += [
        dict(name="remat", cfg={**CFG, "remat": True}, flat=flat,
             batch=batch, modes=MODES),
        dict(name="dropout", cfg={**CFG, "dropout": DROP_RATE}, flat=flat,
             batch=batch, modes=MODES, masks=_masks(batch)),
        dict(name="odd", cfg=CFG, flat=flat, batch=odd, modes=MODES)]
    return graphs, batch, odd, cases


def _train_graphs():
    graphs = _graphs(seed=3, n=16)
    return graphs, np.array([g.y[0] for g in graphs], np.float32)


EP_TCFG = dict(batch_size=4, warmup_steps=4, max_epoch=3,
               ckpt_after_epoch=0)
DROP_TCFG = dict(batch_size=4, warmup_steps=2, ckpt_after_epoch=0)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Everything the ranks compute, one start-up per world size: on 2 and
    4 ranks `ep_cases` (every rank's predictions checked equal to rank
    0's, bit for bit: they are replicated); on 2 ranks also 4 EP steps on
    one batch (ring) and Trainer.fit in EP mode (ring, 3 epochs) and with
    dropout (allgather, 1 epoch); on 4 the row exchange and the
    standalone attention op."""
    graphs, batch, _, cases = setup
    flat = cases[0]["flat"]
    tmp = tmp_path_factory.mktemp("ep")
    train, targets = _train_graphs()
    rng = np.random.default_rng(7)
    n, d = make_ep_batch(batch, 4).in_mask.shape
    x = rng.normal(size=(n * d, 16)).astype(np.float32)
    cot = rng.normal(size=(n * d, 16)).astype(np.float32)
    op_inputs, op_cot = _op_problem(rng)
    calls = {
        2: [(ep_cases, (cases,)),
            (ep_steps, (CFG, flat, batch, dict(batch_size=6,
                                               warmup_steps=2), 4, "ring")),
            (trainer_fit, (CFG, flat, train, targets, EP_TCFG,
                           str(tmp / "ep_run"), "ring", 0, 3)),
            (trainer_fit, ({**CFG, "dropout": 0.3}, flat, train[:8],
                           targets[:8], DROP_TCFG, str(tmp / "ep_drop"),
                           "allgather", 0, 1))],
        4: [(ep_cases, (cases,)), (ep_exchange, (x, cot, batch)),
            (ep_attention_op, ({k: v for k, v in op_inputs.items()
                                if k != "batch"}, op_cot, 4))]}
    started = {w: Ranks(jobs, w, tmp, c) for w, c in calls.items()}
    out = {w: r.wait() for w, r in started.items()}
    for w, res in out.items():
        for r in res[1:]:
            for name in r[0]:
                for mode in MODES:
                    np.testing.assert_array_equal(r[0][name][mode][0],
                                                  res[0][0][name][mode][0])
    return out, tmp, (x, cot, op_inputs, op_cot)


@pytest.fixture(scope="module")
def runs(ranks):
    """{world: rank 0's ep_cases results}."""
    return {w: res[0][0] for w, res in ranks[0].items()}


@pytest.fixture(scope="module")
def single(setup):
    _, batch, odd, cases = setup
    return {c["name"]: _single(c["cfg"], c["flat"], c["batch"],
                               c.get("masks")) for c in cases}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [*CASES, "odd"])
def test_ep_forward_matches_model(runs, single, world, name):
    want = single[name][0]
    for mode in MODES:
        np.testing.assert_allclose(
            runs[world][name][mode][0], want, rtol=PRED_RTOL,
            atol=PRED_ATOL * np.abs(want).max(), err_msg=mode)
        np.testing.assert_allclose(runs[world][name][mode][1],
                                   single[name][1], rtol=PRED_RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_ep_forward_matches_jax_ep(setup, runs, name):
    """JAX make_ep_forward on 4 virtual devices (its XLA branch) with the
    same weights."""
    _, batch, _, cases = setup
    case = next(c for c in cases if c["name"] == name)
    jcfg = JaxModelConfig(**case["cfg"], use_pallas=False)
    jb = jbatching.pad_graphs(_graphs(), jbatching.Budgets(
        *pad_budget_for(_graphs(), 6)), with_triplets=False)
    mesh = jmake_mesh(4)
    epb = jmake_ep_batch(jb, 4)
    ref = np.asarray(jmake_ep_forward(jcfg, mesh, epb.numbers.shape[0])(
        _flax_tree(case["flat"]), jshard_ep_batch(epb, mesh)))
    for mode in MODES:
        np.testing.assert_allclose(runs[4][name][mode][0], ref,
                                   rtol=JAX_PRED_RTOL,
                                   atol=JAX_PRED_ATOL * np.abs(ref).max())


@pytest.mark.parametrize("world", WORLDS)
def test_ring_exchange_is_bitwise_the_allgather(runs, world):
    """Each row comes from its one owner, the others select nothing:
    predictions, loss and every gradient bit for bit."""
    for name, res in runs[world].items():
        ag, ring = res["allgather"], res["ring"]
        np.testing.assert_array_equal(ring[0], ag[0], err_msg=name)
        assert ring[1] == ag[1], name
        for path in ag[2]:
            np.testing.assert_array_equal(ring[2][path], ag[2][path],
                                          err_msg=f"{name} {path}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [*CASES, "odd"])
def test_ep_param_gradients_match_model(runs, single, world, name):
    """The collectives' backwards (the exchange, the norm statistics, the
    frequency counts, the pooling) and the step's division by the EP size
    give the single-process model's gradients (test_ep_model.py:97)."""
    for mode in MODES:
        _assert_grads(runs[world][name][mode][2], single[name][2],
                      GRAD_RTOL, GRAD_ATOL, f"{world} ranks {mode}")


@pytest.mark.parametrize("name", ["atomwise", "molwise_mean", "v2", "beta"])
def test_ep_param_gradients_match_jax(setup, runs, name):
    """Against the JAX model's gradients of the same loss (the JAX EP
    gradients equal them, tests/test_ep_model.py:97)."""
    _, batch, _, cases = setup
    case = next(c for c in cases if c["name"] == name)
    jmodel = JaxX2GNN(JaxModelConfig(**case["cfg"], use_pallas=False))
    jb = jbatching.pad_graphs(_graphs(), jbatching.Budgets(
        *pad_budget_for(_graphs(), 6)), with_triplets=False)

    def loss_fn(p):
        return jloss.smooth_l1_loss(jmodel.apply(p, jb), jb.y,
                                    mask=jb.graph_mask)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        _flax_tree(case["flat"]))
    want = {k: np.asarray(v, np.float32)
            for k, v in export_params_flat(grads).items()}
    for world in WORLDS:
        got = runs[world][name]["ring"]
        np.testing.assert_allclose(got[1], float(loss), rtol=JAX_PRED_RTOL)
        _assert_grads(got[2], want, JAX_GRAD_RTOL, JAX_GRAD_ATOL,
                      f"{world} ranks")


@pytest.mark.parametrize("world", WORLDS)
def test_ep_remat_gradients_are_bitwise(runs, world):
    """remat recomputes each conv, its exchange included, in the backward:
    the same bits."""
    for mode in MODES:
        got, want = runs[world]["remat"][mode], runs[world]["atomwise"][mode]
        np.testing.assert_array_equal(got[0], want[0])
        for path in want[2]:
            np.testing.assert_array_equal(got[2][path], want[2][path],
                                          err_msg=path)


@pytest.mark.parametrize("world", WORLDS)
def test_ep_dropout_with_handed_masks_matches_model(runs, single, world):
    """Each rank drops with its atoms' cut of one global mask per conv: the
    single-process model under the whole masks."""
    want = single["dropout"]
    assert np.abs(want[0] - single["atomwise"][0]).max() > 1e-4
    for mode in MODES:
        got = runs[world]["dropout"][mode]
        np.testing.assert_allclose(got[0], want[0], rtol=PRED_RTOL,
                                   atol=PRED_ATOL * np.abs(want[0]).max())
        _assert_grads(got[2], want[2], GRAD_RTOL, GRAD_ATOL, mode)


def test_ep_dropout_matches_jax_ep_under_the_same_masks(setup, runs):
    """JAX's EP forward with each shard's draw replaced by its cut of the
    same global masks (x2gnn_tpu.ops.attention.pair_dropout_mask, patched
    for the call)."""
    _, batch, _, cases = setup
    case = next(c for c in cases if c["name"] == "dropout")
    masks = [jnp.asarray(m) for m in case["masks"]]
    calls = []

    def cut(key, rate, n_local, d, h):
        i = len(calls) % len(masks)
        calls.append(i)
        lo = jax.lax.axis_index("data") * n_local
        return jax.lax.dynamic_slice_in_dim(masks[i], lo, n_local)

    jcfg = JaxModelConfig(**case["cfg"], use_pallas=False)
    jb = jbatching.pad_graphs(_graphs(), jbatching.Budgets(
        *pad_budget_for(_graphs(), 6)), with_triplets=False)
    mesh = jmake_mesh(4)
    epb = jmake_ep_batch(jb, 4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattention, "pair_dropout_mask", cut)
        fwd = jmake_ep_forward(jcfg, mesh, epb.numbers.shape[0],
                               with_dropout=True)
        ref = np.asarray(fwd(_flax_tree(case["flat"]),
                             jshard_ep_batch(epb, mesh),
                             jax.random.PRNGKey(0)))
    assert calls
    for mode in MODES:
        np.testing.assert_allclose(runs[4]["dropout"][mode][0], ref,
                                   rtol=JAX_PRED_RTOL,
                                   atol=JAX_PRED_ATOL * np.abs(ref).max())


def test_ep_batch_matches_the_reference(setup):
    """make_ep_batch bitwise the JAX package's, padded atom axis
    included, and float16 features kept float16."""
    graphs, batch, odd, _ = setup
    bud = pad_budget_for(graphs, len(graphs))
    odd_bud = bud._replace(n_node=bud.n_node + 1, tiers=(), n_hi=0,
                           n_deg_lo=0)
    for b, budgets, n_dev in ((batch, bud, 4), (odd, odd_bud, 4),
                              (odd, odd_bud, 2)):
        jb = jbatching.pad_graphs(graphs, jbatching.Budgets(*budgets),
                                  with_triplets=False)
        for feat in ("float32", "float16"):
            got = make_ep_batch(cast_feat(b, feat), n_dev)
            ref = jmake_ep_batch(jb.replace(edge_feat=np.asarray(
                cast_feat(b, feat).edge_feat)), n_dev)
            for f in dataclasses.fields(got):
                want = np.asarray(getattr(ref, f.name))
                have = getattr(got, f.name)
                assert have.dtype == want.dtype, f.name
                np.testing.assert_array_equal(have, want, err_msg=f.name)
            assert got.numbers.shape[0] % n_dev == 0


def test_ep_refuses_int8_features_and_bf16_compute(setup):
    _, batch, _, _ = setup
    with pytest.raises(ValueError, match="int8"):
        make_ep_batch(cast_feat(batch, "int8"), 2)
    with pytest.raises(ValueError, match="float32"):
        _check_model(ModelConfig(**CFG, compute_dtype="bfloat16"))


@pytest.fixture(scope="module")
def world4(ranks):
    out, _, (x, cot, op_inputs, op_cot) = ranks
    res = out[4]
    return (x, cot, [r[1] for r in res], dict(op_inputs), op_cot,
            [r[2] for r in res])


@pytest.mark.parametrize("mode", MODES)
def test_exchange_backward_matches_dense_gather(setup, world4, mode):
    """The exchange's output is the dense gather x[out2in] at real
    out-slots, 0 elsewhere, and its backward the dense gather's gradient
    at the real in-slots (tests/test_ep_model.py:390)."""
    _, batch, _, _ = setup
    x, cot, ex, _, _, _ = world4
    epb = make_ep_batch(batch, 4)
    om, im = epb.out_mask, epb.in_mask.reshape(-1)
    xt = torch.from_numpy(x).requires_grad_(True)
    ref = torch.where(torch.from_numpy(om)[..., None],
                      xt[torch.from_numpy(epb.out2in).long()], 0.0)
    (dref,) = torch.autograd.grad(
        (ref * torch.from_numpy(cot.reshape(ref.shape))).sum(), xt)
    dref = torch.where(torch.from_numpy(im)[:, None], dref, 0.0)
    got = np.concatenate([r[mode][0] for r in ex])
    dx = np.concatenate([r[mode][1] for r in ex])
    np.testing.assert_array_equal(got, ref.detach().numpy())
    np.testing.assert_allclose(dx, dref.numpy(), rtol=1e-6, atol=1e-6)


def _op_problem(rng):
    """Inputs of the standalone EP attention op (tests/test_ep_model.py:
    333-385): random projections on a real batch whose atom and edge
    budgets divide by 4."""
    H, C, L = 4, 8, 3
    graphs = _graphs(seed=4, n=8)
    bud = pad_budget_for(graphs, 8)
    bud = bud._replace(n_node=-(-bud.n_node // 4) * 4,
                       n_edge=-(-bud.n_edge // 4) * 4, tiers=(), n_hi=0,
                       n_deg_lo=0)
    b = pad_graphs(graphs, bud)
    E = b.edge_src.shape[0]
    N, D = b.in_edges.shape
    pos = b.positions
    in_src = b.edge_src[b.in_edges]
    out_dst = b.edge_dst[b.out_edges]
    ji = pos[in_src] - pos[:, None, :]
    jk = pos[out_dst] - pos[:, None, :]
    theta = np.arctan2(
        np.sqrt(np.maximum((np.cross(ji[:, :, None, :], jk[:, None, :, :])
                            ** 2).sum(-1), 1e-24)),
        np.einsum("nid,nkd->nik", ji, jk))
    from x2gnn_tpu.ops.basis import legendre_cos_harmonics
    f32 = np.float32
    inputs = dict(
        q=rng.normal(size=(E, H, C)).astype(f32),
        k=rng.normal(size=(E, H, C)).astype(f32),
        v=rng.normal(size=(E, H, C)).astype(f32),
        e_atom=rng.normal(size=(N, H, C)).astype(f32),
        G=rng.normal(size=(E, L, H, C)).astype(f32),
        s_bias=rng.normal(size=(H, C)).astype(f32),
        cbf=np.asarray(legendre_cos_harmonics(jnp.asarray(theta), L), f32),
        in_edges=b.in_edges.astype(np.int64),
        out_edges=b.out_edges.astype(np.int64),
        pair_mask=(b.in_mask[:, :, None] & b.out_mask[:, None, :]
                   & (in_src[:, :, None] != out_dst[:, None, :])))
    inputs["batch"] = b
    cot = rng.normal(size=(N, D, H, C)).astype(f32)
    return inputs, cot


def test_ep_blocked_attention_matches_jax(world4):
    """make_ep_blocked_attention on 4 ranks against the JAX package's on
    4 virtual devices, and its gradients against JAX's single-device
    blocked attention (values in the E layout, at the real edges)."""
    _, _, _, inputs, cot, op = world4
    b = inputs.pop("batch")
    names = ("q", "k", "v", "e_atom", "G", "s_bias", "cbf", "in_edges",
             "out_edges", "pair_mask")
    got = np.concatenate([r[0] for r in op])
    jin = [jnp.asarray(inputs[n]) for n in names]
    want = np.asarray(jmake_ep_blocked_attention(jmake_mesh(4), 4)(*jin))
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-6)
    N, D, H, C = got.shape
    em = b.edge_mask

    def ref(q, k, v, e_atom, G):
        out = jblocked_attention(q, k, v, e_atom, G, jin[5], jin[6],
                                 jin[7], jin[8], jin[9],
                                 jnp.asarray(b.edge_inpos))
        return jnp.where(jnp.asarray(em)[:, None, None], out, 0.0)

    out, vjp = jax.vjp(ref, *jin[:5])
    cot_e = cot.reshape(N * D, H, C)[b.edge_inpos]
    cot_e = np.where(em[:, None, None], cot_e, 0.0)
    np.testing.assert_allclose(got.reshape(N * D, H, C)[b.edge_inpos][em],
                               np.asarray(out)[em], rtol=3e-4, atol=3e-5)
    # the EP op's cotangent lives at the real edges' in-slots only
    mask_blk = np.zeros((N * D,), bool)
    mask_blk[b.edge_inpos[em]] = True
    assert np.array_equal(cot.reshape(N * D, H, C)[mask_blk].shape[0],
                          em.sum())
    for i, name in enumerate(("q", "k", "v", "e_atom", "G")):
        g = np.concatenate([r[1][i] for r in op])
        np.testing.assert_allclose(
            g, np.asarray(vjp(jnp.asarray(cot_e))[i]), rtol=1e-4,
            atol=1e-4 * np.abs(g).max(), err_msg=name)


@pytest.fixture(scope="module")
def world2_training(ranks):
    out, tmp, _ = ranks
    res = out[2]
    return ([r[1] for r in res], [r[2] for r in res], [r[3] for r in res],
            tmp)


def test_ep_train_step_runs_and_descends(world2_training):
    steps, _, _, _ = world2_training
    for losses, step, count, firsts in steps:
        assert step == 4 and count == 6
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
        # a rerun of the first step from the same start gives the same bits
        for a, b in zip(firsts[0], firsts[1]):
            np.testing.assert_array_equal(a, b)
    # both ranks hold the same parameters
    for a, b in zip(steps[0][3][0], steps[1][3][0]):
        np.testing.assert_array_equal(a, b)


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# A run of several epochs against another: each step's gradients agree to
# ~1e-6 relative (above), which Adam's steps carry on; the epochs' losses
# and MAEs are held to 1e-3 relative, as tests/test_torch_port_train.py
# holds the port's two-epoch runs against JAX.
RUN_RTOL = 1e-3


def test_trainer_edge_partition_mode(setup, world2_training):
    """Trainer(edge_partition="ring") over 2 ranks trains as the
    single-process Trainer does on the same molecules and weights; the
    ranks end with the same parameters; rank 0 alone wrote one record per
    epoch."""
    _, fit, _, tmp = world2_training
    for summary, _, spe in fit:
        assert np.isfinite(summary["best_val_mae"]) and spe == 4
    for a, b in zip(fit[0][1], fit[1][1]):
        np.testing.assert_array_equal(a, b)
    got = _records(tmp / "ep_run")
    assert len(got) == 3
    assert "ckpt_best.pt" in os.listdir(tmp / "ep_run")
    from x2gnn_tpu_torch.config import TrainConfig
    from x2gnn_tpu_torch.train.trainer import Trainer
    from x2gnn_tpu_torch.weights import load_flax_params
    train, targets = _train_graphs()
    model = X2GNN(ModelConfig(**CFG), device="cpu")
    load_flax_params(model, setup[3][0]["flat"])
    Trainer(model, model.config, TrainConfig(**EP_TCFG), train, targets,
            workdir=str(tmp / "single"), device="cpu").fit()
    want = _records(tmp / "single")
    for g, w in zip(got, want):
        for key in ("loss", "val_mae", "best_val_mae", "step"):
            np.testing.assert_allclose(g[key], w[key], rtol=RUN_RTOL,
                                       err_msg=key)


def test_trainer_accepts_dropout_with_edge_partition(world2_training):
    _, _, drop, _ = world2_training
    for summary, _, _ in drop:
        assert np.isfinite(summary["best_val_mae"])
