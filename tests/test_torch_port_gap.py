"""The gap recipe's model in the port (runs/gap_r5_50k/args.json: the
flagship's width and packing, `readout: molwise_mean`, `dropout: 0.1`)
against the JAX package on the CPU: segment_mean and the molecule-wise
readouts, and the whole model with attention dropout under the masks the
JAX model draws. Its training and serving: test_torch_port_gap_train.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import x2gnn_tpu.nn.conv as jconv
from test_torch_port_model import (  # noqa: F401 (autouse fixture)
    SMALL, _graphs, one_torch_thread)
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.nn.readout import MolWiseReadout as JaxMolWiseReadout
from x2gnn_tpu.ops.segment import segment_mean as jsegment_mean
from x2gnn_tpu.train import loss as jloss
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import ModelConfig
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.nn.readout import MolWiseReadout
from x2gnn_tpu_torch.ops.segment import segment_mean
from x2gnn_tpu_torch.train.loss import smooth_l1_loss
from x2gnn_tpu_torch.weights import export_flax_params, load_flax_params

# the gap recipe's model at the small width of the other port tests
MOLWISE = dict(SMALL, readout="molwise_mean")


# ---- segment_mean and the molecule-wise readouts ---------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("width", [None, 5])
def test_segment_mean_matches_jax(masked, width):
    """Unsorted ids, an empty segment (count floored at 1: 0) and masked
    rows, against x2gnn_tpu.ops.segment.segment_mean."""
    rng = np.random.default_rng(60)
    shape = (40,) if width is None else (40, width)
    data = rng.normal(size=shape).astype(np.float32)
    ids = rng.integers(0, 6, size=40).astype(np.int32)
    ids[ids == 4] = 5                       # segment 4 is empty
    mask = rng.random(40) > 0.3 if masked else None
    got = segment_mean(torch.from_numpy(data), torch.from_numpy(ids), 7,
                       None if mask is None else torch.from_numpy(mask))
    want = jsegment_mean(jnp.asarray(data), jnp.asarray(ids), 7,
                         None if mask is None else jnp.asarray(mask))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert (got[4] == 0).all() and (got[6] == 0).all()


@pytest.mark.parametrize("pool", ["mean", "add"])
def test_molwise_readout_matches_jax(pool):
    """MolWiseReadout (gate, edges -> atoms, atoms -> molecules by mean or
    sum, torch-default MLP) with the weights of the flax module
    (load_flax_params: the MLP's layers nest a Dense_0 as the reference's
    TorchDense does)."""
    rng = np.random.default_rng(61)
    E, A, G, C, K = 30, 9, 3, 16, 6
    x = rng.normal(size=(E, C)).astype(np.float32)
    rbf = rng.normal(size=(E, K)).astype(np.float32)
    src = rng.integers(0, A, size=E).astype(np.int32)
    gid = np.array([0, 0, 1, 1, 1, 2, 2, 0, 0], np.int32)
    emask = rng.random(E) > 0.2
    nmask = np.array([1, 1, 1, 1, 1, 1, 1, 0, 0], bool)
    jm = JaxMolWiseReadout(C, pool=pool)
    args = [jnp.asarray(a) for a in (x, rbf, src, gid)]
    params = jm.init(jax.random.PRNGKey(2), *args, A, G,
                     edge_mask=jnp.asarray(emask),
                     node_mask=jnp.asarray(nmask))
    want = jm.apply(params, *args, A, G, edge_mask=jnp.asarray(emask),
                    node_mask=jnp.asarray(nmask))
    flat = export_params_flat(params)
    assert "mlp/mlp_0/Dense_0/kernel" in flat
    port = MolWiseReadout(C, K, pool=pool)
    load_flax_params(port, flat)
    got = port(*(torch.from_numpy(a) for a in (x, rbf, src, gid)), A, G,
               edge_mask=torch.from_numpy(emask),
               node_mask=torch.from_numpy(nmask))
    assert got.shape == (G, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert export_flax_params(port).keys() == flat.keys()


# ---- the whole model with dropout, under the JAX model's masks -------------

def _set():
    """24 small molecules whose batch-8 budgets plan degree tiers."""
    return _graphs(24, seed=23)


def _budgets(kind):
    bud = pad_budget_for(_set(), 8)
    assert bud.tiers
    return {"tiers": bud,
            "one window": bud._replace(n_deg_lo=0, n_hi=0, tiers=())}[kind]


def _jax_step(params, jb, rate):
    """Loss, predictions, parameter gradients and the dropout masks of one
    training step of JAX X2GNN(use_pallas=True, molwise_mean, dropout
    `rate`) in interpret mode, the masks recorded as its convs draw them
    (x2gnn_tpu.nn.conv.pair_dropout_mask, patched for the call)."""
    jmodel = JaxX2GNN(JaxModelConfig(use_pallas=True, dropout=rate,
                                     **MOLWISE))
    drawn = []

    def record(*args):
        mask = real(*args)
        drawn.append(mask)
        return mask

    def loss_fn(p):
        drawn.clear()
        pred = jmodel.apply(p, jb, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(5)})
        loss = jloss.smooth_l1_loss(pred, jb.y, mask=jb.graph_mask)
        return loss, (pred, list(drawn))

    real = jconv.pair_dropout_mask
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconv, "pair_dropout_mask", record)
        (loss, (pred, masks)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    return (float(loss), np.asarray(pred), export_params_flat(grads),
            [np.array(m) for m in masks])


def _port_step(model, batch, masks):
    b = batch.to("cpu")
    pred = model(b, dropout_masks=[torch.from_numpy(m) for m in masks])
    loss = smooth_l1_loss(pred, b.y, mask=b.graph_mask)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return (loss.item(), pred.detach().numpy(),
            export_flax_params(model, dict(zip(names, grads))))


@pytest.fixture(scope="module", params=["tiers", "one window"])
def dropout_step(request):
    """One step of both packages on 8 molecules, dropout 0.3, from the
    same weights; the port replays the JAX model's masks."""
    graphs = _set()[:8]
    targets = np.random.default_rng(62).normal(size=8).astype(np.float32)
    bud = _budgets(request.param)
    jb = jbatching.pad_graphs(graphs, jbatching.Budgets(*bud),
                              targets=targets, with_triplets=False)
    params = jax.jit(JaxX2GNN(JaxModelConfig(use_pallas=True,
                                             **MOLWISE)).init)(
        jax.random.PRNGKey(0), jb)
    jl, jpred, jgrads, masks = _jax_step(params, jb, 0.3)
    model = X2GNN(ModelConfig(dropout=0.3, **MOLWISE), device="cpu")
    load_flax_params(model, export_params_flat(params))
    batch = pad_graphs(graphs, bud, targets=targets)
    return request.param, batch, model, masks, (jl, jpred, jgrads), \
        _port_step(model, batch, masks)


def test_dropout_model_matches_jax_forward(dropout_step):
    """Predictions and loss under the recorded masks (one per conv, pair
    space (N, D, D, H), 0.3 of them 0): rtol 1e-4 as the model test."""
    kind, batch, _, masks, (jl, jpred, _), (loss, pred, _) = dropout_step
    N, D = batch.in_edges.shape
    assert len(masks) == MOLWISE["conv_layers"]
    assert all(m.shape == (N, D, D, MOLWISE["heads"]) for m in masks)
    assert 0.25 < np.mean([(m == 0).mean() for m in masks]) < 0.35
    assert bool(batch.tiers) == (kind == "tiers")
    np.testing.assert_allclose(pred, jpred, rtol=1e-4,
                               atol=1e-4 * np.abs(jpred).max())
    np.testing.assert_allclose(loss, jl, rtol=1e-5)


def test_dropout_model_matches_jax_gradients(dropout_step):
    """Every parameter's gradient at rtol 1e-3 and 1e-4 of its largest
    magnitude, as test_whole_model_gradients_match_jax; the lin_key biases
    (0 in exact arithmetic) below 1e-6 of the largest gradient."""
    _, _, _, _, (_, _, jgrads), (_, _, grads) = dropout_step
    assert grads.keys() == jgrads.keys()
    assert "readout_0/mlp/mlp_0/Dense_0/kernel" in grads
    top = max(float(np.abs(r).max()) for r in jgrads.values())
    for path, ref in jgrads.items():
        ref = np.asarray(ref, np.float32)
        if path.endswith("lin_key/Dense_0/bias"):
            assert np.abs(ref).max() < 1e-6 * top, path
            assert np.abs(grads[path]).max() < 1e-6 * top, path
            continue
        np.testing.assert_allclose(grads[path], ref, rtol=1e-3,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=path)


def test_dropout_tiers_equal_one_window():
    """Under one set of masks the tiered forward equals the same sorted
    batch run as one window, bit for bit: every window cuts its mask from
    the canonical pair-space one."""
    batch = pad_graphs(_set()[:8], _budgets("tiers"))
    assert len(batch.tiers) > 1
    whole = dataclasses.replace(batch, tiers=(), n_hi=0, d_lo=0)
    N, D = batch.in_edges.shape
    rng = np.random.default_rng(63)
    ms = [torch.from_numpy((rng.random((N, D, D, MOLWISE["heads"])) < 0.7)
                           .astype(np.float32) / np.float32(0.7))
          for _ in range(MOLWISE["conv_layers"])]
    model = X2GNN(ModelConfig(dropout=0.3, **MOLWISE),
                  torch.Generator().manual_seed(2), device="cpu")
    with torch.no_grad():
        tiered = model(batch.to("cpu"), dropout_masks=ms)
        one = model(whole.to("cpu"), dropout_masks=ms)
        plain = model(batch.to("cpu"))
    np.testing.assert_array_equal(tiered.numpy(), one.numpy())
    assert not np.allclose(tiered.numpy(), plain.numpy())


def test_dropout_draws_from_the_generator(monkeypatch):
    """deterministic=False draws one mask per conv, in layer order, from
    the generator (through ops.attention.pair_dropout_mask, the module
    attribute); a generator seeded alike gives the same predictions;
    deterministic=True never draws."""
    import x2gnn_tpu_torch.ops.attention as attention_ops
    graphs = _set()[:8]
    batch = pad_graphs(graphs, _budgets("tiers")).to("cpu")
    model = X2GNN(ModelConfig(dropout=0.1, **MOLWISE),
                  torch.Generator().manual_seed(1), device="cpu")
    real = attention_ops.pair_dropout_mask
    calls = []

    def count(*args):
        calls.append(args[1:])
        return real(*args)

    monkeypatch.setattr(attention_ops, "pair_dropout_mask", count)
    with torch.no_grad():
        a = model(batch, deterministic=False,
                  generator=torch.Generator().manual_seed(7))
        b = model(batch, deterministic=False,
                  generator=torch.Generator().manual_seed(7))
        assert len(calls) == 2 * MOLWISE["conv_layers"]
        N, D = batch.in_edges.shape
        assert calls[0] == (0.1, N, D, MOLWISE["heads"], batch.in_edges.device)
        c = model(batch)
    assert len(calls) == 2 * MOLWISE["conv_layers"]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.allclose(a.numpy(), c.numpy())
