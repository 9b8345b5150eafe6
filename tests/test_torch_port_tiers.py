"""The port's X2GNN on degree-sorted batches with degree tiers, with the
two-tier split and with one window, against the JAX package (Pallas
formulation, interpret mode) and against itself; and a two-epoch
`pack_mixed` Trainer run against the JAX Trainer, on the CPU."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_model import SMALL, _graphs
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.config import TrainConfig as JaxTrainConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.train.trainer import Trainer as JaxTrainer
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.models.x2gnn import X2GNN, attention_windows
from x2gnn_tpu_torch.train.loss import smooth_l1_loss
from x2gnn_tpu_torch.train.trainer import Trainer
from x2gnn_tpu_torch.weights import export_flax_params, load_flax_params


def _set():
    """24 small molecules whose batch-8 budgets plan tiers and a split."""
    return _graphs(24, seed=23)


def _budgets(kind):
    bud = pad_budget_for(_set(), 8)
    assert bud.tiers and bud.n_hi and bud.n_deg_lo
    return {"tiers": bud, "split": bud._replace(tiers=()),
            "one window": bud._replace(n_deg_lo=0, n_hi=0, tiers=())}[kind]


@pytest.fixture(scope="module")
def weights():
    graphs = _set()[:8]
    jb = jbatching.pad_graphs(graphs, jbatching.Budgets(*_budgets("tiers")),
                              with_triplets=False)
    params = jax.jit(JaxX2GNN(JaxModelConfig(use_pallas=True,
                                             **SMALL)).init)(
        jax.random.PRNGKey(0), jb)
    return params, export_params_flat(params)


def _port_model(flat):
    model = X2GNN(ModelConfig(**SMALL), device="cpu")
    load_flax_params(model, flat)
    return model


@pytest.mark.parametrize("n_hi,d_lo,tiers,want", [
    (0, 0, ((8, 8, 8), (8, 5, 8), (16, 4, 8)), [(0, 8, 8, 8), (8, 16, 4, 8)]),
    (8, 4, ((8, 8, 8), (16, 4, 8)), [(0, 8, 8, 8), (8, 16, 4, 8)]),
    (8, 4, (), [(0, 8, 8, 8), (8, 16, 4, 4)]),
    (16, 4, (), [(0, 16, 8, 8)]),
    (8, 8, (), [(0, 16, 8, 8)]),
    (0, 0, (), [(0, 16, 8, 8)])])
def test_attention_windows_follow_the_reference_branches(n_hi, d_lo, tiers,
                                                         want):
    """Tiers first (an empty tier skipped), else the two-tier split when
    0 < n_hi < N and 0 < d_lo < D, else one window (conv.py:293-371)."""
    assert attention_windows(16, 8, n_hi, d_lo, tiers) == want


@pytest.mark.parametrize("kind", ["tiers", "split", "one window"])
def test_model_matches_reference_pallas(weights, kind):
    """The port's forward on the same degree-sorted batch as JAX
    X2GNN(use_pallas=True) in interpret mode, whose conv runs one kernel
    per tier or the split's two (x2gnn_tpu/nn/conv.py:293-371)."""
    params, flat = weights
    graphs = _set()[8:16]
    bud = _budgets(kind)
    pb = pad_graphs(graphs, bud)
    windows = attention_windows(*pb.in_edges.shape, pb.n_hi, pb.d_lo,
                                pb.tiers)
    assert len(windows) == {"tiers": len(bud.tiers), "split": 2,
                            "one window": 1}[kind]
    jb = jbatching.pad_graphs(graphs, jbatching.Budgets(*bud),
                              with_triplets=False)
    ref = np.asarray(JaxX2GNN(JaxModelConfig(use_pallas=True,
                                             **SMALL)).apply(params, jb))
    with torch.no_grad():
        got = _port_model(flat)(pb.to("cpu")).numpy()
    assert got.shape == ref.shape == (8,)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def _loss_and_grads(model, batch):
    b = batch.to("cpu")
    loss = smooth_l1_loss(model(b), b.y, mask=b.graph_mask)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.item(), export_flax_params(model, dict(zip(names, grads)))


@pytest.mark.parametrize("kind", ["tiers", "split"])
def test_windows_match_one_window(weights, kind):
    """On one degree-sorted batch, the tiered (or split) forward and every
    parameter's gradient equal those of the same batch run as one window:
    the windows drop only slots that no edge occupies."""
    _, flat = weights
    targets = np.random.default_rng(41).normal(size=8).astype(np.float32)
    batch = pad_graphs(_set()[:8], _budgets(kind), targets=targets)
    whole = dataclasses.replace(batch, tiers=(), n_hi=0, d_lo=0)
    model = _port_model(flat)
    with torch.no_grad():
        got = model(batch.to("cpu")).numpy()
        ref = model(whole.to("cpu")).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    loss, g = _loss_and_grads(model, batch)
    ref_loss, g_ref = _loss_and_grads(model, whole)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
    top = max(float(np.abs(r).max()) for r in g_ref.values())
    for path, r in g_ref.items():
        if path.endswith("lin_key/Dense_0/bias"):
            # rounding noise in both (test_whole_model_gradients_match_jax)
            assert np.abs(g[path]).max() < 1e-6 * top, path
            continue
        np.testing.assert_allclose(g[path], r, rtol=1e-5,
                                   atol=1e-6 * np.abs(r).max(),
                                   err_msg=path)


@pytest.fixture(scope="module")
def packed_runs(tmp_path_factory):
    """Two epochs of pack_mixed training in both packages from the same
    weights and budgets. The JAX Trainer runs its XLA branch
    (use_pallas=False): it ignores the tiers but not the degree sort, and
    interpret-mode Pallas on every tier of every step would take minutes
    on the CPU; test_model_matches_reference_pallas holds the tiered
    forward to the Pallas branch."""
    mktemp = tmp_path_factory.mktemp
    graphs = _set()
    targets = np.array([g.y[0] for g in graphs], np.float32)
    bud = pad_budget_for(graphs, 8)
    kw = dict(batch_size=8, max_epoch=2, scheduler="plateau",
              fused_update=True, ckpt_after_epoch=100, max_lr=1e-3,
              pack_mixed=True)
    jcfg = JaxModelConfig(use_pallas=False, **SMALL)
    jt = JaxTrainer(JaxX2GNN(jcfg), jcfg, JaxTrainConfig(**kw), graphs,
                    targets, workdir=str(mktemp("jax")),
                    budgets=jbatching.Budgets(*bud))
    jstate0 = jt.init_state()
    flat0 = export_params_flat(jstate0.params)
    jt.init_state = lambda: jax.tree_util.tree_map(jnp.copy, jstate0)
    jt.fit(epochs=2)
    jrecords = [json.loads(line) for line in
                open(f"{jt.workdir}/metrics.jsonl")]
    model = _port_model(flat0)
    pt = Trainer(model, ModelConfig(**SMALL), TrainConfig(**kw), graphs,
                 targets, workdir=str(mktemp("port")), budgets=bud,
                 device="cpu")
    pt.fit(epochs=2)
    precords = [json.loads(line) for line in
                open(f"{pt.workdir}/metrics.jsonl")]
    return jrecords, precords, pt


def test_packed_trainer_two_epochs_match_reference(packed_runs):
    jrec, prec, pt = packed_runs
    batches = pt.batches(pt.train_idx)
    assert len(batches) > 1 and all(b.tiers for b in batches)
    assert len(jrec) == len(prec) == 2
    for j, p in zip(jrec, prec):
        for key in ("loss", "val_mae", "best_val_mae"):
            np.testing.assert_allclose(p[key], j[key], rtol=1e-3,
                                       err_msg=key)
        for key in ("epoch", "step", "bad_steps", "lr_scale",
                    "occupancy_nodes", "occupancy_edges",
                    "occupancy_triplets", "occupancy_pairs",
                    "budget_shapes"):
            assert p[key] == j[key], key
    assert prec[-1]["step"] == 2 * len(batches)
