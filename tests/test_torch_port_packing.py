"""The port's packing planners, degree tiers and degree-sorted batches
(x2gnn_tpu_torch.data.batching, infer.quantize_budgets and the trainer's
per-epoch shuffle) are bitwise the JAX package's on sets that do produce
tiers and a two-tier split."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from x2gnn_tpu.config import TrainConfig as JaxTrainConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.infer import quantize_budgets as jquantize
from x2gnn_tpu.train.trainer import Trainer as JaxTrainer
from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.data.batching import (
    STATIC_FIELDS, mixed_packed_plan, pad_budget_for, pad_graphs,
    plan_degree_tiers, size_bucketed_plan)
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.infer import quantize_budgets
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.train.trainer import Trainer

SMALL = dict(conv_layers=1, in_channels=32, embedding_size=32, heads=4,
             edge_feat_dim=8, attention_layout="blocked")


def _small_set():
    """24 small molecules whose batch-8 budgets plan 4 tiers and a split
    (n_deg_lo=8, n_hi=8)."""
    return synthetic_dataset(24, mean_atoms=7, seed=23, edge_feat_dim=8)


def _tier_profiles():
    """The 20 exceed-count profiles of tests/test_batching.py::
    test_plan_degree_tiers_invariants."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(20):
        n_node = int(rng.integers(4, 60)) * 8
        cap = int(rng.integers(4, 40))
        raw = np.sort(rng.integers(0, n_node, size=cap + 1))[::-1]
        raw[cap] = 0
        out.append((n_node, cap, raw))
    return out


@pytest.mark.parametrize("trial", range(20))
def test_plan_degree_tiers_matches_reference(trial):
    n_node, cap, raw = _tier_profiles()[trial]
    got = plan_degree_tiers(n_node, cap, raw)
    assert got == jbatching.plan_degree_tiers(n_node, cap, raw)
    assert all(isinstance(v, int) for t in got for v in t)


def test_tier_profiles_plan_tiers():
    """Most of the 20 profiles do give tiers (the DP is exercised)."""
    assert sum(bool(plan_degree_tiers(*p)) for p in _tier_profiles()) >= 10


@pytest.mark.parametrize("n,mean_atoms,seed,batch_size", [
    (24, 7, 23, 8), (24, 7, 23, 3), (512, 18, 11, 32), (16, 64, 3, 4)])
def test_pad_budget_for_matches_reference(n, mean_atoms, seed, batch_size):
    graphs = synthetic_dataset(n, mean_atoms=mean_atoms, seed=seed,
                               edge_feat_dim=8)
    got = pad_budget_for(graphs, batch_size)
    ref = jbatching.pad_budget_for(graphs, batch_size)
    assert got._fields == ref._fields
    assert tuple(got) == tuple(ref)
    assert got.tiers, "these sets plan degree tiers"
    if (n, batch_size) == (24, 8):
        assert (got.n_deg_lo, got.n_hi, len(got.tiers)) == (8, 8, 4)


def _budget_variants(bud):
    return {"tiers+split": bud,
            "tiers": bud._replace(n_deg_lo=0, n_hi=0),
            "split": bud._replace(tiers=()),
            "neither": bud._replace(n_deg_lo=0, n_hi=0, tiers=())}


@pytest.mark.parametrize("variant", ["tiers+split", "tiers", "split",
                                     "neither"])
def test_pad_graphs_matches_reference(variant):
    graphs = _small_set()
    bud = _budget_variants(pad_budget_for(graphs, 8))[variant]
    targets = np.random.default_rng(31).normal(size=7).astype(np.float32)
    chunk = graphs[5:12]
    got = pad_graphs(chunk, bud, n_graph=9, targets=targets)
    ref = jbatching.pad_graphs(chunk, jbatching.Budgets(*bud), n_graph=9,
                               targets=targets, with_triplets=False)
    for f in dataclasses.fields(got):
        x, y = getattr(got, f.name), getattr(ref, f.name)
        if f.name in STATIC_FIELDS or x is None:  # None: edge_feat_scale
            assert x == y, f.name
            continue
        y = np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)
    assert bool(got.tiers) == ("tiers" in variant)
    assert (got.n_hi > 0) == ("split" in variant)
    if variant != "neither":
        # the degree sort: max(in, out)-degree non-increasing over atoms
        deg = np.maximum(got.in_mask.sum(1), got.out_mask.sum(1))
        assert np.all(np.diff(deg) <= 0)


def test_pad_graphs_rejects_budgets_the_sort_cannot_meet():
    graphs = _small_set()[:8]
    bud = pad_budget_for(graphs, 8)
    with pytest.raises(ValueError, match="tier"):
        pad_graphs(graphs, bud._replace(tiers=((8, 2, 8), (bud.n_node, 1,
                                                             8))))
    with pytest.raises(ValueError, match="n_hi"):
        pad_graphs(graphs, bud._replace(n_deg_lo=1, n_hi=8, tiers=()))


def _plans_equal(got, ref):
    (gc, gb, gs), (rc, rb, rs) = got, ref
    assert len(gc) == len(rc)
    for a, b in zip(gc, rc):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert [tuple(b) for b in gb] == [tuple(b) for b in rb]
    assert gs == rs


@pytest.mark.parametrize("which", ["small", "train_split", "val_split"])
def test_mixed_packed_plan_matches_reference(which):
    if which == "small":
        graphs, batch_size = _small_set(), 8
        idx = np.random.default_rng(5).permutation(len(graphs))
    else:
        graphs, batch_size = synthetic_dataset(
            512, mean_atoms=18, seed=11, edge_feat_dim=8), 32
        perm = np.random.RandomState(41).permutation(512)
        idx = perm[102:] if which == "train_split" else perm[51:102]
    base = pad_budget_for(graphs, batch_size)
    got = mixed_packed_plan(graphs, idx, batch_size, base)
    ref = jbatching.mixed_packed_plan(graphs, idx, batch_size,
                                      jbatching.Budgets(*base))
    _plans_equal(got, ref)
    bud = got[1][0]
    assert bud.tiers and bud.n_graph
    if which == "train_split":
        # the shape of the flagship cell's plan: 11 bins, 8 tiers
        assert (len(got[0]), len(bud.tiers)) == (11, 8)


@pytest.mark.parametrize("pack", [False, True])
def test_size_bucketed_plan_matches_reference(pack):
    graphs = _small_set()
    idx = np.random.default_rng(6).permutation(len(graphs))
    base = pad_budget_for(graphs, 8)
    got = size_bucketed_plan(graphs, idx, 8, 2, base, pack=pack)
    ref = jbatching.size_bucketed_plan(graphs, idx, 8, 2,
                                       jbatching.Budgets(*base), pack=pack)
    _plans_equal(got, ref)
    # budgets without tiers, most with a split: the only plan whose
    # batches take the conv's two-tier branch
    assert not any(b.tiers for b in got[1])
    assert sum(b.n_hi > 0 and b.n_deg_lo > 0 for b in got[1]) == 2
    assert all(b.n_graph > 0 for b in got[1]) == pack


@pytest.mark.parametrize("batch_size", [3, 8])
def test_quantize_budgets_matches_reference(batch_size):
    bud = pad_budget_for(_small_set(), batch_size)
    got = quantize_budgets(bud)
    assert tuple(got) == tuple(jquantize(jbatching.Budgets(*bud)))
    assert (got.n_deg_lo, got.n_hi, got.tiers) == (0, 0, ())


@pytest.mark.parametrize("n_batches", [3, 11, 37])
def test_train_shuffle_matches_reference(n_batches):
    """Trainer.train_order visits planned batches in the reference's
    _train_shuffle order for 3 epochs (seeded by random_seed and epoch)."""
    graphs = _small_set()
    tcfg = TrainConfig(pack_mixed=True, random_seed=41)
    trainer = Trainer(X2GNN(ModelConfig(**SMALL), device="cpu"),
                      ModelConfig(**SMALL), tcfg, graphs,
                      np.zeros(len(graphs), np.float32), device="cpu")
    trainer.batches = lambda idx: list(range(n_batches))
    jself = SimpleNamespace(tcfg=JaxTrainConfig(random_seed=41))
    orders = []
    for epoch in range(3):
        got = trainer.train_order(epoch)
        ref = list(JaxTrainer._train_shuffle(jself, range(n_batches),
                                             epoch))
        assert got == ref
        orders.append(tuple(got))
    assert len(set(orders)) == 3 or n_batches == 3


def test_batch_to_keeps_the_static_fields():
    graphs = _small_set()[:8]
    b = pad_graphs(graphs, pad_budget_for(graphs, 8)).to("cpu")
    assert isinstance(b.tiers, tuple) and b.tiers
    assert isinstance(b.n_hi, int) and isinstance(b.d_lo, int)
    assert b.in_edges.dtype == torch.int64
