"""The port's host-side data pipeline (x2gnn_tpu_torch.data) gives arrays
identical to the JAX package's for the same molecules and budgets."""

import dataclasses

import numpy as np
import pytest
import torch

from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.data import graphs as jgraphs
from x2gnn_tpu.data import synthetic as jsynthetic
from x2gnn_tpu.infer import quantize_budgets as jquantize
from x2gnn_tpu_torch.data.batching import (
    STATIC_FIELDS, Budgets, batch_iterator, pad_budget_for, pad_graphs)
from x2gnn_tpu_torch.data.graphs import build_mol_graph
from x2gnn_tpu_torch.data.synthetic import random_molecule, synthetic_dataset
from x2gnn_tpu_torch.infer import quantize_budgets


def _molecules(seed, n=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        numbers, pos = random_molecule(rng, int(rng.integers(3, 14)))
        out.append((numbers, pos))
    return out


def _assert_graphs_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_build_mol_graph_matches_reference():
    for i, (numbers, pos) in enumerate(_molecules(3)):
        feat_rng = np.random.default_rng(i)
        ref = jgraphs.build_mol_graph(numbers, pos, y=np.array([1.5]),
                                      edge_feat_dim=6, index=i)
        feat = feat_rng.normal(size=ref.edge_feat.shape)
        ref = jgraphs.build_mol_graph(numbers, pos, y=np.array([1.5]),
                                      edge_feat=feat, index=i)
        got = build_mol_graph(numbers, pos, y=np.array([1.5]),
                              edge_feat=feat, index=i)
        _assert_graphs_equal(got, ref)


def test_synthetic_dataset_matches_reference():
    ref = jsynthetic.synthetic_dataset(6, mean_atoms=12, seed=5,
                                       edge_feat_dim=10)
    got = synthetic_dataset(6, mean_atoms=12, seed=5, edge_feat_dim=10)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _assert_graphs_equal(a, b)


@pytest.mark.parametrize("batch_size", [2, 4])
def test_budgets_match_reference(batch_size):
    graphs = synthetic_dataset(7, mean_atoms=10, seed=2, edge_feat_dim=4)
    ref = jbatching.pad_budget_for(graphs, batch_size)
    got = pad_budget_for(graphs, batch_size)
    assert tuple(got) == tuple(ref)
    assert tuple(quantize_budgets(got)) == tuple(jquantize(ref))


@pytest.mark.parametrize("quantize", [False, True])
def test_pad_graphs_matches_reference(quantize):
    graphs = synthetic_dataset(6, mean_atoms=9, seed=4, edge_feat_dim=5)
    ref_b = jbatching.pad_budget_for(graphs, 4)
    if quantize:
        ref_b = jquantize(ref_b)
    else:
        # budgets without the degree split or tiers (the serving planner's)
        ref_b = jbatching.Budgets(*ref_b[:4])
    budgets = Budgets(*ref_b[:4])
    ref = jbatching.pad_graphs(graphs[:4], ref_b, n_graph=5,
                               with_triplets=False)
    got = pad_graphs(graphs[:4], budgets, n_graph=5)
    for f in dataclasses.fields(got):
        x = getattr(got, f.name)
        if f.name in STATIC_FIELDS or x is None:  # None: edge_feat_scale
            assert x == getattr(ref, f.name), f.name
            continue
        y = np.asarray(getattr(ref, f.name))
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_batch_iterator_and_to_device():
    graphs = synthetic_dataset(5, mean_atoms=8, seed=6, edge_feat_dim=3)
    budgets = quantize_budgets(pad_budget_for(graphs, 2))
    batches = list(batch_iterator(graphs, 2, budgets=budgets))
    assert len(batches) == 3
    assert batches[-1].graph_mask.tolist() == [True, False]
    tb = batches[0].to("cpu")
    assert tb.in_edges.dtype == torch.int64
    assert tb.in_mask.dtype == torch.bool
    assert tb.positions.dtype == torch.float32
    np.testing.assert_array_equal(tb.edge_inpos.numpy(),
                                  batches[0].edge_inpos)


def test_pad_graphs_rejects_over_budget():
    graphs = synthetic_dataset(2, mean_atoms=8, seed=1, edge_feat_dim=3)
    b = pad_budget_for(graphs, 2)
    with pytest.raises(ValueError):
        pad_graphs(graphs, b._replace(n_node=b.n_node // 4))
    with pytest.raises(ValueError):
        pad_graphs(graphs, b._replace(n_deg=1))
