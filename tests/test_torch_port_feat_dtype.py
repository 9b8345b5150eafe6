"""Edge features in float16 or int8 with per-edge scales (the Trainer's
`feat_dtype`, the CLI's --feat-dtype), on the CPU: the port's `cast_feat`
against the JAX Trainer's `_cast_feat` bitwise, the model on a cast batch
against JAX's model on the same batch, and a training epoch on cast
features against the float32 one."""

import types

import numpy as np
import jax
import pytest
import torch

from test_torch_port_model import (  # noqa: F401 (autouse fixture)
    SMALL, _graphs, one_torch_thread)
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.train.trainer import Trainer as JaxTrainer
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.train.trainer import FEAT_DTYPES, Trainer, cast_feat
from x2gnn_tpu_torch.weights import load_flax_params


def _batches():
    """The same 8 tiered molecules padded by both packages; the features
    made non-negative and bounded, as the integral features are, with one
    all-zero row (scale 1)."""
    graphs = _graphs(24, seed=71)[:8]
    for g in graphs:
        g.edge_feat = (np.abs(g.edge_feat)
                       / (np.abs(g.edge_feat).max() + 1e-9)).astype(
                           np.float32)
    graphs[0].edge_feat[0] = 0.0
    bud = pad_budget_for(graphs, 8)
    jb = jbatching.pad_graphs(graphs, jbatching.Budgets(*bud),
                              with_triplets=False)
    return pad_graphs(graphs, bud), jb


@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_cast_feat_equals_jax_trainer(dtype):
    """Features, and for int8 the per-edge scales, bitwise those of
    x2gnn_tpu/train/trainer.py:309-330 on the same batch."""
    pb, jb = _batches()
    got = cast_feat(pb, dtype)
    ref = JaxTrainer._cast_feat(types.SimpleNamespace(_feat_dtype=dtype),
                                jb)
    ref_feat = np.asarray(ref.edge_feat)
    assert got.edge_feat.dtype == ref_feat.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got.edge_feat, ref_feat)
    if dtype == "int8":
        ref_scale = np.asarray(ref.edge_feat_scale)
        assert got.edge_feat_scale.dtype == ref_scale.dtype == np.float32
        np.testing.assert_array_equal(got.edge_feat_scale, ref_scale)
        assert got.edge_feat_scale[0] == 1.0       # the all-zero row
    else:
        assert got.edge_feat_scale is None and ref.edge_feat_scale is None
    assert cast_feat(pb, "float32") is pb


@pytest.fixture(scope="module")
def jax_model():
    """JAX X2GNN (XLA branch) and its parameters on the float32 batch."""
    jmodel = JaxX2GNN(JaxModelConfig(use_pallas=False, **SMALL))
    return jmodel, jax.jit(jmodel.init)(jax.random.PRNGKey(0), _batches()[1])


@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_model_on_cast_features_matches_jax(jax_model, dtype):
    """The port's model on a float16 or int8 (+ scales) batch against
    JAX X2GNN (its XLA branch) on the same cast batch, from the same
    weights, within the float32 model test's tolerances
    (test_torch_port_tiers.py: rtol 1e-4, 1e-4 of max|pred|): the
    features are upcast (and dequantized) at entry in both."""
    pb, jb = _batches()
    jcast = JaxTrainer._cast_feat(types.SimpleNamespace(_feat_dtype=dtype),
                                  jb)
    jmodel, params = jax_model
    ref = np.asarray(jax.jit(jmodel.apply)(params, jcast))
    model = X2GNN(ModelConfig(**SMALL), device="cpu")
    load_flax_params(model, export_params_flat(params))
    with torch.no_grad():
        b = cast_feat(pb, dtype).to("cpu")
        assert b.edge_feat.dtype == getattr(torch, dtype)
        got = model(b).numpy()
        full = model(pb.to("cpu")).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    assert not np.array_equal(got, full)


@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_training_on_cast_features_close_to_float32(dtype, tmp_path):
    """One epoch on float16 or int8 features against the float32 run:
    the loss within 2e-2 (float16) or 5e-2 (int8) relative, as
    tests/test_train.py:414,625 hold JAX, and the val MAE within 5e-2;
    the cached batches really hold the cast features."""
    graphs = synthetic_dataset(16, mean_atoms=8, seed=5, edge_feat_dim=8)
    for g in graphs:
        g.edge_feat = (np.abs(g.edge_feat)
                       / (np.abs(g.edge_feat).max() + 1e-9)).astype(
                           np.float32)
    y = np.array([g.y[0] for g in graphs], np.float32)
    y = (y - y.mean()) / (y.std() + 1e-9)
    tcfg = TrainConfig(batch_size=8, division=(4, 8), max_epoch=1,
                       warmup_steps=2)
    out = {}
    for dt in ("float32", dtype):
        model = X2GNN(ModelConfig(**SMALL), torch.Generator().manual_seed(0),
                      device="cpu")
        tr = Trainer(model, ModelConfig(**SMALL), tcfg, graphs, y,
                     workdir=str(tmp_path / dt), feat_dtype=dt,
                     device="cpu")
        batch = tr.batches(tr.train_idx)[0]
        assert batch.edge_feat.dtype == getattr(torch, dt)
        assert (batch.edge_feat_scale is not None) == (dt == "int8")
        state, loss = tr.run_epoch(tr.init_state())
        out[dt] = (loss, tr.evaluate(state, tr.val_idx))
    (l32, v32), (lc, vc) = out["float32"], out[dtype]
    assert np.isfinite(lc) and np.isfinite(vc)
    assert lc == pytest.approx(l32, rel=2e-2 if dtype == "float16" else 5e-2)
    assert vc == pytest.approx(v32, rel=5e-2)
    assert (lc, vc) != (l32, v32)


def test_trainer_refuses_an_unknown_feat_dtype():
    graphs = _graphs(4, seed=72)
    model = X2GNN(ModelConfig(**SMALL), device="cpu")
    assert FEAT_DTYPES == ("float32", "float16", "int8")
    with pytest.raises(ValueError, match="feat_dtype"):
        Trainer(model, ModelConfig(**SMALL), TrainConfig(), graphs,
                np.zeros(4, np.float32), device="cpu", feat_dtype="bf16")
