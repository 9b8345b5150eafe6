"""The blocked layout's v2 variant and beta-gated skip on the fused-kernel
formulation against the JAX package's X2GNN(use_pallas=True) in interpret
mode, on a degree-sorted batch run with its tiers and as one window:
predictions and every parameter's gradient, on the CPU (the port's plain
kernels)."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from test_torch_port_layouts import FLAT, _assert_grads, _flax_tree, _set
from test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.train.loss import smooth_l1_loss as jsmooth_l1_loss
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import ModelConfig
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.models.x2gnn import X2GNN, attention_windows
from x2gnn_tpu_torch.ops import blocked_attn
from x2gnn_tpu_torch.train.loss import smooth_l1_loss
from x2gnn_tpu_torch.weights import export_flax_params


def _budgets(kind):
    bud = pad_budget_for(_set(), 8)
    assert bud.tiers
    return {"tiers": bud,
            "one window": bud._replace(n_deg_lo=0, n_hi=0, tiers=())}[kind]


def _cfg(variant, beta):
    return dict(FLAT, attention_layout="blocked", variant=variant,
                beta=beta)


def _port(variant, beta):
    return X2GNN(ModelConfig(**_cfg(variant, beta)),
                 torch.Generator().manual_seed(7), device="cpu")


def _port_loss_and_grads(model, batch):
    b = batch.to("cpu")
    names = [n for n, _ in model.named_parameters()]
    pred = model(b)
    loss = smooth_l1_loss(pred, b.y, mask=b.graph_mask)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                materialize_grads=True)
    return (pred.detach().numpy(), loss.item(),
            export_flax_params(model, dict(zip(names, grads))))


def _jax_loss_and_grads(model, variant, beta, jb):
    jmodel = JaxX2GNN(JaxModelConfig(use_pallas=True, **_cfg(variant, beta)))

    def loss(p):
        pred = jmodel.apply(p, jb)
        return jsmooth_l1_loss(pred, jb.y, mask=jb.graph_mask), pred

    (jl, pred), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        _flax_tree(model))
    return np.asarray(pred), float(jl), export_params_flat(g)


@pytest.mark.parametrize("variant,beta,kind", [
    ("v2", False, "one window"), ("v1", True, "one window"),
    ("v2", True, "one window"), ("v2", True, "tiers")])
def test_blocked_v2_and_beta_match_reference_pallas(variant, beta, kind):
    """Predictions at rtol 1e-4 and gradients at the standing gates, the
    reference's conv running one Pallas kernel per tier or one for the
    whole batch (x2gnn_tpu/nn/conv.py:293-371), its v2 edge attributes
    from the out-table sum of the layer's input (:233-242) and its skip
    through the beta gate (:398-402)."""
    graphs = _set()[:8]
    bud = _budgets(kind)
    pb = pad_graphs(graphs, bud)
    windows = attention_windows(*pb.in_edges.shape, pb.n_hi, pb.d_lo,
                                pb.tiers)
    assert len(windows) == (len(bud.tiers) if kind == "tiers" else 1)
    jb = jbatching.pad_graphs(graphs, jbatching.Budgets(*bud),
                              with_triplets=False)
    model = _port(variant, beta)
    ref, jl, jg = _jax_loss_and_grads(model, variant, beta, jb)
    got, loss, grads = _port_loss_and_grads(model, pb)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    _assert_grads(grads, jg)
    if beta:
        assert np.abs(grads["conv_0/lin_beta/Dense_0/kernel"]).max() > 0
    if variant == "v2":
        assert not np.abs(grads["emb_block/embedding"]).any()


@pytest.mark.parametrize("variant,beta", [("v2", False), ("v1", True)])
def test_blocked_v2_and_beta_tiers_match_one_window(variant, beta):
    """On one degree-sorted batch, the tiered forward and every gradient
    equal those of the batch run as one window, and each conv launches
    one forward per tier window."""
    batch = pad_graphs(_set()[:8], _budgets("tiers"))
    whole = dataclasses.replace(batch, tiers=(), n_hi=0, d_lo=0)
    model = _port(variant, beta)
    calls = []
    real = blocked_attn.blocked_attention_fwd

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocked_attn, "blocked_attention_fwd", counted)
        got, loss, g = _port_loss_and_grads(model, batch)
    assert len(calls) == model.config.conv_layers * len(batch.tiers)
    ref, ref_loss, g_ref = _port_loss_and_grads(model, whole)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
    top = max(float(np.abs(r).max()) for r in g_ref.values())
    for path, r in g_ref.items():
        if path.endswith("lin_key/Dense_0/bias"):
            assert np.abs(g[path]).max() < 1e-6 * top, path
            continue
        np.testing.assert_allclose(g[path], r, rtol=1e-5,
                                   atol=1e-6 * np.abs(r).max(),
                                   err_msg=path)
