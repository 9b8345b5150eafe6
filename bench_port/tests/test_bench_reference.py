"""The plain reference against the port's CPU path on seeded weights, and
the bf16 control failing each cell's check."""

import numpy as np
import pytest
import torch

from bench_port import harness, inputs
from bench_port.reference import model as ref
from bench_port.reference import train as ref_train
from bench_port.tests.tiny import CELLS, run_tiny, tiny


def _setup(seed=3):
    config, traffic = tiny("aid.train")
    m = config["model"]
    mols = inputs.make_molecules({**traffic, "molecules": 6}, seed,
                                 m["cutoff"], m["edge_feat_dim"], "cpu")
    weights = inputs.make_weights(m, seed, "cpu")
    return m, mols, weights


def _port_batch(mols, m):
    from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
    graphs = harness.build_graphs(mols, m["cutoff"])
    return pad_graphs(graphs, pad_budget_for(graphs, len(graphs))).to("cpu")


def test_param_spec_is_the_ports_parameters():
    from x2gnn_tpu_torch.config import ModelConfig
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    config, _ = tiny("aid.train")
    port = X2GNN(ModelConfig(**config["model"]), torch.Generator(),
                 device="cpu")
    want = {n: tuple(p.shape) for n, p in port.named_parameters()}
    got = {s.name: s.shape for s in ref.param_spec(config["model"])}
    assert got == want


def test_forward_matches_the_port():
    m, mols, weights = _setup()
    _, model = harness.port_model(m, weights, "cpu")
    with torch.no_grad():
        got = model(_port_batch(mols, m)).numpy()[:len(mols)]
    want = ref.predict(weights, mols, m, "cpu")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


def test_gradients_match_the_port():
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss
    m, mols, weights = _setup(4)
    _, model = harness.port_model(m, weights, "cpu")
    batch = _port_batch(mols, m)
    loss = smooth_l1_loss(model(batch), batch.y, batch.graph_mask)
    names = [n for n, _ in model.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(
        loss, list(model.parameters()), materialize_grads=True)))
    want_loss, want = ref_train.loss_and_grads(weights, mols, m, "cpu")
    assert abs(float(loss.detach()) - want_loss) <= 1e-5 * abs(want_loss)
    scale = np.median([float(g.norm()) for g in want.values()])
    for k in names:
        err = float((got[k] - want[k]).norm())
        assert err <= 1e-4 * max(float(want[k].norm()), scale), k


def test_moving_average_follows_the_ports_definition():
    from x2gnn_tpu_torch.train.ema import ema_init, ema_update
    g = torch.Generator().manual_seed(0)
    steps = [{"w": torch.randn(3, 2, generator=g)} for _ in range(3)]
    port = ema_init([torch.zeros(3, 2)])
    ref = None
    for p in steps:
        port = ema_update(port, [p["w"]], 0.95)
        ref = ref_train.ema_step(ref, p, 0.95)
    torch.testing.assert_close(port.params[0], ref["w"], rtol=0, atol=1e-7)
    want = 0.95 ** 2 * steps[0]["w"] + 0.95 * 0.05 * steps[1]["w"] \
        + 0.05 * steps[2]["w"]
    torch.testing.assert_close(ref["w"], want)


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_control_fails(cell):
    res = run_tiny(cell, compute_dtype="bfloat16")
    assert not res["correct"], res["checks"]
