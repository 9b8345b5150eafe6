"""The port's flagship-structured X2GNN and Predictor against the JAX
package on the CPU, with the same weights (load_flax_params)."""

import dataclasses
import json

import numpy as np
import jax
import pytest
import torch

from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.infer import Predictor as JaxPredictor
from x2gnn_tpu.infer import load_run_configs as jload_run_configs
from x2gnn_tpu.infer import quantize_budgets as jquantize
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import ModelConfig
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.infer import (
    Predictor, load_run_configs, quantize_budgets)
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.weights import export_flax_params, load_flax_params

# the flagship's structure (blocked, v1, atomwise, L=7, K=6) at small width
SMALL = dict(conv_layers=2, in_channels=32, embedding_size=32, heads=4,
             sbf_dim=7, rbf_dim=6, edge_feat_dim=8,
             attention_layout="blocked")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU tests, restored after
    the module: the suite's workers share the machine's cores, and
    torch's default of one thread per core in every worker oversubscribes
    them (the port's training tests ran several times slower so). Other
    port test modules import it to share it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graphs(n, seed):
    return synthetic_dataset(n, mean_atoms=7, seed=seed, edge_feat_dim=8,
                             target="random")


def _jax_params(cfg, batch):
    return JaxX2GNN(cfg).init(jax.random.PRNGKey(0), batch)


def _port_model(params):
    model = X2GNN(ModelConfig(**SMALL), device="cpu")
    load_flax_params(model, export_params_flat(params))
    return model.eval()


@pytest.fixture(scope="module")
def problem():
    graphs = _graphs(3, seed=8)
    jb = jbatching.pad_graphs(graphs, jquantize(
        jbatching.pad_budget_for(graphs, 3)), with_triplets=False)
    pb = pad_graphs(graphs, quantize_budgets(pad_budget_for(graphs, 3)))
    params = _jax_params(JaxModelConfig(use_pallas=True, **SMALL), jb)
    with torch.no_grad():
        got = _port_model(params)(pb.to("cpu")).numpy()
    return jb, params, got


@pytest.mark.parametrize("use_pallas,rtol", [(True, 1e-4), (False, 1e-3)])
def test_model_matches_reference(problem, use_pallas, rtol):
    """use_pallas=True is the same formulation (interpret mode); the XLA
    branch computes the angle with arctan2 and the cbf table, hence 1e-3."""
    jb, params, got = problem
    ref = np.asarray(JaxX2GNN(JaxModelConfig(
        use_pallas=use_pallas, **SMALL)).apply(params, jb))
    assert got.shape == ref.shape == (3,)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def test_predictor_matches_reference():
    graphs = _graphs(6, seed=9)
    jcfg = JaxModelConfig(use_pallas=True, **SMALL)
    probe = jbatching.pad_graphs(graphs[:4], jbatching.pad_budget_for(
        graphs, 4), with_triplets=False)
    params = _jax_params(jcfg, probe)
    stats = {"mu": 3.0, "sigma": 2.5}
    ref = JaxPredictor(jcfg, params, stats=stats, batch_size=4).predict(
        graphs)
    got = Predictor(ModelConfig(**SMALL), _port_model(params), stats=stats,
                    batch_size=4, device="cpu").predict(graphs)
    assert got.shape == (6,)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("readout", ["atomwise", "molwise_mean"])
def test_load_flax_params_fills_every_parameter(problem, readout):
    """Every flax leaf fills one port parameter; the molecule-wise
    readouts' MLP layers (TorchDense) nest a Dense_0 as the atom-wise
    ones' (Dense) do, and export_flax_params gives the paths back."""
    jb, params, _ = problem
    cfg = dict(SMALL, readout=readout)
    if readout != "atomwise":
        params = _jax_params(JaxModelConfig(use_pallas=False, **cfg), jb)
    flat = export_params_flat(params)
    model = X2GNN(ModelConfig(**cfg), device="cpu")
    n_port = sum(1 for _ in model.parameters())
    assert n_port == len(flat)
    load_flax_params(model, flat)
    state = dict(model.named_parameters())
    k = flat["conv_0/lin_query/Dense_0/kernel"]
    np.testing.assert_array_equal(
        state["conv_0.lin_query.weight"].detach().numpy(), k.T)
    np.testing.assert_array_equal(
        state["conv_0.lin_sbf.kernel"].detach().numpy(),
        flat["conv_0/lin_sbf/kernel"])
    np.testing.assert_array_equal(
        state["readout_1.mlp.mlp_0.weight"].detach().numpy(),
        flat["readout_1/mlp/mlp_0/Dense_0/kernel"].T)
    assert export_flax_params(model).keys() == flat.keys()
    with pytest.raises(KeyError, match="maps to no port parameter"):
        load_flax_params(model, {**flat, "conv_0/lin_extra/kernel": k})
    partial = dict(flat)
    partial.pop("emb_block/embedding")
    with pytest.raises(KeyError, match="left unfilled"):
        load_flax_params(model, partial)


def test_load_run_configs_reads_the_flagship_args():
    cfg, _ = load_run_configs("runs/flagship_r5_regression/args.json")
    assert cfg == ModelConfig(attention_layout="blocked")
    assert (cfg.conv_layers, cfg.in_channels, cfg.heads, cfg.head_dim,
            cfg.sbf_dim, cfg.rbf_dim, cfg.edge_feat_dim) == (
                4, 128, 16, 8, 7, 6, 338)


def test_load_run_configs_reads_a_reference_config_json(tmp_path):
    raw = {"conv_layers": 3, "sbf_dim": 5, "rbf_dim": 4, "in_channels": 64,
           "embedding_size": 32, "heads": 8, "cutoff": 4.5, "target": 7,
           "batch_size": 16, "max_lr": 1e-3}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    ref, _ = jload_run_configs(str(path))
    got, _ = load_run_configs(str(path))
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("field,value", [
    ("attention_layout", "segment"), ("variant", "v2"),
    ("param_dtype", "bfloat16"), ("compute_dtype", "float16"),
    ("attention_layout", "padded"), ("beta", True)])
def test_unported_options_raise(field, value):
    cfg = dataclasses.replace(ModelConfig(**SMALL), **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP A8b"):
        X2GNN(cfg, device="cpu")
