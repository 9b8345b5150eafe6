"""The port's segment-layout X2GNN per layer against the JAX package's
torch oracle (x2gnn_tpu/utils/torch_oracle.py::torch_forward), a
plain-torch transcription of the upstream PyG forward: an independent
reference made from the upstream sources rather than from the JAX
package. Same weights (the port's, through export_params_flat), same
batch; the tolerances of tests/test_torch_oracle.py:51-75."""

import numpy as np
import pytest
import torch

from test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.utils.torch_oracle import torch_forward
from x2gnn_tpu_torch.config import ModelConfig
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.utils.parity import dump_activations, export_params_flat

# tests/test_torch_oracle.py's model
SMALL = dict(conv_layers=2, in_channels=32, embedding_size=32, heads=4,
             sbf_dim=4, rbf_dim=3, edge_feat_dim=12,
             attention_layout="segment")
# (rtol, atol) of tests/test_torch_oracle.py:51-75
CONV_TOL = (2e-4, 2e-5)
NORM_TOL = (5e-4, 5e-5)
READOUT_TOL = (2e-4, 2e-5)
OUTPUT_TOL = (2e-4, 2e-5)


@pytest.fixture(scope="module", params=["atomwise", "molwise_mean",
                                        "molwise_add"])
def layers(request):
    """(port dump, oracle activations, oracle output, edge mask) of one
    batch of three molecules with random features."""
    readout = request.param
    graphs = synthetic_dataset(3, mean_atoms=7, seed=5, edge_feat_dim=12,
                               target="random")
    rng = np.random.default_rng(5)
    for g in graphs:
        g.edge_feat[:] = rng.normal(size=g.edge_feat.shape)
    cfg = ModelConfig(readout=readout, **SMALL)
    model = X2GNN(cfg, torch.Generator().manual_seed(3), device="cpu")
    batch = pad_graphs(graphs, pad_budget_for(graphs, 3), with_triplets=True)
    dump = dump_activations(model, batch.to("cpu"))
    jb = jbatching.pad_graphs(graphs, jbatching.pad_budget_for(graphs, 3),
                              with_triplets=True)
    out, acts = torch_forward(export_params_flat(model), jb,
                              JaxModelConfig(readout=readout, **SMALL))
    return dump, acts, out.numpy(), np.asarray(jb.edge_mask), readout


def test_convs_and_norms_match_the_oracle(layers):
    dump, acts, _, em, _ = layers
    for i in range(SMALL["conv_layers"]):
        rtol, atol = CONV_TOL
        np.testing.assert_allclose(dump[f"conv_{i}/__call__"][em],
                                   acts[f"conv_{i}"][em], rtol=rtol,
                                   atol=atol, err_msg=f"conv_{i}")
        rtol, atol = NORM_TOL
        np.testing.assert_allclose(dump[f"norm_{i}/__call__"][em],
                                   acts[f"norm_{i}"][em], rtol=rtol,
                                   atol=atol, err_msg=f"norm_{i}")


def test_first_readout_matches_the_oracle(layers):
    dump, acts, _, _, readout = layers
    rtol, atol = READOUT_TOL
    got = dump["readout_0/__call__"]
    assert got.shape == acts["readout_0"].shape
    if readout == "atomwise":
        # per-atom scalars; the oracle's rows are the batch's atoms
        assert got.shape[0] > 3
    np.testing.assert_allclose(got, acts["readout_0"], rtol=rtol, atol=atol)


def test_output_matches_the_oracle(layers):
    dump, _, out, _, _ = layers
    rtol, atol = OUTPUT_TOL
    assert dump["__output__"].shape == out.shape == (3,)
    np.testing.assert_allclose(dump["__output__"], out, rtol=rtol, atol=atol)
