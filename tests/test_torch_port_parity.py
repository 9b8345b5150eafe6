"""The port's per-layer parity harness (x2gnn_tpu_torch/utils/parity.py):
dumps repeat and compare, a perturbed parameter is caught, parameters
round-trip, and the port's per-layer dump against the JAX package's
(x2gnn_tpu/utils/parity.py) on the same weights and batch in every layout
and variant, with the table of keys that differ by design held exact."""

import re

import numpy as np
import jax
import pytest
import torch
from torch import nn

from test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.utils import parity as jparity
from x2gnn_tpu_torch.config import ModelConfig
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.models.x2gnn import X2GNN, needs_triplets
from x2gnn_tpu_torch.utils.parity import (
    BY_DESIGN, by_design, compare_dumps, dump_activations,
    export_params_flat, is_dense_twin)
from x2gnn_tpu_torch.weights import load_flax_params

# small widths; embedding_size != in_channels, so a v1/v2 mix-up of the
# edge attributes' width would not load
SMALL = dict(conv_layers=2, in_channels=32, embedding_size=16, heads=4,
             sbf_dim=7, rbf_dim=6, edge_feat_dim=8)
# compare_dumps' defaults (rtol 1e-4, atol 1e-5) in float32; in bf16 each
# entry within 1e-2 of its largest magnitude (the conv's projections
# round to bf16 at other places in XLA's and torch's GEMMs)
BF16_SCALE = 1e-2


def _graphs(seed=8):
    graphs = synthetic_dataset(3, mean_atoms=7, seed=seed, edge_feat_dim=8,
                               target="random")
    rng = np.random.default_rng(seed)
    for g in graphs:
        g.edge_feat[:] = rng.uniform(0.0, 1.0, g.edge_feat.shape)
    return graphs


def _port(cfg, seed=0):
    return X2GNN(cfg, torch.Generator().manual_seed(seed), device="cpu")


def _batch(cfg, graphs):
    return pad_graphs(graphs, pad_budget_for(graphs, 3),
                      with_triplets=needs_triplets(cfg)).to("cpu")


def test_dump_twice_compares_ok(tmp_path):
    cfg = ModelConfig(attention_layout="blocked", **SMALL)
    model, batch = _port(cfg), _batch(cfg, _graphs())
    path = str(tmp_path / "a.npz")
    first = dump_activations(model, batch, path)
    second = dump_activations(model, batch)
    cmp = compare_dumps(path, second)
    assert cmp.ok and not cmp.only_a and not cmp.only_b
    assert len(cmp.entries) == len(first)
    for key, value in first.items():
        np.testing.assert_array_equal(value, second[key], err_msg=key)
        assert value.dtype != np.float64, key
    for key in ("__call__", "__output__", "conv_0/__call__",
                "conv_1/lin_query/__call__", "norm_1/__call__",
                "readout_2/mlp/mlp_out/__call__", "emb_block/lin/__call__"):
        assert key in first, key
    assert not any(is_dense_twin(k) for k in first)
    np.testing.assert_array_equal(first["__call__"], first["__output__"])
    assert first["conv_0/__call__"].shape == batch.in_edges.shape + (32,)
    assert model.training     # the dump restores the module's mode


def test_perturbed_parameter_is_caught():
    """Perturbing conv_1's query projection changes its output and
    everything after it, and nothing before it."""
    cfg = ModelConfig(attention_layout="blocked", **SMALL)
    model, batch = _port(cfg), _batch(cfg, _graphs())
    ref = dump_activations(model, batch)
    with torch.no_grad():
        model.conv_1.lin_query.weight.add_(0.1)
    cmp = compare_dumps(dump_activations(model, batch), ref)
    failed = {k for k, _, _ in cmp.failed()}
    for key in ("conv_1/lin_query/__call__", "conv_1/__call__",
                "norm_1/__call__", "readout_2/__call__", "__output__"):
        assert key in failed, key
    for key in ("conv_0/__call__", "norm_0/__call__", "readout_1/__call__",
                "conv_1/lin_key/__call__", "mat_trans/__call__"):
        assert key not in failed, key


def test_repeated_calls_and_tuple_outputs_get_indexed_keys():
    """A module called twice gets one entry per call (.0, .1), in order,
    and a tuple output one per member, as flax's capture_intermediates
    records them."""
    class Twice(nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(3, 3)

        def forward(self, x):
            return self.lin(x), self.lin(2 * x)

    model = Twice()
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    dump = dump_activations(model, x)
    assert set(dump) == {"lin/__call__.0", "lin/__call__.1", "__call__.0",
                         "__call__.1", "__output__.0", "__output__.1"}
    with torch.no_grad():
        np.testing.assert_array_equal(dump["lin/__call__.1"],
                                      model.lin(2 * x).numpy())


def test_compare_dumps_reports_shapes_and_missing_keys():
    a = {"x": np.ones(3, np.float32), "y": np.zeros(2, np.float32),
         "only_a": np.ones(1, np.float32)}
    b = {"x": np.ones(3, np.float32) * (1 + 1e-6),
         "y": np.zeros(3, np.float32), "only_b": np.ones(1, np.float32)}
    cmp = compare_dumps(a, b)
    assert cmp.entries[0][0] == "x" and cmp.entries[0][2]
    assert cmp.entries[1] == ("y", float("inf"), False)
    assert cmp.only_a == ["only_a"] and cmp.only_b == ["only_b"]
    assert not cmp.ok
    # max_scale: a tolerance relative to the entry's largest magnitude
    big = {"x": np.array([100.0, 1.0], np.float32)}
    off = {"x": np.array([100.0, 1.5], np.float32)}
    assert not compare_dumps(off, big).ok
    assert compare_dumps(off, big, rtol=0, atol=0, max_scale=1e-2).ok


def test_export_params_flat_round_trips():
    """export_params_flat gives the JAX tree's paths; load_flax_params
    reads it back into another model bit for bit."""
    cfg = ModelConfig(attention_layout="blocked", **SMALL)
    model = _port(cfg, seed=0)
    flat = export_params_flat(model)
    other = _port(cfg, seed=1)
    load_flax_params(other, flat)
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 other.named_parameters()):
        assert torch.equal(p, q), name
    jb = jbatching.pad_graphs(_graphs(), jbatching.pad_budget_for(
        _graphs(), 3), with_triplets=False)
    jparams = JaxX2GNN(JaxModelConfig(
        use_pallas=False, attention_layout="blocked", **SMALL)).init(
            jax.random.PRNGKey(0), jb)
    jflat = jparity.export_params_flat(jparams)
    assert flat.keys() == jflat.keys()
    for key, value in flat.items():
        assert value.shape == np.shape(jflat[key]), key
        assert value.dtype == np.float32, key


# (case, model fields, use_pallas of the JAX side); None in the flat
# layouts, which reach no Pallas kernel
CASES = {
    "blocked_pallas": (dict(attention_layout="blocked"), True),
    "blocked_xla": (dict(attention_layout="blocked"), False),
    "v2_beta": (dict(attention_layout="blocked", variant="v2", beta=True),
                True),
    "segment": (dict(attention_layout="segment"), None),
    "padded": (dict(attention_layout="padded"), None),
    "segment_v2_beta": (dict(attention_layout="segment", variant="v2",
                             beta=True), None),
    "molwise_mean": (dict(attention_layout="blocked",
                          readout="molwise_mean"), True),
    "bf16": (dict(attention_layout="blocked", compute_dtype="bfloat16"),
             True),
}


def _load_jax_dump(path):
    """A JAX dump as float32: its bf16 entries were saved as ml_dtypes'
    bfloat16, which np.load reads back as raw 2-byte records."""
    import ml_dtypes
    out = {}
    with np.load(path) as f:
        for key in f.files:
            v = f[key]
            if v.dtype.kind == "V" and v.dtype.itemsize == 2:
                v = v.view(ml_dtypes.bfloat16)
            out[key] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """{case: (port dump, JAX dump, port config, JAX batch)} of one batch
    and one set of weights (the port's, through export_params_flat)."""
    graphs = _graphs()
    out = {}
    for case, (fields, use_pallas) in CASES.items():
        cfg = ModelConfig(**SMALL, **fields)
        model = _port(cfg)
        jcfg = JaxModelConfig(use_pallas=use_pallas, **SMALL, **fields)
        jb = jbatching.pad_graphs(graphs, jbatching.pad_budget_for(
            graphs, 3), with_triplets=needs_triplets(cfg))
        jmodel = JaxX2GNN(jcfg)
        params = {"params": jax.tree_util.tree_map(
            np.asarray, _nest(export_params_flat(model)))}
        path = str(tmp_path_factory.mktemp(case) / "jax.npz")
        jparity.dump_activations(jmodel, params, jb, path)
        out[case] = (dump_activations(model, _batch(cfg, graphs)),
                     _load_jax_dump(path), cfg, jb)
    return out


def _nest(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _compare(case, port, ref):
    if CASES[case][0].get("compute_dtype") == "bfloat16":
        return compare_dumps(port, ref, rtol=0.0, atol=0.0,
                             max_scale=BF16_SCALE)
    return compare_dumps(port, ref)


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_jax_per_layer(dumps, case):
    """Every entry both dumps have, outside the by-design table, within
    compare_dumps' defaults (bf16: 1e-2 of its largest magnitude)."""
    port, ref, cfg, _ = dumps[case]
    cmp = _compare(case, port, ref)
    expected = by_design(cfg)
    bad = [(k, e) for k, e, ok in cmp.entries if not ok and k not in expected]
    assert not bad, bad
    compared = {k for k, _, _ in cmp.entries} - set(expected)
    # every module of the model, the output and the model's own entry
    assert len(compared) > 50, sorted(compared)
    assert {"__output__", "__call__", "conv_1/__call__",
            "readout_2/__call__"} <= compared


@pytest.mark.parametrize("case", list(CASES))
def test_by_design_table_is_exact(dumps, case):
    """The keys that do not compare (missing from one dump, another shape,
    a value off) are exactly the table's for the configuration, once the
    reference's Dense_0 twins are set aside: a key missing without an
    entry fails, and so does an entry that no longer applies."""
    port, ref, cfg, _ = dumps[case]
    cmp = _compare(case, port, ref)
    assert not cmp.only_a     # the port writes no key the reference lacks
    differing = ({k for k, _, ok in cmp.entries if not ok}
                 | {k for k in cmp.only_b if not is_dense_twin(k)})
    assert differing == set(by_design(cfg))
    twins = [k for k in cmp.only_b if is_dense_twin(k)]
    for key in twins:
        wrapper = key.replace("/Dense_0", "")
        assert wrapper in port or wrapper in by_design(cfg), key
        np.testing.assert_array_equal(ref[key], ref[wrapper], err_msg=key)


def test_by_design_table_lists_each_key_once_with_a_reason():
    keys = [key for key, _, _ in BY_DESIGN]
    assert len(keys) == len(set(keys))
    assert all(reason for _, _, reason in BY_DESIGN)
    union = set()
    for fields, _ in CASES.values():
        union |= {re.sub(r"^conv_\d+/", "conv_{i}/", k)
                  for k in by_design(ModelConfig(**SMALL, **fields))}
    assert union == set(keys)


@pytest.mark.parametrize("case", ["segment", "padded", "segment_v2_beta"])
def test_by_design_keys_agree_where_they_are_defined(dumps, case):
    """The flat layouts' by-design keys on the rows both sides compute:
    lin_edge on real triplets, and in v1 the edge MLP per atom gathered at
    each real triplet's media atom against the reference's per-triplet
    rows."""
    port, ref, cfg, jb = dumps[case]
    real = np.asarray(jb.trip_mask)
    trip_j = np.asarray(jb.trip_j)
    for i in range(cfg.conv_layers):
        key = f"conv_{i}/lin_edge/__call__"
        np.testing.assert_allclose(port[key][real], ref[key][real],
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    if cfg.variant == "v1":
        for key in ("edgenn_0/__call__", "edgenn_1/__call__"):
            np.testing.assert_allclose(port[key][trip_j[real]],
                                       ref[key][real], rtol=1e-4, atol=1e-5,
                                       err_msg=key)
