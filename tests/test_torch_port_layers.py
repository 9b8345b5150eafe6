"""The port's nn blocks against the flax modules of the JAX package, with
weights carried by load_flax_params, and the port's initializers."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from x2gnn_tpu.nn.layers import EmbeddingBlock as FlaxEmbeddingBlock
from x2gnn_tpu.nn.norm import GraphLayerNorm as FlaxGraphLayerNorm
from x2gnn_tpu.nn.readout import AtomWiseReadout as FlaxAtomWiseReadout
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.nn.init import glorot_orthogonal_, torch_linear_
from x2gnn_tpu_torch.nn.layers import Dense, EmbeddingBlock
from x2gnn_tpu_torch.nn.norm import GraphLayerNorm
from x2gnn_tpu_torch.nn.readout import AtomWiseReadout
from x2gnn_tpu_torch.weights import load_flax_params

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(t):
    return t.detach().numpy()


def test_graph_layer_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, size=(20, 8)).astype(np.float32)
    gid = np.repeat(np.arange(4), 5).astype(np.int32)
    mask = rng.uniform(size=20) > 0.2
    ref = np.asarray(FlaxGraphLayerNorm().apply(
        {}, jnp.asarray(x), jnp.asarray(gid), 4, mask=jnp.asarray(mask)))
    got = GraphLayerNorm()(torch.from_numpy(x),
                           torch.from_numpy(gid).long(), 4,
                           mask=torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), ref, **TOL)


def test_embedding_block_renorms_inside_the_forward():
    numbers = np.array([0, 1, 6, 7, 8, 9, 6, 1], np.int32)
    flax_mod = FlaxEmbeddingBlock(16)
    params = flax_mod.init(jax.random.PRNGKey(1), jnp.asarray(numbers))
    # N(0,1) rows of width 16 have norms ~4 > max_norm 3: the renorm bites
    ref = np.asarray(flax_mod.apply(params, jnp.asarray(numbers)))
    port = EmbeddingBlock(16)
    load_flax_params(port, export_params_flat(params))
    before = _np(port.embedding).copy()
    got = _np(port(torch.from_numpy(numbers).long()))
    np.testing.assert_allclose(got, ref, **TOL)
    # the table itself is never renormed in place (unlike torch max_norm)
    np.testing.assert_array_equal(_np(port.embedding), before)


@pytest.mark.parametrize("use_aggregate", [False, True])
def test_atomwise_readout(use_aggregate):
    rng = np.random.default_rng(2)
    E, Cc, Kr, n_atoms = 12, 16, 6, 5
    x = rng.normal(size=(E, Cc)).astype(np.float32)
    rbf = rng.normal(size=(E, Kr)).astype(np.float32)
    src = rng.integers(0, n_atoms, size=E).astype(np.int32)
    mask = np.arange(E) < 10
    flax_mod = FlaxAtomWiseReadout(Cc)
    args = (jnp.asarray(x), jnp.asarray(rbf), jnp.asarray(src), n_atoms)
    params = flax_mod.init(jax.random.PRNGKey(2), *args,
                           edge_mask=jnp.asarray(mask))
    onehot = (src[None, :] == np.arange(n_atoms)[:, None]) & mask[None]
    agg_j = agg_t = None
    if use_aggregate:
        m = onehot.astype(np.float32)
        agg_j = lambda g: jnp.asarray(m) @ g                  # noqa: E731
        agg_t = lambda g: torch.from_numpy(m) @ g              # noqa: E731
    ref = np.asarray(flax_mod.apply(params, *args,
                                    edge_mask=jnp.asarray(mask),
                                    aggregate=agg_j))
    port = AtomWiseReadout(Cc, Kr)
    load_flax_params(port, export_params_flat(params))
    got = port(torch.from_numpy(x), torch.from_numpy(rbf),
               torch.from_numpy(src).long(), n_atoms,
               edge_mask=torch.from_numpy(mask), aggregate=agg_t)
    assert tuple(got.shape) == (n_atoms, 1)
    np.testing.assert_allclose(_np(got), ref, **TOL)


@pytest.mark.parametrize("shape", [(32, 8), (8, 32), (16, 16)])
def test_glorot_orthogonal_statistics(shape):
    w = torch.empty(*shape)
    glorot_orthogonal_(w, scale=2.0,
                       generator=torch.Generator().manual_seed(0))
    var = float(torch.var(w))
    assert var * (shape[0] + shape[1]) == pytest.approx(2.0, rel=1e-5)
    # orthogonal up to the common scale
    small = w if shape[0] <= shape[1] else w.T
    gram = _np(small @ small.T)
    np.testing.assert_allclose(gram / gram[0, 0], np.eye(gram.shape[0]),
                               atol=1e-5)


def test_init_is_driven_by_the_generator():
    def make(seed):
        return _np(Dense(8, 4, generator=torch.Generator().manual_seed(seed))
                   .weight)
    np.testing.assert_array_equal(make(3), make(3))
    assert not np.array_equal(make(3), make(4))
    w, b = torch.empty(64, 25), torch.empty(64)
    torch_linear_(w, b, torch.Generator().manual_seed(0))
    assert float(w.abs().max()) <= 0.2 and float(b.abs().max()) <= 0.2
    assert float(w.abs().max()) > 0.18
    emb = EmbeddingBlock(8, generator=torch.Generator().manual_seed(0))
    assert float(emb.embedding.detach()[0].abs().max()) == 0.0
