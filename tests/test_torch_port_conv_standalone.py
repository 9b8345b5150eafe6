"""The flat EdgeAttentionConv's two standalone branches against the JAX
conv (x2gnn_tpu/nn/conv.py) on the CPU: the `attention_fn` override
(:69, :116-125) and its refusal of dropout, and the iid keep mask drawn
when no pair-space mask is handed in (:138-143 padded, :162-165
segment)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_layouts import _conv_problem, _flax_tree, _tables
from test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)
from x2gnn_tpu.nn.conv import EdgeAttentionConv as JaxEdgeAttentionConv
from x2gnn_tpu.ops import attention as jattention
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.nn.conv import EdgeAttentionConv
from x2gnn_tpu_torch.ops import attention
from x2gnn_tpu_torch.weights import export_flax_params

RATE = 0.3
# float32 through the same projections and a softmax in other orders,
# as tests/test_torch_port_layouts.py holds the flat conv: values 1e-5 +
# 1e-5 of their largest magnitude, parameter gradients 1e-3 + 1e-4
OUT_RTOL, OUT_ATOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5, 1e-3, 1e-4


def torch_segment_override(q, k, v, e, s, trip_src, trip_dst, trip_mask,
                           num_edges):
    """The segment attention with the override's signature, written with
    scatters (no table): softmax of q[dst].(k[src] + e) / sqrt(C) over
    each destination edge's real triplets, messages (v[src] + e) * s."""
    H, C = q.shape[1], q.shape[2]
    mask = trip_mask[:, None]
    alpha = (q[trip_dst] * (k[trip_src] + e)).sum(-1) / math.sqrt(C)
    alpha = torch.where(mask, alpha, -1e30)
    idx = trip_dst[:, None].expand(-1, H)
    amax = torch.full((num_edges, H), -1e30).scatter_reduce(
        0, idx, alpha.detach(), "amax")
    ex = torch.where(mask, torch.exp(alpha - amax[trip_dst]), 0.0)
    den = torch.zeros(num_edges, H).index_add(0, trip_dst, ex)
    w = ex / den[trip_dst].clamp_min(1e-16)
    msg = (v[trip_src] + e) * s * w[..., None]
    return torch.zeros(num_edges, H, C).index_add(0, trip_dst, msg)


def _jax_conv(layout, rate, problem, attention_fn=None):
    """The JAX conv, its positional and keyword arguments (no pair-space
    dropout positions: the standalone use)."""
    pb, jb, inputs = problem
    jconv = JaxEdgeAttentionConv(32, 4, rate, layout=layout,
                                 attention_fn=attention_fn)
    jargs = [jnp.asarray(a) for a in inputs] + [
        jnp.asarray(jb.trip_src_edge), jnp.asarray(jb.trip_dst_edge)]
    jkw = dict(trip_mask=jnp.asarray(jb.trip_mask),
               nbr_trip=jnp.asarray(jb.nbr_trip),
               nbr_src=jnp.asarray(jb.nbr_src),
               nbr_mask=jnp.asarray(jb.nbr_mask))
    return jconv, jargs, jkw


def _port_conv(layout, rate, attention_fn=None):
    return EdgeAttentionConv(32, 4, layout=layout, sbf_l=7, sbf_k=6,
                             rbf_dim=6, emb_dim=16, dropout=rate,
                             attention_fn=attention_fn,
                             generator=torch.Generator().manual_seed(0))


def _held(conv, out, jout, jgrads, w):
    """The port's output and parameter gradients against the JAX conv's."""
    names = [n for n, _ in conv.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(w).float()).sum(),
                                list(conv.parameters()))
    ref = np.asarray(jout)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=OUT_RTOL,
                               atol=OUT_ATOL * np.abs(ref).max())
    got = export_flax_params(conv, dict(zip(names, grads)))
    want = export_params_flat(jgrads)
    assert got.keys() == want.keys()
    for path, r in want.items():
        if path.endswith("lin_key/Dense_0/bias"):
            continue      # ~0 in both: the softmax ignores a key shift
        np.testing.assert_allclose(got[path], r, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(r).max(),
                                   err_msg=path)


def _jax_value_and_grads(jconv, params, jargs, jkw, w, deterministic):
    def jloss(p):
        out = jconv.apply(p, *jargs, **jkw, deterministic=deterministic,
                          rngs={"dropout": jax.random.PRNGKey(1)})
        return (out * w).sum(), out
    (_, out), grads = jax.value_and_grad(jloss, has_aux=True)(params)
    return out, grads


@pytest.mark.parametrize("layout", ["segment", "padded"])
def test_attention_fn_override_matches_reference(layout):
    """An override computing the segment attention replaces either
    layout's attention: the port's conv with a scatter version of it
    against the JAX conv with the JAX package's segment_attention, on the
    same weights; values and parameter gradients. The override sees the
    batch's triplet ids and its edge count."""
    problem = _conv_problem(21)
    pb, _, inputs = problem
    calls = []

    def counted(*args):
        calls.append([a.shape if torch.is_tensor(a) else a for a in args])
        return torch_segment_override(*args)

    conv = _port_conv(layout, 0.0, counted)
    jconv, jargs, jkw = _jax_conv(layout, 0.0, problem,
                                  jattention.segment_attention)
    w = np.random.default_rng(22).normal(size=(pb.edge_mask.shape[0], 32))
    jout, jgrads = _jax_value_and_grads(jconv, _flax_tree(conv), jargs, jkw,
                                        w, True)
    b = pb.to("cpu")
    out = conv(*[torch.from_numpy(a) for a in inputs], _tables(b))
    E, T = b.edge_mask.shape[0], b.trip_mask.shape[0]
    assert calls == [[(E, 4, 8)] * 3 + [(T, 4, 8)] * 2 + [(T,)] * 3 + [E]]
    _held(conv, out, jout, jgrads, w)
    # the override is what ran: the built-in attention gives the same
    # function, within the same tolerance
    plain = _port_conv(layout, 0.0)
    plain.load_state_dict(conv.state_dict())
    ref = plain(*[torch.from_numpy(a) for a in inputs],
                _tables(b)).detach()
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(),
                               rtol=OUT_RTOL,
                               atol=OUT_ATOL * float(ref.abs().max()))


def test_attention_fn_override_refuses_dropout():
    """Dropout with an override raises in both packages (the override
    takes no mask); without dropout, or deterministic, it runs."""
    problem = _conv_problem(23)
    pb, _, inputs = problem
    b = pb.to("cpu")
    args = [torch.from_numpy(a) for a in inputs] + [_tables(b)]
    conv = _port_conv("segment", RATE, torch_segment_override)
    with pytest.raises(NotImplementedError, match="attention_fn"):
        conv(*args, deterministic=False,
             generator=torch.Generator().manual_seed(1))
    N, D = pb.in_edges.shape
    with pytest.raises(NotImplementedError, match="attention_fn"):
        conv(*args, dropout_mask=torch.ones(N, D, D, 4),
             drop_pair_pos=torch.zeros(b.trip_mask.shape[0],
                                       dtype=torch.long))
    with pytest.raises(ValueError, match="segment layout"):
        conv(*args, return_attention_weights=True)
    assert conv(*args).shape == (b.edge_mask.shape[0], 32)
    jconv, jargs, jkw = _jax_conv("segment", RATE, problem,
                                  jattention.segment_attention)
    params = _flax_tree(conv)
    with pytest.raises(NotImplementedError, match="attention_fn"):
        jconv.apply(params, *jargs, **jkw, deterministic=False,
                    rngs={"dropout": jax.random.PRNGKey(1)})
    jconv.apply(params, *jargs, **jkw, deterministic=True)


@pytest.mark.parametrize("layout", ["segment", "padded"])
def test_iid_dropout_matches_reference_under_one_keep_pattern(
        layout, monkeypatch):
    """The standalone draw: the port's conv with deterministic=False and
    no pair-space mask against the JAX conv's iid branch, whose bernoulli
    draw is replaced by the port's keep pattern from the same generator
    seed; values and parameter gradients."""
    problem = _conv_problem(25)
    pb, _, inputs = problem
    b = pb.to("cpu")
    tables = _tables(b)
    valid = tables.trip_mask if layout == "segment" else tables.nbr_mask
    mask = attention.iid_dropout_mask(torch.Generator().manual_seed(9),
                                      RATE, valid, 4)
    keep = jnp.asarray((mask > 0).numpy())
    shapes = []

    def bernoulli(key, p=0.5, shape=None):
        shapes.append((float(p), tuple(shape)))
        return keep
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    conv = _port_conv(layout, RATE)
    jconv, jargs, jkw = _jax_conv(layout, RATE, problem)
    w = np.random.default_rng(26).normal(size=(pb.edge_mask.shape[0], 32))
    jout, jgrads = _jax_value_and_grads(jconv, _flax_tree(conv), jargs, jkw,
                                        w, False)
    assert shapes == [(pytest.approx(1.0 - RATE), tuple(mask.shape))]
    out = conv(*[torch.from_numpy(a) for a in inputs], tables,
               deterministic=False,
               generator=torch.Generator().manual_seed(9))
    _held(conv, out, jout, jgrads, w)
    # and the draw dropped something: the deterministic output differs
    same = conv(*[torch.from_numpy(a) for a in inputs], tables)
    assert not torch.equal(out, same)


@pytest.mark.parametrize("shape", [(20000,), (2500, 8)])
def test_iid_dropout_mask_keeps_scales_repeats_and_masks(shape):
    """Per triplet (T,) or per neighbour slot (E, D), H heads: the share
    kept among valid rows within 5 sigma of the binomial's mean, every
    kept value exactly 1/(1 - rate) in float32, zero at every invalid row,
    the same bits from one generator seed and other bits from another."""
    rng = np.random.default_rng(27)
    valid = torch.from_numpy(rng.random(shape) < 0.8)
    H = 4
    mask = attention.iid_dropout_mask(torch.Generator().manual_seed(3),
                                      RATE, valid, H)
    assert mask.shape == shape + (H,) and mask.dtype == torch.float32
    assert (mask[~valid] == 0).all()
    kept = mask[valid]
    n = kept.numel()
    share = float((kept > 0).float().mean())
    sigma = math.sqrt(RATE * (1 - RATE) / n)
    assert abs(share - (1 - RATE)) < 5 * sigma, (share, sigma)
    scale = torch.tensor(1.0) / torch.tensor(1.0 - RATE)
    assert set(kept.unique().tolist()) == {0.0, float(scale)}
    again = attention.iid_dropout_mask(torch.Generator().manual_seed(3),
                                       RATE, valid, H)
    assert torch.equal(mask, again)
    other = attention.iid_dropout_mask(torch.Generator().manual_seed(4),
                                       RATE, valid, H)
    assert not torch.equal(mask, other)


@pytest.mark.parametrize("layout", ["segment", "padded"])
def test_iid_dropout_conv_repeats_from_one_seed(layout):
    """The conv's own draw: bitwise the same output from one generator
    seed, another from another seed; the model's path (a handed-in mask)
    and a deterministic call draw nothing."""
    pb, _, inputs = _conv_problem(29)
    b = pb.to("cpu")
    args = [torch.from_numpy(a) for a in inputs] + [_tables(b)]
    conv = _port_conv(layout, RATE)

    def drawn(seed):
        return conv(*args, deterministic=False,
                    generator=torch.Generator().manual_seed(seed))
    assert torch.equal(drawn(5), drawn(5))
    assert not torch.equal(drawn(5), drawn(6))
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    conv(*args, generator=g)
    N, D = pb.in_edges.shape
    pos = torch.zeros(b.trip_mask.shape[0], dtype=torch.long)
    conv(*args, dropout_mask=torch.ones(N, D, D, 4), drop_pair_pos=pos,
         deterministic=False, generator=g)
    assert torch.equal(g.get_state(), state)
