"""bf16 storage in the port's blocked attention and the bf16 model
(ModelConfig.compute_dtype="bfloat16"), on the CPU: the plain kernels and
the autograd Function on bf16 q, k, v and e against the reference Pallas
kernels run in interpret mode on the same bf16 inputs, the whole bf16
model against JAX's bf16 X2GNN (Pallas in interpret mode and the XLA
branch), and the bf16 model against the port's float32 model. The CUDA
kernels' bf16 instances run only on the card, where chip_smoke.py phase
10a holds them bitwise to the float32 instances on the widened inputs and
to these plain versions."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_attention_bwd import ARGS, DIFF, TOL, _g
from test_torch_port_blocked_attn import HC, H, K, L, _problem
from test_torch_port_model import (  # noqa: F401 (autouse fixture)
    SMALL, _graphs, one_torch_thread)
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.ops.pallas.blocked_attn import (
    expand_block_diagonal, pallas_blocked_attention)
from x2gnn_tpu.train import loss as jloss
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import ModelConfig
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.ops.blocked_attn import (
    BWD_VARIANTS, FWD_VARIANTS, blocked_attention, blocked_attention_plain)
from x2gnn_tpu_torch.train.loss import smooth_l1_loss
from x2gnn_tpu_torch.weights import export_flax_params, load_flax_params

BF16_INPUTS = ("q", "k", "v", "e_atom")
WINDOWS = [("square", None), ("rect", None), ("square", 2)]
# (mask, alpha): every instance at the square window, the plain and the
# drop+alpha instances at the others
CASES = ([(w, c, m, a) for w, c in WINDOWS[:1] for m in (False, True)
          for a in (False, True)]
         + [(w, c, m, m) for w, c in WINDOWS[1:] for m in (False, True)])


def _window(window, seed):
    return _problem(seed) if window == "square" else _problem(seed, di=6,
                                                              dk=4)


def _mask(p, seed, rate=0.3):
    N, DI, _ = p["q"].shape
    keep = np.float32(1.0 - rate)
    draw = np.random.default_rng(seed).random(
        (N, DI, p["k"].shape[1], H)) < keep
    return draw.astype(np.float32) / keep


def _jax_fn(p, mask, return_alpha, i_chunk):
    """The interpret-mode Pallas function of (q, k, v, e, w, b) and its
    primals, q, k, v and e in bf16 (the conftest's x64 leaves the rest
    float32 explicitly)."""
    j = {n: jnp.asarray(a, jnp.bfloat16 if n in BF16_INPUTS
                        else None) for n, a in p.items()}

    def f(q, k, v, e, w, b):
        return pallas_blocked_attention(
            q, k, v, e, j["rbf"], expand_block_diagonal(w, L, K, HC),
            b.reshape(1, HC), j["z"], j["a_ids"], j["b_ids"], heads=H,
            num_radial=K, interpret=True, i_chunk=i_chunk,
            dropout_mask=None if mask is None else jnp.asarray(mask),
            return_alpha=return_alpha)

    return f, [j[n] for n in DIFF]


def bf16_ulp(x):
    """One bf16 ulp of each element of x, 2^(e - 7) for 2^e <= |x| <
    2^(e+1): between 2^-8 and 2^-7 of |x|. The bf16 gradients are float32
    ones rounded once, on either side, so they may land one ulp apart."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _torch(p):
    return {n: (torch.from_numpy(a).to(torch.bfloat16) if n in BF16_INPUTS
                else torch.from_numpy(a)) for n, a in p.items()}


@pytest.mark.parametrize("window,i_chunk,masked,alpha", CASES)
def test_fwd_plain_on_bf16_matches_pallas_interpret(window, i_chunk, masked,
                                                    alpha):
    """The plain forward on bf16 q, k, v, e (widened to float32 first, as
    _fwd_kernel does at :179-182) against the Pallas kernels on the same
    bf16 inputs: out and alpha float32, within the float32 tolerances of
    test_torch_port_blocked_attn.py."""
    p = _window(window, 50)
    mask = _mask(p, 51) if masked else None
    f, primals = _jax_fn(p, mask, alpha, i_chunk)
    ref = f(*primals)
    t = _torch(p)
    got = blocked_attention_plain(
        *(t[n] for n in ARGS), heads=H, num_radial=K,
        dropout_mask=None if mask is None else torch.from_numpy(mask),
        return_alpha=alpha)
    if not alpha:
        ref, got = (ref,), (got,)
    for name, a, b in zip(("out", "alpha"), got, ref):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("window,i_chunk,masked,galpha", CASES)
def test_bwd_on_bf16_matches_pallas_interpret(window, i_chunk, masked,
                                              galpha):
    """The autograd Function's backward (the plain backward on the CPU)
    on bf16 q, k, v, e against the Pallas VJP on the same inputs: dq, dk,
    dv and de in bf16 (their primal's dtype, :719-724), compared in
    float32 within the float32 tolerances plus one bf16 ulp of each
    element (`bf16_ulp`: 2^-8 to 2^-7 of it); dW and db float32 within the
    float32 tolerances."""
    p = _window(window, 52)
    mask = _mask(p, 53) if masked else None
    g = _g(p, 54)
    f, primals = _jax_fn(p, mask, galpha, i_chunk)
    _, vjp = jax.vjp(f, *primals)
    N, DI, _ = p["q"].shape
    ga = (np.random.default_rng(55).normal(
        size=(N, DI, p["k"].shape[1], H)).astype(np.float32)
        if galpha else None)
    ref = vjp((jnp.asarray(g), jnp.asarray(ga)) if galpha
              else jnp.asarray(g))
    t = _torch(p)
    for n in DIFF:
        t[n].requires_grad_(True)
    res = blocked_attention(
        *(t[n] for n in ARGS), heads=H, num_radial=K,
        dropout_mask=None if mask is None else torch.from_numpy(mask),
        return_alpha=galpha)
    loss = ((res[0] * torch.from_numpy(g)).sum()
            + (res[1] * torch.from_numpy(ga)).sum() if galpha
            else (res * torch.from_numpy(g)).sum())
    got = torch.autograd.grad(loss, [t[n] for n in DIFF])
    for name, a, b in zip(DIFF, got, ref):
        assert a.dtype == t[name].dtype, name
        assert str(b.dtype) == ("bfloat16" if name in BF16_INPUTS
                                else "float32"), name
        a, b = a.float().numpy(), np.asarray(b, np.float32).reshape(a.shape)
        limit = TOL["atol"] + TOL["rtol"] * np.abs(b)
        if name in BF16_INPUTS:
            limit = limit + bf16_ulp(b)
        assert (np.abs(a - b) <= limit).all(), (
            name, float(np.abs(a - b).max()))


@pytest.mark.parametrize("name", BF16_INPUTS)
def test_wrapper_rejects_mixed_storage(name):
    """q, k, v and e_atom share one storage dtype (bf16 or float32); the
    geometry stays float32."""
    t = _torch(_problem(0))
    t[name] = t[name].float()
    with pytest.raises(TypeError, match="one storage dtype"):
        blocked_attention(*(t[n] for n in ARGS), heads=H, num_radial=K)
    t = _torch(_problem(0))
    t["rbf"] = t["rbf"].to(torch.bfloat16)
    with pytest.raises(TypeError, match="rbf"):
        blocked_attention(*(t[n] for n in ARGS), heads=H, num_radial=K)
    t = _torch(_problem(0))
    for n in BF16_INPUTS:
        t[n] = t[n].half()
    with pytest.raises(TypeError, match="float16"):
        blocked_attention(*(t[n] for n in ARGS), heads=H, num_radial=K)


def test_variant_names_name_the_storage():
    assert FWD_VARIANTS == ("plain", "drop", "alpha", "drop+alpha",
                            "bf16:plain", "bf16:drop", "bf16:alpha",
                            "bf16:drop+alpha")
    assert BWD_VARIANTS[4:] == ("bf16:plain", "bf16:drop", "bf16:galpha",
                                "bf16:drop+galpha")


# ---- the whole bf16 model ---------------------------------------------------

def _model_set():
    """8 small molecules, degree-tiered at batch 8, with targets."""
    graphs = _graphs(24, seed=23)
    bud = pad_budget_for(graphs, 8)
    assert bud.tiers
    targets = np.random.default_rng(62).normal(size=8).astype(np.float32)
    return graphs[:8], bud, targets


@pytest.fixture(scope="module")
def bf16_step():
    """One step of the port's bf16 model and of JAX's bf16 X2GNN with
    use_pallas True (interpret mode) and False, from the same float32
    weights, on one tiered batch: (port, {use_pallas: jax}) as (loss,
    predictions, gradients by flax path)."""
    graphs, bud, targets = _model_set()
    jb = jbatching.pad_graphs(graphs, jbatching.Budgets(*bud),
                              targets=targets, with_triplets=False)
    # the float32 parameters of a seeded port model, as a flax tree (the
    # JAX model's init would cost a compile)
    flat = export_flax_params(X2GNN(ModelConfig(**SMALL),
                                    torch.Generator().manual_seed(0),
                                    device="cpu"))
    params = {"params": {}}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = params["params"]
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = jnp.asarray(value)
    ref = {}
    for use_pallas in (True, False):
        jmodel = JaxX2GNN(JaxModelConfig(use_pallas=use_pallas,
                                         compute_dtype="bfloat16", **SMALL))

        def loss_fn(p, jmodel=jmodel):
            pred = jmodel.apply(p, jb)
            return jloss.smooth_l1_loss(pred, jb.y, mask=jb.graph_mask), pred

        (loss, pred), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        ref[use_pallas] = (float(loss), np.asarray(pred),
                           export_params_flat(grads))
    model = X2GNN(ModelConfig(compute_dtype="bfloat16", **SMALL),
                  device="cpu")
    load_flax_params(model, export_params_flat(params))
    b = pad_graphs(graphs, bud, targets=targets).to("cpu")
    assert b.tiers
    pred = model(b)
    loss = smooth_l1_loss(pred, b.y, mask=b.graph_mask)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    port = (loss.item(), pred.detach().numpy(),
            export_flax_params(model, dict(zip(names, grads))))
    return port, ref


@pytest.mark.parametrize("use_pallas", [True, False])
def test_bf16_model_matches_jax_predictions(bf16_step, use_pallas):
    """Predictions within 1e-2 of max|pred| (measured: 1.88e-05 against
    use_pallas=True, 1.85e-05 against False; the loss 6.4e-06 relative).
    Not bitwise: XLA may keep
    excess precision between a bf16 dot and its bias add, torch rounds at
    each op, so either side can land one bf16 ulp away (ROADMAP C)."""
    (loss, pred, _), ref = bf16_step
    jl, jpred, _ = ref[use_pallas]
    assert pred.dtype == np.float32
    scale = np.abs(jpred).max()
    assert np.abs(pred - jpred).max() <= 1e-2 * scale
    assert abs(loss - jl) <= 1e-2 * abs(jl)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_bf16_model_matches_jax_gradients(bf16_step, use_pallas):
    """Every parameter gradient float32 and within 2e-2 of its leaf's
    max|g| (measured against either branch: 1.83e-02 at conv_0/lin_query's
    bias, the largest, then 1.20e-02 and 9.5e-03; those are bf16 ulps of
    small bias gradients). The lin_key biases' gradient is 0 in exact
    arithmetic (a shift common to a query's scores) and bf16 rounding noise
    on both sides (measured 1.0e-05 of the largest gradient): held below
    1e-3 of it."""
    (_, _, grads), ref = bf16_step
    _, _, jgrads = ref[use_pallas]
    assert grads.keys() == jgrads.keys()
    top = max(float(np.abs(r).max()) for r in jgrads.values())
    for path, r in jgrads.items():
        got, r = grads[path], np.asarray(r)
        assert got.dtype == np.float32 and r.dtype == np.float32, path
        assert np.isfinite(got).all(), path
        if path.endswith("lin_key/Dense_0/bias"):
            assert np.abs(r).max() < 1e-3 * top, path
            assert np.abs(got).max() < 1e-3 * top, path
            continue
        assert np.abs(got - r).max() <= 2e-2 * np.abs(r).max(), path


def test_bf16_model_close_to_float32():
    """The port's bf16 model against its float32 model on the same
    weights, within atol 0.05 of the scale, as tests/test_bf16.py holds
    JAX's; parameters and their gradients float32 and finite."""
    graphs, bud, targets = _model_set()
    b = pad_graphs(graphs, bud, targets=targets).to("cpu")
    m32 = X2GNN(ModelConfig(**SMALL), torch.Generator().manual_seed(0),
                device="cpu")
    m16 = X2GNN(ModelConfig(compute_dtype="bfloat16", **SMALL),
                device="cpu")
    m16.load_state_dict(m32.state_dict())
    with torch.no_grad():
        out32 = m32(b).numpy()
    out16 = m16(b)
    assert out16.dtype == torch.float32
    scale = max(np.abs(out32).max(), 1.0)
    np.testing.assert_allclose(out16.detach().numpy() / scale, out32 / scale,
                               atol=0.05)
    assert not np.array_equal(out16.detach().numpy(), out32)
    grads = torch.autograd.grad((out16 ** 2).sum(), list(m16.parameters()))
    for p, g in zip(m16.parameters(), grads):
        assert p.dtype == g.dtype == torch.float32
        assert torch.isfinite(g).all()


def test_bf16_conv_runs_its_projections_in_bf16():
    """lin_rbf, lin_query, lin_edge, lin_key and lin_value compute in
    bf16 (the reference's dtype= layers, nn/conv.py:232-270); lin_skip and
    lin_sbf stay float32, and so does the conv's output."""
    model = X2GNN(ModelConfig(compute_dtype="bfloat16", **SMALL),
                  device="cpu")
    conv = model.conv_0
    for name in ("lin_rbf", "lin_query", "lin_edge", "lin_key",
                 "lin_value"):
        assert getattr(conv, name).dtype == torch.bfloat16, name
        x = torch.ones(3, getattr(conv, name).weight.shape[1])
        assert getattr(conv, name)(x).dtype == torch.bfloat16, name
    assert conv.lin_skip.dtype is None
    assert all(p.dtype == torch.float32 for p in model.parameters())
    graphs, bud, _ = _model_set()
    seen = []
    real = blocked_attention

    def spy(*args, **kw):
        seen.append(tuple(a.dtype for a in args[:4]))
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        import x2gnn_tpu_torch.nn.conv as conv_mod
        mp.setattr(conv_mod, "blocked_attention", spy)
        with torch.no_grad():
            out = model(pad_graphs(graphs, bud).to("cpu"))
    assert out.dtype == torch.float32
    assert seen and all(s == (torch.bfloat16,) * 4 for s in seen)
    assert len(seen) == SMALL["conv_layers"] * len(bud.tiers)


def test_from_run_serves_a_bf16_run(tmp_path, capsys):
    """A bf16 run's args.json loads through Predictor.from_run and serves
    float32 predictions with the bf16 conv stack; the evaluate CLI on the
    run gives the MAE of those predictions."""
    from x2gnn_tpu_torch.config import TrainConfig, dump_configs
    from x2gnn_tpu_torch.infer import Predictor
    from x2gnn_tpu_torch.train.checkpoint import save_checkpoint
    from x2gnn_tpu_torch.train.ema import ema_init
    from x2gnn_tpu_torch.train.optim import Optimizer
    from x2gnn_tpu_torch.train.trainer import TrainState
    cfg = ModelConfig(compute_dtype="bfloat16", **SMALL)
    model = X2GNN(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = list(model.parameters())
    zero = torch.zeros((), dtype=torch.int32)
    save_checkpoint(str(tmp_path / "ckpt_best.pt"), TrainState(
        params, Optimizer(TrainConfig()).init(params), ema_init(params),
        zero, zero))
    dump_configs(cfg, TrainConfig(), str(tmp_path / "args.json"))
    pred = Predictor.from_run(str(tmp_path), device="cpu")
    assert pred.model.config.compute_dtype == "bfloat16"
    graphs = _graphs(6, seed=64)
    got = pred.predict(graphs)
    ref = Predictor(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                    model, device="cpu").predict(graphs)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)
    from x2gnn_tpu_torch.evaluate import main as evaluate_main
    capsys.readouterr()
    assert evaluate_main(["--ckpt", str(tmp_path / "ckpt_best.pt"),
                          "--synthetic", "6", "--batch-size", "3",
                          "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    graphs = synthetic_dataset(6, cutoff=cfg.cutoff,
                               edge_feat_dim=cfg.edge_feat_dim)
    want = Predictor.from_run(str(tmp_path), batch_size=3,
                              device="cpu").predict(graphs)
    assert out["count"] == 6
    np.testing.assert_allclose(
        out["mae"], np.abs(want - np.array([g.y[0] for g in graphs])).mean(),
        rtol=1e-5)
