"""The port's fixed-order segment sum against `jax.ops.segment_sum`
(x2gnn_tpu/ops/segment.py), values and gradients, and the port's
run-to-run determinism checks against x2gnn_tpu/utils/determinism.py, on
the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_model import (  # noqa: F401 (autouse fixture)
    SMALL, _graphs, one_torch_thread)
from x2gnn_tpu.ops.segment import segment_sum as jsegment_sum
from x2gnn_tpu.utils import determinism as jdet
from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.ops import segment as segment_mod
from x2gnn_tpu_torch.ops.segment import segment_sum
from x2gnn_tpu_torch.train.trainer import Trainer
from x2gnn_tpu_torch.utils.determinism import (
    check_determinism, check_train_step_determinism, copy_tree,
    tree_bitwise_diff)


def _problem(feature_shape, masked, seed):
    """40 rows into 7 segments: unsorted ids, segments 2 and 5 empty, one
    row with an id past the last segment (dropped by JAX), and with
    `masked` a mask that drops a quarter of the rows, some of them NaN."""
    rng = np.random.default_rng(seed)
    ids = rng.choice([0, 1, 3, 4, 6], size=40)
    ids[7] = 7
    data = rng.normal(size=(40,) + feature_shape).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random(40) > 0.25
        mask[7] = True
        data[np.flatnonzero(~mask)[:2]] = np.nan
    return data, ids, mask


@pytest.mark.parametrize("feature_shape", [(), (5,), (3, 4)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("block", [None, 100])
def test_segment_sum_matches_jax(monkeypatch, feature_shape, masked, block):
    """Values within rtol 1e-6 (float32 sums of <= 40 terms in other
    orders) and the gradient of a weighted sum, which is a gather of the
    cotangent: equal to JAX's bitwise but for the masked rows' zeros.
    With `block`, the selects run a few segments at a time."""
    if block is not None:
        monkeypatch.setattr(segment_mod, "_BLOCK", block)
    data, ids, mask = _problem(feature_shape, masked, seed=len(feature_shape))
    w = np.random.default_rng(9).normal(
        size=(7,) + feature_shape).astype(np.float32)

    def jloss(d):
        out = jsegment_sum(d, jnp.asarray(ids), 7,
                           None if mask is None else jnp.asarray(mask))
        return (out * w).sum(), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(data))
    d = torch.from_numpy(data).requires_grad_()
    out = segment_sum(d, torch.from_numpy(ids), 7,
                      None if mask is None else torch.from_numpy(mask))
    (grad,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), d)
    assert out.shape == (7,) + feature_shape
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    assert (out[[2, 5]] == 0).all()
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=0)
    again = segment_sum(d, torch.from_numpy(ids), 7,
                        None if mask is None else torch.from_numpy(mask))
    assert torch.equal(out, again)


@pytest.mark.parametrize("feature_shape", [(), (5,)])
@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_segment_sum_keeps_non_finite_rows_in_their_segment(feature_shape,
                                                            bad):
    """A NaN or inf in one unmasked row spoils its own segment's sum only,
    as in JAX (rtol 1e-6 elsewhere, the same non-finite value there); a
    NaN cotangent of one segment reaches that segment's rows only, equal
    to JAX's gradient (rtol 1e-6, NaN where JAX has NaN)."""
    data, ids, mask = _problem(feature_shape, True, seed=3)
    row = int(np.flatnonzero(mask & (ids == 3))[0])
    data[row] = bad
    w = np.ones((7,) + feature_shape, np.float32)
    w[1] = np.nan

    def jloss(d):
        out = jsegment_sum(d, jnp.asarray(ids), 7, jnp.asarray(mask))
        return (out * w).sum(), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(data))
    d = torch.from_numpy(data).requires_grad_()
    out = segment_sum(d, torch.from_numpy(ids), 7, torch.from_numpy(mask))
    (grad,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), d)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    finite = np.isfinite(out.detach().numpy())
    assert (finite.reshape(7, -1).all(1) == (np.arange(7) != 3)).all()
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=0)
    nan_rows = np.isnan(grad.numpy()).reshape(40, -1).any(1)
    assert (nan_rows == (mask & (ids == 1))).all()


def test_bitwise_diff_names_the_leaf_as_jax_does():
    a = {"w": np.ones((4, 4), np.float32), "b": np.zeros(3, np.float32)}
    b = {"w": np.ones((4, 4), np.float32),
         "b": np.array([0, 1e-12, 0], np.float32)}
    got = tree_bitwise_diff({k: torch.from_numpy(v) for k, v in a.items()},
                            {k: torch.from_numpy(v) for k, v in b.items()})
    want = jdet.tree_bitwise_diff({k: jnp.asarray(v) for k, v in a.items()},
                                  {k: jnp.asarray(v) for k, v in b.items()})
    assert got == want and len(got) == 1 and "'b'" in got[0]
    assert tree_bitwise_diff(a, a) == []
    assert "shape" in tree_bitwise_diff({"a": np.zeros(2)},
                                        {"a": np.zeros(3)})[0]
    assert tree_bitwise_diff({"a": 1}, {"b": 1})[0].startswith(
        "tree structure differs")


def test_check_determinism_flags_a_flaky_function():
    counter = {"n": 0}

    def flaky(x):
        counter["n"] += 1
        return x + counter["n"]

    report = check_determinism(flaky, torch.zeros(4), repeats=3)
    assert not report["deterministic"] and len(report["mismatches"]) == 2

    def writes_its_input(x):
        x.mul_(2.0)
        return x.clone()

    x = torch.arange(8.0)
    assert check_determinism(writes_its_input, x, repeats=3)[
        "deterministic"]
    assert torch.equal(x, torch.arange(8.0))   # inputs are copies


def _trainer(tmp_path, fused):
    graphs = _graphs(16, seed=41)
    model = X2GNN(ModelConfig(**SMALL), torch.Generator().manual_seed(2),
                  device="cpu")
    return Trainer(model, ModelConfig(**SMALL),
                   TrainConfig(batch_size=4, pack_mixed=True,
                               scheduler="plateau", fused_update=fused),
                   graphs, np.array([g.y[0] for g in graphs]),
                   workdir=str(tmp_path), device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_determinism(tmp_path, fused):
    """The port's step repeats bit for bit on the CPU; the trainer's
    parameters hold the checked state's values afterwards."""
    trainer = _trainer(tmp_path, fused)
    state = trainer.init_state()
    state, _ = trainer.train_step(state, trainer.batches(
        trainer.train_idx)[1])
    before = copy_tree(state)
    report = check_train_step_determinism(trainer, state, repeats=3)
    assert report["deterministic"], report["mismatches"]
    assert all(torch.equal(p, q) for p, q in
               zip(trainer.init_state().params, before.params))


def test_train_step_determinism_reports_a_perturbed_leaf(tmp_path):
    """A step that moves one EMA leaf by a different amount on every run
    is reported, by that leaf's name only."""
    trainer = _trainer(tmp_path, fused=False)
    step = trainer.train_step
    calls = {"n": 0}

    def perturbed(state, batch):
        new, loss = step(state, batch)
        calls["n"] += 1
        ema = list(new.ema.params)
        ema[3] = ema[3] + 1e-3 * calls["n"]
        return new._replace(ema=new.ema._replace(params=ema)), loss

    trainer.train_step = perturbed
    report = check_train_step_determinism(trainer)
    assert not report["deterministic"]
    assert len(report["mismatches"]) == 1
    assert report["mismatches"][0].startswith(
        "run 1: ['state'].ema.params[3]: ")
