"""The port's memory options on the CPU: `remat` (each conv recomputed in
the backward by torch.utils.checkpoint) against the model without it,
bitwise, with and without attention dropout; gradient accumulation
(`accum_steps`) against optax.MultiSteps and the JAX Trainer; a resumed
accumulating run against an unbroken one, bitwise; and the training CLI
with --compute-dtype, --feat-dtype, --remat and --accum-steps."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_model import (  # noqa: F401 (autouse fixture)
    SMALL, _graphs, one_torch_thread)
from test_torch_port_resume import _records, assert_resumed_records_equal
from test_torch_port_train import _adam_of, _small_config
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.config import TrainConfig as JaxTrainConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.train import ema as jema
from x2gnn_tpu.train import optim as joptim
from x2gnn_tpu.train.trainer import Trainer as JaxTrainer
from x2gnn_tpu.train.trainer import TrainState as JaxTrainState
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import ModelConfig, TrainConfig, load_configs
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.ops import blocked_attn
from x2gnn_tpu_torch.train import optim
from x2gnn_tpu_torch.train.__main__ import main as cli_main
from x2gnn_tpu_torch.train.ema import ema_init
from x2gnn_tpu_torch.train.loss import smooth_l1_loss
from x2gnn_tpu_torch.train.trainer import Trainer, TrainState
from x2gnn_tpu_torch.utils.determinism import tree_bitwise_diff
from x2gnn_tpu_torch.weights import load_flax_params


# ---- remat -----------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_gradients_equal_the_plain_step(dropout, compute_dtype,
                                              monkeypatch):
    """One step's loss and every parameter gradient with remat=True equal
    those without, bit for bit, on a tiered batch; with dropout 0.1 both
    draw from generators of one seed: the model draws each conv's mask
    before the checkpointed call, so the recompute does not draw another.
    With remat the attention forward runs again in the backward, once per
    conv and window."""
    graphs = _graphs(24, seed=23)[:8]
    bud = pad_budget_for(graphs, 8)
    targets = np.random.default_rng(81).normal(size=8).astype(np.float32)
    b = pad_graphs(graphs, bud, targets=targets).to("cpu")
    assert b.tiers
    calls = []
    real = blocked_attn.blocked_attention_fwd

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(blocked_attn, "blocked_attention_fwd", counted)
    out = {}
    for remat in (False, True):
        cfg = ModelConfig(dropout=dropout, remat=remat,
                          compute_dtype=compute_dtype, **SMALL)
        model = X2GNN(cfg, torch.Generator().manual_seed(0), device="cpu")
        calls.clear()
        pred = model(b, deterministic=dropout == 0.0,
                     generator=torch.Generator().manual_seed(5))
        loss = smooth_l1_loss(pred, b.y, mask=b.graph_mask)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[remat] = (loss, grads, len(calls))
    windows = SMALL["conv_layers"] * len(bud.tiers)
    assert out[False][2] == windows and out[True][2] == 2 * windows
    assert torch.equal(out[False][0], out[True][0])
    for a, c in zip(out[False][1], out[True][1]):
        assert torch.equal(a, c)
    if dropout:
        model = X2GNN(dataclasses.replace(cfg, remat=False),
                      torch.Generator().manual_seed(0), device="cpu")
        with torch.no_grad():
            other = model(b, deterministic=False,
                          generator=torch.Generator().manual_seed(6))
        assert not torch.equal(other, pred.detach())


# ---- accumulation against optax.MultiSteps ----------------------------------

def _multisteps_of(s):
    """The optax MultiStepsState inside an optimizer state tree."""
    if hasattr(s, "mini_step") and hasattr(s, "acc_grads"):
        return s
    if isinstance(s, tuple):
        for c in s:
            found = _multisteps_of(c)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("fused", [False, True])
def test_accumulation_matches_optax_multisteps(fused):
    """accum_steps=3 over 7 micro-steps, the 5th (mid-accumulation) with a
    non-finite loss,
    against the reference's make_optimizer (optax.MultiSteps around clip
    and Adam) through apply_update_skip_nonfinite: parameters, EMA, Adam
    moments and count, the gradient mean and the micro-step counter, at
    test_clip_adam_ema_match_optax's tolerances (rtol 1e-6 and 1e-7 of
    each tensor's largest magnitude). The non-finite micro-step leaves
    the counter and the mean as they were; the parameters move only on
    the emitting micro-steps."""
    kw = dict(accum_steps=3, fused_update=fused, max_grad=2.0,
              warmup_steps=2, decay_steps=10, ema_decay=0.9)
    rng = np.random.default_rng(8)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    keys = sorted(shapes)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jopt = joptim.make_optimizer(JaxTrainConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = JaxTrainState(jp, jopt.init(jp), jema.ema_init(jp, flat=fused),
                           jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    popt = optim.Optimizer(TrainConfig(**kw))
    leaves = [torch.from_numpy(p0[k].copy()) for k in keys]
    params = [torch.cat([t.reshape(-1) for t in leaves])] if fused else leaves
    zero = torch.zeros((), dtype=torch.int32)
    pstate = TrainState(params, popt.init(params), ema_init(params), zero,
                        zero.clone())

    def flat(x):
        if isinstance(x, dict):
            return np.concatenate([np.asarray(x[k]).reshape(-1)
                                   for k in keys])
        if isinstance(x, list):
            return np.concatenate([t.numpy().reshape(-1) for t in x])
        return np.asarray(x).reshape(-1)

    moved = []
    for step in range(7):
        scale = (3.0, 1.5, 0.1, 1.0, 0.7, 2.5, 0.4)[step]
        g = {k: (rng.normal(size=s) * scale).astype(np.float32)
             for k, s in shapes.items()}
        loss = np.float32(np.nan if step == 4 else 1.0)
        before = flat([p.clone() for p in pstate.params])
        jstate, _ = joptim.apply_update_skip_nonfinite(
            jstate, jnp.float32(loss), {k: jnp.asarray(v) for k, v in
                                        g.items()}, jopt, 0.9)
        pg = [torch.from_numpy(g[k]) for k in keys]
        if fused:
            pg = [torch.cat([t.reshape(-1) for t in pg])]
        pstate, _ = optim.apply_update_skip_nonfinite(
            pstate, torch.tensor(loss), pg, popt, 0.9)
        moved.append(not np.array_equal(before, flat(pstate.params)))
        ms = _multisteps_of(jstate.opt_state)
        jadam = _adam_of(ms.inner_opt_state)
        want = {"params": flat(jstate.params),
                "ema": flat(jstate.ema.params), "mu": flat(jadam.mu),
                "nu": flat(jadam.nu), "acc": flat(ms.acc_grads)}
        got = {"params": flat(pstate.params), "ema": flat(pstate.ema.params),
               "mu": flat(pstate.opt_state.mu),
               "nu": flat(pstate.opt_state.nu),
               "acc": flat(pstate.opt_state.acc)}
        for name in want:
            np.testing.assert_allclose(
                got[name], want[name], rtol=1e-6,
                atol=1e-7 * max(np.abs(want[name]).max(), 1e-30),
                err_msg=f"{name} after micro-step {step}")
        assert int(pstate.opt_state.mini_step) == int(ms.mini_step), step
        assert int(pstate.opt_state.count) == int(jadam.count), step
        assert int(pstate.step) == int(jstate.step) == step + 1
    # micro-steps 0..6, 4 (non-finite) not counted: the 3rd and the 6th
    # counted ones (2 and 6) emit
    assert moved == [False, False, True, False, False, False, True]
    assert int(pstate.opt_state.count) == 2
    assert int(pstate.opt_state.mini_step) == 0
    assert int(pstate.bad_steps) == 1


def test_accumulation_refuses_fewer_than_one_step():
    with pytest.raises(ValueError, match="accum_steps"):
        optim.Optimizer(TrainConfig(accum_steps=0))


# ---- the Trainer -------------------------------------------------------------

def test_packed_accumulating_run_matches_jax_trainer(tmp_path_factory):
    """Two epochs of the packed recipe with accum_steps=2 on both
    packages from the same weights (JAX's XLA branch, the port's plain
    kernels): loss and val MAE within rtol 1e-3, as the packed run without
    accumulation is held (test_torch_port_tiers.py); step, bad steps and
    the plateau scale equal."""
    mktemp = tmp_path_factory.mktemp
    graphs = _graphs(24, seed=23)
    targets = np.array([g.y[0] for g in graphs], np.float32)
    bud = pad_budget_for(graphs, 8)
    kw = dict(batch_size=8, max_epoch=2, scheduler="plateau",
              fused_update=True, ckpt_after_epoch=100, max_lr=1e-3,
              pack_mixed=True, accum_steps=2)
    jcfg = JaxModelConfig(use_pallas=False, **SMALL)
    jt = JaxTrainer(JaxX2GNN(jcfg), jcfg, JaxTrainConfig(**kw), graphs,
                    targets, workdir=str(mktemp("jax")),
                    budgets=jbatching.Budgets(*bud))
    jstate0 = jt.init_state()
    flat0 = export_params_flat(jstate0.params)
    jt.init_state = lambda: jax.tree_util.tree_map(jnp.copy, jstate0)
    jt.fit(epochs=2)
    model = X2GNN(ModelConfig(**SMALL), device="cpu")
    load_flax_params(model, flat0)
    pt = Trainer(model, ModelConfig(**SMALL), TrainConfig(**kw), graphs,
                 targets, workdir=str(mktemp("port")), budgets=bud,
                 device="cpu")
    state, _ = pt.fit(epochs=2)
    jrec, prec = _records(jt.workdir), _records(pt.workdir)
    assert len(jrec) == len(prec) == 2
    for j, p in zip(jrec, prec):
        for key in ("loss", "val_mae", "best_val_mae"):
            np.testing.assert_allclose(p[key], j[key], rtol=1e-3,
                                       err_msg=key)
        for key in ("epoch", "step", "bad_steps", "lr_scale"):
            assert p[key] == j[key], key
    steps = 2 * pt.steps_per_epoch()
    assert prec[-1]["step"] == steps
    assert int(state.opt_state.count) == steps // 2
    assert int(state.opt_state.mini_step) == steps % 2


def test_resumed_accumulating_run_equals_an_unbroken_one(tmp_path):
    """accum_steps=2 with 3 steps per epoch, so the first epoch ends
    between two micro-steps: 2 epochs straight against 1 epoch, a fresh
    Trainer restoring ckpt_last.pt (with the gradient mean and the
    micro-step counter) and 1 more, bit for bit."""
    graphs = _graphs(24, seed=51)
    train = dict(batch_size=8, scheduler="plateau", fused_update=True,
                 ckpt_after_epoch=0, ckpt_every=1, accum_steps=2)

    def trainer(workdir, seed=0):
        model = X2GNN(ModelConfig(**SMALL),
                      torch.Generator().manual_seed(seed), device="cpu")
        return Trainer(model, ModelConfig(**SMALL), TrainConfig(**train),
                       graphs, np.array([g.y[0] for g in graphs]),
                       workdir=str(workdir), device="cpu")

    a = trainer(tmp_path / "a")
    assert a.steps_per_epoch() == 3
    state_a, _ = a.fit(2)
    b = trainer(tmp_path / "b")
    b.fit(1)
    b2 = trainer(tmp_path / "b", seed=7)
    restored = b2.restore(str(tmp_path / "b" / "ckpt_last.pt"))
    assert int(restored.opt_state.mini_step) == 1
    assert restored.opt_state.acc[0].abs().sum() > 0
    state_b, _ = b2.fit(1, state=restored)
    assert_resumed_records_equal(_records(tmp_path / "a"),
                                 _records(tmp_path / "b"), 1)
    assert tree_bitwise_diff(state_a, state_b) == []
    assert int(state_b.opt_state.count) == 3


def test_restore_without_the_accumulator_restarts_the_optimizer(tmp_path):
    """A checkpoint of a run without accumulation restored into an
    accumulating Trainer: parameters and EMA carried over, the Adam state,
    the gradient mean and the counter start again (the structure differs,
    as for the flat/per-parameter EMA adaptation)."""
    graphs = _graphs(16, seed=52)
    y = np.array([g.y[0] for g in graphs])
    common = dict(batch_size=8, ckpt_after_epoch=0, ckpt_every=1)
    model = X2GNN(ModelConfig(**SMALL), torch.Generator().manual_seed(0),
                  device="cpu")
    Trainer(model, ModelConfig(**SMALL), TrainConfig(**common), graphs, y,
            workdir=str(tmp_path), device="cpu").fit(1)
    acc = Trainer(model, ModelConfig(**SMALL),
                  TrainConfig(accum_steps=2, **common), graphs, y,
                  workdir=str(tmp_path / "acc"), device="cpu")
    state = acc.restore(str(tmp_path / "ckpt_last.pt"))
    assert int(state.step) > 0 and int(state.opt_state.count) == 0
    assert int(state.opt_state.mini_step) == 0
    assert all(float(t.abs().sum()) == 0 for t in state.opt_state.acc)


# ---- the CLI -------------------------------------------------------------------

@pytest.mark.parametrize("feat_dtype", ["float16", "int8"])
def test_cli_runs_the_precision_and_memory_options(tmp_path, feat_dtype):
    """The training CLI with all four options on 16 small molecules,
    packed: the run's args.json records bf16, remat and accum_steps, the
    loss is finite, no step is skipped; a config's own values are kept
    when no flag is given."""
    workdir = tmp_path / "run"
    assert cli_main(["--device", "cpu", "--synthetic", "16", "--epochs",
                     "1", "--config", _small_config(tmp_path),
                     "--pack-mixed", "--compute-dtype", "bfloat16",
                     "--feat-dtype", feat_dtype, "--remat",
                     "--accum-steps", "2", "--workdir", str(workdir)]) == 0
    mcfg, tcfg = load_configs(str(workdir / "args.json"))
    assert (mcfg.compute_dtype, mcfg.remat, tcfg.accum_steps) == (
        "bfloat16", True, 2)
    (record,) = _records(workdir)
    assert np.isfinite(record["loss"]) and record["bad_steps"] == 0
    again = tmp_path / "again"
    assert cli_main(["--device", "cpu", "--synthetic", "16", "--epochs",
                     "1", "--config", str(workdir / "args.json"),
                     "--workdir", str(again)]) == 0
    assert load_configs(str(again / "args.json")) == (mcfg, tcfg)
