"""Resuming a run in the port (Trainer.restore, fit(state=), the CLI's
--resume / --auto-resume) on the CPU: a run of 1 + 1 epochs equals one of
2 epochs bit for bit, the epoch numbering and steps follow the JAX
Trainer's restore + fit(state=), and the counterparts of
tests/test_train.py's resume tests (ckpt_best kept, periodic checkpoints
with auto-resume, flat <-> per-parameter EMA adaptation)."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_model import (  # noqa: F401 (autouse fixture)
    SMALL, _graphs, one_torch_thread)
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.config import TrainConfig as JaxTrainConfig
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.train import optim as joptim
from x2gnn_tpu.train.trainer import Trainer as JaxTrainer
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.train import optim
from x2gnn_tpu_torch.train.__main__ import main as cli_main
from x2gnn_tpu_torch.train.checkpoint import (
    latest_checkpoint, save_checkpoint)
from x2gnn_tpu_torch.train.trainer import Trainer
from x2gnn_tpu_torch.utils.determinism import tree_bitwise_diff
from x2gnn_tpu_torch.weights import load_flax_params

RECIPE = dict(batch_size=8, scheduler="plateau", fused_update=True,
              ckpt_after_epoch=0, ckpt_every=1)


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def assert_resumed_records_equal(straight, resumed, first_resumed):
    """Every field of the records equal, bitwise, but the wall-clock ones
    (seconds, *_per_sec). A resumed run's test_mae starts again at None,
    as the reference's does (its best-val gate is re-seeded, the test MAE
    of the earlier best is not): from record `first_resumed` on, a None
    test_mae is accepted on an epoch that did not improve on best_val."""
    assert len(straight) == len(resumed)
    for i, (a, b) in enumerate(zip(straight, resumed)):
        assert a.keys() == b.keys()
        for key in a:
            if key == "seconds" or key.endswith("_per_sec"):
                continue
            if (key == "test_mae" and i >= first_resumed
                    and b[key] is None):
                assert b["val_mae"] > b["best_val_mae"], (i, a, b)
                continue
            assert a[key] == b[key], (i, key, a[key], b[key])


def _port_trainer(workdir, graphs, train, seed=0, weights=None):
    model = X2GNN(ModelConfig(**SMALL), torch.Generator().manual_seed(seed),
                  device="cpu")
    if weights is not None:
        load_flax_params(model, weights)
    return Trainer(model, ModelConfig(**SMALL), TrainConfig(**train), graphs,
                   np.array([g.y[0] for g in graphs]), workdir=str(workdir),
                   device="cpu")


@pytest.mark.parametrize("packed", [True, False])
def test_resumed_run_equals_an_uninterrupted_run(tmp_path, packed):
    """2 epochs straight, against 1 epoch, then a fresh Trainer (a new
    model from another seed) restoring ckpt_last.pt and training 1 more:
    the same metrics, parameters, EMA and optimizer state, bit for bit.
    Packed: the resumed epoch must visit the batches in epoch 2's shuffled
    order."""
    graphs = _graphs(24, seed=51)
    train = dict(RECIPE, pack_mixed=packed)
    a = _port_trainer(tmp_path / "a", graphs, train)
    state_a, _ = a.fit(2)
    b = _port_trainer(tmp_path / "b", graphs, train)
    b.fit(1)
    b2 = _port_trainer(tmp_path / "b", graphs, train, seed=7)
    restored = b2.restore(str(tmp_path / "b" / "ckpt_last.pt"))
    assert int(restored.step) == b2.steps_per_epoch()
    state_b, _ = b2.fit(1, state=restored)
    assert_resumed_records_equal(_records(tmp_path / "a"),
                                 _records(tmp_path / "b"), 1)
    assert [r["epoch"] for r in _records(tmp_path / "b")] == [1, 2]
    assert tree_bitwise_diff(state_a, state_b) == []
    for p, q in zip(a.model.parameters(), b2.model.parameters()):
        assert torch.equal(p, q)
    if packed:
        assert ([id(x) for x in a.train_order(0)]
                != [id(x) for x in a.train_order(1)])


def test_epoch_numbering_matches_jax_resume(tmp_path):
    """The JAX Trainer and the port, from the same weights, each train 1
    epoch, restore ckpt_last and train 1 more: the same epoch numbers,
    steps and learning-rate scales, and test_mae reported on the same
    epochs."""
    graphs = _graphs(24, seed=52)
    targets = np.array([g.y[0] for g in graphs], np.float32)
    train = dict(RECIPE, max_epoch=2)
    jcfg = JaxModelConfig(use_pallas=False, **SMALL)
    jt = JaxTrainer(JaxX2GNN(jcfg), jcfg, JaxTrainConfig(**train), graphs,
                    targets, workdir=str(tmp_path / "jax"))
    state0 = jt.init_state()
    weights = export_params_flat(state0.params)
    jt.init_state = lambda: jax.tree_util.tree_map(jnp.copy, state0)
    jt.fit(epochs=1)
    jt.fit(epochs=1, state=jt.restore(str(tmp_path / "jax" / "ckpt_last")))
    pt = _port_trainer(tmp_path / "port", graphs, train, weights=weights)
    pt.fit(1)
    pt.fit(1, state=pt.restore(str(tmp_path / "port" / "ckpt_last.pt")))
    jrec, prec = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert [r["epoch"] for r in prec] == [r["epoch"] for r in jrec] == [1, 2]
    for j, p in zip(jrec, prec):
        assert (p["step"], p["lr_scale"], p["test_mae"] is None) == (
            j["step"], j["lr_scale"], j["test_mae"] is None)
        np.testing.assert_allclose(p["val_mae"], j["val_mae"], rtol=1e-3)


def test_resume_does_not_clobber_best_checkpoint(tmp_path):
    """The resumed run's best-val gate starts at the restored weights' val
    MAE: a worse first epoch must not overwrite ckpt_best.pt
    (tests/test_train.py:168)."""
    graphs = _graphs(16, seed=53)
    trainer = _port_trainer(tmp_path, graphs, dict(RECIPE, batch_size=4,
                                                   fused_update=False))
    trainer.fit(3)
    best = str(tmp_path / "ckpt_best.pt")
    val0 = trainer.evaluate(trainer.restore(best), trainer.val_idx)
    state = trainer.restore(best)
    bad = state._replace(params=[p * 10.0 for p in state.params])
    bad = bad._replace(ema=bad.ema._replace(
        params=[p * 10.0 for p in bad.ema.params]))
    trainer.fit(1, state=bad)
    assert _records(tmp_path)[-1]["val_mae"] > val0
    val1 = trainer.evaluate(trainer.restore(best), trainer.val_idx)
    np.testing.assert_allclose(val1, val0, rtol=1e-6)


def test_periodic_ckpt_and_auto_resume(tmp_path):
    """ckpt_last.pt every 2 epochs; a run cut after epoch 3 resumes from
    epoch 2's checkpoint and steps on (tests/test_train.py:194); the CLI's
    --auto-resume picks the newest checkpoint and trains the epochs left
    of --epochs."""
    graphs = _graphs(16, seed=54)
    train = dict(RECIPE, batch_size=4, ckpt_every=2)
    trainer = _port_trainer(tmp_path / "t", graphs, train)
    trainer.fit(3)
    state = trainer.restore(str(tmp_path / "t" / "ckpt_last.pt"))
    spe = trainer.steps_per_epoch()
    assert int(state.step) == 2 * spe
    state2, _ = trainer.fit(2, state=state)
    assert int(state2.step) == 4 * spe
    assert [r["epoch"] for r in _records(tmp_path / "t")] == [1, 2, 3, 3, 4]

    config = tmp_path / "args.json"
    config.write_text(json.dumps({"model": SMALL, "train": {
        "batch_size": 8, "ckpt_after_epoch": 0, "ckpt_every": 1}}))
    run = str(tmp_path / "cli")
    common = ["--device", "cpu", "--synthetic", "24", "--config",
              str(config), "--workdir", run]
    assert cli_main(common + ["--epochs", "1"]) == 0
    assert cli_main(common + ["--epochs", "3", "--auto-resume"]) == 0
    records = _records(run)
    assert [r["epoch"] for r in records] == [1, 2, 3]
    assert records[-1]["step"] == 3 * records[0]["step"]
    assert cli_main(common + ["--epochs", "3", "--auto-resume"]) == 0
    assert len(_records(run)) == 3          # nothing left to train


@pytest.mark.parametrize("saved_fused", [False, True])
def test_restore_adapts_ema_representation(tmp_path, saved_fused):
    """A per-parameter checkpoint restored by a fused_update (flat EMA)
    trainer, and the reverse: parameters and EMA carry over, the Adam
    moments start again, and the adapted state trains on
    (tests/test_train.py:573)."""
    graphs = _graphs(12, seed=55)
    train = dict(RECIPE, batch_size=4, fused_update=saved_fused)
    src = _port_trainer(tmp_path / "src", graphs, train)
    state, _ = src.run_epoch(src.init_state())
    ckpt = str(tmp_path / "ckpt_x.pt")
    save_checkpoint(ckpt, state)
    ema_src = src.ema_parameters(state)

    dst = _port_trainer(tmp_path / "dst", graphs,
                        dict(train, fused_update=not saved_fused), seed=3)
    got = dst.restore(ckpt)
    assert len(got.ema.params) == (len(ema_src) if saved_fused else 1)
    for name, t in dst.ema_parameters(got).items():
        assert torch.equal(t, ema_src[name]), name
    for p, q in zip(dst.model.parameters(), src.model.parameters()):
        assert torch.equal(p, q)
    assert int(got.opt_state.count) == 0 and int(got.step) == int(state.step)
    assert all(not m.any() for m in got.opt_state.mu)
    got, loss = dst.run_epoch(got)
    assert np.isfinite(loss) and int(got.bad_steps) == 0


def test_restore_writes_into_the_live_parameters(tmp_path):
    """The restored state holds the model's own parameter tensors (under
    fused_update the flat vector they are views of), filled with the
    checkpoint's values, so the next step trains the restored weights."""
    graphs = _graphs(12, seed=56)
    src = _port_trainer(tmp_path / "src", graphs, dict(RECIPE, batch_size=4))
    state, _ = src.run_epoch(src.init_state())
    save_checkpoint(str(tmp_path / "ckpt_last.pt"), state)
    dst = _port_trainer(tmp_path / "dst", graphs, dict(RECIPE, batch_size=4),
                        seed=9)
    got = dst.restore(str(tmp_path / "ckpt_last.pt"))
    assert got.params[0] is dst._flat
    for p, q in zip(dst.model.parameters(), src.model.parameters()):
        assert torch.equal(p, q)
    before = dst._flat.clone()
    dst.train_step(got, dst.batches(dst.train_idx)[0])
    assert not torch.equal(before, dst._flat)


def test_latest_checkpoint_handles_named_and_numeric(tmp_path):
    def mk(name, t):
        path = tmp_path / name
        path.write_bytes(b"")
        os.utime(path, (t, t))

    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    mk("ckpt_best.pt", 100)
    mk("notes.pt", 900)
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_best.pt")
    mk("ckpt_5.pt", 200)
    mk("ckpt_40.pt", 200)
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_40.pt")
    mk("ckpt_last.pt", 300)
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_last.pt")


def test_plateau_scale_reseeds_like_the_reference():
    """get_plateau_scale reads the float32 scale the optimizer holds, and
    a controller started at it steps as the reference's does."""
    cfg = TrainConfig(scheduler="plateau")
    params = [torch.zeros(3)]
    st = optim.set_plateau_scale(optim.Optimizer(cfg).init(params), 0.7)
    jst = joptim.set_plateau_scale(
        joptim.make_optimizer(JaxTrainConfig(scheduler="plateau")).init(
            {"w": jnp.zeros(3)}), 0.7)
    assert optim.get_plateau_scale(st) == joptim.get_plateau_scale(jst)
    assert optim.get_plateau_scale(optim.Optimizer(TrainConfig()).init(
        params)) == 1.0
    scale = optim.get_plateau_scale(st)
    ours = optim.PlateauController(patience=1, scale=scale)
    ref = joptim.PlateauController(patience=1, scale=scale)
    for metric in (5.0, 5.0, 5.0, 4.0, 4.0, 4.0, 4.0):
        assert ours.step(metric) == ref.step(metric)
    assert ours.scale < scale
