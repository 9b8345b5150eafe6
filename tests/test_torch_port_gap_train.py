"""The gap recipe's training and serving in the port
(runs/gap_r5_50k/args.json) on the CPU: the Trainer (against the JAX
Trainer without dropout; bitwise repeats and resumes with it), the configs
and the CLI, Predictor.from_run and the evaluate CLI on a molwise run, and
the .pth names of its readouts."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_gap import MOLWISE, _set
from test_torch_port_model import (  # noqa: F401 (autouse fixture)
    SMALL, _graphs, one_torch_thread)
from test_torch_port_resume import assert_resumed_records_equal
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.config import TrainConfig as JaxTrainConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.infer import Predictor as JaxPredictor
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.train.trainer import Trainer as JaxTrainer
from x2gnn_tpu.utils import torch_ckpt as jtorch_ckpt
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import (
    ModelConfig, TrainConfig, dump_configs, load_configs)
from x2gnn_tpu_torch.data.batching import pad_budget_for
from x2gnn_tpu_torch.infer import Predictor
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.train.__main__ import main as cli_main
from x2gnn_tpu_torch.train.checkpoint import save_checkpoint
from x2gnn_tpu_torch.train.trainer import Trainer
from x2gnn_tpu_torch.utils import torch_ckpt
from x2gnn_tpu_torch.utils.determinism import (
    check_train_step_determinism, tree_bitwise_diff)
from x2gnn_tpu_torch.weights import load_flax_params

GAP_ARGS = "runs/gap_r5_50k/args.json"


# ---- the Trainer on the gap recipe ----------------------------------------

RECIPE = dict(batch_size=8, scheduler="plateau", fused_update=True,
              ckpt_after_epoch=0, ckpt_every=1, pack_mixed=True,
              max_lr=1e-3)


def _records(workdir):
    with open(workdir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _port_trainer(workdir, flat, dropout, seed=0):
    mcfg = ModelConfig(dropout=dropout, **MOLWISE)
    model = X2GNN(mcfg, torch.Generator().manual_seed(seed), device="cpu")
    load_flax_params(model, flat)
    graphs = _set()
    return Trainer(model, mcfg, TrainConfig(**RECIPE), graphs,
                   np.array([g.y[0] for g in graphs], np.float32),
                   workdir=str(workdir), device="cpu")


@pytest.fixture(scope="module")
def gap_runs(tmp_path_factory):
    """Two pack_mixed molwise_mean epochs without dropout in both packages
    from the same weights (the JAX Trainer on its XLA branch, as
    test_torch_port_tiers's packed run), and the port with dropout 0.1:
    two epochs straight, and one, a restore in a fresh Trainer and one
    more."""
    mktemp = tmp_path_factory.mktemp
    graphs = _set()
    targets = np.array([g.y[0] for g in graphs], np.float32)
    jcfg = JaxModelConfig(use_pallas=False, **MOLWISE)
    jt = JaxTrainer(JaxX2GNN(jcfg), jcfg, JaxTrainConfig(**RECIPE), graphs,
                    targets, workdir=str(mktemp("jax")),
                    budgets=jbatching.Budgets(*pad_budget_for(graphs, 8)))
    jstate0 = jt.init_state()
    flat0 = export_params_flat(jstate0.params)
    jt.init_state = lambda: jax.tree_util.tree_map(jnp.copy, jstate0)
    jt.fit(epochs=2)
    jrec = [json.loads(line) for line in open(f"{jt.workdir}/metrics.jsonl")]
    runs = {"jax": jrec}
    for name, dropout in (("port", 0.0), ("dropout", 0.1)):
        work = mktemp(name)
        pt = _port_trainer(work, flat0, dropout)
        state, _ = pt.fit(2)
        runs[name] = (pt, state, _records(work))
    work = mktemp("resumed")
    _port_trainer(work, flat0, 0.1).fit(1)
    pt = _port_trainer(work, flat0, 0.1, seed=7)
    state, _ = pt.fit(1, state=pt.restore(str(work / "ckpt_last.pt")))
    runs["resumed"] = (pt, state, _records(work))
    runs["flat0"] = flat0
    return runs


def test_gap_trainer_without_dropout_matches_jax(gap_runs):
    jrec = gap_runs["jax"]
    pt, _, prec = gap_runs["port"]
    assert all(b.tiers for b in pt.batches(pt.train_idx))
    assert len(jrec) == len(prec) == 2
    for j, p in zip(jrec, prec):
        for key in ("loss", "val_mae", "best_val_mae"):
            np.testing.assert_allclose(p[key], j[key], rtol=1e-3,
                                       err_msg=key)
        for key in ("epoch", "step", "bad_steps", "lr_scale",
                    "occupancy_pairs", "budget_shapes"):
            assert p[key] == j[key], key


def test_gap_trainer_with_dropout_resumes_bitwise(gap_runs):
    """1 + 1 resumed epochs equal 2 straight, records and state bit for
    bit: each step's masks come from (random_seed, step); the dropout
    changes the loss."""
    _, state_a, rec_a = gap_runs["dropout"]
    _, state_b, rec_b = gap_runs["resumed"]
    assert_resumed_records_equal(rec_a, rec_b, 1)
    assert tree_bitwise_diff(state_a, state_b) == []
    _, _, rec_0 = gap_runs["port"]
    assert all(np.isfinite(r["loss"]) and r["bad_steps"] == 0
               for r in rec_a)
    assert rec_a[0]["loss"] != rec_0[0]["loss"]


def test_gap_trainer_step_repeats_bitwise(gap_runs, tmp_path):
    """check_train_step_determinism: the same step twice from one state
    draws the same masks and gives the same state bit for bit; the next
    step draws others."""
    pt = _port_trainer(tmp_path, gap_runs["flat0"], 0.1)
    report = check_train_step_determinism(pt)
    assert report["deterministic"], report["mismatches"]
    g0, g1 = pt.dropout_generator(0), pt.dropout_generator(1)
    a = torch.rand(64, generator=g0)
    assert torch.equal(a, torch.rand(64, generator=pt.dropout_generator(0)))
    assert not torch.equal(a, torch.rand(64, generator=g1))


def test_load_configs_reads_the_gap_args():
    mcfg, tcfg = load_configs(GAP_ARGS)
    raw = json.load(open(GAP_ARGS))
    for cfg, block in ((mcfg, "model"), (tcfg, "train")):
        for f in dataclasses.fields(cfg):
            want = raw[block][f.name]
            assert getattr(cfg, f.name) == (
                tuple(want) if f.name == "division" else want), f.name
    assert (mcfg.readout, mcfg.dropout, tcfg.target, tcfg.pack_mixed) == (
        "molwise_mean", 0.1, 4, True)
    assert mcfg == dataclasses.replace(
        ModelConfig(attention_layout="blocked"), readout="molwise_mean",
        dropout=0.1)


def test_cli_trains_the_gap_recipe_on_the_cpu(tmp_path):
    """The gap recipe's args.json at a small width through the CLI with
    --pack-mixed: the target picks molwise_mean, the run drops."""
    raw = json.load(open(GAP_ARGS))
    raw["model"].update({k: v for k, v in SMALL.items()})
    raw["train"].update(batch_size=8, ckpt_after_epoch=0)
    config = tmp_path / "gap.json"
    config.write_text(json.dumps(raw))
    workdir = tmp_path / "run"
    assert cli_main(["--device", "cpu", "--synthetic", "16", "--epochs",
                     "1", "--config", str(config), "--pack-mixed",
                     "--workdir", str(workdir)]) == 0
    mcfg, tcfg = load_configs(str(workdir / "args.json"))
    assert (mcfg.readout, mcfg.dropout, tcfg.target) == (
        "molwise_mean", 0.1, 4)
    (record,) = _records(workdir)
    assert np.isfinite(record["loss"]) and record["bad_steps"] == 0


# ---- serving a molwise run, .pth names ------------------------------------

@pytest.fixture(scope="module")
def molwise_weights():
    graphs = _graphs(6, seed=9)
    probe = jbatching.pad_graphs(graphs[:4], jbatching.pad_budget_for(
        graphs, 4), with_triplets=False)
    # the same parameter tree as the Pallas formulation's, quicker to trace
    params = JaxX2GNN(JaxModelConfig(use_pallas=False, **MOLWISE)).init(
        jax.random.PRNGKey(0), probe)
    return JaxModelConfig(use_pallas=True, dropout=0.1, **MOLWISE), params


def _molwise_model(params, dropout=0.1, seed=0):
    model = X2GNN(ModelConfig(dropout=dropout, **MOLWISE),
                  torch.Generator().manual_seed(seed), device="cpu")
    load_flax_params(model, export_params_flat(params))
    return model


@pytest.fixture(scope="module")
def molwise_run(tmp_path_factory, molwise_weights):
    """A gap-recipe run directory (dropout 0.1 in args.json) whose EMA
    holds the JAX weights, with a standardization."""
    _, params = molwise_weights
    run = tmp_path_factory.mktemp("molwise_run")
    mcfg, tcfg = ModelConfig(dropout=0.1, **MOLWISE), TrainConfig(
        fused_update=True, target=4)
    trainer = Trainer(_molwise_model(params), mcfg, tcfg, _graphs(6, seed=9),
                      np.zeros(6, np.float32), workdir=str(run),
                      device="cpu")
    save_checkpoint(str(run / "ckpt_best.pt"), trainer.init_state())
    dump_configs(mcfg, tcfg, str(run / "args.json"))
    (run / "standardization.json").write_text(json.dumps(
        {"mu": 1.5, "sigma": 0.5}))
    return run


def test_from_run_serves_a_molwise_run(molwise_run, molwise_weights):
    """Predictor.from_run of the run against JAX Predictor on the same
    weights: rtol 1e-4; serving never drops (two calls bitwise)."""
    jcfg, params = molwise_weights
    graphs = _graphs(6, seed=9)
    pred = Predictor.from_run(str(molwise_run), batch_size=4, device="cpu")
    assert pred.mcfg == ModelConfig(dropout=0.1, **MOLWISE)
    got = pred.predict(graphs)
    ref = JaxPredictor(jcfg, params, stats={"mu": 1.5, "sigma": 0.5},
                       batch_size=4).predict(graphs)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(got, pred.predict(graphs))


def test_evaluate_cli_serves_a_molwise_run(capsys, molwise_run):
    """python -m x2gnn_tpu_torch.evaluate --target 4 on the run (the
    target picks molwise_mean, as in training) equals the MAE of
    from_run's predictions within 1e-5 relative."""
    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    from x2gnn_tpu_torch.evaluate import main as evaluate_main
    assert evaluate_main(["--ckpt", str(molwise_run / "ckpt_best.pt"),
                          "--synthetic", "12", "--target", "4",
                          "--batch-size", "4", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    graphs = synthetic_dataset(12, cutoff=5.0, edge_feat_dim=8)
    pred = Predictor.from_run(str(molwise_run), batch_size=4,
                              device="cpu").predict(graphs)
    want = float(np.abs(pred - np.array([g.y[0] for g in graphs])).mean())
    assert out["count"] == 12
    np.testing.assert_allclose(out["mae"], want, rtol=1e-5)


def test_molwise_pth_round_trip_is_bitwise(tmp_path, molwise_weights):
    """A molwise model's reference-named state dict equals the JAX
    package's export of the same weights key for key (readout MLP layer j
    at `fin_model.readouts.i.mlp.{2j}`), and a .pth round trip into a
    fresh model is bitwise."""
    _, params = molwise_weights
    model = _molwise_model(params)
    sd = torch_ckpt.export_torch_state_dict(model)
    want = jtorch_ckpt.export_torch_state_dict(params)
    assert sd.keys() == want.keys()
    assert "fin_model.readouts.0.mlp.4.weight" in sd
    for key, value in want.items():
        np.testing.assert_array_equal(sd[key], np.asarray(value),
                                      err_msg=key)
    path = tmp_path / "gap.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               str(path))
    fresh = _molwise_model(params, seed=3)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    report = torch_ckpt.import_torch_state_dict(
        torch.load(str(path), weights_only=True)["model"], fresh)
    assert report == {"missing": [], "unused": [], "dead": []}
    for (name, p), q in zip(fresh.named_parameters(), model.parameters()):
        assert torch.equal(p, q), name
