"""A trained run's files in the port, on the CPU, against the JAX package:
graph caches (written by either package, read by the other, field for
field), training targets, Predictor.from_run / from_checkpoint, the
`python -m x2gnn_tpu_torch.evaluate` CLI, and the reference X2-GNN's
`.pth` state-dict naming (x2gnn_tpu/utils/torch_ckpt.py)."""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from test_torch_port_model import (  # noqa: F401 (autouse fixture)
    SMALL, _graphs, _jax_params, _port_model, one_torch_thread)
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.data import dataset as jdataset
from x2gnn_tpu.data import featurize as jfeaturize
from x2gnn_tpu.data import molecule as jmolecule
from x2gnn_tpu.data.synthetic import synthetic_dataset as jsynthetic
from x2gnn_tpu.infer import Predictor as JaxPredictor
from x2gnn_tpu.utils import torch_ckpt as jtorch_ckpt
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import ModelConfig, TrainConfig, dump_configs
from x2gnn_tpu_torch.data import dataset, featurize, molecule
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.evaluate import main as evaluate_main
from x2gnn_tpu_torch.infer import Predictor
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.train.__main__ import main as train_main
from x2gnn_tpu_torch.train.checkpoint import save_checkpoint
from x2gnn_tpu_torch.train.trainer import Trainer
from x2gnn_tpu_torch.utils import torch_ckpt
from x2gnn_tpu_torch.weights import export_flax_params

GRAPH_FIELDS = ("numbers", "positions", "edge_index", "edge_feat",
                "triplet_index", "atom_j", "atom_i", "atom_k", "y", "index")


def _assert_graphs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in GRAPH_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert type(a) is type(b), f
            np.testing.assert_array_equal(a, b, err_msg=f)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, (f, a.dtype, b.dtype)


# ---- graph caches and targets ---------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_graph_cache_round_trips_between_the_packages(tmp_path, writer):
    """A cache written by one package loads in the other field for field,
    values and dtypes, as the writer's own loader reads it, and equal to
    the graphs saved."""
    path = str(tmp_path / "cache.npz")
    if writer == "jax":
        graphs = jsynthetic(5, mean_atoms=6, seed=4, edge_feat_dim=8)
        jdataset.save_graph_cache(path, graphs, basis="x2sv")
    else:
        graphs = synthetic_dataset(5, mean_atoms=6, seed=4, edge_feat_dim=8)
        dataset.save_graph_cache(path, graphs, basis="x2sv")
    got, ref = dataset.load_graph_cache(path), jdataset.load_graph_cache(path)
    _assert_graphs_equal(got, ref)
    _assert_graphs_equal(got, [dataclasses.replace(
        g, index=int(g.index)) for g in graphs])
    assert dataset.read_cache_basis(path) == jdataset.read_cache_basis(
        path) == "x2sv"
    unknown = str(tmp_path / "old.npz")
    with np.load(path) as zf:
        np.savez(unknown, **{k: zf[k] for k in zf.files if k != "basis"})
    assert dataset.read_cache_basis(unknown) == "unknown"


@pytest.mark.parametrize("n_labels", [1, 2, 12])
def test_prepare_targets_matches_jax(n_labels):
    """One label, the synthetic [energy, gap] pair and 12 QM9 labels
    (atomization references, Hartree -> eV), each target 0-11, bitwise."""
    graphs = synthetic_dataset(9, mean_atoms=6, seed=6, edge_feat_dim=4)
    rng = np.random.default_rng(12)
    for g in graphs:
        g.y = rng.normal(size=n_labels).astype(np.float32)
    for target in range(12):
        got = dataset.prepare_targets(graphs, target)
        want = jdataset.prepare_targets(graphs, target)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=str(target))


def test_target_tables_equal_the_references():
    assert molecule.QM9_PROPERTY_NAMES == jmolecule.QM9_PROPERTY_NAMES
    assert molecule.HARTREE_TO_EV == jmolecule.HARTREE_TO_EV
    np.testing.assert_array_equal(molecule.ATOM_REF, jmolecule.ATOM_REF)
    assert featurize.BACKEND_BASIS == jfeaturize.BACKEND_BASIS


@pytest.mark.parametrize("run,data", [
    ("x2sv", "6-311+g(3df,2p)"), ("x2sv", "x2sv"), ("unknown", "x2sv"),
    (None, "zero")])
def test_check_basis_compatible_matches_jax(run, data):
    def outcome(fn, allow):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                fn(run, data, allow=allow)
            except ValueError as e:
                return "raises", str(e)
        return "warns" if caught else "passes", [str(w.message)
                                                 for w in caught]

    for allow in (False, True):
        assert (outcome(featurize.check_basis_compatible, allow)
                == outcome(jfeaturize.check_basis_compatible, allow))
    if run == "x2sv" and data != run:
        with pytest.raises(ValueError, match="basis mismatch"):
            featurize.check_basis_compatible(run, data)
        with pytest.warns(UserWarning, match="basis mismatch"):
            featurize.check_basis_compatible(run, data, allow=True)


# ---- restoring a run ------------------------------------------------------

@pytest.fixture(scope="module")
def jax_weights():
    graphs = _graphs(6, seed=9)
    probe = jbatching.pad_graphs(graphs[:4], jbatching.pad_budget_for(
        graphs, 4), with_triplets=False)
    # the same parameter tree as the Pallas formulation's, quicker to trace
    params = _jax_params(JaxModelConfig(use_pallas=False, **SMALL), probe)
    return JaxModelConfig(use_pallas=True, **SMALL), params


def _write_run(workdir, params, fused, live_scale=2.0, stats=None,
               basis=None, name="ckpt_best.pt"):
    """A port run directory whose EMA holds `params` (flax tree) and whose
    live weights are `live_scale` times them, as Trainer.fit leaves it."""
    mcfg, tcfg = ModelConfig(**SMALL), TrainConfig(fused_update=fused)
    graphs = _graphs(4, seed=3)
    trainer = Trainer(_port_model(params), mcfg, tcfg, graphs,
                      np.zeros(4, np.float32), workdir=str(workdir),
                      device="cpu")
    state = trainer.init_state()
    with torch.no_grad():
        for p in state.params:
            p.mul_(live_scale)
    workdir.mkdir(parents=True, exist_ok=True)
    save_checkpoint(str(workdir / name), state)
    dump_configs(mcfg, tcfg, str(workdir / "args.json"))
    if stats is not None:
        (workdir / "standardization.json").write_text(json.dumps(stats))
    if basis is not None:
        (workdir / "provenance.json").write_text(json.dumps(
            {"basis": basis}))


@pytest.mark.parametrize("fused", [True, False])
def test_from_run_matches_jax_predictor(tmp_path, jax_weights, fused):
    """Predictor.from_run on a port run directory (EMA flat under
    fused_update, else one tensor per parameter) against JAX
    Predictor(mcfg, params).predict on the same weights: rtol 1e-4,
    atol 1e-4 of the largest prediction. The live weights differ and
    give other predictions."""
    jcfg, params = jax_weights
    stats = {"mu": 3.0, "sigma": 2.5}
    _write_run(tmp_path, params, fused, stats=stats, basis="x2sv")
    graphs = _graphs(6, seed=9)
    ref = JaxPredictor(jcfg, params, stats=stats, batch_size=4).predict(
        graphs)
    pred = Predictor.from_run(str(tmp_path), batch_size=4, device="cpu")
    assert pred.stats == stats
    got = pred.predict(graphs)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    direct = Predictor(ModelConfig(**SMALL), _port_model(params),
                       stats=stats, batch_size=4, device="cpu")
    np.testing.assert_array_equal(got, direct.predict(graphs))
    live = Predictor.from_run(str(tmp_path), use_ema=False, batch_size=4,
                              device="cpu").predict(graphs)
    assert not np.allclose(live, got)
    # the run's provenance.json basis: molecules featurized in another
    # basis are refused before they are read
    assert pred.basis == "x2sv"
    with pytest.raises(ValueError, match="basis mismatch"):
        pred.predict_xyz("x.xyz", backend="native6311")
    with pytest.raises(ValueError, match="basis mismatch"):
        pred.predict_molecules([], backend="native6311")


def test_from_run_prefers_best_then_last(tmp_path, jax_weights):
    _, params = jax_weights
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        dump_configs(ModelConfig(**SMALL), TrainConfig(),
                     str(tmp_path / "args.json"))
        Predictor.from_run(str(tmp_path), device="cpu")
    graphs = _graphs(3, seed=2)
    _write_run(tmp_path, params, False, name="ckpt_last.pt")
    last = Predictor.from_run(str(tmp_path), device="cpu").predict(graphs)
    _write_run(tmp_path, params, False, live_scale=1.0, name="ckpt_best.pt")
    with torch.no_grad():
        best_model = _port_model(params)
        for p in best_model.parameters():
            p.mul_(1.5)
    ckpt = torch.load(str(tmp_path / "ckpt_best.pt"), weights_only=True)
    ckpt["ema"]["params"] = [p.detach().clone()
                             for p in best_model.parameters()]
    torch.save(ckpt, str(tmp_path / "ckpt_best.pt"))
    best = Predictor.from_run(str(tmp_path), device="cpu").predict(graphs)
    assert not np.allclose(best, last)
    np.testing.assert_array_equal(best, Predictor(
        ModelConfig(**SMALL), best_model, device="cpu").predict(graphs))


# ---- the evaluate CLI -----------------------------------------------------

@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """A port run trained 2 epochs by the CLI on 24 synthetic molecules
    with a fitted atomref and standardized targets."""
    root = tmp_path_factory.mktemp("evalrun")
    config = root / "config.json"
    config.write_text(json.dumps({"model": SMALL, "train": {
        "batch_size": 8, "ckpt_after_epoch": 0}}))
    run = root / "run"
    assert train_main(["--device", "cpu", "--synthetic", "24", "--epochs",
                       "2", "--config", str(config), "--atomref-fit",
                       "--standardize", "--workdir", str(run)]) == 0
    return run


def _evaluate(capsys, args):
    assert evaluate_main(args + ["--device", "cpu", "--batch-size",
                                 "8"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _in_process_mae(run, graphs, targets):
    """|Predictor.from_run prediction - (target - atomref)| averaged."""
    table = json.loads((run / "atomref.json").read_text())
    icept = table.pop("intercept")
    ref = np.array([sum(table[str(int(z))] for z in g.numbers) + icept
                    for g in graphs])
    pred = Predictor.from_run(str(run), batch_size=8,
                              device="cpu").predict(graphs)
    return float(np.abs(pred - (np.asarray(targets, np.float64)
                                - ref)).mean())


@pytest.mark.parametrize("source", ["synthetic", "data-npz"])
def test_evaluate_cli_equals_in_process_mae(capsys, tmp_path, trained_run,
                                            source):
    """The CLI's MAE (standardized targets, MAE times sigma) equals the
    MAE of from_run's de-standardized predictions within 1e-5 relative
    (float32 rounding of the two formulations)."""
    graphs = synthetic_dataset(24, cutoff=5.0, edge_feat_dim=8)
    ckpt = str(trained_run / "ckpt_best.pt")
    if source == "synthetic":
        out = _evaluate(capsys, ["--ckpt", ckpt, "--synthetic", "24"])
    else:
        cache = str(tmp_path / "c.npz")
        dataset.save_graph_cache(cache, graphs, basis="synthetic-random")
        out = _evaluate(capsys, ["--ckpt", ckpt, "--data-npz", cache,
                                 "--limit", "20"])
        graphs = graphs[:20]
    want = _in_process_mae(trained_run, graphs,
                           [g.y[0] for g in graphs])
    assert out["count"] == len(graphs)
    assert out["unit"] == "dataset label units"
    np.testing.assert_allclose(out["mae"], want, rtol=1e-5)
    if source == "synthetic":
        live = _evaluate(capsys, ["--ckpt", ckpt, "--synthetic", "24",
                                  "--use-live-params"])
        assert live["count"] == 24 and live["mae"] != out["mae"]


def test_evaluate_cli_guards(capsys, tmp_path, trained_run):
    """The basis guard raises (warns with --allow-basis-mismatch); an
    element missing from atomref.json exits; a missing --data file
    raises; --layout segment gives the blocked run's MAE."""
    graphs = synthetic_dataset(8, cutoff=5.0, edge_feat_dim=8)
    cache = str(tmp_path / "x2sv.npz")
    dataset.save_graph_cache(cache, graphs, basis="x2sv")
    ckpt = str(trained_run / "ckpt_best.pt")
    with pytest.raises(ValueError, match="basis mismatch"):
        evaluate_main(["--ckpt", ckpt, "--data-npz", cache, "--device",
                       "cpu"])
    with pytest.warns(UserWarning, match="basis mismatch"):
        _evaluate(capsys, ["--ckpt", ckpt, "--data-npz", cache,
                           "--allow-basis-mismatch"])
    for g in graphs:
        g.numbers = np.where(g.numbers == 9, 16, g.numbers).astype(
            g.numbers.dtype)
    graphs[0].numbers[0] = 16
    odd = str(tmp_path / "odd.npz")
    dataset.save_graph_cache(odd, graphs, basis="synthetic-random")
    with pytest.raises(SystemExit, match=r"Z=\[16\]"):
        evaluate_main(["--ckpt", ckpt, "--data-npz", odd, "--device",
                       "cpu"])
    with pytest.raises(FileNotFoundError):
        evaluate_main(["--ckpt", ckpt, "--data", str(tmp_path / "x.xyz"),
                       "--cache-dir", str(tmp_path), "--device", "cpu"])
    # another layout than the run's evaluates its weights to the same MAE
    blocked = _evaluate(capsys, ["--ckpt", ckpt, "--synthetic", "8"])
    segment = _evaluate(capsys, ["--ckpt", ckpt, "--synthetic", "8",
                                 "--layout", "segment"])
    np.testing.assert_allclose(segment["mae"], blocked["mae"], rtol=1e-4)


# ---- .pth interop ----------------------------------------------------------

def _pth(tmp_path, sd, prefix=""):
    path = str(tmp_path / "ref.pth")
    torch.save({"model": {prefix + k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, "epoch": 3}, path)
    return path


def test_jax_exported_pth_imports_bitwise(tmp_path, jax_weights):
    """A .pth made by the JAX package's export imports into a fresh port
    model equal, bit for bit, to load_flax_params of the same parameters,
    and to the JAX package's own import of that .pth."""
    jcfg, params = jax_weights
    path = _pth(tmp_path, jtorch_ckpt.export_torch_state_dict(params))
    sd = torch.load(path, weights_only=True)["model"]
    model = X2GNN(ModelConfig(**SMALL), torch.Generator().manual_seed(5),
                  device="cpu")
    report = torch_ckpt.import_torch_state_dict(sd, model)
    assert report == {"missing": [], "unused": [], "dead": []}
    want = _port_model(params)
    for (name, p), q in zip(model.named_parameters(), want.parameters()):
        assert torch.equal(p, q), name
    jimported, _ = jtorch_ckpt.import_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, params)
    jflat = export_params_flat(jimported)
    got = export_flax_params(model)
    assert got.keys() == jflat.keys()
    for path_, value in jflat.items():
        np.testing.assert_array_equal(got[path_], np.asarray(value))


def test_port_export_equals_jax_export(jax_weights):
    _, params = jax_weights
    want = jtorch_ckpt.export_torch_state_dict(params)
    model = _port_model(params)
    got = torch_ckpt.export_torch_state_dict(model)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(value),
                                      err_msg=key)
    assert set(torch_ckpt.name_map(model).values()) == set(
        jtorch_ckpt.name_map(params).values())


def test_pth_import_handles_averaged_model_keys(tmp_path, jax_weights):
    """An AveragedModel's `module.` prefix and `n_averaged` are handled,
    the reference's dead `rbf_trans.*` are reported, a missing key is
    reported and keeps the model's value, a wrong shape raises."""
    _, params = jax_weights
    sd = jtorch_ckpt.export_torch_state_dict(params)
    sd = {**sd, "rbf_trans.0.weight": np.ones((4, 6), np.float32),
          "n_averaged": np.array(7), "extra.weight": np.zeros(2)}
    missing_key = "fin_model.convs.0.lin_sbf.bias"
    sd.pop(missing_key)
    loaded = torch.load(_pth(tmp_path, sd, prefix="module."),
                        weights_only=True)["model"]
    model = X2GNN(ModelConfig(**SMALL), torch.Generator().manual_seed(6),
                  device="cpu")
    kept = model.conv_0.lin_sbf.bias.detach().clone()
    report = torch_ckpt.import_torch_state_dict(loaded, model)
    assert report == {"missing": ["conv_0.lin_sbf.bias"],
                      "unused": ["extra.weight"],
                      "dead": ["rbf_trans.0.weight"]}
    assert torch.equal(model.conv_0.lin_sbf.bias, kept)
    assert torch.equal(model.conv_0.lin_sbf.kernel,
                       _port_model(params).conv_0.lin_sbf.kernel)
    bad = dict(loaded)
    bad["module.fin_model.convs.0.lin_sbf.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_ckpt.import_torch_state_dict(bad, model)


def test_import_cli_writes_a_run_that_from_run_and_evaluate_read(
        capsys, tmp_path, jax_weights):
    """`python -m x2gnn_tpu_torch.utils.torch_ckpt` with the reference's
    flat config.json (no feature width: it is read from mat_trans.weight)
    writes ckpt_best.pt + args.json; from_run predicts with the imported
    weights bit for bit, and evaluate runs on it."""
    _, params = jax_weights
    pth = _pth(tmp_path, jtorch_ckpt.export_torch_state_dict(params))
    config = tmp_path / "config.json"
    config.write_text(json.dumps({k: SMALL[k] for k in (
        "conv_layers", "sbf_dim", "rbf_dim", "in_channels",
        "embedding_size", "heads")}))
    out = tmp_path / "imported"
    assert torch_ckpt.main(["--pth", pth, "--config", str(config), "--out",
                            str(out), "--device", "cpu"]) == 0
    assert "imported" in capsys.readouterr().out
    pred = Predictor.from_run(str(out), device="cpu")
    assert pred.mcfg == ModelConfig(**SMALL)
    graphs = _graphs(5, seed=13)
    want = Predictor(ModelConfig(**SMALL), _port_model(params),
                     device="cpu").predict(graphs)
    np.testing.assert_array_equal(pred.predict(graphs), want)
    res = _evaluate(capsys, ["--ckpt", str(out / "ckpt_best.pt"),
                             "--synthetic", "6"])
    assert res["count"] == 6 and np.isfinite(res["mae"])


def test_import_cli_unpickles_other_objects_only_when_trusted(
        capsys, tmp_path, jax_weights):
    """A .pth that holds a pickled object beside the state dict (an
    argparse Namespace here) is refused, naming --trust-pickle, and with
    that flag imports the same weights."""
    import argparse

    _, params = jax_weights
    sd = jtorch_ckpt.export_torch_state_dict(params)
    pth = str(tmp_path / "ref.pth")
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()},
                "args": argparse.Namespace(lr=1e-3)}, pth)
    config = tmp_path / "args.json"
    dump_configs(ModelConfig(**SMALL), TrainConfig(), str(config))
    cli = ["--pth", pth, "--config", str(config), "--device", "cpu"]
    with pytest.raises(SystemExit, match="--trust-pickle"):
        torch_ckpt.main(cli + ["--out", str(tmp_path / "refused")])
    assert not (tmp_path / "refused").exists()
    assert torch_ckpt.main(cli + ["--out", str(tmp_path / "run"),
                                  "--trust-pickle"]) == 0
    assert "imported" in capsys.readouterr().out
    graphs = _graphs(3, seed=4)
    want = Predictor(ModelConfig(**SMALL), _port_model(params),
                     device="cpu").predict(graphs)
    np.testing.assert_array_equal(
        Predictor.from_run(str(tmp_path / "run"), device="cpu").predict(
            graphs), want)
