"""The port's `scripts.aid_cv` and `scripts.featurize_aid` against the JAX
package's scripts/aid_cv.py and scripts/featurize_aid.py on the CPU: the
JAX scripts run in this process through runpy, as their command lines
run them, on a tiny AID-format xyz file. aid_cv's fold 0 at small widths
from the JAX Trainer's initial weights (the same split, atomref,
standardization and baseline, the trained scores within the Trainer
parity's rtol), its fold-out predictions against the Predictor, --fold
resume and the summary; featurize_aid's cache against the JAX script's,
resumed after a kill, and a changed --chunk."""

import functools
import json
import os
import runpy
import shutil
import sys

import numpy as np
import pytest

import x2gnn_tpu.config as jconfig
import x2gnn_tpu.data.dataset as jdataset
import x2gnn_tpu.data.integrals as jintegrals
import x2gnn_tpu.data.molecule as jmolecule
import x2gnn_tpu.train.trainer as jtrainer
from test_torch_port_model import one_torch_thread  # noqa: F401
from test_torch_port_run_io import _assert_graphs_equal
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.data import dataset, molecule, synthetic
from x2gnn_tpu_torch.data.integrals import engine
from x2gnn_tpu_torch.infer import Predictor
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.scripts import aid_cv, featurize_aid
from x2gnn_tpu_torch.weights import load_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_AID_CV = os.path.join(REPO, "scripts", "aid_cv.py")
JAX_FEATURIZE = os.path.join(REPO, "scripts", "featurize_aid.py")
JaxModelConfig = jconfig.ModelConfig

# the scripts' flagship model at small widths (both packages, patched into
# the scripts' ModelConfig); the features keep their 338 columns
NARROW = dict(conv_layers=2, in_channels=32, embedding_size=32, heads=4)
FOLDS, EPOCHS, BATCH, SEED, MAX_LR = 3, 8, 4, 41, 5e-3
CV_FLAGS = ["--folds", str(FOLDS), "--epochs", str(EPOCHS), "--batch-size",
            str(BATCH), "--warmup-steps", "1", "--max-lr", str(MAX_LR),
            "--backend", "native"]
SCORE_RTOL = 1e-3        # the Trainer parity's (ROADMAP, parity on record)
STATS_RTOL = 1e-12


def _aid_xyz(path, n=15, seed=29):
    """`n` molecules of 4-8 H and C atoms whose kcal/mol labels are a
    composition term plus a pairwise geometric one, as an AID-format xyz:
    two elements, so that a fold's few training molecules outnumber the
    atomref's three coefficients."""
    rng = np.random.default_rng(seed)
    mols = []
    for i in range(n):
        numbers, pos = synthetic.synthetic_geometry(
            i, seed=seed, mean_atoms=6, min_atoms=4, max_atoms=8)
        numbers = np.where(numbers == 1, 1, 6).astype(numbers.dtype)
        r = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        pair = (1.0 / r[np.triu_indices(len(numbers), 1)]).sum()
        label = -120.0 * numbers.sum() + 40.0 * pair + rng.normal()
        mols.append(molecule.Molecule(numbers, pos, [label], i))
    molecule.write_xyz(str(path), mols)
    return mols


def _run_jax_script(path, argv):
    saved = sys.argv
    sys.argv = [path] + argv
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved


@pytest.fixture(scope="module")
def cv(tmp_path_factory):
    """The xyz file's cache (the port's engine), the JAX script's fold 0
    (what it fitted, the Trainer it built, its initial parameters) and the
    port's fold 0 from those parameters."""
    d = tmp_path_factory.mktemp("aid_cv")
    xyz = d / "aid_tiny.xyz"
    _aid_xyz(xyz)
    cache = str(d / "processed")
    graphs = dataset.load_dataset(str(xyz), cache_dir=cache,
                                  backend="native", num_workers=1)
    seen = {}
    real_fit, real_trainer = jmolecule.fit_linear_atomref, jtrainer.Trainer

    def fit(numbers, y, train_idx):
        seen["atomref"], _ = out = real_fit(numbers, y, train_idx)
        return out

    class Trainer(real_trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            seen["trainer"], seen["std"] = self, kw["std"]
            seen["targets"] = np.asarray(args[4])

        def init_state(self, rng_seed=0):
            state = super().init_state(rng_seed)
            seen["params"] = state.params
            return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmolecule, "fit_linear_atomref", fit)
        mp.setattr(jtrainer, "Trainer", Trainer)
        mp.setattr(jconfig, "ModelConfig", lambda **kw: JaxModelConfig(
            **{**kw, **NARROW}))
        _run_jax_script(JAX_AID_CV, ["--data", str(xyz), "--cache-dir",
                                     cache, "--fold", "0", "--workdir",
                                     str(d / "jax")] + CV_FLAGS)
    y = np.array([g.y[0] for g in graphs], dtype=np.float64)
    fold = aid_cv.prepare_fold(
        graphs, y, aid_cv.fold_splits(len(graphs), FOLDS, SEED), 0, BATCH)
    mcfg = ModelConfig(attention_layout="blocked", readout="atomwise",
                       **NARROW)
    model = X2GNN(mcfg, device="cpu")
    load_flax_params(model, export_params_flat(seen["params"]))
    tcfg = TrainConfig(batch_size=BATCH, max_lr=MAX_LR, warmup_steps=1,
                       random_seed=SEED, ckpt_after_epoch=0)
    fold_dir = str(d / "port" / "fold_0")
    res, pred = aid_cv.run_fold(model, mcfg, tcfg, graphs, y, fold, 0,
                                fold_dir, EPOCHS, device="cpu")
    return dict(dir=d, xyz=xyz, cache=cache, graphs=graphs, y=y, fold=fold,
                seen=seen, res=res, pred=pred, mcfg=mcfg, fold_dir=fold_dir)


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_fold0_split_atomref_and_baseline_match_the_jax_script(cv):
    fold, seen = cv["fold"], cv["seen"]
    jt = seen["trainer"]
    for name in ("train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(fold[name], getattr(jt, name),
                                      err_msg=name)
    np.testing.assert_allclose(fold["atomref"], seen["atomref"],
                               rtol=STATS_RTOL)
    np.testing.assert_allclose(fold["sigma"], seen["std"], rtol=STATS_RTOL)
    mu = float((cv["y"] - seen["atomref"])[fold["train_idx"]].mean())
    np.testing.assert_allclose(fold["mu"], mu, rtol=STATS_RTOL,
                               atol=STATS_RTOL * fold["sigma"])
    np.testing.assert_allclose(fold["targets"], seen["targets"], rtol=1e-6,
                               atol=1e-6)
    with open(cv["dir"] / "jax" / "fold_0" / "result.json") as f:
        want = json.load(f)
    got = cv["res"]
    assert set(got) == set(want)
    assert (got["fold"], got["n_train"], got["n_test"]) == (
        want["fold"], want["n_train"], want["n_test"])
    for key in ("baseline_mae_kcal", "baseline_mae_kcal_per_atom"):
        np.testing.assert_allclose(got[key], want[key], rtol=STATS_RTOL,
                                   err_msg=key)


def test_fold0_trained_from_the_jax_weights_matches_the_jax_script(cv):
    """The scores and every epoch's loss and val MAE within the Trainer
    parity's rtol; the trained model moved the predictions off the
    composition baseline."""
    with open(cv["dir"] / "jax" / "fold_0" / "result.json") as f:
        want = json.load(f)
    got = cv["res"]
    for key in ("test_mae_kcal", "test_mae_kcal_per_atom",
                "best_val_mae_resid_kcal"):
        np.testing.assert_allclose(got[key], want[key], rtol=SCORE_RTOL,
                                   err_msg=key)
    jrec = _read(cv["dir"] / "jax" / "fold_0" / "metrics.jsonl")
    prec = _read(os.path.join(cv["fold_dir"], "metrics.jsonl"))
    assert len(jrec) == len(prec) == EPOCHS
    for j, p in zip(jrec, prec):
        for key in ("loss", "val_mae", "best_val_mae"):
            np.testing.assert_allclose(p[key], j[key], rtol=SCORE_RTOL,
                                       err_msg=key)
        assert (p["epoch"], p["step"]) == (j["epoch"], j["step"])
    assert abs(got["test_mae_kcal"] - got["baseline_mae_kcal"]) > 1e-3


def test_fold_out_predictions_are_the_predictors_in_test_order(cv):
    """run_fold's predictions are Predictor.predict of ckpt_best.pt's EMA
    weights on graphs[test_idx], in order, plus the atomref; they score
    the fold's test MAE against y[test_idx]."""
    fold, graphs = cv["fold"], cv["graphs"]
    test = fold["test_idx"]
    pred = Predictor.from_checkpoint(
        os.path.join(cv["fold_dir"], "ckpt_best.pt"), model_cfg=cv["mcfg"],
        device="cpu", stats={"mu": fold["mu"], "sigma": fold["sigma"]},
        batch_size=BATCH)
    served = pred.predict([graphs[i] for i in test])
    np.testing.assert_allclose(cv["pred"] - fold["atomref"][test], served,
                               rtol=1e-5, atol=1e-5 * fold["sigma"])
    assert float(np.abs(cv["pred"] - cv["y"][test]).mean()) == \
        cv["res"]["test_mae_kcal"]


def test_fold_resume_and_summary_match_the_jax_script(cv, tmp_path,
                                                      monkeypatch):
    """--fold k trains fold k alone and a cached fold_k/result.json is read,
    not trained again; summary.json aggregates as the JAX script's does
    over the same fold results."""
    monkeypatch.setattr(aid_cv, "ModelConfig", lambda **kw: ModelConfig(
        **{**kw, **NARROW}))
    trained = []
    real_run_fold = aid_cv.run_fold

    def run_fold(*args, **kw):
        trained.append(args[6])
        return real_run_fold(*args, **kw)

    monkeypatch.setattr(aid_cv, "run_fold", run_fold)
    work = tmp_path / "port"
    common = ["--data", str(cv["xyz"]), "--cache-dir", cv["cache"],
              "--workdir", str(work), "--device", "cpu"] + CV_FLAGS[:2] + [
              "--epochs", "1"] + CV_FLAGS[4:]
    assert aid_cv.main(common + ["--fold", "1"]) == 0
    assert trained == [1] and not (work / "summary.json").exists()
    assert aid_cv.main(common) == 0
    assert trained == [1, 0, 2]
    assert aid_cv.main(common + ["--fold", "1"]) == 0
    assert aid_cv.main(common) == 0          # every fold cached
    assert trained == [1, 0, 2]
    with open(work / "summary.json") as f:
        summary = json.load(f)
    assert [r["fold"] for r in summary["folds"]] == [0, 1, 2]
    jwork = tmp_path / "jax"
    for k in range(FOLDS):
        os.makedirs(jwork / f"fold_{k}")
        shutil.copy(work / f"fold_{k}" / "result.json",
                    jwork / f"fold_{k}" / "result.json")
    _run_jax_script(JAX_AID_CV, ["--data", str(cv["xyz"]), "--cache-dir",
                                 cv["cache"], "--workdir", str(jwork)]
                    + CV_FLAGS)
    with open(jwork / "summary.json") as f:
        assert summary == json.load(f)


# ---- featurize_aid ----------------------------------------------------------

CHUNK = 3


@pytest.fixture
def featurize_setup(tmp_path, monkeypatch):
    """Seven small molecules as an xyz file; both packages' featurizers on
    the port's C++ engine in this process (the engines are compared in
    test_torch_port_featurize.py); featurize_aid's featurize_molecules
    counted."""
    xyz = tmp_path / "aid_small.xyz"
    _aid_xyz(xyz, n=7, seed=31)
    monkeypatch.setattr(jintegrals, "one_electron_matrices",
                        engine.one_electron_matrices)
    monkeypatch.setattr(jdataset, "featurize_molecules", functools.partial(
        jdataset.featurize_molecules, num_workers=1))
    calls = []
    real = dataset.featurize_molecules

    def counted(mols, **kw):
        calls.append(len(mols))
        if getattr(counted, "fail_at", None) == len(calls):
            raise KeyboardInterrupt("killed")
        return real(mols, num_workers=1, **kw)

    monkeypatch.setattr(featurize_aid, "featurize_molecules", counted)
    return xyz, counted, calls


def _featurize(xyz, cache, chunk=CHUNK):
    return featurize_aid.main(["--xyz", str(xyz), "--chunk", str(chunk),
                               "--cache-dir", str(cache), "--backend",
                               "native"])


def test_featurize_aid_cache_is_the_jax_scripts(featurize_setup, tmp_path):
    xyz, _, calls = featurize_setup
    assert _featurize(xyz, tmp_path / "port") == 0
    assert calls == [3, 3, 1]
    assert os.listdir(tmp_path / "port") == ["aid_small_native_c5.npz"]
    _run_jax_script(JAX_FEATURIZE, ["--xyz", str(xyz), "--chunk",
                                    str(CHUNK), "--cache-dir",
                                    str(tmp_path / "jax")])
    got = str(tmp_path / "port" / "aid_small_native_c5.npz")
    want = str(tmp_path / "jax" / "aid_small_native_c5.npz")
    _assert_graphs_equal(dataset.load_graph_cache(got),
                         jdataset.load_graph_cache(want))
    assert dataset.read_cache_basis(got) == jdataset.read_cache_basis(want)
    # the cache load_dataset looks for: found, nothing featurized
    graphs = dataset.load_dataset(str(xyz), cache_dir=str(tmp_path / "port"),
                                  backend="native")
    assert len(graphs) == 7 and calls == [3, 3, 1]
    assert _featurize(xyz, tmp_path / "port") == 0    # exists: nothing done
    assert calls == [3, 3, 1]


def test_featurize_aid_resumes_a_killed_run(featurize_setup, tmp_path):
    """Killed after its first part, the run resumes with the parts still
    missing, and its cache is bitwise the one-shot run's."""
    xyz, counted, calls = featurize_setup
    assert _featurize(xyz, tmp_path / "once") == 0
    del calls[:]
    counted.fail_at = 2
    with pytest.raises(KeyboardInterrupt):
        _featurize(xyz, tmp_path / "killed")
    assert os.listdir(tmp_path / "killed") == ["_aid_small_native_chunk00000.npz"]
    counted.fail_at = None
    del calls[:]
    assert _featurize(xyz, tmp_path / "killed") == 0
    assert calls == [3, 1]
    assert os.listdir(tmp_path / "killed") == ["aid_small_native_c5.npz"]
    with np.load(tmp_path / "once" / "aid_small_native_c5.npz") as a, \
            np.load(tmp_path / "killed" / "aid_small_native_c5.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype


def test_featurize_aid_refeaturizes_a_part_of_another_chunk(featurize_setup,
                                                           tmp_path):
    xyz, counted, calls = featurize_setup
    counted.fail_at = 2
    with pytest.raises(KeyboardInterrupt):
        _featurize(xyz, tmp_path / "c", chunk=2)     # part 0: 2 molecules
    counted.fail_at = None
    del calls[:]
    assert _featurize(xyz, tmp_path / "c", chunk=CHUNK) == 0
    assert calls == [3, 3, 1]                          # part 0 again
    graphs = dataset.load_graph_cache(str(tmp_path / "c" /
                                          "aid_small_native_c5.npz"))
    assert [g.index for g in graphs] == list(range(7))
