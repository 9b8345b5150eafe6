"""The port's host data pipeline against the JAX package's, on the CPU:
the labelled synthetic molecules, featurize_molecules and load_dataset
(cache tag, cache hit, fields; caches read both ways), the dataset
builder, prefetch, and the Trainer's cache_batches modes (bitwise equal
runs). The `--data` CLI and the featurizing predictors are in
test_torch_port_data_cli.py."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import x2gnn_tpu.data.integrals as jintegrals
from test_torch_port_model import SMALL, one_torch_thread  # noqa: F401
from test_torch_port_run_io import _assert_graphs_equal
from x2gnn_tpu.data import dataset as jdataset
from x2gnn_tpu.data import molecule as jmolecule
from x2gnn_tpu.data import synthetic as jsynthetic
from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.data import dataset, make_synthetic, molecule, synthetic
from x2gnn_tpu_torch.data.integrals import engine
from x2gnn_tpu_torch.data.prefetch import prefetch
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.train import trainer as trainer_mod
from x2gnn_tpu_torch.train.trainer import Trainer
from x2gnn_tpu_torch.utils.determinism import tree_bitwise_diff

@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread for numpy's and scipy's eigensolvers in this
    module, as one_torch_thread does for torch: the suite's workers share
    the cores, and the spinning BLAS threads of every worker oversubscribe
    them (the labelled-molecule tests ran ~20x slower so)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture
def same_engine(monkeypatch):
    """The JAX package's featurizers on the port's C++ engine, so both
    packages read the same integrals (the engines are compared in
    test_torch_port_featurize.py). The engine shares torch's OpenMP
    runtime, so one_torch_thread keeps it on one thread here too."""
    monkeypatch.setattr(jintegrals, "one_electron_matrices",
                        engine.one_electron_matrices)


def _xyz(path, n, seed=5, mean_atoms=7, n_labels=1):
    """`n` synthetic molecules' float64 geometry with random labels, as a
    concatenated xyz file; returns the Molecules."""
    rng = np.random.default_rng(seed)
    mols = []
    for i in range(n):
        numbers, pos = synthetic.synthetic_geometry(i, seed=seed,
                                                    mean_atoms=mean_atoms)
        mols.append(molecule.Molecule(numbers, pos,
                                      rng.normal(size=n_labels), i))
    molecule.write_xyz(str(path), mols)
    return mols


# ---- labelled synthetic molecules -------------------------------------------

@pytest.mark.parametrize("basis,gap,featurize", [
    ("x2sv", False, True), ("6311", True, True), ("x2sv", False, False)])
def test_synthetic_labeled_graph_matches_jax(same_engine, basis, gap,
                                             featurize):
    """Graph, integral features, the energy (and gap) labels, and the
    geometry-only stand-in, bitwise, for three indices of one seed."""
    for index in (0, 5, 17):
        kw = dict(seed=3, mean_atoms=6, featurize=featurize, basis=basis,
                  gap_label=gap)
        got = synthetic.synthetic_labeled_graph(index, **kw)
        want = jsynthetic.synthetic_labeled_graph(index, **kw)
        _assert_graphs_equal([got], [want])
        assert got.y.shape == ((2,) if gap and featurize else (1,))
        numbers, pos = synthetic.synthetic_geometry(index, seed=3,
                                                    mean_atoms=6)
        np.testing.assert_array_equal(numbers, want.numbers)
        np.testing.assert_array_equal(pos.astype(np.float32), want.positions)
        if featurize:
            assert got.edge_feat.any()
            s, h, _ = engine.one_electron_matrices(numbers, pos)
            e, g = jsynthetic.independent_particle_labels(numbers, pos, s, h)
            assert synthetic.independent_particle_labels(
                numbers, pos, s, h) == (e, g)
            assert synthetic.independent_particle_energy(
                numbers, pos, s, h) == e


# ---- featurize_molecules, load_dataset, caches ------------------------------

@pytest.mark.parametrize("backend,workers", [("native", 2), ("native", 1),
                                             ("zero", None)])
def test_featurize_molecules_matches_jax(same_engine, tmp_path, backend,
                                         workers):
    mols = _xyz(tmp_path / "m.xyz", 6)
    jmols = jmolecule.read_xyz(str(tmp_path / "m.xyz"))
    got = dataset.featurize_molecules(mols, backend=backend,
                                      num_workers=workers)
    want = jdataset.featurize_molecules(jmols, backend=backend,
                                        num_workers=1)
    _assert_graphs_equal(got, want)
    assert (backend == "zero") == (not any(g.edge_feat.any() for g in got))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_load_dataset_caches_as_the_reference(same_engine, tmp_path, writer,
                                              monkeypatch):
    """load_dataset names its cache as the reference does, finds a cache
    the other package wrote, gives the same graphs and basis tag, and on
    a hit featurizes nothing."""
    xyz = tmp_path / "set_a.xyz"
    _xyz(xyz, 7, seed=8, n_labels=2)
    first, second = ((dataset, jdataset) if writer == "port"
                     else (jdataset, dataset))
    cache = str(tmp_path / "processed")
    made = first.load_dataset(str(xyz), cache_dir=cache, backend="native",
                              limit=5, num_workers=1)
    fresh = jdataset.load_dataset(str(xyz), cache_dir=str(tmp_path / "j"),
                                  backend="native", limit=5, num_workers=1)
    assert os.listdir(cache) == ["set_a_native_c5_n5.npz"]
    assert dataset.read_cache_basis(os.path.join(
        cache, "set_a_native_c5_n5.npz")) == "x2sv"

    def no_featurizing(*args, **kw):
        raise AssertionError("featurized on a cache hit")

    monkeypatch.setattr(second, "featurize_molecules", no_featurizing)
    loaded = second.load_dataset(str(xyz), cache_dir=cache,
                                 backend="native", limit=5)
    _assert_graphs_equal(loaded, made)
    _assert_graphs_equal(loaded, fresh)
    assert len(made) == 5 and made[0].y.shape == (2,)


def test_make_synthetic_builds_the_reference_molecules(same_engine,
                                                       tmp_path):
    """The builder's chunks and merged cache hold the molecules
    synthetic_labeled_graph makes in either package: graphs and features
    bitwise; the labels within 1e-10 relative, since the builder's
    workers run the eigensolver on fewer BLAS threads than this process,
    which sums in another order (~1e-12 relative)."""
    args = ["--n", "5", "--name", "tiny", "--seed", "2", "--mean-atoms",
            "6", "--chunk", "3", "--cache-dir", str(tmp_path),
            "--workers", "2", "--basis", "6311", "--gap-label"]
    assert make_synthetic.main(args) == 0
    path = str(tmp_path / "tiny.npz")
    assert sorted(os.listdir(tmp_path)) == ["tiny.npz"]
    assert dataset.read_cache_basis(path) == "6-311+g(3df,2p)-native"
    want = [jsynthetic.synthetic_labeled_graph(
        i, seed=2, mean_atoms=6, basis="6311", gap_label=True)
        for i in range(5)]
    got = dataset.load_graph_cache(path)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.y, w.y, rtol=1e-10, atol=0)
    _assert_graphs_equal([dataclasses.replace(g, y=w.y) for g, w in
                          zip(got, want)], want)
    geo = make_synthetic.build_dataset(
        3, "geo", seed=2, mean_atoms=6, chunk=2, cache_dir=str(tmp_path),
        workers=1, geometry_only=True)
    assert dataset.read_cache_basis(geo) == "geometry-only"
    for g, w in zip(dataset.load_graph_cache(geo), want):
        np.testing.assert_array_equal(g.edge_index, w.edge_index)
        assert not g.edge_feat.any()


# ---- prefetch ---------------------------------------------------------------

def test_prefetch_order_empty_and_reraise():
    assert list(prefetch(iter(range(17)), depth=3)) == list(range(17))
    assert list(prefetch(iter([]))) == []

    def failing():
        yield 1
        raise ValueError("boom")

    it = prefetch(failing(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)


def test_prefetch_works_ahead():
    produced = []

    def gen(n=6):
        for i in range(n):
            produced.append(i)
            yield i

    it = prefetch(gen(), depth=2)
    assert next(it) == 0
    deadline = time.time() + 10.0
    while len(produced) < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert len(produced) >= 3, produced
    assert list(it) == [1, 2, 3, 4, 5]


def test_prefetch_abandonment_cancels_the_producer():
    started = threading.active_count()
    finished = threading.Event()

    def gen():
        try:
            for i in range(1000):
                yield i
        finally:
            finished.set()

    it = prefetch(gen(), depth=2)
    assert next(it) == 0
    it.close()
    assert finished.wait(timeout=10.0), "producer thread never released"
    deadline = time.time() + 10.0
    while threading.active_count() > started and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= started


# ---- the Trainer's cache modes ----------------------------------------------

def _cache_run(tmp_path, graphs, mode, packed):
    # one conv layer: a streamed batch's prefetch thread and the step take
    # turns at the interpreter lock at every torch op, which costs seconds
    # when the suite's workers load the cores
    cfg = ModelConfig(**{**SMALL, "conv_layers": 1})
    tcfg = TrainConfig(batch_size=8, max_epoch=2, ckpt_after_epoch=0,
                       fused_update=True, scheduler="plateau",
                       pack_mixed=packed)
    model = X2GNN(cfg, torch.Generator().manual_seed(0), device="cpu")
    tr = Trainer(model, cfg, tcfg, graphs,
                 np.array([g.y[0] for g in graphs], np.float32),
                 workdir=str(tmp_path / f"{mode}_{packed}"), device="cpu",
                 cache_batches=mode)
    state, summary = tr.fit()
    records = [{k: v for k, v in json.loads(line).items()
                if k != "seconds" and not k.endswith("_per_sec")}
               for line in open(os.path.join(tr.workdir, "metrics.jsonl"))]
    return tr, state, summary, records


@pytest.mark.parametrize("packed", [True, False])
def test_cache_modes_give_bitwise_equal_runs(tmp_path, packed):
    """Two epochs with the batches cached on the device, assembled and
    streamed every epoch, and cached on the host and streamed: records,
    parameters, optimizer state and EMA bitwise equal."""
    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    graphs = synthetic_dataset(20, mean_atoms=7, seed=13, edge_feat_dim=8,
                               target="random")
    runs = {mode: _cache_run(tmp_path, graphs, mode, packed)
            for mode in (True, False, "host")}
    ref_tr, ref_state, ref_summary, ref_records = runs[True]
    assert len(ref_records) == 2 and ref_records[-1]["step"] > 2
    for mode in (False, "host"):
        tr, state, summary, records = runs[mode]
        assert tr.cache_batches == mode
        assert records == ref_records, mode
        assert summary == ref_summary
        assert tree_bitwise_diff(state, ref_state) == [], mode
    assert not runs[False][0]._batch_cache          # nothing kept
    for mode in (False, "host"):    # no device cache in a streamed mode
        tr = runs[mode][0]
        with pytest.raises(ValueError, match="device_batches"):
            tr.batches(tr.train_idx)
    assert len(runs["host"][0]._batch_cache) == 3   # train, val, test
    host = next(iter(runs["host"][0]._batch_cache.values()))[0]
    assert isinstance(host.numbers, np.ndarray)     # kept on the host


def test_cache_batches_auto_uses_the_reference_threshold(monkeypatch):
    """None keeps batches on the device up to 20,000 molecules
    (x2gnn_tpu/train/trainer.py:170-173) and streams above; other
    values are refused."""
    from x2gnn_tpu_torch.data.batching import Budgets
    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    g = synthetic_dataset(1, mean_atoms=5, edge_feat_dim=8)[0]
    cfg = ModelConfig(**SMALL)
    model = X2GNN(cfg, device="cpu")
    assert trainer_mod.DEVICE_CACHE_MAX_MOLECULES == 20000
    for n, want in ((20000, True), (20001, False)):
        tr = Trainer(model, cfg, TrainConfig(), [g] * n,
                     np.zeros(n, np.float32), device="cpu",
                     budgets=Budgets(8, 64, 512, 8))
        assert tr.cache_batches is want
    for bad in ("device", 1):
        with pytest.raises(ValueError, match="cache_batches"):
            Trainer(model, cfg, TrainConfig(), [g] * 4,
                    np.zeros(4, np.float32), device="cpu",
                    cache_batches=bad)
