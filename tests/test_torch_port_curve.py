"""The JAX training-curve fixture of chip_smoke.py's phase 15
(tests/torch_port_curve_jax.json, written by
tests/torch_port_make_curve.py): its schema, the port's builder against
its checksums, the port's labels against the JAX package's, and the gate
that holds the port's curve on the card to it."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
import torch_port_make_curve as make_curve
from test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)
from x2gnn_tpu_torch.config import ModelConfig, load_configs
from x2gnn_tpu_torch.data.make_synthetic import build_dataset
from x2gnn_tpu_torch.data.dataset import load_graph_cache
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.utils.parity import export_params_flat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fixture():
    with open(chip_smoke.CURVE_FIXTURE) as f:
        return json.load(f)


def test_fixture_schema(fixture):
    """What phase 15 reads: 10 epochs of the JAX run of the flagship
    recipe on the 1,024-molecule cut and of its four perturbed twins, their
    split, the set's checksums, the labels' statistics and the initial
    weights' sums."""
    assert fixture["recipe"] == make_curve.RECIPE
    assert fixture["epochs"] == make_curve.CURVE_EPOCHS == 10
    assert fixture["builder"] == {"n": 1024, "seed": 7, "mean_atoms": 13,
                                  "basis": "6311", "gap_label": True}
    # resolve_division's scaled division of 1,024 molecules
    assert fixture["split"] == {"test": 102, "val": 102, "train": 820}
    assert fixture["noise"] == {"scale": 1e-6,
                                "seeds": list(make_curve.NOISE_SEEDS)}
    s = fixture["set"]
    assert s["molecules"] == 1024 and len(s["first"]) == 16
    assert len(s["y_sum"]) == 2          # [energy Hartree, gap eV]
    assert {"intercept", "1", "6"} <= set(fixture["atomref"])
    stats = fixture["standardization"]
    assert stats.keys() == {"mu", "sigma"} and stats["sigma"] > 0
    runs = fixture["runs"]
    assert set(runs) == {"jax", "perturbed"}
    assert set(runs["perturbed"]) == {str(s) for s in make_curve.NOISE_SEEDS}
    for records in [runs["jax"], *runs["perturbed"].values()]:
        assert [r["epoch"] for r in records] == list(range(1, 11))
        assert set(records[0]) == set(make_curve.RECORD_KEYS)
        per_epoch = records[0]["step"]
        assert per_epoch > 0
        for r in records:
            assert r["step"] == r["epoch"] * per_epoch
            assert r["bad_steps"] == 0
            assert r["occupancy_pairs"] == fixture["occupancy_pairs"]
            assert all(np.isfinite(r[m]) and r[m] > 0
                       for m in chip_smoke.CURVE_METRICS)
    assert 0 < fixture["occupancy_pairs"] < 1


def test_initial_weights_are_the_ports(fixture):
    """The fixture's sum |w| per parameter is the port's flagship drawn
    from torch.Generator().manual_seed(seed) on the CPU, within phase
    15's gate."""
    mcfg, _ = load_configs(os.path.join(REPO, make_curve.RECIPE))
    assert mcfg == ModelConfig(attention_layout="blocked")
    model = X2GNN(mcfg, torch.Generator().manual_seed(
        fixture["init"]["seed"]), device="cpu")
    flat = export_params_flat(model)
    sums = fixture["init"]["abs_sums"]
    assert flat.keys() == sums.keys()
    for key, value in flat.items():
        got = float(np.abs(value.astype(np.float64)).sum())
        assert abs(got - sums[key]) <= chip_smoke.INIT_RTOL * sums[key], key


@pytest.fixture(scope="module")
def first_molecules(tmp_path_factory, fixture):
    """The port's builder's first 16 molecules of the A12 set."""
    b = fixture["builder"]
    path = build_dataset(16, "first16", seed=b["seed"],
                         mean_atoms=b["mean_atoms"], basis=b["basis"],
                         gap_label=b["gap_label"], workers=2,
                         cache_dir=str(tmp_path_factory.mktemp("built")))
    return load_graph_cache(path)


def test_builder_reproduces_the_first_molecules(fixture, first_molecules):
    """Atoms and edges exactly, each molecule's edge feature sum within
    1e-6 and its labels within 1e-9 relative: phase 15's gates."""
    got = chip_smoke.set_checksums(first_molecules)["first"]
    want = fixture["set"]["first"]
    assert len(got) == len(want) == 16
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g["atoms"], g["edges"]) == (w["atoms"], w["edges"]), i
        assert abs(g["edge_feat_sum"] - w["edge_feat_sum"]) <= (
            chip_smoke.FEAT_RTOL * abs(w["edge_feat_sum"])), i
        np.testing.assert_allclose(g["y"], w["y"], rtol=chip_smoke.LABEL_RTOL,
                                   atol=0, err_msg=str(i))


def test_curve_labels_match_the_jax_package(first_molecules):
    """chip_smoke.curve_labels (the port's atomref fit and standardization)
    against the fixture script's, which uses the JAX package's functions
    as train.py does, within phase 15's 1e-8."""
    from x2gnn_tpu.data.dataset import prepare_targets
    from x2gnn_tpu.data.molecule import fit_linear_atomref
    from x2gnn_tpu.train.trainer import make_split, resolve_division
    _, tcfg = load_configs(os.path.join(REPO, make_curve.RECIPE))
    got = chip_smoke.curve_labels(first_molecules, tcfg)
    want = make_curve.labels(first_molecules, tcfg, make_split,
                             resolve_division, fit_linear_atomref,
                             prepare_targets)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2].keys() == want[2].keys()
    for a, b in zip((got[1], got[3], got[4], *got[2].values()),
                    (want[1], want[3], want[4], *want[2].values())):
        assert abs(a - b) <= chip_smoke.STATS_RTOL * abs(b)


def _scaled(records, factor, metrics=chip_smoke.CURVE_METRICS):
    return [{**r, **{m: r[m] * factor for m in metrics}} for r in records]


def test_gate_passes_the_twins_and_fails_a_curve_5_percent_off(fixture):
    """Each perturbed JAX twin passes the gate against the JAX run (and the
    JAX run itself); a curve 5% off in both metrics fails, and so does one
    5% off in its loss alone (the first epochs' loss moves least under
    rounding)."""
    runs = fixture["runs"]
    for twin in runs["perturbed"].values():
        rows = chip_smoke.curve_gate(twin, fixture)
        assert len(rows) == 10 * len(chip_smoke.CURVE_METRICS)
        assert all(ok for *_, ok in rows)
    assert all(ok for *_, ok in chip_smoke.curve_gate(runs["jax"], fixture))
    for metrics in (chip_smoke.CURVE_METRICS, ("loss",)):
        off = chip_smoke.curve_gate(_scaled(runs["jax"], 1.05, metrics),
                                    fixture)
        assert not all(ok for *_, ok in off), metrics


def test_gate_limits_are_the_twins_envelope(fixture):
    """limit = max(3 x the largest twin gap up to the epoch, the floor):
    never below the floor, never below 3x any twin's gap so far, and never
    shrinking from one epoch to the next."""
    noise = chip_smoke.curve_noise(fixture)
    ref = fixture["runs"]["jax"]
    rows = chip_smoke.curve_gate(ref, fixture)
    for m in chip_smoke.CURVE_METRICS:
        limits = [limit for _, metric, *_, limit, _ in rows if metric == m]
        assert limits == sorted(limits)
        assert min(limits) >= chip_smoke.CURVE_FLOOR
        for e, r in enumerate(ref):
            for twin in fixture["runs"]["perturbed"].values():
                gap = abs(twin[e][m] - r[m]) / abs(r[m])
                assert noise[(r["epoch"], m)] >= gap
                assert limits[e] >= chip_smoke.CURVE_GAP_FACTOR * gap
