"""`chip_smoke.py --gap-full` on the CPU: its gate against the two JAX gap
runs' own records and the port's card run, on curves at the mean and at
the median constant and on one 1.25 x r5's, on broken records; the
references read from runs/; the training command and the labels as the
recipe's CLI makes them; the constant baselines; and the mode's refusal
of the CPU."""

import json
import math
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)

RUNS = chip_smoke.GAP_RUNS
# the constant predictors' MAEs on the whole set, as `constant_baselines`
# gave them on an H100 (the train split's mean label, then its median);
# the median is the better constant, above both JAX runs at every epoch
BASELINES = {"val": 2.2353991138011384, "test": 2.290737207224833,
             "val_median": 2.027014885731973,
             "test_median": 2.0924491118319564}
# the port's card run of the recipe on the set (13 epochs, an H100):
# each epoch's val_mae, best_val_mae and the best epoch's test_mae
PORT_CURVE = [
    (1.99484088954768, 1.99484088954768, 2.0612539195563597),
    (1.9975814832446244, 1.99484088954768, 2.0612539195563597),
    (2.0289038429717734, 1.99484088954768, 2.0612539195563597),
    (1.9904596298323887, 1.9904596298323887, 2.0643680711300356),
    (2.015191472188753, 1.9904596298323887, 2.0643680711300356),
    (1.9893080480246879, 1.9893080480246879, 2.039469366512282),
    (1.9917777260828993, 1.9893080480246879, 2.039469366512282),
    (1.9860037599617484, 1.9860037599617484, 2.0389528808433277),
    (1.9852944079875139, 1.9852944079875139, 2.0516063401738194),
    (1.9989139252959225, 1.9852944079875139, 2.0516063401738194),
    (1.978732660233687, 1.978732660233687, 2.055036439959758),
    (1.9980888172758144, 1.978732660233687, 2.055036439959758),
    (1.9917037747241118, 1.978732660233687, 2.055036439959758)]


def _refs():
    return chip_smoke.recipe_references(chip_smoke.GAP)


def _records(run):
    """A JAX run's records, r4's occupancy set to r5's: its records carry
    an earlier planner's (0.347); the gate holds the port to r5's."""
    refs = _refs()
    records = [dict(r) for r in refs["curves"][run]]
    for r in records:
        r["occupancy_pairs"] = refs["occupancy_pairs"]
    return records


def _gate(records, baselines=BASELINES):
    return chip_smoke.gap_gate(records, _refs(), baselines)


def _constants(val, test):
    """Baselines whose mean and median constants are the same."""
    return {"val": val, "val_median": val, "test": test,
            "test_median": test}


@pytest.mark.parametrize("run", RUNS)
def test_gate_passes_each_jax_runs_own_curve(run):
    """Each run's own records pass at every cut from 10 epochs to the end
    of the shorter run, the other run being the band's other side."""
    records = _records(run)
    last = min(len(c) for c in _refs()["curves"].values())
    for cut in range(chip_smoke.GAP_MIN_EPOCHS, last + 1):
        rows, faults = _gate(records[:cut])
        assert faults == [], (cut, faults)
        assert [r[0] for r in rows] == ["best_val_mae", "test_mae"]
        assert all(r[1] == cut and r[-1] for r in rows)


def test_the_gates_numbers_at_a_cut():
    """At epoch 18 the band is 2 x the largest per-epoch val_mae gap of the
    two runs up to it (0.0283 at epoch 11), for the test MAE too; the
    share is taken from the better constant (the median) towards the
    worse JAX run, which r5's best is there."""
    refs = _refs()
    r5, r4 = (refs["curves"][run] for run in RUNS)
    spread = max(abs(a["val_mae"] - b["val_mae"])
                 for a, b in zip(r5[:18], r4[:18]))
    assert spread == pytest.approx(0.0283, abs=1e-4)
    rows, _ = _gate(_records(RUNS[0])[:18])
    metric, e, got, base, j5, j4, share, limit, over, band, ok = rows[0]
    assert (metric, e, got, base, j5, j4) == (
        "best_val_mae", 18, r5[17]["best_val_mae"],
        BASELINES["val_median"], r5[17]["best_val_mae"],
        r4[17]["best_val_mae"])
    assert j5 > j4 and share == (base - got) / (base - j5) == 1.0
    assert over == got - max(j5, j4) and band == 2.0 * spread
    assert limit == chip_smoke.GAP_SHARE == 0.5 and ok
    assert rows[1][3] == BASELINES["test_median"] and rows[1][9] == band
    assert chip_smoke.gap_report(rows)[0].startswith("metric | epoch")
    assert chip_smoke.gap_report(rows)[1].endswith("| pass")


def test_gate_passes_the_ports_card_run():
    """The port's 13 epochs on the card pass at every cut from 10, the
    last keeping 0.88 of the worse run's val gain over the median constant
    and 0.95 of its test gain."""
    records = _records(RUNS[0])[:len(PORT_CURVE)]
    for r, (val, best, test) in zip(records, PORT_CURVE):
        r.update(val_mae=val, best_val_mae=best, test_mae=test)
    for cut in range(chip_smoke.GAP_MIN_EPOCHS, len(PORT_CURVE) + 1):
        rows, faults = _gate(records[:cut])
        assert faults == [] and all(r[-1] for r in rows), (cut, faults)
    assert [round(r[6], 2) for r in rows] == [0.88, 0.95]
    assert rows[0][8] == pytest.approx(0.00660, abs=1e-5)


@pytest.mark.parametrize("constant", ["mean", "median"])
@pytest.mark.parametrize("cut", [10, 18, 25])
def test_gate_fails_a_curve_at_a_constant(cut, constant):
    """A curve that predicts the train split's mean or median label for
    every molecule fails on val and on test: at the median, the better
    constant, it keeps none of the JAX runs' gain, at the mean less."""
    key = "" if constant == "mean" else "_median"
    records = _records(RUNS[0])[:cut]
    for r in records:
        r["val_mae"] = r["best_val_mae"] = BASELINES["val" + key]
        r["test_mae"] = BASELINES["test" + key]
    rows, faults = _gate(records)
    shares = [r[6] for r in rows]
    if constant == "median":
        assert shares == [0.0, 0.0]
    else:
        assert all(s < 0.0 for s in shares)
    assert not any(r[-1] for r in rows) and len(faults) == 2
    assert "best_val_mae" in faults[0] and "test_mae" in faults[1]


@pytest.mark.parametrize("cut", [10, 18, 25])
def test_gate_fails_r5s_curve_a_quarter_higher(cut):
    """r5's curve times 1.25 is within A12's factor of the larger JAX
    value at every epoch, and fails here: over the band, and above the
    better constant, so no share of the gain kept."""
    records = _records(RUNS[0])[:cut]
    refs = _refs()
    for r in records:
        for key in ("val_mae", "best_val_mae", "test_mae"):
            r[key] *= 1.25
    for r, a, b in zip(records, *(refs["curves"][run] for run in RUNS)):
        assert r["best_val_mae"] / max(a["best_val_mae"], b["best_val_mae"]
                                       ) <= chip_smoke.A12_FACTOR
    rows, faults = _gate(records)
    assert len(faults) == 2 and not any(r[-1] for r in rows)
    assert all(r[8] > r[9] and r[6] < 0 for r in rows)


def test_gate_holds_the_band_and_the_share_apart():
    """A best val MAE just over the band fails though it keeps most of the
    gain; with a constant close above the JAX runs, one inside the band
    fails for the share alone."""
    far = _constants(4.0, 4.0)
    records = _records(RUNS[0])[:12]
    rows, _ = _gate(records, far)
    band = rows[0][9]
    records[-1]["best_val_mae"] = max(rows[0][4:6]) + band * 1.01
    rows, faults = _gate(records, far)
    assert rows[0][6] > chip_smoke.GAP_SHARE and not rows[0][-1]
    assert len(faults) == 1 and "best_val_mae at epoch 12" in faults[0]
    records = _records(RUNS[1])[:12]
    worse = max(rows[0][4:6])
    records[-1]["best_val_mae"] = worse + 0.01
    rows, faults = _gate(records, _constants(worse + 0.015, 2.15))
    assert rows[0][8] <= rows[0][9] and rows[0][6] < chip_smoke.GAP_SHARE
    assert len(faults) == 1 and "keeps" in faults[0]


def test_gate_refuses_a_baseline_under_the_jax_runs():
    """The better of the two constants counts: a median under the JAX
    runs is refused though the mean is above them."""
    records = _records(RUNS[0])[:10]
    rows, faults = _gate(records, dict(BASELINES, val_median=1.97))
    assert [r[0] for r in rows] == ["test_mae"]
    assert len(faults) == 1 and faults[0].startswith(
        "best_val_mae: the better constant val baseline 1.97 is not above")


@pytest.mark.parametrize("case", ["nine epochs", "bad steps", "wrong step",
                                  "occupancy", "non-finite loss",
                                  "missing epoch"])
def test_gate_fails_a_broken_record(case):
    records = _records(RUNS[0])[:12]
    if case == "nine epochs":
        del records[9:]
    elif case == "bad steps":
        records[3]["bad_steps"] = 2
    elif case == "wrong step":
        records[6]["step"] -= 1
    elif case == "occupancy":
        records[2]["occupancy_pairs"] = np.nextafter(
            records[2]["occupancy_pairs"], 0.0)
    elif case == "non-finite loss":
        records[5]["loss"] = math.nan
    else:
        del records[3]
    faults = _gate(records)[1]
    word = {"nine epochs": "fewer than 10", "bad steps": "bad_steps",
            "wrong step": "step", "occupancy": "occupancy_pairs",
            "non-finite loss": "loss", "missing epoch": "is epoch"}[case]
    assert any(word in f for f in faults), faults


def test_gate_without_references_checks_the_records_alone():
    records = [{"epoch": e, "step": 51 * e, "bad_steps": 0, "loss": 0.2,
                "best_val_mae": 2.0, "test_mae": 2.0} for e in (1, 2, 3)]
    assert chip_smoke.gap_gate(records, None, None) == ([], [])
    records[1]["loss"] = math.inf
    assert chip_smoke.gap_gate(records, None, None)[1] == [
        "epoch 2: loss inf"]


def test_references_are_read_from_the_runs_files(tmp_path):
    """The two gap runs' records and r5's standardization, as the files
    say; the recipe fits no atomref; a changed copy changes them."""
    refs = _refs()
    root = chip_smoke.REPO
    with open(f"{root}/runs/{RUNS[0]}/standardization.json") as f:
        assert refs["standardization"] == json.load(f) == {
            "mu": 2.939972400665283, "sigma": 4.54472541809082}
    for run in RUNS:
        with open(f"{root}/runs/{run}/metrics.jsonl") as f:
            assert refs["curves"][run] == [json.loads(x) for x in f]
    assert "atomref" not in refs and not chip_smoke.GAP.atomref
    assert refs["steps_per_epoch"] == 1172
    assert refs["occupancy_pairs"] == 0.4716048782753496
    assert [len(refs["curves"][run]) for run in RUNS] == [87, 60]
    for run in RUNS:
        shutil.copytree(f"{root}/runs/{run}", tmp_path / run)
    path = tmp_path / RUNS[0] / "metrics.jsonl"
    records = [json.loads(x) for x in path.read_text().splitlines()]
    for r in records:
        r["step"] = 900 * r["epoch"]
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    (tmp_path / RUNS[0] / "standardization.json").write_text(
        json.dumps({"mu": 3.0, "sigma": 4.0}))
    changed = chip_smoke.recipe_references(chip_smoke.GAP,
                                           str(tmp_path))
    assert changed["steps_per_epoch"] == 900
    assert changed["standardization"] == {"mu": 3.0, "sigma": 4.0}


def test_the_training_command_is_the_recipes():
    """scripts/run_gap_r5.sh's recipe: runs/gap_r5_50k/args.json (target
    4, molwise_mean, dropout 0.1, patience 6, pack_mixed) with
    --standardize --pack-mixed --cache-batches on --feat-dtype float16 and
    no --atomref-fit; A12's command is as it was."""
    cmd = chip_smoke.train_command(chip_smoke.GAP, "set.npz", "run")
    assert cmd[:3] == [sys.executable, "-m", "x2gnn_tpu_torch.train"]
    assert cmd[3:] == [
        "--config", f"{chip_smoke.REPO}/runs/gap_r5_50k/args.json",
        "--data-npz", "set.npz", "--standardize", "--pack-mixed",
        "--cache-batches", "on", "--feat-dtype", "float16",
        "--workdir", "run"]
    assert "--atomref-fit" not in cmd
    assert chip_smoke.GAP.feat_dtype == "float16"
    mcfg, tcfg = chip_smoke.gap_training_configs()
    assert (tcfg.target, mcfg.readout, mcfg.dropout, tcfg.patience,
            tcfg.pack_mixed) == (4, "molwise_mean", 0.1, 6, True)
    assert chip_smoke.train_command(chip_smoke.A12, "set.npz", "run")[3:] \
        == ["--config", chip_smoke.FLAGSHIP_ARGS, "--data-npz", "set.npz",
            "--atomref-fit", "--standardize", "--cache-batches", "on",
            "--workdir", "run"]
    assert (chip_smoke.A12.atomref, chip_smoke.A12.feat_dtype) == (
        True, "float32")


def _gap_set(n=40, seed=3):
    """Synthetic graphs with an [energy, gap] label pair, the gap drawn
    from a seeded generator."""
    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    rng = np.random.default_rng(seed)
    graphs = synthetic_dataset(n, mean_atoms=6, seed=seed, edge_feat_dim=8)
    for g in graphs:
        g.y = np.array([float(rng.normal()), float(rng.gamma(1.5, 2.0))],
                       np.float32)
    return graphs


def test_labels_and_baselines_on_a_small_set(tmp_path):
    """`curve_labels` without an atomref standardizes the raw gap as the
    training CLI does (its standardization.json bitwise), and
    `check_curve_stats` holds it to a fixture without an atomref;
    `constant_baselines` is the train split's mean label's MAE on val and
    test."""
    from x2gnn_tpu_torch.data.dataset import save_graph_cache
    from x2gnn_tpu_torch.train.__main__ import main
    from x2gnn_tpu_torch.train.trainer import make_split, resolve_division

    graphs = _gap_set()
    _, tcfg = chip_smoke.gap_training_configs()
    targets, std, table, mu, sigma = chip_smoke.curve_labels(
        graphs, tcfg, atomref=False)
    gap = np.array([g.y[1] for g in graphs], np.float32)
    assert table is None and std == sigma
    assert (mu, sigma) == (float(np.mean(gap)), float(np.std(gap) + 1e-12))
    np.testing.assert_array_equal(
        targets, ((gap - mu) / sigma).astype(np.float32))

    npz = str(tmp_path / "gap.npz")
    save_graph_cache(npz, graphs)
    config = tmp_path / "small.json"
    config.write_text(json.dumps({
        "model": {"conv_layers": 1, "in_channels": 32, "embedding_size": 32,
                  "heads": 4, "edge_feat_dim": 8, "readout": "molwise_mean",
                  "dropout": 0.1, "attention_layout": "blocked"},
        "train": {"target": 4, "batch_size": 8, "max_epoch": 1,
                  "pack_mixed": True}}))
    run = tmp_path / "run"
    assert main(["--config", str(config), "--data-npz", npz,
                 "--standardize", "--pack-mixed", "--feat-dtype", "float16",
                 "--device", "cpu", "--workdir", str(run)]) == 0
    written = json.loads((run / "standardization.json").read_text())
    assert written == {"mu": mu, "sigma": sigma}
    assert not (run / "atomref.json").exists()
    chip_smoke.check_curve_stats(None, mu, sigma,
                                 {"standardization": written}, tag="gap")
    with pytest.raises(AssertionError, match="mu"):
        chip_smoke.check_curve_stats(None, mu * (1 + 1e-7), sigma,
                                     {"standardization": written})
    with pytest.raises(AssertionError, match="atomref"):
        chip_smoke.check_curve_stats({"1": 0.5}, mu, sigma,
                                     {"standardization": written})

    base = chip_smoke.constant_baselines(graphs, tcfg)
    train, val, test = make_split(len(graphs), tcfg.random_seed,
                                  resolve_division(len(graphs),
                                                   tcfg.division))
    y = gap.astype(np.float64)
    for key, c in (("", float(np.mean(y[train]))),
                   ("_median", float(np.median(y[train])))):
        assert base["train" + ("_mean" if not key else key)] == c
        assert base["val" + key] == float(np.mean(np.abs(y[val] - c)))
        assert base["test" + key] == float(np.mean(np.abs(y[test] - c)))
    assert len(base) == 6


def test_the_mode_refuses_the_cpu(monkeypatch):
    """Without a card --gap-full raises before it builds or starts
    anything, and the script exits non-zero with no ok line and no
    kernels line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    def refused(*a, **kw):
        raise AssertionError("a process was started")
    monkeypatch.setattr(subprocess, "run", refused)
    monkeypatch.setattr(subprocess, "Popen", refused)
    monkeypatch.setattr(chip_smoke.tempfile, "mkdtemp", refused)
    with pytest.raises(RuntimeError, match="--gap-full: no CUDA device"):
        chip_smoke.gap_full(n=64, deadline_s=60)
    monkeypatch.undo()
    out = subprocess.run([sys.executable, "chip_smoke.py", "--gap-full",
                          "--n", "64"], cwd=chip_smoke.REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr
