"""`chip_smoke.py --a12-full` on the CPU: its gate against the two JAX runs'
own records, the records read from runs/, the deadline-and-poll loop
around a stand-in trainer, and the mode's refusal of the CPU."""

import json
import math
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke

RUNS = chip_smoke.A12_RUNS


def _records(run):
    return [dict(r) for r in chip_smoke.a12_references()["curves"][run]]


def _failed(records):
    return chip_smoke.a12_gate(records, chip_smoke.a12_references())[1]


@pytest.mark.parametrize("run", RUNS)
def test_gate_passes_each_jax_runs_own_curve(run):
    """Each JAX run's own records pass, at every cut from 5 epochs on.
    r4_mixed's records carry the occupancy of an earlier planner (0.347):
    the gate holds the port to r5_regression's, so it is set to that."""
    refs = chip_smoke.a12_references()
    records = _records(run)
    for r in records:
        r["occupancy_pairs"] = refs["occupancy_pairs"]
    for cut in (5, 8, 12, 20):
        rows, faults = chip_smoke.a12_gate(records[:cut], refs)
        assert faults == [], (cut, faults)
        assert [r[0] for r in rows] == ["best_val_mae"] * cut + ["test_mae"]
        assert all(r[-1] for r in rows)


def _spoiled(change):
    records = _records(RUNS[0])[:8]
    change(records)
    return _failed(records)


def test_gate_fails_a_curve_over_the_band():
    """1.3 x the larger JAX best_val_mae at epoch 5 is over the 1.25 limit;
    1.3 x at epoch 2 is within the early 1.5; 1.3 x the larger test_mae at
    the last epoch is over its 1.25."""
    refs = chip_smoke.a12_references()
    curves = [refs["curves"][run] for run in RUNS]

    def band(e, key="best_val_mae"):
        return max(c[e - 1][key] for c in curves)

    def at5(records):
        records[4]["best_val_mae"] = 1.3 * band(5)
    faults = _spoiled(at5)
    assert len(faults) == 1 and "best_val_mae at epoch 5" in faults[0]

    def at2(records):
        records[1]["best_val_mae"] = 1.3 * band(2)
    assert _spoiled(at2) == []

    def test_last(records):
        records[7]["test_mae"] = 1.3 * band(8, "test_mae")
    faults = _spoiled(test_last)
    assert len(faults) == 1 and "test_mae at epoch 8" in faults[0]


@pytest.mark.parametrize("case", ["four epochs", "bad steps", "wrong step",
                                  "occupancy", "non-finite loss",
                                  "missing epoch"])
def test_gate_fails_a_broken_record(case):
    def change(records):
        if case == "four epochs":
            del records[4:]
        elif case == "bad steps":
            records[3]["bad_steps"] = 1
        elif case == "wrong step":
            records[6]["step"] += 1
        elif case == "occupancy":
            records[2]["occupancy_pairs"] = np.nextafter(
                records[2]["occupancy_pairs"], 1.0)
        elif case == "non-finite loss":
            records[5]["loss"] = math.nan
        else:
            del records[3]
    faults = _spoiled(change)
    assert faults, case
    word = {"four epochs": "fewer than 5", "bad steps": "bad_steps",
            "wrong step": "step", "occupancy": "occupancy_pairs",
            "non-finite loss": "loss", "missing epoch": "is epoch"}[case]
    assert any(word in f for f in faults), faults


def test_gate_without_references_checks_the_records_alone():
    """A set other than the A12 set: no JAX row, no epoch minimum, the
    step count of the first epoch held for the others."""
    records = [{"epoch": e, "step": 48 * e, "bad_steps": 0, "loss": 0.5,
                "best_val_mae": 1.0, "test_mae": 1.0} for e in (1, 2, 3)]
    assert chip_smoke.a12_gate(records, None) == ([], [])
    records[2]["step"] = 143
    assert chip_smoke.a12_gate(records, None)[1] == [
        "epoch 3: step 143, not 144"]
    assert chip_smoke.a12_gate([], None)[1] == ["no complete epoch"]


def test_references_are_read_from_the_runs_files(tmp_path):
    """The values come from runs/*/: the same as the files say, and a
    changed copy of the files changes them."""
    refs = chip_smoke.a12_references()
    root = chip_smoke.REPO
    with open(f"{root}/runs/{RUNS[0]}/standardization.json") as f:
        assert refs["standardization"] == json.load(f)
    with open(f"{root}/runs/{RUNS[0]}/atomref.json") as f:
        assert refs["atomref"] == json.load(f)
    for run in RUNS:
        with open(f"{root}/runs/{run}/metrics.jsonl") as f:
            assert refs["curves"][run] == [json.loads(x) for x in f]
    assert refs["steps_per_epoch"] == 1172
    assert refs["occupancy_pairs"] == refs["curves"][RUNS[0]][0][
        "occupancy_pairs"]
    for run in RUNS:
        shutil.copytree(f"{root}/runs/{run}", tmp_path / run)
    path = tmp_path / RUNS[0] / "metrics.jsonl"
    records = [json.loads(x) for x in path.read_text().splitlines()]
    for r in records:
        r["step"] = 1000 * r["epoch"]
        r["occupancy_pairs"] = 0.5
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    (tmp_path / RUNS[0] / "standardization.json").write_text(
        json.dumps({"mu": 1.0, "sigma": 2.0}))
    changed = chip_smoke.a12_references(str(tmp_path))
    assert (changed["steps_per_epoch"], changed["occupancy_pairs"]) == (
        1000, 0.5)
    assert changed["standardization"] == {"mu": 1.0, "sigma": 2.0}


# a stand-in trainer: one metrics line per second, each written in two
# pieces half a second apart (a kill can land inside a line); "hang" stops
# after three lines inside a fourth
STAND_IN = """
import json, sys, time
path, hang = sys.argv[1], sys.argv[2] == "hang"
for epoch in range(1, 1000):
    line = json.dumps({"epoch": epoch, "step": 10 * epoch}) + "\\n"
    with open(path, "a") as f:
        f.write(line[:9])
        f.flush()
        if hang and epoch == 4:
            time.sleep(1000)
        time.sleep(0.5)
        f.write(line[9:])
    time.sleep(0.5)
"""


@pytest.mark.parametrize("mode", ["steady", "hang"])
def test_train_until_stops_at_the_deadline(tmp_path, mode):
    """The loop stops the stand-in before its next line would end past the
    deadline (the gap between two lines predicts the next) and returns
    exactly the file's complete lines; the process and its group end."""
    script = tmp_path / "stand_in.py"
    script.write_text(STAND_IN)
    metrics = tmp_path / "metrics.jsonl"
    polls = []
    t0 = time.perf_counter()
    records, rc, stopped, seen = chip_smoke.train_until(
        [sys.executable, str(script), str(metrics), mode], str(metrics),
        t0 + 6.6, poll_s=0.1, on_poll=polls.append, cwd=str(tmp_path))
    elapsed = time.perf_counter() - t0
    assert stopped and rc is not None and rc != 0
    assert polls and all(p.poll() is not None for p in polls)
    assert elapsed < 6.6 + 1.0
    text = metrics.read_text()
    complete = [json.loads(x) for x in text.split("\n")[:-1]]
    assert records == complete
    assert [r["epoch"] for r in records] == list(
        range(1, len(records) + 1))
    assert len(records) >= 2 and sorted(seen) == [
        r["epoch"] for r in records]
    if mode == "hang":
        assert len(records) == 3 and not text.endswith("\n")
    # the next line was predicted from the gaps, so the stop came at
    # least a gap before the deadline
    assert elapsed < 6.6 - 0.5


def test_train_until_returns_when_the_trainer_ends(tmp_path):
    metrics = tmp_path / "metrics.jsonl"
    code = ("import json, sys\n"
            "open(sys.argv[1], 'w').write(json.dumps({'epoch': 1}) + '\\n')")
    records, rc, stopped, seen = chip_smoke.train_until(
        [sys.executable, "-c", code, str(metrics)], str(metrics),
        time.perf_counter() + 60, poll_s=0.05, cwd=str(tmp_path))
    assert (records, rc, stopped) == ([{"epoch": 1}], 0, False)


def test_the_mode_refuses_the_cpu(tmp_path, monkeypatch):
    """Without a card the mode raises before it builds or starts anything,
    and the script exits non-zero with no ok line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    def refused(*a, **kw):
        raise AssertionError("a process was started")
    monkeypatch.setattr(subprocess, "run", refused)
    monkeypatch.setattr(subprocess, "Popen", refused)
    monkeypatch.setattr(chip_smoke.tempfile, "mkdtemp", refused)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.a12_full(n=64, deadline_s=60)
    monkeypatch.undo()
    out = subprocess.run([sys.executable, "chip_smoke.py", "--a12-full",
                          "--n", "64"], cwd=chip_smoke.REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr
