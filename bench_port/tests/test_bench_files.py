"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""

import json
import os
import re

import pytest

from bench_port import check, run

B = run.load_json(run.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads",
               "layer", "moves"}


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["bench_port"]
    assert 1 <= B["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in B["command"])
    assert len(json.dumps(B)) < 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in B["configs"]]
             + [w["name"] for w in B["workloads"]]
             + [w["traffic"] for w in B["workloads"]]
             + [m["name"] for m in B["end_to_end"] + B["per_layer"]])
    assert all(NAME.match(n) for n in names), names
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= METRIC_KEYS
    for text in ([w["why"] for w in B["workloads"]]
                 + [c["source"] for c in B["configs"]]
                 + [m["layer"] for m in B["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in B["workloads"]:
        cell = w["name"]
        assert w["chips"] == 1
        mine = [m for m in B["end_to_end"]
                if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layer = [m for m in B["per_layer"]
                 if cell in m.get("workloads", [cell])]
        assert layer
        for m in layer:
            assert m["moves"] in {x["name"] for x in mine}


def test_every_file_is_found_by_name():
    for c in B["configs"]:
        cfg = run.load_json(run.ROOT, c["file"])
        assert c["file"].startswith("bench_port/configs/")
        assert cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in B["workloads"])
    for w in B["workloads"]:
        traffic = run.load_json(run.HERE, "traffic", f"{w['traffic']}.json")
        assert callable(run.driver(traffic["kind"]).run)
        assert set(check.limits(w["name"])) == {
            "loss_gap", "grad_gap", "change_gap", "ema_gap"}
    for m in B["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_a_driver_is_found_by_its_kind_alone():
    from bench_port import drive_train
    assert run.driver("train") is drive_train
    with pytest.raises(ModuleNotFoundError):
        run.driver("no_such_kind")


@pytest.mark.parametrize("metric", [m["name"] for m in B["per_layer"]])
def test_readers_return_nothing_without_a_reading(metric):
    rec = {"kind": "train", "window": {
        "seconds": 1.0, "steps": 0, "molecules": 0, "flops": 0.0,
        "dispatch_s": [], "launches": 0}}
    assert run.reader(metric)(rec) is None


def test_readers_on_a_traced_run():
    trace = {"window_s": 2.0, "busy_s": 0.5, "attn_fwd_s": 0.1,
             "attn_bwd_s": 0.2, "attn_fwd_bound_s": 0.01,
             "attn_bwd_bound_s": 0.01}
    train = {"kind": "train", "trace": trace, "window": {
        "seconds": 2.0, "steps": 10, "molecules": 300, "flops": 13.4e12,
        "dispatch_s": [0.01, 0.03, 0.02], "launches": 960}}
    got = {m["name"]: run.reader(m["name"])(train) for m in B["per_layer"]}
    assert got["train_step_mfu"] == pytest.approx(10.0)
    assert got["train.device_idle"] == pytest.approx(75.0)
    assert got["train.attn_fwd_roofline"] == pytest.approx(10.0)
    assert got["train.attn_bwd_roofline"] == pytest.approx(5.0)
    assert got["train.attn_launches_per_step"] == 96
    assert got["train.dispatch_ms"] == pytest.approx(20.0)


def test_limits_record_their_readings():
    for w in B["workloads"]:
        with open(os.path.join(run.HERE, "limits", f"{w['name']}.json")) as f:
            raw = json.load(f)
        for k, v in raw["limits"].items():
            assert 0 < v < 1, (w["name"], k)
