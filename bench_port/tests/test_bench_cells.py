"""Each cell's harness at a tiny size on the CPU, through the port's
plain kernel paths, up to the reference comparison."""

import math

import pytest

from bench_port.tests.tiny import CELLS, bench, run_tiny


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_cpu(cell):
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {e["name"] for e in bench()["end_to_end"]
            if cell in e.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    assert list(res)[-1] == "checks"
    assert all(r["value"] <= r["limit"] for r in res["checks"].values())


def test_same_seed_same_inputs():
    a, b = run_tiny("aid.train", seed=5), run_tiny("aid.train", seed=5)
    assert a["checks"] == b["checks"]


@pytest.mark.parametrize("mode", ["host", False])
def test_streamed_batches_are_correct_on_the_cpu(mode):
    """A traffic that sets the Trainer's cache mode needs no new code: the
    window's work is read from each step's labels, not from the batch
    objects the device cache keeps."""
    res = run_tiny("aid.train", seconds=0.5, trainer={"cache_batches": mode})
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
