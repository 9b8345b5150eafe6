"""`chip_smoke.py --multi-card` on the CPU: its rank functions for DP, EP
and DP x EP on 4 gloo ranks at a small width with every gate passing, each
gate failing on a spoiled input, the mode refusing the CPU and fewer than
4 cards, the torch.distributed.run command lines it builds, the training
CLI's gate, and a hung rank stopped at its launch's deadline.

Each rank function runs the mode's own gates through `mc_agree`, so a
failure raises on every rank at once; `tests/torch_port_ranks.py::
spoiled` spoils one input on one rank. On the CPU the plain kernels run
and count no launch (the gates expect 0 there); the window checks against
the plain kernels run on the card only."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

import chip_smoke
from torch_port_ranks import Ranks, jobs, spoiled
from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset

MCFG = ModelConfig(conv_layers=2, in_channels=32, embedding_size=32,
                   heads=4, sbf_dim=7, rbf_dim=6, edge_feat_dim=8,
                   attention_layout="blocked")
TCFG = TrainConfig(batch_size=4, pack_mixed=True, warmup_steps=2)
WORLD = 4


@pytest.fixture(scope="module")
def inputs():
    """10 packed host batches as the mode plans them (the last DP group
    ragged over 4 ranks), and an AID-scale batch with D > 40."""
    hosts = chip_smoke.mc_packed_hosts(
        MCFG, TCFG, synthetic_dataset(60, mean_atoms=9, seed=11,
                                      edge_feat_dim=8), 10)
    aid = chip_smoke.whole_batch(synthetic_dataset(
        2, mean_atoms=64, seed=3, edge_feat_dim=8))
    assert aid.in_edges.shape[1] > 40
    return hosts, aid


@pytest.fixture(scope="module")
def ranks_out(inputs, tmp_path_factory):
    """One start of 4 gloo ranks: the rank functions as the mode calls
    them, then each spoiled (`spoiled`): one rank's parameters one ulp off,
    one gradient of one rank's reference 1e-2 off, ring and allgather
    made to differ. Each rank's (passing results, failure messages)."""
    hosts, aid = inputs
    dp_args = ("cpu", MCFG, TCFG, hosts)
    calls = [(chip_smoke.mc_dp, dp_args),
             (chip_smoke.mc_ep, ("cpu", MCFG, TCFG,
                                 {"flagship": hosts[0], "AID": aid}, 2)),
             (chip_smoke.mc_hybrid, dp_args),
             (chip_smoke.mc_turns, ("cpu", MCFG, TCFG, hosts, 1)),
             (spoiled, ("ulp", chip_smoke.mc_dp, dp_args)),
             (spoiled, ("grad", chip_smoke.mc_dp, dp_args)),
             (spoiled, ("ring", chip_smoke.mc_ep,
                        ("cpu", MCFG, TCFG, {"flagship": hosts[0]}, 1)))]
    out = Ranks(jobs, WORLD, tmp_path_factory.mktemp("ranks"), calls).wait()
    return [(r[:4], r[4:]) for r in out]


def test_rank_functions_pass_on_four_gloo_ranks(inputs, ranks_out):
    hosts, aid = inputs
    dp, ep, hybrid, turns = zip(*(passed for passed, _ in ranks_out))
    # (b): 3 steps, the last group of 2 batches: fillers on ranks 2 and 3
    for r, res in enumerate(dp):
        assert len(res["steps"]) == 3
        assert res["digest"] == dp[0]["digest"]
        assert (res["steps"][-1]["graphs_here"] == 0) == (r >= 2)
        assert all(s["worst"] < 1e-3 for s in res["steps"])
    # (c): the atoms split evenly, every pair on exactly one rank
    for name, batch in (("flagship", hosts[0]), ("AID", aid)):
        recs = [res[name] for res in ep]
        n = recs[0]["N"]
        assert [r["Nl"] for r in recs] == [n // WORLD] * WORLD
        assert n >= batch.in_edges.shape[0]
        whole = chip_smoke.ep_valid_pairs(batch, (1,))[1][0]
        assert sum(r["valid_pairs"] for r in recs) == whole
        assert all(r["launches"] == {"fwd": 0, "bwd": 0, "reduce": 0}
                   for r in recs)
        assert all(set(r["exchange_ms"]) == {"allgather", "ring"}
                   for r in recs)
        assert recs[0]["window"] == [n // WORLD, recs[0]["D"],
                                     recs[0]["D"]]
    assert ep[0]["AID"]["D"] > 40
    assert len({res["steps"]["ring"]["digest"] for res in ep}) == 1
    # (d)
    assert len({round(res["loss"], 12) for res in hybrid}) == 1
    # (f): each path timed twice, in turns
    assert set(turns[0]) == {"plain", "dp", "ep allgather", "ep ring",
                             "dp x ep allgather", "dp x ep ring"}
    assert all(len(v) == 2 for v in turns[0].values())


def test_each_gate_fails_on_a_spoiled_input(ranks_out):
    """Each spoiled gate raises, on every rank, naming what failed."""
    for _, (ulp, grad, ring) in ranks_out:
        assert ulp is not None and "DP step 1: the parameters" in ulp
        assert "not the same bits" in ulp
        assert grad is not None and grad.startswith(
            "DP 4 ranks, step 1: gradients: rank 2:")
        assert "differs" in grad
        assert ring is not None and "ring and allgather" in ring


def test_placement_gate():
    good = [{"rank": r, "local_rank": r, "index": r, "current": r,
             "uuid": f"GPU-{r}", "name": "card", "backend": "nccl"}
            for r in range(WORLD)]
    chip_smoke.placement_gate(good, WORLD)
    for field, value, what in (("uuid", "GPU-0", "UUIDs"),
                               ("index", 0, "on card"),
                               ("backend", "gloo", "over gloo")):
        bad = [dict(r) for r in good]
        bad[2][field] = value
        with pytest.raises(AssertionError, match=what):
            chip_smoke.placement_gate(bad, WORLD)


def test_mode_refuses_the_cpu_and_fewer_cards(monkeypatch, capsys):
    out = subprocess.run([sys.executable, "chip_smoke.py", "--multi-card"],
                         cwd=chip_smoke.REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "0 CUDA devices" in out.stderr and '"ok"' not in out.stdout

    def refused():
        raise AssertionError("the mode ran")

    monkeypatch.setattr(chip_smoke, "multi_card", refused)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert chip_smoke.main(["--multi-card"]) == 1
    assert "2 CUDA devices" in capsys.readouterr().err


def test_torchrun_command_lines(monkeypatch, tmp_path):
    """The rank group's command line, as multi_card builds it after the
    kernels are built once."""
    assert chip_smoke.mc_torchrun(["-m", "x"]) == [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", "4", "-m", "x"]
    launched, built = [], []

    def launch(cmd, phase, deadline_s, stem, run_dir=None):
        launched.append((cmd, phase, deadline_s, run_dir))
        raise KeyboardInterrupt

    monkeypatch.setattr(chip_smoke, "MC_OUT", str(tmp_path / "out"))
    monkeypatch.setattr(chip_smoke, "mc_launch", launch)
    monkeypatch.setattr(chip_smoke, "_host_lines", lambda cmd: ["card"])
    monkeypatch.setattr(torch.cuda.nccl, "version", lambda: (2, 0, 0))
    from x2gnn_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "build_all", lambda: built.append(1) or {})
    with pytest.raises(KeyboardInterrupt):
        chip_smoke.multi_card()
    (cmd, phase, deadline_s, run_dir), = launched
    assert built == [1]
    assert cmd == chip_smoke.mc_torchrun([
        os.path.join(chip_smoke.REPO, "chip_smoke.py"), "--multi-card-rank",
        str(tmp_path / "out")])
    assert run_dir == str(tmp_path / "out")
    assert phase == "the rank group of (a)-(d), (f)"
    assert 0 < deadline_s <= chip_smoke.MC_RANKS_S


def _run_dir(tmp_path, records, epochs_logged):
    wd = tmp_path / "run"
    wd.mkdir()
    (wd / "metrics.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in records))
    (wd / "train.log").write_text("line\n" * epochs_logged)
    return str(wd)


@pytest.mark.parametrize("spoil", [None, "every rank wrote", "skipped",
                                   "steps", "nan"])
def test_cli_gate(tmp_path, spoil):
    records = [{"epoch": e, "loss": 0.5, "val_mae": 1.0,
                "best_val_mae": 1.0, "step": 3 * e, "bad_steps": 0,
                "seconds": 1.0, "molecules_per_sec": 9.0} for e in (1, 2)]
    mode = "data parallel over 4 ranks (nccl)"
    stdout, stderr, logged = '{"best_val_mae": 1.0}\n', mode + "\n", 2
    if spoil == "every rank wrote":
        records, logged = records * 4, 8
        stdout *= 4
    elif spoil == "skipped":
        records[1]["bad_steps"] = 1
    elif spoil == "steps":
        records[1]["step"] = 5
    elif spoil == "nan":
        records[0]["loss"] = float("nan")
    wd = _run_dir(tmp_path, records, logged)
    if spoil is None:
        assert chip_smoke.cli_gate("cli", wd, stdout, stderr, 2, 3,
                                   mode) == records
    else:
        with pytest.raises(AssertionError):
            chip_smoke.cli_gate("cli", wd, stdout, stderr, 2, 3, mode)


HANG = """
import os, sys, time
import torch.distributed as dist
sys.path.insert(0, {repo!r})
import chip_smoke
run_dir = sys.argv[1]
rank = int(os.environ["RANK"])
dist.init_process_group("gloo")
with open(os.path.join(run_dir, f"pid.rank{{rank}}"), "w") as f:
    f.write(str(os.getpid()))
chip_smoke.mc_note(run_dir, rank, "a stand-in collective")
if rank == 3:
    time.sleep(600)
dist.barrier()
"""


def test_a_hung_rank_is_stopped_at_the_deadline(tmp_path):
    """Rank 3 never joins the barrier: the launch is stopped at its
    deadline with every rank and torch.distributed.run itself, and the
    failure names the launch's phase and where each rank was."""
    script = tmp_path / "hang.py"
    script.write_text(HANG.format(repo=chip_smoke.REPO))
    deadline = 15.0
    t0 = time.monotonic()
    with pytest.raises(AssertionError) as failed:
        chip_smoke.mc_launch(chip_smoke.mc_torchrun([str(script),
                                                     str(tmp_path)]),
                             "(x) a stand-in phase", deadline,
                             str(tmp_path / "hang"), run_dir=str(tmp_path))
    took = time.monotonic() - t0
    msg = str(failed.value)
    assert msg.startswith("(x) a stand-in phase: still running at its "
                          "deadline of 15 s")
    assert "a stand-in collective" in msg
    assert deadline <= took < deadline + 25
    pids = [int((tmp_path / f"pid.rank{r}").read_text())
            for r in range(WORLD)]
    assert not any(chip_smoke._running(p) for p in pids)
