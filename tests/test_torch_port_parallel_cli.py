"""The training CLI's parallel flags on the CPU (x2gnn_tpu_torch/train/
__main__.py, train.py:288-321): --data-parallel, --edge-partition
{allgather,ring} and --dp-groups, their refusals, one rank in this
process and two under `python -m torch.distributed.run`."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_port_model import one_torch_thread  # noqa: F401
from x2gnn_tpu_torch.train.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"model": {"conv_layers": 1, "in_channels": 32, "embedding_size": 32,
                   "heads": 4, "sbf_dim": 3, "rbf_dim": 4, "edge_feat_dim": 8,
                   "attention_layout": "blocked"},
         "train": {"batch_size": 4, "ckpt_after_epoch": 0}}


@pytest.fixture
def config(tmp_path):
    path = tmp_path / "small.json"
    path.write_text(json.dumps(SMALL))
    return str(path)


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _run(config, workdir, *flags):
    """One CPU rank in this process; the process group is gone after."""
    rc = main(["--device", "cpu", "--synthetic", "12", "--epochs", "1",
               "--config", config, "--workdir", str(workdir), *flags])
    assert not dist.is_initialized()
    return rc


def test_dp_groups_without_edge_partition_exits_2(config, tmp_path,
                                                   capsys):
    assert _run(config, tmp_path / "w", "--dp-groups", "2") == 2
    assert "--dp-groups requires --edge-partition" in capsys.readouterr().err


def test_dp_groups_that_do_not_divide_the_ranks_exit_2(config, tmp_path,
                                                       capsys):
    assert _run(config, tmp_path / "w", "--edge-partition", "ring",
                "--dp-groups", "2") == 2
    assert "--dp-groups 2 does not divide 1 ranks" in \
        capsys.readouterr().err


def test_edge_partition_implies_the_blocked_layout(config, tmp_path, capsys):
    from x2gnn_tpu_torch.config import load_configs
    assert _run(config, tmp_path / "w", "--edge-partition", "allgather",
                "--layout", "segment") == 0
    assert "edge partitioning implies the blocked layout" in \
        capsys.readouterr().err
    mcfg, _ = load_configs(str(tmp_path / "w" / "args.json"))
    assert mcfg.attention_layout == "blocked"


def test_int8_features_with_edge_partition_are_refused(config, tmp_path):
    with pytest.raises(ValueError, match="int8"):
        _run(config, tmp_path / "w", "--edge-partition", "ring",
             "--feat-dtype", "int8")
    from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.train.trainer import Trainer
    cfg = ModelConfig(**SMALL["model"])
    with pytest.raises(ValueError, match="int8"):
        Trainer(X2GNN(cfg, device="cpu"), cfg, TrainConfig(), [],
                np.zeros(0), device="cpu", edge_partition="ring",
                feat_dtype="int8")


@pytest.mark.parametrize("flags", [
    ("--data-parallel",), ("--edge-partition", "allgather"),
    ("--edge-partition", "ring"),
    ("--edge-partition", "ring", "--dp-groups", "1")])
def test_parallel_flags_train_one_rank_on_the_cpu(config, tmp_path, capsys,
                                                  flags):
    """One rank (a process group of this process alone): the epoch runs
    and trains as the plain CLI does on the same data."""
    assert _run(config, tmp_path / "par", *flags) == 0
    assert _run(config, tmp_path / "plain") == 0
    got, want = _records(tmp_path / "par"), _records(tmp_path / "plain")
    assert len(got) == len(want) == 1
    for key in ("loss", "val_mae", "step"):
        np.testing.assert_allclose(got[0][key], want[0][key], rtol=1e-3,
                                   err_msg=key)


def test_data_parallel_resumes(config, tmp_path, capsys):
    """--auto-resume under --data-parallel continues the run."""
    w = tmp_path / "w"
    assert _run(config, w, "--data-parallel", "--ckpt-every", "1") == 0
    assert main(["--device", "cpu", "--synthetic", "12", "--epochs", "2",
                 "--config", config, "--workdir", str(w), "--data-parallel",
                 "--auto-resume"]) == 0
    assert [r["epoch"] for r in _records(w)] == [1, 2]
    assert "resumed from" in capsys.readouterr().err


def test_parallel_entry_points_default_to_the_card(config, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    for flags in (["--data-parallel"], ["--edge-partition", "ring"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--synthetic", "4", "--config", config, "--workdir",
                  str(tmp_path), *flags])
        assert not dist.is_initialized()


def test_two_ranks_under_torch_distributed_run(config, tmp_path):
    """Two CPU ranks started by torch.distributed.run, in data parallelism
    and with the atoms split by the ring: each run trains 2 epochs, and
    rank 0 alone wrote one record and one log line per epoch and printed
    one summary."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [REPO] + os.environ.get("PYTHONPATH", "").split(os.pathsep))}
    runs = {}
    for name, flags in (("dp", ["--data-parallel"]),
                        ("ep", ["--edge-partition", "ring"])):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "x2gnn_tpu_torch.train",
               "--device", "cpu", "--synthetic", "16", "--epochs", "2",
               "--config", config, "--workdir", str(tmp_path / name),
               *flags]
        runs[name] = subprocess.Popen(cmd, cwd=str(tmp_path), env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
    for name, proc in runs.items():
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-3000:]
        summaries = [line for line in out.splitlines() if line.startswith("{")]
        assert len(summaries) == 1, out
        assert np.isfinite(json.loads(summaries[0])["best_val_mae"])
        records = _records(tmp_path / name)
        assert [r["epoch"] for r in records] == [1, 2]
        assert all(np.isfinite(r["loss"]) for r in records)
        with open(tmp_path / name / "train.log") as f:
            assert len(f.readlines()) == 2
        assert "over 2 ranks (gloo)" in err
