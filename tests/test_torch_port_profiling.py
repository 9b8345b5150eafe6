"""The port's profiling hooks on the CPU: StepTimer and Throughput
against the JAX package's (x2gnn_tpu/utils/profiling.py), a traced epoch
(`Trainer.fit(profile_dir=)`) that changes no record and no parameter,
and the training CLI's --profile-dir and --check-determinism."""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_port_model import SMALL, one_torch_thread  # noqa: F401
from x2gnn_tpu.utils import profiling as jprofiling
from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.train.__main__ import main as train_main
from x2gnn_tpu_torch.train.trainer import Trainer
from x2gnn_tpu_torch.utils import determinism, profiling


class _Clock:
    """A perf_counter that advances by the given steps."""

    def __init__(self, steps):
        self.t, self.steps = 0.0, iter(steps)

    def __call__(self):
        self.t += next(self.steps)
        return self.t


@pytest.mark.parametrize("warmup", [0, 2])
def test_step_timer_discards_warmup_as_jax(monkeypatch, warmup):
    """Both timers, on the same clock: the first `warmup` steps dropped,
    the mean over the rest (0 with none)."""
    durations = [5.0, 3.0, 1.0, 2.0, 4.0]
    ticks = [x for d in durations for x in (1.0, d)]
    timers = {}
    for name, mod in (("port", profiling), ("jax", jprofiling)):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(ticks))
        t = mod.StepTimer(warmup=warmup)
        assert t.mean == 0.0
        for _ in durations:
            with t:
                pass
        timers[name] = t
    assert timers["port"].times == timers["jax"].times == durations[warmup:]
    assert timers["port"].mean == timers["jax"].mean == pytest.approx(
        np.mean(durations[warmup:]))


def test_step_timer_synchronises_only_on_the_card(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: calls.append(1))
    with profiling.StepTimer(device="cpu"):
        pass
    assert calls == []
    with profiling.StepTimer(device="cuda"):
        pass
    assert calls == [1, 1]                       # at enter and at exit


@pytest.mark.parametrize("seconds", [0.25, 1e-15, 0.0])
def test_throughput_rates_equal_jax(seconds):
    args = (9016, 61234, 48, 4)
    assert (profiling.Throughput(*args).rates(seconds)
            == jprofiling.Throughput(*args).rates(seconds))
    assert profiling.Throughput(10, 20, 3, 0).rates(2.0) == {
        "edges_per_sec_per_chip": 5.0, "triplets_per_sec_per_chip": 10.0,
        "molecules_per_sec": 1.5, "seconds_per_step": 2.0}


def test_trace_writes_a_chrome_trace_also_on_error(tmp_path):
    with profiling.trace(str(tmp_path / "a"), "cpu") as prof:
        torch.ones(8).sum()
    assert prof.key_averages()
    trace = json.loads((tmp_path / "a" / profiling.TRACE_FILE).read_text())
    assert trace["traceEvents"]
    with pytest.raises(ValueError):
        with profiling.trace(str(tmp_path / "b"), "cpu"):
            raise ValueError("inside")
    assert (tmp_path / "b" / profiling.TRACE_FILE).exists()


def _run(tmp_path, name, profile_dir=None):
    cfg = ModelConfig(**SMALL)
    tcfg = TrainConfig(batch_size=8, max_epoch=3, ckpt_after_epoch=0,
                       fused_update=True, pack_mixed=True)
    graphs = synthetic_dataset(20, mean_atoms=7, seed=17, edge_feat_dim=8,
                               target="random")
    model = X2GNN(cfg, torch.Generator().manual_seed(0), device="cpu")
    tr = Trainer(model, cfg, tcfg, graphs,
                 np.array([g.y[0] for g in graphs], np.float32),
                 workdir=str(tmp_path / name), device="cpu")
    state, _ = tr.fit(profile_dir=profile_dir)
    records = [{k: v for k, v in json.loads(line).items()
                if k != "seconds" and not k.endswith("_per_sec")}
               for line in open(os.path.join(tr.workdir, "metrics.jsonl"))]
    return records, state


def test_fit_traces_the_second_epoch_and_changes_nothing(tmp_path,
                                                         monkeypatch):
    """fit(profile_dir=) traces epoch 2 only (trainer.py:612-617) into a
    trace file; the run's records and state equal an untraced run's bit
    for bit."""
    traced_epochs = []
    real = profiling.trace

    def spy(logdir, device=None):
        traced_epochs.append(logdir)
        return real(logdir, device)

    monkeypatch.setattr(profiling, "trace", spy)
    prof = tmp_path / "prof"
    traced, traced_state = _run(tmp_path, "traced", str(prof))
    plain, plain_state = _run(tmp_path, "plain")
    assert traced_epochs == [str(prof)]
    assert os.path.getsize(prof / profiling.TRACE_FILE) > 0
    assert traced == plain and len(plain) == 3
    assert determinism.tree_bitwise_diff(traced_state, plain_state) == []


def _cli(tmp_path, *extra):
    config = tmp_path / "small.json"
    config.write_text(json.dumps({"model": SMALL, "train": {
        "batch_size": 8, "ckpt_after_epoch": 100}}))
    return train_main(["--device", "cpu", "--synthetic", "16", "--epochs",
                       "2", "--config", str(config), "--pack-mixed",
                       "--workdir", str(tmp_path / "run"), *extra])


def test_cli_profile_dir_and_check_determinism(tmp_path, capsys):
    assert _cli(tmp_path, "--check-determinism", "--profile-dir",
                str(tmp_path / "prof"), "--cache-batches", "host") == 0
    assert "determinism check: OK" in capsys.readouterr().err
    assert (tmp_path / "prof" / profiling.TRACE_FILE).exists()
    assert len((tmp_path / "run" / "metrics.jsonl").read_text()
               .splitlines()) == 2


def test_cli_check_determinism_exits_3_on_a_mismatch(tmp_path, capsys,
                                                     monkeypatch):
    """A step that differs between its two runs stops the CLI before
    training, with exit code 3 (train.py:344-353)."""
    def mismatch(trainer, state=None):
        return {"deterministic": False, "repeats": 2,
                "mismatches": ["run 1: loss: 1 element(s) differ"]}

    monkeypatch.setattr(determinism, "check_train_step_determinism",
                        mismatch)
    assert _cli(tmp_path, "--check-determinism") == 3
    assert "MISMATCH" in capsys.readouterr().err
    assert not (tmp_path / "run" / "metrics.jsonl").exists()


def test_event_rows_sum_the_profilers_own_events():
    # event_rows reads the raw events; torch's parsed FunctionEvents of the
    # same trace (what key_averages sums) give the same us and count per
    # name. On the CPU the test reads CPU ops: the card's kernels are
    # events of the same kind, of device type CUDA. No op here calls an op
    # of its own name: torch's parse merges such CPU pairs into one event,
    # which kernels never are.
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name
    from torch.profiler import ProfilerActivity, profile

    from x2gnn_tpu_torch.profile_serving import device_rows, event_rows

    x = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 64)))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            torch.exp((x @ x).relu())
    want = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and not e.is_async:
            us, n = want.get(e.name, (0.0, 0))
            want[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    rows = event_rows(prof, DeviceType.CPU)
    got = {name: (us, n) for us, n, name in rows if not _filter_name(name)}
    assert rows == sorted(rows, reverse=True)
    assert got.keys() == {k for k, (us, _) in want.items() if us > 0}
    assert "aten::mm" in got
    for name, (us, n) in got.items():
        assert n == want[name][1]
        assert us == pytest.approx(want[name][0], rel=1e-9, abs=1e-3)
    with pytest.raises(RuntimeError, match="no device time"):
        device_rows(prof)
