"""Profiling and throughput accounting (x2gnn_tpu/utils/profiling.py).

`trace` records a torch.profiler trace (the card's kernels and copies
too when the device is CUDA) into a directory, as a Chrome trace file
that chrome://tracing or Perfetto opens. `StepTimer` times steps with a
warm-up discarded; `Throughput` turns a step time into the north-star
rates (edges/s per chip, triplets/s per chip, molecules/s).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the block and write `logdir/trace.json`; yields the
    torch.profiler profile (its `key_averages()` summarize the block).
    CUDA activity is recorded when `device` is a CUDA device (default:
    when a card is present). The trace is written also when the block
    raises."""
    device = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class StepTimer:
    """Per-step wall-clock timing with the first `warmup` steps discarded.
    On a CUDA device the card is synchronised when a step starts and when
    it ends, so a time is the step's own work, not its launches'."""

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.times = []
        self._t0: Optional[float] = None
        self._count = 0
        self._cuda = device is not None and torch.device(
            device).type == "cuda"

    def _sync(self):
        if self._cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


class Throughput:
    """North-star counters: edges/s/chip, triplets/s/chip, molecules/s."""

    def __init__(self, edges_per_batch: int, triplets_per_batch: int,
                 molecules_per_batch: int, num_chips: int = 1):
        self.e = edges_per_batch
        self.t = triplets_per_batch
        self.m = molecules_per_batch
        self.chips = max(num_chips, 1)

    def rates(self, seconds_per_step: float) -> Dict[str, float]:
        s = max(seconds_per_step, 1e-12)
        return {
            "edges_per_sec_per_chip": self.e / s / self.chips,
            "triplets_per_sec_per_chip": self.t / s / self.chips,
            "molecules_per_sec": self.m / s,
            "seconds_per_step": seconds_per_step,
        }
