"""What a traced slice of a run gives the per-layer metrics: device busy
time as the union of the intervals in which a kernel, copy or set ran,
device time per kernel name, device time of the kernels launched under
a labelled host range, and the device's idle gaps labelled by the host
operation running during them.

Everything is read from the profiler's raw events (as the port's
`profile_serving.event_rows` reads them): `key_averages()` builds a Python
object per event and takes seconds per traced training step. A kernel
belongs to a labelled range when the host call that launched it (matched
by the profiler's correlation id) started inside it, so a renamed or split
kernel still counts.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
from typing import Dict, Iterable, List, Tuple

import torch

# host ranges that the benchmark opens around calls into the port
ATTN_FWD, ATTN_BWD = "bench_port.attn_fwd", "bench_port.attn_bwd"
LABELS = (ATTN_FWD, ATTN_BWD)


def _wrap(fn, label):
    @functools.wraps(fn)
    def inner(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)
    return inner


@contextlib.contextmanager
def attention_ranges():
    """Open ATTN_FWD around every forward and ATTN_BWD around every
    backward of the port's fused attention (the autograd op's calls of
    `blocked_attention_fwd` and `blocked_attention_bwd`)."""
    from x2gnn_tpu_torch.ops import blocked_attn as ba
    fwd, bwd = ba.blocked_attention_fwd, ba.blocked_attention_bwd
    ba.blocked_attention_fwd = _wrap(fwd, ATTN_FWD)
    ba.blocked_attention_bwd = _wrap(bwd, ATTN_BWD)
    try:
        yield
    finally:
        ba.blocked_attention_fwd, ba.blocked_attention_bwd = fwd, bwd


def _usable(e) -> bool:
    """As key_averages keeps events: not hidden, not async."""
    return not (e.is_async() or e.start_thread_id() != e.end_thread_id()
                or getattr(e, "is_hidden_event", lambda: False)())


def _is_api(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...), whose correlation id its device work shares."""
    return name.startswith("cu")


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(prof, top: int = 10) -> dict:
    """The traced slice's device numbers from a finished profiler run;
    raises if it recorded no device work."""
    from torch.autograd import DeviceType
    dev, host, launch = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if not _usable(e):
            continue
        if e.device_type() == DeviceType.CUDA:
            if e.name() not in LABELS and e.end_ns() > e.start_ns():
                dev.append((e.start_ns(), e.end_ns(), e.name(),
                            e.correlation_id()))
            continue
        host.append((e.start_ns(), e.end_ns(), e.name()))
        if _is_api(e.name()) and e.correlation_id():
            launch[e.correlation_id()] = e.start_ns()
    if not dev:
        raise RuntimeError("the profiler recorded no device work")
    busy = _union((s, e) for s, e, _, _ in dev)
    per_name: Dict[str, float] = {}
    for s, e, name, _ in dev:
        per_name[name] = per_name.get(name, 0.0) + (e - s) / 1e9
    under = {lab: 0.0 for lab in LABELS}
    for lab in LABELS:
        rs = sorted((s, e) for s, e, n in host if n == lab)
        starts = [s for s, _ in rs]
        for s, e, _, corr in dev:
            t = launch.get(corr)
            i = -1 if t is None else bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= rs[i][1]:
                under[lab] += (e - s) / 1e9
    # idle gaps between busy intervals, by the innermost host operation
    # (not a CUDA runtime call) open at the gap's start
    ops = sorted(h for h in host if not _is_api(h[2]))
    starts = [s for s, _, _ in ops]
    gaps: Dict[str, float] = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        label = "(no host op)"
        i = bisect.bisect_right(starts, a) - 1
        for s, e, name in reversed(ops[max(i - 4096, 0):i + 1]):
            if e >= a:
                label = name
                break
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    by = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "attn_fwd_s": under[ATTN_FWD], "attn_bwd_s": under[ATTN_BWD],
            "breakdown": {
                "device_ops": [[n, v] for n, v in by],
                "idle_gaps": [[n, v] for n, v in sorted(
                    gaps.items(), key=lambda kv: -kv[1])[:top]]}}


@contextlib.contextmanager
def profiled():
    """torch.profiler over host and device, yielding the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
