"""The traced slice's arithmetic on made-up profiler events: the union
of device intervals, device time by name and under the labelled host
ranges (matched by correlation id), copies, and idle gaps labelled by
the host operation open at their start."""

import pytest
from torch.autograd import DeviceType

from bench_port import trace


class Ev:
    def __init__(self, name, start, end, device=DeviceType.CPU, corr=0):
        self._n, self._s, self._e, self._d, self._c = (name, start, end,
                                                       device, corr)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def is_async(self):
        return False

    def start_thread_id(self):
        return 1

    def end_thread_id(self):
        return 1


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": lambda self: events})()})()


G = DeviceType.CUDA
EVENTS = [
    Ev("aten::mm", 0, 100),
    Ev("cudaLaunchKernel", 10, 12, corr=1),
    Ev(trace.ATTN_FWD, 20, 40),
    Ev("cudaLaunchKernel", 25, 27, corr=2),
    Ev(trace.ATTN_BWD, 50, 70),
    Ev("cudaLaunchKernel", 55, 57, corr=3),
    Ev("cudaMemcpyAsync", 80, 82, corr=4),
    Ev("aten::copy_", 78, 200),
    Ev("gemm", 1000, 2000, G, 1),
    Ev("attn_fwd_kernel", 1500, 3000, G, 2),     # overlaps the gemm
    Ev("attn_bwd_kernel", 5000, 6000, G, 3),
    Ev("Memcpy HtoD (Pageable -> Device)", 9000, 9500, G, 4),
    Ev(trace.ATTN_FWD, 1500, 3000, G),           # gpu-side annotation
]


def test_summarize_made_up_events():
    out = trace.summarize(Prof(EVENTS))
    assert out["busy_s"] == pytest.approx(3500e-9)   # 2000 + 1000 + 500
    assert out["attn_fwd_s"] == pytest.approx(1500e-9)
    assert out["attn_bwd_s"] == pytest.approx(1000e-9)
    ops = dict(out["breakdown"]["device_ops"])
    assert ops["attn_fwd_kernel"] == pytest.approx(1500e-9)
    assert trace.ATTN_FWD not in ops
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(5000e-9)
    assert set(gaps) == {"(no host op)"}


def test_a_gap_takes_the_innermost_open_host_op():
    ev = [Ev("outer", 0, 10_000), Ev("inner", 3000, 4000),
          Ev("k1", 1000, 3500, G, 1), Ev("k2", 5000, 6000, G, 2)]
    gaps = dict(trace.summarize(Prof(ev))["breakdown"]["idle_gaps"])
    assert gaps == {"inner": pytest.approx(1500e-9)}


def test_no_device_work_raises():
    with pytest.raises(RuntimeError):
        trace.summarize(Prof([Ev("aten::mm", 0, 10)]))
