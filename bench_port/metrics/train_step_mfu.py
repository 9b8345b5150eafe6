"""Share of the card's float32 peak that the window's training steps
reached: the steps' counted FLOPs (counts/work.py::step_flops) over the
window's seconds, over 67 TFLOP/s."""

from bench_port.counts.work import PEAK_FP32_FLOPS


def read(rec):
    w = rec["window"]
    if rec["kind"] != "train" or not w["steps"]:
        return None
    return 100.0 * w["flops"] / w["seconds"] / PEAK_FP32_FLOPS
