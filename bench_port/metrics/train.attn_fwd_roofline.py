"""The fused attention forward's share of its roofline in the traced
slice: the least time its work needs at the card's peaks
(counts/work.py::attn_fwd, once per conv and batch) over the device time
of the kernels launched inside the port's forward call."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "train" or not t or t["attn_fwd_s"] <= 0:
        return None
    return 100.0 * t["attn_fwd_bound_s"] / t["attn_fwd_s"]
