"""Launches of the fused attention's kernels (the port's counters
`blocked_attention.launches`, `blocked_attention_bwd_partials.launches`
and `reduce_partials.launches`) per optimizer step of the window."""


def read(rec):
    w = rec["window"]
    if rec["kind"] != "train" or not w["steps"] or not w["launches"]:
        return None
    return w["launches"] / w["steps"]
