"""Share of the traced slice in which nothing ran on the device: one
minus the union of the kernels', copies' and sets' intervals over the
slice's seconds."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "train" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
