"""Host milliseconds to enqueue one `Trainer.train_step`, with no
synchronise: the median over the window's steps."""

import statistics


def read(rec):
    w = rec["window"]
    if rec["kind"] != "train" or not w["dispatch_s"]:
        return None
    return 1e3 * statistics.median(w["dispatch_s"])
