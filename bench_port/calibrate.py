"""Readings that the correctness limits are set from: a cell's check
numbers on many seeds, for the program as configured and for the
control, in one process on the card.

    python3 -m bench_port.calibrate --workload <cell> --variant <v> \\
        --seeds 1 2 3 ... [--out FILE]

Variants: `fp32`, the cell as configured (the lower readings); `bf16`,
the program with `compute_dtype` bfloat16, the nearest precision below
the configuration's float32 (the control); `half_batch`, a training step
that leaves half of each batch's molecules out and takes the mean over
the rest (a fault planted in the program's step). A training cell checks
steps made before its window, so each seed runs no window. Prints one
JSON line per seed, and appends them to FILE.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import sys
import time


@contextlib.contextmanager
def half_batch():
    """Trainer.train_step on batches whose graph mask keeps only the
    first half of their real molecules."""
    import torch
    from x2gnn_tpu_torch.train.trainer import Trainer
    step = Trainer.train_step

    def faulty(self, state, batch, step_no=None):
        mask = batch.graph_mask
        keep = torch.cumsum(mask.int(), 0) <= (mask.sum() + 1) // 2
        return step(self, state, dataclasses.replace(
            batch, graph_mask=mask & keep), step_no)

    Trainer.train_step = faulty
    try:
        yield
    finally:
        Trainer.train_step = step


def main(argv=None) -> int:
    started = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", choices=("fp32", "bf16", "half_batch"),
                    default="fp32")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from bench_port import run
    run.host_settings()
    import torch
    torch.set_num_threads(1)
    from bench_port.harness import Run

    if not torch.cuda.is_available():
        print("calibration reads the card; none found", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    w = next(x for x in bench["workloads"] if x["name"] == args.workload)
    c = next(x for x in bench["configs"] if x["name"] == w["config"])
    config = run.load_json(run.ROOT, c["file"])
    traffic = run.load_json(run.HERE, "traffic", f"{w['traffic']}.json")
    if args.variant == "bf16":
        config = copy.deepcopy(config)
        config["model"]["compute_dtype"] = "bfloat16"
    drive = run.driver(traffic["kind"])
    fault = (half_batch if args.variant == "half_batch"
             else contextlib.nullcontext)
    for seed in args.seeds:
        t0 = time.perf_counter()
        with fault():
            out = drive.run(Run(args.workload, config, traffic, seed,
                                0.0, False, torch.device("cuda", 0),
                                started))
        line = json.dumps({"workload": args.workload,
                           "variant": args.variant, "seed": seed,
                           "numbers": out["numbers"],
                           "worst_leaves": out.get("worst_leaves"),
                           "attempted": out["attempted"],
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
