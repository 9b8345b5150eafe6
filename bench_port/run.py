"""Run one cell of the benchmark of the PyTorch port once, and print its
result as the last line of standard output.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. `BENCHMARK.json` names the cell's
configuration (`bench_port/configs/<config>.json`) and traffic
(`bench_port/traffic/<traffic>.json`, whose `kind` names the driver
`bench_port/drive_<kind>.py`);
every per-layer metric is read by `bench_port/metrics/<metric>.py`, every
correctness limit comes from `bench_port/limits/<cell>.json`. With
`--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer ones and the device's busy time in a traced
slice. Exits non-zero, with no result, without enough CUDA devices, or if
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that the process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "x2gnn_tpu")
CACHE_VARS = ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH")
# one host thread for the CPU libraries: the window's host work is the
# Python thread's dispatch, and idle pool threads that spin beside it on
# a shared host made whole runs 10-35% slower or faster
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def driver(kind: str):
    """The module bench_port/drive_<kind>.py, whose `run(Run)` drives a
    cell of a traffic of that kind."""
    return importlib.import_module(f"bench_port.drive_{kind}")


def reader(metric: str):
    """The `read(records)` function of metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_port.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
             device, started: float, config: Optional[dict] = None,
             traffic: Optional[dict] = None,
             limits: Optional[dict] = None) -> dict:
    """One run of `cell` on `device`: the result object (without checking
    for a card). `config`, `traffic` and `limits` replace the cell's own
    files (the tests run a cell at a tiny size on the CPU)."""
    from bench_port import check
    from bench_port.harness import Run

    w = next(x for x in bench["workloads"] if x["name"] == cell)
    c = next(x for x in bench["configs"] if x["name"] == w["config"])
    config = config or load_json(ROOT, c["file"])
    traffic = traffic or load_json(HERE, "traffic", f"{w['traffic']}.json")
    lims = limits or check.limits(cell)
    out = driver(traffic["kind"]).run(Run(cell, config, traffic, seed,
                                          seconds, trace, device, started))
    correct, rows = check.verdict(out["numbers"], lims)
    if trace:
        metrics = {}
        for entry in bench["per_layer"]:
            if applies(entry, cell):
                value = reader(entry["name"])(out["records"])
                if value is not None:
                    metrics[entry["name"]] = {"value": value,
                                              "unit": entry["unit"]}
    else:
        metrics = {e["name"]: {"value": out["end_to_end"][e["name"]],
                               "unit": e["unit"]}
                   for e in bench["end_to_end"] if applies(e, cell)}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics}
    result["device"] = {"platform": "gpu" if device.type == "cuda"
                        else device.type, "kind": _kind(device),
                        "count": w["chips"],
                        "memory_peak_bytes": out["peak"]}
    tr = out["records"].get("trace")
    if tr is not None:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = tr["breakdown"]
    result["checks"] = rows
    return result


def _kind(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def host_settings() -> None:
    """The run's environment, set before torch is imported: every cache
    directory at a fixed path inside the checkout, one thread for the
    CPU libraries."""
    for var in CACHE_VARS:
        os.environ[var] = os.path.join(ROOT, "build", "bench_port",
                                       var.lower())
    for var in THREAD_VARS:
        os.environ[var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    host_settings()
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; BENCHMARK.json has "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), STARTED)
    loaded = forbidden_modules()
    if loaded:
        print(f"the process loaded {loaded}: the benchmark may hold none "
              f"of {FORBIDDEN}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"{name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
