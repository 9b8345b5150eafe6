"""Tiny versions of the benchmark's cells for the CPU tests: two convs of
32 channels, a few dozen small molecules, batch 4."""

from __future__ import annotations

import copy
import time

import torch

from bench_port import check, run

TINY_MODEL = {"conv_layers": 2, "in_channels": 32, "embedding_size": 32,
              "heads": 4, "edge_feat_dim": 8}
TINY_TRAFFIC = {"molecules": 24, "size_sd": 2, "min_atoms": 3,
                "max_atoms": 12, "trace_steps": 2}
CELLS = ("aid.train",)


def bench() -> dict:
    return run.load_json(run.ROOT, "BENCHMARK.json")


def tiny(cell: str, **model):
    """(config, traffic) of `cell` at the tiny size; `model` overrides
    further model keys."""
    b = bench()
    w = next(x for x in b["workloads"] if x["name"] == cell)
    c = next(x for x in b["configs"] if x["name"] == w["config"])
    config = copy.deepcopy(run.load_json(run.ROOT, c["file"]))
    config["model"].update(TINY_MODEL, **model)
    config["train"]["batch_size"] = 4
    traffic = run.load_json(run.HERE, "traffic", f"{w['traffic']}.json")
    traffic.update(TINY_TRAFFIC,
                   mean_atoms=9 if traffic["mean_atoms"] > 40 else 7)
    return config, traffic


def run_tiny(cell: str, seed: int = 7, seconds: float = 1.0,
             trainer=None, **model):
    """One untraced run of `cell` at the tiny size on the CPU, under the
    cell's own limits; `trainer` replaces the traffic's Trainer
    options."""
    config, traffic = tiny(cell, **model)
    if trainer is not None:
        traffic["trainer"] = trainer
    return run.run_cell(bench(), cell, seed, seconds, False,
                        torch.device("cpu"), time.perf_counter(),
                        config=config, traffic=traffic,
                        limits=check.limits(cell))
