"""Pieces the cell drivers share: the run's context, step-boundary marks,
and the program's side of a run (the port's model with the benchmark's
weights and molecules)."""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bench_port.reference.model import Molecule


@dataclasses.dataclass
class Run:
    """One run of one cell."""
    cell: str
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float        # time.perf_counter() at the process's start

    @property
    def model_cfg(self) -> dict:
        return self.config["model"]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Marks:
    """Step boundaries on the device's stream (CUDA events, so a step's
    time keeps the host's dispatch-ahead and shows a stall), or on the
    host's clock for a CPU run."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        """Milliseconds between consecutive marks (after a sync)."""
        if self.cuda:
            return [a.elapsed_time(b)
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def p95(values: Sequence[float]) -> float:
    """95th percentile by linear interpolation (numpy's default); NaN for
    no values."""
    if not len(values):
        return float("nan")
    return float(np.percentile(np.asarray(values, np.float64), 95))


def build_graphs(mols: Sequence[Molecule], cutoff: float):
    """The port's MolGraphs of the benchmark's molecules (labels as their
    targets); raises where the port's radius graph and the features the
    benchmark drew disagree in size."""
    from x2gnn_tpu_torch.data.graphs import build_mol_graph
    out = []
    for i, m in enumerate(mols):
        g = build_mol_graph(m.numbers, m.positions, np.array([m.y]),
                            cutoff=cutoff, edge_feat=m.feat, index=i)
        if g.num_edges != m.feat.shape[0]:
            raise RuntimeError(f"molecule {i}: the port's graph has "
                               f"{g.num_edges} edges, the benchmark drew "
                               f"{m.feat.shape[0]} feature rows")
        out.append(g)
    return out


def port_model(model_cfg: dict, weights: Dict[str, torch.Tensor], device):
    """The port's X2GNN of `model_cfg` holding `weights` (copied in)."""
    from x2gnn_tpu_torch.config import ModelConfig
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    mcfg = ModelConfig(**model_cfg)
    model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)
    model.load_state_dict(weights, strict=True)
    return mcfg, model


def free(device: torch.device) -> None:
    """Let go of what the program held on the device."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(device: torch.device) -> Optional[int]:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return None
