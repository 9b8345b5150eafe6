"""Graph caches and training targets (x2gnn_tpu/data/dataset.py:55-124,
162-178).

A cache is one uncompressed npz of the molecules' ragged arrays,
concatenated, with per-molecule counts and a featurization-basis tag. The
port reads caches the JAX package writes and the other way round: every
field keeps the dtype it was saved with. Featurizing xyz files into a
cache (`featurize_molecules`, `load_dataset`) is not ported yet (ROADMAP
A11).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from x2gnn_tpu_torch.data.graphs import MolGraph
from x2gnn_tpu_torch.data.molecule import (
    EXTENSIVE_TARGETS, atomization_target)


def save_graph_cache(path: str, graphs: Sequence[MolGraph],
                     basis: Optional[str] = None) -> None:
    """Write `graphs` to the npz `path`: concatenated ragged arrays plus
    counts. `basis` tags the featurization provenance
    (`featurize.BACKEND_BASIS`); evaluation checks it against the
    training run's tag."""
    payload = {
        "basis": np.array(basis if basis is not None else "unknown"),
        "numbers": np.concatenate([g.numbers for g in graphs]),
        "positions": np.concatenate([g.positions for g in graphs]),
        "edge_index": np.concatenate(
            [g.edge_index for g in graphs], axis=1),
        "edge_feat": np.concatenate([g.edge_feat for g in graphs]),
        "triplet_index": np.concatenate(
            [g.triplet_index for g in graphs], axis=1),
        "atom_j": np.concatenate([g.atom_j for g in graphs]),
        "atom_i": np.concatenate([g.atom_i for g in graphs]),
        "atom_k": np.concatenate([g.atom_k for g in graphs]),
        "y": np.stack([g.y for g in graphs]),
        "n_atoms": np.array([g.num_atoms for g in graphs]),
        "n_edges": np.array([g.num_edges for g in graphs]),
        "n_trips": np.array([g.num_triplets for g in graphs]),
        "index": np.array([g.index for g in graphs]),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # uncompressed: a compressed member is decompressed whole on every
    # read. Written to a temporary file and renamed, so a crash never
    # leaves a truncated cache that a reader would trust.
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def read_cache_basis(path: str) -> str:
    """Featurization-basis tag of a graph cache ('unknown' for caches
    written before provenance tagging)."""
    with np.load(path) as zf:
        if "basis" in zf.files:
            return str(zf["basis"])
    return "unknown"


def load_graph_cache(path: str) -> List[MolGraph]:
    """The MolGraphs of a cache, each field with its saved dtype."""
    with np.load(path) as zf:
        # read every member once: indexing a lazy NpzFile member reads it
        # again on each access
        z = {k: np.asarray(zf[k]) for k in zf.files}
    n_off = np.concatenate([[0], np.cumsum(z["n_atoms"])])
    e_off = np.concatenate([[0], np.cumsum(z["n_edges"])])
    t_off = np.concatenate([[0], np.cumsum(z["n_trips"])])
    graphs = []
    for m in range(len(z["n_atoms"])):
        a0, a1 = n_off[m], n_off[m + 1]
        e0, e1 = e_off[m], e_off[m + 1]
        t0, t1 = t_off[m], t_off[m + 1]
        graphs.append(MolGraph(
            numbers=z["numbers"][a0:a1],
            positions=z["positions"][a0:a1],
            edge_index=z["edge_index"][:, e0:e1],
            edge_feat=z["edge_feat"][e0:e1],
            triplet_index=z["triplet_index"][:, t0:t1],
            atom_j=z["atom_j"][t0:t1],
            atom_i=z["atom_i"][t0:t1],
            atom_k=z["atom_k"][t0:t1],
            y=z["y"][m],
            index=int(z["index"][m]),
        ))
    return graphs


def prepare_targets(graphs: Sequence[MolGraph], target: int) -> np.ndarray:
    """Training targets (num_mols,) float32 from the graphs' labels: a
    single label as it is; the synthetic [energy, gap] pair by target
    family (extensive targets train the energy, intensive ones the gap,
    train_ema.py:41-44); 12 QM9 labels through `atomization_target`
    (train_ema.py:28-38)."""
    numbers = [g.numbers for g in graphs]
    labels = np.stack([g.y for g in graphs])
    if labels.shape[1] == 1:
        return labels[:, 0].astype(np.float32)
    if labels.shape[1] == 2:
        col = 0 if target in EXTENSIVE_TARGETS else 1
        return labels[:, col].astype(np.float32)
    return atomization_target(numbers, labels, target).astype(np.float32)
