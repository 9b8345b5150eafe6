"""Synthetic QM9-like molecules for tests, benchmarks and smoke runs
(x2gnn_tpu/data/synthetic.py:19-38, 160-187; numpy only).

H/C/N/O/F atoms placed with a minimum separation so radius-graph degree
statistics resemble real featurized sets. Edge features are random
placeholders for the 338-dim integral block.
"""

from __future__ import annotations

from typing import List

import numpy as np

from x2gnn_tpu_torch.data.graphs import MolGraph, build_mol_graph


def random_molecule(rng: np.random.Generator, n_atoms: int,
                    min_dist: float = 1.0, density: float = 0.08):
    """Positions drawn in a cube sized for ~`density` atoms/A^3 with a
    minimum pairwise distance."""
    box = (n_atoms / density) ** (1.0 / 3.0) / 2.0
    pos = np.zeros((n_atoms, 3))
    placed = 0
    tries = 0
    while placed < n_atoms:
        cand = rng.uniform(-box, box, size=3)
        if placed == 0 or np.linalg.norm(
                pos[:placed] - cand, axis=1).min() >= min_dist:
            pos[placed] = cand
            placed += 1
        tries += 1
        if tries > 100000:
            raise RuntimeError("packing failed; lower density")
    numbers = rng.choice([1, 1, 1, 6, 6, 6, 6, 7, 8, 9],
                         size=n_atoms).astype(np.int32)
    return numbers, pos


def synthetic_dataset(
    num_molecules: int,
    mean_atoms: int = 18,
    seed: int = 0,
    cutoff: float = 5.0,
    edge_feat_dim: int = 338,
    target: str = "atom_count",
) -> List[MolGraph]:
    """MolGraphs with synthetic geometry + features. target='atom_count'
    makes the label learnable from structure; 'random' gives N(0,1)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for i in range(num_molecules):
        n = max(3, int(rng.normal(mean_atoms, max(2, mean_atoms // 6))))
        numbers, pos = random_molecule(rng, n)
        g = build_mol_graph(numbers, pos, y=np.array([0.0]), cutoff=cutoff,
                            edge_feat_dim=edge_feat_dim, index=i)
        g.edge_feat[:] = rng.normal(
            size=g.edge_feat.shape).astype(np.float32) * 0.1
        if target == "atom_count":
            g.y = np.array([float(n)], dtype=np.float32)
        else:
            g.y = rng.normal(size=1).astype(np.float32)
        graphs.append(g)
    return graphs
