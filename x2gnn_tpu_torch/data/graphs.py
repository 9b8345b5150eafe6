"""Radius-graph and line-graph (triplet) construction, host-side numpy.

A copy of x2gnn_tpu/data/graphs.py:29-168: all graph structure is computed
once per molecule, the model only ever sees static-shaped index arrays.

  * radius graph = all ordered pairs with 0 < d < cutoff, bidirected, no
    self loops, as COO (2, E), enumerated src-major;
  * line graph: for each edge e1=(i->j) and each edge e2=(j->k) with
    k != i, a triplet whose message flows FROM e2 INTO e1, sorted by
    destination edge id.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def pairwise_distances(positions: np.ndarray) -> np.ndarray:
    """(N,3) -> (N,N) Euclidean distance matrix from direct differences."""
    diff = positions[:, None, :] - positions[None, :, :]
    return np.sqrt((diff * diff).sum(-1))


def radius_graph(
    positions: np.ndarray, cutoff: float = 5.0
) -> Tuple[np.ndarray, np.ndarray]:
    """All ordered pairs with 0 < d < cutoff.

    Returns (edge_index (2, E) int32 [src; dst], distances (E,) float64).
    """
    # pin the edge set to f64 distances: f32 positions can flip
    # near-cutoff pairs and misalign a cached (E, F) edge_feat block
    d = pairwise_distances(np.asarray(positions, np.float64))
    mask = (d < cutoff) & (d > 0.0)
    src, dst = np.nonzero(mask)
    edge_index = np.stack([src, dst]).astype(np.int32)
    return edge_index, d[src, dst]


def line_graph(
    edge_index: np.ndarray, num_nodes: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Triplet expansion of the atom graph (vectorized).

    For each e1=(i->j), pair it with every edge e2=(j->k), k != i.
    Returns (triplet_index (2, T) int32 [src_edge=jk; dst_edge=ij],
    atom_j, atom_i, atom_k), sorted by dst edge id.
    """
    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    num_edges = src.shape[0]
    if num_edges == 0:
        z = np.zeros(0, dtype=np.int32)
        return np.zeros((2, 0), dtype=np.int32), z, z, z

    # CSR of edges grouped by source atom: out_edges[ptr[a]:ptr[a+1]] are
    # the edge ids leaving atom a
    order = np.argsort(src, kind="stable").astype(np.int64)
    out_deg = np.bincount(src, minlength=num_nodes)
    ptr = np.concatenate([[0], np.cumsum(out_deg)])

    # each e1 pairs with out_deg[dst[e1]] candidate e2 (before i==k removal)
    cand = out_deg[dst]
    total = int(cand.sum())
    dst_edge = np.repeat(np.arange(num_edges, dtype=np.int64), cand)
    group_start = np.repeat(np.cumsum(cand) - cand, cand)
    within = np.arange(total, dtype=np.int64) - group_start
    src_edge = order[ptr[dst[dst_edge]] + within]

    atom_i = src[dst_edge]
    atom_k = dst[src_edge]
    keep = atom_i != atom_k          # drop backtracking i->j->i
    dst_edge = dst_edge[keep]
    src_edge = src_edge[keep]
    triplet_index = np.stack([src_edge, dst_edge]).astype(np.int32)
    atom_j = dst[dst_edge].astype(np.int32)   # media atom (= src of e2)
    return (
        triplet_index,
        atom_j,
        atom_i[keep].astype(np.int32),
        atom_k[keep].astype(np.int32),
    )


@dataclass
class MolGraph:
    """One molecule's static graph structure + features: the unit the
    batcher consumes."""

    numbers: np.ndarray        # (N,) int32
    positions: np.ndarray      # (N, 3) float32
    edge_index: np.ndarray     # (2, E) int32  [src; dst]
    edge_feat: np.ndarray      # (E, F) float32 integral features (or zeros)
    triplet_index: np.ndarray  # (2, T) int32  [src_edge(jk); dst_edge(ij)]
    atom_j: np.ndarray         # (T,) int32 media atom
    atom_i: np.ndarray         # (T,) int32 start atom
    atom_k: np.ndarray         # (T,) int32 end atom
    y: np.ndarray              # (P,) float32 target(s)
    index: int = 0

    @property
    def num_atoms(self) -> int:
        return int(self.numbers.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    @property
    def num_triplets(self) -> int:
        return int(self.triplet_index.shape[1])


def build_mol_graph(
    numbers: np.ndarray,
    positions: np.ndarray,
    y: np.ndarray,
    cutoff: float = 5.0,
    edge_feat: Optional[np.ndarray] = None,
    edge_feat_dim: int = 338,
    index: int = 0,
) -> MolGraph:
    """Construct the full graph structure for one molecule; `edge_feat`
    None fills the (E, edge_feat_dim) feature block with zeros."""
    edge_index, _ = radius_graph(positions, cutoff)
    triplet_index, atom_j, atom_i, atom_k = line_graph(
        edge_index, numbers.shape[0])
    if edge_feat is None:
        edge_feat = np.zeros((edge_index.shape[1], edge_feat_dim),
                             dtype=np.float32)
    return MolGraph(
        numbers=np.asarray(numbers, dtype=np.int32),
        positions=np.asarray(positions, dtype=np.float32),
        edge_index=edge_index,
        edge_feat=np.asarray(edge_feat, dtype=np.float32),
        triplet_index=triplet_index,
        atom_j=atom_j,
        atom_i=atom_i,
        atom_k=atom_k,
        y=np.atleast_1d(np.asarray(y, dtype=np.float32)),
        index=index,
    )
