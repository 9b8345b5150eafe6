"""Static-shape graph batching for serving and training: concatenate + pad
molecules to fixed budgets and build the atom-blocked tables.

The single-window subset of x2gnn_tpu/data/batching.py: `Budgets`,
`pad_budget_for` (:209-272) without the degree split or tier planning,
`pad_graphs` (:275-477) for the blocked layout only, with no triplet or
neighbor tables and no degree sort (only tiers and the split use it), and
`batch_iterator` (:748-775).

Padding convention: pad atoms have atomic number 0 and position 0; pad
edges carry index 0 everywhere and are excluded by the boolean masks.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch

from x2gnn_tpu_torch.data.graphs import MolGraph


class Budgets(NamedTuple):
    """Static padding budgets shared by every batch of a run."""

    n_node: int
    n_edge: int
    n_trip: int
    n_deg: int   # atom in/out table width (max atom degree)


@dataclass
class GraphBatch:
    """A fixed-shape batch of molecular graphs in the atom-blocked layout.

    Shapes: N = node budget, E = edge budget, D = degree budget,
    G = graph budget, F = integral feature dim. Fields are numpy arrays
    from `pad_graphs`; `to(device)` gives the same batch as torch tensors.
    """

    numbers: np.ndarray        # (N,) int32, 0 = padding
    positions: np.ndarray      # (N, 3) float32
    edge_src: np.ndarray       # (E,) int32 source atom of each edge
    edge_dst: np.ndarray       # (E,) int32 destination atom
    edge_feat: np.ndarray      # (E, F) float32
    atom_gid: np.ndarray       # (N,) int32 graph id per atom
    edge_gid: np.ndarray       # (E,) int32 graph id per edge
    node_mask: np.ndarray      # (N,) bool
    edge_mask: np.ndarray      # (E,) bool
    y: np.ndarray              # (G,) float32 target
    graph_mask: np.ndarray     # (G,) bool
    # atom-blocked layout: row n of the in-table lists the edges arriving
    # at atom n, row n of the out-table the edges leaving it; every real
    # edge occupies exactly one slot of each table
    in_edges: np.ndarray       # (N, D) int32 edge ids with dst atom = n
    in_mask: np.ndarray        # (N, D) bool
    out_edges: np.ndarray      # (N, D) int32 edge ids with src atom = n
    out_mask: np.ndarray       # (N, D) bool
    edge_inpos: np.ndarray     # (E,) int32 flat n*D+slot in the in-table
    edge_outpos: np.ndarray    # (E,) int32 flat n*D+slot in the out-table

    def to(self, device) -> "GraphBatch":
        """The batch as torch tensors on `device`; index arrays become
        int64 (torch's index type)."""
        out = {}
        for f in fields(self):
            a = np.asarray(getattr(self, f.name))
            if a.dtype == np.int32:
                a = a.astype(np.int64)
            out[f.name] = torch.from_numpy(a).to(device)
        return GraphBatch(**out)


def pad_budget_for(
    graphs: Sequence[MolGraph],
    batch_size: int,
    multiple: int = 8,
) -> Budgets:
    """Budgets covering ANY `batch_size`-sized subset of `graphs` (the sum
    of the batch_size largest per-graph sizes; the max atom degree for the
    table width), rounded up to `multiple`."""
    n = np.array([g.num_atoms for g in graphs])
    e = np.array([g.num_edges for g in graphs])
    t = np.array([g.num_triplets for g in graphs])

    def worst_case(x: np.ndarray) -> int:
        k = min(batch_size, len(x))
        return int(np.sort(x)[::-1][:k].sum())

    def round_up(v: int) -> int:
        return ((max(v, 1) + multiple - 1) // multiple) * multiple

    deg = max((int(np.maximum(
        np.bincount(g.edge_index[0], minlength=g.num_atoms),
        np.bincount(g.edge_index[1], minlength=g.num_atoms)).max())
        for g in graphs if g.num_edges), default=1)
    return Budgets(round_up(worst_case(n)), round_up(worst_case(e)),
                   round_up(worst_case(t)), round_up(max(deg, 1)))


def _slot_table(atom_of_edge: np.ndarray, n_node: int, n_deg: int):
    """Group edges by atom (stable order): (N, D) table of edge ids, its
    mask, and each edge's flat slot n*D + s."""
    e0 = atom_of_edge.shape[0]
    table = np.zeros((n_node, n_deg), dtype=np.int32)
    mask = np.zeros((n_node, n_deg), dtype=bool)
    flat = np.zeros(e0, dtype=np.int32)
    if e0 == 0:
        return table, mask, flat
    order = np.argsort(atom_of_edge, kind="stable")
    counts = np.bincount(atom_of_edge, minlength=n_node)
    if counts.max() > n_deg:
        raise ValueError(
            f"max atom degree {counts.max()} exceeds budget {n_deg}")
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    atoms = atom_of_edge[order]
    slot = np.arange(e0) - starts[atoms]
    table[atoms, slot] = order
    mask[atoms, slot] = True
    flat[order] = (atoms * n_deg + slot).astype(np.int32)
    return table, mask, flat


def pad_graphs(
    graphs: Sequence[MolGraph],
    budgets: Budgets,
    n_graph: Optional[int] = None,
    targets: Optional[np.ndarray] = None,
) -> GraphBatch:
    """Concatenate molecules and pad to static budgets; the arrays equal
    x2gnn_tpu's `pad_graphs(..., with_triplets=False)` for budgets without
    a degree split or tiers. Each graph's target is `targets[i]` if given
    (shape (len(graphs),)), else `g.y[0]`."""
    n_node, n_edge, n_trip, n_deg = budgets
    n_graph = n_graph if n_graph is not None else len(graphs)
    if len(graphs) > n_graph:
        raise ValueError(f"{len(graphs)} graphs > budget {n_graph}")
    tot_n = sum(g.num_atoms for g in graphs)
    tot_e = sum(g.num_edges for g in graphs)
    tot_t = sum(g.num_triplets for g in graphs)
    if tot_n > n_node or tot_e > n_edge or tot_t > n_trip:
        raise ValueError(
            f"batch ({tot_n} nodes, {tot_e} edges, {tot_t} triplets) exceeds "
            f"budgets ({n_node}, {n_edge}, {n_trip})")

    feat_dim = graphs[0].edge_feat.shape[1] if graphs else 0
    numbers = np.zeros(n_node, dtype=np.int32)
    positions = np.zeros((n_node, 3), dtype=np.float32)
    edge_src = np.zeros(n_edge, dtype=np.int32)
    edge_dst = np.zeros(n_edge, dtype=np.int32)
    edge_feat = np.zeros((n_edge, feat_dim), dtype=np.float32)
    atom_gid = np.zeros(n_node, dtype=np.int32)
    edge_gid = np.zeros(n_edge, dtype=np.int32)
    y = np.zeros(n_graph, dtype=np.float32)

    a0 = e0 = 0
    for gid, g in enumerate(graphs):
        na, ne = g.num_atoms, g.num_edges
        numbers[a0:a0 + na] = g.numbers
        positions[a0:a0 + na] = g.positions
        edge_src[e0:e0 + ne] = g.edge_index[0] + a0
        edge_dst[e0:e0 + ne] = g.edge_index[1] + a0
        edge_feat[e0:e0 + ne] = g.edge_feat
        atom_gid[a0:a0 + na] = gid
        edge_gid[e0:e0 + ne] = gid
        y[gid] = targets[gid] if targets is not None else g.y[0]
        a0, e0 = a0 + na, e0 + ne

    in_edges, in_mask, edge_inpos = _slot_table(edge_dst[:e0], n_node, n_deg)
    out_edges, out_mask, edge_outpos = _slot_table(edge_src[:e0], n_node,
                                                   n_deg)
    return GraphBatch(
        numbers=numbers, positions=positions,
        edge_src=edge_src, edge_dst=edge_dst, edge_feat=edge_feat,
        atom_gid=atom_gid, edge_gid=edge_gid,
        node_mask=np.arange(n_node) < a0,
        edge_mask=np.arange(n_edge) < e0,
        y=y, graph_mask=np.arange(n_graph) < len(graphs),
        in_edges=in_edges, in_mask=in_mask,
        out_edges=out_edges, out_mask=out_mask,
        edge_inpos=_pad_to(edge_inpos, n_edge),
        edge_outpos=_pad_to(edge_outpos, n_edge),
    )


def _pad_to(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=a.dtype)
    out[:a.shape[0]] = a
    return out


def batch_iterator(
    graphs: Sequence[MolGraph],
    batch_size: int,
    budgets: Optional[Budgets] = None,
    targets: Optional[np.ndarray] = None,
) -> Iterator[GraphBatch]:
    """Yield fixed-shape GraphBatches over `graphs` in order; the last one
    is padded with empty graphs up to `batch_size`. `targets` (one per
    graph) overrides the graphs' own `y[0]`."""
    if budgets is None:
        budgets = pad_budget_for(graphs, batch_size)
    for lo in range(0, len(graphs), batch_size):
        chunk = graphs[lo:lo + batch_size]
        sub = (None if targets is None
               else np.asarray(targets[lo:lo + len(chunk)]))
        yield pad_graphs(chunk, budgets, n_graph=batch_size, targets=sub)
