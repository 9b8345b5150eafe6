"""Radius graph and line graph of one molecule, in plain numpy.

Written for the benchmark from the model's description: an edge is an
ordered atom pair (src, dst) closer than the cutoff and not the same atom,
the pairs enumerated src-major, dst-minor (the order the benchmark's edge
features come in); a triplet is a pair of edges (i->j, j->k) with k != i,
whose message flows from j->k into i->j. Distances are taken in float64 from
direct differences, so the edge set does not depend on rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class MolEdges(NamedTuple):
    src: np.ndarray   # (E,) int64 source atom
    dst: np.ndarray   # (E,) int64 destination atom


class MolTriplets(NamedTuple):
    e_in: np.ndarray   # (T,) edge i->j that receives the message
    e_out: np.ndarray  # (T,) edge j->k that sends it
    i: np.ndarray      # (T,) start atom
    j: np.ndarray      # (T,) media atom
    k: np.ndarray      # (T,) end atom


def radius_edges(positions: np.ndarray, cutoff: float) -> MolEdges:
    """Every ordered pair (src, dst), src != dst, with distance < cutoff,
    in src-major order."""
    p = np.asarray(positions, np.float64)
    diff = p[:, None, :] - p[None, :, :]
    d = np.sqrt((diff * diff).sum(-1))
    src, dst = np.nonzero((d < cutoff) & (d > 0.0))
    return MolEdges(src.astype(np.int64), dst.astype(np.int64))


def degrees(edges: MolEdges, n_atoms: int) -> np.ndarray:
    """(n_atoms,) neighbour count of every atom (the graph is symmetric)."""
    return np.bincount(edges.src, minlength=n_atoms)


def triplets(edges: MolEdges, n_atoms: int) -> MolTriplets:
    """Every (i->j, j->k) edge pair with k != i, media atom by media
    atom."""
    src, dst = edges.src, edges.dst
    eid = np.full((n_atoms, n_atoms), -1, np.int64)
    eid[src, dst] = np.arange(src.shape[0])
    e_in, e_out = [], []
    for j in range(n_atoms):
        nbr = np.nonzero(eid[j] >= 0)[0]
        i, k = np.meshgrid(nbr, nbr, indexing="ij")
        keep = i != k
        e_in.append(eid[i[keep], j])
        e_out.append(eid[j, k[keep]])
    e_in = np.concatenate(e_in) if e_in else np.zeros(0, np.int64)
    e_out = np.concatenate(e_out) if e_out else np.zeros(0, np.int64)
    return MolTriplets(e_in, e_out, src[e_in], dst[e_in], dst[e_out])
