"""Static-shape graph batching: concatenate + pad molecules to fixed
budgets, sort atoms by degree and build the atom-blocked tables.

A copy of x2gnn_tpu/data/batching.py: `Budgets`, `plan_degree_tiers`
(:135-206), `pad_budget_for` with the two-tier degree split and the tier
planner (:209-272), `pad_graphs` (:275-477) with the triplet arrays and
the padded layout's neighbour tables when `with_triplets` (the segment
and padded layouts read them, the blocked layout never does), the
packing planners `mixed_packed_plan` (:480-591) and `size_bucketed_plan`
(:594-745), and `batch_iterator` (:748-775).

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
    # two-tier degree split (0 = off): atoms are degree-sorted per batch
    # and rows >= n_hi have degree <= n_deg_lo, so they run in a
    # (n_deg_lo x n_deg_lo) window
    n_deg_lo: int = 0
    n_hi: int = 0
    # graph slots of a packed batch (0 = the trainer's batch_size)
    n_graph: int = 0
    # rectangular degree tiers ((end_row, di, dk), ...), end rows
    # increasing, the last == n_node: rows [end_{t-1}, end_t) of the sorted
    # atoms have degree <= di_t and run in a di_t x dk_t window (dk_t =
    # di_t rounded up to 8); supersedes the two-tier split; () = off
    tiers: tuple = ()


# fields of GraphBatch that are Python values, not arrays
STATIC_FIELDS = ("n_hi", "d_lo", "tiers")


@dataclass
class GraphBatch:
    """A fixed-shape batch of molecular graphs.

    Shapes: N = node budget, E = edge budget, T = triplet budget (0 when
    the batch was padded without triplets), D = degree budget, G = graph
    budget, F = integral feature dim. Array fields are numpy
    arrays from `pad_graphs`; `to(device)` gives the same batch as torch
    tensors. `n_hi`, `d_lo` and `tiers` are Python values that choose the
    attention windows (see `Budgets`).
    """

    numbers: np.ndarray        # (N,) int32, 0 = padding
    positions: np.ndarray      # (N, 3) float32
    edge_src: np.ndarray       # (E,) int32 source atom of each edge
    edge_dst: np.ndarray       # (E,) int32 destination atom
    edge_feat: np.ndarray      # (E, F) float32
    # line graph: triplet t carries a message from edge j->k into i->j
    trip_src_edge: np.ndarray  # (T,) int32 source edge (j->k)
    trip_dst_edge: np.ndarray  # (T,) int32 destination edge (i->j)
    trip_j: np.ndarray         # (T,) int32 media atom
    trip_i: np.ndarray         # (T,) int32 start atom
    trip_k: np.ndarray         # (T,) int32 end atom
    atom_gid: np.ndarray       # (N,) int32 graph id per atom
    edge_gid: np.ndarray       # (E,) int32 graph id per edge
    node_mask: np.ndarray      # (N,) bool
    edge_mask: np.ndarray      # (E,) bool
    trip_mask: np.ndarray      # (T,) bool
    y: np.ndarray              # (G,) float32 target
    graph_mask: np.ndarray     # (G,) bool
    # padded layout: row e lists the triplets flowing into edge e (each
    # real triplet exactly once), padded to D; (0, D) without triplets
    nbr_trip: np.ndarray       # (E, D) int32 triplet ids, 0 = padding
    nbr_src: np.ndarray        # (E, D) int32 source edge of each triplet
    nbr_mask: np.ndarray       # (E, D) bool
    # atom-blocked layout: row n of the in-table lists the edges arriving
    # at atom n, row n of the out-table the edges leaving it; every real
    # edge occupies exactly one slot of each table
    in_edges: np.ndarray       # (N, D) int32 edge ids with dst atom = n
    in_mask: np.ndarray        # (N, D) bool
    out_edges: np.ndarray      # (N, D) int32 edge ids with src atom = n
    out_mask: np.ndarray       # (N, D) bool
    edge_inpos: np.ndarray     # (E,) int32 flat n*D+slot in the in-table
    edge_outpos: np.ndarray    # (E,) int32 flat n*D+slot in the out-table
    n_hi: int = 0              # two-tier split: rows >= n_hi have
    d_lo: int = 0              # degree <= d_lo (0 = off)
    tiers: tuple = ()          # ((end_row, di, dk), ...); () = off
    # (E,) float32 per-edge scale of int8 edge_feat (the Trainer's
    # feat_dtype="int8"), None otherwise (x2gnn_tpu/data/batching.py:108)
    edge_feat_scale: Optional[np.ndarray] = None

    def _tensors(self, fn) -> "GraphBatch":
        """The batch with `fn` applied to each array field as a torch
        tensor (numpy fields converted first, int32 ones to int64); the
        static fields, and a None edge_feat_scale, stay as they are."""
        out = {}
        for f in fields(self):
            a = getattr(self, f.name)
            if f.name not in STATIC_FIELDS and a is not None:
                if not isinstance(a, torch.Tensor):
                    a = np.asarray(a)
                    if a.dtype == np.int32:
                        a = a.astype(np.int64)
                    a = torch.from_numpy(a)
                a = fn(a)
            out[f.name] = a
        return GraphBatch(**out)

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        """The batch as torch tensors on `device`; index arrays become
        int64 (torch's index type). `non_blocking` copies a pinned batch
        asynchronously on the current stream."""
        return self._tensors(lambda t: t.to(device,
                                            non_blocking=non_blocking))

    def pin_memory(self) -> "GraphBatch":
        """The batch as torch tensors (the types `to` gives) in
        page-locked host memory, which the card copies from
        asynchronously. Needs a CUDA build of torch."""
        return self._tensors(lambda t: t.pin_memory())

    def arrays(self) -> list:
        """The batch's array fields (tensors once `to` or `pin_memory`
        made them so), without the static ones and a None
        edge_feat_scale."""
        return [getattr(self, f.name) for f in fields(self)
                if f.name not in STATIC_FIELDS
                and getattr(self, f.name) is not None]


def _atom_degrees(g: MolGraph) -> np.ndarray:
    """max(in-degree, out-degree) of each atom of g."""
    if not g.num_edges:
        return np.zeros(g.num_atoms, np.int64)
    return np.maximum(np.bincount(g.edge_index[0], minlength=g.num_atoms),
                      np.bincount(g.edge_index[1], minlength=g.num_atoms))


def _round_up(v, multiple: int = 8) -> int:
    return ((max(int(v), 1) + multiple - 1) // multiple) * multiple


def plan_degree_tiers(n_node: int, cap_deg: int, cnt_over,
                      max_tiers: int = 8, multiple: int = 8) -> tuple:
    """Rectangular degree tiers minimizing the pair capacity
    sum (rows x di x round8(dk)), by the reference's DP over thresholds.

    cnt_over[d] (d = 0..cap_deg) is the worst-case number of atom rows of
    a batch whose degree exceeds d. Returns ((end_row, di, dk), ...), end
    rows increasing (multiples of `multiple` except the last = n_node);
    rows [end_{t-1}, end_t) are guaranteed degree <= di_t. () when one
    full-width window is optimal."""
    def ru_row(v):
        return min(((int(v) + multiple - 1) // multiple) * multiple, n_node)

    cap_deg = max(int(cap_deg), 1)
    cnt = [ru_row(cnt_over[d]) if d < len(cnt_over) else 0
           for d in range(cap_deg + 1)]
    w = [d * _round_up(d, multiple) for d in range(cap_deg + 1)]
    # f[k][d] = least cost covering rows [cnt[d], n_node) with <= k tiers,
    # topmost window d; nxt[k][d] = the next (smaller) window, or None
    # when tier d runs to the end
    f = [None, {d: (n_node - cnt[d]) * w[d] for d in range(1, cap_deg + 1)}]
    nxt = [None, {d: None for d in range(1, cap_deg + 1)}]
    for k in range(2, max_tiers + 1):
        fk, nk = {}, {}
        for d in range(1, cap_deg + 1):
            best, arg = f[1][d], None
            for d2 in range(1, d):
                c = (cnt[d2] - cnt[d]) * w[d] + f[k - 1][d2]
                if c < best:
                    best, arg = c, d2
            fk[d], nk[d] = best, arg
        f.append(fk)
        nxt.append(nk)
    seq, k, d = [cap_deg], max_tiers, cap_deg
    while nxt[k][d] is not None:
        d, k = nxt[k][d], k - 1
        seq.append(d)
    tiers, prev_end = [], 0
    for i, dd in enumerate(seq):
        end = cnt[seq[i + 1]] if i + 1 < len(seq) else n_node
        if end > prev_end:
            tiers.append((int(end), int(dd), int(_round_up(dd, multiple))))
            prev_end = end
    return tuple(tiers) if len(tiers) > 1 else ()


def _exceed_counts(deg: np.ndarray, cap: int) -> np.ndarray:
    """(cap + 1,) counts of atoms whose degree exceeds 0..cap."""
    h = np.bincount(np.minimum(deg, cap), minlength=cap + 1)
    return deg.size - np.cumsum(h)


def pad_budget_for(
    graphs: Sequence[MolGraph],
    batch_size: int,
    multiple: int = 8,
) -> Budgets:
    """Budgets covering ANY `batch_size`-sized subset of `graphs` (the sum
    of the batch_size largest per-graph sizes; the max atom degree for the
    table width), rounded up to `multiple`, with the two-tier split and
    the degree tiers planned from the same worst-case counts."""
    n = np.array([g.num_atoms for g in graphs])
    e = np.array([g.num_edges for g in graphs])
    t = np.array([g.num_triplets for g in graphs])

    def worst_case(x: np.ndarray) -> int:
        k = min(batch_size, len(x))
        return int(np.sort(x)[::-1][:k].sum())

    per_graph_deg = [_atom_degrees(g) for g in graphs]
    deg = max((int(d.max()) for d in per_graph_deg if d.size), default=1)
    n_deg = _round_up(max(deg, 1), multiple)
    # two-tier split: d_lo covers ~75% of atoms; n_hi = worst-case count of
    # atoms above d_lo in any batch_size-subset
    all_deg = (np.concatenate(per_graph_deg) if per_graph_deg
               else np.zeros(1))
    d_lo = int(-(-int(np.quantile(all_deg, 0.75)) // 8) * 8)
    n_node = _round_up(worst_case(n), multiple)
    n_hi = 0
    if 0 < d_lo < n_deg:
        n_hi = ((worst_case(np.array([int((d > d_lo).sum())
                                      for d in per_graph_deg])) + 7) // 8) * 8
        if n_hi >= n_node:
            d_lo = n_hi = 0   # the split would cover everything
    else:
        d_lo = 0
    # tiers: the worst-case exceed-count per threshold over any
    # batch_size-subset, fed to the tier DP
    tiers: tuple = ()
    if deg > 1 and per_graph_deg:
        cnt_mat = np.zeros((len(per_graph_deg), deg + 1), np.int64)
        for m, dvec in enumerate(per_graph_deg):
            if dvec.size:
                cnt_mat[m] = _exceed_counts(dvec, deg)
        k = min(batch_size, cnt_mat.shape[0])
        cnt_over = (-np.sort(-cnt_mat, axis=0))[:k].sum(axis=0)
        tiers = plan_degree_tiers(n_node, deg, cnt_over, multiple=multiple)
    return Budgets(n_node, _round_up(worst_case(e), multiple),
                   _round_up(worst_case(t), multiple), n_deg, d_lo, n_hi,
                   tiers=tiers)


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


def _degree_order(edge_src, edge_dst, a0: int, e0: int, n_node: int,
                  d_lo: int, n_hi: int, tiers: tuple) -> np.ndarray:
    """The relabelling of the degree sort: perm[new] = old, real atoms by
    descending max(in, out)-degree (stable), pad atoms last. Raises if the
    sorted atoms break the split's or a tier's guarantee."""
    key = np.maximum(np.bincount(edge_dst[:e0], minlength=n_node),
                     np.bincount(edge_src[:e0], minlength=n_node))
    perm = np.concatenate([np.argsort(-key[:a0], kind="stable"),
                           np.arange(a0, n_node)])
    key_sorted = key[perm]
    if d_lo > 0 and n_hi > 0:
        n_over = int((key_sorted > d_lo).sum())
        if n_over > n_hi:
            raise ValueError(
                f"{n_over} atoms exceed degree {d_lo} but the n_hi budget "
                f"is {n_hi}: budgets not from pad_budget_for?")
    prev_end = 0
    for (end_t, di_t, _) in tiers:
        n_over = int((key_sorted > di_t).sum())
        if n_over > prev_end:
            raise ValueError(
                f"{n_over} atoms exceed tier degree {di_t} but the tier "
                f"starts at row {prev_end}: budgets not from the tier "
                "planner?")
        prev_end = end_t
    if tiers and prev_end != n_node:
        raise ValueError(f"tiers end at {prev_end} != node budget {n_node}")
    return perm


def pad_graphs(
    graphs: Sequence[MolGraph],
    budgets: Budgets,
    n_graph: Optional[int] = None,
    targets: Optional[np.ndarray] = None,
    with_triplets: bool = False,
) -> GraphBatch:
    """Concatenate molecules and pad to static budgets; the arrays equal
    x2gnn_tpu's `pad_graphs(..., with_triplets=with_triplets)`. With a
    two-tier split or tiers in `budgets`, atoms are relabelled by
    descending degree (pad atoms last) and every index array follows,
    trip_i/j/k too. Each graph's target is `targets[i]` if given (shape
    (len(graphs),)), else `g.y[0]`. `with_triplets=False` (the blocked
    layout, which never reads them) leaves the triplet arrays and the
    neighbour tables zero-length; all batches of a run share the
    setting."""
    n_node, n_edge, n_trip, n_deg = budgets[:4]
    d_lo, n_hi = budgets.n_deg_lo, budgets.n_hi
    tiers = budgets.tiers
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
    n_trip_alloc = n_trip if with_triplets else 0
    trip_src_edge, trip_dst_edge, trip_j, trip_i, trip_k = (
        np.zeros(n_trip_alloc, dtype=np.int32) for _ in range(5))
    atom_gid = np.zeros(n_node, dtype=np.int32)
    edge_gid = np.zeros(n_edge, dtype=np.int32)
    y = np.zeros(n_graph, dtype=np.float32)

    a0 = e0 = t0 = 0
    for gid, g in enumerate(graphs):
        na, ne, nt = g.num_atoms, g.num_edges, g.num_triplets
        numbers[a0:a0 + na] = g.numbers
        positions[a0:a0 + na] = g.positions
        edge_src[e0:e0 + ne] = g.edge_index[0] + a0
        edge_dst[e0:e0 + ne] = g.edge_index[1] + a0
        edge_feat[e0:e0 + ne] = g.edge_feat
        if with_triplets:
            trip_src_edge[t0:t0 + nt] = g.triplet_index[0] + e0
            trip_dst_edge[t0:t0 + nt] = g.triplet_index[1] + e0
            trip_j[t0:t0 + nt] = g.atom_j + a0
            trip_i[t0:t0 + nt] = g.atom_i + a0
            trip_k[t0:t0 + nt] = g.atom_k + a0
        atom_gid[a0:a0 + na] = gid
        edge_gid[e0:e0 + ne] = gid
        y[gid] = targets[gid] if targets is not None else g.y[0]
        a0, e0, t0 = a0 + na, e0 + ne, t0 + nt

    # degree sort, a pure renaming of the atoms. The split fields stay set
    # even for an empty batch (the sort is then the identity).
    if (d_lo > 0 and n_hi > 0) or tiers:
        if not (d_lo > 0 and n_hi > 0):
            d_lo = n_hi = 0
        perm = _degree_order(edge_src, edge_dst, a0, e0, n_node, d_lo, n_hi,
                             tiers)
        inv = np.empty(n_node, np.int64)
        inv[perm] = np.arange(n_node)
        numbers, positions, atom_gid = (numbers[perm], positions[perm],
                                        atom_gid[perm])
        edge_src[:e0] = inv[edge_src[:e0]]
        edge_dst[:e0] = inv[edge_dst[:e0]]
        if with_triplets:
            for a in (trip_i, trip_j, trip_k):
                a[:t0] = inv[a[:t0]]
    else:
        d_lo = n_hi = 0

    nbr_trip, nbr_mask = _neighbour_table(
        trip_dst_edge[:t0], n_edge if with_triplets else 0, n_deg)
    in_edges, in_mask, edge_inpos = _slot_table(edge_dst[:e0], n_node, n_deg)
    out_edges, out_mask, edge_outpos = _slot_table(edge_src[:e0], n_node,
                                                   n_deg)
    return GraphBatch(
        numbers=numbers, positions=positions,
        edge_src=edge_src, edge_dst=edge_dst, edge_feat=edge_feat,
        trip_src_edge=trip_src_edge, trip_dst_edge=trip_dst_edge,
        trip_j=trip_j, trip_i=trip_i, trip_k=trip_k,
        atom_gid=atom_gid, edge_gid=edge_gid,
        node_mask=np.arange(n_node) < a0,
        edge_mask=np.arange(n_edge) < e0,
        trip_mask=np.arange(n_trip_alloc) < t0,
        y=y, graph_mask=np.arange(n_graph) < len(graphs),
        nbr_trip=nbr_trip, nbr_src=trip_src_edge[nbr_trip],
        nbr_mask=nbr_mask,
        in_edges=in_edges, in_mask=in_mask,
        out_edges=out_edges, out_mask=out_mask,
        edge_inpos=_pad_to(edge_inpos, n_edge),
        edge_outpos=_pad_to(edge_outpos, n_edge),
        n_hi=int(n_hi), d_lo=int(d_lo),
        tiers=tuple(tuple(int(v) for v in t) for t in tiers),
    )


def _neighbour_table(dsts: np.ndarray, n_edge: int, n_deg: int):
    """(n_edge, n_deg) triplet ids grouped by destination edge and their
    mask (x2gnn_tpu/data/batching.py:404-422). `dsts`, the real triplets'
    destination edges, is nondecreasing (each molecule's triplets are
    sorted by it and the molecules' edge offsets increase), so every
    edge's triplets sit in consecutive slots in triplet order."""
    nbr_trip = np.zeros((n_edge, n_deg), dtype=np.int32)
    nbr_mask = np.zeros((n_edge, n_deg), dtype=bool)
    t0 = dsts.shape[0]
    if t0 and n_edge:
        counts = np.bincount(dsts, minlength=n_edge)
        if counts.max() > n_deg:
            raise ValueError(f"max triplets/edge {counts.max()} exceeds "
                             f"degree budget {n_deg}")
        seg_start = np.concatenate([[0], np.cumsum(counts)])[:-1]
        pos = np.arange(t0) - seg_start[dsts]
        nbr_trip[dsts, pos] = np.arange(t0)
        nbr_mask[dsts, pos] = True
    return nbr_trip, nbr_mask


def _pad_to(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=a.dtype)
    out[:a.shape[0]] = a
    return out


def _pair_capacity(b: Budgets) -> int:
    """Pair slots one batch of budgets `b` gives the attention: the tier
    windows, else the two-tier split's, else N x D x D."""
    if b.tiers:
        starts = (0,) + tuple(t[0] for t in b.tiers[:-1])
        return sum((end - start) * di * dk
                   for (end, di, dk), start in zip(b.tiers, starts))
    if b.n_hi:
        return (b.n_hi * b.n_deg ** 2
                + (b.n_node - b.n_hi) * b.n_deg_lo * b.n_deg_lo)
    return b.n_node * b.n_deg ** 2


def mixed_packed_plan(
    graphs: Sequence[MolGraph],
    idx,
    batch_size: int,
    base: Budgets,
    multiple: int = 8,
    fill: float = 0.75,
):
    """One batch shape, mixed composition: first-fit-decreasing packing of
    the molecules `idx` (largest triplet count first) into bins whose
    capacity is the total need over the fixed plan's batch count, inflated
    by 1/`fill`; each bin starts with a large molecule and fills up with
    small ones. The split and the tiers are planned from the exact bin
    compositions (the trainer shuffles batch order, not membership).

    Returns (chunks, budgets, stats): the bins' index arrays, one Budgets
    per bin (all equal, with n_graph), and the real/padded node, edge,
    triplet and pair totals."""
    idx = np.asarray(idx)
    n_mols = len(idx)
    mol_needs = np.zeros((n_mols, 4), dtype=np.int64)
    deg_sq = np.zeros(n_mols, dtype=np.int64)
    want_split = base.n_deg_lo > 0 and base.n_hi > 0
    # mol_cnt[m, t] = atoms of molecule m with degree > t
    capd = max(int(base.n_deg), 1)
    mol_cnt = np.zeros((n_mols, capd + 1), dtype=np.int64)
    deg_max_all = 1
    for m, i in enumerate(idx):
        g = graphs[i]
        hi = 0
        if g.num_edges:
            deg = _atom_degrees(g)
            deg_sq[m] = int((deg.astype(np.int64) ** 2).sum())
            deg_max_all = max(deg_max_all, int(deg.max()))
            mol_cnt[m] = _exceed_counts(deg, capd)
            if want_split:
                hi = int((deg > base.n_deg_lo).sum())
        mol_needs[m] = (g.num_atoms, g.num_edges, g.num_triplets, hi)

    n_bins = max(1, -(-n_mols // batch_size))
    totals = mol_needs.sum(axis=0)
    cap = np.maximum(np.ceil(totals / (n_bins * fill)),
                     mol_needs.max(axis=0)).astype(np.int64)

    bins = []
    loads = np.zeros((0, 4), dtype=np.int64)
    for m in np.argsort(-mol_needs[:, 2], kind="stable"):
        need = mol_needs[m]
        fits = np.all(loads + need <= cap, axis=1)
        if fits.any():
            hit = int(np.argmax(fits))
            bins[hit].append(m)
            loads[hit] += need
        else:
            bins.append([m])
            loads = np.vstack([loads, need])
    n_node = _round_up(loads[:, 0].max(), multiple)
    n_hi = _round_up(loads[:, 3].max(), multiple) if want_split else 0
    d_lo = base.n_deg_lo if want_split else 0
    if want_split and n_hi >= n_node:
        n_hi = d_lo = 0
    capd_eff = min(deg_max_all, capd)
    bin_cnt = np.array([mol_cnt[np.asarray(b)].sum(axis=0) for b in bins],
                       dtype=np.int64)
    tiers = plan_degree_tiers(n_node, capd_eff,
                              bin_cnt.max(axis=0)[:capd_eff + 1],
                              multiple=multiple)
    bud = Budgets(n_node, _round_up(loads[:, 1].max(), multiple),
                  _round_up(loads[:, 2].max(), multiple), base.n_deg, d_lo,
                  n_hi, n_graph=_round_up(max(len(b) for b in bins),
                                          multiple),
                  tiers=tiers)
    chunks = [idx[np.asarray(b)] for b in bins]
    stats = {
        "real": tuple(int(x) for x in totals[:3]),
        "padded": tuple(int(bud[d] * len(chunks)) for d in range(3)),
        "pairs": (int(deg_sq.sum()), int(_pair_capacity(bud) * len(chunks))),
        "shapes": 1,
    }
    return chunks, [bud] * len(chunks), stats


def size_bucketed_plan(
    graphs: Sequence[MolGraph],
    idx,
    batch_size: int,
    num_shapes: int,
    base: Budgets,
    multiple: int = 8,
    pack: bool = False,
):
    """Size-grouped batches over `idx` with a closed set of budget shapes:
    molecules sorted by triplet count (largest first) are chunked into
    batches of `batch_size`, the chunks split into `num_shapes` contiguous
    classes, and each class gets the elementwise-max budget of its chunks,
    its own table width n_deg and the two-tier split point (a multiple of
    8) that minimizes its pair capacity. `pack=True` instead fills each
    batch greedily with consecutive molecules up to the class budget and
    sets n_graph to the class's largest count. Only `base.n_deg`'s role is
    taken over per class; the budgets carry no tiers.

    Returns (chunks, budgets, stats) as `mixed_packed_plan`."""
    idx = np.asarray(idx)
    t_sizes = np.array([graphs[i].num_triplets for i in idx])
    idx = idx[np.argsort(-t_sizes, kind="stable")]

    # per molecule: sizes; deg_gt[m, c] = atoms with degree > 8*(c+1);
    # deg_sq[m] = sum deg^2 (real pair work); deg_max[m]
    n_mols = len(idx)
    degs = [_atom_degrees(graphs[i]) for i in idx]
    max_deg_all = max((int(d.max()) for d in degs if d.size), default=1)
    n_cand = max(max_deg_all // 8 + 1, 1)
    mol_needs = np.zeros((n_mols, 3), dtype=np.int64)
    deg_gt = np.zeros((n_mols, n_cand), dtype=np.int64)
    deg_sq = np.zeros(n_mols, dtype=np.int64)
    deg_max = np.zeros(n_mols, dtype=np.int64)
    for m, i in enumerate(idx):
        g = graphs[i]
        mol_needs[m] = (g.num_atoms, g.num_edges, g.num_triplets)
        if g.num_edges:
            deg = degs[m]
            deg_sq[m] = int((deg.astype(np.int64) ** 2).sum())
            deg_max[m] = int(deg.max())
            for c in range(n_cand):
                deg_gt[m, c] = int((deg > 8 * (c + 1)).sum())

    pos_chunks = [np.arange(lo, min(lo + batch_size, n_mols))
                  for lo in range(0, n_mols, batch_size)]
    needs = np.array([mol_needs[c].sum(axis=0) for c in pos_chunks],
                     dtype=np.int64)
    n_chunks = len(pos_chunks)
    per_class = max(1, -(-n_chunks // max(num_shapes, 1)))
    chunks, budgets = [], []
    pair_capacity = 0
    for lo in range(0, n_chunks, per_class):
        cls = needs[lo:lo + per_class]
        cls_pos = pos_chunks[lo:lo + per_class]
        members = np.concatenate(cls_pos)
        n_node = _round_up(cls[:, 0].max(), multiple)
        n_deg = _round_up(max(int(deg_max[members].max()), 1), multiple)
        best = (n_node * n_deg * n_deg, 0, 0)   # (capacity, d_lo, n_hi)
        for c in range(n_cand):
            d_lo_c = 8 * (c + 1)
            if d_lo_c >= n_deg:
                break
            n_hi_c = _round_up(max(int(deg_gt[p, c].sum())
                                   for p in cls_pos), multiple)
            if n_hi_c >= n_node:
                continue
            cap = n_hi_c * n_deg * n_deg + (n_node - n_hi_c) * d_lo_c ** 2
            if cap < best[0]:
                best = (cap, d_lo_c, n_hi_c)
        _, d_lo, n_hi = best
        b = Budgets(n_node, _round_up(cls[:, 1].max(), multiple),
                    _round_up(cls[:, 2].max(), multiple), n_deg, d_lo, n_hi)
        if not pack:
            cls_chunks = [idx[p] for p in cls_pos]
        else:
            hi_col = d_lo // 8 - 1   # deg_gt column of the split point
            cls_chunks = []
            cur, acc = [], np.zeros(4, dtype=np.int64)
            for p in range(lo * batch_size,
                           min((lo + per_class) * batch_size, n_mols)):
                need = (*mol_needs[p], int(deg_gt[p, hi_col]) if n_hi else 0)
                fits = (acc[0] + need[0] <= b.n_node
                        and acc[1] + need[1] <= b.n_edge
                        and acc[2] + need[2] <= b.n_trip
                        and (b.n_hi == 0 or acc[3] + need[3] <= b.n_hi))
                if cur and not fits:
                    cls_chunks.append(np.array(cur))
                    cur, acc = [], np.zeros(4, dtype=np.int64)
                cur.append(idx[p])
                acc += np.asarray(need, dtype=np.int64)
            if cur:
                cls_chunks.append(np.array(cur))
            b = b._replace(n_graph=_round_up(
                max(len(c) for c in cls_chunks), multiple))
        chunks.extend(cls_chunks)
        budgets.extend([b] * len(cls_chunks))
        pair_capacity += _pair_capacity(b) * len(cls_chunks)

    stats = {
        "real": tuple(int(x) for x in mol_needs.sum(axis=0)),
        "padded": tuple(int(sum(b[d] for b in budgets)) for d in range(3)),
        "pairs": (int(deg_sq.sum()), int(pair_capacity)),
        "shapes": len({(b.n_node, b.n_edge, b.n_trip, b.n_deg, b.n_deg_lo,
                        b.n_hi, b.n_graph) for b in budgets}),
    }
    return chunks, budgets, stats


def batch_iterator(
    graphs: Sequence[MolGraph],
    batch_size: int,
    budgets: Optional[Budgets] = None,
    targets: Optional[np.ndarray] = None,
    with_triplets: bool = False,
) -> Iterator[GraphBatch]:
    """Yield fixed-shape GraphBatches over `graphs` in order; the last one
    is padded with empty graphs up to `batch_size`. `targets` (one per
    graph) overrides the graphs' own `y[0]`; `with_triplets` as in
    `pad_graphs`."""
    if budgets is None:
        budgets = pad_budget_for(graphs, batch_size)
    for lo in range(0, len(graphs), batch_size):
        chunk = graphs[lo:lo + batch_size]
        sub = (None if targets is None
               else np.asarray(targets[lo:lo + len(chunk)]))
        yield pad_graphs(chunk, budgets, n_graph=batch_size, targets=sub,
                         with_triplets=with_triplets)
