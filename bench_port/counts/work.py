"""Operations and bytes the model's work needs, from the configuration and
the molecules' real atoms, edges and attention pairs (never from the
padding or from how kernels are launched).

Peaks are NVIDIA's published figures for one H100 SXM: 67 TFLOP/s in
float32 outside the tensor cores (the port computes float32 with TF32 off)
and 3.35 TB/s of HBM bandwidth.

The attention arithmetic follows the fused attention's definition (the
port's `chip_smoke.py::attention_work`, `attention_bwd_work` and
`live_input_bytes`, counted over real rows): a valid pair is an (in-edge
i->j, out-edge j->k) pair of one atom j with k != i, so an atom of degree
d has d (d - 1) of them; a live row is an edge into (query) or out of (key)
an atom with d >= 2. Inputs are read once at their live rows, outputs are
written once over every real row. Model FLOPs count the matrix products
(2 m n k each, twice that again in the backward for the input and the
weight gradients) and the attention's operations; elementwise work is not
counted.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from bench_port.reference.graphs import degrees, radius_edges

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
WORD = 4   # float32 and int32 bytes


class Stats(NamedTuple):
    """Sums over a batch's molecules."""
    molecules: int
    atoms: int
    edges: int
    pairs: int        # sum d (d - 1)
    live_rows: int    # edges at atoms of degree >= 2, per side
    live_atoms: int   # atoms of degree >= 2

    def __add__(self, other):
        return Stats(*(a + b for a, b in zip(self, other)))


ZERO = Stats(0, 0, 0, 0, 0, 0)


def mol_stats(positions: np.ndarray, cutoff: float) -> Stats:
    n = positions.shape[0]
    edges = radius_edges(positions, cutoff)
    deg = degrees(edges, n)
    live = deg >= 2
    return Stats(1, n, int(edges.src.shape[0]), int((deg * (deg - 1)).sum()),
                 int(deg[live].sum()), int(live.sum()))


def total(stats: Sequence[Stats]) -> Stats:
    out = ZERO
    for s in stats:
        out = out + s
    return out


def _dims(m: dict):
    C, H, L, K = m["in_channels"], m["heads"], m["sbf_dim"], m["rbf_dim"]
    return C, H, L, K


def attn_fwd(s: Stats, m: dict):
    """(operations, bytes) of one conv's attention over a batch."""
    C, H, L, K = _dims(m)
    ops = (s.pairs * (C * (2 * L + 5) + H + 4 * max(L - 2, 0))
           + s.live_rows * 2 * L * K * C)
    words = (s.live_rows * C            # q
             + s.live_rows * 2 * C      # k, v
             + s.live_rows * L * K      # radial factors of the keys
             + s.pairs                  # cos(angle) per pair
             + s.live_atoms * C         # media-atom projection
             + 2 * s.edges              # atom ids of both tables
             + L * K * C + C            # sbf weight and bias
             + s.edges * C)             # output
    return ops, words * WORD


def attn_bwd(s: Stats, m: dict):
    """(operations, bytes) of one conv's attention backward over a batch:
    the forward's live inputs and the output gradient read once, every
    input gradient written once."""
    C, H, L, K = _dims(m)
    ops = (s.pairs * (C * (4 * L + 17) + 6 * H + 4 * max(L - 2, 0))
           + s.live_rows * 4 * L * K * C)
    _, fwd_bytes = attn_fwd(s, m)
    words = (s.live_rows * C                       # g at live query rows
             + 3 * s.edges * C + s.atoms * C       # dq, dk, dv, de
             + L * K * C + C                       # dW, db
             - s.edges * C)                        # no output written
    return ops, fwd_bytes + words * WORD


def gemm_flops(s: Stats, m: dict) -> float:
    """Forward matrix-product FLOPs of the whole model over a batch."""
    C, H, L, K = _dims(m)
    emb, F, R = m["embedding_size"], m["edge_feat_dim"], m["conv_layers"] + 1
    depth = m["mlp_depth"]
    E, n = s.edges, s.atoms
    f = 2 * E * F * 2 * emb + 2 * E * 2 * emb * C      # mat_trans, emb_trans
    f += 3 * 2 * n * emb * emb                          # embedding, edgenn
    f += R * (2 * E * K * C + (depth - 1) * 2 * n * C * C + 2 * n * C)
    per_conv = (2 * E * K * C + 4 * 2 * E * C * C      # lin_rbf, q k v skip
                + 2 * n * emb * C                       # lin_edge
                + 7 * 2 * E * C * C)                    # residual blocks
    return f + m["conv_layers"] * per_conv


def step_flops(s: Stats, m: dict) -> float:
    """Forward and backward of one training step."""
    return (3 * gemm_flops(s, m)
            + m["conv_layers"] * (attn_fwd(s, m)[0] + attn_bwd(s, m)[0]))


def bound_s(ops: float, nbytes: float) -> float:
    """Least time at the card's peaks."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S)
