"""Plain PyTorch reference of X2-GNN (atom-wise readout, v1 conv), written
for the benchmark from the model's equations.

Every per-edge quantity is a row of a flat edge table and every attention
pair a row of a flat triplet table; sums go through `index_add`. Geometry
(distances, the smooth cutoff envelope, the spherical Bessel radial basis,
the Legendre angular basis) is worked out in float64 numpy from the
molecules' positions, then rounded to float32; everything with a parameter
in it runs in float32 tensors (TF32 off on the card).

For one molecule with atoms a (atomic number Z_a), edges e = (s -> t) of
length d_e and features f_e (F wide), triplets (i->j, j->k), k != i:

    env_e    = 1/x + A x^(p-1) + B x^p + C x^(p+1),  x = d_e / cutoff,
               p = envelope_exponent + 1, A = -(p+1)(p+2)/2, B = p(p+2),
               C = -p(p+1)/2
    rbf_e    = sin(freq * d_e / cutoff) * env_e                       (K)
    x_e      = silu(W2 silu(W1 (f_e env_e)))                          (C)
    attr_a   = W4 silu(W3 silu(W0 renorm(emb)[Z_a]))                   (emb)
    sbf_t    = env(d_jk) N_ln j_l(z_ln d_jk / cutoff) Y_l(cos angle ijk)  (L*K)

A conv, with heads H of width c = C / H:
    q = Wq x + bq,  u = x * (Wr rbf),  k = Wk u + bk,  v = Wv u + bv
    e_t = We attr_j,  s_t = sbf_t Ws + bs
    score_t = <q_{ij}, k_{jk} + e_t>_head / sqrt(c)
    alpha_t = softmax of score over the triplets into edge i->j
    out_{ij} = sum_t alpha_t (v_{jk} + e_t) * s_t + Wskip x_{ij} + bskip
then a layer norm over all edges x channels of each molecule (no affine),
a residual block, silu(dense), the conv's input added, two residual
blocks. Readout r (r = 0 before the convs, r = i + 1 after conv i): each
atom sums (Wr' rbf_e + br') * x_e over the edges leaving it, a 3-layer
silu MLP maps the sum to a scalar; the molecule's prediction is the sum of
all readouts over its atoms.

The embedding table is renormalized to row norms of at most `max_norm` in
the forward; each looked-up row's gradient is divided by how often its
atomic number occurs in the step's batch, and row 0 (padding) gets none.

Parameters are a dict {name: tensor} under the names of `param_spec`.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference.graphs import degrees, radius_edges, triplets

VOCAB = 10        # atomic numbers 0 (padding) .. 9
MAX_NORM = 3.0    # the embedding's row-norm bound
NORM_EPS = 1e-8   # the graph layer norm's epsilon


class ParamSpec(NamedTuple):
    name: str
    shape: tuple
    init: str      # glorot | uniform | uniform_bias | zeros | embedding
                   # | frequencies
    fan_in: int    # for uniform and uniform_bias


def param_spec(m: dict) -> List[ParamSpec]:
    """Every parameter of the model config `m` (the "model" block of a
    configuration file): name, shape and how the benchmark draws it.
    Weights are (out, in); the sbf kernel is (L*K, C)."""
    C, emb, K, L = (m["in_channels"], m["embedding_size"], m["rbf_dim"],
                    m["sbf_dim"])
    out: List[ParamSpec] = []

    def dense(name, n_in, n_out, bias=True, init="glorot"):
        out.append(ParamSpec(f"{name}.weight", (n_out, n_in), init, n_in))
        if bias:
            out.append(ParamSpec(
                f"{name}.bias", (n_out,),
                "zeros" if init == "glorot" else "uniform_bias", n_in))

    dense("mat_trans", m["edge_feat_dim"], 2 * emb)
    dense("emb_trans", 2 * emb, C)
    out.append(ParamSpec("emb_block.embedding", (VOCAB, emb), "embedding",
                         emb))
    dense("emb_block.lin", emb, emb)
    out.append(ParamSpec("rbf_layer.frequencies", (K,), "frequencies", K))
    dense("edgenn_0", emb, emb)
    dense("edgenn_1", emb, emb)
    depth = m["mlp_depth"]
    for r in range(m["conv_layers"] + 1):
        dense(f"readout_{r}.lin_rbf", K, C)
        for d in range(depth - 1):
            dense(f"readout_{r}.mlp.mlp_{d}", C, C)
        dense(f"readout_{r}.mlp.mlp_out", C, 1)
    for i in range(m["conv_layers"]):
        c = f"conv_{i}"
        dense(f"{c}.lin_rbf", K, C, bias=False)
        dense(f"{c}.lin_query", C, C, init="uniform")
        dense(f"{c}.lin_edge", emb, C, bias=False, init="uniform")
        out.append(ParamSpec(f"{c}.lin_sbf.kernel", (L * K, C), "glorot",
                             L * K))
        out.append(ParamSpec(f"{c}.lin_sbf.bias", (C,), "zeros", L * K))
        dense(f"{c}.lin_key", C, C, init="uniform")
        dense(f"{c}.lin_value", C, C, init="uniform")
        dense(f"{c}.lin_skip", C, C, init="uniform")
        for blk in (f"bf_skip_{i}", f"af_skip_{i}_0", f"af_skip_{i}_1"):
            dense(f"{blk}.lin0", C, C)
            dense(f"{blk}.lin1", C, C)
        dense(f"dense_bf_skip_{i}", C, C)
    return out


# ---- geometry, float64 numpy -------------------------------------------

def envelope(d: np.ndarray, cutoff: float, exponent: int) -> np.ndarray:
    p = exponent + 1
    a, b, c = -(p + 1) * (p + 2) / 2.0, p * (p + 2.0), -p * (p + 1) / 2.0
    x = d / cutoff
    return 1.0 / x + a * x ** (p - 1) + b * x ** p + c * x ** (p + 1)


_ZEROS: Dict[tuple, tuple] = {}


def bessel_zeros(L: int, K: int):
    """(zeros (L, K), norms (L, K)): the first K positive zeros z_ln of the
    spherical Bessel function j_l, and 1 / sqrt(j_{l+1}(z_ln)^2 / 2)."""
    if (L, K) not in _ZEROS:
        from scipy.optimize import brentq
        from scipy.special import spherical_jn
        zeros = np.zeros((L, K))
        grid = np.arange(0.5, (K + L + 2) * np.pi, 0.01)
        for l in range(L):
            f = spherical_jn(l, grid)
            change = np.nonzero(np.sign(f[:-1]) != np.sign(f[1:]))[0][:K]
            zeros[l] = [brentq(lambda x: spherical_jn(l, x), grid[c],
                               grid[c + 1], xtol=1e-15) for c in change]
        norms = 1.0 / np.sqrt(0.5 * spherical_jn(
            np.arange(1, L + 1)[:, None], zeros) ** 2)
        _ZEROS[(L, K)] = (zeros, norms)
    return _ZEROS[(L, K)]


class Molecule(NamedTuple):
    """One molecule as the benchmark makes it."""
    numbers: np.ndarray    # (n,) int
    positions: np.ndarray  # (n, 3) float32
    feat: np.ndarray       # (E, F) float32, src-major edge order
    y: float


class Block(NamedTuple):
    """Molecules concatenated into flat tables, as float32/int64 tensors."""
    n_mol: int
    numbers: torch.Tensor    # (n,)
    atom_mol: torch.Tensor   # (n,)
    src: torch.Tensor        # (E,)
    dst: torch.Tensor
    edge_mol: torch.Tensor   # (E,)
    d: torch.Tensor          # (E,) edge length
    env: torch.Tensor        # (E,) envelope
    feat: torch.Tensor       # (E, F)
    t_in: torch.Tensor       # (T,) receiving edge i->j
    t_out: torch.Tensor      # (T,) sending edge j->k
    t_j: torch.Tensor        # (T,) media atom
    sbf: torch.Tensor        # (T, L*K) radial x angular basis
    y: torch.Tensor          # (n_mol,)


def make_block(mols: Sequence[Molecule], m: dict, device) -> Block:
    """The flat tables of `mols` on `device`; raises if a molecule's
    feature rows do not match its radius graph."""
    L, K, cut, p = m["sbf_dim"], m["rbf_dim"], m["cutoff"], \
        m["envelope_exponent"]
    zeros, norms = bessel_zeros(L, K)
    from scipy.special import eval_legendre, spherical_jn
    cols = {k: [] for k in ("numbers", "atom_mol", "src", "dst", "edge_mol",
                            "d", "feat", "t_in", "t_out", "t_j", "radial",
                            "ang")}
    a0 = e0 = 0
    for idx, mol in enumerate(mols):
        n = len(mol.numbers)
        pos = np.asarray(mol.positions, np.float64)
        edges = radius_edges(pos, cut)
        if edges.src.shape[0] != mol.feat.shape[0]:
            raise ValueError(f"molecule {idx}: {mol.feat.shape[0]} feature "
                             f"rows for {edges.src.shape[0]} edges")
        tr = triplets(edges, n)
        vec = pos[edges.dst] - pos[edges.src]
        d = np.sqrt((vec * vec).sum(-1))
        ji = pos[tr.i] - pos[tr.j]
        jk = pos[tr.k] - pos[tr.j]
        cos = np.clip((ji * jk).sum(-1) / np.sqrt(
            (ji * ji).sum(-1) * (jk * jk).sum(-1)), -1.0, 1.0)
        radial = (spherical_jn(np.arange(L)[None, :, None],
                               zeros[None] * (d / cut)[:, None, None])
                  * norms[None] * envelope(d, cut, p)[:, None, None])
        cols["radial"].append(radial.reshape(-1, L * K))
        cols["ang"].append(np.stack(
            [math.sqrt((2 * l + 1) / (4 * math.pi)) * eval_legendre(l, cos)
             for l in range(L)], 1))
        cols["numbers"].append(np.asarray(mol.numbers, np.int64))
        cols["atom_mol"].append(np.full(n, idx, np.int64))
        cols["src"].append(edges.src + a0)
        cols["dst"].append(edges.dst + a0)
        cols["edge_mol"].append(np.full(len(d), idx, np.int64))
        cols["d"].append(d)
        cols["feat"].append(mol.feat)
        cols["t_in"].append(tr.e_in + e0)
        cols["t_out"].append(tr.e_out + e0)
        cols["t_j"].append(tr.j + a0)
        a0 += n
        e0 += len(d)
    cat = {k: np.concatenate(v) for k, v in cols.items()}
    env = envelope(cat["d"], cut, p)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    f32, i64 = torch.float32, torch.int64
    t_out = t(cat["t_out"], i64)
    sbf = (t(cat["radial"], f32).reshape(-1, L, K)[t_out]
           * t(cat["ang"], f32)[:, :, None]).reshape(-1, L * K)
    return Block(len(mols), t(cat["numbers"], i64), t(cat["atom_mol"], i64),
                 t(cat["src"], i64), t(cat["dst"], i64),
                 t(cat["edge_mol"], i64), t(cat["d"], f32), t(env, f32),
                 t(cat["feat"], f32), t(cat["t_in"], i64),
                 t_out, t(cat["t_j"], i64), sbf,
                 t([mol.y for mol in mols], f32))


# ---- the model --------------------------------------------------------

def _lin(p, name, x):
    y = x @ p[f"{name}.weight"].t()
    b = p.get(f"{name}.bias")
    return y if b is None else y + b


def _residual(p, name, x):
    return F.silu(_lin(p, f"{name}.lin1", F.silu(_lin(p, f"{name}.lin0",
                                                      x)))) + x


def _readout(p, r, x, rbf, blk, n_atoms, depth):
    h = _lin(p, f"readout_{r}.lin_rbf", rbf) * x
    h = torch.zeros(n_atoms, h.shape[1], dtype=h.dtype,
                    device=h.device).index_add_(0, blk.src, h)
    for d in range(depth - 1):
        h = F.silu(_lin(p, f"readout_{r}.mlp.mlp_{d}", h))
    return _lin(p, f"readout_{r}.mlp.mlp_out", h)[:, 0]


def _graph_norm(x, blk):
    """Layer norm over all rows x channels of each molecule."""
    G, C = blk.n_mol, x.shape[1]
    count = torch.zeros(G, dtype=x.dtype, device=x.device).index_add_(
        0, blk.edge_mol, torch.ones_like(x[:, 0])) * C
    mean = torch.zeros(G, dtype=x.dtype, device=x.device).index_add_(
        0, blk.edge_mol, x.sum(1)) / count
    cen = x - mean[blk.edge_mol][:, None]
    var = torch.zeros(G, dtype=x.dtype, device=x.device).index_add_(
        0, blk.edge_mol, (cen * cen).sum(1)) / count
    return cen / torch.sqrt(var + NORM_EPS)[blk.edge_mol][:, None]


def _conv(p, i, x, rbf, attr, blk, heads):
    E, C = x.shape
    c = C // heads
    pre = f"conv_{i}"
    q = _lin(p, f"{pre}.lin_query", x).reshape(E, heads, c)
    u = x * _lin(p, f"{pre}.lin_rbf", rbf)
    k = _lin(p, f"{pre}.lin_key", u).reshape(E, heads, c)
    v = _lin(p, f"{pre}.lin_value", u).reshape(E, heads, c)
    e = _lin(p, f"{pre}.lin_edge", attr)[blk.t_j].reshape(-1, heads, c)
    s = (blk.sbf @ p[f"{pre}.lin_sbf.kernel"]
         + p[f"{pre}.lin_sbf.bias"]).reshape(-1, heads, c)
    score = (q[blk.t_in] * (k[blk.t_out] + e)).sum(-1) / math.sqrt(c)
    top = torch.full((E, heads), -torch.inf, dtype=score.dtype,
                     device=score.device).scatter_reduce_(
        0, blk.t_in[:, None].expand(-1, heads), score.detach(), "amax")
    ex = torch.exp(score - top[blk.t_in])
    den = torch.zeros(E, heads, dtype=ex.dtype,
                      device=ex.device).index_add_(0, blk.t_in, ex)
    alpha = ex / den[blk.t_in]
    msg = (v[blk.t_out] + e) * s * alpha[..., None]
    out = torch.zeros(E, heads, c, dtype=msg.dtype,
                      device=msg.device).index_add_(0, blk.t_in, msg)
    return out.reshape(E, C) + _lin(p, f"{pre}.lin_skip", x)


def forward(p: Dict[str, torch.Tensor], blk: Block, m: dict,
            z_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_mol,) predictions of the block's molecules. `z_counts` (VOCAB,):
    the atomic numbers' counts that the embedding rows' gradients divide
    by (default: the counts in this block)."""
    n_atoms = blk.numbers.shape[0]
    K, cut = m["rbf_dim"], m["cutoff"]
    env = blk.env[:, None]
    x = F.silu(_lin(p, "emb_trans",
                    F.silu(_lin(p, "mat_trans", blk.feat * env))))
    rbf = torch.sin(p["rbf_layer.frequencies"]
                    * (blk.d / cut)[:, None]) * env
    table = p["emb_block.embedding"]
    norms = torch.sqrt((table * table).sum(-1, keepdim=True) + 1e-24)
    table = table * torch.clamp(MAX_NORM / norms, max=1.0)
    rows = table[blk.numbers]
    if rows.requires_grad:
        if z_counts is None:
            z_counts = torch.bincount(blk.numbers, minlength=VOCAB).to(
                rows.dtype)
        scale = torch.where(blk.numbers == 0, 0.0,
                            1.0 / torch.clamp(z_counts[blk.numbers], min=1))
        rows.register_hook(lambda g: g * scale[:, None])
    a = F.silu(_lin(p, "emb_block.lin", rows))
    attr = _lin(p, "edgenn_1", F.silu(_lin(p, "edgenn_0", a)))
    depth = m["mlp_depth"]
    atom_out = _readout(p, 0, x, rbf, blk, n_atoms, depth)
    for i in range(m["conv_layers"]):
        res = x
        h = _conv(p, i, x, rbf, attr, blk, m["heads"])
        h = _graph_norm(h, blk)
        h = _residual(p, f"bf_skip_{i}", h)
        h = F.silu(_lin(p, f"dense_bf_skip_{i}", h)) + res
        h = _residual(p, f"af_skip_{i}_0", h)
        x = _residual(p, f"af_skip_{i}_1", h)
        atom_out = atom_out + _readout(p, i + 1, x, rbf, blk, n_atoms, depth)
    return torch.zeros(blk.n_mol, dtype=atom_out.dtype,
                       device=atom_out.device).index_add_(
        0, blk.atom_mol, atom_out)


def triplet_count(mol: Molecule, cutoff: float) -> int:
    """Triplets of one molecule: sum over atoms of deg (deg - 1)."""
    deg = degrees(radius_edges(mol.positions, cutoff), len(mol.numbers))
    return int((deg * (deg - 1)).sum())


def blocks_of(mols: Sequence[Molecule], cutoff: float,
              max_triplets: int) -> List[List[int]]:
    """Consecutive runs of molecule indices, each with at most
    `max_triplets` triplets (a molecule with more stands alone)."""
    out, cur, tot = [], [], 0
    for i, mol in enumerate(mols):
        t = triplet_count(mol, cutoff)
        if cur and tot + t > max_triplets:
            out.append(cur)
            cur, tot = [], 0
        cur.append(i)
        tot += t
    if cur:
        out.append(cur)
    return out


def predict(p: Dict[str, torch.Tensor], mols: Sequence[Molecule], m: dict,
            device, max_triplets: int = 400_000) -> np.ndarray:
    """(len(mols),) float64 predictions, in blocks, without gradients."""
    out = []
    with torch.no_grad():
        for idx in blocks_of(mols, m["cutoff"], max_triplets):
            blk = make_block([mols[i] for i in idx], m, device)
            out.append(forward(p, blk, m).double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)
