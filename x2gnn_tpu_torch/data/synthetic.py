"""Synthetic QM9-like molecules for tests, benchmarks and smoke runs
(x2gnn_tpu/data/synthetic.py).

H/C/N/O/F atoms placed with a minimum separation so radius-graph degree
statistics resemble real featurized sets. `synthetic_dataset` gives
random placeholder features; `synthetic_labeled_graph` (:41-158) the
native integral features and a label derived from them, the
independent-particle energy (and optionally the HOMO-LUMO gap).
"""

from __future__ import annotations

from typing import List, Tuple

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


def independent_particle_energy(
    numbers: np.ndarray,
    positions: np.ndarray,
    S: np.ndarray,
    H_over_nelec: np.ndarray,
) -> float:
    """Physically-derived label: non-interacting electronic energy from the
    native one-electron integrals plus nuclear repulsion (Hartree).

    E = sum over occupied orbitals of the generalized eigenvalues of
    (Hcore, S), doubly filled (one singly-occupied level for odd electron
    counts), + sum_{i<j} Z_i Z_j / r_ij. This is an extended-Hueckel-style
    total energy: a smooth, extensive function of composition AND geometry
    that a model reading the integral edge features can in principle learn
    exactly — a substitute for QM9 labels where the QM9 raw data is not
    at hand (the reference's labels come from DFT, train_ema.py:28-38).

    Uses canonical orthogonalization (S eigenvalues < 1e-8 dropped) so
    near-linear-dependent random geometries cannot blow up the solve.
    """
    return independent_particle_labels(numbers, positions, S,
                                       H_over_nelec)[0]


HARTREE_TO_EV = 27.211386245988


def independent_particle_labels(
    numbers: np.ndarray,
    positions: np.ndarray,
    S: np.ndarray,
    H_over_nelec: np.ndarray,
) -> Tuple[float, float]:
    """(total energy [Hartree], HOMO-LUMO-style gap [eV]) from one
    generalized eigensolve of (Hcore, S).

    The gap is the intensive companion label to the extensive energy
    (reference intensive targets 0-5 dispatch to the global/MolWise
    model, train_ema.py:41-44; QM9 target 4 is exactly this gap). For
    odd electron counts the singly-occupied level is HOMO and the next
    level up is LUMO.
    """
    import scipy.linalg as sla

    nelec = int(np.asarray(numbers).sum())
    H = np.asarray(H_over_nelec) * max(nelec, 1)
    s_val, s_vec = np.linalg.eigh(np.asarray(S))
    keep = s_val > 1e-8
    X = s_vec[:, keep] / np.sqrt(s_val[keep])
    eps = sla.eigh(X.T @ H @ X, eigvals_only=True)
    nocc, odd = divmod(nelec, 2)
    e_el = 2.0 * eps[:nocc].sum() + (eps[nocc] if odd else 0.0)
    homo = nocc if odd else nocc - 1          # highest (partly) occupied
    gap_ev = float(eps[homo + 1] - eps[homo]) * HARTREE_TO_EV
    pos_bohr = np.asarray(positions, np.float64) * 1.8897259886
    z = np.asarray(numbers, np.float64)
    diff = pos_bohr[:, None, :] - pos_bohr[None, :, :]
    r = np.sqrt((diff ** 2).sum(-1))
    iu = np.triu_indices(len(z), k=1)
    e_nn = (z[iu[0]] * z[iu[1]] / r[iu]).sum()
    return float(e_el + e_nn), gap_ev


def synthetic_geometry(index: int, seed: int = 7, mean_atoms: int = 13,
                       min_atoms: int = 4, max_atoms: int = 26):
    """(atomic numbers, float64 positions) of `synthetic_labeled_graph`'s
    molecule `index`: its own random stream, seeded by (seed, index); a
    size drawn around `mean_atoms` and clipped."""
    rng = np.random.default_rng([seed, index])
    n = int(np.clip(round(rng.normal(mean_atoms, 4.0)),
                    min_atoms, max_atoms))
    return random_molecule(rng, n)


def synthetic_labeled_graph(
    index: int,
    seed: int = 7,
    mean_atoms: int = 13,
    min_atoms: int = 4,
    max_atoms: int = 26,
    cutoff: float = 5.0,
    featurize: bool = True,
    basis: str = "x2sv",
    gap_label: bool = False,
) -> MolGraph:
    """One deterministic synthetic molecule with NATIVE integral edge
    features and the independent-particle energy label.

    Per-index rng streams make generation resumable and order-independent
    (chunked featurization can restart anywhere). Heterogeneous sizes
    (normal around `mean_atoms`, clipped) give QM9-like batch-occupancy
    statistics for the bucketed-budget training path.

    `basis` selects the integral basis ('x2sv' stand-in or '6311' = the
    embedded published 6-311+G(3df,2p), the exact basis the reference
    requests, scf.py:31). The geometry rng stream is independent of
    `basis`/`gap_label`, so geometry-only stand-ins pre-warm compiled
    shapes for any featurized variant. With gap_label=True, y is
    (2,) = [IP energy Hartree, HOMO-LUMO gap eV] — extensive +
    intensive companion labels (train_ema.py:41-44 dispatch).
    """
    from x2gnn_tpu_torch.data.featurize import EDGE_FEAT_DIM, sa_compress
    from x2gnn_tpu_torch.data.integrals.basis import get_basis
    from x2gnn_tpu_torch.data.integrals.engine import one_electron_matrices

    numbers, pos = synthetic_geometry(index, seed, mean_atoms, min_atoms,
                                      max_atoms)
    g = build_mol_graph(numbers, pos, y=np.array([0.0]), cutoff=cutoff,
                        edge_feat_dim=EDGE_FEAT_DIM, index=index)
    if not featurize:
        # geometry-only stand-in: the same graph structure (so the same
        # batch budgets) without the integral engine
        return g
    S, H_n, ao = one_electron_matrices(
        numbers, pos, basis=get_basis("6-311+g(3df,2p)" if basis == "6311"
                                      else basis))
    g.edge_feat[:] = sa_compress(S, H_n, ao, g.edge_index)
    energy, gap = independent_particle_labels(numbers, pos, S, H_n)
    g.y = np.array([energy, gap] if gap_label else [energy],
                   dtype=np.float64)
    return g


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
