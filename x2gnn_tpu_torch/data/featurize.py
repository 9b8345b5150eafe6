"""Quantum edge features: symmetry-adapted one-electron-integral blocks
(x2gnn_tpu/data/featurize.py:47-274).

Per molecule (reference scf.py:27-119): the overlap matrix S and the core
Hamiltonian H (divided by the electron count); per directed edge (i, j),
the AO block between atom i's and atom j's orbitals, aligned into a
39x39 frame (heavy atoms have 39 AOs = 5s + 4p + 3d + 1f shells; H atoms
9 = 3s + 2p, aligned at offset 2), each axis compressed to 13 entries
(the 5 s columns kept, each p/d/f shell's L2 norm) -> 13x13 per matrix,
338 features for the two.

Backends: 'native6311' (the port's C++ engine on the embedded published
6-311+G(3df,2p) data), 'native' (the same engine on the 'x2sv'
stand-in), 'pyscf' (exact integrals through PySCF, where it is
installed), 'zero' (zeros, for structure-only work) and 'auto' (pyscf if
installed, else native6311). Graph caches and training runs carry the
basis tag of their features (`BACKEND_BASIS`); evaluation refuses to mix
two tags.

The reference's scf.py:69 compares `ij_ovlp.size` (the method object) to
a Size, so its (9, 39) H-row blocks are padded top-left instead of at
rows 2:11; `replicate_reference_bug=True` reproduces its features bit
for bit.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np

from x2gnn_tpu_torch.data.molecule import Molecule

# Shell-group column layout of the 39-AO heavy-atom frame:
# 5 s columns kept as-is, then L2-norm groups for 4 p shells, 3 d shells,
# 1 f shell (scf.py:75-114).
_S_COLS = 5
_GROUPS = [(5, 8), (8, 11), (11, 14), (14, 17), (17, 22), (22, 27),
           (27, 32), (32, 39)]
SA_DIM = _S_COLS + len(_GROUPS)          # 13
EDGE_FEAT_DIM = 2 * SA_DIM * SA_DIM      # 338
_HEAVY_NAO = 39
_H_NAO = 9
_H_OFFSET = 2                            # H block alignment (scf.py:63-68)


def _sa_compress_axis(mat: np.ndarray, axis: int) -> np.ndarray:
    """Compress one 39-length axis to 13 symmetry-adapted entries."""
    mat = np.moveaxis(mat, axis, 0)      # (39, ...)
    parts = [mat[:_S_COLS]]
    for lo, hi in _GROUPS:
        parts.append(
            np.sqrt((mat[lo:hi] ** 2).sum(axis=0, keepdims=True)))
    out = np.concatenate(parts, axis=0)  # (13, ...)
    return np.moveaxis(out, 0, axis)


def _pad_block(block: np.ndarray, replicate_reference_bug: bool
               ) -> np.ndarray:
    """Align an AO block into the 39x39 frame. H atoms (9 AOs) sit at
    offset 2 so their s/p shells line up with heavy-atom valence shells."""
    ni, nj = block.shape
    if replicate_reference_bug:
        # the reference assigns f64 slices into float32 torch.zeros and
        # norms in f32 (scf.py:61-114) — truncate BEFORE the norms so
        # the parity flag is bit-for-bit, not just close
        block = block.astype(np.float32)
    out = np.zeros((_HEAVY_NAO, _HEAVY_NAO), dtype=block.dtype)
    ri = slice(_H_OFFSET, _H_OFFSET + ni) if ni == _H_NAO else slice(0, ni)
    cj = slice(_H_OFFSET, _H_OFFSET + nj) if nj == _H_NAO else slice(0, nj)
    if replicate_reference_bug and ni == _H_NAO and nj != _H_NAO:
        # scf.py:69's broken comparison drops (9, 39) blocks into the
        # generic top-left branch
        ri = slice(0, ni)
    out[ri, cj] = block
    return out


def _sa_compress_frames(frames: np.ndarray) -> np.ndarray:
    """(E, 39, 39) aligned blocks -> (E, 13, 13), vectorized over edges.
    Column-axis compression first, then row-axis (scf.py:75-114)."""
    def compress_last(m):  # (..., 39) -> (..., 13)
        parts = [m[..., :_S_COLS]]
        for lo, hi in _GROUPS:
            parts.append(np.sqrt((m[..., lo:hi] ** 2).sum(
                axis=-1, keepdims=True)))
        return np.concatenate(parts, axis=-1)

    cols = compress_last(frames)                       # (E, 39, 13)
    rows = compress_last(np.swapaxes(cols, 1, 2))      # (E, 13, 13)
    return np.swapaxes(rows, 1, 2)


def sa_compress(
    mat_ovlp: np.ndarray,
    mat_hcore: np.ndarray,
    ao_slices: np.ndarray,
    edge_index: np.ndarray,
    replicate_reference_bug: bool = False,
) -> np.ndarray:
    """Edge features from full AO matrices.

    ao_slices: (num_atoms, 2) [start, stop) AO index per atom (the last two
    columns of PySCF's aoslice_by_atom). Returns (E, 338) float32.
    Same math as the reference's per-edge loop (scf.py:52-117) but
    vectorized over edges, grouped by (row, col) AO-block widths — the
    per-edge Python loop was a material fraction of featurization time
    at dataset scale.
    """
    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    E = src.shape[0]
    feats = np.zeros((E, EDGE_FEAT_DIM), dtype=np.float32)
    if E == 0:
        return feats
    ao_slices = np.asarray(ao_slices)
    starts, stops = ao_slices[:, 0], ao_slices[:, 1]
    width = stops - starts
    wi, wj = width[src], width[dst]
    dtype = np.float32 if replicate_reference_bug else np.result_type(
        mat_ovlp, mat_hcore)
    for pi in np.unique(wi):
        for pj in np.unique(wj[wi == pi]):
            sel = np.where((wi == pi) & (wj == pj))[0]
            ri = _H_OFFSET if pi == _H_NAO else 0
            rj = _H_OFFSET if pj == _H_NAO else 0
            if replicate_reference_bug and pi == _H_NAO and pj != _H_NAO:
                # scf.py:69's broken comparison drops (9, 39) blocks into
                # the generic top-left branch
                ri = 0
            rows = starts[src[sel]][:, None] + np.arange(pi)[None, :]
            cols = starts[dst[sel]][:, None] + np.arange(pj)[None, :]
            blk_s = mat_ovlp[rows[:, :, None], cols[:, None, :]]
            blk_h = mat_hcore[rows[:, :, None], cols[:, None, :]]
            frames = np.zeros((sel.size, 2, _HEAVY_NAO, _HEAVY_NAO), dtype)
            # replicate_reference_bug: f64 slices truncate to f32 BEFORE
            # the norms (torch.zeros assignment, scf.py:61-114) — the
            # frames dtype above does exactly that
            frames[:, 0, ri:ri + pi, rj:rj + pj] = blk_s
            frames[:, 1, ri:ri + pi, rj:rj + pj] = blk_h
            both = _sa_compress_frames(
                frames.reshape(sel.size * 2, _HEAVY_NAO, _HEAVY_NAO))
            feats[sel] = both.reshape(sel.size, 2 * SA_DIM * SA_DIM)
    return feats


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

def pyscf_available() -> bool:
    try:
        import pyscf  # noqa: F401
        return True
    except ImportError:
        return False


# The pyscf backend computes exact 6-311+G(3df,2p) integrals; the native
# engine runs either the embedded published 6-311+G(3df,2p) data
# ('native6311', tagged -native since its precision differs from libcint)
# or the project-defined 'x2sv' stand-in (same AO structure, other
# exponents). Different tags are NOT numerically interchangeable.
BACKEND_BASIS = {"pyscf": "6-311+g(3df,2p)",
                 "native6311": "6-311+g(3df,2p)-native",
                 "native": "x2sv",
                 "zero": "zero"}


def check_basis_compatible(run_basis, data_basis, allow: bool = False,
                           context: str = "") -> None:
    """Raise ValueError (or warn with allow=True) when a checkpoint's
    featurization basis and the evaluation data's basis are both known and
    different. 'unknown'/None tags (caches written before provenance
    tagging) are not checked."""
    def known(b):
        return b not in (None, "", "unknown")

    if known(run_basis) and known(data_basis) and run_basis != data_basis:
        msg = (f"featurization basis mismatch{context}: the checkpoint "
               f"was trained on '{run_basis}' features but this data is "
               f"'{data_basis}' — the two bases (pyscf 6-311+G(3df,2p), "
               "scf.py:31, vs the native 'x2sv') are not numerically "
               "interchangeable and predictions would be silently wrong. "
               "Refeaturize with the matching backend, or override with "
               "allow_basis_mismatch / --allow-basis-mismatch.")
        if allow:
            warnings.warn(msg)
        else:
            raise ValueError(msg)


def basis_provenance(backend: str) -> str:
    """Basis tag for a (possibly 'auto') featurizer backend."""
    return BACKEND_BASIS[resolve_backend(backend)]


def resolve_backend(backend: str) -> str:
    """'auto' -> the backend that will actually run on THIS machine.
    Callers that persist features (data/dataset.py cache tags) must tag
    with the resolved name — the quantum backends use different bases
    and their features are not interchangeable. 'auto' prefers the real
    6-311+G(3df,2p) basis (pyscf when installed, else the native engine
    with the embedded Pople data); the 'x2sv' stand-in stays available
    as backend='native' for caches and checkpoints made with it."""
    if backend == "auto":
        return "pyscf" if pyscf_available() else "native6311"
    return backend


def _pyscf_matrices(mol: Molecule, basis: str = "6-311+g(3df,2p)"
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """S, H/nelec, ao_slices via PySCF (geom_scf_6, scf.py:27-48).

    No SCF is run — only one-electron integrals. Spin falls back 0 -> 1
    like the reference (scf.py:33-38).
    """
    from pyscf import gto

    m = gto.Mole()
    m.symmetry = False
    m.basis = basis
    m.atom = mol.geometry_string()
    m.unit = "Angstrom"
    try:
        m.spin = 0
        m.build()
    except Exception:
        m.spin = 1
        m.build()
    ovlp = m.intor("int1e_ovlp")
    hcore = m.intor("int1e_kin") + m.intor("int1e_nuc")
    ao_slices = m.aoslice_by_atom()[:, 2:]
    return ovlp, hcore / m.nelectron, ao_slices


def _native_matrices(mol: Molecule, basis_name: str = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """S, H/nelec, ao_slices from the C++ engine ('x2sv' without a
    name)."""
    from x2gnn_tpu_torch.data.integrals.basis import get_basis
    from x2gnn_tpu_torch.data.integrals.engine import one_electron_matrices
    basis = get_basis(basis_name) if basis_name else None
    return one_electron_matrices(mol.numbers, mol.positions, basis=basis)


def edge_features(
    mol: Molecule,
    edge_index: np.ndarray,
    backend: str = "auto",
    replicate_reference_bug: bool = False,
) -> np.ndarray:
    """(E, 338) integral features for one molecule.

    backend: 'pyscf' | 'native6311' (native engine, embedded published
    6-311+G(3df,2p) data) | 'native' (x2sv stand-in) | 'zero' | 'auto'
    (pyscf if installed, else native6311).
    """
    backend = resolve_backend(backend)
    if backend == "zero":
        return np.zeros((edge_index.shape[1], EDGE_FEAT_DIM),
                        dtype=np.float32)
    if backend == "pyscf":
        s, h, ao = _pyscf_matrices(mol)
    elif backend == "native6311":
        s, h, ao = _native_matrices(mol, basis_name="6-311+g(3df,2p)")
    elif backend == "native":
        s, h, ao = _native_matrices(mol)
    else:
        raise ValueError(f"unknown featurizer backend {backend!r}")
    assert ao.shape[0] == mol.num_atoms, (
        f"AO slice count {ao.shape[0]} != atom count {mol.num_atoms} "
        f"(molecule {mol.index})")  # sanity assert, qm9_allprop.py:15
    return sa_compress(s, h, ao, edge_index, replicate_reference_bug)
