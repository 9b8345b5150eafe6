"""Molecules and their labels (x2gnn_tpu/data/molecule.py), numpy only:
the `Molecule` container, the concatenated-xyz readers (:51-157), the
QM9 property tables, the atomization targets, the MAE report calibration
and the least-squares per-element reference energies."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

# Supported elements (reference utils.py:19 limits to H/C/N/O/F organics).
ATOMIC_NUMBER = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}
ELEMENT_SYMBOL = {v: k for k, v in ATOMIC_NUMBER.items()}

# QM9 property index map (reference train_ema.py:9).
QM9_PROPERTY_NAMES = {
    0: "dipole", 1: "polarizability", 2: "HOMO", 3: "LUMO", 4: "GAP",
    5: "spatial_extent", 6: "zpve", 7: "U0", 8: "U", 9: "H", 10: "G",
    11: "Cv",
}

HARTREE_TO_EV = 27.211385056            # train_ema.py:35
EV_TO_KCALMOL = 1.0 / 0.04336414        # train_ema.py:36 (report calibration)
# Targets stored in Hartree in QM9 and trained in eV (train_ema.py:34).
ENERGY_TARGETS_EV = frozenset({2, 3, 4, 6, 7, 8, 9, 10})
# Extensive targets use the atom-wise readout (train_ema.py:41).
EXTENSIVE_TARGETS = frozenset({6, 7, 8, 9, 10, 11})

# Per-atom reference energies (Hartree) for atomization-energy targets,
# indexed [property, atomic_number] (reference train_ema.py:10-20).
ATOM_REF = np.zeros((12, 10), dtype=np.float64)
ATOM_REF[7] = [np.nan, -0.500273, np.nan, np.nan, np.nan, np.nan,
               -37.846772, -54.583861, -75.064579, -99.718730]
ATOM_REF[8] = [np.nan, -0.498857, np.nan, np.nan, np.nan, np.nan,
               -37.845355, -54.582445, -75.063163, -99.717314]
ATOM_REF[9] = [np.nan, -0.497912, np.nan, np.nan, np.nan, np.nan,
               -37.844411, -54.581501, -75.062219, -99.716370]
ATOM_REF[10] = [np.nan, -0.510927, np.nan, np.nan, np.nan, np.nan,
                -37.861317, -54.598897, -75.079532, -99.733544]
ATOM_REF[11] = [np.nan, 2.981, np.nan, np.nan, np.nan, np.nan,
                2.981, 2.981, 2.981, 2.981]


@dataclass
class Molecule:
    """One molecule: atomic numbers, positions (Angstrom) and labels."""

    numbers: np.ndarray                 # (N,) int32 atomic numbers
    positions: np.ndarray               # (N, 3) float64 Angstrom
    labels: np.ndarray                  # (P,) float64 property values
    index: int = 0

    def __post_init__(self):
        self.numbers = np.asarray(self.numbers, dtype=np.int32)
        self.positions = np.asarray(self.positions, dtype=np.float64)
        self.labels = np.atleast_1d(np.asarray(self.labels, dtype=np.float64))

    @property
    def num_atoms(self) -> int:
        return int(self.numbers.shape[0])

    def geometry_string(self) -> str:
        """PySCF-style `El x y z` block, one atom per line."""
        return "\n".join(
            f"{ELEMENT_SYMBOL[int(z)]} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f}"
            for z, p in zip(self.numbers, self.positions)
        )


def _parse_concat_xyz(filename: str, n_props: Optional[int]) -> List[Molecule]:
    """Parse a concatenated xyz stream: a line holding one int starts a
    molecule with that many atoms; the lines before its atom block whose
    tokens are floats are its labels (several per line, tab- or
    space-separated; Mathematica's `*^` exponent read as `E`); then one
    `element x y z` line per atom. `n_props`, if given, is the label count
    every molecule must have."""
    mols: List[Molecule] = []
    with open(filename, "rt") as f:
        lines = f.readlines()
    i = 0
    idx = 0
    n_lines = len(lines)
    while i < n_lines:
        tok = lines[i].split()
        if not tok:
            i += 1
            continue
        n_atoms = int(tok[0])
        i += 1
        labels: List[float] = []
        while i < n_lines:
            tok = lines[i].split()
            if not tok:
                i += 1
                continue
            if tok[0] in ATOMIC_NUMBER:
                break
            labels.extend(float(t.replace("*^", "E")) for t in tok)
            i += 1
        numbers = np.empty(n_atoms, dtype=np.int32)
        positions = np.empty((n_atoms, 3), dtype=np.float64)
        for a in range(n_atoms):
            if i >= n_lines:
                raise ValueError(
                    f"molecule {idx}: file truncated at atom {a}/{n_atoms} "
                    f"(line {i})")
            tok = lines[i].split()
            if not tok or tok[0] not in ATOMIC_NUMBER:
                raise ValueError(
                    f"molecule {idx}, line {i}: unknown element "
                    f"{tok[0] if tok else '<empty>'!r} (supported: "
                    f"{sorted(ATOMIC_NUMBER)})")
            numbers[a] = ATOMIC_NUMBER[tok[0]]
            positions[a] = [float(t.replace("*^", "E")) for t in tok[1:4]]
            i += 1
        if n_props is not None and len(labels) != n_props:
            raise ValueError(
                f"molecule {idx}: expected {n_props} properties, got "
                f"{len(labels)}")
        mols.append(Molecule(numbers, positions, np.array(labels), idx))
        idx += 1
    return mols


def read_xyz(filename: str) -> List[Molecule]:
    """Every molecule of a concatenated xyz file, with however many labels
    each carries (reference utils.py:17-63, without its dropped first
    molecule)."""
    return _parse_concat_xyz(filename, n_props=None)


def read_xyz_allprop(filename: str) -> List[Molecule]:
    """A QM9 xyz file with the 12 properties per molecule (mu, alpha,
    HOMO, LUMO, gap, r2, zpve, U0, U, H, G, Cv) on the lines after each
    atom count; a molecule with another count raises."""
    return _parse_concat_xyz(filename, n_props=12)


def write_xyz(filename: str, molecules: Sequence[Molecule]) -> None:
    """Write `molecules` as one concatenated xyz file that `read_xyz`
    reads back bitwise: per molecule its atom count, its labels on one
    tab-joined line (none if it has none), then `element x y z` lines,
    every float in Python's shortest round-trip form."""
    with open(filename, "wt") as f:
        for m in molecules:
            f.write(f"{m.num_atoms}\n")
            if m.labels.size:
                f.write("\t".join(repr(float(v)) for v in m.labels) + "\n")
            for z, p in zip(m.numbers, m.positions):
                f.write(f"{ELEMENT_SYMBOL[int(z)]} " + " ".join(
                    repr(float(c)) for c in p) + "\n")


def atomization_target(
    numbers_per_mol: Sequence[np.ndarray],
    labels: np.ndarray,
    target: int,
) -> np.ndarray:
    """Training targets from raw QM9 labels (num_mols, 12): subtract the
    sum of the atoms' reference energies where the property has them
    (train_ema.py:30-32) and convert energy targets Hartree -> eV
    (train_ema.py:34-35). Returns (num_mols,) float64."""
    y = np.asarray(labels, dtype=np.float64)[:, target].copy()
    refs = ATOM_REF[target]
    if np.any(refs != 0):   # rows without atom refs are all-zero: skip
        for m, numbers in enumerate(numbers_per_mol):
            y[m] -= refs[numbers].sum()
    if target in ENERGY_TARGETS_EV:
        y *= HARTREE_TO_EV
    return y


def fit_linear_atomref(
    numbers_per_mol: Sequence[np.ndarray],
    y: np.ndarray,
    train_idx: np.ndarray,
):
    """Least-squares per-element reference energies (+ intercept), fitted
    on `train_idx` only. Returns (predictions for ALL molecules, {Z: coef}
    dict incl. 'intercept')."""
    zs = sorted({int(z) for nums in numbers_per_mol for z in nums})
    X = np.zeros((len(numbers_per_mol), len(zs) + 1))
    for m, nums in enumerate(numbers_per_mol):
        for j, z in enumerate(zs):
            X[m, j] = (np.asarray(nums) == z).sum()
        X[m, -1] = 1.0
    y = np.asarray(y, dtype=np.float64)
    coef, *_ = np.linalg.lstsq(X[np.asarray(train_idx)],
                               y[np.asarray(train_idx)], rcond=None)
    table = {int(z): float(c) for z, c in zip(zs, coef[:-1])}
    table["intercept"] = float(coef[-1])
    return X @ coef, table


def report_calibration(target: int) -> float:
    """MAE report scale: eV -> kcal/mol for energy targets, else 1.0
    (train_ema.py:34-38, applied at eval in trainer.py:57)."""
    return EV_TO_KCALMOL if target in ENERGY_TARGETS_EV else 1.0
