"""Target helpers of x2gnn_tpu/data/molecule.py (:20-45, :159-220), numpy
only: the QM9 property tables, the atomization targets, the MAE report
calibration, and the least-squares per-element reference energies."""

from __future__ import annotations

from typing import Sequence

import numpy as np

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
