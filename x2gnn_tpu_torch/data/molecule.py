"""Target helpers of x2gnn_tpu/data/molecule.py (:33, :180-220), numpy
only: the extensive QM9 targets, the MAE report calibration, and the
least-squares per-element reference energies."""

from __future__ import annotations

from typing import Sequence

import numpy as np

EV_TO_KCALMOL = 1.0 / 0.04336414        # train_ema.py:36 (report calibration)
# Targets stored in Hartree in QM9 and trained in eV (train_ema.py:34).
ENERGY_TARGETS_EV = frozenset({2, 3, 4, 6, 7, 8, 9, 10})
# Extensive targets use the atom-wise readout (train_ema.py:41).
EXTENSIVE_TARGETS = frozenset({6, 7, 8, 9, 10, 11})


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
