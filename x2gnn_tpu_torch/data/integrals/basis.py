"""Gaussian basis sets for the native integral engine
(x2gnn_tpu/data/integrals/basis.py:25-186).

Any contracted Gaussian basis works. Two are built in: 'x2sv', an
even-tempered stand-in with the AO structure the 338-dim features expect
(H: 3s + 2p = 9 AOs; heavy atoms: 5s + 4p + 3d + 1f = 39 spherical AOs)
and exponents defined by the project, and the published
6-311+G(3df,2p) data that the reference requests from PySCF (scf.py:31),
read from the package's own copy `g94/6-311+g_3df_2p.g94`. Features of
the two are not interchangeable.
"""

from __future__ import annotations

from dataclasses import dataclass
import os
from typing import Dict, List

import numpy as np

from x2gnn_tpu_torch.data.molecule import ATOMIC_NUMBER

ANGSTROM_TO_BOHR = 1.8897259886


@dataclass
class Shell:
    """One contracted shell: angular momentum l, primitive exponents and
    contraction coefficients (same length).

    Coefficients follow the universal convention: they weight
    UNIT-NORMALIZED primitives (what Gaussian94/BSE files tabulate).
    The engines consume `weighted_coefficients`, which folds the
    alpha-dependent part of each primitive's norm in — without it, a
    multi-primitive contraction has the wrong radial shape (primitive
    norms vary ~1000x across a 6-311 core contraction) and the final
    diag(S)=1 AO rescale can only fix overall scale, not the relative
    primitive weights."""

    l: int
    exponents: np.ndarray
    coefficients: np.ndarray

    def __post_init__(self):
        self.exponents = np.atleast_1d(
            np.asarray(self.exponents, dtype=np.float64))
        self.coefficients = np.atleast_1d(
            np.asarray(self.coefficients, dtype=np.float64))
        assert self.exponents.shape == self.coefficients.shape

    @property
    def num_sph(self) -> int:
        return 2 * self.l + 1

    @property
    def weighted_coefficients(self) -> np.ndarray:
        """coefficients x the alpha-dependent primitive norm
        (2a/pi)^(3/4) (4a)^(l/2); alpha-independent factors are absorbed
        by the engines' final diag(S)=1 normalization."""
        a = self.exponents
        norm = (2.0 * a / np.pi) ** 0.75 * (4.0 * a) ** (self.l / 2.0)
        return self.coefficients * norm


@dataclass
class BasisSet:
    """Element symbol/Z -> list of shells."""

    shells: Dict[int, List[Shell]]

    def shells_for(self, z: int) -> List[Shell]:
        return self.shells[int(z)]

    def nao(self, z: int) -> int:
        return sum(s.num_sph for s in self.shells_for(z))


def _even_tempered(a0: float, beta: float, n: int) -> np.ndarray:
    """alpha_i = a0 * beta^(-i), i = 0..n-1 (descending from a0)."""
    return a0 * beta ** (-np.arange(n, dtype=np.float64))


def fallback_basis() -> BasisSet:
    """'x2sv': even-tempered basis with the 6-311+G(3df,2p) AO structure.

    H (9 AOs): 3 uncontracted s + 2 p shells.
    C/N/O/F (39 AOs): 5 s + 4 p + 3 d + 1 f shells, all uncontracted,
    exponent ranges scaled with nuclear charge so core/valence/diffuse
    coverage is physically sensible.
    """
    shells: Dict[int, List[Shell]] = {}
    # hydrogen: s exponents spanning tight->diffuse; p polarization pair
    shells[1] = (
        [Shell(0, [e], [1.0]) for e in _even_tempered(18.0, 4.2, 3)]
        + [Shell(1, [e], [1.0]) for e in _even_tempered(1.5, 4.0, 2)]
    )
    for z in (6, 7, 8, 9):
        zf = z / 6.0
        s_exp = _even_tempered(3200.0 * zf * zf, 6.2, 5)
        p_exp = _even_tempered(22.0 * zf * zf, 5.0, 4)
        d_exp = _even_tempered(2.4 * zf, 3.2, 3)
        f_exp = [0.9 * zf]
        shells[z] = (
            [Shell(0, [e], [1.0]) for e in s_exp]
            + [Shell(1, [e], [1.0]) for e in p_exp]
            + [Shell(2, [e], [1.0]) for e in d_exp]
            + [Shell(3, [e], [1.0]) for e in f_exp]
        )
    return BasisSet(shells)


_G94_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "g94")
_named_cache: Dict[str, "BasisSet"] = {}


def pople_6311g_3df_2p() -> BasisSet:
    """The exact 6-311+G(3df,2p) basis the reference requests from PySCF
    (scf.py:31), embedded as published tabulated data
    (g94/6-311+g_3df_2p.g94; Krishnan 1980 + Clark 1983 diffuse +
    Frisch 1984 polarization). H/C/N/O/F only — the reference's element
    map (utils.py:19)."""
    key = "6-311+g(3df,2p)"
    if key not in _named_cache:
        with open(os.path.join(_G94_DIR, "6-311+g_3df_2p.g94")) as f:
            _named_cache[key] = parse_gaussian94(f.read())
    return _named_cache[key]


def get_basis(name: str) -> BasisSet:
    """Named-basis registry: 'x2sv' (project even-tempered stand-in) or
    '6-311+g(3df,2p)' (embedded Pople data)."""
    if name == "x2sv":
        return fallback_basis()
    if name in ("6-311+g(3df,2p)", "6311"):
        return pople_6311g_3df_2p()
    raise ValueError(f"unknown basis {name!r} "
                     "(known: 'x2sv', '6-311+g(3df,2p)')")


def parse_gaussian94(text: str) -> BasisSet:
    """Parse a Gaussian94-format basis block (the format distributed by the
    Basis Set Exchange) into a BasisSet. Supports S/P/D/F and combined SP
    shells."""
    lmap = {"S": 0, "P": 1, "D": 2, "F": 3}
    shells: Dict[int, List[Shell]] = {}
    lines = [ln.split("!")[0].rstrip() for ln in text.splitlines()]
    i = 0
    current_z = None
    while i < len(lines):
        ln = lines[i].strip()
        i += 1
        if not ln or ln.startswith("****"):
            current_z = None
            continue
        tok = ln.split()
        if current_z is None:
            if tok[0].capitalize() in ATOMIC_NUMBER:
                current_z = ATOMIC_NUMBER[tok[0].capitalize()]
                shells.setdefault(current_z, [])
            continue
        # shell header: e.g. "S   6   1.00" or "SP  3   1.00" — the third
        # token is the Gaussian94 scale factor f (exponents scale by f^2)
        kind = tok[0].upper()
        nprim = int(tok[1])
        scale2 = float(tok[2]) ** 2 if len(tok) > 2 else 1.0
        prims = []
        for _ in range(nprim):
            row = lines[i].replace("D", "E").replace("d", "E").split()
            i += 1
            prims.append([float(v) for v in row])
        prims = np.asarray(prims)
        exps = prims[:, 0] * scale2
        if kind == "SP":
            shells[current_z].append(Shell(0, exps, prims[:, 1]))
            shells[current_z].append(Shell(1, exps, prims[:, 2]))
        else:
            shells[current_z].append(Shell(lmap[kind], exps, prims[:, 1]))
    # group shells by angular momentum (stable): the feature compression
    # (featurize.py _GROUPS) and PySCF's formatted bases both lay AOs out
    # l-grouped (5s,4p,3d,1f) — BSE files interleave SP shells
    for z in shells:
        shells[z] = sorted(shells[z], key=lambda s: s.l)
    return BasisSet(shells)
