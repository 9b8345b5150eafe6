"""McMurchie-Davidson one-electron integrals in numpy
(x2gnn_tpu/data/integrals/md.py:29-329): the plain version of the C++
engine (csrc/integrals.cpp), which the tests hold it against. Never on
the main path: `engine.one_electron_matrices` runs the C++ engine.

Overlap S, kinetic T and nuclear attraction V over contracted real
spherical Gaussian AOs. Positions in Bohr internally; spherical AOs built
from Cartesian monomial Gaussians through real solid-harmonic
coefficient tables; every AO normalized to unit self-overlap at the end
(diag(S) == 1).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.special import gammainc, gamma

from x2gnn_tpu_torch.data.integrals.basis import (
    ANGSTROM_TO_BOHR, BasisSet, fallback_basis)

# ---------------------------------------------------------------------------
# Cartesian monomials and real solid-harmonic coefficients
# ---------------------------------------------------------------------------

def cart_monomials(l: int) -> List[Tuple[int, int, int]]:
    """(i, j, k) exponent triples with i+j+k == l, lexicographic."""
    out = []
    for i in range(l, -1, -1):
        for j in range(l - i, -1, -1):
            out.append((i, j, l - i - j))
    return out


def solid_harmonic_coeffs(l: int) -> np.ndarray:
    """(2l+1, n_cart) coefficients of real solid harmonics in the cartesian
    monomial basis (rows ordered m = -l..l). Overall scale is arbitrary —
    AOs are post-normalized — but relative coefficients define the
    harmonics. Each row satisfies Laplace's equation (tested)."""
    mons = cart_monomials(l)
    idx = {m: i for i, m in enumerate(mons)}
    C = np.zeros((2 * l + 1, len(mons)))

    def put(row, mono, val):
        C[row, idx[mono]] = val

    if l == 0:
        put(0, (0, 0, 0), 1.0)
    elif l == 1:
        put(0, (0, 1, 0), 1.0)   # m=-1: y
        put(1, (0, 0, 1), 1.0)   # m= 0: z
        put(2, (1, 0, 0), 1.0)   # m=+1: x
    elif l == 2:
        put(0, (1, 1, 0), 1.0)                       # xy
        put(1, (0, 1, 1), 1.0)                       # yz
        put(2, (2, 0, 0), -0.5)                      # (2z^2-x^2-y^2)/2
        put(2, (0, 2, 0), -0.5)
        put(2, (0, 0, 2), 1.0)
        put(3, (1, 0, 1), 1.0)                       # xz
        put(4, (2, 0, 0), 0.5)                       # (x^2-y^2)/2 scale-free
        put(4, (0, 2, 0), -0.5)
    elif l == 3:
        put(0, (2, 1, 0), 3.0)                       # y(3x^2-y^2)
        put(0, (0, 3, 0), -1.0)
        put(1, (1, 1, 1), 1.0)                       # xyz
        put(2, (2, 1, 0), -1.0)                      # y(4z^2-x^2-y^2)
        put(2, (0, 3, 0), -1.0)
        put(2, (0, 1, 2), 4.0)
        put(3, (2, 0, 1), -3.0)                      # z(2z^2-3x^2-3y^2)
        put(3, (0, 2, 1), -3.0)
        put(3, (0, 0, 3), 2.0)
        put(4, (2, 0, 1), 1.0)                       # z(x^2-y^2)
        put(4, (0, 2, 1), -1.0)
        put(5, (3, 0, 0), -1.0)                      # x(4z^2-x^2-y^2)
        put(5, (1, 2, 0), -1.0)
        put(5, (1, 0, 2), 4.0)
        put(6, (3, 0, 0), 1.0)                       # x(x^2-3y^2)
        put(6, (1, 2, 0), -3.0)
    else:
        raise NotImplementedError(f"l={l} > 3 not supported")
    return C


# ---------------------------------------------------------------------------
# Hermite expansion coefficients (1D)
# ---------------------------------------------------------------------------

def hermite_E(i_max: int, j_max: int, a: float, b: float, AB: float
              ) -> np.ndarray:
    """E[t, i, j] Hermite expansion coefficients for the 1D Gaussian
    product x_A^i x_B^j exp(-a x_A^2) exp(-b x_B^2)."""
    p = a + b
    q = a * b / p
    XPA = -b * AB / p     # P - A where P = (aA + bB)/p; AB = A - B
    XPB = a * AB / p      # P - B
    tmax = i_max + j_max
    E = np.zeros((tmax + 1, i_max + 1, j_max + 1))
    E[0, 0, 0] = np.exp(-q * AB * AB)
    for i in range(1, i_max + 1):
        for t in range(0, i + 1):
            val = XPA * E[t, i - 1, 0]
            if t > 0:
                val += E[t - 1, i - 1, 0] / (2 * p)
            if t + 1 <= tmax:
                val += (t + 1) * E[t + 1, i - 1, 0]
            E[t, i, 0] = val
    for j in range(1, j_max + 1):
        for i in range(0, i_max + 1):
            for t in range(0, i + j + 1):
                val = XPB * E[t, i, j - 1]
                if t > 0:
                    val += E[t - 1, i, j - 1] / (2 * p)
                if t + 1 <= tmax:
                    val += (t + 1) * E[t + 1, i, j - 1]
                E[t, i, j] = val
    return E


# ---------------------------------------------------------------------------
# Boys function and Hermite Coulomb integrals
# ---------------------------------------------------------------------------

def boys(m_max: int, T: float) -> np.ndarray:
    """F_m(T) for m = 0..m_max."""
    ms = np.arange(m_max + 1)
    if T < 1e-12:
        return 1.0 / (2 * ms + 1)
    return (gammainc(ms + 0.5, T) * gamma(ms + 0.5)
            / (2.0 * T ** (ms + 0.5)))


def hermite_coulomb(t_max: int, u_max: int, v_max: int, p: float,
                    PC: np.ndarray) -> np.ndarray:
    """R[t, u, v] = R^0_{tuv}(p, PC) Hermite Coulomb integrals."""
    n_max = t_max + u_max + v_max
    T = p * float(PC @ PC)
    F = boys(n_max, T)
    # R^n_{000}
    Rn = np.array([(-2.0 * p) ** n * F[n] for n in range(n_max + 1)])
    # dp arrays indexed [n, t, u, v], built by recursion on t, u, v
    R = np.zeros((n_max + 1, t_max + 1, u_max + 1, v_max + 1))
    R[:, 0, 0, 0] = Rn
    for t in range(1, t_max + 1):
        for n in range(0, n_max - t + 1):
            val = PC[0] * R[n + 1, t - 1, 0, 0]
            if t > 1:
                val += (t - 1) * R[n + 1, t - 2, 0, 0]
            R[n, t, 0, 0] = val
    for u in range(1, u_max + 1):
        for t in range(0, t_max + 1):
            for n in range(0, n_max - t - u + 1):
                val = PC[1] * R[n + 1, t, u - 1, 0]
                if u > 1:
                    val += (u - 1) * R[n + 1, t, u - 2, 0]
                R[n, t, u, 0] = val
    for v in range(1, v_max + 1):
        for u in range(0, u_max + 1):
            for t in range(0, t_max + 1):
                for n in range(0, n_max - t - u - v + 1):
                    val = PC[2] * R[n + 1, t, u, v - 1]
                    if v > 1:
                        val += (v - 1) * R[n + 1, t, u, v - 2]
                    R[n, t, u, v] = val
    return R[0]


# ---------------------------------------------------------------------------
# Primitive-pair Cartesian integrals
# ---------------------------------------------------------------------------

def _pair_sab(la: int, lb: int, a: float, b: float, A: np.ndarray,
              B: np.ndarray):
    """Per-dimension Hermite tables for a primitive pair. Returns (Ex, Ey,
    Ez) with room for the +2 angular momentum the kinetic integral needs."""
    Ex = hermite_E(la, lb + 2, a, b, A[0] - B[0])
    Ey = hermite_E(la, lb + 2, a, b, A[1] - B[1])
    Ez = hermite_E(la, lb + 2, a, b, A[2] - B[2])
    return Ex, Ey, Ez


def primitive_ST(la: int, lb: int, a: float, b: float, A: np.ndarray,
                 B: np.ndarray):
    """Cartesian overlap and kinetic blocks for one primitive pair:
    returns (S_cart, T_cart) of shape (ncart_a, ncart_b)."""
    p = a + b
    pref = (np.pi / p) ** 1.5
    Ex, Ey, Ez = _pair_sab(la, lb, a, b, A, B)
    mons_a = cart_monomials(la)
    mons_b = cart_monomials(lb)
    S = np.zeros((len(mons_a), len(mons_b)))
    T = np.zeros_like(S)

    def s1(E, i, j):
        return E[0, i, j] if j >= 0 else 0.0

    for ai, (ix, iy, iz) in enumerate(mons_a):
        for bi, (jx, jy, jz) in enumerate(mons_b):
            sx, sy, sz = s1(Ex, ix, jx), s1(Ey, iy, jy), s1(Ez, iz, jz)
            S[ai, bi] = sx * sy * sz * pref

            def t1(E, i, j):
                val = -2.0 * b * b * s1(E, i, j + 2)
                val += b * (2 * j + 1) * s1(E, i, j)
                if j >= 2:
                    val -= 0.5 * j * (j - 1) * s1(E, i, j - 2)
                return val

            T[ai, bi] = (t1(Ex, ix, jx) * sy * sz
                         + sx * t1(Ey, iy, jy) * sz
                         + sx * sy * t1(Ez, iz, jz)) * pref
    return S, T


def primitive_V(la: int, lb: int, a: float, b: float, A: np.ndarray,
                B: np.ndarray, charges: Sequence[float],
                centers: np.ndarray) -> np.ndarray:
    """Cartesian nuclear-attraction block summed over nuclei:
    V = -sum_C Z_C <a| 1/r_C |b>."""
    p = a + b
    P = (a * A + b * B) / p
    Ex = hermite_E(la, lb, a, b, A[0] - B[0])
    Ey = hermite_E(la, lb, a, b, A[1] - B[1])
    Ez = hermite_E(la, lb, a, b, A[2] - B[2])
    mons_a = cart_monomials(la)
    mons_b = cart_monomials(lb)
    V = np.zeros((len(mons_a), len(mons_b)))
    for Z, C in zip(charges, centers):
        R = hermite_coulomb(la + lb, la + lb, la + lb, p, P - C)
        for ai, (ix, iy, iz) in enumerate(mons_a):
            for bi, (jx, jy, jz) in enumerate(mons_b):
                acc = 0.0
                for t in range(ix + jx + 1):
                    Et = Ex[t, ix, jx]
                    if Et == 0.0:
                        continue
                    for u in range(iy + jy + 1):
                        Eu = Ey[u, iy, jy]
                        if Eu == 0.0:
                            continue
                        for v in range(iz + jz + 1):
                            Ev = Ez[v, iz, jz]
                            if Ev == 0.0:
                                continue
                            acc += Et * Eu * Ev * R[t, u, v]
                V[ai, bi] -= Z * acc
        # (R depends on C through P - C; loop recomputes per nucleus)
    V *= 2.0 * np.pi / p
    return V


# ---------------------------------------------------------------------------
# Full-molecule assembly
# ---------------------------------------------------------------------------

def _shell_list(numbers: np.ndarray, positions_bohr: np.ndarray,
                basis: BasisSet):
    """Flatten (atom, shell) with AO offsets. Returns list of
    (atom_idx, center, Shell, sph_offset) and per-atom AO slices."""
    shells = []
    offset = 0
    ao_slices = np.zeros((len(numbers), 2), dtype=np.int64)
    for ia, z in enumerate(numbers):
        ao_slices[ia, 0] = offset
        for sh in basis.shells_for(int(z)):
            shells.append((ia, positions_bohr[ia], sh, offset))
            offset += sh.num_sph
        ao_slices[ia, 1] = offset
    return shells, ao_slices, offset


def one_electron_matrices_numpy(
    numbers: np.ndarray,
    positions_angstrom: np.ndarray,
    basis: BasisSet = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(S, Hcore/nelec, ao_slices) for a molecule — the native analogue of
    geom_scf_6 (scf.py:27-48): Hcore = T + V, divided by electron count;
    AOs normalized so diag(S) = 1."""
    basis = basis or fallback_basis()
    numbers = np.asarray(numbers, dtype=np.int64)
    pos = np.asarray(positions_angstrom, dtype=np.float64) * ANGSTROM_TO_BOHR
    shells, ao_slices, nao = _shell_list(numbers, pos, basis)
    S = np.zeros((nao, nao))
    T = np.zeros((nao, nao))
    V = np.zeros((nao, nao))
    charges = numbers.astype(np.float64)

    sph = {l: solid_harmonic_coeffs(l) for l in range(4)}
    for ish, (ia, A, sa, oa) in enumerate(shells):
        Ca = sph[sa.l]
        for jsh in range(ish + 1):
            ib, B, sb, ob = shells[jsh]
            Cb = sph[sb.l]
            na, nb = len(cart_monomials(sa.l)), len(cart_monomials(sb.l))
            Sc = np.zeros((na, nb))
            Tc = np.zeros((na, nb))
            Vc = np.zeros((na, nb))
            for ea, ca in zip(sa.exponents, sa.weighted_coefficients):
                for eb, cb in zip(sb.exponents, sb.weighted_coefficients):
                    w = ca * cb
                    s_blk, t_blk = primitive_ST(sa.l, sb.l, ea, eb, A, B)
                    Sc += w * s_blk
                    Tc += w * t_blk
                    Vc += w * primitive_V(sa.l, sb.l, ea, eb, A, B,
                                          charges, pos)
            # cartesian -> spherical on both sides
            Ss = Ca @ Sc @ Cb.T
            Ts = Ca @ Tc @ Cb.T
            Vs = Ca @ Vc @ Cb.T
            S[oa:oa + sa.num_sph, ob:ob + sb.num_sph] = Ss
            T[oa:oa + sa.num_sph, ob:ob + sb.num_sph] = Ts
            V[oa:oa + sa.num_sph, ob:ob + sb.num_sph] = Vs
            if ish != jsh:
                S[ob:ob + sb.num_sph, oa:oa + sa.num_sph] = Ss.T
                T[ob:ob + sb.num_sph, oa:oa + sa.num_sph] = Ts.T
                V[ob:ob + sb.num_sph, oa:oa + sa.num_sph] = Vs.T

    # normalize every AO to unit self-overlap
    norm = 1.0 / np.sqrt(np.diag(S))
    S = S * norm[:, None] * norm[None, :]
    T = T * norm[:, None] * norm[None, :]
    V = V * norm[:, None] * norm[None, :]

    hcore = T + V
    nelec = int(numbers.sum())
    return S, hcore / max(nelec, 1), ao_slices
