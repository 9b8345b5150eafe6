"""Closed-form basis math: envelope, spherical Bessel functions, Legendre
harmonics, the radial factor of the 2D basis and the per-triplet 2D basis
of the flat layouts (x2gnn_tpu/ops/basis.py:28-198).

Only the Bessel zeros are computed on the host (scipy); the rest are plain
tensor recurrences.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def poly_envelope(d: torch.Tensor, cutoff: float = 5.0,
                  exponent: int = 5) -> torch.Tensor:
    """DimeNet-style smooth cutoff u(d), with x = d/cutoff, p = exponent+1:
    u = 1/x + a x^(p-1) + b x^p + c x^(p+1),
    a = -(p+1)(p+2)/2, b = p(p+2), c = -p(p+1)/2.
    No d > cutoff guard: padded entries must be masked by the caller."""
    p = exponent + 1
    a = -(p + 1) * (p + 2) / 2.0
    b = float(p * (p + 2))
    c = -p * (p + 1) / 2.0
    x = d * (1.0 / cutoff)
    x_p_minus1 = x ** (p - 1)
    return 1.0 / x + x_p_minus1 * (a + x * (b + x * c))


def radial_frequencies_init(rbf_dim: int) -> np.ndarray:
    """n*pi, n = 1..rbf_dim: the initial radial-basis frequencies."""
    return np.pi * np.arange(1, rbf_dim + 1, dtype=np.float32)


def _jn_numpy(r: np.ndarray, n: int) -> np.ndarray:
    from scipy import special as sp
    return np.sqrt(np.pi / (2 * r)) * sp.jv(n + 0.5, r)


@functools.lru_cache(maxsize=8)
def bessel_zeros_and_norms(
    num_spherical: int, num_radial: int
) -> Tuple[np.ndarray, np.ndarray]:
    """First `num_radial` positive zeros z_{l,n} of j_l for l <
    num_spherical, plus normalizers N_{l,n} = 1/sqrt(0.5 j_{l+1}(z_{l,n})^2).
    Host-side scipy root finding, cached per (L, K)."""
    from scipy.optimize import brentq

    n, k = num_spherical, num_radial
    zeros = np.zeros((n, k), dtype=np.float64)
    zeros[0] = np.arange(1, k + 1) * np.pi
    points = np.arange(1, k + n) * np.pi
    racines = np.zeros(k + n - 1, dtype=np.float64)
    for i in range(1, n):
        for j in range(k + n - 1 - i):
            racines[j] = brentq(_jn_numpy, points[j], points[j + 1], (i,))
        points = racines.copy()
        zeros[i][:k] = racines[:k]

    norms = 1.0 / np.sqrt(
        0.5 * _jn_numpy(zeros, np.arange(n)[:, None] + 1) ** 2
    )
    return zeros, norms


def spherical_bessel(x: torch.Tensor, num_spherical: int) -> torch.Tensor:
    """j_l(x) for l = 0..num_spherical-1 on the last axis, by the upward
    recurrence j_{l+1} = (2l+1)/x j_l - j_{l-1}. x must stay away from 0."""
    inv_x = 1.0 / x
    sin_x = torch.sin(x)
    cos_x = torch.cos(x)
    j = [sin_x * inv_x]
    if num_spherical > 1:
        j.append((sin_x * inv_x - cos_x) * inv_x)
    for l in range(2, num_spherical):
        j.append((2 * l - 1) * inv_x * j[l - 1] - j[l - 2])
    return torch.stack(j, dim=-1)


def legendre_cos_harmonics(theta: torch.Tensor,
                           num_spherical: int) -> torch.Tensor:
    """Y_l^0(theta) = sqrt((2l+1)/(4 pi)) P_l(cos theta), l = 0..L-1 on the
    last axis, with P_l by the Legendre recurrence."""
    z = torch.cos(theta)
    p = [torch.ones_like(z)]
    if num_spherical > 1:
        p.append(z)
    for l in range(2, num_spherical):
        p.append(((2 * l - 1) * z * p[l - 1] - (l - 1) * p[l - 2]) / l)
    pref = np.sqrt((2 * np.arange(num_spherical) + 1) / (4 * np.pi))
    return torch.stack(p, dim=-1) * torch.as_tensor(
        pref, dtype=z.dtype, device=z.device)


def sbf_radial_part(
    distances: torch.Tensor,
    num_spherical: int,
    num_radial: int,
    cutoff: float = 5.0,
    envelope_exponent: int = 5,
    edge_mask: torch.Tensor = None,
) -> torch.Tensor:
    """Envelope-damped radial factor of the 2D basis, per edge:
    rbf_env[e, l, n] = env(d_e) N_{l,n} j_l(z_{l,n} d_e / cutoff), (E, L, K).
    The blocked attention contracts it with the angular factor inside the
    kernel instead of materializing the (T, L*K) triplet basis."""
    zeros, norms = bessel_zeros_and_norms(num_spherical, num_radial)
    zeros_t = torch.as_tensor(zeros, dtype=distances.dtype,
                              device=distances.device)
    norms_t = torch.as_tensor(norms, dtype=distances.dtype,
                              device=distances.device)
    d_scaled = distances * (1.0 / cutoff)
    x = d_scaled[:, None, None] * zeros_t                   # (E, L, K)
    jl = [spherical_bessel(x[:, l, :], l + 1)[..., l]
          for l in range(num_spherical)]
    rbf = torch.stack(jl, dim=1) * norms_t
    env = poly_envelope(distances, cutoff, envelope_exponent)[:, None, None]
    rbf_env = rbf * env
    if edge_mask is not None:
        rbf_env = torch.where(edge_mask[:, None, None], rbf_env, 0.0)
    return rbf_env


def sbf_2d(distances: torch.Tensor, theta: torch.Tensor,
           src_edge_ids: torch.Tensor, num_spherical: int, num_radial: int,
           cutoff: float = 5.0, envelope_exponent: int = 5,
           edge_mask: torch.Tensor = None) -> torch.Tensor:
    """Per-triplet spherical-Bessel x Legendre-harmonic features (T, L*K)
    (x2gnn_tpu/ops/basis.py:170-198): out[t, l*K + n] = rbf_env[src_t, l,
    n] * Y_l(theta_t), rbf_env as `sbf_radial_part` of the per-edge
    `distances` (E,), `src_edge_ids` the triplets' j->k edges. Pad edges
    should come clamped to d ~ 1 and masked by `edge_mask`."""
    rbf_env = sbf_radial_part(distances, num_spherical, num_radial, cutoff,
                              envelope_exponent, edge_mask)
    rbf_env = rbf_env.reshape(rbf_env.shape[0], num_spherical * num_radial)
    cbf = legendre_cos_harmonics(theta, num_spherical)      # (T, L)
    cbf = torch.repeat_interleave(cbf, num_radial, dim=-1)  # (T, L*K)
    return rbf_env[src_edge_ids] * cbf
