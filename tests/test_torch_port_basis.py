"""The port's basis functions (x2gnn_tpu_torch.ops.basis) against the jnp
functions of the JAX package, in float32."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from x2gnn_tpu.ops import basis as jbasis
from x2gnn_tpu.nn.layers import RadialBasisLayer as FlaxRadialBasisLayer
from x2gnn_tpu_torch.nn.layers import RadialBasisLayer
from x2gnn_tpu_torch.ops import basis

TOL = dict(rtol=1e-6, atol=1e-6)


def _distances(seed=0, n=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.7, 4.99, size=n).astype(np.float32)


def test_poly_envelope():
    d = _distances()
    ref = np.asarray(jbasis.poly_envelope(jnp.asarray(d), 5.0, 5))
    got = basis.poly_envelope(torch.from_numpy(d), 5.0, 5).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_bessel_zeros_and_norms_identical():
    zeros, norms = basis.bessel_zeros_and_norms(7, 6)
    rz, rn = jbasis.bessel_zeros_and_norms(7, 6)
    np.testing.assert_array_equal(zeros, rz)
    np.testing.assert_array_equal(norms, rn)


def test_spherical_bessel():
    x = _distances(1) * 3.0
    ref = np.asarray(jbasis.spherical_bessel(jnp.asarray(x), 7))
    got = basis.spherical_bessel(torch.from_numpy(x), 7).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_legendre_cos_harmonics():
    rng = np.random.default_rng(2)
    theta = rng.uniform(0.0, np.pi, size=(16, 9)).astype(np.float32)
    ref = np.asarray(jbasis.legendre_cos_harmonics(jnp.asarray(theta), 7))
    got = basis.legendre_cos_harmonics(torch.from_numpy(theta), 7).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_sbf_radial_part(masked):
    d = _distances(3)
    mask = np.arange(d.shape[0]) % 5 != 0 if masked else None
    ref = np.asarray(jbasis.sbf_radial_part(
        jnp.asarray(d), 7, 6, 5.0, 5,
        None if mask is None else jnp.asarray(mask)))
    got = basis.sbf_radial_part(
        torch.from_numpy(d), 7, 6, 5.0, 5,
        None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == (d.shape[0], 7, 6) and got.dtype == np.float32
    # the upward Bessel recurrence amplifies 1-ulp differences between
    # XLA's and PyTorch's float32 sin/cos (up to ~1e-5 relative at single
    # elements near small x): 1e-6 is held relative to the basis' scale
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


def test_radial_basis_layer():
    import jax
    d = _distances(4).reshape(8, 8)
    flax_layer = FlaxRadialBasisLayer(6, 5.0)
    params = flax_layer.init(jax.random.PRNGKey(0), jnp.asarray(d))
    ref = np.asarray(flax_layer.apply(params, jnp.asarray(d)))
    got = RadialBasisLayer(6, 5.0)(torch.from_numpy(d)).detach().numpy()
    np.testing.assert_allclose(got, ref, **TOL)
