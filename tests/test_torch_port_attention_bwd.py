"""The port's plain attention backward (`blocked_attention_bwd_plain`, the
plain version of csrc/blocked_attn_bwd.cu) against the reference Pallas
backward kernels run in interpret mode, and against torch autograd through
the plain forward. The CUDA kernel runs only on the card, where
chip_smoke.py holds it against this plain version."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_blocked_attn import HC, H, K, L, _problem
from x2gnn_tpu.ops.pallas.blocked_attn import (
    expand_block_diagonal, pallas_blocked_attention)
from x2gnn_tpu_torch.ops.blocked_attn import (
    blocked_attention, blocked_attention_bwd_plain, blocked_attention_plain)

ARGS = ("q", "k", "v", "e_atom", "rbf", "w_sbf", "bias", "z", "a_ids",
        "b_ids")
DIFF = ("q", "k", "v", "e_atom", "w_sbf", "bias")   # the six gradients
# the tolerance of tests/test_pallas.py for this formulation
TOL = dict(rtol=3e-4, atol=3e-5)


def _g(p, seed):
    shape = p["q"].shape
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _reference_grads(p, g, i_chunk=None):
    """jax.vjp of the interpret-mode Pallas kernel in q, k, v, e_atom,
    w_sbf (through expand_block_diagonal) and bias."""
    j = {name: jnp.asarray(a) for name, a in p.items()}

    def f(q, k, v, e, w, b):
        return pallas_blocked_attention(
            q, k, v, e, j["rbf"], expand_block_diagonal(w, L, K, HC),
            b.reshape(1, HC), j["z"], j["a_ids"], j["b_ids"], heads=H,
            num_radial=K, interpret=True, i_chunk=i_chunk)

    _, vjp = jax.vjp(f, *(j[n] for n in DIFF))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_grads(p, g):
    t = {name: torch.from_numpy(a) for name, a in p.items()}
    out = blocked_attention_plain(*(t[n] for n in ARGS), heads=H,
                                  num_radial=K)
    return [x.numpy() for x in blocked_attention_bwd_plain(
        *(t[n] for n in ARGS), torch.from_numpy(g), heads=H, num_radial=K,
        out=out)]


@pytest.mark.parametrize("window,i_chunk", [
    ("square", None), ("rect", None), ("square", 2)])
def test_bwd_plain_matches_pallas_interpret(window, i_chunk):
    """_bwd_kernel (i_chunk None), at DI == DK and DI != DK, and
    _bwd_kernel_ichunk; measured max abs error ~4e-6 on gradients of
    magnitude up to ~40."""
    p = _problem(0) if window == "square" else _problem(1, di=6, dk=4)
    g = _g(p, 10)
    ref = _reference_grads(p, g, i_chunk)
    got = _port_grads(p, g)
    for name, a, b in zip(DIFF, got, ref):
        np.testing.assert_allclose(a, b.reshape(a.shape), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("window", ["square", "rect"])
def test_bwd_plain_matches_autograd(window):
    p = _problem(2) if window == "square" else _problem(3, di=5, dk=7)
    g = _g(p, 11)
    t = {name: torch.from_numpy(a) for name, a in p.items()}
    for name in DIFF:
        t[name].requires_grad_(True)
    out = blocked_attention_plain(*(t[n] for n in ARGS), heads=H,
                                  num_radial=K)
    want = torch.autograd.grad(out, [t[n] for n in DIFF],
                               torch.from_numpy(g))
    for name, a, b in zip(DIFF, _port_grads(p, g), want):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("window,i_chunk", [
    ("square", None), ("rect", None), ("square", 2)])
def test_bwd_plain_with_saved_out_matches_pallas_interpret(window, i_chunk):
    """The plain backward given the forward output (as the autograd
    Function saves it, and as the CUDA kernel reads it for inner(i,h))
    against _bwd_kernel and _bwd_kernel_ichunk."""
    p = _problem(5) if window == "square" else _problem(6, di=4, dk=7)
    g = _g(p, 13)
    t = {name: torch.from_numpy(a) for name, a in p.items()}
    out = blocked_attention_plain(*(t[n] for n in ARGS), heads=H,
                                  num_radial=K)
    got = blocked_attention_bwd_plain(*(t[n] for n in ARGS),
                                      torch.from_numpy(g), heads=H,
                                      num_radial=K, out=out)
    ref = _reference_grads(p, g, i_chunk)
    for name, a, b in zip(DIFF, got, ref):
        np.testing.assert_allclose(a.numpy(), b.reshape(a.shape),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("window", ["square", "rect"])
def test_autograd_function_saves_out_and_matches_plain_autograd(window):
    """blocked_attention (the autograd Function, which now saves its
    output for the backward) against torch.autograd.grad through the plain
    forward, on the CPU."""
    p = _problem(7) if window == "square" else _problem(8, di=6, dk=3)
    g = torch.from_numpy(_g(p, 14))
    grads = []
    for fn in (blocked_attention, blocked_attention_plain):
        t = {name: torch.from_numpy(a) for name, a in p.items()}
        for name in DIFF:
            t[name].requires_grad_(True)
        out = fn(*(t[n] for n in ARGS), heads=H, num_radial=K)
        grads.append(torch.autograd.grad(out, [t[n] for n in DIFF], g))
    for name, a, b in zip(DIFF, *grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_dead_rows_and_pad_keys_get_exactly_zero():
    """Pad query slots, degree-0 atoms and pad key slots: exactly zero dq,
    dk, dv (so the lin_key/lin_value biases on pad rows of k_out get
    nothing from them), and a degree-0 atom gets exactly zero de."""
    p = _problem(0)
    dq, dk, dv, de, _, _ = _port_grads(p, _g(p, 12))
    dead_q = p["a_ids"] < 0
    dead_k = p["b_ids"] < 0
    assert dead_q.any() and dead_k.any()
    assert (dq[dead_q] == 0).all()
    assert (dk[dead_k] == 0).all() and (dv[dead_k] == 0).all()
    isolated = dead_q.all(1) & dead_k.all(1)
    assert isolated.any()
    assert (de[isolated] == 0).all()


if __name__ == "__main__":
    # the measured errors of the plain backward against the Pallas kernels
    #   env JAX_PLATFORMS=cpu python tests/test_torch_port_attention_bwd.py
    jax.config.update("jax_enable_x64", True)
    for window, i_chunk in (("square", None), ("rect", None),
                            ("square", 2)):
        p = _problem(0) if window == "square" else _problem(1, di=6, dk=4)
        g = _g(p, 10)
        ref = _reference_grads(p, g, i_chunk)
        for name, a, b in zip(DIFF, _port_grads(p, g), ref):
            b = b.reshape(a.shape)
            err = np.abs(a - b)
            print(f"{window} i_chunk={i_chunk} d{name}: max abs "
                  f"{err.max():.3e}, max |ref| {np.abs(b).max():.3e}, "
                  f"max rel {(err / np.maximum(np.abs(b), 1e-30)).max():.3e}")
