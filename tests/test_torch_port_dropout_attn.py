"""The port's blocked attention with a dropout mask and the alpha output:
the plain forward and backward (the plain versions of the CUDA kernels'
drop and alpha instances) against the reference Pallas kernels run in
interpret mode with `dropout_mask=` and `return_alpha=True`, and the
autograd Function's handling of the mask and of alpha's cotangent. The
CUDA instances run only on the card, where chip_smoke.py holds them
against these plain versions."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_attention_bwd import ARGS, DIFF, TOL, _g
from test_torch_port_blocked_attn import HC, H, K, L, _problem
from x2gnn_tpu.ops.pallas.blocked_attn import (
    expand_block_diagonal, pallas_blocked_attention)
from x2gnn_tpu_torch.ops.blocked_attn import (
    blocked_attention, blocked_attention_bwd_plain, blocked_attention_plain)

WINDOWS = [("square", None), ("rect", None), ("square", 2)]


def _window(window, seed):
    return _problem(seed) if window == "square" else _problem(seed, di=6,
                                                              dk=4)


def _mask(p, seed, rate=0.3):
    """A keep mask (N, DI, DK, H) pre-scaled by 1/keep, from numpy."""
    N, DI, _ = p["q"].shape
    DK = p["k"].shape[1]
    keep = np.float32(1.0 - rate)
    draw = np.random.default_rng(seed).random((N, DI, DK, H)) < keep
    return draw.astype(np.float32) / keep


def _reference(p, mask, return_alpha, i_chunk):
    """The interpret-mode Pallas function of (q, k, v, e, w, b)."""
    j = {name: jnp.asarray(a) for name, a in p.items()}

    def f(q, k, v, e, w, b):
        return pallas_blocked_attention(
            q, k, v, e, j["rbf"], expand_block_diagonal(w, L, K, HC),
            b.reshape(1, HC), j["z"], j["a_ids"], j["b_ids"], heads=H,
            num_radial=K, interpret=True, i_chunk=i_chunk,
            dropout_mask=jnp.asarray(mask), return_alpha=return_alpha)

    return f, [j[n] for n in DIFF]


def _torch(p):
    return {name: torch.from_numpy(a) for name, a in p.items()}


@pytest.mark.parametrize("return_alpha", [False, True])
@pytest.mark.parametrize("window,i_chunk", WINDOWS)
def test_fwd_plain_with_mask_matches_pallas_interpret(window, i_chunk,
                                                      return_alpha):
    """_fwd_kernel / _fwd_kernel_ichunk with HAS_DROP (and WANT_ALPHA):
    the output, and alpha = the pre-dropout weights, 0 at invalid pairs."""
    p = _window(window, 20)
    mask = _mask(p, 21)
    f, primals = _reference(p, mask, return_alpha, i_chunk)
    ref = f(*primals)
    t = _torch(p)
    got = blocked_attention_plain(*(t[n] for n in ARGS), heads=H,
                                  num_radial=K,
                                  dropout_mask=torch.from_numpy(mask),
                                  return_alpha=return_alpha)
    if not return_alpha:
        ref, got = (ref,), (got,)
    for name, a, b in zip(("out", "alpha"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert (mask == 0).mean() > 0.1
    no_drop = blocked_attention_plain(*(t[n] for n in ARGS), heads=H,
                                      num_radial=K)
    assert not np.allclose(got[0].numpy(), no_drop.numpy())
    if return_alpha:
        alpha = got[1].numpy()
        valid = ((p["a_ids"][:, :, None] != p["b_ids"][:, None, :])
                 & (p["a_ids"] >= 0)[:, :, None]
                 & (p["b_ids"] >= 0)[:, None, :])
        assert (alpha[~valid] == 0).all()
        rows = valid.any(2)
        np.testing.assert_allclose(alpha.sum(2)[rows], 1.0, rtol=1e-5)


@pytest.mark.parametrize("with_galpha", [False, True])
@pytest.mark.parametrize("window,i_chunk", WINDOWS)
def test_bwd_plain_with_mask_matches_pallas_interpret(window, i_chunk,
                                                      with_galpha):
    """_bwd_kernel / _bwd_kernel_ichunk with HAS_DROP (and WANT_ALPHA's
    cotangent galpha): all six gradients, from the saved output, with
    inner(i,h) = sum g out + sum_k alpha galpha."""
    p = _window(window, 22)
    mask = _mask(p, 23)
    g = _g(p, 24)
    f, primals = _reference(p, mask, with_galpha, i_chunk)
    _, vjp = jax.vjp(f, *primals)
    galpha = None
    if with_galpha:
        N, DI, _ = p["q"].shape
        galpha = np.random.default_rng(25).normal(
            size=(N, DI, p["k"].shape[1], H)).astype(np.float32)
        ref = vjp((jnp.asarray(g), jnp.asarray(galpha)))
    else:
        ref = vjp(jnp.asarray(g))
    t = _torch(p)
    args = [t[n] for n in ARGS]
    m = torch.from_numpy(mask)
    out = blocked_attention_plain(*args, heads=H, num_radial=K,
                                  dropout_mask=m)
    got = blocked_attention_bwd_plain(
        *args, torch.from_numpy(g), heads=H, num_radial=K, out=out,
        dropout_mask=m,
        galpha=None if galpha is None else torch.from_numpy(galpha))
    for name, a, b in zip(DIFF, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("window", ["square", "rect"])
def test_autograd_function_alpha_path_matches_plain_autograd(window):
    """blocked_attention with the mask and return_alpha, a loss of out,
    alpha or both: its gradients (the backward with galpha) against
    torch.autograd through the plain forward; with alpha unused (a None
    cotangent) they equal those of the call without alpha."""
    p = _window(window, 26)
    m = torch.from_numpy(_mask(p, 27))
    rng = np.random.default_rng(28)
    g = torch.from_numpy(_g(p, 29))
    wa = torch.from_numpy(rng.normal(size=(p["q"].shape[0],
                                           p["q"].shape[1],
                                           p["k"].shape[1], H)).astype(
                                               np.float32))

    def grads(fn, loss_of, return_alpha=True):
        t = _torch(p)
        for name in DIFF:
            t[name].requires_grad_(True)
        res = fn(*(t[n] for n in ARGS), heads=H, num_radial=K,
                 dropout_mask=m, return_alpha=return_alpha)
        out, alpha = res if return_alpha else (res, None)
        loss = {"out": lambda: (out * g).sum(),
                "alpha": lambda: (alpha * wa).sum(),
                "both": lambda: (out * g).sum() + (alpha * wa).sum()}
        # alpha alone does not depend on v
        got = torch.autograd.grad(loss[loss_of](), [t[n] for n in DIFF],
                                  allow_unused=True)
        return [torch.zeros_like(t[n]) if d is None else d
                for n, d in zip(DIFF, got)]

    # "alpha": no cotangent for out, which the backward takes as zeros
    for loss_of in ("both", "out", "alpha"):
        got = grads(blocked_attention, loss_of)
        want = grads(blocked_attention_plain, loss_of)
        for name, a, b in zip(DIFF, got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} "
                                       f"loss of {loss_of}")
    unused = grads(blocked_attention, "out")
    without = grads(blocked_attention, "out", return_alpha=False)
    for name, a, b in zip(DIFF, unused, without):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


@pytest.mark.parametrize("change", ["shape", "dtype", "layout", "device"])
def test_wrapper_rejects_a_bad_mask(change):
    p = _problem(0)
    t = _torch(p)
    m = torch.from_numpy(_mask(p, 30))
    bad = {"shape": m[:, :, :-1].contiguous(), "dtype": m.double(),
           "layout": m.transpose(1, 2), "device": m.to("meta")}[change]
    with pytest.raises((ValueError, TypeError)):
        blocked_attention(*(t[n] for n in ARGS), heads=H, num_radial=K,
                          dropout_mask=bad)
