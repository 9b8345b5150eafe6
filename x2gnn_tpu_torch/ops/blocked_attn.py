"""Fused atom-blocked attention (counterpart of
x2gnn_tpu/ops/pallas/blocked_attn.py).

`blocked_attention` is a `torch.autograd.Function`. On CUDA tensors its
forward launches the hand-written kernel of `csrc/blocked_attn_fwd.cu`
and its backward those of `csrc/blocked_attn_bwd.cu` (the gradient kernel,
then a fixed-order sum of its per-atom dW/db partials); on CPU tensors
both run the plain PyTorch versions `blocked_attention_plain` and
`blocked_attention_bwd_plain`. All take the un-expanded sbf weight
`w_sbf` (L*K, HC); the reference's kernel takes its block-diagonal
expansion instead (`expand_block_diagonal`, :64-71), so the port's dW is
the diagonal blocks of the reference's dW_bd.

Inputs, per atom row n of the blocked layout:
    q:      (N, DI, HC) in-edge query projections
    k, v:   (N, DK, HC) out-edge key/value projections
    e_atom: (N, HC)     media-atom edge_attr projection (added to k and v)
    rbf:    (N, DK, L*K) radial sbf factors of the out-edges
    w_sbf:  (L*K, HC)   lin_sbf kernel; bias (HC,) lin_sbf bias
    z:      (N, DI, DK) cos(angle) between in- and out-edge pairs
    a_ids:  (N, DI) int32 source atom of each in-edge, -1 at pad slots
    b_ids:  (N, DK) int32 destination atom of each out-edge, -2 at pad slots
Returns out (N, DI, HC) float32. Gradients flow to q, k, v, e_atom, w_sbf
and bias; rbf and z are geometry and get none, as in the reference
(:719-724, zero cotangents).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

_NEG = -1e30
MAX_DEGREE = 64   # the kernels' largest DI and DK
MAX_L = 8         # the backward kernel keeps L values per thread


def _legendre_stack(z: torch.Tensor, L: int):
    """pref_l P_l(z), l = 0..L-1 (the reference's _legendre_stack, :82-91)."""
    p = [torch.ones_like(z)]
    if L > 1:
        p.append(z)
    for l in range(2, L):
        p.append(((2 * l - 1) * z * p[l - 1] - (l - 1) * p[l - 2]) / l)
    pref = np.sqrt((2 * np.arange(L) + 1) / (4 * np.pi)).astype(np.float32)
    return [p[l] * float(pref[l]) for l in range(L)]


def _softmax_parts(q, kk, a_ids, b_ids, heads):
    """Pair validity (N,DI,DK), unnormalized weights ex (N,DI,DK,H) and
    reciprocal denominators rnorm (N,DI,1,H), as `_attention_core`
    (:135-145): one select at -1e30, the max floored at -5e29, the
    denominator clamped at 1e-16."""
    N, DI, HC = q.shape
    DK = kk.shape[1]
    C = HC // heads
    valid = ((a_ids[:, :, None] != b_ids[:, None, :])
             & (a_ids >= 0)[:, :, None] & (b_ids >= 0)[:, None, :])
    prod = q[:, :, None, :] * kk[:, None, :, :]             # (N,DI,DK,HC)
    scores = prod.reshape(N, DI, DK, heads, C).sum(-1) / float(np.sqrt(C))
    scores = torch.where(valid[..., None], scores, _NEG)
    smax = torch.clamp(scores.amax(dim=2, keepdim=True), min=_NEG / 2)
    ex = torch.exp(scores - smax)          # exactly 0 at masked pairs
    rnorm = 1.0 / torch.clamp(ex.sum(dim=2, keepdim=True), min=1e-16)
    return valid, ex, rnorm


def _modulation(rbf, w_sbf, bias, z, num_radial):
    """P_l(z) (list of (N,DI,DK)) and s = bias + sum_l P_l G_l
    (N,DI,DK,HC), with G = rbf . w_sbf per l block (N,DK,L,HC)."""
    N, DK, LK = rbf.shape
    K = num_radial
    L = LK // K
    HC = w_sbf.shape[-1]
    G = torch.einsum("nklj,ljf->nklf", rbf.reshape(N, DK, L, K),
                     w_sbf.reshape(L, K, HC))
    P = _legendre_stack(z, L)
    s = bias.reshape(1, 1, 1, HC)
    for l in range(L):
        s = s + P[l][..., None] * G[:, None, :, l, :]
    return P, s


def blocked_attention_plain(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids,
                            b_ids, heads: int, num_radial: int):
    """Plain PyTorch version of the forward kernel, mirroring the
    reference's `_attention_core` (:107-163): it materializes (N, DI, DK,
    HC) pair tensors and defers the softmax division."""
    N, DI, HC = q.shape
    C = HC // heads
    e = e_atom[:, None, :]
    kk, vv = k + e, v + e
    _, ex, rnorm = _softmax_parts(q, kk, a_ids, b_ids, heads)
    _, s = _modulation(rbf, w_sbf, bias, z, num_radial)
    ex_rep = ex.repeat_interleave(C, dim=-1)                # (N,DI,DK,HC)
    out = (vv[:, None, :, :] * s * ex_rep).sum(dim=2)       # (N,DI,HC)
    return out * rnorm.reshape(N, DI, heads).repeat_interleave(C, dim=-1)


def blocked_attention_bwd_plain(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids,
                                b_ids, g, heads: int, num_radial: int):
    """Plain PyTorch version of the backward kernel, step by step as the
    reference's `_bwd_kernel` (:198-279): recompute the softmax, fold
    rnorm into g, then ds, dv, dalpha, inner, dscores, dq/dk, dG, dW, db,
    de. Returns (dq, dk, dv, de, dW, db) with dW (L*K, HC) the gradient of
    the un-expanded w_sbf and db (HC,)."""
    N, DI, HC = q.shape
    H, K = heads, num_radial
    C = HC // H
    L = rbf.shape[-1] // K
    e = e_atom[:, None, :]
    kk, vv = k + e, v + e
    valid, ex, rnorm = _softmax_parts(q, kk, a_ids, b_ids, H)
    P, s = _modulation(rbf, w_sbf, bias, z, K)
    alpha = ex * rnorm                                      # (N,DI,DK,H)
    ex_rep = ex.repeat_interleave(C, dim=-1)                # (N,DI,DK,HC)
    gn = g * rnorm.reshape(N, DI, H).repeat_interleave(C, dim=-1)
    gn4, g4 = gn[:, :, None, :], g[:, :, None, :]
    v4 = vv[:, None, :, :]
    ds = gn4 * v4 * ex_rep                                  # (N,DI,DK,HC)
    dv = (gn4 * s * ex_rep).sum(dim=1)
    dalpha = (g4 * v4 * s).reshape(*ds.shape[:3], H, C).sum(-1)
    inner = (alpha * dalpha).sum(dim=2, keepdim=True)
    dscores = alpha * (dalpha - inner) / float(np.sqrt(C))
    dscores = torch.where(valid[..., None], dscores, 0.0)
    dsc_rep = dscores.repeat_interleave(C, dim=-1)
    dq = (dsc_rep * kk[:, None, :, :]).sum(dim=2)           # (N,DI,HC)
    dk = (dsc_rep * q[:, :, None, :]).sum(dim=1)            # (N,DK,HC)
    dG = torch.stack([(P[l][..., None] * ds).sum(dim=1)
                      for l in range(L)], dim=2)            # (N,DK,L,HC)
    dW = torch.einsum("nklj,nklf->ljf", rbf.reshape(N, -1, L, K), dG)
    db = ds.sum(dim=(0, 1, 2))
    de = (dk + dv).sum(dim=1)
    return dq, dk, dv, de, dW.reshape(L * K, HC), db


def _check(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids, heads,
           num_radial):
    """Raise on inputs the kernels do not take."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q and k must be 3-D, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    N, DI, HC = q.shape
    DK = k.shape[1]
    if heads <= 0 or HC % heads:
        raise ValueError(f"HC={HC} is not a multiple of heads={heads}")
    C = HC // heads
    K = num_radial
    if K <= 0 or rbf.dim() != 3 or rbf.shape[-1] % K:
        raise ValueError(f"rbf {tuple(rbf.shape)} is not (N, DK, L*{K})")
    L = rbf.shape[-1] // K
    want = {"q": (N, DI, HC), "k": (N, DK, HC), "v": (N, DK, HC),
            "e_atom": (N, HC), "rbf": (N, DK, L * K), "w_sbf": (L * K, HC),
            "bias": (HC,), "z": (N, DI, DK), "a_ids": (N, DI),
            "b_ids": (N, DK)}
    got = {"q": q, "k": k, "v": v, "e_atom": e_atom, "rbf": rbf,
           "w_sbf": w_sbf, "bias": bias, "z": z, "a_ids": a_ids,
           "b_ids": b_ids}
    device = q.device
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        dtype = torch.int32 if name in ("a_ids", "b_ids") else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if not (N >= 1 and 1 <= DI <= MAX_DEGREE and 1 <= DK <= MAX_DEGREE):
        raise ValueError(f"N={N}, DI={DI}, DK={DK}: the kernels take N >= 1 "
                         f"and DI, DK in 1..{MAX_DEGREE}")
    if 32 % C or HC % 32 or HC > 1024:
        raise ValueError(f"H={heads}, C={C}: the kernels need C dividing 32 "
                         "and HC a multiple of 32 up to 1024")
    if L > MAX_L:
        raise ValueError(f"L={L}: the backward kernel takes L <= {MAX_L}")


def _raise_on(lib, err, name, shape):
    if err != 0:
        msg = lib.blocked_attn_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({shape})")


def blocked_attention_fwd(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids,
                          heads: int, num_radial: int) -> torch.Tensor:
    """The forward: the CUDA kernel on CUDA tensors (counted in
    `blocked_attention.launches`), the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return blocked_attention_plain(q, k, v, e_atom, rbf, w_sbf, bias, z,
                                       a_ids, b_ids, heads, num_radial)
    N, DI, HC = q.shape
    DK = k.shape[1]
    L = rbf.shape[-1] // num_radial
    lib = _library("blocked_attn_fwd")
    out = torch.empty((N, DI, HC), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blocked_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e_atom.data_ptr(),
            rbf.data_ptr(), w_sbf.data_ptr(), bias.data_ptr(), z.data_ptr(),
            a_ids.data_ptr(), b_ids.data_ptr(), out.data_ptr(),
            N, DI, DK, heads, HC // heads, L, num_radial, stream)
    _raise_on(lib, err, "blocked_attn_fwd",
              f"N={N}, DI={DI}, DK={DK}, HC={HC}, L={L}")
    blocked_attention.launches += 1
    return out


def blocked_attention_bwd(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids,
                          g, heads: int, num_radial: int):
    """(dq, dk, dv, de, dW, db) from g = d out: on CUDA tensors the
    backward kernel (`blocked_attention_bwd_partials`) and the fixed-order
    sum of its per-atom dW/db partials (`reduce_partials`); on CPU tensors
    the plain version."""
    if q.device.type == "cpu":
        return blocked_attention_bwd_plain(q, k, v, e_atom, rbf, w_sbf, bias,
                                           z, a_ids, b_ids, g, heads,
                                           num_radial)
    dq, dk, dv, de, partial = blocked_attention_bwd_partials(
        q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids, g, heads,
        num_radial)
    LKHC = w_sbf.numel()
    dwdb = reduce_partials(partial)
    return dq, dk, dv, de, dwdb[:LKHC].reshape(w_sbf.shape), dwdb[LKHC:]


def blocked_attention_bwd_partials(q, k, v, e_atom, rbf, w_sbf, bias, z,
                                   a_ids, b_ids, g, heads: int,
                                   num_radial: int):
    """The backward kernel alone, on CUDA tensors (counted in
    `blocked_attention_bwd_partials.launches`): (dq, dk, dv, de, partial),
    with partial (N, (L*K+1)*HC) each atom's share of dW (row-major, L*K x
    HC) followed by its share of db."""
    if q.device.type != "cuda":
        raise ValueError(f"the backward kernel runs on CUDA tensors, got "
                         f"{q.device}")
    if g.shape != q.shape or g.dtype != torch.float32 or g.device != q.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} on {g.device} does "
                         f"not match q {tuple(q.shape)}")
    if not g.is_contiguous():
        raise ValueError("g is not contiguous")
    N, DI, HC = q.shape
    DK = k.shape[1]
    K = num_radial
    L = rbf.shape[-1] // K
    lib = _library("blocked_attn_bwd")
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((N, DI, HC), **f32)
    dk = torch.empty((N, DK, HC), **f32)
    dv = torch.empty((N, DK, HC), **f32)
    de = torch.empty((N, HC), **f32)
    partial = torch.empty((N, (L * K + 1) * HC), **f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blocked_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e_atom.data_ptr(),
            rbf.data_ptr(), w_sbf.data_ptr(), bias.data_ptr(), z.data_ptr(),
            a_ids.data_ptr(), b_ids.data_ptr(), g.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), de.data_ptr(), partial.data_ptr(),
            N, DI, DK, heads, HC // heads, L, K, stream)
    _raise_on(lib, err, "blocked_attn_bwd",
              f"N={N}, DI={DI}, DK={DK}, HC={HC}, L={L}")
    blocked_attention_bwd_partials.launches += 1
    return dq, dk, dv, de, partial


def reduce_partials(partial: torch.Tensor) -> torch.Tensor:
    """Column sums of `partial` (rows, cols) float32 on CUDA: the reduce
    kernel of blocked_attn_bwd.cu, whose summation order depends only on
    the shape (counted in `reduce_partials.launches`)."""
    if partial.device.type != "cuda":
        raise ValueError(f"the reduce kernel runs on CUDA tensors, got "
                         f"{partial.device}")
    if partial.dim() != 2 or partial.dtype != torch.float32:
        raise ValueError(f"partial {tuple(partial.shape)} {partial.dtype} is "
                         "not a 2-D float32 tensor")
    if not partial.is_contiguous():
        raise ValueError("partial is not contiguous")
    rows, cols = partial.shape
    lib = _library("blocked_attn_bwd")
    out = torch.empty(cols, dtype=torch.float32, device=partial.device)
    with torch.cuda.device(partial.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blocked_attn_bwd_reduce(partial.data_ptr(), out.data_ptr(),
                                          rows, cols, stream)
    _raise_on(lib, err, "blocked_attn_bwd_reduce", f"{rows}x{cols}")
    reduce_partials.launches += 1
    return out


class _BlockedAttention(torch.autograd.Function):
    """Saves the inputs; the backward recomputes the softmax from them, as
    the reference's custom VJP does (the forward output is not saved)."""

    @staticmethod
    def forward(ctx, q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids,
                heads, num_radial):
        ctx.save_for_backward(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids,
                              b_ids)
        ctx.heads, ctx.num_radial = heads, num_radial
        return blocked_attention_fwd(q, k, v, e_atom, rbf, w_sbf, bias, z,
                                     a_ids, b_ids, heads, num_radial)

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv, de, dw, db = blocked_attention_bwd(
            *ctx.saved_tensors, g.contiguous(), ctx.heads, ctx.num_radial)
        # rbf, z (geometry), the ids, heads and num_radial get none
        return dq, dk, dv, de, None, dw, db, None, None, None, None, None


def blocked_attention(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids,
                      heads: int, num_radial: int) -> torch.Tensor:
    """Fused blocked attention, differentiable in q, k, v, e_atom, w_sbf
    and bias. CUDA tensors run the CUDA kernels, CPU tensors the plain
    versions; a CUDA launch that fails raises, nothing falls back."""
    _check(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids, heads,
           num_radial)
    return _BlockedAttention.apply(q, k, v, e_atom, rbf, w_sbf, bias, z,
                                   a_ids, b_ids, heads, num_radial)


def reset_launch_counts() -> None:
    """Set the three kernel launch counts to 0."""
    blocked_attention.launches = 0
    blocked_attention_bwd_partials.launches = 0
    reduce_partials.launches = 0


reset_launch_counts()


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    from x2gnn_tpu_torch.ops import _build
    lib = _build.load(name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "blocked_attn_fwd":
        lib.blocked_attn_fwd.argtypes = [ptr] * 11 + [i32] * 7 + [ptr]
        lib.blocked_attn_fwd.restype = i32
        lib.blocked_attn_error_string = lib.blocked_attn_fwd_error_string
    else:
        lib.blocked_attn_bwd.argtypes = [ptr] * 16 + [i32] * 7 + [ptr]
        lib.blocked_attn_bwd.restype = i32
        lib.blocked_attn_bwd_reduce.argtypes = [ptr, ptr, i32, i32, ptr]
        lib.blocked_attn_bwd_reduce.restype = i32
        lib.blocked_attn_error_string = lib.blocked_attn_bwd_error_string
    lib.blocked_attn_error_string.argtypes = [i32]
    lib.blocked_attn_error_string.restype = ctypes.c_char_p
    return lib
