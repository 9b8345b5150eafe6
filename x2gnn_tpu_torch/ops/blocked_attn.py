"""Fused atom-blocked attention (counterpart of
x2gnn_tpu/ops/pallas/blocked_attn.py).

`blocked_attention` launches the hand-written CUDA kernel
(`csrc/blocked_attn_fwd.cu`) for CUDA tensors and runs the plain PyTorch
version `blocked_attention_plain` for CPU tensors. Both take the
un-expanded sbf weight `w_sbf` (L*K, HC); the reference's kernel takes its
block-diagonal expansion instead (`expand_block_diagonal`, :64-71).

Inputs, per atom row n of the blocked layout:
    q:      (N, DI, HC) in-edge query projections
    k, v:   (N, DK, HC) out-edge key/value projections
    e_atom: (N, HC)     media-atom edge_attr projection (added to k and v)
    rbf:    (N, DK, L*K) radial sbf factors of the out-edges
    w_sbf:  (L*K, HC)   lin_sbf kernel; bias (HC,) lin_sbf bias
    z:      (N, DI, DK) cos(angle) between in- and out-edge pairs
    a_ids:  (N, DI) int32 source atom of each in-edge, -1 at pad slots
    b_ids:  (N, DK) int32 destination atom of each out-edge, -2 at pad slots
Returns out (N, DI, HC) float32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

_NEG = -1e30
MAX_DEGREE = 64   # the kernel's largest DI and DK


def _legendre_stack(z: torch.Tensor, L: int):
    """pref_l P_l(z), l = 0..L-1 (the reference's _legendre_stack, :82-91)."""
    p = [torch.ones_like(z)]
    if L > 1:
        p.append(z)
    for l in range(2, L):
        p.append(((2 * l - 1) * z * p[l - 1] - (l - 1) * p[l - 2]) / l)
    pref = np.sqrt((2 * np.arange(L) + 1) / (4 * np.pi)).astype(np.float32)
    return [p[l] * float(pref[l]) for l in range(L)]


def blocked_attention_plain(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids,
                            b_ids, heads: int, num_radial: int):
    """Plain PyTorch version of the kernel, mirroring the reference's
    `_attention_core` (:107-163): it materializes (N, DI, DK, HC) pair
    tensors, masks with one select at -1e30, floors the max at -5e29,
    clamps the denominator at 1e-16 and defers the division."""
    N, DI, HC = q.shape
    DK = k.shape[1]
    H, K = heads, num_radial
    C = HC // H
    L = rbf.shape[-1] // K
    e = e_atom[:, None, :]
    k = k + e
    v = v + e
    valid = ((a_ids[:, :, None] != b_ids[:, None, :])
             & (a_ids >= 0)[:, :, None] & (b_ids >= 0)[:, None, :])
    prod = q[:, :, None, :] * k[:, None, :, :]              # (N,DI,DK,HC)
    scores = prod.reshape(N, DI, DK, H, C).sum(-1) / float(np.sqrt(C))
    scores = torch.where(valid[..., None], scores, _NEG)
    smax = torch.clamp(scores.amax(dim=2, keepdim=True), min=_NEG / 2)
    ex = torch.exp(scores - smax)          # exactly 0 at masked pairs
    rnorm = 1.0 / torch.clamp(ex.sum(dim=2, keepdim=True), min=1e-16)
    ex_rep = ex.repeat_interleave(C, dim=-1)                # (N,DI,DK,HC)

    G = torch.einsum("nklj,ljf->nklf", rbf.reshape(N, DK, L, K),
                     w_sbf.reshape(L, K, HC))               # (N,DK,L,HC)
    P = _legendre_stack(z, L)                               # (N,DI,DK) each
    s = bias.reshape(1, 1, 1, HC)
    for l in range(L):
        s = s + P[l][..., None] * G[:, None, :, l, :]
    out = (v[:, None, :, :] * s * ex_rep).sum(dim=2)        # (N,DI,HC)
    return out * rnorm.reshape(N, DI, H).repeat_interleave(C, dim=-1)


def _check(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids, heads,
           num_radial):
    """Raise on inputs the kernel does not take."""
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
        raise ValueError(f"N={N}, DI={DI}, DK={DK}: the kernel takes N >= 1 "
                         f"and DI, DK in 1..{MAX_DEGREE}")
    if 32 % C or HC % 32 or HC > 1024:
        raise ValueError(f"H={heads}, C={C}: the kernel needs C dividing 32 "
                         "and HC a multiple of 32 up to 1024")


def _check_no_grad(*tensors):
    """Raise if autograd would record through the kernel: its output has no
    backward yet, so a gradient would be cut there without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "blocked_attention on CUDA has no backward yet (the _bwd_kernel "
            "port); call it under torch.no_grad() or torch.inference_mode()")


def blocked_attention(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids,
                      heads: int, num_radial: int) -> torch.Tensor:
    """Fused blocked attention forward: the CUDA kernel on CUDA tensors,
    the plain (differentiable) version on CPU tensors. On CUDA it raises
    when a float input needs a gradient. Counts its kernel launches in
    `blocked_attention.launches`."""
    _check(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids, heads,
           num_radial)
    if q.device.type == "cpu":
        return blocked_attention_plain(q, k, v, e_atom, rbf, w_sbf, bias, z,
                                       a_ids, b_ids, heads, num_radial)
    _check_no_grad(q, k, v, e_atom, rbf, w_sbf, bias, z)
    N, DI, HC = q.shape
    DK = k.shape[1]
    L = rbf.shape[-1] // num_radial
    lib = _library()
    out = torch.empty((N, DI, HC), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blocked_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e_atom.data_ptr(),
            rbf.data_ptr(), w_sbf.data_ptr(), bias.data_ptr(), z.data_ptr(),
            a_ids.data_ptr(), b_ids.data_ptr(), out.data_ptr(),
            N, DI, DK, heads, HC // heads, L, num_radial, stream)
    if err != 0:
        msg = lib.blocked_attn_fwd_error_string(err).decode()
        raise RuntimeError(f"blocked_attn_fwd launch failed: {msg} "
                           f"(N={N}, DI={DI}, DK={DK}, HC={HC}, L={L})")
    blocked_attention.launches += 1
    return out


blocked_attention.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from x2gnn_tpu_torch.ops import _build
    lib = _build.load()
    ptr = ctypes.c_void_p
    lib.blocked_attn_fwd.argtypes = ([ptr] * 11 + [ctypes.c_int] * 7
                                     + [ptr])
    lib.blocked_attn_fwd.restype = ctypes.c_int
    lib.blocked_attn_fwd_error_string.argtypes = [ctypes.c_int]
    lib.blocked_attn_fwd_error_string.restype = ctypes.c_char_p
    return lib
