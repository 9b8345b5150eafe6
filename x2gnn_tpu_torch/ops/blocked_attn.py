"""Fused atom-blocked attention (counterpart of
x2gnn_tpu/ops/pallas/blocked_attn.py).

`blocked_attention` is a `torch.autograd.Function` that saves its
output for the backward. On CUDA tensors its forward launches the
hand-written kernel of `csrc/blocked_attn_fwd.cu` (laid out by
`fwd_plan`) and its backward those of `csrc/blocked_attn_bwd.cu` (the
gradient kernel, laid out by `bwd_plan`, then a fixed-order sum of its
per-CTA dW/db partials); on CPU
tensors both run the plain PyTorch versions `blocked_attention_plain` and
`blocked_attention_bwd_plain`. All take the un-expanded sbf weight
`w_sbf` (L*K, HC); the reference's kernel takes its block-diagonal
expansion instead (`expand_block_diagonal`, :64-71), so the port's dW is
the diagonal blocks of the reference's dW_bd.

Inputs, per atom row n of the blocked layout:
    q:      (N, DI, HC) in-edge query projections
    k, v:   (N, DK, HC) out-edge key/value projections
    e_atom: (N, HC)     media-atom edge_attr projection (added to k and v)
    (q, k, v and e_atom all float32, or all bfloat16: the reference's bf16
    storage, widened to float32 at load with all math float32, :179-182;
    the other float inputs are float32)
    rbf:    (N, DK, L*K) radial sbf factors of the out-edges
    w_sbf:  (L*K, HC)   lin_sbf kernel; bias (HC,) lin_sbf bias
    z:      (N, DI, DK) cos(angle) between in- and out-edge pairs
    a_ids:  (N, DI) int32 source atom of each in-edge, -1 at pad slots
    b_ids:  (N, DK) int32 destination atom of each out-edge, -2 at pad slots
Optional, as the reference's `dropout_mask` and `return_alpha` (:446-472):
    dropout_mask: (N, DI, DK, H) float32 keep mask pre-scaled by 1/keep
                  (`ops.attention.pair_dropout_mask`), applied to the
                  softmax weights after the softmax, the denominator
                  undropped (:146);
    return_alpha: also return the pre-dropout weights alpha (N, DI, DK, H),
                  0 at invalid pairs, differentiable (its cotangent joins
                  the softmax's).
Returns out (N, DI, HC) float32, or (out, alpha). Gradients flow to q, k,
v, e_atom (in their storage dtype: the float32 gradients rounded once, as
the reference casts them, :719-724), w_sbf and bias (float32); rbf, z and
the mask are geometry and noise and get none, as in the reference (zero
cotangents).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

_NEG = -1e30
MAX_DEGREE = 64   # the kernels' largest DI and DK
MAX_L = 8         # the kernels keep L values of G (and dG) per thread
REG_K = 6         # K whose dW the backward kernel keeps in registers


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
                            b_ids, heads: int, num_radial: int,
                            dropout_mask=None, return_alpha: bool = False):
    """Plain PyTorch version of the forward kernel, mirroring the
    reference's `_attention_core` (:107-163) and `_fwd_kernel` (:166-195):
    it materializes (N, DI, DK, HC) pair tensors, multiplies the
    unnormalized weights by the mask after the softmax and defers the
    division. Returns out, or (out, alpha) with alpha = ex * rnorm before
    the dropout. bf16 q, k, v and e_atom are widened to float32 first."""
    q, k, v, e_atom = (t.float() for t in (q, k, v, e_atom))
    N, DI, HC = q.shape
    C = HC // heads
    e = e_atom[:, None, :]
    kk, vv = k + e, v + e
    _, ex, rnorm = _softmax_parts(q, kk, a_ids, b_ids, heads)
    _, s = _modulation(rbf, w_sbf, bias, z, num_radial)
    ex_used = ex if dropout_mask is None else ex * dropout_mask
    ex_rep = ex_used.repeat_interleave(C, dim=-1)           # (N,DI,DK,HC)
    out = (vv[:, None, :, :] * s * ex_rep).sum(dim=2)       # (N,DI,HC)
    out = out * rnorm.reshape(N, DI, heads).repeat_interleave(C, dim=-1)
    return (out, ex * rnorm) if return_alpha else out


def blocked_attention_bwd_plain(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids,
                                b_ids, g, heads: int, num_radial: int, *,
                                out, dropout_mask=None, galpha=None):
    """Plain PyTorch version of the backward kernel, step by step as the
    reference's `_bwd_kernel` (:198-279): recompute the softmax, fold
    rnorm into g, then ds, dv, dalpha (times the mask, plus the alpha
    output's cotangent `galpha`: :251-259), dscores, dq/dk, dG, dW, db,
    de. inner(i,h) = sum_k alpha dalpha is read, as the kernel reads it,
    from the forward output: sum_{c in h} g out (`out` as the forward
    returned it, which carries the mask already), plus sum_k alpha galpha.
    Returns (dq, dk, dv, de, dW, db), all float32 (bf16 q, k, v and e_atom
    are widened first), with dW (L*K, HC) the gradient of the un-expanded
    w_sbf and db (HC,)."""
    q, k, v, e_atom = (t.float() for t in (q, k, v, e_atom))
    N, DI, HC = q.shape
    H, K = heads, num_radial
    C = HC // H
    L = rbf.shape[-1] // K
    e = e_atom[:, None, :]
    kk, vv = k + e, v + e
    valid, ex, rnorm = _softmax_parts(q, kk, a_ids, b_ids, H)
    P, s = _modulation(rbf, w_sbf, bias, z, K)
    alpha = ex * rnorm                                      # (N,DI,DK,H)
    ex_used = ex if dropout_mask is None else ex * dropout_mask
    ex_rep = ex_used.repeat_interleave(C, dim=-1)           # (N,DI,DK,HC)
    gn = g * rnorm.reshape(N, DI, H).repeat_interleave(C, dim=-1)
    gn4, g4 = gn[:, :, None, :], g[:, :, None, :]
    v4 = vv[:, None, :, :]
    ds = gn4 * v4 * ex_rep                                  # (N,DI,DK,HC)
    dv = (gn4 * s * ex_rep).sum(dim=1)
    dalpha = (g4 * v4 * s).reshape(*ds.shape[:3], H, C).sum(-1)
    if dropout_mask is not None:
        dalpha = dalpha * dropout_mask
    inner = (g * out).reshape(N, DI, 1, H, C).sum(-1)       # (N,DI,1,H)
    if galpha is not None:
        dalpha = dalpha + galpha
        inner = inner + (alpha * galpha).sum(dim=2, keepdim=True)
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
           num_radial, dropout_mask=None):
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
    if dropout_mask is not None:
        want["dropout_mask"] = (N, DI, DK, heads)
        got["dropout_mask"] = dropout_mask
    device = q.device
    storage = q.dtype
    kinds = {"q": q.dtype, "k": k.dtype, "v": v.dtype, "e_atom": e_atom.dtype}
    if storage not in STORAGE or len(set(kinds.values())) > 1:
        raise TypeError(f"q, k, v and e_atom must share one storage dtype "
                        f"of {tuple(STORAGE)}, got {kinds}")
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        dtype = (torch.int32 if name in ("a_ids", "b_ids") else
                 storage if name in ("q", "k", "v", "e_atom") else
                 torch.float32)
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
    # each raises on what its kernel cannot lay out
    fwd_plan(N, DI, DK, HC, heads, L, K)
    bwd_plan(N, DI, DK, HC, heads, L, K)


def _raise_on(lib, err, name, shape):
    if err != 0:
        msg = lib.blocked_attn_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({shape})")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


# storage dtypes of q, k, v and e_atom (and of their gradients): the C entry
# points' storage index
STORAGE = {torch.float32: 0, torch.bfloat16: 1}

# the kernels' template instances, by (mask, alpha output or cotangent) in
# float32 storage, then the same in bf16 storage: the launch counters'
# variant names and the C entry points' variant index
FWD_VARIANTS = ("plain", "drop", "alpha", "drop+alpha")
BWD_VARIANTS = ("plain", "drop", "galpha", "drop+galpha")
FWD_VARIANTS += tuple(f"bf16:{v}" for v in FWD_VARIANTS)
BWD_VARIANTS += tuple(f"bf16:{v}" for v in BWD_VARIANTS)


def _variant(names, mask, alpha, dtype) -> str:
    return names[(mask is not None) + 2 * bool(alpha) + 4 * STORAGE[dtype]]


def blocked_attention_fwd(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids,
                          heads: int, num_radial: int, dropout_mask=None,
                          return_alpha: bool = False):
    """The forward: the CUDA kernel on CUDA tensors, laid out by
    `fwd_plan` (counted in `blocked_attention.launches`, per (N, DI, DK)
    in `blocked_attention.by_shape` and per (variant, N, DI, DK) in
    `blocked_attention.by_variant`, the variant one of FWD_VARIANTS, by
    the mask, alpha and q's storage dtype; `out` and `alpha` float32 from
    torch.empty, every slot of which the kernel writes), the plain version
    on CPU tensors. Returns out, or (out, alpha)."""
    if q.device.type == "cpu":
        return blocked_attention_plain(q, k, v, e_atom, rbf, w_sbf, bias, z,
                                       a_ids, b_ids, heads, num_radial,
                                       dropout_mask, return_alpha)
    N, DI, HC = q.shape
    DK = k.shape[1]
    L = rbf.shape[-1] // num_radial
    plan = fwd_plan(N, DI, DK, HC, heads, L, num_radial)
    lib = _library("blocked_attn_fwd")
    out = torch.empty((N, DI, HC), dtype=torch.float32, device=q.device)
    alpha = (torch.empty((N, DI, DK, heads), dtype=torch.float32,
                         device=q.device) if return_alpha else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blocked_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e_atom.data_ptr(),
            rbf.data_ptr(), w_sbf.data_ptr(), bias.data_ptr(), z.data_ptr(),
            a_ids.data_ptr(), b_ids.data_ptr(), _ptr(dropout_mask),
            out.data_ptr(), _ptr(alpha), STORAGE[q.dtype],
            N, DI, DK, heads, HC // heads, L, num_radial, plan.grid,
            plan.threads, plan.warpgroups, plan.i_chunk, plan.smem_bytes,
            stream)
    variant = _variant(FWD_VARIANTS, dropout_mask, return_alpha, q.dtype)
    _raise_on(lib, err, "blocked_attn_fwd",
              f"{variant}, N={N}, DI={DI}, DK={DK}, HC={HC}, L={L}, {plan}")
    blocked_attention.launches += 1
    blocked_attention.by_shape[(N, DI, DK)] += 1
    blocked_attention.by_variant[(variant, N, DI, DK)] += 1
    return (out, alpha) if return_alpha else out


# Launch plans of both kernels. A CTA is `warpgroups` warpgroups (4, fewer
# for windows of fewer than 4 keys) of up to 128 threads, one per channel of
# a group (heads never straddle a group; a wider HC is more CTAs along
# grid.y), which split each atom's keys: 16 warps on an SM. Its shared
# memory is sized so that 4 // warpgroups CTAs fit on one SM of an H100
# (228 KB of shared memory per SM, 1 KB of it reserved per CTA; 227 KB at
# most for one CTA), the atom's valid queries in chunks of `i_chunk`; where
# that does not fit even for one query, one CTA per SM with as many
# warpgroups as fit. The grid is at most 132 SMs x those CTAs, persistent:
# a constant, so the plan and the order of every sum depend on the shape
# alone, never on the card the kernel runs on.
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_CTA = 1024
MAX_SMEM_PER_CTA = 232448
PLAN_SMS = 132
WARPGROUPS_PER_SM = 4


def _up4(words):     # shared-memory regions start 16-byte aligned
    return -(-words // 4) * 4


def _plan_shape(kernel, N, DI, DK, HC, heads, L, K):
    """Raise ValueError on a shape the named kernel does not take; else
    return (C, threads): the head width and the channels of a
    warpgroup."""
    C = HC // heads if heads > 0 else 0
    if not (N >= 1 and 1 <= DI <= MAX_DEGREE and 1 <= DK <= MAX_DEGREE):
        raise ValueError(f"N={N}, DI={DI}, DK={DK}: the {kernel} kernel "
                         f"takes N >= 1 and DI, DK in 1..{MAX_DEGREE}")
    if heads <= 0 or HC % heads or C < 1 or 32 % C or HC % 32 or HC > 1024:
        raise ValueError(f"HC={HC}, heads={heads}: the {kernel} kernel needs "
                         "C dividing 32 and HC a multiple of 32 up to 1024")
    if not (1 <= L <= MAX_L and K >= 1):
        raise ValueError(f"L={L}, K={K}: the {kernel} kernel takes L in "
                         f"1..{MAX_L} and K >= 1")
    return C, next(t for t in (128, 96, 64, 32) if HC % t == 0)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Launch plan of a kernel: `grid` persistent CTAs of `warpgroups` x
    `threads` threads (each warpgroup one thread per channel of a group of
    `threads` channels and its share of the keys; `channel_groups` groups
    along grid.y), CTA r walking the atoms r, r + grid, ..., the valid
    queries of an atom in chunks of `i_chunk`, with `smem_bytes` of dynamic
    shared memory, `ctas_per_sm` of them sized to fit on one SM."""
    grid: int
    threads: int
    warpgroups: int
    channel_groups: int
    i_chunk: int
    smem_bytes: int
    ctas_per_sm: int


def _plan(kernel, words, N, DI, DK, HC, L, K, threads) -> LaunchPlan:
    """The first (warpgroups, CTAs per SM) whose `words(wg, ic)` fit, with
    the largest query chunk ic: 4 // wg CTAs of wg = min(4, DK) warpgroups
    per SM, else one CTA of as many warpgroups as fit."""
    wg0 = min(WARPGROUPS_PER_SM, DK)
    for warpgroups, ctas_per_sm in (
            [(wg0, WARPGROUPS_PER_SM // wg0)]
            + [(wg, 1) for wg in range(wg0, 0, -1)]):
        budget = (SMEM_PER_SM // ctas_per_sm - SMEM_RESERVED_PER_CTA) // 4
        i_chunk = next((ic for ic in range(DI, 0, -1)
                        if words(warpgroups, ic) <= budget), 0)
        if i_chunk:
            return LaunchPlan(
                grid=min(N, PLAN_SMS * ctas_per_sm), threads=threads,
                warpgroups=warpgroups, channel_groups=HC // threads,
                i_chunk=i_chunk, smem_bytes=4 * words(warpgroups, i_chunk),
                ctas_per_sm=ctas_per_sm)
    raise ValueError(f"DI={DI}, DK={DK}, HC={HC}, L={L}, K={K}: W and rbf "
                     f"rows beyond the {kernel} kernel's {MAX_SMEM_PER_CTA} B "
                     "of shared memory")


def fwd_plan(N: int, DI: int, DK: int, HC: int, heads: int, L: int,
             K: int) -> LaunchPlan:
    """The forward kernel's launch plan for a shape; raises ValueError on
    a shape the kernel does not take. blocked_attn_fwd (the C entry point)
    checks the plan again."""
    C, threads = _plan_shape("forward", N, DI, DK, HC, heads, L, K)
    hb, LK = threads // C, L * K

    # 4-byte words, as make_layout in csrc/blocked_attn_fwd.cu: per CTA the
    # compacted slots and atom ids, the L prefactors, 8 words of counts and
    # masks, W's columns and the atom's rbf rows (each order's K values
    # padded to a multiple of 4) and k + e rows; per chunk of queries their
    # q rows, an output partial per warpgroup, the scores then exps (DK x
    # heads), pref_l P_l (DK x 8) and 1/denominator (heads).
    def words(wg, ic):
        fixed = (2 * _up4(DI) + 2 * _up4(DK) + MAX_L + 8 + LK * threads
                 + DK * L * _up4(K) + DK * threads)
        return fixed + ((1 + wg) * ic * threads + _up4(ic * DK * hb)
                        + ic * DK * MAX_L + _up4(ic * hb))

    return _plan("forward", words, N, DI, DK, HC, L, K, threads)


def fwd_occupancy(plan: LaunchPlan, variant: str = "plain") -> dict:
    """What the card gives the forward kernel's instance `variant` (one of
    FWD_VARIANTS) under `plan` (as `bwd_occupancy`)."""
    return _occupancy("blocked_attn_fwd", plan,
                      FWD_VARIANTS.index(variant))


def bwd_plan(N: int, DI: int, DK: int, HC: int, heads: int, L: int,
             K: int) -> LaunchPlan:
    """The backward kernel's launch plan for a shape; raises ValueError on
    a shape the kernel does not take. blocked_attn_bwd (the C entry point)
    checks the plan again."""
    C, threads = _plan_shape("backward", N, DI, DK, HC, heads, L, K)
    hb = threads // C
    LK = L * K

    # 4-byte words, as make_layout in csrc/blocked_attn_bwd.cu: per CTA the
    # compacted slots and atom ids, the L prefactors, 8 words of counts and
    # masks, de per warpgroup, W's columns, the atom's rbf rows and, for
    # K > REG_K, dW per warpgroup; per chunk of queries their q and g rows,
    # dq rows per warpgroup, alpha (DK x heads), pref_l P_l (DK x 8) and
    # inner (heads). The chunk's region also holds the final dW/db
    # reduction, (L*K + 1) rows.
    def words(wg, ic):
        fixed = (2 * _up4(DI) + 2 * _up4(DK) + MAX_L + 8 + wg * threads
                 + LK * threads + _up4(DK * LK)
                 + (wg * LK * threads if K > REG_K else 0))
        chunk = ((2 + wg) * ic * threads + _up4(ic * DK * hb)
                 + ic * DK * MAX_L + _up4(ic * hb))
        return fixed + max(chunk, (LK + 1) * threads)

    return _plan("backward", words, N, DI, DK, HC, L, K, threads)


def bwd_occupancy(plan: LaunchPlan, variant: str = "plain") -> dict:
    """What the card gives the backward kernel's instance `variant` (one
    of BWD_VARIANTS) under `plan`: registers and local (spill) bytes per
    thread, static shared bytes, and resident CTAs and warps per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    return _occupancy("blocked_attn_bwd", plan,
                      BWD_VARIANTS.index(variant))


def _occupancy(name: str, plan, variant: int) -> dict:
    lib = _library(name)
    info = (ctypes.c_int * 4)()
    block = plan.threads * plan.warpgroups
    err = getattr(lib, f"{name}_occupancy")(block, plan.smem_bytes, variant,
                                            info)
    _raise_on(lib, err, f"{name}_occupancy", str(plan))
    return {"registers": info[0], "spill_bytes": info[1],
            "static_smem_bytes": info[2], "dynamic_smem_bytes":
            plan.smem_bytes, "ctas_per_sm": info[3],
            "warps_per_sm": info[3] * block // 32}


def blocked_attention_bwd(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids,
                          g, heads: int, num_radial: int, *, out,
                          dropout_mask=None, galpha=None):
    """(dq, dk, dv, de, dW, db) from g = d out, the forward output `out`,
    the forward's mask and the cotangent `galpha` of its alpha output
    (None: no mask, no alpha output or an unused one): on CUDA tensors the
    backward kernel (`blocked_attention_bwd_partials`) and the fixed-order
    sum of its per-CTA dW/db partials (`reduce_partials`); on CPU tensors
    the plain version."""
    if q.device.type == "cpu":
        return blocked_attention_bwd_plain(
            q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids, g, heads,
            num_radial, out=out, dropout_mask=dropout_mask, galpha=galpha)
    dq, dk, dv, de, partial = blocked_attention_bwd_partials(
        q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids, g, heads,
        num_radial, out=out, dropout_mask=dropout_mask, galpha=galpha)
    LKHC = w_sbf.numel()
    dwdb = reduce_partials(partial)
    return dq, dk, dv, de, dwdb[:LKHC].reshape(w_sbf.shape), dwdb[LKHC:]


def blocked_attention_bwd_partials(q, k, v, e_atom, rbf, w_sbf, bias, z,
                                   a_ids, b_ids, g, heads: int,
                                   num_radial: int, *, out,
                                   dropout_mask=None, galpha=None):
    """The backward kernel alone, on CUDA tensors (counted in
    `blocked_attention_bwd_partials.launches`, per (N, DI, DK) in its
    `by_shape` and per (variant, N, DI, DK) in its `by_variant`, the
    variant one of BWD_VARIANTS): (dq, dk, dv, de, partial), the first four
    in q's storage dtype, with partial (bwd_plan(...).grid, (L*K+1)*HC)
    float32 each CTA's share of dW (row-major, L*K x HC) followed by its
    share of db. bf16 storage whose queries the plan chunks (i_chunk < DI)
    also gets two float32 (N, DK, HC) scratch tensors, where dk and dv sum
    over the chunks before their one rounding."""
    if q.device.type != "cuda":
        raise ValueError(f"the backward kernel runs on CUDA tensors, got "
                         f"{q.device}")
    N, DI, HC = q.shape
    DK = k.shape[1]
    pair = (N, DI, DK, heads)
    for name, t, shape in (("g", g, q.shape), ("out", out, q.shape),
                           ("dropout_mask", dropout_mask, pair),
                           ("galpha", galpha, pair)):
        if t is None and name in ("dropout_mask", "galpha"):
            continue
        if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} is not {tuple(shape)} float32 on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    K = num_radial
    L = rbf.shape[-1] // K
    plan = bwd_plan(N, DI, DK, HC, heads, L, K)
    lib = _library("blocked_attn_bwd")
    f32 = dict(dtype=torch.float32, device=q.device)
    own = dict(dtype=q.dtype, device=q.device)
    dq = torch.empty((N, DI, HC), **own)
    dk = torch.empty((N, DK, HC), **own)
    dv = torch.empty((N, DK, HC), **own)
    de = torch.empty((N, HC), **own)
    scratch = (None, None)
    if q.dtype != torch.float32 and plan.i_chunk < DI:
        scratch = (torch.empty((N, DK, HC), **f32),
                   torch.empty((N, DK, HC), **f32))
    partial = torch.empty((plan.grid, (L * K + 1) * HC), **f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blocked_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), e_atom.data_ptr(),
            rbf.data_ptr(), w_sbf.data_ptr(), bias.data_ptr(), z.data_ptr(),
            a_ids.data_ptr(), b_ids.data_ptr(), _ptr(dropout_mask),
            out.data_ptr(), g.data_ptr(), _ptr(galpha), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), de.data_ptr(), _ptr(scratch[0]),
            _ptr(scratch[1]), partial.data_ptr(), STORAGE[q.dtype],
            N, DI, DK, heads, HC // heads, L, K, plan.grid, plan.threads,
            plan.warpgroups, plan.i_chunk, plan.smem_bytes, stream)
    variant = _variant(BWD_VARIANTS, dropout_mask, galpha is not None,
                       q.dtype)
    _raise_on(lib, err, "blocked_attn_bwd",
              f"{variant}, N={N}, DI={DI}, DK={DK}, HC={HC}, L={L}, K={K}, "
              f"{plan}")
    blocked_attention_bwd_partials.launches += 1
    blocked_attention_bwd_partials.by_shape[(N, DI, DK)] += 1
    blocked_attention_bwd_partials.by_variant[(variant, N, DI, DK)] += 1
    return dq, dk, dv, de, partial


def reduce_partials(partial: torch.Tensor) -> torch.Tensor:
    """Column sums of `partial` (rows, cols) float32 on CUDA, cols a
    multiple of 4: the reduce kernel of blocked_attn_bwd.cu, whose
    summation order depends only on the shape (counted in
    `reduce_partials.launches`)."""
    if partial.device.type != "cuda":
        raise ValueError(f"the reduce kernel runs on CUDA tensors, got "
                         f"{partial.device}")
    if partial.dim() != 2 or partial.dtype != torch.float32:
        raise ValueError(f"partial {tuple(partial.shape)} {partial.dtype} is "
                         "not a 2-D float32 tensor")
    if not partial.is_contiguous() or partial.shape[1] % 4 \
            or partial.data_ptr() % 16:
        raise ValueError("partial is not contiguous, 16-byte aligned rows of "
                         "a multiple of 4 columns")
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
    """Saves the inputs, the mask and the forward output; the backward
    recomputes the softmax from the inputs and reads inner(i,h) =
    sum_{c in h} g out from the output (the reference's custom VJP
    recomputes the output instead, to spare TPU memory: :235). An unused
    output's cotangent arrives as None (the reference's `_zero_ct`,
    :633-639): no alpha cotangent runs the kernel without one, no `out`
    cotangent a zero g. dq, dk, dv and de are returned in their primal's
    dtype (the kernels write bf16 ones themselves; the plain version's
    float32 ones are rounded here), as the reference does (:719-724)."""

    @staticmethod
    def forward(ctx, q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids,
                dropout_mask, heads, num_radial, return_alpha):
        res = blocked_attention_fwd(q, k, v, e_atom, rbf, w_sbf, bias, z,
                                    a_ids, b_ids, heads, num_radial,
                                    dropout_mask, return_alpha)
        out = res[0] if return_alpha else res
        ctx.save_for_backward(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids,
                              b_ids, dropout_mask, out)
        ctx.heads, ctx.num_radial = heads, num_radial
        ctx.set_materialize_grads(False)
        return res

    @staticmethod
    def backward(ctx, g, galpha=None):
        *inputs, mask, out = ctx.saved_tensors
        g = torch.zeros_like(out) if g is None else g.contiguous()
        if galpha is not None:
            galpha = galpha.contiguous()
        dq, dk, dv, de, dw, db = blocked_attention_bwd(
            *inputs, g, ctx.heads, ctx.num_radial, out=out,
            dropout_mask=mask, galpha=galpha)
        dq, dk, dv, de = (d.to(p.dtype) for d, p in zip((dq, dk, dv, de),
                                                        inputs))
        # rbf, z (geometry), the ids, the mask, heads, num_radial and
        # return_alpha get none
        return (dq, dk, dv, de, None, dw, db, None, None, None, None, None,
                None, None)


def blocked_attention(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids,
                      heads: int, num_radial: int, dropout_mask=None,
                      return_alpha: bool = False):
    """Fused blocked attention, differentiable in q, k, v, e_atom, w_sbf
    and bias (and through alpha, with `return_alpha`). CUDA tensors run the
    CUDA kernels, CPU tensors the plain versions; a CUDA launch that fails
    raises, nothing falls back. Returns out, or (out, alpha)."""
    _check(q, k, v, e_atom, rbf, w_sbf, bias, z, a_ids, b_ids, heads,
           num_radial, dropout_mask)
    return _BlockedAttention.apply(q, k, v, e_atom, rbf, w_sbf, bias, z,
                                   a_ids, b_ids, dropout_mask, heads,
                                   num_radial, bool(return_alpha))


def reset_launch_counts() -> None:
    """Set the three kernel launch counts, and the forward's and the
    backward's counts per shape and per variant, to 0."""
    blocked_attention.launches = 0
    blocked_attention_bwd_partials.launches = 0
    reduce_partials.launches = 0
    for fn in (blocked_attention, blocked_attention_bwd_partials):
        fn.by_shape = collections.Counter()
        fn.by_variant = collections.Counter()


reset_launch_counts()


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    from x2gnn_tpu_torch.ops import _build
    lib = _build.load(name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "blocked_attn_fwd":
        lib.blocked_attn_fwd.argtypes = [ptr] * 13 + [i32] * 13 + [ptr]
        lib.blocked_attn_fwd.restype = i32
        lib.blocked_attn_fwd_occupancy.argtypes = [i32, i32, i32, ptr]
        lib.blocked_attn_fwd_occupancy.restype = i32
        lib.blocked_attn_error_string = lib.blocked_attn_fwd_error_string
    else:
        lib.blocked_attn_bwd.argtypes = [ptr] * 21 + [i32] * 13 + [ptr]
        lib.blocked_attn_bwd.restype = i32
        lib.blocked_attn_bwd_occupancy.argtypes = [i32, i32, i32, ptr]
        lib.blocked_attn_bwd_occupancy.restype = i32
        lib.blocked_attn_bwd_reduce.argtypes = [ptr, ptr, i32, i32, ptr]
        lib.blocked_attn_bwd_reduce.restype = i32
        lib.blocked_attn_error_string = lib.blocked_attn_bwd_error_string
    lib.blocked_attn_error_string.argtypes = [i32]
    lib.blocked_attn_error_string.restype = ctypes.c_char_p
    return lib
