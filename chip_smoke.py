#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port: builds the port's CUDA
kernels, holds each against its plain PyTorch version on the card, serves
the flagship X2GNN through the port's Predictor, trains it through the
port's Trainer, and times both.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. card: name and power limit from nvidia-smi; no CUDA device -> exit 1;
  2. build: one nvcc per source under x2gnn_tpu_torch/ops/csrc, for
     sm_90a, all started together;
  3. kernels vs plain versions at the serving shape (N=1024, D=24) and at
     a D>40 AID-scale shape (N=512, D=48), on real padded batches: the
     forward (bitwise equal across two runs, exact zeros at dead rows,
     timed, with its launch plan, registers, spills and resident warps per
     SM), and the backward (all six gradients from the checked forward
     output, bitwise equal across two runs, zeros at dead rows) with its
     fixed-order reduce kernel (checked), the kernel alone timed; each
     backward check prints the kernel's launch plan, registers, spills,
     shared memory and resident warps per SM;
  4. serving: the flagship model (4 layers, 128 channels, 16 heads, L=7,
     K=6, 338 edge features, random weights from a seeded generator)
     serves 256 QM9-scale molecules at batch 32, then 16 AID-scale
     molecules at batch 4, counting kernel launches; one batch is checked
     against the same weights on the CPU (plain version);
  5. serving times: kernel and plain version per launch (CUDA events,
     median of 30 after warm-up) and throughput in molecules/s including
     host batching;
  6. training: Trainer.fit, 2 epochs of the flagship recipe as written
     (runs/flagship_r5_regression/args.json: pack_mixed, i.e. mixed-FFD
     packed batches, degree-sorted, one attention launch per degree
     tier) over 512 QM9-scale molecules at batch 32, then the same recipe
     on fixed budgets (pad_budget_for, also tiered) and on fixed budgets
     without split and tiers (Trainer(budgets=...), one window per conv),
     each counting forward, backward and reduce launches against
     conv_layers x the attention windows of its steps and eval batches;
     one step at AID scale (batch 4, a first tier with DK>40) with its
     tiers and as one window; one step on 8 molecules, a tiered batch, on
     the card against the same step on the CPU (loss and every gradient);
     the forward, backward and reduce kernels against their plain
     versions, all three timed, on every tier window of the first packed
     batch (odd DI, 8-row tiers; each with its plan and valid pairs per
     CTA), on that batch as one window, on the one-window fixed-budget
     run's first batch, on the AID-scale step's DK>40 tier and on the
     AID-scale batch as one window; checked with K=9 radial functions (dW
     in shared memory) on the one-window fixed-budget batch and with
     HC=1024 (128 heads of 8) on its geometry, a width whose shared
     memory the first forward kernel could not lay out; the forward also
     at every other head width it takes (C=1, 2, 4, 16, 32) on that
     batch; the reduce timed against partial.sum(0) on the same
     partials;
  7. training times: ms per step (CUDA events around steps on cached
     batches) of the packed batches with their tiers and as one window
     (tiers and split removed), and of the fixed-budget batches with their
     tiers and on the one-window path's batches, each pair in turns, with
     the launches per step; training molecules/s per epoch of the three
     runs.
Each row of the kernels line takes its launches from a path that launches
its shape, with the counts zeroed just before that path.
The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# float32 tolerances of a kernel against its plain version on the card:
# both sum in float32 in different orders (shuffle-tree head sums, FMA
# contraction, an online vs a two-pass softmax denominator) over at most
# DK*L ~ 450 terms, a few ulp each, i.e. ~1e-5 relative in the worst case
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# the backward's gradients sum over up to DI*DK pairs per atom (dq, dk,
# dv, de) and over every pair of the batch (dW, db, ~1e5 terms of both
# signs), in other orders than the plain version: each gradient is held
# to 1e-4 relative plus 1e-5 of its largest magnitude
BWD_RTOL, BWD_ATOL = 1e-4, 1e-5
# card vs CPU predictions of the whole model: float32 matmuls in other
# summation orders through ~20 layers and 5 readouts
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-4
# card vs CPU gradients of one training step: those orders of summation
# in the forward and again in the backward; per parameter 1e-3 relative
# plus 1e-4 of its largest magnitude, as tests/test_torch_port_train.py
# holds the CPU port against JAX (lin_key biases: see
# check_step_on_card_and_cpu)
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 FLOP/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

PALLAS = "x2gnn_tpu/ops/pallas/blocked_attn.py"


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one call of fn, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def backlog_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Device time of one call of fn, for calls shorter than the host's
    launch overhead: a sleep kernel keeps the stream busy while the host
    queues all `reps` calls between two CUDA events, so the events time the
    calls back to back on the device, not the host's enqueue."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)      # ~10 ms of the card's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def valid_pairs(args):
    """(N, DI, DK) bool: the (query, key) pairs of each atom that take part
    in the attention."""
    a_ids, b_ids = args[8], args[9]
    return ((a_ids[:, :, None] != b_ids[:, None, :])
            & (a_ids >= 0)[:, :, None] & (b_ids >= 0)[:, None, :])


def live_input_bytes(args, valid, query_inputs=1):
    """Bytes of the attention inputs that the function's value depends on
    at these ids, each read once: the rows of q (and of `query_inputs` - 1
    more (N, DI, HC) inputs) at query slots in a valid pair, the rows of k,
    v and rbf at key slots in a valid pair, z at the valid pairs, e of the
    atoms with a valid pair, and all of the ids, W and the bias. No other
    row changes an output: a query slot without a valid pair gives 0."""
    q, k, v, e, rbf, w, bias, z, a_ids, b_ids = args
    HC = q.shape[-1]
    q_rows = int(valid.any(dim=2).sum())
    k_rows = int(valid.any(dim=1).sum())
    atoms = int(valid.flatten(1).any(dim=1).sum())
    words = (q_rows * HC * query_inputs + k_rows * (2 * HC + rbf.shape[-1])
             + int(valid.sum()) + atoms * HC + a_ids.numel() + b_ids.numel()
             + w.numel() + bias.numel())
    return 4 * words


def attention_work(args, heads: int, num_radial: int, out_bytes: int):
    """(bytes, FP32 operations, valid pairs) the attention function needs
    on these inputs: the live input rows read once (live_input_bytes) and
    the whole output written once; per valid pair 2L+5 operations per
    channel (score product and sum, L FMAs of the angular sum, message and
    accumulation), one exp per head and 4(L-2) for the Legendre recurrence;
    2*L*K per channel for G of each key that takes part in a valid
    pair."""
    HC = args[0].shape[-1]
    L = args[4].shape[-1] // num_radial
    valid = valid_pairs(args)
    n_pairs = int(valid.sum())
    n_keys = int(valid.any(dim=1).sum())
    ops = (n_pairs * (HC * (2 * L + 5) + heads + 4 * max(L - 2, 0))
           + n_keys * 2 * L * num_radial * HC)
    return live_input_bytes(args, valid) + out_bytes, ops, n_pairs


def kernel_inputs(graphs, batch_size, cfg, device, seed):
    """Attention inputs at the shape serving gives the kernel: the first
    batch of `graphs` padded to the Predictor's quantized budgets."""
    from x2gnn_tpu_torch.data.batching import batch_iterator, pad_budget_for
    from x2gnn_tpu_torch.infer import quantize_budgets

    budgets = quantize_budgets(pad_budget_for(graphs, batch_size))
    batch = next(batch_iterator(graphs, batch_size, budgets=budgets))
    return batch_kernel_inputs(batch.to(device), cfg, seed)


def batch_kernel_inputs(batch, cfg, seed):
    """Attention inputs for a batch on the card, over all of its rows as
    one window: geometry, masks and ids from the batch, activations and
    weights from a seeded numpy generator."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.models.x2gnn import blocked_geometry

    whole = blocked_geometry(dataclasses.replace(
        batch, tiers=(), n_hi=0, d_lo=0), cfg).windows[0]
    device = batch.positions.device
    N, D = batch.in_edges.shape
    HC, LK = cfg.in_channels, cfg.sbf_dim * cfg.rbf_dim
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32)).to(device)

    return (normal(N, D, HC), normal(N, D, HC), normal(N, D, HC),
            normal(N, HC), whole.rbf_env_out, normal(LK, HC, scale=0.3),
            normal(HC), whole.z, whole.a_ids, whole.b_ids)


def fwd_occupancy_line(args, cfg):
    """The forward kernel's launch plan at this shape, what the card gives
    it and how the plan's walk (CTA r takes the atoms r, r + grid, ...)
    spreads the valid pairs over the CTAs, as log lines; returns the
    occupancy dict."""
    import torch
    from x2gnn_tpu_torch.ops.blocked_attn import fwd_occupancy, fwd_plan

    N, DI, HC = args[0].shape
    DK = args[1].shape[1]
    plan = fwd_plan(N, DI, DK, HC, cfg.heads, cfg.sbf_dim, cfg.rbf_dim)
    occ = fwd_occupancy(plan)
    log(f"[fwd plan N={N} DI={DI} DK={DK} HC={HC}] grid {plan.grid} x "
        f"{plan.channel_groups} CTAs of {plan.warpgroups} x {plan.threads} "
        f"threads, {plan.ctas_per_sm} per SM planned, i_chunk "
        f"{plan.i_chunk}, {plan.smem_bytes} B dynamic shared memory; "
        f"{occ['registers']} registers, {occ['spill_bytes']} B spilled, "
        f"{occ['static_smem_bytes']} B static shared; {occ['ctas_per_sm']} "
        f"CTAs = {occ['warps_per_sm']} warps resident per SM")
    per_atom = valid_pairs(args).sum(dim=(1, 2))
    per_cta = per_atom.new_zeros(plan.grid).index_add_(
        0, torch.arange(N, device=per_atom.device) % plan.grid, per_atom)
    log(f"[fwd plan N={N} DI={DI} DK={DK} HC={HC}] valid pairs per CTA: "
        f"max {int(per_cta.max())}, mean {float(per_cta.float().mean()):.1f}"
        f"; per atom: max {int(per_atom.max())}")
    return occ


def check_fwd_kernel(tag, args, cfg, timed):
    """Forward kernel vs plain version on the card: within KERNEL_RTOL /
    KERNEL_ATOL, bitwise equal across two runs, exact zeros at dead query
    rows. Returns (the kernel's output, its JSON record at this shape, or
    None unless `timed`); timed prints the plan and occupancy line."""
    import torch
    from x2gnn_tpu_torch.ops.blocked_attn import (
        blocked_attention_fwd, blocked_attention_plain)

    H, K = cfg.heads, cfg.rbf_dim
    N, DI, HC = args[0].shape
    tag = f"{tag} N={N} DI={DI} DK={args[1].shape[1]} HC={HC}"
    got = blocked_attention_fwd(*args, heads=H, num_radial=K)
    again = blocked_attention_fwd(*args, heads=H, num_radial=K)
    ref = blocked_attention_plain(*args, heads=H, num_radial=K)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp(min=1e-30)).max())
    bad = int((err > KERNEL_ATOL + KERNEL_RTOL * ref.abs()).sum())
    log(f"[fwd {tag}] max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"(|ref| max {float(ref.abs().max()):.3e}), "
        f"{bad} elements outside atol={KERNEL_ATOL} rtol={KERNEL_RTOL}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"fwd {tag}: non-finite output")
    if bad:
        raise AssertionError(f"fwd {tag}: {bad} elements disagree with "
                             "the plain version")
    if not torch.equal(got, again):
        raise AssertionError(f"fwd {tag}: two runs differ")
    dead = args[8] < 0
    if (got[dead] != 0).any():
        raise AssertionError(f"fwd {tag}: a dead query row is not 0")
    log(f"[fwd {tag}] two runs bitwise equal; {int(dead.sum())} dead query "
        "rows exactly 0")
    # the kernel's calls queued behind a sleep kernel: device time back to
    # back, not the host's time to check, plan and launch
    ms = backlog_ms(lambda: blocked_attention_fwd(*args, heads=H,
                                                  num_radial=K))
    nbytes, ops, n_pairs = attention_work(args, H, K, got.numel() * 4)
    bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, ops)
    if not timed:
        log(f"[fwd {tag}] kernel {ms:.4f} ms/launch over {n_pairs} valid "
            f"pairs ({ms / bound_ms:.1f}x its bound)")
        return got, None
    occ = fwd_occupancy_line(args, cfg)
    plain_ms = median_ms(
        lambda: blocked_attention_plain(*args, heads=H, num_radial=K))
    log(f"[fwd {tag}] kernel {ms:.4f} ms/launch, plain {plain_ms:.4f} "
        f"ms; {nbytes} bytes ({t_bytes:.4f} ms at 3.35 TB/s), {ops} FP32 "
        f"ops over {n_pairs} valid pairs ({t_ops:.4f} ms at 67 TFLOP/s); "
        f"{ms / bound_ms:.1f}x its bound")
    return got, {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "max_abs_err": max_abs,
                 "library_ms": None, "warps_per_sm": occ["warps_per_sm"]}


def attention_bwd_work(args, g, out, heads: int, num_radial: int):
    """(bytes, bytes of `out`, FP32 operations, valid pairs) of the
    attention backward on these inputs. The bytes the function needs: the
    live rows of the inputs and of g read once (live_input_bytes, g beside
    q), each gradient (dq, dk, dv, de, dW, db) written whole once; the
    kernel also reads the saved forward output `out` at the live query
    rows, which it reads instead of recomputing it, counted apart. Per
    valid pair 4L+17 operations per channel (score
    product and sum, the L FMAs of s, ds, dv, dalpha, dq and dk FMAs, the L
    FMAs of dG, db), 6 per head (exp, alpha, inner, dscore) and 4(L-2) for
    the Legendre recurrence; per key in a valid pair 4*L*K per channel (G
    and its dW product)."""
    q, k, v, e, rbf, w, bias, z, a_ids, b_ids = args
    HC = q.shape[-1]
    L = rbf.shape[-1] // num_radial
    valid = valid_pairs(args)
    n_pairs = int(valid.sum())
    n_keys = int(valid.any(dim=1).sum())
    ops = (n_pairs * (HC * (4 * L + 17) + 6 * heads + 4 * max(L - 2, 0))
           + n_keys * 4 * L * num_radial * HC)
    grads = [q, k, v, e, w, bias]          # dq, dk, dv, de, dW, db
    nbytes = (live_input_bytes(args, valid, query_inputs=2)
              + sum(t.numel() * 4 for t in grads))
    out_bytes = int(valid.any(dim=2).sum()) * HC * out.element_size()
    return nbytes, out_bytes, ops, n_pairs


def bound(nbytes, ops):
    """(bound ms, what bounds it, bytes ms, operations ms) at the card's
    published peaks."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops


GRAD_NAMES = ("dq", "dk", "dv", "de", "dW", "db")


def bwd_occupancy_line(args, cfg):
    """The backward kernel's launch plan at this shape and what the card
    gives it (registers, spills, shared memory, resident CTAs and warps per
    SM), as one log line; returns the occupancy dict."""
    from x2gnn_tpu_torch.ops.blocked_attn import bwd_occupancy, bwd_plan

    N, DI, HC = args[0].shape
    DK = args[1].shape[1]
    plan = bwd_plan(N, DI, DK, HC, cfg.heads, cfg.sbf_dim, cfg.rbf_dim)
    occ = bwd_occupancy(plan)
    log(f"[bwd plan N={N} DI={DI} DK={DK} K={cfg.rbf_dim}] grid "
        f"{plan.grid} x {plan.channel_groups} CTAs of {plan.warpgroups} x "
        f"{plan.threads} threads, {plan.ctas_per_sm} per SM planned, "
        f"i_chunk {plan.i_chunk}, {plan.smem_bytes} B dynamic shared memory; "
        f"{occ['registers']} registers, {occ['spill_bytes']} B spilled, "
        f"{occ['static_smem_bytes']} B static shared; {occ['ctas_per_sm']} "
        f"CTAs = {occ['warps_per_sm']} warps resident per SM")
    return occ


def check_bwd_kernel(tag, args, cfg, seed, timed, out):
    """Backward kernel and its reduce vs the plain version on the card, for
    g from a seeded generator and `out`, the checked output of the forward
    kernel on `args`: all six
    gradients, bitwise equal across two runs, exact zeros at dead rows,
    the reduce against a float64 sum of the kernel's own partials, and
    the kernel alone timed (backlog_ms). With `timed`, returns the JSON
    records of the backward kernel and of the reduce kernel at this shape:
    the backward's ms is the kernel alone (its ms_with_reduce adds the
    reduce; ms_events is one call at a time by CUDA events), its bound
    (without the saved output's bytes; bound_ms_with_saved_out with them)
    and plain version are those of the whole backward."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.ops.blocked_attn import (
        blocked_attention_bwd, blocked_attention_bwd_partials,
        blocked_attention_bwd_plain, reduce_partials)

    H, K = cfg.heads, cfg.rbf_dim
    g = torch.from_numpy(np.random.default_rng(seed).normal(
        size=tuple(args[0].shape)).astype(np.float32)).to(args[0].device)
    tag = (f"{tag} N={args[0].shape[0]} DI={args[0].shape[1]} "
           f"DK={args[1].shape[1]}")
    occ = bwd_occupancy_line(args, cfg)
    got = blocked_attention_bwd(*args, g, heads=H, num_radial=K, out=out)
    again = blocked_attention_bwd(*args, g, heads=H, num_radial=K, out=out)
    ref = blocked_attention_bwd_plain(*args, g, heads=H, num_radial=K,
                                      out=out)
    torch.cuda.synchronize()
    max_abs = 0.0
    for name, a, b in zip(GRAD_NAMES, got, ref):
        err = (a - b).abs()
        scale = float(b.abs().max())
        limit = BWD_ATOL * scale + BWD_RTOL * b.abs()
        bad = int((err > limit).sum())
        log(f"[bwd {tag}] {name} {tuple(a.shape)}: max_abs_err="
            f"{float(err.max()):.3e} (|ref| max {scale:.3e}), {bad} elements "
            f"outside {BWD_ATOL}*max|ref| + {BWD_RTOL}*|ref|")
        if not torch.isfinite(a).all():
            raise AssertionError(f"bwd {tag}: non-finite {name}")
        if bad:
            raise AssertionError(f"bwd {tag}: {bad} elements of {name} "
                                 "disagree with the plain version")
        max_abs = max(max_abs, float(err.max()))
    for name, a, b in zip(GRAD_NAMES, got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"bwd {tag}: {name} differs between two "
                                 "runs")
    log(f"[bwd {tag}] two runs give bitwise-equal dq, dk, dv, de, dW, db")
    # dead rows and pad keys get exactly zero
    dead_q = args[8] < 0
    dead_k = args[9] < 0
    if (got[0][dead_q] != 0).any() or (got[1][dead_k] != 0).any() \
            or (got[2][dead_k] != 0).any():
        raise AssertionError(f"bwd {tag}: dead rows got a gradient")
    # the reduce on the kernel's own partials
    partial = blocked_attention_bwd_partials(*args, g, heads=H,
                                             num_radial=K, out=out)[-1]
    red = reduce_partials(partial)
    red_err = float((red.double() - partial.double().sum(0)).abs().max())
    tol = 1e-5 * float(partial.abs().sum(0).max())
    log(f"[reduce {tag}] {tuple(partial.shape)} partials: max_abs_err="
        f"{red_err:.3e} against a float64 sum (limit {tol:.3e})")
    if red_err > tol or not torch.equal(red, reduce_partials(partial)):
        raise AssertionError(f"reduce {tag}: wrong or not reproducible")
    # device time back to back (the tier windows are shorter than the
    # host's time to allocate the gradients and launch)
    ms = backlog_ms(lambda: blocked_attention_bwd_partials(
        *args, g, heads=H, num_radial=K, out=out))
    nbytes, out_bytes, ops, n_pairs = attention_bwd_work(args, g, out, H, K)
    if not timed:
        log(f"[bwd {tag}] kernel {ms:.4f} ms/launch over {n_pairs} valid "
            "pairs")
        return None

    with_reduce = backlog_ms(lambda: blocked_attention_bwd(
        *args, g, heads=H, num_radial=K, out=out))
    # one call at a time by CUDA events: the host's launch time in it
    ms_events = median_ms(lambda: blocked_attention_bwd_partials(
        *args, g, heads=H, num_radial=K, out=out))
    plain_ms = median_ms(lambda: blocked_attention_bwd_plain(
        *args, g, heads=H, num_radial=K, out=out))
    bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, ops)
    with_out_ms = bound(nbytes + out_bytes, ops)[0]
    log(f"[bwd {tag}] kernel {ms:.4f} ms/launch ({ms_events:.4f} ms timed "
        f"one call at a time), kernel+reduce {with_reduce:.4f} ms, plain "
        f"{plain_ms:.4f} ms; {nbytes} bytes "
        f"({t_bytes:.4f} ms at 3.35 TB/s; {with_out_ms:.4f} ms with the saved"
        f" out's {out_bytes} bytes), {ops} FP32 ops over {n_pairs} valid "
        f"pairs ({t_ops:.4f} ms at 67 TFLOP/s); kernel alone "
        f"{ms / bound_ms:.1f}x its bound")
    bwd = {"ms": ms, "ms_with_reduce": with_reduce, "ms_events": ms_events,
           "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_ms_with_saved_out": with_out_ms, "max_abs_err": max_abs,
           "library_ms": None, "warps_per_sm": occ["warps_per_sm"]}
    # reduce and partial.sum(0) on the same partials, in turns, timed on
    # the device back to back (both are shorter than a launch's host time)
    r_ms = backlog_ms(lambda: reduce_partials(partial))
    r_plain = backlog_ms(lambda: partial.sum(0))
    r_ms2 = backlog_ms(lambda: reduce_partials(partial))
    r_plain2 = backlog_ms(lambda: partial.sum(0))
    r_bound, r_by, _, _ = bound(partial.numel() * 4 + red.numel() * 4,
                                partial.numel())
    log(f"[reduce {tag}] kernel {r_ms:.4f} / {r_ms2:.4f} ms, partial.sum(0) "
        f"{r_plain:.4f} / {r_plain2:.4f} ms (two turns), bound {r_bound:.4f} "
        f"ms ({r_by})")
    verdict = ("no slower than" if max(r_ms, r_ms2) <= min(r_plain, r_plain2)
               else "slower than")
    log(f"[reduce {tag}] the kernel is {verdict} partial.sum(0) in both "
        "turns")
    reduce = {"ms": r_ms, "plain_ms": r_plain, "bound_ms": r_bound,
              "bound_by": r_by, "max_abs_err": red_err, "library_ms": r_plain}
    return bwd, reduce


def check_window(tag, args, cfg, seed, fwd_timed=False, bwd_timed=False):
    """The forward kernel checked on `args`, then the backward from its
    output; returns (forward record, backward records), each None unless
    timed."""
    out, fwd = check_fwd_kernel(tag, args, cfg, fwd_timed)
    return fwd, check_bwd_kernel(tag, args, cfg, seed, bwd_timed, out)


def window_args(args, window):
    """Attention inputs cut to one window (b0, b1, di, dk): atom rows
    [b0, b1), their first di query and dk key slots, contiguous, as the
    conv cuts them (W and the bias stay)."""
    b0, b1, di, dk = window
    q, k, v, e, rbf, w, bias, z, a_ids, b_ids = args
    r = slice(b0, b1)
    return (q[r, :di].contiguous(), k[r, :dk].contiguous(),
            v[r, :dk].contiguous(), e[r].contiguous(),
            rbf[r, :dk].contiguous(), w, bias, z[r, :di, :dk].contiguous(),
            a_ids[r, :di].contiguous(), b_ids[r, :dk].contiguous())


def windows_of(batch):
    """The attention windows (b0, b1, di, dk) the conv runs on a batch."""
    from x2gnn_tpu_torch.models.x2gnn import attention_windows
    N, D = batch.in_edges.shape
    return attention_windows(N, D, batch.n_hi, batch.d_lo, batch.tiers)


def window_shape(window):
    """(N, DI, DK) of the kernel call on a window (b0, b1, di, dk)."""
    b0, b1, di, dk = window
    return (b1 - b0, di, dk)


def n_windows(batches):
    """Attention kernel calls per conv layer over `batches`."""
    return sum(len(windows_of(b)) for b in batches)


def serve(pred, graphs, expect_launches, tag):
    """One run of the serving path with the launch count zeroed just
    before it and read just after."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.ops.blocked_attn import blocked_attention

    blocked_attention.launches = 0
    out = pred.predict(graphs)
    torch.cuda.synchronize()
    launches = blocked_attention.launches
    log(f"[serve {tag}] {len(graphs)} molecules -> {out.shape} predictions,"
        f" {launches} kernel launches (expected {expect_launches})")
    if out.shape != (len(graphs),) or not np.isfinite(out).all():
        raise AssertionError(f"serve {tag}: bad predictions {out}")
    if launches != expect_launches:
        raise AssertionError(f"serve {tag}: {launches} launches, expected "
                             f"{expect_launches}")
    return out, launches


def launch_counts():
    from x2gnn_tpu_torch.ops.blocked_attn import (
        blocked_attention, blocked_attention_bwd_partials, reduce_partials)
    return {"fwd": blocked_attention.launches,
            "bwd": blocked_attention_bwd_partials.launches,
            "reduce": reduce_partials.launches}


def launch_shapes():
    """{"fwd": {...}, "bwd": {...}}: launches per (N, DI, DK)."""
    from x2gnn_tpu_torch.ops.blocked_attn import (
        blocked_attention, blocked_attention_bwd_partials)
    return {"fwd": dict(blocked_attention.by_shape),
            "bwd": dict(blocked_attention_bwd_partials.by_shape)}


def one_window_budgets(graphs, batch_size):
    """`pad_budget_for` without the two-tier split and the tiers: the
    fixed budgets of the earlier slices, which a caller gets by passing
    them as `Trainer(budgets=...)`. Its batches are not degree-sorted and
    run one attention window per conv."""
    from x2gnn_tpu_torch.data.batching import pad_budget_for
    return pad_budget_for(graphs, batch_size)._replace(
        n_deg_lo=0, n_hi=0, tiers=())


def train_flagship(mcfg, tcfg, graphs, device, tag, budgets=None):
    """Phase 6a-6c: Trainer.fit over `graphs` for tcfg.max_epoch epochs in
    a temporary workdir, with every launch count zeroed just before and
    read just after. Checks finite losses, no skipped step, one metrics
    record per epoch and launches = conv_layers x the attention windows
    (one per non-empty degree tier) of the train steps, for the forward
    also of the eval batches. Returns (trainer, state, records, counts,
    counts per shape)."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.train.trainer import Trainer

    targets = np.array([g.y[0] for g in graphs], np.float32)
    model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)
    with tempfile.TemporaryDirectory() as workdir:
        trainer = Trainer(model, mcfg, tcfg, graphs, targets,
                          workdir=workdir, budgets=budgets, device=device)
        log(f"[train {tag}] {len(trainer.train_idx)} train / "
            f"{len(trainer.val_idx)} val / {len(trainer.test_idx)} test "
            f"molecules, base budgets {tuple(trainer.budgets)}")
        reset_launch_counts()
        state, summary = trainer.fit(epochs=tcfg.max_epoch)
        torch.cuda.synchronize()
        counts, shapes = launch_counts(), launch_shapes()
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        files = sorted(os.listdir(workdir))
    for r in records:
        log(f"[train {tag}] epoch {r['epoch']}: loss {r['loss']:.6f} "
            f"val_mae {r['val_mae']:.6f} test_mae {r['test_mae']} step "
            f"{r['step']} bad_steps {r['bad_steps']} {r['seconds']:.3f} s "
            f"{r['molecules_per_sec']:.1f} molecules/s, occupancy pairs "
            f"{r.get('occupancy_pairs')}")
    log(f"[train {tag}] summary {json.dumps(summary)}; workdir files "
        f"{files}")
    if len(records) != tcfg.max_epoch:
        raise AssertionError(f"train {tag}: {len(records)} metrics records")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["val_mae"])
               for r in records):
        raise AssertionError(f"train {tag}: non-finite loss or val MAE")
    if int(state.bad_steps) != 0 or records[-1]["bad_steps"] != 0:
        raise AssertionError(f"train {tag}: a step was skipped")
    epochs = tcfg.max_epoch
    train_b = trainer.batches(trainer.train_idx)
    steps = len(train_b) * epochs
    improved = sum(r["test_mae"] is not None and r["val_mae"]
                   == r["best_val_mae"] for r in records)
    val_b = trainer.batches(trainer.val_idx)
    test_b = trainer.batches(trainer.test_idx)
    train_w = n_windows(train_b) * epochs
    eval_w = n_windows(val_b) * epochs + n_windows(test_b) * improved
    L = mcfg.conv_layers
    expect = {"fwd": L * (train_w + eval_w), "bwd": L * train_w,
              "reduce": L * train_w}
    b0 = train_b[0]
    n, d = b0.in_edges.shape
    log(f"[train {tag}] {len(train_b)} train batches of N={n}, D={d}, "
        f"{b0.y.shape[0]} graph slots, tiers {b0.tiers}, split (n_hi="
        f"{b0.n_hi}, d_lo={b0.d_lo}); {len(val_b)} val and {len(test_b)} "
        "test batches")
    log(f"[train {tag}] launches {counts} (expected {expect}: {L} layers x "
        f"{train_w} windows of {steps} steps, + {eval_w} windows of "
        f"{len(val_b) * epochs + len(test_b) * improved} eval batches for "
        f"the forward)")
    if counts != expect or int(state.step) != steps:
        raise AssertionError(f"train {tag}: launches {counts}, expected "
                             f"{expect}, step {int(state.step)} of {steps}")
    return trainer, state, records, counts, shapes


def train_one_step(mcfg, tcfg, graphs, device, tag, budgets=None):
    """One training step on the first batch of `graphs` with every count
    zeroed before and read after: conv_layers launches of each kernel per
    attention window. Returns (the batch, counts, counts per shape)."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.train.trainer import Trainer

    targets = np.array([g.y[0] for g in graphs], np.float32)
    model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)
    trainer = Trainer(model, mcfg, tcfg, graphs, targets,
                      workdir="unused", budgets=budgets, device=device)
    batch = trainer.batches(trainer.train_idx)[0]
    state = trainer.init_state()
    reset_launch_counts()
    state, loss = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    counts, shapes = launch_counts(), launch_shapes()
    shape = tuple(batch.in_edges.shape)
    log(f"[train {tag}] one step at N, D = {shape}, windows "
        f"{windows_of(batch)}: loss {float(loss):.6f}, launches {counts}")
    n = mcfg.conv_layers * len(windows_of(batch))
    if not math.isfinite(float(loss)) or int(state.bad_steps):
        raise AssertionError(f"train {tag}: non-finite loss")
    if counts != {"fwd": n, "bwd": n, "reduce": n}:
        raise AssertionError(f"train {tag}: launches {counts}")
    return batch, counts, shapes


def check_step_on_card_and_cpu(mcfg, graphs, device):
    """Phase 6c: the loss and the gradient of every parameter of one
    training step on 8 molecules, on the card (CUDA kernels) and on the
    CPU (plain versions), from the same weights. The lin_key biases shift
    every score of a query alike, which the softmax ignores: their
    gradient is 0 in exact arithmetic and rounding noise on both sides,
    held below 1e-6 of the largest gradient instead."""
    import torch
    from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss

    model = X2GNN(mcfg, torch.Generator().manual_seed(4), device=device)
    cpu_model = copy.deepcopy(model).to("cpu")
    batch = pad_graphs(graphs, pad_budget_for(graphs, len(graphs)))
    if len(windows_of(batch)) < 2:
        raise AssertionError(f"card vs cpu: the batch has no degree tiers "
                             f"({batch.tiers})")

    def grads(m, dev):
        b = batch.to(dev)
        loss = smooth_l1_loss(m(b), b.y, mask=b.graph_mask)
        g = torch.autograd.grad(loss, list(m.parameters()))
        return loss.item(), {n: t.detach().cpu() for (n, _), t in
                             zip(m.named_parameters(), g)}

    loss, g_card = grads(model, device)
    t0 = time.perf_counter()
    cpu_loss, g_cpu = grads(cpu_model, "cpu")
    log(f"[card vs cpu] one step on {len(graphs)} molecules, N, D = "
        f"{tuple(batch.in_edges.shape)}, tiers {batch.tiers}: loss "
        f"{loss:.7f} card, "
        f"{cpu_loss:.7f} CPU ({time.perf_counter() - t0:.1f} s on the CPU)")
    if abs(loss - cpu_loss) > 1e-5 * abs(cpu_loss):
        raise AssertionError("card vs cpu: losses differ")
    top = max(float(t.abs().max()) for t in g_cpu.values())
    worst = (0.0, "")
    for name, ref in g_cpu.items():
        got = g_card[name]
        err = (got - ref).abs()
        if name.endswith("lin_key.bias"):
            if max(float(got.abs().max()), float(ref.abs().max())) \
                    >= 1e-6 * top:
                raise AssertionError(f"card vs cpu: {name} not ~0")
            continue
        limit = GRAD_ATOL * float(ref.abs().max()) + GRAD_RTOL * ref.abs()
        if (err > limit).any() or not torch.isfinite(got).all():
            raise AssertionError(f"card vs cpu: gradient of {name} differs"
                                 f" (max abs {float(err.max()):.3e})")
        rel = float(err.max()) / max(float(ref.abs().max()), 1e-30)
        worst = max(worst, (rel, name))
    log(f"[card vs cpu] {len(g_cpu)} gradients agree within {GRAD_RTOL} "
        f"relative + {GRAD_ATOL} of each one's largest magnitude; largest "
        f"max|err|/max|g| {worst[0]:.3e} ({worst[1]})")


def step_ms(trainer, state, batches, reps: int = 20):
    """Median ms of one training step on `batches` (cached on the card),
    by CUDA events around each step, after 3 steps of warm-up. Returns
    (ms, state, steps run)."""
    import torch
    pairs = []
    for i in range(reps + 3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = trainer.train_step(state, batches[i % len(batches)])
        end.record()
        if i >= 3:
            pairs.append((start, end))
    torch.cuda.synchronize()
    return (statistics.median(s.elapsed_time(e) for s, e in pairs), state,
            reps + 3)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke test runs only on the "
              "card", file=sys.stderr)
        return 1

    import numpy as np
    from x2gnn_tpu_torch.config import ModelConfig
    from x2gnn_tpu_torch.data.batching import batch_iterator, pad_budget_for
    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    from x2gnn_tpu_torch.device import resolve_device
    from x2gnn_tpu_torch.infer import Predictor, quantize_budgets
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.ops import _build
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.profile_training import flagship_training_configs

    # ---- 1. card ----
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = resolve_device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    for name, built in _build.build_all().items():
        log(f"[build] {name}: {built.seconds:.2f} s nvcc -> {built.path}")
        for line in built.log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] total {time.perf_counter() - t0:.2f} s (one nvcc per "
        "source, in parallel)")

    cfg = ModelConfig(attention_layout="blocked")   # the flagship
    qm9 = synthetic_dataset(256, mean_atoms=18, seed=11)
    aid = synthetic_dataset(16, mean_atoms=64, seed=3)

    # ---- 3. kernels against their plain versions ----
    serving_args = kernel_inputs(qm9, 32, cfg, device, seed=1)
    aid_args = kernel_inputs(aid, 4, cfg, device, seed=2)
    if tuple(serving_args[0].shape[:2]) != (1024, 24):
        raise AssertionError(f"serving shape {serving_args[0].shape}")
    if aid_args[1].shape[1] <= 40:
        raise AssertionError(f"AID-scale shape {aid_args[1].shape} is not "
                             "D > 40")
    records = {}
    records["serving"], _ = check_window("serving", serving_args, cfg,
                                         seed=21, fwd_timed=True)
    records["aid"], _ = check_window("AID", aid_args, cfg, seed=22,
                                     fwd_timed=True)

    # ---- 4. serving ----
    model = X2GNN(cfg, torch.Generator().manual_seed(0), device=device)
    pred = Predictor(cfg, model, batch_size=32, device=device)
    n_batches = math.ceil(len(qm9) / 32)
    out, launches_qm9 = serve(pred, qm9, cfg.conv_layers * n_batches,
                              "QM9-scale")
    aid_pred = Predictor(cfg, model, batch_size=4, device=device)
    _, launches_aid = serve(aid_pred, aid,
                            cfg.conv_layers * math.ceil(len(aid) / 4),
                            "AID-scale")
    cpu_model = copy.deepcopy(model)
    cpu_out = Predictor(cfg, cpu_model, batch_size=32,
                        device="cpu").predict(qm9[:32])
    diff = np.abs(out[:32] - cpu_out)
    log(f"[serve] card vs CPU on 32 molecules: max_abs={diff.max():.3e} "
        f"max_rel={(diff / np.abs(cpu_out)).max():.3e} "
        f"(|pred| max {np.abs(cpu_out).max():.3e})")
    np.testing.assert_allclose(out[:32], cpu_out, rtol=MODEL_RTOL,
                               atol=MODEL_ATOL)

    # ---- 5. serving times ----
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        pred.predict(qm9)
    dt = (time.perf_counter() - t0) / iters
    log(f"[serve] throughput {len(qm9) / dt:.1f} molecules/s "
        f"({dt * 1e3:.2f} ms per {len(qm9)} molecules, batch 32, "
        "incl. host batching)")
    budgets = quantize_budgets(pad_budget_for(qm9, 32))
    t0 = time.perf_counter()
    for _ in range(iters):
        for batch in batch_iterator(qm9, 32, budgets=budgets):
            batch.to(device)
    torch.cuda.synchronize()
    dt_host = (time.perf_counter() - t0) / iters
    log(f"[serve] of which host batching + copy to the card: "
        f"{dt_host * 1e3:.2f} ms per {len(qm9)} molecules")

    # ---- 6. training ----
    mcfg, tcfg = flagship_training_configs()
    tcfg = dataclasses.replace(tcfg, max_epoch=2)
    log("[train] flagship recipe from runs/flagship_r5_regression/args.json"
        f", max_epoch=2: {json.dumps(dataclasses.asdict(tcfg))}")
    if mcfg != cfg or not tcfg.pack_mixed:
        raise AssertionError(f"flagship configs {mcfg}, {tcfg}")
    train_graphs = synthetic_dataset(512, mean_atoms=18, seed=11)
    # 6a: the recipe as written: mixed-FFD packed batches, degree tiers
    packed, pstate, packed_records, packed_counts, packed_shapes = \
        train_flagship(mcfg, tcfg, train_graphs, device, "packed")
    # 6b: the same recipe on fixed budgets (pad_budget_for), also tiered
    fixed, fstate, fixed_records, _, _ = train_flagship(
        mcfg, dataclasses.replace(tcfg, pack_mixed=False), train_graphs,
        device, "fixed")
    # 6c: fixed budgets without split and tiers, Trainer(budgets=...): one
    # window per conv, the fixed-budget path of the earlier slices
    fixed_one, _, fixed_one_records, fixed_one_counts, _ = train_flagship(
        mcfg, dataclasses.replace(tcfg, pack_mixed=False), train_graphs,
        device, "fixed one window", budgets=one_window_budgets(
            train_graphs, tcfg.batch_size))
    # 6d: one step at AID scale with its tiers, and as one window
    aid_tcfg = dataclasses.replace(tcfg, pack_mixed=False, batch_size=4)
    aid_batch, _, aid_shapes = train_one_step(mcfg, aid_tcfg, aid, device,
                                              "AID")
    aid_tier = windows_of(aid_batch)[0]
    if aid_tier[3] <= 40:
        raise AssertionError(f"AID-scale training tier {aid_tier} is not "
                             "DK > 40")
    aid_one_batch, aid_one_counts, _ = train_one_step(
        mcfg, aid_tcfg, aid, device, "AID one window",
        budgets=one_window_budgets(aid, 4))
    check_step_on_card_and_cpu(mcfg, qm9[:8], device)
    # the forward, backward and reduce kernels against their plain
    # versions, and timed, on every tier window of the first packed batch
    packed_batches = packed.batches(packed.train_idx)
    packed_args = batch_kernel_inputs(packed_batches[0], mcfg, seed=23)
    tiers = []
    for t, win in enumerate(windows_of(packed_batches[0])):
        fwd, (bwd, red) = check_window(
            f"packed tier {t}", window_args(packed_args, win), mcfg,
            seed=40 + t, fwd_timed=True, bwd_timed=True)
        tiers.append((win, fwd, bwd, red))
    # the same batch as one window, the alternative the tiers replace (no
    # path launches it: logged beside the tiers, not a row of its own)
    packed_one_fwd, (packed_one_bwd, _) = check_window(
        "packed one window", packed_args, mcfg, seed=24, fwd_timed=True,
        bwd_timed=True)
    # the one-window fixed-budget path's first batch, as the earlier
    # slices checked and timed the training kernels
    train_batch = fixed_one.batches(fixed_one.train_idx)[0]
    records["fwd_train"], (records["bwd"], records["reduce"]) = check_window(
        "train", batch_kernel_inputs(train_batch, mcfg, seed=27), mcfg,
        seed=24, fwd_timed=True, bwd_timed=True)
    # the AID-scale step: its D > 40 tier, and the whole batch as one
    # window (more atoms than CTAs, several per CTA with i-chunks)
    aid_args = batch_kernel_inputs(aid_batch, mcfg, seed=25)
    records["fwd_aid_tier"], (records["bwd_aid_tier"], _) = check_window(
        "train AID tier 0", window_args(aid_args, aid_tier), mcfg, seed=26,
        fwd_timed=True, bwd_timed=True)
    _, (records["bwd_aid"], _) = check_window(
        "train AID", batch_kernel_inputs(aid_one_batch, mcfg, seed=25), mcfg,
        seed=26, bwd_timed=True)
    # K = 9 radial functions, beyond the backward's 6 in registers: dW in
    # shared memory, on the same batch
    cfg_k9 = dataclasses.replace(mcfg, rbf_dim=9)
    check_window("train K=9", batch_kernel_inputs(train_batch, cfg_k9,
                                                  seed=28), cfg_k9, seed=29)
    # HC = 1024 (128 heads of 8) on the same geometry: 8 channel groups
    # along grid.y; the first forward kernel's shared memory grew with HC
    # and refused this width. The backward on its first 256 atoms, which
    # keeps the plain version's (N, D, D, HC) tensors to ~1 GB each.
    cfg_wide = dataclasses.replace(mcfg, in_channels=1024, heads=128)
    wide_args = batch_kernel_inputs(train_batch, cfg_wide, seed=30)
    check_fwd_kernel("train HC=1024", wide_args, cfg_wide, timed=False)
    n_slots = wide_args[0].shape[1]
    check_window("train HC=1024", window_args(wide_args,
                                              (0, 256, n_slots, n_slots)),
                 cfg_wide, seed=31)
    del wide_args
    # every other head width the kernel takes, on the same batch: C = 1, 2
    # (scalar scores), 4, 16, 32 (16-byte loads), beside the flagship's 8
    for heads in (128, 64, 32, 8, 4):
        cfg_c = dataclasses.replace(mcfg, heads=heads)
        check_fwd_kernel(f"train C={mcfg.in_channels // heads}",
                         batch_kernel_inputs(train_batch, cfg_c, seed=32),
                         cfg_c, timed=False)

    # ---- 7. training times ----
    # the packed step with its tiers and as one window per conv (the same
    # sorted batches, split and tiers removed); the fixed-budget step with
    # its tiers and on the one-window path's batches; each on one model and
    # its weights, in turns
    one_window = [dataclasses.replace(b, tiers=(), n_hi=0, d_lo=0)
                  for b in packed_batches]
    fixed_batches = fixed.batches(fixed.train_idx)
    fixed_one_batches = fixed_one.batches(fixed_one.train_idx)
    for tag, trainer, state, tiered, untiered in (
            ("packed", packed, pstate, packed_batches, one_window),
            ("fixed", fixed, fstate, fixed_batches, fixed_one_batches)):
        turns = {}
        for name, batches in (("tiers", tiered), ("one window", untiered),
                              ("one window", untiered), ("tiers", tiered)):
            reset_launch_counts()
            ms, state, steps = step_ms(trainer, state, batches)
            per_step = {k: v / steps for k, v in launch_counts().items()}
            log(f"[train {tag}] {name}: {ms:.3f} ms per training step "
                f"(median of 20, CUDA events, cached on the card), launches "
                f"per step {per_step}")
            turns.setdefault(name, []).append(ms)
        n, d = tiered[0].in_edges.shape
        log(f"[train {tag}] with tiers {turns['tiers'][0]:.3f} / "
            f"{turns['tiers'][1]:.3f} ms per step, one window "
            f"{turns['one window'][0]:.3f} / {turns['one window'][1]:.3f} ms"
            f" (N={n}, D={d}, {tiered[0].y.shape[0]} graph slots)")
    for tag, recs in (("packed", packed_records), ("fixed", fixed_records),
                      ("fixed one window", fixed_one_records)):
        log(f"[train {tag}] training molecules/s per epoch (wall clock, "
            "incl. eval and checkpoints): " + ", ".join(
                f"epoch {r['epoch']} {r['molecules_per_sec']:.1f}"
                for r in recs))
    for win, fwd, bwd, red in tiers:
        log(f"[train packed] tier {win}: forward {fwd['ms']:.4f} ms, "
            f"backward {bwd['ms']:.4f} ms (with the reduce "
            f"{bwd['ms_with_reduce']:.4f}), reduce {red['ms']:.4f} ms")
    log(f"[train packed] one window: forward {packed_one_fwd['ms']:.4f} ms, "
        f"backward {packed_one_bwd['ms']:.4f} ms (with the reduce "
        f"{packed_one_bwd['ms_with_reduce']:.4f}); AID tier {aid_tier}: "
        f"forward {records['fwd_aid_tier']['ms']:.4f} ms, backward "
        f"{records['bwd_aid_tier']['ms']:.4f} ms (device time back to back)")

    fwd_src = "x2gnn_tpu_torch/ops/csrc/blocked_attn_fwd.cu"
    bwd_src = "x2gnn_tpu_torch/ops/csrc/blocked_attn_bwd.cu"

    def by_events(rec):
        # the backward rows of the earlier slices are timed one call at a
        # time by CUDA events; the device time back to back beside it
        return {**rec, "ms": rec["ms_events"], "ms_backlog": rec["ms"]}

    aid_note = f"AID-scale step, tier {aid_tier}"
    kernels = [
        {"name": "blocked_attn_fwd", "route": "cuda", "source": fwd_src,
         "replaces": f"{PALLAS}:166", "launches": launches_qm9,
         **records["serving"]},
        {"name": "blocked_attn_fwd (D>40)", "route": "cuda",
         "source": fwd_src, "replaces": f"{PALLAS}:282",
         "launches": launches_aid, **records["aid"]},
        {"name": "blocked_attn_fwd (training)", "route": "cuda",
         "source": fwd_src, "replaces": f"{PALLAS}:166",
         "launches": fixed_one_counts["fwd"], **records["fwd_train"]},
        {"name": "blocked_attn_bwd", "route": "cuda", "source": bwd_src,
         "replaces": f"{PALLAS}:198", "launches": fixed_one_counts["bwd"],
         **by_events(records["bwd"])},
        {"name": "blocked_attn_bwd (D>40)", "route": "cuda",
         "source": bwd_src, "replaces": f"{PALLAS}:346",
         "launches": aid_one_counts["bwd"], **by_events(records["bwd_aid"])},
        {"name": "blocked_attn_bwd_reduce", "route": "cuda",
         "source": bwd_src, "replaces": f"{PALLAS}:271",
         "launches": fixed_one_counts["reduce"], **records["reduce"]},
        {"name": "blocked_attn_fwd (D>40, training tier)", "route": "cuda",
         "source": fwd_src, "replaces": f"{PALLAS}:282",
         "launches": aid_shapes["fwd"][window_shape(aid_tier)],
         "window": aid_note, **records["fwd_aid_tier"]},
        {"name": "blocked_attn_bwd (D>40, training tier)", "route": "cuda",
         "source": bwd_src, "replaces": f"{PALLAS}:346",
         "launches": aid_shapes["bwd"][window_shape(aid_tier)],
         "window": aid_note, **records["bwd_aid_tier"]},
    ]
    for t, (win, fwd, bwd, _) in enumerate(tiers):
        ichunk = win[3] > 40      # the reference's i-chunked kernels
        note = f"packed tier {t}, {win} of the first packed batch"
        kernels += [
            {"name": f"blocked_attn_fwd (packed tier {t})", "route": "cuda",
             "source": fwd_src,
             "replaces": f"{PALLAS}:{282 if ichunk else 166}",
             "launches": packed_shapes["fwd"].get(window_shape(win), 0),
             "window": note, **fwd},
            {"name": f"blocked_attn_bwd (packed tier {t})", "route": "cuda",
             "source": bwd_src,
             "replaces": f"{PALLAS}:{346 if ichunk else 198}",
             "launches": packed_shapes["bwd"].get(window_shape(win), 0),
             "window": note, **bwd}]
    # the reduce's count is not kept per shape: one row for the packed run,
    # timed on the partials of its largest tier
    win, _, _, red = max(tiers, key=lambda t: t[0][1] - t[0][0])
    kernels.append(
        {"name": "blocked_attn_bwd_reduce (packed tiers)", "route": "cuda",
         "source": bwd_src, "replaces": f"{PALLAS}:271",
         "launches": packed_counts["reduce"],
         "window": f"partials of packed tier {win}", **red})
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise AssertionError(f"rows not launched on their path: {idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
