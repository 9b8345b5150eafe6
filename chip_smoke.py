#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port: builds the port's CUDA
kernels, holds each against its plain PyTorch version on the card, serves
the flagship X2GNN through the port's Predictor, trains it through the
port's Trainer, in all three attention layouts and both variants and on
its parallel paths, and times them.

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
     runs;
  8. determinism, resume and a trained run's files, with the flagship
     recipe as written on the same 512 molecules: (a) the training step
     on the first packed batch (N=744, D=32, 8 tiers) repeated by
     utils/determinism.py::check_train_step_determinism must be bitwise
     equal (the earlier index_add_ segment sums are checked beside it and
     reported), and two predict calls on the 256 molecules too, after
     segment_sum itself on the card (against the CPU, a rerun bitwise, a
     NaN row spoiling its own segment only); the
     packed step's device busy time with the fixed-order segment sums and
     with index_add_, in turns; (b) 2 epochs straight against 1 epoch,
     Trainer.restore of its ckpt_last.pt in a fresh Trainer and 1 more:
     the metrics records equal field for field (but the wall clock's),
     and equal to phase 6a's, parameters, EMA and moments bitwise, the
     resumed epoch's launches counted, the restore timed; (c) a graph
     cache of the molecules, `python -m x2gnn_tpu_torch.train --data-npz
     ... --epochs 1` and then `--auto-resume --epochs 2` as subprocesses,
     `python -m x2gnn_tpu_torch.evaluate` on the run (its seconds, one
     cold pass), its MAE against Predictor.from_run's within 1e-6
     relative, and evaluate's loop timed warm in-process; (d) from_run
     timed, serving the 256 molecules with 4 launches per batch, bitwise
     equal to a Predictor on the EMA weights that Trainer.restore gives,
     one batch against the CPU; (e) the EMA weights exported to a
     reference-named .pth and imported into a fresh model, bitwise.
  9. the gap recipe (runs/gap_r5_50k/args.json: the flagship's width and
     packing, molwise_mean readout, attention dropout 0.1): (c) Trainer.fit
     2 epochs on the same 512 molecules (cut from 200 epochs on 50k
     molecules), the drop instances of both kernels launched conv_layers x
     the windows of every training step and the plain forward in every
     evaluation; the step with dropout repeated bitwise; 1 + 1 resumed
     epochs against 2, bitwise; `python -m x2gnn_tpu_torch.train
     --config runs/gap_r5_50k/args.json --pack-mixed` for 1 epoch as a
     subprocess; ms per step in turns with the flagship's packed step; (b) one step on the card against the CPU under the same
     explicit masks (phase 6c's gate); a gap step at AID scale (the drop
     instances at its DK>40 tier); (d) the first conv with
     return_attention_weights on the first packed batch and a loss of its
     alpha (the drop+alpha forward and drop+galpha backward); (a) the
     four instances (fwd drop, drop+alpha; bwd drop, drop+galpha) against
     their plain versions under seeded masks at rates 0.1 and 0.4, with
     phase 3's tolerances and bitwise reruns, on every tier window of the
     first packed batch (timed in turns with the instance without mask),
     that batch as one window, and the AID step's DK>40 tier (timed),
     and on 128 atoms of phase 6's HC=1024 batch (8 channel groups).
 10. the flagship recipe's precision and memory options (train.py
     --compute-dtype bfloat16, --feat-dtype float16|int8, --remat,
     --accum-steps): (b) Trainer.fit 1 epoch with the bf16 conv stack on
     float16 features, only bf16 instances launched, 32 bf16 forwards,
     backwards and reduces in a packed step, the step bitwise on a rerun,
     one step on the card against the CPU on the first packed batch
     (loss within 1e-2, gradients within 2e-2 of each one's largest
     magnitude), the training CLI for 1 epoch, ms per step and device
     busy ms in turns with the float32 step; (c) remat on the bf16
     flagship and gap models: gradients bitwise those without, forward
     launches doubled, peak device memory of both; (d) accum_steps=2 on
     int8 features: parameters unchanged after a micro-step that does not
     emit, finite losses, and the CLI with all four options; (e)
     Predictor.from_run of the bf16 run serves the 256 molecules, its
     molecules/s in turns with the float32 Predictor's; (a) the eight bf16
     instances (forward plain, drop, alpha, drop+alpha; backward plain,
     drop, galpha, drop+galpha) bitwise equal to their float32 twins on
     the widened inputs (the gradients after rounding to bf16), bitwise
     on a rerun and within phase 3's tolerances of their plain versions
     (one bf16 ulp more for dq, dk, dv, de), on every tier of the first
     packed batch (timed in turns with the twins), the batch whole, the
     AID step's DK>40 tier (timed) and HC=1024; their launches from the
     bf16 epoch, two bf16 gap steps and conv_0's attention weights with
     and without dropout.
 11. the host data pipeline and the profiling hooks, at the flagship's
     full width: (a) the integral engine built by g++ from the
     repository's source through its CLI (`python -m
     x2gnn_tpu_torch.data.integrals.build`, its printed path the one the
     engine loads; the builder after it runs no g++), 128 labelled
     molecules (`python -m
     x2gnn_tpu_torch.data.make_synthetic --basis 6311 --gap-label
     --mean-atoms 18`), the 2 smallest held against the numpy engine (S
     rtol 1e-10, H rtol 1e-8), ms per molecule of both engines; (b) their
     float64 geometry and labels as an xyz file, `python -m
     x2gnn_tpu_torch.train --data ... --backend native6311 --pack-mixed
     --epochs 1` as a subprocess, its features bitwise the builder's; (c)
     one epoch in-process with cache_batches True, False and "host" from
     the same weights, records, state and launches bitwise equal; the
     first streamed batch bitwise its host assembly, the forward and
     backward kernels on each of its tiers against their plain versions
     (phase 3's tolerances, timed; the rows' launches from the `off`
     epoch) and one step on it card vs CPU; then each mode's step (wall
     over 5 epochs, device busy, idle share) in turns; (d)
     Predictor.from_run of (b)'s run: predict_xyz of 64 molecules,
     featurized again in this process, bitwise predict on load_dataset's
     graphs; (e) the CLI on 64 molecules of (b)'s cache with
     --cache-batches host, --profile-dir (a trace file) and
     --check-determinism (OK).
 12. the rest of the reference's model options at the flagship's width:
     (a) variant v2 with the beta-gated skip on the blocked layout:
     serving the 256 QM9-scale molecules (4 launches per batch), card vs
     CPU within 1e-4; one packed step (32 forward, backward and reduce
     launches), card vs CPU within the gradient gates, bitwise on a rerun;
     molecules/s, step ms, busy ms and a step's peak memory in turns with
     the v1 flagship; (b) phase 4's weights in the segment and padded
     layouts: the 256 molecules within 5e-4 / 5e-5 x max of the blocked
     predictions and within 1e-4 of the CPU, no attention kernel launched;
     one packed step per layout card vs CPU and bitwise on a rerun (no
     launch); molecules/s, step and busy ms and a step's peak memory in
     turns with the blocked layout; (c) `python -m x2gnn_tpu_torch.train
     --layout segment --check-determinism` for 1 epoch of the packed
     recipe as a subprocess, and `evaluate --layout` of phase 8c's blocked
     run in every layout (the MAEs within 1e-4 relative); (d) the three
     layouts' forwards under one set of explicit masks at rate 0.1, within
     (b)'s tolerance; (e) the segment layout's attention weights of conv_0
     against the blocked kernel's alpha (`pairs_to_triplet_weights`);
 13. the parallel paths on the packed batches (N=744, D=32): (a) data
     parallelism at world size 1 over NCCL, the all-reduced gradient
     against the plain step's within the gradient gates, a step bitwise
     on a rerun, 32 launches of each kernel per step; (b) two spawned
     processes sharing the card over gloo, two full steps and a ragged
     one (a filler), each held to one process stepping the group's
     molecules, both ranks' parameters the same bits; (c) edge
     partitioning (allgather, ring) and DP x EP (1 x 1) at world size 1
     against the blocked model (predictions, gradients, ring bitwise the
     allgather), 4 launches of each kernel per EP step (the EP window
     is phase 5's one window, checked and timed there), the gap recipe's
     dropout under the same masks, an epoch of streamed EP batches equal to the cached
     one; valid pairs per rank at 1, 2 and 4 EP ranks; (d) the training
     CLI with --data-parallel and --edge-partition ring under
     `python -m torch.distributed.run --nproc-per-node 1`; (e) ms per
     packed step of the plain, DP and EP trainers in turns.
 14. per-layer dumps (utils/parity.py) of the flagship with phase 4's
     weights on the first serving batch (N=1024, D=24, one window) and the
     first packed training batch (N=744, D=32, 8 tiers): every entry of the
     card dump (hand kernels) within 1e-6 + 1e-4 x its max|x| of the CPU
     dump (plain versions), the same keys on both sides, a rerun of the card
     dump bitwise, and the bf16 model's output within 1e-2 and its other
     entries within 2e-2 x their max|x|; the 5 worst entries and the
     dump's bytes printed;
 15. A12's cut: the first 1,024 molecules of the A12 set built by the
     port's builder (`make_synthetic --n 1024 --basis 6311 --gap-label`),
     checked against tests/torch_port_curve_jax.json's checksums, its
     atomref fit and standardization against the fixture's, the flagship
     recipe trained 10 epochs from the fixture's initial weights
     (Trainer.fit(state=init_state())), each epoch's val_mae and loss held
     to the fixture's JAX curve (`curve_gate`), occupancy_pairs bitwise;
     the kernels checked and timed on every tier of its first batch.
 16. the evaluation and measurement scripts (`x2gnn_tpu_torch/scripts/`),
     each through its `main`: (a) 18 AID-scale molecules (48-80 atoms)
     labelled with their independent-particle energy in kcal/mol, written
     as an AID-format xyz, `featurize_aid --chunk 6` (3 parts), `aid_cv`
     3 folds x 3 epochs at batch 4 (launches held to conv_layers x the
     windows of every step, evaluation and fold-out prediction; a window
     with more than 40 key slots among them), fold 0 again in a fresh
     workdir bitwise (result.json, every metrics record but the wall
     clock's), fold 0's fold-out predictions from its ckpt_best.pt on the
     card reproducing its test MAE bitwise and within MODEL_RTOL /
     MODEL_ATOL of the CPU's, the three kernels checked and timed on every
     window of its first training batch; (b) `profile_step` at batch 32
     (no attention launch in no_kernel, 4 x the windows of each per step
     in full); (c) `bench_infer` on 256 molecules beside phase 5's rate;
     (d) `debug_ep_cost` at world size 1; (e) `bench_scaling` on one card
     (its single line); (f) `pack_ab --report-only` over phase 6a's packed
     and 6b's fixed-budget runs; (g) `pipeline_demo`: 2 streamed epochs of
     2,048 geometry-only molecules.
Each row of the kernels line takes its launches from a path that launches
its shape, with the counts zeroed just before that path.
The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --a12-full [--deadline-s S] [--n N]

runs A12 at full scale instead, and nothing else (`a12_full`): the port's
builder makes the A12 set (`make_synthetic --n 50000 --name
synthq50k_6311 --basis 6311 --gap-label`) in a temporary directory, its
atomref fit and standardization are held to runs/flagship_r5_regression's
within 1e-8, the training CLI runs the flagship recipe as written
(`--config runs/flagship_r5_regression/args.json --atomref-fit
--standardize --cache-batches on`) as a subprocess until its next epoch
would end past S seconds (default 3300) from the start, and every
complete epoch is held to both JAX runs' curves (`a12_gate`); the step,
epoch and evaluation times, molecules/s and peak memory are printed
beside the card's name and power limit. The ok line ends it only if every
check passed, and only for the A12 set's 50,000 molecules: another N
tries the mechanics without the JAX checks.

    python3 chip_smoke.py --gap-full [--deadline-s S] [--n N]

runs the gap recipe at full scale in the same way, and nothing else
(`gap_full`; both modes are `full_recipe` of their recipe's record): the
same set, its standardization (no atomref) held to runs/gap_r5_50k's, the
constant predictors' val and test MAE printed (the train split's mean and
median label; both modes print them), `--config
runs/gap_r5_50k/args.json --standardize --pack-mixed --cache-batches on
--feat-dtype float16` trained until the deadline, the last epoch held to
runs/gap_r5_50k and runs/gap_molwise_r4 by `gap_gate`, the timings, and
the <drop> forward, backward and reduce on every tier of the plan's
heaviest batch checked against their plain versions and timed, with one
step's launches counted (an epoch's is logged as the plan's arithmetic,
not counted); its kernels line holds those rows.

    python3 chip_smoke.py --multi-card

runs the parallel paths on 4 cards of one host over NCCL instead, and
nothing else (`multi_card`); with fewer than 4 cards, or none, it exits
1 and prints no result. It builds the kernels once, logs the cards
(index, name, power limit, UUID) and `nvidia-smi topo -m`, then starts 4
ranks with `python -m torch.distributed.run --standalone
--nproc-per-node 4 chip_smoke.py --multi-card-rank DIR`, each joining
through the port's `initialize_distributed` (`mc_rank_phases`), on the
flagship at full width with the seed-0 weights: (a) each rank on the card
of its LOCAL_RANK, 4 distinct UUIDs, NCCL; (b) data parallelism, 3 steps
over groups of 4 of phase 6's packed batches (the last ragged, with
fillers), each step's reduced gradient and loss against the plain step of
the group on the rank's card, the parameters the same bits on every rank
after every step and on a rerun; (c) edge partitioning with both
exchanges on the first packed batch (186 rows a rank) and on an AID-scale
batch (32 molecules, D = 48 > 40: the i-chunked kernels), predictions and
gradients against the single-card model on the batch as one window, ring
bitwise the allgather, 4 launches of each kernel per rank, each rank's
first window against the plain kernels on its card (phase 3's gates,
timed), one EP step with the parameters the same bits on every rank;
(d) DP x EP on 2 x 2 with both exchanges against the plain step over the
two groups; (f) ms per step of the plain, DP, EP and DP x EP steps in
turns, and of the row exchange per conv on every rank. Then (e) the
training CLI under torch.distributed.run on 4 ranks: the flagship recipe
on 512 synthetic molecules for 2 epochs with --data-parallel, 1 epoch
and --resume to 2 (bitwise the 2-epoch run), 1 epoch with
--edge-partition ring --dp-groups 2, each with its plan's step count and
rank 0 alone writing, Predictor.from_run of the 2-epoch run on one card
reproducing its logged val MAE; and `scripts.bench_scaling` on 4 ranks.
Every launch has its own deadline inside the mode's 800 s; a launch still
running at its deadline is stopped with every process it started and
fails the mode naming its phase. Logs go to MC_OUT. The
kernels line holds each rank's window rows; the ok line's count is 4.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
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
# the bf16 model (compute_dtype "bfloat16"), card against CPU: the loss
# within 1e-2 relative, each parameter's gradient within 2e-2 of its
# largest magnitude, the tolerances tests/test_torch_port_bf16.py holds the
# port's bf16 model to against JAX's (bf16 rounds at other places in the
# two GEMM libraries; either side can land one bf16 ulp away)
BF16_PRED_TOL, BF16_GRAD_TOL = 1e-2, 2e-2

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
    more (N, DI, HC) float32 inputs) at query slots in a valid pair, the
    rows of k, v and rbf at key slots in a valid pair, z at the valid
    pairs, e of the atoms with a valid pair, and all of the ids, W and the
    bias. No other row changes an output: a query slot without a valid
    pair gives 0. q, k, v and e count at their storage's element size (4
    bytes float32, 2 bfloat16), the others at 4."""
    q, k, v, e, rbf, w, bias, z, a_ids, b_ids = args
    HC = q.shape[-1]
    q_rows = int(valid.any(dim=2).sum())
    k_rows = int(valid.any(dim=1).sum())
    atoms = int(valid.flatten(1).any(dim=1).sum())
    words = (q_rows * HC * (query_inputs - 1) + k_rows * rbf.shape[-1]
             + int(valid.sum()) + a_ids.numel() + b_ids.numel()
             + w.numel() + bias.numel())
    return (4 * words + q_rows * HC * q.element_size()
            + k_rows * HC * (k.element_size() + v.element_size())
            + atoms * HC * e.element_size())


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
              + sum(t.numel() * t.element_size() for t in grads))
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
        blocked_attention_bwd_plain)

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
    red, red_err = check_reduce(tag, partial)
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
    return bwd, time_reduce(tag, partial, red, red_err)


def check_reduce(tag, partial):
    """The reduce kernel on a backward's `partial` against a float64 sum
    (within 1e-5 x its largest column sum of |partial|) and bitwise on a
    rerun; returns (its output, max abs error)."""
    import torch
    from x2gnn_tpu_torch.ops.blocked_attn import reduce_partials

    red = reduce_partials(partial)
    red_err = float((red.double() - partial.double().sum(0)).abs().max())
    tol = 1e-5 * float(partial.abs().sum(0).max())
    log(f"[reduce {tag}] {tuple(partial.shape)} partials: max_abs_err="
        f"{red_err:.3e} against a float64 sum (limit {tol:.3e})")
    if red_err > tol or not torch.equal(red, reduce_partials(partial)):
        raise AssertionError(f"reduce {tag}: wrong or not reproducible")
    return red, red_err


def time_reduce(tag, partial, red, red_err):
    """The reduce kernel and partial.sum(0) on the same partials, in
    turns, timed on the device back to back (both are shorter than a
    launch's host time); returns the reduce's record."""
    from x2gnn_tpu_torch.ops.blocked_attn import reduce_partials

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
    return {"ms": r_ms, "plain_ms": r_plain, "bound_ms": r_bound,
            "bound_by": r_by, "max_abs_err": red_err, "library_ms": r_plain}


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
    """{"fwd": {...}, "bwd": {...}}: launches per (N, DI, DK); and
    "fwd_variants", "bwd_variants": per (variant, N, DI, DK)."""
    from x2gnn_tpu_torch.ops.blocked_attn import (
        blocked_attention, blocked_attention_bwd_partials)
    return {"fwd": dict(blocked_attention.by_shape),
            "bwd": dict(blocked_attention_bwd_partials.by_shape),
            "fwd_variants": dict(blocked_attention.by_variant),
            "bwd_variants": dict(blocked_attention_bwd_partials.by_variant)}


def per_variant(counts):
    """{variant: launches} of a by_variant count."""
    out = {}
    for (variant, *_), n in counts.items():
        out[variant] = out.get(variant, 0) + n
    return out


def one_window_budgets(graphs, batch_size):
    """`pad_budget_for` without the two-tier split and the tiers: the
    fixed budgets of the earlier slices, which a caller gets by passing
    them as `Trainer(budgets=...)`. Its batches are not degree-sorted and
    run one attention window per conv."""
    from x2gnn_tpu_torch.data.batching import pad_budget_for
    return pad_budget_for(graphs, batch_size)._replace(
        n_deg_lo=0, n_hi=0, tiers=())


def train_flagship(mcfg, tcfg, graphs, device, tag, budgets=None,
                   feat_dtype="float32"):
    """Phase 6a-6c: Trainer.fit over `graphs` for tcfg.max_epoch epochs in
    a temporary workdir (edge features cached as `feat_dtype`), with every
    launch count zeroed just before and read just after. Checks finite losses, no skipped step, one metrics
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
                          workdir=workdir, budgets=budgets,
                          feat_dtype=feat_dtype, device=device)
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


def check_step_on_card_and_cpu(mcfg, graphs, device, tag="card vs cpu",
                               batch=None):
    """Phase 6c: the loss and the gradient of every parameter of one
    training step on 8 molecules (or the host batch `batch`), on the card
    (CUDA kernels) and on the CPU (plain versions), from the same weights;
    with attention dropout (phase 9b) both under the same explicit masks,
    one per conv drawn from a seeded numpy generator at the config's
    rate. The lin_key biases
    shift every score of a query alike, which the softmax ignores: their
    gradient is 0 in exact arithmetic and rounding noise on both sides,
    held below 1e-6 of the largest gradient instead. With compute_dtype
    bfloat16 (phase 10b) the loss is held within BF16_PRED_TOL relative,
    each gradient within BF16_GRAD_TOL of its largest magnitude and the
    lin_key biases below 1e-3 of the largest gradient, as
    tests/test_torch_port_bf16.py holds the bf16 model against JAX."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss

    model = X2GNN(mcfg, torch.Generator().manual_seed(4), device=device)
    cpu_model = copy.deepcopy(model).to("cpu")
    if batch is None:
        batch = pad_graphs(graphs, pad_budget_for(graphs, len(graphs)))
    if len(windows_of(batch)) < 2:
        raise AssertionError(f"{tag}: the batch has no degree tiers "
                             f"({batch.tiers})")
    masks = None
    if mcfg.dropout > 0:
        N, D = batch.in_edges.shape
        keep = np.float32(1.0 - mcfg.dropout)
        rng = np.random.default_rng(91)
        masks = [torch.from_numpy(
            (rng.random((N, D, D, mcfg.heads)) < keep).astype(np.float32)
            / keep) for _ in range(mcfg.conv_layers)]

    def grads(m, dev):
        b = batch.to(dev)
        pred = m(b, dropout_masks=None if masks is None
                 else [x.to(dev) for x in masks])
        loss = smooth_l1_loss(pred, b.y, mask=b.graph_mask)
        # v2 leaves the atom embedding unused: zero gradients
        g = torch.autograd.grad(loss, list(m.parameters()),
                                materialize_grads=True)
        return loss.item(), {n: t.detach().cpu() for (n, _), t in
                             zip(m.named_parameters(), g)}

    loss, g_card = grads(model, device)
    t0 = time.perf_counter()
    cpu_loss, g_cpu = grads(cpu_model, "cpu")
    log(f"[{tag}] one step on {int(batch.graph_mask.sum())} molecules, "
        f"N, D = {tuple(batch.in_edges.shape)}, tiers {batch.tiers}, readout "
        f"{mcfg.readout}, dropout {mcfg.dropout}"
        f"{'' if masks is None else ' (the same explicit masks)'}: loss "
        f"{loss:.7f} card, "
        f"{cpu_loss:.7f} CPU ({time.perf_counter() - t0:.1f} s on the CPU)")
    bf16 = mcfg.compute_dtype == "bfloat16"
    if abs(loss - cpu_loss) > (BF16_PRED_TOL if bf16 else 1e-5) * abs(
            cpu_loss):
        raise AssertionError(f"{tag}: losses differ")
    top = max(float(t.abs().max()) for t in g_cpu.values())
    worst = (0.0, "")
    for name, ref in g_cpu.items():
        got = g_card[name]
        err = (got - ref).abs()
        if name.endswith("lin_key.bias"):
            if max(float(got.abs().max()), float(ref.abs().max())) \
                    >= (1e-3 if bf16 else 1e-6) * top:
                raise AssertionError(f"{tag}: {name} not ~0")
            continue
        limit = GRAD_ATOL * float(ref.abs().max()) + GRAD_RTOL * ref.abs()
        if bf16:
            limit = BF16_GRAD_TOL * float(ref.abs().max())
        if (err > limit).any() or not torch.isfinite(got).all():
            raise AssertionError(f"{tag}: gradient of {name} differs"
                                 f" (max abs {float(err.max()):.3e})")
        rel = float(err.max()) / max(float(ref.abs().max()), 1e-30)
        worst = max(worst, (rel, name))
    within = (f"{BF16_GRAD_TOL} of each one's largest magnitude" if bf16
              else f"{GRAD_RTOL} relative + {GRAD_ATOL} of each one's "
              "largest magnitude")
    log(f"[{tag}] {len(g_cpu)} gradients agree within {within}; largest "
        f"max|err|/max|g| {worst[0]:.3e} ({worst[1]})")


def step_ms(trainer, state, batches, reps: int = 20):
    """Median ms of one training step on `batches` (cached on the card),
    by CUDA events around each step, after 3 steps of warm-up. Returns
    (ms, state, steps run)."""
    import torch
    pairs = []
    step = int(state.step)      # the steps' numbers for dropout masks
    for i in range(reps + 3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = trainer.train_step(state, batches[i % len(batches)],
                                      step + i)
        end.record()
        if i >= 3:
            pairs.append((start, end))
    torch.cuda.synchronize()
    return (statistics.median(s.elapsed_time(e) for s, e in pairs), state,
            reps + 3)


# ---- phase 8: determinism, resume, caches, the CLIs, from_run, .pth ----

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_ARGS = os.path.join(REPO, "runs", "flagship_r5_regression",
                             "args.json")


def index_add_segment_sum(data, segment_ids, num_segments, mask=None):
    """The segment sum of the earlier slices (`index_add_`, float atomics
    on CUDA), kept here only to compare the packed step's device time and
    run-to-run bits with the fixed-order select-and-sum of
    ops/segment.py."""
    import torch
    if mask is not None:
        data = torch.where(
            mask.reshape(mask.shape + (1,) * (data.dim() - mask.dim())),
            data, 0.0)
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return out.index_add_(0, segment_ids, data)


@contextlib.contextmanager
def segment_sums(fn):
    """Run the model's three segment-sum callers (the graph norm, the
    molecule sum, the non-blocked readout) through `fn`."""
    import x2gnn_tpu_torch.models.x2gnn as model_mod
    import x2gnn_tpu_torch.nn.norm as norm_mod
    import x2gnn_tpu_torch.nn.readout as readout_mod
    mods = (model_mod, norm_mod, readout_mod)
    saved = [m.segment_sum for m in mods]
    for m in mods:
        m.segment_sum = fn
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.segment_sum = f


def busy_ms(trainer, state, batches, steps: int = 5, check=False):
    """(device busy ms per step, wall ms per step, state) of `steps`
    training steps on cached batches traced by torch.profiler, after 3
    steps of warm-up. With `check`, device_rows' sums (the raw events) are
    held to key_averages' on the same trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from x2gnn_tpu_torch.profile_serving import device_rows

    step = int(state.step)      # the steps' numbers for dropout masks
    for i in range(3):
        state, _ = trainer.train_step(state, batches[i % len(batches)],
                                      step + i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state, _ = trainer.train_step(state, batches[i % len(batches)],
                                          step + 3 + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    if check:
        check_device_rows(prof, rows)
    return busy / steps, wall / steps, state


def check_device_rows(prof, rows):
    """device_rows' kernels and copies (read from the raw events) against
    key_averages' on the same trace: the same count and device time, within
    1e-6 relative (the two sum in another order)."""
    from torch.autograd import DeviceType
    t0 = time.perf_counter()
    ref = [(e.self_device_time_total, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    parse_s = time.perf_counter() - t0
    got = (sum(r[0] for r in rows), sum(r[1] for r in rows))
    want = (sum(r[0] for r in ref), sum(r[1] for r in ref))
    log(f"[device_rows] {got[1]} device events, {got[0]:.3f} us from the raw "
        f"events; key_averages {want[1]}, {want[0]:.3f} us (its parse "
        f"{parse_s:.2f} s)")
    if got[1] != want[1] or abs(got[0] - want[0]) > 1e-6 * want[0]:
        raise AssertionError(f"device_rows {got} against key_averages {want}")


def read_records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def resumed_record_diffs(straight, resumed, first_resumed):
    """Fields of two runs' metrics.jsonl records that differ, bitwise, but
    the wall-clock ones (seconds, *_per_sec). A resumed run's test_mae
    starts again at None, as the reference's does: from record
    `first_resumed` on, a None test_mae on an epoch that did not improve on
    best_val is not a difference."""
    diffs = []
    if len(straight) != len(resumed):
        return [f"{len(straight)} records against {len(resumed)}"]
    for i, (a, b) in enumerate(zip(straight, resumed)):
        if a.keys() != b.keys():
            diffs.append(f"record {i}: keys {sorted(a)} vs {sorted(b)}")
            continue
        for key in a:
            if key == "seconds" or key.endswith("_per_sec"):
                continue
            if (key == "test_mae" and i >= first_resumed
                    and b[key] is None and b["val_mae"] > b["best_val_mae"]):
                continue
            if a[key] != b[key]:
                diffs.append(f"record {i}: {key} {a[key]!r} vs {b[key]!r}")
    return diffs


def flagship_trainer(mcfg, tcfg, graphs, device, workdir, seed=0,
                     feat_dtype="float32"):
    import numpy as np
    import torch
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.train.trainer import Trainer
    model = X2GNN(mcfg, torch.Generator().manual_seed(seed), device=device)
    return Trainer(model, mcfg, tcfg, graphs,
                   np.array([g.y[0] for g in graphs], np.float32),
                   workdir=workdir, feat_dtype=feat_dtype, device=device)


def check_segment_sum_on_card(device):
    """ops/segment.py::segment_sum on the card at the graph norm's shape
    (23,808 rows into 48 slots) and the molecule sum's with features
    (744 x 128 into 48), unsorted ids, a quarter of the rows masked: equal
    to the CPU's sum within rtol 1e-5 / atol 1e-4, bitwise equal on a
    rerun, and a NaN in one unmasked row spoils its own segment only."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.ops.segment import segment_sum

    rng = np.random.default_rng(8)
    for shape in ((23808,), (744, 128)):
        data = rng.normal(size=shape).astype(np.float32)
        ids = rng.integers(0, 48, size=shape[0])
        mask = rng.random(shape[0]) > 0.25
        row = int(np.flatnonzero(mask)[0])
        data[row] = np.nan
        args = [torch.from_numpy(a) for a in (data, ids, mask)]
        cpu = segment_sum(args[0], args[1], 48, args[2]).numpy()
        card = [segment_sum(*(a.to(device) for a in args[:2]), 48,
                            args[2].to(device)).cpu().numpy()
                for _ in range(2)]
        bad = ~np.isfinite(card[0]).reshape(48, -1).all(1)
        same = np.array_equal(card[0], card[1], equal_nan=True)
        log(f"[segment sums] {shape} into 48: card vs CPU max_abs "
            f"{np.nanmax(np.abs(card[0] - cpu)):.3e}, rerun "
            f"{'bitwise equal' if same else 'DIFFERS'}, "
            f"non-finite segments {np.flatnonzero(bad).tolist()} "
            f"(the NaN row's: {int(ids[row])})")
        np.testing.assert_allclose(card[0], cpu, rtol=1e-5, atol=1e-4)
        if (not same
                or np.flatnonzero(bad).tolist() != [int(ids[row])]):
            raise AssertionError(f"segment_sum on the card at {shape}")


def check_step_determinism(mcfg, tcfg, graphs, qm9, device, card):
    """Phase 8a: check_train_step_determinism on the first packed batch,
    with the fixed-order segment sums (must be bitwise) and with the
    earlier index_add_ ones (reported); two Predictor.predict calls on the
    QM9-scale molecules (bitwise); the packed step's device busy time with
    either segment sum, in turns."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.infer import Predictor
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.utils.determinism import (
        check_train_step_determinism)

    trainer = flagship_trainer(mcfg, tcfg, graphs, device, "unused")
    batch = trainer.batches(trainer.train_idx)[0]
    shape = tuple(batch.in_edges.shape)
    log(f"[determinism] first packed batch N, D = {shape}, "
        f"{len(batch.tiers)} tiers {batch.tiers}")
    if shape != (744, 32) or len(batch.tiers) != 8:
        raise AssertionError(f"determinism: first packed batch {shape}, "
                             f"tiers {batch.tiers}")
    check_segment_sum_on_card(device)
    report = check_train_step_determinism(trainer, repeats=2)
    log(f"[determinism] train step, 2 repeats, select segment sums: "
        f"mismatches {json.dumps(report['mismatches'])}")
    if not report["deterministic"]:
        raise AssertionError("determinism: the training step differs "
                             "between two runs")
    with segment_sums(index_add_segment_sum):
        old = check_train_step_determinism(trainer, repeats=2)
    log(f"[determinism] the same with index_add_ segment sums: "
        f"{len(old['mismatches'])} mismatching tensors "
        f"{json.dumps(old['mismatches'][:4])}")

    model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)
    pred = Predictor(mcfg, model, batch_size=32, device=device)
    a, b = pred.predict(qm9), pred.predict(qm9)
    log(f"[determinism] two predict calls on {len(qm9)} molecules: "
        f"{'bitwise equal' if np.array_equal(a, b) else 'DIFFER'}")
    if not np.array_equal(a, b):
        raise AssertionError("determinism: predictions differ")

    batches = trainer.batches(trainer.train_idx)
    state = trainer.init_state()
    for turn, (name, fn) in enumerate((
            ("select", None), ("index_add_", index_add_segment_sum),
            ("index_add_", index_add_segment_sum), ("select", None))):
        if fn is None:
            busy, wall, state = busy_ms(trainer, state, batches,
                                        check=turn == 0)
        else:
            with segment_sums(fn):
                busy, wall, state = busy_ms(trainer, state, batches)
        log(f"[segment sums] {card}: {name}: packed step device busy "
            f"{busy:.3f} ms, wall {wall:.3f} ms per step (5 steps traced)")


def check_resume(mcfg, tcfg, graphs, device, card, reference_records):
    """Phase 8b: 2 epochs straight in workdir A; 1 epoch in B, then a
    fresh Trainer restoring B/ckpt_last.pt and 1 more: B's records equal
    A's (and A's those of phase 6a's run of the same recipe), the final
    parameters, EMA and optimizer state bitwise; the resumed epoch
    launches conv_layers x its windows. Returns the steps per epoch."""
    import torch
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.utils.determinism import tree_bitwise_diff

    with tempfile.TemporaryDirectory() as root:
        wa, wb = os.path.join(root, "a"), os.path.join(root, "b")
        a = flagship_trainer(mcfg, tcfg, graphs, device, wa)
        state_a, _ = a.fit(2)
        flagship_trainer(mcfg, tcfg, graphs, device, wb).fit(1)
        b = flagship_trainer(mcfg, tcfg, graphs, device, wb, seed=1)
        b.steps_per_epoch()                 # batches built before timing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = b.restore(os.path.join(wb, "ckpt_last.pt"))
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        log(f"[resume] {card}: Trainer.restore of ckpt_last.pt "
            f"{restore_ms:.1f} ms (step {int(restored.step)})")
        reset_launch_counts()
        state_b, _ = b.fit(1, state=restored)
        torch.cuda.synchronize()
        counts = launch_counts()
        rec_a, rec_b = read_records(wa), read_records(wb)
    for r in rec_b:
        log(f"[resume] B epoch {r['epoch']}: loss {r['loss']!r} val_mae "
            f"{r['val_mae']!r} best {r['best_val_mae']!r} test_mae "
            f"{r['test_mae']!r} step {r['step']}")
    diffs = (resumed_record_diffs(rec_a, rec_b, 1)
             + [f"phase 6a: {d}" for d in resumed_record_diffs(
                 reference_records, rec_a, len(rec_a))]
             + tree_bitwise_diff(state_a, state_b))
    log(f"[resume] 1 + 1 epochs against 2 straight: differences "
        f"{json.dumps(diffs)}")
    if diffs:
        raise AssertionError("resume: the resumed run differs")
    L = mcfg.conv_layers
    train_w = n_windows(b.batches(b.train_idx))
    improved = rec_b[-1]["val_mae"] == rec_b[-1]["best_val_mae"]
    eval_w = (2 * n_windows(b.batches(b.val_idx))
              + improved * n_windows(b.batches(b.test_idx)))
    expect = {"fwd": L * (train_w + eval_w), "bwd": L * train_w,
              "reduce": L * train_w}
    log(f"[resume] resumed epoch launches {counts} (expected {expect}: "
        f"{L} layers x {train_w} train windows + {eval_w} eval windows, "
        "the val set twice: the best-val gate's seed and the epoch)")
    if counts != expect:
        raise AssertionError(f"resume: launches {counts}, expected {expect}")
    return b.steps_per_epoch()


def run_cli(args, tag, timeout=600):
    """`python -m <args>` from the repository root as a subprocess; its
    standard output and the tail of its standard error are logged."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    for line in proc.stderr.strip().splitlines()[-6:]:
        log(f"[{tag}] stderr: {line}")
    log(f"[{tag}] exit {proc.returncode} after {seconds:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: exit {proc.returncode}")
    return proc


def check_run_io(mcfg, graphs, qm9, device, card, steps_per_epoch,
                 keep=None):
    """Phases 8c-8e: a graph cache of the training molecules; the training
    CLI on it for 1 epoch, then with --auto-resume to 2; the evaluate CLI
    against Predictor.from_run's MAE; from_run serving the QM9-scale
    molecules (launches; bitwise against a Predictor on the EMA weights
    restored by Trainer.restore; one batch against the CPU); the .pth
    export and import (bitwise). The run's directory and the cache are
    copied under `keep` (phase 12c evaluates them in every layout)."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.data.dataset import save_graph_cache
    from x2gnn_tpu_torch.evaluate import absolute_error
    from x2gnn_tpu_torch.infer import Predictor, load_run_configs
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.utils.torch_ckpt import (
        export_torch_state_dict, import_torch_state_dict)

    with tempfile.TemporaryDirectory() as root:
        cache = os.path.join(root, "cache.npz")
        save_graph_cache(cache, graphs, basis="synthetic-random")
        work = os.path.join(root, "cli")
        train = ["x2gnn_tpu_torch.train", "--config", FLAGSHIP_ARGS,
                 "--data-npz", cache, "--ckpt-every", "1", "--pack-mixed",
                 "--workdir", work]
        run_cli(train + ["--epochs", "1"], "cli train")
        run_cli(train + ["--epochs", "2", "--auto-resume"],
                "cli train --auto-resume")
        records = read_records(work)
        log(f"[cli train] metrics.jsonl: epochs "
            f"{[r['epoch'] for r in records]}, steps "
            f"{[r['step'] for r in records]}, val_mae "
            f"{[r['val_mae'] for r in records]}")
        if ([r["epoch"] for r in records] != [1, 2]
                or records[-1]["step"] != 2 * steps_per_epoch):
            raise AssertionError(f"cli train: records {records}")
        best = os.path.join(work, "ckpt_best.pt")
        proc = run_cli(["x2gnn_tpu_torch.evaluate", "--ckpt", best,
                        "--data-npz", cache], "cli evaluate")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        cold = [line for line in proc.stderr.splitlines()
                if "cold pass" in line][-1]
        log(f"[cli evaluate] {card}: {json.dumps(result)}; {cold}")

        # 8d: from_run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = Predictor.from_run(work, device=device)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        log(f"[from_run] {card}: Predictor.from_run load {load_ms:.1f} ms")
        full = pred.predict(graphs)
        targets = np.array([g.y[0] for g in graphs], np.float64)
        mae = float(np.abs(full - targets).mean())
        rel = abs(result["mae"] - mae) / abs(mae)
        log(f"[cli evaluate] MAE {result['mae']!r} against from_run's "
            f"{mae!r} over {len(graphs)} molecules: relative difference "
            f"{rel:.3e} (limit 1e-6)")
        if result["count"] != len(graphs) or rel > 1e-6:
            raise AssertionError("cli evaluate: MAE differs from from_run")
        # evaluate's loop on the restored model, warm: the second of two
        # passes in this process
        y = targets.astype(np.float32)
        absolute_error(pred.model, graphs, y, 32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, count = absolute_error(pred.model, graphs, y, 32)
        seconds = time.perf_counter() - t0
        log(f"[evaluate] {card}: evaluate's loop, warm, {count} molecules "
            f"in {seconds:.4f} s: {count / seconds:.1f} molecules/s")
        preds, _ = serve(pred, qm9, mcfg.conv_layers * math.ceil(
            len(qm9) / pred.batch_size), "from_run")
        _, run_tcfg = load_run_configs(os.path.join(work, "args.json"))
        trainer = flagship_trainer(mcfg, run_tcfg, graphs, device,
                                   "unused", seed=5)
        ema = trainer.ema_parameters(trainer.restore(best))
        direct = X2GNN(mcfg, torch.Generator().manual_seed(6), device=device)
        with torch.no_grad():
            for name, p in direct.named_parameters():
                p.copy_(ema[name])
        again = Predictor(mcfg, direct, device=device).predict(qm9)
        same = np.array_equal(preds, again)
        log(f"[from_run] against a Predictor on the EMA weights of "
            f"Trainer.restore: {'bitwise equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("from_run: predictions differ from the "
                                 "restored EMA weights'")
        cpu = Predictor.from_run(work, device="cpu").predict(qm9[:32])
        diff = np.abs(preds[:32] - cpu)
        log(f"[from_run] card vs CPU on 32 molecules: max_abs="
            f"{diff.max():.3e} (|pred| max {np.abs(cpu).max():.3e})")
        np.testing.assert_allclose(preds[:32], cpu, rtol=MODEL_RTOL,
                                   atol=MODEL_ATOL)

        # 8e: .pth round trip of the EMA weights
        pth = os.path.join(root, "x2gnn.pth")
        sd = export_torch_state_dict(pred.model)
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                    "epoch": 2}, pth)
        fresh = X2GNN(mcfg, torch.Generator().manual_seed(9), device=device)
        report = import_torch_state_dict(
            torch.load(pth, map_location="cpu", weights_only=True)["model"],
            fresh)
        same = all(torch.equal(p, q) for p, q in
                   zip(fresh.parameters(), pred.model.parameters()))
        back = Predictor(mcfg, fresh, device=device).predict(qm9)
        log(f"[pth] {len(sd)} tensors exported and imported: report "
            f"{json.dumps(report)}, parameters "
            f"{'bitwise equal' if same else 'DIFFER'}, predictions "
            f"{'bitwise equal' if np.array_equal(back, preds) else 'DIFFER'}")
        if any(report.values()) or not same or not np.array_equal(back,
                                                                 preds):
            raise AssertionError("pth: the round trip changed the model")
        if keep is not None:
            shutil.copytree(work, os.path.join(keep, "run"))
            shutil.copy(cache, os.path.join(keep, "cache.npz"))


# ---- phase 9: the gap recipe (molwise readout, attention dropout) ----

GAP_ARGS = os.path.join(REPO, "runs", "gap_r5_50k", "args.json")
DROP_RATES = (0.1, 0.4)      # the recipe's rate, and one that drops many


def gap_training_configs():
    """The gap recipe's (ModelConfig, TrainConfig) as written."""
    from x2gnn_tpu_torch.config import load_configs
    return load_configs(GAP_ARGS)


def keep_mask(shape, rate, seed, device):
    """A keep mask pre-scaled by 1/keep, from a seeded numpy generator."""
    import numpy as np
    import torch
    keep = np.float32(1.0 - rate)
    draw = np.random.default_rng(seed).random(shape) < keep
    return torch.from_numpy(draw.astype(np.float32) / keep).to(device)


def masked_work(args, heads, num_radial, variant):
    """(bytes, FP32 operations) of one kernel instance on these inputs:
    attention_work / attention_bwd_work, plus 4 B per valid pair and head
    for the mask (read at valid pairs only) and for galpha, and the whole
    (N, DI, DK, H) alpha output written; one operation per valid pair and
    head for the mask (forward) or two (backward), one for alpha, three
    for galpha."""
    q = args[0]
    N, DI, HC = q.shape
    DK = args[1].shape[1]
    pair_heads = int(valid_pairs(args).sum()) * heads
    if variant.startswith("fwd"):
        nbytes, ops, _ = attention_work(args, heads, num_radial,
                                        q.numel() * 4)
        ops += pair_heads * (("drop" in variant) + ("alpha" in variant))
        nbytes += 4 * pair_heads * ("drop" in variant)
        nbytes += 4 * N * DI * DK * heads * ("alpha" in variant)
        return nbytes, ops
    nbytes, _, ops, _ = attention_bwd_work(args, q, q, heads, num_radial)
    nbytes += 4 * pair_heads * (("drop" in variant) + ("galpha" in variant))
    ops += pair_heads * (2 * ("drop" in variant) + 3 * ("galpha" in variant))
    return nbytes, ops


def _held(tag, name, got, ref, rtol, atol_scale):
    """got against ref within atol_scale * max|ref| + rtol |ref|, finite;
    returns max |got - ref|."""
    import torch
    err = (got - ref).abs()
    limit = atol_scale * float(ref.abs().max()) + rtol * ref.abs()
    bad = int((err > limit).sum())
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{tag}: {bad} elements of {name} disagree "
                             "with the plain version (or are not finite)")
    return float(err.max())


def check_masked_window(tag, args, cfg, seed, timed):
    """Phase 9a on one window: the forward's drop and drop+alpha instances
    and the backward's drop and drop+galpha instances against their plain
    versions, under a seeded mask at each rate of DROP_RATES: within phase
    3's tolerances, bitwise equal across two runs, dead query rows 0 and
    alpha 0 at invalid pairs (its valid rows summing to 1). With `timed`,
    each instance's device time back to back (backlog_ms) in turns with
    the instance without mask and alpha, its plain version's time, its
    bound and its resident warps; returns {variant: record}."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.ops.blocked_attn import (
        blocked_attention_bwd, blocked_attention_bwd_partials,
        blocked_attention_bwd_plain, blocked_attention_fwd,
        blocked_attention_plain, bwd_occupancy, bwd_plan, fwd_occupancy,
        fwd_plan)

    H, K = cfg.heads, cfg.rbf_dim
    N, DI, HC = args[0].shape
    DK = args[1].shape[1]
    dev = args[0].device
    tag = f"{tag} N={N} DI={DI} DK={DK}"
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(size=(N, DI, HC)).astype(
        np.float32)).to(dev)
    galpha = torch.from_numpy(rng.normal(size=(N, DI, DK, H)).astype(
        np.float32)).to(dev)
    valid = valid_pairs(args)
    dead = args[8] < 0
    err = {}
    for r, rate in enumerate(DROP_RATES):
        m = keep_mask((N, DI, DK, H), rate, seed + 1 + r, dev)
        for name, want_alpha in (("fwd drop", False),
                                 ("fwd drop+alpha", True)):
            kw = dict(heads=H, num_radial=K, dropout_mask=m,
                      return_alpha=want_alpha)
            got = blocked_attention_fwd(*args, **kw)
            again = blocked_attention_fwd(*args, **kw)
            ref = blocked_attention_plain(*args, **kw)
            got, again, ref = [x if want_alpha else (x,)
                               for x in (got, again, ref)]
            e = max(_held(f"{name} {tag}", n, a, b, KERNEL_RTOL,
                          KERNEL_ATOL)
                    for n, a, b in zip(("out", "alpha"), got, ref))
            err[name] = max(err.get(name, 0.0), e)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} {tag}: two runs differ")
            if (got[0][dead] != 0).any():
                raise AssertionError(f"{name} {tag}: a dead row is not 0")
            if want_alpha:
                alpha = got[1]
                sums = alpha.sum(dim=2)[valid.any(dim=2)]
                if (alpha[~valid] != 0).any() or (
                        (sums - 1).abs() > 1e-5).any():
                    raise AssertionError(f"{name} {tag}: alpha is not the "
                                         "softmax")
            else:
                out = got[0]
        for name, ga in (("bwd drop", None), ("bwd drop+galpha", galpha)):
            kw = dict(heads=H, num_radial=K, out=out, dropout_mask=m,
                      galpha=ga)
            got = blocked_attention_bwd(*args, g, **kw)
            again = blocked_attention_bwd(*args, g, **kw)
            ref = blocked_attention_bwd_plain(*args, g, **kw)
            e = max(_held(f"{name} {tag}", n, a, b, BWD_RTOL, BWD_ATOL)
                    for n, a, b in zip(GRAD_NAMES, got, ref))
            err[name] = max(err.get(name, 0.0), e)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} {tag}: two runs differ")
        log(f"[masked {tag}] rate {rate}: {float((m == 0).float().mean()):.3f}"
            " of the mask 0; fwd drop, drop+alpha, bwd drop, drop+galpha "
            "within phase 3's tolerances of their plain versions, reruns "
            "bitwise")
    log(f"[masked {tag}] max_abs_err " + ", ".join(
        f"{k} {v:.3e}" for k, v in err.items()))
    if not timed:
        return None

    m = keep_mask((N, DI, DK, H), DROP_RATES[0], seed + 1, dev)
    out = blocked_attention_fwd(*args, heads=H, num_radial=K,
                                dropout_mask=m)
    L = args[4].shape[-1] // K
    fplan, bplan = (fwd_plan(N, DI, DK, HC, H, L, K),
                    bwd_plan(N, DI, DK, HC, H, L, K))
    calls = {
        "fwd": lambda: blocked_attention_fwd(*args, heads=H, num_radial=K),
        "fwd drop": lambda: blocked_attention_fwd(
            *args, heads=H, num_radial=K, dropout_mask=m),
        "fwd drop+alpha": lambda: blocked_attention_fwd(
            *args, heads=H, num_radial=K, dropout_mask=m, return_alpha=True),
        "bwd": lambda: blocked_attention_bwd_partials(
            *args, g, heads=H, num_radial=K, out=out),
        "bwd drop": lambda: blocked_attention_bwd_partials(
            *args, g, heads=H, num_radial=K, out=out, dropout_mask=m),
        "bwd drop+galpha": lambda: blocked_attention_bwd_partials(
            *args, g, heads=H, num_radial=K, out=out, dropout_mask=m,
            galpha=galpha)}
    plain = {
        "fwd drop": lambda: blocked_attention_plain(
            *args, heads=H, num_radial=K, dropout_mask=m),
        "fwd drop+alpha": lambda: blocked_attention_plain(
            *args, heads=H, num_radial=K, dropout_mask=m, return_alpha=True),
        "bwd drop": lambda: blocked_attention_bwd_plain(
            *args, g, heads=H, num_radial=K, out=out, dropout_mask=m),
        "bwd drop+galpha": lambda: blocked_attention_bwd_plain(
            *args, g, heads=H, num_radial=K, out=out, dropout_mask=m,
            galpha=galpha)}
    turns = {}
    for side in ("fwd", "bwd"):
        names = [n for n in calls if n.startswith(side)]
        for name in names + names[::-1]:      # in turns, there and back
            turns.setdefault(name, []).append(backlog_ms(calls[name]))
    records = {}
    for name, fn in plain.items():
        nbytes, ops = masked_work(args, H, K, name)
        bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, ops)
        variant = name.split()[1]
        occ = (fwd_occupancy(fplan, variant) if name.startswith("fwd")
               else bwd_occupancy(bplan, variant))
        side = name.split()[0]
        ms = turns[name][0]
        records[name] = {
            "ms": ms, "ms_turns": turns[name],
            "ms_without_mask": turns[side], "plain_ms": median_ms(fn),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err[name], "library_ms": None,
            "warps_per_sm": occ["warps_per_sm"],
            "registers": occ["registers"], "spill_bytes": occ["spill_bytes"]}
        log(f"[masked {tag}] {name}: {turns[name][0]:.4f} / "
            f"{turns[name][1]:.4f} ms back to back, without mask "
            f"{turns[side][0]:.4f} / {turns[side][1]:.4f} (in turns); plain "
            f"{records[name]['plain_ms']:.4f} ms; {nbytes} bytes "
            f"({t_bytes:.4f} ms), {ops} ops ({t_ops:.4f} ms): "
            f"{ms / bound_ms:.1f}x its bound; {occ['registers']} registers, "
            f"{occ['spill_bytes']} B spilled, {occ['warps_per_sm']} warps "
            "per SM")
    return records


def check_gap_launches(trainer, records, shapes, tag):
    """Phase 9c: every training step launched the drop instances of both
    kernels, conv_layers x its windows, and every evaluation the plain
    forward; nothing else."""
    L = trainer.mcfg.conv_layers
    epochs = len(records)
    improved = sum(r["test_mae"] is not None and r["val_mae"]
                   == r["best_val_mae"] for r in records)
    train_w = n_windows(trainer.batches(trainer.train_idx)) * epochs
    eval_w = (n_windows(trainer.batches(trainer.val_idx)) * epochs
              + n_windows(trainer.batches(trainer.test_idx)) * improved)
    got = {"fwd": per_variant(shapes["fwd_variants"]),
           "bwd": per_variant(shapes["bwd_variants"])}
    expect = {"fwd": {"drop": L * train_w, "plain": L * eval_w},
              "bwd": {"drop": L * train_w}}
    log(f"[{tag}] launches per variant {json.dumps(got)} (expected "
        f"{json.dumps(expect)}: {L} layers x {train_w} train windows with "
        f"the mask, {eval_w} eval windows without)")
    if got != expect:
        raise AssertionError(f"{tag}: launches per variant {got}, expected "
                             f"{expect}")


def alpha_on_a_path(mcfg, batch, device, deterministic=False):
    """Phase 9d: the gap model's first conv with return_attention_weights
    on the packed batch, dropout drawn, a loss of its output and alpha,
    backward: one drop+alpha forward and one drop+galpha backward per
    window (without the dropout, `deterministic`: alpha and galpha; with
    compute_dtype bfloat16 their bf16 instances); alpha (N, D, D, H) is a
    softmax over the valid pairs and 0 elsewhere. Returns the counts per
    shape and variant."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.models.x2gnn import X2GNN, blocked_geometry
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts

    model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)
    geo = blocked_geometry(batch, mcfg)
    whole = blocked_geometry(dataclasses.replace(
        batch, tiers=(), n_hi=0, d_lo=0), mcfg).windows[0]
    N, D = batch.in_edges.shape
    rng = np.random.default_rng(93)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device)

    x = normal(N, D, mcfg.in_channels)
    rbf = normal(N, D, mcfg.rbf_dim)
    edge_attr = normal(N, mcfg.embedding_size)
    w = normal(N, D, D, mcfg.heads)
    reset_launch_counts()
    out, alpha = model.conv_0(
        x, rbf, edge_attr, geo.out2in, geo.in2out, geo.mask_flat,
        geo.windows, deterministic=deterministic,
        generator=torch.Generator(device=device).manual_seed(3),
        return_attention_weights=True)
    loss = (out * out).mean() + (alpha * w).sum()
    grads = torch.autograd.grad(loss, list(model.conv_0.parameters()))
    torch.cuda.synchronize()
    shapes = launch_shapes()
    valid = ((whole.a_ids[:, :, None] != whole.b_ids[:, None, :])
             & (whole.a_ids >= 0)[:, :, None] & (whole.b_ids >= 0)[:, None, :])
    rows = valid.any(dim=2)
    alpha = alpha.detach()
    sums = alpha.sum(dim=2)[rows]
    prefix = "bf16:" if mcfg.compute_dtype == "bfloat16" else ""
    fwd = prefix + ("alpha" if deterministic else "drop+alpha")
    bwd = prefix + ("galpha" if deterministic else "drop+galpha")
    log(f"[alpha path] conv_0 ({fwd}) with return_attention_weights on the "
        f"packed batch N={N}, D={D}: alpha {tuple(alpha.shape)}, valid rows sum to "
        f"1 within {float((sums - 1).abs().max()):.2e}, launches per "
        f"variant fwd {per_variant(shapes['fwd_variants'])}, bwd "
        f"{per_variant(shapes['bwd_variants'])}")
    n = len(geo.windows)
    if (tuple(alpha.shape) != (N, D, D, mcfg.heads)
            or (alpha[~valid] != 0).any()
            or float((sums - 1).abs().max()) > 1e-5
            or not all(torch.isfinite(t).all() for t in (out, *grads))):
        raise AssertionError("alpha path: wrong alpha or non-finite output")
    if (per_variant(shapes["fwd_variants"]) != {fwd: n}
            or per_variant(shapes["bwd_variants"]) != {bwd: n}):
        raise AssertionError(f"alpha path: launches {shapes}")
    return shapes


def gap_recipe(card, device, train_graphs, aid, packed, pstate,
               packed_records):
    """Phase 9: the gap recipe on the card; `packed` is phase 6a's trainer
    of the flagship recipe, `pstate` its state and `packed_records` its
    metrics, timed beside it. Returns (rows of the kernels line, the
    records of the 2-epoch run)."""
    import torch
    from x2gnn_tpu_torch.data.batching import pad_graphs
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.utils.determinism import (
        check_train_step_determinism)

    gcfg, gtcfg = gap_training_configs()
    gtcfg = dataclasses.replace(gtcfg, max_epoch=2)
    log(f"[gap] recipe from runs/gap_r5_50k/args.json: readout "
        f"{gcfg.readout}, dropout {gcfg.dropout}, target {gtcfg.target}, "
        f"pack_mixed {gtcfg.pack_mixed}; cut to 2 epochs of its 200 and "
        f"{len(train_graphs)} synthetic molecules instead of its 50k")
    if (gcfg.readout, gcfg.dropout, gtcfg.pack_mixed) != (
            "molwise_mean", 0.1, True):
        raise AssertionError(f"gap configs {gcfg}, {gtcfg}")

    # 9c: the recipe as written on the flagship's 512 molecules
    gap, gstate, grecords, _, gshapes = train_flagship(
        gcfg, gtcfg, train_graphs, device, "gap")
    check_gap_launches(gap, grecords, gshapes, "gap")
    gap_batches = gap.batches(gap.train_idx)
    report = check_train_step_determinism(gap, repeats=2)
    log(f"[gap] train step with dropout, 2 repeats: mismatches "
        f"{json.dumps(report['mismatches'])}")
    if not report["deterministic"]:
        raise AssertionError("gap: the training step differs between two "
                             "runs")
    check_resume(gcfg, gtcfg, train_graphs, device, card, grecords)
    # the training CLI on the recipe as written, 1 epoch on 512 molecules
    with tempfile.TemporaryDirectory() as work:
        run_cli(["x2gnn_tpu_torch.train", "--config", GAP_ARGS,
                 "--synthetic", str(len(train_graphs)), "--epochs", "1",
                 "--pack-mixed", "--workdir", work], "gap cli train")
        (record,) = read_records(work)
        with open(os.path.join(work, "args.json")) as f:
            saved = json.load(f)["model"]
    log(f"[gap cli train] epoch 1: loss {record['loss']:.6f} val_mae "
        f"{record['val_mae']:.6f} step {record['step']} bad_steps "
        f"{record['bad_steps']}; readout {saved['readout']}, dropout "
        f"{saved['dropout']}")
    if (not math.isfinite(record["loss"]) or record["bad_steps"]
            or (saved["readout"], saved["dropout"]) != ("molwise_mean",
                                                        0.1)):
        raise AssertionError(f"gap cli train: {record}, {saved}")
    packed_batches = packed.batches(packed.train_idx)
    turns, busy = {}, {}
    states = {"gap": gstate, "flagship": pstate}
    for tag, trainer, batches in (("gap", gap, gap_batches),
                                  ("flagship", packed, packed_batches),
                                  ("flagship", packed, packed_batches),
                                  ("gap", gap, gap_batches)):
        ms, states[tag], _ = step_ms(trainer, states[tag], batches)
        turns.setdefault(tag, []).append(ms)
    for tag, trainer, batches in (("gap", gap, gap_batches),
                                  ("flagship", packed, packed_batches),
                                  ("flagship", packed, packed_batches),
                                  ("gap", gap, gap_batches)):
        # 2 traced steps a turn: tracing and reading a step's thousand
        # launches takes seconds, and the busy time varies by < 1%
        b, wall, states[tag] = busy_ms(trainer, states[tag], batches,
                                       steps=2)
        busy.setdefault(tag, []).append((b, wall))
    log(f"[gap] {card}: ms per packed training step (median of 20, CUDA "
        f"events, in turns): gap {turns['gap'][0]:.3f} / "
        f"{turns['gap'][1]:.3f}, flagship {turns['flagship'][0]:.3f} / "
        f"{turns['flagship'][1]:.3f}")
    log(f"[gap] {card}: device busy / wall ms per step (2 steps traced, "
        "in turns): gap " + " / ".join(f"{b:.3f} / {w:.3f}"
                                        for b, w in busy["gap"])
        + ", flagship " + " / ".join(f"{b:.3f} / {w:.3f}"
                                      for b, w in busy["flagship"]))
    log(f"[gap] {card}: training molecules/s per epoch (wall clock, incl. "
        "eval and checkpoints): gap " + ", ".join(
            f"{r['molecules_per_sec']:.1f}" for r in grecords)
        + "; flagship (phase 6a) " + ", ".join(
            f"{r['molecules_per_sec']:.1f}" for r in packed_records))

    # 9b: one step on the card against the CPU under the same masks, on
    # the first packed batch as the Trainer builds it on the host
    chunks, budgets, _ = gap.plan(gap.train_idx)
    host = pad_graphs([train_graphs[i] for i in chunks[0]], budgets[0],
                      n_graph=budgets[0].n_graph or gtcfg.batch_size,
                      targets=gap.targets[chunks[0]])
    check_step_on_card_and_cpu(gcfg, None, device, tag="gap card vs cpu",
                               batch=host)
    # one gap step at AID scale: the drop instances at a D > 40 tier
    aid_tcfg = dataclasses.replace(gtcfg, pack_mixed=False, batch_size=4)
    aid_batch, _, aid_shapes = train_one_step(gcfg, aid_tcfg, aid, device,
                                              "gap AID")
    aid_tier = windows_of(aid_batch)[0]
    # 9d: alpha on a path
    alpha_shapes = alpha_on_a_path(gcfg, gap_batches[0], device)

    # 9a: the instances against their plain versions, timed
    args = batch_kernel_inputs(gap_batches[0], gcfg, seed=94)
    rows = []
    for t, win in enumerate(windows_of(gap_batches[0])):
        recs = check_masked_window(f"gap tier {t}", window_args(args, win),
                                   gcfg, seed=100 + 10 * t, timed=True)
        ichunk = win[3] > 40
        shape = window_shape(win)
        note = f"packed tier {t}, {win} of the first packed batch"
        for name, rec in recs.items():
            side, variant = name.split()
            counts = (gshapes if variant == "drop" else alpha_shapes)[
                f"{side}_variants"]
            line = {"fwd": 282 if ichunk else 166,
                    "bwd": 346 if ichunk else 198}[side]
            rows.append({
                "name": f"blocked_attn_{side} ({variant}, packed tier {t})",
                "route": "cuda",
                "source": f"x2gnn_tpu_torch/ops/csrc/blocked_attn_{side}.cu",
                "replaces": f"{PALLAS}:{line}",
                "launches": counts.get((variant, *shape), 0),
                "window": note, **rec})
    check_masked_window("gap one window", args, gcfg, seed=95, timed=False)
    aid_recs = check_masked_window(
        "gap AID tier 0", window_args(batch_kernel_inputs(
            aid_batch, gcfg, seed=96), aid_tier), gcfg, seed=97, timed=True)
    for name in ("fwd drop", "bwd drop"):
        side = name.split()[0]
        rows.append({
            "name": f"blocked_attn_{side} (drop, D>40, training tier)",
            "route": "cuda",
            "source": f"x2gnn_tpu_torch/ops/csrc/blocked_attn_{side}.cu",
            "replaces": f"{PALLAS}:{282 if side == 'fwd' else 346}",
            "launches": aid_shapes[f"{side}_variants"].get(
                ("drop", *window_shape(aid_tier)), 0),
            "window": f"gap AID-scale step, tier {aid_tier}",
            **aid_recs[name]})
    for side in ("fwd", "bwd"):
        for variant in ("drop", "drop+alpha" if side == "fwd"
                        else "drop+galpha"):
            sel = [r for r in rows if r["name"].startswith(
                f"blocked_attn_{side} ({variant}, packed")]
            log(f"[gap] {side} {variant} over the 8 tiers: "
                f"{sum(r['ms'] for r in sel):.4f} ms back to back, without "
                f"mask {sum(r['ms_without_mask'][0] for r in sel):.4f}; "
                f"launches {sum(r['launches'] for r in sel)}")
    reset_launch_counts()
    return rows, grecords

# ---- phase 10: bf16 storage, feature dtypes, remat, accumulation ----

def bf16_ulp(t):
    """One bf16 ulp of each element of t, 2^(e - 7) for 2^e <= |t| <
    2^(e+1): the bf16 gradients dq, dk, dv, de are the float32 ones rounded
    once, so against the plain version's float32 gradients they are held
    to phase 3's tolerances plus this."""
    import torch
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp(min=1e-30))) - 7)


def bf16_args(args):
    """(q, k, v and e in bf16 storage with the rest of `args`, the same
    values with q, k, v and e widened back to float32): a bf16 instance's
    inputs and its float32 twin's."""
    import torch
    low = tuple(t.to(torch.bfloat16) if i < 4 else t
                for i, t in enumerate(args))
    return low, tuple(t.float() if i < 4 else t for i, t in enumerate(low))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_bf16_window(tag, args, cfg, seed, timed):
    """Phase 10a on one window: the eight bf16 instances (forward plain,
    drop, alpha, drop+alpha; backward plain, drop, galpha, drop+galpha) on
    q, k, v and e in bf16 storage, under a seeded mask at the gap recipe's
    rate: each bitwise equal to its float32 twin on the same values widened
    to float32 (out and alpha; the dW/db partials; dq, dk, dv and de equal
    to the twin's rounded to bf16), bitwise equal on a rerun, within phase
    3's tolerances of its plain version (dq, dk, dv and de compared in
    float32 with one bf16 ulp of each element more), dead rows 0. With
    `timed`, each
    instance's device time back to back (backlog_ms) in turns with its
    float32 twin, its plain version's time, its bound (q, k, v, e and their
    gradients at 2 bytes) and occupancy; returns {"fwd <variant>" or "bwd
    <variant>": record}."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.ops.blocked_attn import (
        BWD_VARIANTS, FWD_VARIANTS, blocked_attention_bwd,
        blocked_attention_bwd_partials, blocked_attention_bwd_plain,
        blocked_attention_fwd, blocked_attention_plain, bwd_occupancy,
        bwd_plan, fwd_occupancy, fwd_plan)

    H, K = cfg.heads, cfg.rbf_dim
    low, up = bf16_args(args)
    N, DI, HC = args[0].shape
    DK = args[1].shape[1]
    dev = args[0].device
    tag = f"{tag} N={N} DI={DI} DK={DK} HC={HC}"
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(size=(N, DI, HC)).astype(
        np.float32)).to(dev)
    galpha = torch.from_numpy(rng.normal(size=(N, DI, DK, H)).astype(
        np.float32)).to(dev)
    mask = keep_mask((N, DI, DK, H), DROP_RATES[0], seed + 1, dev)
    dead = args[8] < 0
    err, outs, calls, twins, plains = {}, {}, {}, {}, {}
    for m in (None, mask):
        for want_alpha in (False, True):
            name = "fwd " + FWD_VARIANTS[4 + (m is not None)
                                         + 2 * want_alpha]
            kw = dict(heads=H, num_radial=K, dropout_mask=m,
                      return_alpha=want_alpha)
            got = _as_tuple(blocked_attention_fwd(*low, **kw))
            again = _as_tuple(blocked_attention_fwd(*low, **kw))
            twin = _as_tuple(blocked_attention_fwd(*up, **kw))
            ref = _as_tuple(blocked_attention_plain(*low, **kw))
            if not all(torch.equal(a, b) for a, b in zip(got, twin)):
                raise AssertionError(f"{name} {tag}: not its float32 twin's "
                                     "result on the widened inputs")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} {tag}: two runs differ")
            if (got[0][dead] != 0).any():
                raise AssertionError(f"{name} {tag}: a dead row is not 0")
            err[name] = max(_held(f"{name} {tag}", n, a, b, KERNEL_RTOL,
                                  KERNEL_ATOL)
                            for n, a, b in zip(("out", "alpha"), got, ref))
            if not want_alpha:
                outs[m is None] = got[0]
            calls[name] = (lambda kw=kw: blocked_attention_fwd(*low, **kw))
            twins[name] = (lambda kw=kw: blocked_attention_fwd(*up, **kw))
            plains[name] = (lambda kw=kw: blocked_attention_plain(*low,
                                                                  **kw))
        for ga in (None, galpha):
            name = "bwd " + BWD_VARIANTS[4 + (m is not None)
                                         + 2 * (ga is not None)]
            kw = dict(heads=H, num_radial=K, out=outs[m is None],
                      dropout_mask=m, galpha=ga)
            got = blocked_attention_bwd_partials(*low, g, **kw)
            again = blocked_attention_bwd_partials(*low, g, **kw)
            twin = blocked_attention_bwd_partials(*up, g, **kw)
            for n, a, b in zip(("dq", "dk", "dv", "de", "partial"), got,
                               twin):
                want = b if n == "partial" else b.to(torch.bfloat16)
                if a.dtype != want.dtype or not torch.equal(a, want):
                    raise AssertionError(
                        f"{name} {tag}: {n} is not its float32 twin's "
                        "(rounded to bf16)")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} {tag}: two runs differ")
            full = blocked_attention_bwd(*low, g, **kw)
            ref = blocked_attention_bwd_plain(*low, g, **kw)
            errs = []
            for n, a, b in zip(GRAD_NAMES, full, ref):
                e = (a.float() - b).abs()
                limit = BWD_ATOL * float(b.abs().max()) + BWD_RTOL * b.abs()
                if a.dtype == torch.bfloat16:
                    limit = limit + bf16_ulp(b)
                if (e > limit).any() or not torch.isfinite(a).all():
                    raise AssertionError(
                        f"{name} {tag}: {int((e > limit).sum())} elements "
                        f"of {n} disagree with the plain version")
                errs.append(float(e.max()))
            err[name] = max(errs)
            calls[name] = (lambda kw=kw: blocked_attention_bwd_partials(
                *low, g, **kw))
            twins[name] = (lambda kw=kw: blocked_attention_bwd_partials(
                *up, g, **kw))
            plains[name] = (lambda kw=kw: blocked_attention_bwd_plain(
                *low, g, **kw))
    log(f"[bf16 {tag}] 8 instances: bitwise their float32 twins on the "
        "widened inputs (bwd gradients rounded to bf16), reruns bitwise, "
        "within phase 3's tolerances of their plain versions; max_abs_err "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items()))
    if not timed:
        return None

    L = args[4].shape[-1] // K
    fplan, bplan = (fwd_plan(N, DI, DK, HC, H, L, K),
                    bwd_plan(N, DI, DK, HC, H, L, K))
    records = {}
    for name, fn in calls.items():
        side, variant = name.split()
        turns = {"bf16": [], "float32": []}
        for which in ("float32", "bf16", "bf16", "float32"):
            turns[which].append(backlog_ms(fn if which == "bf16"
                                           else twins[name]))
        nbytes, ops = masked_work(low, H, K, side + " "
                                  + variant[len("bf16:"):])
        bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, ops)
        occ = (fwd_occupancy(fplan, variant) if side == "fwd"
               else bwd_occupancy(bplan, variant))
        ms = turns["bf16"][0]
        records[name] = {
            "ms": ms, "ms_turns": turns["bf16"],
            "ms_float32": turns["float32"],
            "plain_ms": median_ms(plains[name], reps=10, warmup=2),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err[name], "library_ms": None,
            "warps_per_sm": occ["warps_per_sm"],
            "registers": occ["registers"], "spill_bytes": occ["spill_bytes"]}
        log(f"[bf16 {tag}] {name}: {turns['bf16'][0]:.4f} / "
            f"{turns['bf16'][1]:.4f} ms back to back, float32 twin "
            f"{turns['float32'][0]:.4f} / {turns['float32'][1]:.4f} (in "
            f"turns); plain {records[name]['plain_ms']:.4f} ms; {nbytes} "
            f"bytes ({t_bytes:.4f} ms), {ops} ops ({t_ops:.4f} ms): "
            f"{ms / bound_ms:.1f}x its bound; {occ['registers']} registers, "
            f"{occ['spill_bytes']} B spilled, {occ['warps_per_sm']} warps "
            "per SM")
    return records


def bf16_window_rows(tag, records, shape, counts, note, ichunk):
    """Rows of the kernels line for one window's bf16 instances: each
    record of check_bf16_window with its launches on the path that runs
    it (`counts`: {"fwd"/"bwd": {(variant, N, DI, DK): launches}})."""
    rows = []
    for name, rec in records.items():
        side, variant = name.split()
        line = {"fwd": 282 if ichunk else 166,
                "bwd": 346 if ichunk else 198}[side]
        rows.append({
            "name": f"blocked_attn_{side} ({variant}, {tag})",
            "route": "cuda",
            "source": f"x2gnn_tpu_torch/ops/csrc/blocked_attn_{side}.cu",
            "replaces": f"{PALLAS}:{line}",
            "launches": counts[side].get((variant, *shape), 0),
            "window": note, **rec})
    return rows


def merge_variant_counts(*shapes):
    """{"fwd"/"bwd": {(variant, N, DI, DK): launches}} of several paths'
    launch_shapes, each zeroed just before its path (their variants
    differ)."""
    out = {"fwd": {}, "bwd": {}}
    for s in shapes:
        for side in out:
            for key, n in s[f"{side}_variants"].items():
                out[side][key] = out[side].get(key, 0) + n
    return out


def cli_run(tag, extra, graphs):
    """`python -m x2gnn_tpu_torch.train` on the flagship recipe for 1 epoch
    on `graphs` molecules with the options `extra`, in a temporary
    directory kept by the caller: (workdir, its one metrics record, the
    run's args.json)."""
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    run_cli(["x2gnn_tpu_torch.train", "--config", FLAGSHIP_ARGS,
             "--synthetic", str(graphs), "--epochs", "1", "--pack-mixed",
             *extra, "--workdir", work], tag)
    (record,) = read_records(work)
    with open(os.path.join(work, "args.json")) as f:
        saved = json.load(f)
    log(f"[{tag}] epoch 1: loss {record['loss']:.6f} val_mae "
        f"{record['val_mae']:.6f} step {record['step']} bad_steps "
        f"{record['bad_steps']}; model compute_dtype "
        f"{saved['model']['compute_dtype']}, remat {saved['model']['remat']}"
        f", accum_steps {saved['train']['accum_steps']}")
    if not math.isfinite(record["loss"]) or record["bad_steps"]:
        raise AssertionError(f"{tag}: {record}")
    return work, record, saved


def grads_of_step(model, batch, generator=None):
    """One training step's loss and gradients of `model` on a cached
    batch (with attention dropout drawn from `generator` if given), every
    launch count zeroed just before and the device's peak memory reset:
    (loss, grads, launch counts, peak bytes, bytes allocated before)."""
    import torch
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    kw = ({} if generator is None
          else dict(deterministic=False, generator=generator))
    pred = model(batch, **kw)
    loss = smooth_l1_loss(pred, batch.y, mask=batch.graph_mask)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                materialize_grads=True)
    torch.cuda.synchronize()
    return (loss, grads, launch_counts(), torch.cuda.max_memory_allocated(),
            before)


def check_remat(cfg, batch, device, tag, seed=None):
    """Phase 10c on one cached batch: a step's loss and gradients with
    remat equal those without bitwise (with dropout, both drawing from a
    generator of one seed); the forward launches doubled; the peak device
    memory of both steps. Returns {remat: (peak bytes, step bytes)}."""
    import torch
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    out = {}
    for remat in (False, True):
        model = X2GNN(dataclasses.replace(cfg, remat=remat),
                      torch.Generator().manual_seed(0), device=device)
        gen = (None if seed is None
               else torch.Generator(device=device).manual_seed(seed))
        loss, grads, counts, peak, before = grads_of_step(model, batch, gen)
        out[remat] = (loss, grads, counts, peak, peak - before)
        del model
    windows = cfg.conv_layers * len(windows_of(batch))
    (l0, g0, c0, p0, s0), (l1, g1, c1, p1, s1) = out[False], out[True]
    log(f"[{tag}] one step on N, D = {tuple(batch.in_edges.shape)}: "
        f"launches without remat {c0}, with remat {c1}; peak device memory "
        f"{p0 / 2**20:.1f} MiB without, {p1 / 2**20:.1f} MiB with remat "
        f"(the step's own {s0 / 2**20:.1f} against {s1 / 2**20:.1f} MiB)")
    if not (torch.equal(l0, l1)
            and all(torch.equal(a, b) for a, b in zip(g0, g1))):
        raise AssertionError(f"{tag}: gradients with remat differ")
    if (c0 != {"fwd": windows, "bwd": windows, "reduce": windows}
            or c1 != {"fwd": 2 * windows, "bwd": windows,
                      "reduce": windows}):
        raise AssertionError(f"{tag}: launches {c0}, {c1}")
    log(f"[{tag}] loss and all {len(g0)} gradients bitwise equal with and "
        "without remat")
    return {False: (p0, s0), True: (p1, s1)}


def check_accumulation(cfg, tcfg, graphs, device):
    """Phase 10d: accum_steps=2 on int8 features (per-edge scales in the
    device cache): four micro-steps, the parameters unchanged after the
    first and third (not emitting) and moved after the second and fourth,
    the losses finite."""
    import torch
    trainer = flagship_trainer(cfg, dataclasses.replace(tcfg, accum_steps=2),
                               graphs, device, "unused", feat_dtype="int8")
    batches = trainer.batches(trainer.train_idx)
    b0 = batches[0]
    if b0.edge_feat.dtype != torch.int8 or b0.edge_feat_scale is None:
        raise AssertionError("accum: the cached features are not int8")
    state = trainer.init_state()
    moved, losses = [], []
    for i in range(4):
        before = [p.detach().clone() for p in state.params]
        state, loss = trainer.train_step(state, batches[i])
        losses.append(float(loss))
        moved.append(not all(torch.equal(a, b)
                             for a, b in zip(before, state.params)))
    log(f"[accum] accum_steps=2, int8 features ({b0.edge_feat.shape} int8 + "
        f"{tuple(b0.edge_feat_scale.shape)} scales): losses {losses}, "
        f"parameters moved after micro-steps {moved}, Adam count "
        f"{int(state.opt_state.count)}, micro-step {int(state.opt_state.mini_step)}")
    if (moved != [False, True, False, True]
            or not all(math.isfinite(x) for x in losses)
            or int(state.opt_state.count) != 2 or int(state.bad_steps)):
        raise AssertionError(f"accum: moved {moved}, losses {losses}")


def predict_rate(pred, graphs, calls=3):
    """Molecules/s of `calls` predict calls after one warm-up."""
    pred.predict(graphs)
    t0 = time.perf_counter()
    for _ in range(calls):
        pred.predict(graphs)
    return len(graphs) * calls / (time.perf_counter() - t0)


def bf16_recipe(card, device, train_graphs, aid, qm9, packed, pstate, pred,
                train_batch):
    """Phase 10: the flagship recipe with its precision and memory options
    (bf16 conv stack, float16 and int8 features, remat, accumulation) on
    the card; `packed`/`pstate` are phase 6a's float32 trainer and state,
    `pred` phase 4's float32 Predictor, `train_batch` the one-window fixed
    batch of phase 6c. Returns the rows of the kernels line."""
    import torch
    from x2gnn_tpu_torch.data.batching import pad_graphs
    from x2gnn_tpu_torch.infer import Predictor
    from x2gnn_tpu_torch.ops.blocked_attn import (
        blocked_attention, reset_launch_counts)
    from x2gnn_tpu_torch.profile_training import flagship_training_configs
    from x2gnn_tpu_torch.train.trainer import cast_feat
    from x2gnn_tpu_torch.utils.determinism import (
        check_train_step_determinism)

    mcfg, tcfg = flagship_training_configs()
    bcfg = dataclasses.replace(mcfg, compute_dtype="bfloat16")
    btcfg = dataclasses.replace(tcfg, max_epoch=1)
    gcfg, gtcfg = gap_training_configs()
    gbcfg = dataclasses.replace(gcfg, compute_dtype="bfloat16")

    # 10b: the recipe with --compute-dtype bfloat16 --feat-dtype float16
    bf, bstate, brecords, _, bshapes = train_flagship(
        bcfg, btcfg, train_graphs, device, "bf16", feat_dtype="float16")
    bbatches = bf.batches(bf.train_idx)
    variants = {side: per_variant(bshapes[f"{side}_variants"])
                for side in ("fwd", "bwd")}
    log(f"[bf16] launches per variant in the epoch {json.dumps(variants)}")
    if set(variants["fwd"]) != {"bf16:plain"} or set(
            variants["bwd"]) != {"bf16:plain"}:
        raise AssertionError(f"bf16: launches {variants}")
    reset_launch_counts()
    bstate, _ = bf.train_step(bstate, bbatches[0])
    torch.cuda.synchronize()
    step_counts = {"fwd": per_variant(launch_shapes()["fwd_variants"]),
                   "bwd": per_variant(launch_shapes()["bwd_variants"]),
                   "reduce": launch_counts()["reduce"]}
    n = mcfg.conv_layers * len(windows_of(bbatches[0]))
    log(f"[bf16] one packed step: launches {json.dumps(step_counts)} "
        f"(expected {n} bf16 forwards, backwards and reduces)")
    if step_counts != {"fwd": {"bf16:plain": n}, "bwd": {"bf16:plain": n},
                       "reduce": n}:
        raise AssertionError(f"bf16 step: launches {step_counts}")
    report = check_train_step_determinism(bf, repeats=2)
    log(f"[bf16] train step, 2 repeats: mismatches "
        f"{json.dumps(report['mismatches'])}")
    if not report["deterministic"]:
        raise AssertionError("bf16: the training step differs between two "
                             "runs")
    chunks, budgets, _ = bf.plan(bf.train_idx)
    host = pad_graphs([train_graphs[i] for i in chunks[0]], budgets[0],
                      n_graph=budgets[0].n_graph or btcfg.batch_size,
                      targets=bf.targets[chunks[0]])
    check_step_on_card_and_cpu(bcfg, None, device, tag="bf16 card vs cpu",
                               batch=cast_feat(host, "float16"))
    packed_batches = packed.batches(packed.train_idx)
    turns, busy = {}, {}
    states = {"bf16": bstate, "float32": pstate}
    order = (("bf16", bf, bbatches), ("float32", packed, packed_batches),
             ("float32", packed, packed_batches), ("bf16", bf, bbatches))
    for tag, trainer, batches in order:
        ms, states[tag], _ = step_ms(trainer, states[tag], batches)
        turns.setdefault(tag, []).append(ms)
    for tag, trainer, batches in order:
        b, wall, states[tag] = busy_ms(trainer, states[tag], batches,
                                       steps=2)
        busy.setdefault(tag, []).append((b, wall))
    log(f"[bf16] {card}: ms per packed training step (median of 20, CUDA "
        f"events, in turns): bf16 + float16 features {turns['bf16'][0]:.3f}"
        f" / {turns['bf16'][1]:.3f}, float32 {turns['float32'][0]:.3f} / "
        f"{turns['float32'][1]:.3f}")
    log(f"[bf16] {card}: device busy / wall ms per step (2 steps traced, "
        "in turns): bf16 " + " / ".join(f"{b:.3f} / {w:.3f}"
                                         for b, w in busy["bf16"])
        + ", float32 " + " / ".join(f"{b:.3f} / {w:.3f}"
                                     for b, w in busy["float32"]))
    log(f"[bf16] {card}: training molecules/s in the epoch "
        f"{brecords[0]['molecules_per_sec']:.1f} (loss "
        f"{brecords[0]['loss']:.6f}, val_mae {brecords[0]['val_mae']:.6f})")

    # 10c: remat, bf16 flagship and bf16 gap (dropout drawn before the
    # checkpointed call), the first packed batch cached with float16
    check_remat(bcfg, bbatches[0], device, "remat")
    check_remat(gbcfg, bbatches[0], device, "remat gap", seed=11)
    # 10d: accumulation on int8 features
    check_accumulation(bcfg, btcfg, train_graphs, device)
    # 10b and 10d by the training CLI, the two runs at once (nothing is
    # timed meanwhile): the bf16 recipe on float16 features, and all four
    # options
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(cli_run, tag, extra, len(train_graphs))
                for tag, extra in (
                    ("bf16 cli train", ["--compute-dtype", "bfloat16",
                                        "--feat-dtype", "float16"]),
                    ("remat accum cli train", [
                        "--compute-dtype", "bfloat16", "--feat-dtype",
                        "int8", "--remat", "--accum-steps", "2"]))]
        (work_b, _, saved_b), (work_r, _, saved_r) = [r.result()
                                                      for r in runs]
    if (saved_b["model"]["compute_dtype"] != "bfloat16"
            or (saved_r["model"]["remat"], saved_r["train"]["accum_steps"])
            != (True, 2)):
        raise AssertionError(f"cli train: {saved_b}, {saved_r}")

    # 10e: a Predictor from the bf16 run serves the 256 molecules
    bpred = Predictor.from_run(work_b, device=device)
    reset_launch_counts()
    serve(bpred, qm9, mcfg.conv_layers * math.ceil(len(qm9) / 32),
          "bf16 from_run")
    if set(per_variant(blocked_attention.by_variant)) != {"bf16:plain"}:
        raise AssertionError("bf16 from_run: launches "
                             f"{dict(blocked_attention.by_variant)}")
    rates = {}
    for tag, p in (("float32", pred), ("bf16", bpred), ("bf16", bpred),
                   ("float32", pred)):
        rates.setdefault(tag, []).append(predict_rate(p, qm9))
    log(f"[bf16 serve] {card}: molecules/s (256 QM9-scale, batch 32, mean "
        "of 3 calls, in turns): bf16 " + " / ".join(
            f"{r:.1f}" for r in rates["bf16"]) + ", float32 " + " / ".join(
            f"{r:.1f}" for r in rates["float32"]))
    for work in (work_b, work_r):
        shutil.rmtree(work, ignore_errors=True)

    # the bf16 instances' paths: the gap recipe in bf16 (drop), and conv_0
    # with its attention weights (alpha; drop+alpha)
    gap = flagship_trainer(gbcfg, gtcfg, train_graphs, device, "unused")
    gbatches = gap.batches(gap.train_idx)
    gstate = gap.init_state()
    reset_launch_counts()
    for i in range(2):
        gstate, _ = gap.train_step(gstate, gbatches[i], i)
    torch.cuda.synchronize()
    drop_shapes = launch_shapes()
    alpha_shapes = alpha_on_a_path(gbcfg, gbatches[0], device,
                                   deterministic=True)
    drop_alpha_shapes = alpha_on_a_path(gbcfg, gbatches[0], device)
    counts = merge_variant_counts(bshapes, drop_shapes, alpha_shapes,
                                  drop_alpha_shapes)
    aid_tcfg = dataclasses.replace(tcfg, pack_mixed=False, batch_size=4)
    aid_batch, _, aid_shapes = train_one_step(bcfg, aid_tcfg, aid, device,
                                              "bf16 AID")
    aid_tier = windows_of(aid_batch)[0]

    # 10a: the eight bf16 instances on every tier of the first packed
    # batch, the batch whole, the AID tier and HC=1024
    args = batch_kernel_inputs(bbatches[0], bcfg, seed=101)
    rows = []
    for t, win in enumerate(windows_of(bbatches[0])):
        recs = check_bf16_window(f"bf16 tier {t}", window_args(args, win),
                                 bcfg, seed=110 + 10 * t, timed=True)
        rows += bf16_window_rows(
            f"packed tier {t}", recs, window_shape(win), counts,
            f"packed tier {t}, {win} of the first packed batch",
            win[3] > 40)
    check_bf16_window("bf16 one window", args, bcfg, seed=102, timed=False)
    aid_recs = check_bf16_window(
        "bf16 AID tier 0", window_args(batch_kernel_inputs(
            aid_batch, bcfg, seed=103), aid_tier), bcfg, seed=104,
        timed=True)
    rows += bf16_window_rows(
        "D>40, training tier",
        {k: v for k, v in aid_recs.items() if k.endswith("bf16:plain")},
        window_shape(aid_tier), merge_variant_counts(aid_shapes),
        f"bf16 AID-scale step, tier {aid_tier}", True)
    cfg_wide = dataclasses.replace(bcfg, in_channels=1024, heads=128)
    wide_args = batch_kernel_inputs(train_batch, cfg_wide, seed=105)
    n_slots = wide_args[0].shape[1]
    check_bf16_window("bf16 HC=1024", window_args(
        wide_args, (0, 128, n_slots, n_slots)), cfg_wide, seed=106,
        timed=False)
    for name in sorted({r["name"].split(",")[0] for r in rows
                        if "packed tier" in r["name"]}):
        sel = [r for r in rows if r["name"].startswith(name + ", packed")]
        log(f"[bf16] {name[len('blocked_attn_'):]}) over the 8 tiers: "
            f"{sum(r['ms'] for r in sel):.4f} ms back to back, float32 "
            f"twin {sum(r['ms_float32'][0] for r in sel):.4f}; bound "
            f"{sum(r['bound_ms'] for r in sel):.5f} ms; launches "
            f"{sum(r['launches'] for r in sel)}")
    reset_launch_counts()
    return rows


# ---- phase 11: the host data pipeline and the profiling hooks ----

PHASE11_SEED, PHASE11_MOLECULES, PHASE11_MEAN_ATOMS = 7, 128, 18
# untraced epochs per turn of 11c's step times: one epoch is 4 steps, and
# the host's clock spreads a 4-step mean by more than the modes differ
WALL_EPOCHS = 5


def _numpy_integrals(index):
    """The numpy engine's (S, H/nelec, ao_slices) of the builder's
    molecule `index` in 6-311+G(3df,2p) (a worker of a spawned pool), and
    its seconds."""
    from x2gnn_tpu_torch.data.integrals.basis import get_basis
    from x2gnn_tpu_torch.data.integrals.md import one_electron_matrices_numpy
    from x2gnn_tpu_torch.data.synthetic import synthetic_geometry
    numbers, pos = synthetic_geometry(index, seed=PHASE11_SEED,
                                      mean_atoms=PHASE11_MEAN_ATOMS)
    t0 = time.perf_counter()
    out = one_electron_matrices_numpy(numbers, pos,
                                      get_basis("6-311+g(3df,2p)"))
    return out, time.perf_counter() - t0


def build_phase11_set(work):
    """11a: the integral engine built from the repository's source by its
    CLI (`python -m x2gnn_tpu_torch.data.integrals.build`, a subprocess:
    the printed path is the one the engine loads), the builder's labelled
    molecules (a subprocess that then runs no g++ of its own), 2 held against
    the numpy engine (S rtol 1e-10, H rtol 1e-8, as
    tests/test_torch_port_featurize.py holds them), and the xyz file of
    their float64 geometry and labels. Returns (graphs, xyz path, ms per
    molecule of the builder)."""
    import multiprocessing

    import numpy as np
    from x2gnn_tpu_torch.data.dataset import load_graph_cache
    from x2gnn_tpu_torch.data.integrals import engine
    from x2gnn_tpu_torch.data.integrals.basis import get_basis
    from x2gnn_tpu_torch.data.molecule import Molecule, write_xyz
    from x2gnn_tpu_torch.data.synthetic import synthetic_geometry

    cores = os.cpu_count()
    # the engine built once by its CLI, then the builder's workers load it
    t0 = time.perf_counter()
    proc = run_cli(["x2gnn_tpu_torch.data.integrals.build"], "engine build")
    path = proc.stdout.strip()
    compiled = bool(proc.stderr.strip())     # the g++ command, if it ran
    log(f"[data] integral engine: `python -m x2gnn_tpu_torch.data.integrals"
        f".build` {time.perf_counter() - t0:.2f} s -> {path} ("
        f"{'compiled by g++' if compiled else 'built before on this host'})"
        f"; {cores} host cores")
    if path != engine.library_path():
        raise AssertionError(f"engine build: printed {path!r}, the engine "
                             f"loads {engine.library_path()!r}")
    t0 = time.perf_counter()
    builder = run_cli([
        "x2gnn_tpu_torch.data.make_synthetic", "--n",
        str(PHASE11_MOLECULES), "--name", "phase11", "--seed",
        str(PHASE11_SEED), "--mean-atoms", str(PHASE11_MEAN_ATOMS),
        "--chunk", str(PHASE11_MOLECULES), "--cache-dir",
        os.path.join(work, "built"), "--workers", str(cores), "--basis",
        "6311", "--gap-label"], "data builder")
    builder_ms = (time.perf_counter() - t0) * 1e3 / PHASE11_MOLECULES
    if f"integral engine {path} (0.00 s g++)" not in builder.stderr:
        raise AssertionError("data builder: it ran g++ of its own after the "
                             "engine's build CLI")
    graphs = load_graph_cache(os.path.join(work, "built", "phase11.npz"))
    sizes = [g.num_atoms for g in graphs]
    log(f"[data] builder: {len(graphs)} molecules of {min(sizes)}-"
        f"{max(sizes)} atoms (mean {np.mean(sizes):.2f}), "
        f"{sum(g.num_edges for g in graphs)} edges, {builder_ms:.3f} ms per "
        f"molecule wall over {cores} worker processes (engine build, "
        "process start and the cache's write included)")
    if len(graphs) != PHASE11_MOLECULES or not all(
            g.y.shape == (2,) and np.isfinite(g.y).all()
            and g.edge_feat.any() for g in graphs):
        raise AssertionError("data builder: bad molecules")
    # the C++ engine in this process, one molecule at a time on all cores;
    # then the numpy engine on the 2 smallest, 2 spawned processes at once
    basis = get_basis("6-311+g(3df,2p)")
    t0 = time.perf_counter()
    for i in range(16):
        numbers, pos = synthetic_geometry(i, seed=PHASE11_SEED,
                                          mean_atoms=PHASE11_MEAN_ATOMS)
        engine.one_electron_matrices(numbers, pos, basis)
    cpp_ms = (time.perf_counter() - t0) * 1e3 / 16
    smallest = sorted(range(len(graphs)), key=lambda i: sizes[i])[:2]
    cpp, cpp_small_ms = {}, []
    for i in smallest:
        numbers, pos = synthetic_geometry(i, seed=PHASE11_SEED,
                                          mean_atoms=PHASE11_MEAN_ATOMS)
        t0 = time.perf_counter()
        cpp[i] = engine.one_electron_matrices(numbers, pos, basis)
        cpp_small_ms.append((time.perf_counter() - t0) * 1e3)
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        numpy_results = pool.map(_numpy_integrals, smallest)
    worst = [0.0, 0.0]
    for i, ((s, h, ao), _) in zip(smallest, numpy_results):
        cs, ch, cao = cpp[i]
        np.testing.assert_allclose(cs, s, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(ch, h, rtol=1e-8, atol=1e-10)
        np.testing.assert_array_equal(cao, ao)
        worst = [max(worst[0], float(np.abs(cs - s).max())),
                 max(worst[1], float(np.abs(ch - h).max()))]
    numpy_ms = [1e3 * sec for _, sec in numpy_results]
    log(f"[data] C++ engine {cpp_ms:.3f} ms per molecule (molecules 0-15 "
        f"of {np.mean(sizes[:16]):.2f} atoms on average, one at a time, "
        f"OpenMP on {cores} cores); on molecules {smallest} of "
        f"{[sizes[i] for i in smallest]} atoms: numpy engine "
        f"{', '.join(f'{ms:.1f}' for ms in numpy_ms)} ms (one process "
        f"each, 2 at once), C++ "
        f"{', '.join(f'{ms:.3f}' for ms in cpp_small_ms)} ms; C++ vs numpy "
        f"max |dS| {worst[0]:.3e}, max |dH| {worst[1]:.3e}")
    mols = []
    for i, g in enumerate(graphs):
        numbers, pos = synthetic_geometry(i, seed=PHASE11_SEED,
                                          mean_atoms=PHASE11_MEAN_ATOMS)
        mols.append(Molecule(numbers, pos, g.y, i))
    xyz = os.path.join(work, "phase11.xyz")
    write_xyz(xyz, mols)
    return graphs, xyz, builder_ms


def streamed_epochs(mcfg, tcfg, graphs, device, work, card):
    """11c: one epoch of the flagship recipe with cache_batches True,
    False and "host" from the same weights, every count zeroed just before
    each: records (but the wall clock's), state and launches bitwise
    equal. The first streamed batch of the `off` epoch's trainer (read
    after its copy's event) equals the batch assembled on the host bitwise;
    on each of its tiers the forward and backward kernels are held against
    their plain versions at phase 3's tolerances and timed, and one step
    on it runs on the card and on the CPU. Then each mode's step in turns
    (cached, off, host, host, off, cached): WALL_EPOCHS untraced epochs
    (wall ms per step of each) and one under torch.profiler (device busy
    ms per step, idle share). Returns (turns, the kernel rows of the
    streamed tiers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from x2gnn_tpu_torch.data.batching import pad_graphs
    from x2gnn_tpu_torch.data.dataset import prepare_targets
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.profile_serving import device_rows
    from x2gnn_tpu_torch.train.trainer import Trainer
    from x2gnn_tpu_torch.utils.determinism import tree_bitwise_diff

    targets = prepare_targets(graphs, tcfg.target)
    runs = {}
    for mode in (True, False, "host"):
        model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)
        tr = Trainer(model, mcfg, tcfg, graphs, targets,
                     workdir=os.path.join(work, f"cache_{mode}"),
                     device=device, cache_batches=mode)
        reset_launch_counts()
        state, _ = tr.fit(epochs=1)
        torch.cuda.synchronize()
        counts, shapes = launch_counts(), launch_shapes()
        records = [{k: v for k, v in r.items()
                    if k != "seconds" and not k.endswith("_per_sec")}
                   for r in read_records(tr.workdir)]
        runs[mode] = (tr, state, records, counts, shapes)
        log(f"[data cache {mode}] epoch 1: loss {records[0]['loss']:.6f} "
            f"val_mae {records[0]['val_mae']:.6f} step {records[0]['step']}"
            f", launches {counts}")
    ref = runs[True]
    for mode in (False, "host"):
        tr, state, records, counts, shapes = runs[mode]
        diffs = tree_bitwise_diff(ref[1], state)
        if (records != ref[2] or diffs or counts != ref[3]
                or shapes != ref[4]):
            raise AssertionError(
                f"cache_batches={mode!r} differs from the cached epoch: "
                f"records equal {records == ref[2]}, launches {counts} vs "
                f"{ref[3]}, per shape equal {shapes == ref[4]}, state "
                f"{diffs[:4]}")
        log(f"[data cache {mode}] records, state and launches per shape "
            "bitwise those of the cached epoch")
    # the first streamed batch against the host's assembly of its plan
    # entry, then the kernels on its tiers and one step card vs CPU
    off, off_counts, off_shapes = runs[False][0], runs[False][3], \
        runs[False][4]
    chunks, budgets, _ = off.plan(off.train_idx)
    host = pad_graphs([graphs[i] for i in chunks[0]], budgets[0],
                      n_graph=budgets[0].n_graph or tcfg.batch_size,
                      targets=off.targets[chunks[0]])
    streamed = off.first_batch(off.train_idx)
    torch.cuda.synchronize()
    want = host.to("cpu")
    if (streamed.positions.device.type != "cuda"
            or (streamed.tiers, streamed.n_hi, streamed.d_lo)
            != (want.tiers, want.n_hi, want.d_lo)
            or len(streamed.arrays()) != len(want.arrays())
            or not all(torch.equal(a.cpu(), b) for a, b in
                       zip(streamed.arrays(), want.arrays()))):
        raise AssertionError("the first streamed batch differs from its "
                             "host assembly")
    n, d = streamed.in_edges.shape
    log(f"[data streamed] first batch (N={n}, D={d}, "
        f"{int(streamed.graph_mask.sum())} molecules, tiers "
        f"{streamed.tiers}) bitwise its host assembly")
    args = batch_kernel_inputs(streamed, mcfg, seed=60)
    fwd_src = "x2gnn_tpu_torch/ops/csrc/blocked_attn_fwd.cu"
    bwd_src = "x2gnn_tpu_torch/ops/csrc/blocked_attn_bwd.cu"
    rows, reduces = [], []
    for t, win in enumerate(windows_of(streamed)):
        fwd, (bwd, red) = check_window(
            f"data streamed tier {t}", window_args(args, win), mcfg,
            seed=61 + t, fwd_timed=True, bwd_timed=True)
        reduces.append((win, red))
        ichunk = win[3] > 40      # the reference's i-chunked kernels
        note = (f"streamed tier {t}, {win} of the first streamed batch "
                "(phase 11)")
        rows += [
            {"name": f"blocked_attn_fwd (streamed tier {t})",
             "route": "cuda", "source": fwd_src,
             "replaces": f"{PALLAS}:{282 if ichunk else 166}",
             "launches": off_shapes["fwd"].get(window_shape(win), 0),
             "window": note, **fwd},
            {"name": f"blocked_attn_bwd (streamed tier {t})",
             "route": "cuda", "source": bwd_src,
             "replaces": f"{PALLAS}:{346 if ichunk else 198}",
             "launches": off_shapes["bwd"].get(window_shape(win), 0),
             "window": note, **bwd}]
        log(f"[data streamed] tier {win}: forward {fwd['ms']:.4f} ms, "
            f"backward {bwd['ms']:.4f} ms, reduce {red['ms']:.4f} ms; "
            f"launches in the off epoch {rows[-2]['launches']} / "
            f"{rows[-1]['launches']}")
    win, red = max(reduces, key=lambda r: r[0][1] - r[0][0])
    rows.append(
        {"name": "blocked_attn_bwd_reduce (streamed tiers)", "route": "cuda",
         "source": bwd_src, "replaces": f"{PALLAS}:271",
         "launches": off_counts["reduce"],
         "window": f"partials of streamed tier {win} (phase 11)", **red})
    del args
    check_step_on_card_and_cpu(mcfg, None, device, tag="data card vs cpu",
                               batch=host)
    steps = int(ref[1].step)
    turns, epoch = {}, 1
    for mode in (True, False, "host", "host", False, True):
        tr, state = runs[mode][:2]
        walls = []
        for _ in range(WALL_EPOCHS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = tr.run_epoch(state, epoch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / steps)
            epoch += 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = tr.run_epoch(state, epoch)
            torch.cuda.synchronize()
            traced = (time.perf_counter() - t0) * 1e3 / steps
        epoch += 1
        busy = sum(r[0] for r in device_rows(prof)) / 1e3 / steps
        runs[mode] = (tr, state) + runs[mode][2:]
        wall = statistics.median(walls)
        turns.setdefault(mode, []).append((wall, traced, busy))
        log(f"[data cache {mode}] untraced ms per step over {WALL_EPOCHS} "
            f"epochs: median {wall:.3f}, min {min(walls):.3f}, max "
            f"{max(walls):.3f}; traced {traced:.3f}, device busy "
            f"{busy:.3f} ms per step, idle share {1 - busy / traced:.3f} "
            f"({steps} steps per epoch, {card})")
    return turns, rows


def data_pipeline(card, device):
    """Phase 11: molecules to predictions through the port's own host
    pipeline, at the flagship's full width: the builder and the integral
    engine (11a), `python -m x2gnn_tpu_torch.train --data` (11b), the
    Trainer's cache modes (11c), predict_xyz (11d), --profile-dir and
    --check-determinism (11e)."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.data.dataset import load_dataset
    from x2gnn_tpu_torch.infer import Predictor
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.profile_training import flagship_training_configs
    from x2gnn_tpu_torch.utils.profiling import TRACE_FILE

    work = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        t_phase = time.perf_counter()
        built, xyz, builder_ms = build_phase11_set(work)
        # 11b: the training CLI featurizes the xyz file (before it touches
        # the card) and trains 1 epoch of the flagship recipe
        cache = os.path.join(work, "processed")
        run = os.path.join(work, "run")
        data = ["--data", xyz, "--backend", "native6311", "--cache-dir",
                cache]
        t0 = time.perf_counter()
        run_cli(["x2gnn_tpu_torch.train", "--config", FLAGSHIP_ARGS, *data,
                 "--pack-mixed", "--epochs", "1", "--ckpt-every", "1",
                 "--workdir", run], "data train --data")
        cli_s = time.perf_counter() - t0
        graphs = load_dataset(xyz, cache_dir=cache, backend="native6311")
        if os.listdir(cache) != ["phase11_native6311_c5.npz"]:
            raise AssertionError(f"--data cache {os.listdir(cache)}")
        for g, b in zip(graphs, built):
            for f in ("edge_index", "edge_feat", "numbers"):
                if not np.array_equal(getattr(g, f), getattr(b, f)):
                    raise AssertionError(f"--data {f} of molecule {g.index}"
                                         " differs from the builder's")
        (record,) = read_records(run)
        with open(os.path.join(run, "provenance.json")) as f:
            prov = json.load(f)
        log(f"[data train --data] {cli_s:.1f} s for featurizing "
            f"{len(graphs)} molecules and 1 epoch; features bitwise the "
            f"builder's; epoch 1 loss {record['loss']:.6f} val_mae "
            f"{record['val_mae']:.6f} step {record['step']}; provenance "
            f"{prov}")
        if (not math.isfinite(record["loss"]) or record["bad_steps"]
                or prov != {"basis": "6-311+g(3df,2p)-native"}):
            raise AssertionError(f"--data run: {record}, {prov}")
        # 11c: the cache modes, in-process
        mcfg, tcfg = flagship_training_configs()
        tcfg = dataclasses.replace(tcfg, max_epoch=1)
        turns, rows = streamed_epochs(mcfg, tcfg, graphs, device, work,
                                      card)
        # 11d: the run serves the first 64 molecules of the xyz file,
        # featurized again in this process (by a spawned pool: this
        # process holds the card)
        pred = Predictor.from_run(run, device=device)
        n_serve = min(64, len(graphs))
        t0 = time.perf_counter()
        reset_launch_counts()
        got = pred.predict_xyz(xyz, backend="native6311", limit=n_serve,
                               cache_dir=os.path.join(work, "serve"))
        torch.cuda.synchronize()
        xyz_s = time.perf_counter() - t0
        serve_launches = launch_counts()["fwd"]
        want = pred.predict(graphs[:n_serve])
        if (got.shape != (n_serve,) or not np.isfinite(got).all()
                or not np.array_equal(got, want)):
            raise AssertionError("predict_xyz differs from predict on "
                                 "load_dataset's graphs")
        log(f"[data predict_xyz] {len(got)} predictions in {xyz_s:.2f} s "
            f"(featurizing included), {serve_launches} forward launches, "
            "bitwise predict(load_dataset graphs)")
        # 11e: --profile-dir traces epoch 2 and --check-determinism runs
        # first, on 64 molecules of (b)'s cache
        prof_dir = os.path.join(work, "profile")
        proc = run_cli(["x2gnn_tpu_torch.train", "--config", FLAGSHIP_ARGS,
                        "--data-npz",
                        os.path.join(cache, "phase11_native6311_c5.npz"),
                        "--limit", "64", "--pack-mixed", "--epochs", "2",
                        "--cache-batches", "host", "--check-determinism",
                        "--profile-dir", prof_dir, "--workdir",
                        os.path.join(work, "run_profiled")],
                       "data --profile-dir --check-determinism")
        trace = os.path.join(prof_dir, TRACE_FILE)
        if ("determinism check: OK" not in proc.stderr
                or not os.path.exists(trace)):
            raise AssertionError("--check-determinism or --profile-dir "
                                 "failed")
        log(f"[data --profile-dir] determinism check: OK; trace "
            f"{os.path.getsize(trace)} bytes ({trace})")
        log(f"[data] phase 11 took {time.perf_counter() - t_phase:.1f} s; "
            f"builder {builder_ms:.3f} ms per molecule; step ms (untraced, "
            "traced, busy) per mode in turns: " + "; ".join(
                f"{mode}: {v}" for mode, v in turns.items()))
        return rows
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---- phase 12: v2 and the beta gate; the segment and padded layouts ----

# the three layouts against each other: tests/test_model_v2.py:52's
# tolerance, the absolute part scaled by the largest |prediction|
LAYOUT_RTOL, LAYOUT_ATOL = 5e-4, 5e-5


def held_across_layouts(tag, got, ref):
    import numpy as np
    scale = float(np.abs(ref).max())
    err = np.abs(got - ref)
    log(f"[{tag}] max_abs={err.max():.3e} max_rel="
        f"{(err / np.maximum(np.abs(ref), 1e-30)).max():.3e} (|pred| max "
        f"{scale:.3e}; limit rtol {LAYOUT_RTOL} + {LAYOUT_ATOL} x max)")
    np.testing.assert_allclose(got, ref, rtol=LAYOUT_RTOL,
                               atol=LAYOUT_ATOL * scale, err_msg=tag)


def first_host_batch(trainer):
    """The host assembly of the trainer's first training batch."""
    return trainer._assemble(trainer._plan_of(trainer.train_idx)[0])


def step_turn(tag, trainer, state, batches):
    """Step ms (CUDA events), busy ms (traced) and a step's peak device
    memory (phase 10c's method) on cached batches; counts zeroed before."""
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    reset_launch_counts()
    ms, state, steps = step_ms(trainer, state, batches)
    counts = {k: v / steps for k, v in launch_counts().items()}
    busy, wall, state = busy_ms(trainer, state, batches)
    _, _, _, peak, before = grads_of_step(trainer.model, batches[0])
    log(f"[layouts {tag}] {ms:.3f} ms per step (median of 20, CUDA "
        f"events), busy {busy:.3f} ms, wall {wall:.3f} ms traced, idle "
        f"{1 - busy / wall:.3f}; peak device memory of a step "
        f"{peak / 2**20:.1f} MiB (the step's own {(peak - before) / 2**20:.1f}"
        f" MiB); attention launches per step {counts}")
    return {"ms": ms, "busy": busy, "peak": peak, "own": peak - before}, state


def v2_beta_blocked(card, device, qm9, train_graphs, mcfg, tcfg, pred,
                    packed, pstate):
    """Phase 12a: the flagship with variant v2 and the beta gate on the
    blocked layout: serving (launches, card vs CPU), one packed step
    (launches, card vs CPU, bitwise rerun), and molecules/s, step and busy
    ms in turns with the v1 flagship (phase 4's Predictor, phase 6a's
    trainer)."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.infer import Predictor
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.utils.determinism import (
        check_train_step_determinism)

    cfg = dataclasses.replace(mcfg, variant="v2", beta=True)
    model = X2GNN(cfg, torch.Generator().manual_seed(0), device=device)
    v2 = Predictor(cfg, model, batch_size=32, device=device)
    out, launches = serve(v2, qm9, cfg.conv_layers * math.ceil(len(qm9) / 32),
                          "v2+beta")
    cpu = Predictor(cfg, copy.deepcopy(model).to("cpu"), batch_size=32,
                    device="cpu").predict(qm9[:32])
    diff = np.abs(out[:32] - cpu)
    log(f"[serve v2+beta] card vs CPU on 32 molecules: max_abs="
        f"{diff.max():.3e} (|pred| max {np.abs(cpu).max():.3e})")
    np.testing.assert_allclose(out[:32], cpu, rtol=MODEL_RTOL,
                               atol=MODEL_ATOL)
    trainer = flagship_trainer(cfg, tcfg, train_graphs, device, "unused")
    batches = trainer.batches(trainer.train_idx)
    state = trainer.init_state()
    reset_launch_counts()
    state, loss = trainer.train_step(state, batches[0])
    torch.cuda.synchronize()
    counts = launch_counts()
    n = cfg.conv_layers * len(windows_of(batches[0]))
    log(f"[train v2+beta] one packed step on N, D = "
        f"{tuple(batches[0].in_edges.shape)}, {len(windows_of(batches[0]))} "
        f"windows: loss {float(loss):.6f}, launches {counts} (expected {n} "
        "each)")
    if counts != {"fwd": n, "bwd": n, "reduce": n} or not math.isfinite(
            float(loss)):
        raise AssertionError(f"v2+beta step: launches {counts}")
    check_step_on_card_and_cpu(cfg, None, device, "v2+beta card vs cpu",
                               batch=first_host_batch(trainer))
    report = check_train_step_determinism(trainer, repeats=2)
    log(f"[train v2+beta] step rerun: mismatches "
        f"{json.dumps(report['mismatches'])}")
    if not report["deterministic"]:
        raise AssertionError("v2+beta: the step differs on a rerun")
    rates, turns = {}, {}
    states = {"v1": pstate, "v2+beta": state}
    runs = {"v1": (pred, packed, packed.batches(packed.train_idx)),
            "v2+beta": (v2, trainer, batches)}
    for name in ("v1", "v2+beta", "v2+beta", "v1"):
        p, tr, bs = runs[name]
        rates.setdefault(name, []).append(predict_rate(p, qm9))
        turn, states[name] = step_turn(name, tr, states[name], bs)
        turns.setdefault(name, []).append(turn)
    for name in ("v1", "v2+beta"):
        log(f"[layouts {name}] {card}: serving " + " / ".join(
            f"{r:.1f}" for r in rates[name]) + " molecules/s; packed step "
            + " / ".join(f"{t['ms']:.3f}" for t in turns[name]) + " ms, busy "
            + " / ".join(f"{t['busy']:.3f}" for t in turns[name]) + " ms")


def flat_layouts(card, device, qm9, train_graphs, mcfg, tcfg, model, pred,
                 packed, pstate):
    """Phase 12b, 12d, 12e: phase 4's flagship weights in the segment and
    padded layouts: serving the 256 molecules against the blocked
    predictions and the CPU, no attention kernel launched; one packed step
    per layout card vs CPU and rerun bitwise; serving molecules/s, step
    and busy ms and a step's peak memory in turns with the blocked
    layout; the three forwards under one set of explicit masks; the
    segment layout's attention weights against the blocked kernel's.
    Returns the models and the first flat packed batch."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.infer import Predictor
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.ops.attention import (
        pairs_to_triplet_weights, triplet_pair_positions)
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.utils.determinism import (
        check_train_step_determinism)

    ref = pred.predict(qm9)
    models, preds, trainers = {"blocked": model}, {"blocked": pred}, {}
    states, batches = {}, {}
    for layout in ("segment", "padded"):
        cfg = dataclasses.replace(mcfg, attention_layout=layout)
        m = X2GNN(cfg, torch.Generator().manual_seed(1), device=device)
        m.load_state_dict(model.state_dict())
        models[layout] = m
        preds[layout] = Predictor(cfg, m, batch_size=32, device=device)
        out, _ = serve(preds[layout], qm9, 0, layout)
        held_across_layouts(f"serve {layout} vs blocked", out, ref)
        cpu = Predictor(cfg, copy.deepcopy(m).to("cpu"), batch_size=32,
                        device="cpu").predict(qm9[:32])
        diff = np.abs(out[:32] - cpu)
        log(f"[serve {layout}] card vs CPU on 32 molecules: max_abs="
            f"{diff.max():.3e} (|pred| max {np.abs(cpu).max():.3e})")
        np.testing.assert_allclose(out[:32], cpu, rtol=MODEL_RTOL,
                                   atol=MODEL_ATOL)
        tr = flagship_trainer(cfg, tcfg, train_graphs, device, "unused")
        trainers[layout], batches[layout] = tr, tr.batches(tr.train_idx)
        b0 = batches[layout][0]
        log(f"[train {layout}] {len(batches[layout])} packed batches, the "
            f"first N, E, T, D = {b0.in_edges.shape[0]}, "
            f"{b0.edge_mask.shape[0]}, {b0.trip_mask.shape[0]}, "
            f"{b0.in_edges.shape[1]}, {int(b0.trip_mask.sum())} real "
            "triplets")
        check_step_on_card_and_cpu(cfg, None, device,
                                   f"{layout} card vs cpu",
                                   batch=first_host_batch(tr))
        reset_launch_counts()
        report = check_train_step_determinism(tr, repeats=2)
        torch.cuda.synchronize()
        counts = launch_counts()
        log(f"[train {layout}] step rerun: mismatches "
            f"{json.dumps(report['mismatches'])}; attention launches "
            f"{counts}")
        if not report["deterministic"]:
            raise AssertionError(f"{layout}: the step differs on a rerun")
        if any(counts.values()):
            raise AssertionError(f"{layout}: the blocked kernels ran")
        states[layout] = tr.init_state()
    trainers["blocked"] = packed
    batches["blocked"] = packed.batches(packed.train_idx)
    states["blocked"] = pstate
    order = ("blocked", "segment", "padded", "padded", "segment", "blocked")
    rates, turns = {}, {}
    for layout in order:
        rates.setdefault(layout, []).append(predict_rate(preds[layout], qm9))
        turn, states[layout] = step_turn(layout, trainers[layout],
                                         states[layout], batches[layout])
        turns.setdefault(layout, []).append(turn)
    for layout in ("blocked", "segment", "padded"):
        t = turns[layout]
        log(f"[layouts {layout}] {card}: serving " + " / ".join(
            f"{r:.1f}" for r in rates[layout]) + " molecules/s; packed step "
            + " / ".join(f"{x['ms']:.3f}" for x in t) + " ms, busy "
            + " / ".join(f"{x['busy']:.3f}" for x in t) + " ms, peak "
            + " / ".join(f"{x['peak'] / 2**20:.1f}" for x in t) + " MiB")

    # 12d: one explicit set of pair-space masks at rate 0.1, all layouts
    batch = batches["segment"][0]
    N, D = batch.in_edges.shape
    rng = np.random.default_rng(95)
    keep = np.float32(0.9)
    masks = [torch.from_numpy((rng.random((N, D, D, mcfg.heads)) < keep)
                              .astype(np.float32) / keep).to(device)
             for _ in range(mcfg.conv_layers)]
    with torch.no_grad():
        dropped = {k: m(batch, deterministic=False,
                        dropout_masks=masks).cpu().numpy()
                   for k, m in models.items()}
        plain = models["blocked"](batch).cpu().numpy()
    for layout in ("segment", "padded"):
        held_across_layouts(f"dropout {layout} vs blocked", dropped[layout],
                            dropped["blocked"])
    if np.allclose(dropped["blocked"], plain, rtol=1e-3):
        raise AssertionError("dropout: the masks changed nothing")

    # 12e: conv_0's attention weights, segment (T, H) against the blocked
    # kernel's alpha through pairs_to_triplet_weights
    alphas = {}
    for layout in ("blocked", "segment"):
        seen = {}

        def grab(module, args, kwargs):
            seen["args"], seen["kwargs"] = args, kwargs

        handle = models[layout].conv_0.register_forward_pre_hook(
            grab, with_kwargs=True)
        with torch.no_grad():
            models[layout](batch)
        handle.remove()
        with torch.no_grad():
            _, alphas[layout] = models[layout].conv_0(
                *seen["args"], **{**seen["kwargs"],
                                  "return_attention_weights": True})
    pair_pos = triplet_pair_positions(batch.trip_dst_edge,
                                      batch.trip_src_edge, batch.edge_inpos,
                                      batch.edge_outpos, D)
    real = batch.trip_mask
    got = alphas["segment"][real].cpu().numpy()
    want = pairs_to_triplet_weights(alphas["blocked"],
                                    pair_pos)[real].cpu().numpy()
    err = np.abs(got - want)
    log(f"[alpha layouts] conv_0 weights of {int(real.sum())} triplets, "
        f"segment against the blocked kernel's alpha: max_abs "
        f"{err.max():.3e} (limit {KERNEL_RTOL} relative + {KERNEL_ATOL})")
    np.testing.assert_allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    if (alphas["segment"][~real] != 0).any():
        raise AssertionError("alpha: pad triplets carry weight")


def layout_clis(card, device, train_graphs, kept):
    """Phase 12c: `train --layout segment` for one epoch of the packed
    recipe on the 512 molecules' graph cache, with --check-determinism, as
    a subprocess; `evaluate --layout` of phase 8c's blocked run in every
    layout (in this process): the flat layouts' MAE within 1e-4 relative
    of the blocked one."""
    import contextlib as _ctx
    import io
    from x2gnn_tpu_torch.evaluate import main as evaluate_main

    cache = os.path.join(kept, "cache.npz")
    work = os.path.join(kept, "segment")
    proc = run_cli(["x2gnn_tpu_torch.train", "--config", FLAGSHIP_ARGS,
                    "--data-npz", cache, "--epochs", "1", "--pack-mixed",
                    "--layout", "segment", "--check-determinism",
                    "--workdir", work], "cli train --layout segment")
    (record,) = read_records(work)
    with open(os.path.join(work, "args.json")) as f:
        layout = json.load(f)["model"]["attention_layout"]
    log(f"[cli train --layout segment] {card}: epoch 1 loss "
        f"{record['loss']:.6f} val_mae {record['val_mae']:.6f} step "
        f"{record['step']} {record['molecules_per_sec']:.1f} molecules/s; "
        f"args.json layout {layout}")
    if ("determinism check: OK" not in proc.stderr or layout != "segment"
            or not math.isfinite(record["loss"]) or record["bad_steps"]):
        raise AssertionError(f"cli train --layout segment: {record}")
    maes = {}
    for layout in ("blocked", "segment", "padded"):
        out = io.StringIO()
        t0 = time.perf_counter()
        with _ctx.redirect_stdout(out):
            rc = evaluate_main(["--ckpt", os.path.join(kept, "run",
                                                       "ckpt_best.pt"),
                                "--data-npz", cache, "--layout", layout])
        result = json.loads(out.getvalue().strip().splitlines()[-1])
        maes[layout] = result["mae"]
        log(f"[cli evaluate --layout {layout}] {card}: {json.dumps(result)} "
            f"in {time.perf_counter() - t0:.1f} s (exit {rc})")
        if rc != 0:
            raise AssertionError(f"evaluate --layout {layout}: exit {rc}")
    for layout in ("segment", "padded"):
        rel = abs(maes[layout] - maes["blocked"]) / abs(maes["blocked"])
        log(f"[cli evaluate --layout {layout}] MAE relative to blocked "
            f"{rel:.3e} (limit 1e-4)")
        if rel > 1e-4:
            raise AssertionError(f"evaluate --layout {layout}: MAE differs")


# ---- phase 13: the parallel paths (DP, EP, DP x EP) ----

def held_grads(tag, got, ref):
    """Gradients {name: tensor} held to the card-vs-CPU gates: each within
    GRAD_RTOL of itself plus GRAD_ATOL of its largest magnitude; the
    lin_key biases, 0 in exact arithmetic (check_step_on_card_and_cpu),
    below 1e-6 of the largest gradient. Returns the largest
    max|err|/max|g|."""
    import torch
    top = max(float(t.abs().max()) for t in ref.values())
    worst = (0.0, "")
    for name, r in ref.items():
        g = got[name]
        if name.endswith("lin_key.bias"):
            if max(float(g.abs().max()), float(r.abs().max())) >= 1e-6 * top:
                raise AssertionError(f"{tag}: {name} not ~0")
            continue
        err = (g - r).abs()
        limit = GRAD_ATOL * float(r.abs().max()) + GRAD_RTOL * r.abs()
        if (err > limit).any() or not torch.isfinite(g).all():
            raise AssertionError(f"{tag}: gradient of {name} differs (max "
                                 f"abs {float(err.max()):.3e})")
        worst = max(worst, (float(err.max()) / max(float(r.abs().max()),
                                                   1e-30), name))
    log(f"[{tag}] {len(ref)} gradients agree within {GRAD_RTOL} relative + "
        f"{GRAD_ATOL} of each one's largest magnitude; largest max|err|/"
        f"max|g| {worst[0]:.3e} ({worst[1]})")
    return worst[0]


def plain_grads(model, batch, masks=None):
    """(loss, {name: gradient}) of one process's step on `batch`."""
    import torch
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss
    pred = model(batch, dropout_masks=masks)
    loss = smooth_l1_loss(pred, batch.y, mask=batch.graph_mask)
    g = torch.autograd.grad(loss, list(model.parameters()),
                            materialize_grads=True)
    return loss.detach(), {n: t for (n, _), t in
                           zip(model.named_parameters(), g)}


def group_grads(model, group, device):
    """(loss, {name: gradient}) of one process stepping the real molecules
    of `group` (host batches): each real batch's plain gradient and loss
    weighted by its real graphs, the count-weighted mean that the data-
    parallel all-reduce computes (a filler weighs nothing)."""
    ref, n, loss = None, 0, 0.0
    for b in group:
        b = b.to(device)
        cnt = int(b.graph_mask.sum())
        if cnt == 0:
            continue
        lb, g = plain_grads(model, b)
        ref = ({k: v * cnt for k, v in g.items()} if ref is None
               else {k: ref[k] + v * cnt for k, v in g.items()})
        n, loss = n + cnt, loss + float(lb) * cnt
    return loss / n, {k: v / n for k, v in ref.items()}


def split_grads(flat, model):
    """{name: view of `flat`} in the model's parameter order."""
    from x2gnn_tpu_torch.train.ema import unflatten
    leaves = list(model.parameters())
    return {n: t for (n, _), t in zip(model.named_parameters(),
                                      unflatten(flat, leaves))}


def dp_gloo_rank(rank, world, store, device, batches, mcfg, tcfg,
                 out_dir):
    """Phase 13b, one of `world` processes sharing the card over gloo: the
    flagship from seed 0 takes one data-parallel step per group of
    `world` batches (the last group ragged). Before each step rank 0
    computes, alone, the count-weighted mean of each real batch's
    gradient (one process stepping the group's molecules) and holds the
    all-reduced gradient to it; every rank records a digest of its
    parameters after each step."""
    import torch
    import torch.distributed as dist
    from x2gnn_tpu_torch.device import resolve_device
    from x2gnn_tpu_torch.parallel import (
        dp_batch_iterator, make_dp_train_step, make_mesh)
    from x2gnn_tpu_torch.parallel.data_parallel import reduced_gradients
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss

    device = resolve_device(device, 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh()
        model = seed0_model(mcfg, device)
        leaves = list(model.parameters())
        opt, state = fresh_state(model, tcfg)
        step = make_dp_train_step(model, opt, tcfg.ema_decay, mesh)
        records = []
        for lo in range(0, len(batches), world):
            group = batches[lo:lo + world]
            mine = next(dp_batch_iterator(group, world, rank)).to(device)
            loss = smooth_l1_loss(model(mine), mine.y, mask=mine.graph_mask)
            flat, gloss, total = reduced_gradients(
                loss, leaves, mine.graph_mask.sum())
            rec = {"real": int(total), "loss": float(gloss),
                   "filler": not bool(mine.graph_mask.any())}
            if rank == 0:
                want, ref = group_grads(model, group, device)
                rec["worst"] = held_grads(
                    f"DP 2 ranks (gloo) step {len(records) + 1}",
                    split_grads(flat, model), ref)
                if abs(float(gloss) - want) > 1e-5 * abs(want):
                    raise AssertionError(f"DP 2 ranks: loss {float(gloss)} "
                                         f"against {want}")
            state, _, _ = step(state, mine)
            rec["digest"] = params_digest(leaves)
            records.append(rec)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(records, f)
    finally:
        dist.destroy_process_group()


def dp_two_ranks_on_one_card(device, batches, mcfg, tcfg):
    """Phase 13b: two processes share the card over gloo (NCCL refuses
    two ranks on one GPU; gloo all-reduces CUDA tensors): two full steps
    and one whose group has one real batch and a filler, each held to one
    process stepping the group's molecules, both ranks' parameters the
    same bits after each step."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=dp_gloo_rank,
                             args=(r, 2, os.path.join(work, "store"),
                                   str(device), batches, mcfg, tcfg, work))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 300
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise AssertionError(f"DP 2 ranks: exit codes {codes}")
        recs = []
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    for i, (a, b) in enumerate(zip(*recs)):
        same = "the same bits" if a["digest"] == b["digest"] else "DIFFER"
        log(f"[parallel dp gloo] step {i + 1}: {a['real']} real graphs, "
            f"loss {a['loss']:.7f}, rank 1 "
            f"{'a filler' if b['filler'] else 'a batch'}, parameters "
            f"{same} on both ranks; largest max|err|/max|g| "
            f"{a['worst']:.3e}")
        if a["digest"] != b["digest"] or a["loss"] != b["loss"]:
            raise AssertionError(f"DP 2 ranks: step {i + 1} differs across "
                                 "ranks")
    if not recs[1][-1]["filler"]:
        raise AssertionError("DP 2 ranks: the last group is not ragged")
    log(f"[parallel dp gloo] 2 processes on one card, {len(recs[0])} steps:"
        f" {time.perf_counter() - t0:.1f} s")


def piece_valid_pairs(piece):
    """Valid (query, key) pairs of one rank's host EPBatch piece: the load
    its kernel gets (host arithmetic, no card)."""
    import numpy as np
    valid = (piece.in_mask[:, :, None] & piece.out_mask[:, None, :]
             & (piece.edge_src_blk[:, :, None]
                != piece.out_dst_blk[:, None, :]))
    return int(np.sum(valid))


def ep_valid_pairs(host_batch, worlds=(1, 2, 4)):
    """Valid (query, key) pairs of each rank's piece of the batch's atoms
    at each EP size: the load each rank's kernel gets (contiguous pieces
    of degree-sorted atoms; host arithmetic, no card)."""
    from x2gnn_tpu_torch.parallel import make_ep_batch
    out = {}
    for w in worlds:
        epb = make_ep_batch(host_batch, w)
        per = [piece_valid_pairs(epb.shard(r, w)) for r in range(w)]
        out[w] = per
        log(f"[parallel ep] {w} ranks of N={epb.numbers.shape[0]}: valid "
            f"pairs per rank {per}")
    return out


def parallel_paths(card, device, train_graphs, mcfg, tcfg, packed,
                   one_window):
    """Phase 13, on the flagship at full width over the packed recipe's
    batches (N=744, D=32): (a) data parallelism at world size 1 over NCCL
    against the plain Trainer; (b) two ranks on the card over gloo; (c)
    edge partitioning (allgather, ring) and DP x EP (1 x 1) at world size
    1 against the blocked model, with the gap recipe's dropout; (d) the
    training CLI under torch.distributed.run; (e) ms per step in turns
    with the plain Trainer. Returns the EP window's kernel rows: the
    first packed batch as one window, which phase 5 checked and timed
    (`one_window`, its forward, backward and reduce records), with the
    launches of one EP step."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.parallel import (
        initialize_distributed, make_ep_batch, make_ep_forward,
        make_hybrid_forward, make_hybrid_mesh, make_mesh, shard_ep_batch,
        shard_hybrid_batch, stack_ep_batches)
    from x2gnn_tpu_torch.parallel.data_parallel import reduced_gradients
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss
    from x2gnn_tpu_torch.train.trainer import Trainer
    from x2gnn_tpu_torch.utils.determinism import (
        check_train_step_determinism)

    t13 = time.perf_counter()
    targets = np.array([g.y[0] for g in train_graphs], np.float32)
    hosts = [packed._assemble(e)
             for e in packed._plan_of(packed.train_idx)[:5]]
    hb = hosts[0]
    N, D = hb.in_edges.shape
    L = mcfg.conv_layers

    # (b) first, before this process joins a group of its own
    dp_two_ranks_on_one_card(device, hosts, mcfg, tcfg)

    initialize_distributed(device=device)
    work = tempfile.TemporaryDirectory()
    try:
        mesh = make_mesh()
        log(f"[parallel] world size {dist.get_world_size()} over "
            f"{dist.get_backend()}, mesh {mesh.axis_names} {mesh.shape}")

        def trainer(tag, **kw):
            model = X2GNN(mcfg, torch.Generator().manual_seed(0),
                          device=device)
            t = Trainer(model, mcfg, tcfg, train_graphs, targets,
                        workdir=os.path.join(work.name, tag),
                        device=device, **kw)
            cached = kw.get("cache_batches", True) is True
            return (t, t.init_state(),
                    t.batches(t.train_idx) if cached else None)

        # ---- (a) data parallelism, world size 1, NCCL ----
        plain, pstate, pbatches = trainer("plain")
        dp, dstate, dbatches = trainer("dp", mesh=mesh)
        b = dbatches[0]
        if (len(dbatches) != len(pbatches)
                or not torch.equal(b.edge_feat, pbatches[0].edge_feat)):
            raise AssertionError("DP: the rank's batches are not the plain "
                                 "Trainer's")
        ref_loss, ref = plain_grads(plain.model, b)
        loss = smooth_l1_loss(dp.model(b), b.y, mask=b.graph_mask)
        flat, gloss, _ = reduced_gradients(loss, list(dp.model.parameters()),
                                           b.graph_mask.sum())
        log(f"[parallel dp] loss {float(gloss):.7f} against the plain step's "
            f"{float(ref_loss):.7f}")
        if abs(float(gloss) - float(ref_loss)) > 1e-6 * abs(float(ref_loss)):
            raise AssertionError("DP: the loss differs from the plain step's")
        held_grads("parallel dp, world 1 vs the plain step",
                   split_grads(flat, dp.model), ref)
        report = check_train_step_determinism(dp, dstate)
        if not report["deterministic"]:
            raise AssertionError(f"DP: a rerun differs: "
                                 f"{report['mismatches'][:5]}")
        reset_launch_counts()
        dstate, _ = dp.train_step(dstate, b, 0)
        torch.cuda.synchronize()
        dp_counts = launch_counts()
        expect = L * len(windows_of(b))
        log(f"[parallel dp] a step bitwise on a rerun; launches per step "
            f"{dp_counts} (expected {expect} each: {L} layers x "
            f"{len(windows_of(b))} tiers)")
        if dp_counts != {"fwd": expect, "bwd": expect, "reduce": expect}:
            raise AssertionError(f"DP: launches {dp_counts}")

        # ---- (c) edge partitioning and DP x EP at world size 1 ----
        valid = ep_valid_pairs(hb)
        model = plain.model
        hd = hb.to(device)
        with torch.no_grad():
            ref_pred = model(hd)
        epb = make_ep_batch(hb, 1)
        local = shard_ep_batch(epb, mesh, device)
        hmesh = make_hybrid_mesh(1, 1)
        hlocal = shard_hybrid_batch(stack_ep_batches([epb]), hmesh, device)
        preds = {}
        with torch.no_grad():
            for mode in ("allgather", "ring"):
                preds[mode] = make_ep_forward(mesh, mode)(model, local)
            preds["hybrid"] = make_hybrid_forward(hmesh, "ring")(
                model, hlocal)
        for tag, p in preds.items():
            err = (p - ref_pred).abs()
            log(f"[parallel ep {tag}] predictions max_abs "
                f"{float(err.max()):.3e} against the blocked model (|pred| "
                f"max {float(ref_pred.abs().max()):.3e})")
            if (err > MODEL_ATOL + MODEL_RTOL * ref_pred.abs()).any():
                raise AssertionError(f"EP {tag}: predictions differ")
        if not torch.equal(preds["ring"], preds["allgather"]):
            raise AssertionError("EP: ring and allgather differ")
        ref_loss, ref = plain_grads(model, hd)
        for mode in ("allgather", "ring"):
            reset_launch_counts()
            pred = make_ep_forward(mesh, mode)(model, local)
            loss = smooth_l1_loss(pred, local.y, mask=local.graph_mask)
            flat, _, _ = reduced_gradients(loss, list(model.parameters()),
                                           local.graph_mask.sum())
            torch.cuda.synchronize()
            counts = launch_counts()
            held_grads(f"parallel ep {mode} vs the blocked model",
                       split_grads(flat, model), ref)
            if counts != {"fwd": L, "bwd": L, "reduce": L}:
                raise AssertionError(f"EP {mode}: launches {counts}")
        # the gap recipe's dropout on the EP path, under the same masks
        gcfg, _ = gap_training_configs()
        gmodel = X2GNN(gcfg, torch.Generator().manual_seed(0), device=device)
        masks = [keep_mask((N, D, D, gcfg.heads), gcfg.dropout, 70 + i,
                           device) for i in range(gcfg.conv_layers)]
        with torch.no_grad():
            gref = gmodel(hd, dropout_masks=masks)
            reset_launch_counts()
            gpred = make_ep_forward(mesh, "ring")(gmodel, local,
                                                  dropout_masks=masks)
        drops = per_variant(launch_shapes()["fwd_variants"])
        err = (gpred - gref).abs()
        log(f"[parallel ep gap] dropout {gcfg.dropout}, {gcfg.readout}: "
            f"max_abs {float(err.max()):.3e} against the blocked model under "
            f"the same masks; forward launches by instance {drops}")
        if (err > MODEL_ATOL + MODEL_RTOL * gref.abs()).any() or \
                drops != {"drop": gcfg.conv_layers}:
            raise AssertionError("EP gap: dropout forward differs")
        # the EP trainers; one EP step's launches per rank
        ep_trainers = {m: trainer(f"ep_{m}", mesh=mesh, edge_partition=m)
                       for m in ("allgather", "ring")}
        ep, estate, ebatches = ep_trainers["ring"]
        reset_launch_counts()
        estate, _ = ep.train_step(estate, ebatches[0], 0)
        torch.cuda.synchronize()
        ep_counts = launch_counts()
        log(f"[parallel ep] one EP step's launches {ep_counts} (expected "
            f"{L} each, one window per conv)")
        if ep_counts != {"fwd": L, "bwd": L, "reduce": L}:
            raise AssertionError(f"EP step: launches {ep_counts}")
        # an epoch of EP batches assembled and streamed from the host
        # (cache_batches off: each rank's piece pinned and copied on a
        # stream of its own) against the same epoch on cached ones
        fresh, fstate, fbatches = ep_trainers["allgather"]
        streamed, sstate, _ = trainer("ep_streamed", mesh=mesh,
                                      edge_partition="allgather",
                                      cache_batches=False)
        fstate, cached_loss = fresh.run_epoch(fstate, 0)
        ep_trainers["allgather"] = (fresh, fstate, fbatches)
        _, streamed_loss = streamed.run_epoch(sstate, 0)
        log(f"[parallel ep] an epoch on streamed EP batches: loss "
            f"{streamed_loss!r}, on cached ones {cached_loss!r}")
        if streamed_loss != cached_loss:
            raise AssertionError("EP: the streamed epoch differs")

        # ---- (e) ms per step in turns ----
        runs = {"plain": (plain, pstate, pbatches),
                "dp": (dp, dstate, dbatches),
                "ep allgather": ep_trainers["allgather"],
                "ep ring": (ep, estate, ebatches)}
        turns = {}
        for name in ("plain", "dp", "ep allgather", "ep ring", "ep ring",
                     "ep allgather", "dp", "plain"):
            t, st, bs = runs[name]
            ms, st, _ = step_ms(t, st, bs)
            runs[name] = (t, st, bs)
            turns.setdefault(name, []).append(ms)
        log("[parallel] ms per packed step (median of 20, CUDA events, "
            "cached batches), in turns: " + "; ".join(
                f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in turns.items()))

        # ---- (d) the training CLI under torch.distributed.run ----
        for tag, flags in (("dp", ["--data-parallel"]),
                           ("ep", ["--edge-partition", "ring"])):
            wd = os.path.join(work.name, f"cli_{tag}")
            proc = run_cli(["torch.distributed.run", "--standalone",
                            "--nproc-per-node", "1", "-m",
                            "x2gnn_tpu_torch.train", "--synthetic", "96",
                            "--epochs", "1", "--config", FLAGSHIP_ARGS,
                            "--pack-mixed", "--workdir", wd, *flags],
                           f"parallel cli {tag}", timeout=300)
            recs = read_records(wd)
            backend = "nccl" if device.type == "cuda" else "gloo"
            if (len(recs) != 1 or not np.isfinite(recs[0]["loss"])
                    or f"over 1 ranks ({backend})" not in proc.stderr):
                raise AssertionError(f"parallel cli {tag}: {recs}")
            log(f"[parallel cli {tag}] 1 epoch: loss {recs[0]['loss']:.6f}, "
                f"{recs[0]['molecules_per_sec']:.1f} molecules/s")
    finally:
        dist.destroy_process_group()
        work.cleanup()
    log(f"[phase 13] took {time.perf_counter() - t13:.1f} s; EP valid pairs "
        f"per rank {valid}")
    # the EP rank's window is phase 5's "packed one window"
    if packed.batches(packed.train_idx)[0].in_edges.shape != (N, D):
        raise AssertionError("EP: phase 5's one window is another batch")
    ep_fwd, ep_bwd, ep_red = one_window
    note = (f"EP window ({N}, {D}, {D}): the first packed batch on one "
            "rank, checked and timed as phase 5's one window")
    return [
        {"name": "blocked_attn_fwd (EP window)", "route": "cuda",
         "source": "x2gnn_tpu_torch/ops/csrc/blocked_attn_fwd.cu",
         "replaces": f"{PALLAS}:166", "launches": ep_counts["fwd"],
         "window": note, **ep_fwd},
        {"name": "blocked_attn_bwd (EP window)", "route": "cuda",
         "source": "x2gnn_tpu_torch/ops/csrc/blocked_attn_bwd.cu",
         "replaces": f"{PALLAS}:198", "launches": ep_counts["bwd"],
         "window": note, **ep_bwd},
        {"name": "blocked_attn_bwd_reduce (EP window)", "route": "cuda",
         "source": "x2gnn_tpu_torch/ops/csrc/blocked_attn_bwd.cu",
         "replaces": f"{PALLAS}:271", "launches": ep_counts["reduce"],
         "window": f"partials of the {note}", **ep_red}]


# ---- phase 14: per-layer dumps, card against CPU ----

# each entry of a card dump against the CPU dump of the same weights and
# batch: within 1e-4 of the entry's largest magnitude plus 1e-6, the
# predictions' card-against-CPU gate (MODEL_RTOL) applied to every layer.
# The bf16 model's output within 1e-2 of its largest magnitude (the
# predictions' bf16 gate, BF16_PRED_TOL) and every other entry within 2e-2
# (BF16_GRAD_TOL): one bf16 ulp is up to 2^-7 = 7.8e-3 of an entry's
# largest magnitude, q, k, v and e can each land one ulp apart on the two
# sides, and the deeper layers carry the earlier ones' flips (the first
# card run measured conv_3's output at 1.116e-2 of its max|x| on the
# serving batch, its prediction within 1e-2)
PARITY_SCALE, PARITY_ATOL = 1e-4, 1e-6


# a dump's entries of the model's output (X2GNN.forward's return value)
OUTPUT_KEYS = ("__call__", "__output__")


def report_dumps(tag, got, ref, scale, output_scale=None):
    """Card dump `got` against CPU dump `ref`: every entry within
    PARITY_ATOL + scale * its max|ref| (the model's output within
    output_scale when given), the same keys on both sides. Logs the key
    sets' sizes, the 5 worst entries relative to their largest magnitude
    and the dump's bytes."""
    atol = PARITY_ATOL
    import numpy as np
    from x2gnn_tpu_torch.utils.parity import compare_dumps

    cmp = compare_dumps(got, ref, rtol=0.0, atol=atol, max_scale=scale)
    if output_scale is not None:
        out = compare_dumps({k: got[k] for k in OUTPUT_KEYS},
                            {k: ref[k] for k in OUTPUT_KEYS}, rtol=0.0,
                            atol=atol, max_scale=output_scale)
        worst = max(err / max(float(np.abs(ref[k]).max()), 1e-30)
                    for k, err, _ in out.entries)
        log(f"[parity {tag}] the output within {worst:.3e} of its max|cpu| "
            f"(gate {atol} + {output_scale} x max|cpu|)")
        if not out.ok:
            raise AssertionError(f"parity {tag}: the output is over its "
                                 f"gate: {out.entries}")
    worst = sorted(((k, err / max(float(np.abs(ref[k]).max()), 1e-30), err)
                    for k, err, _ in cmp.entries), key=lambda t: -t[1])
    log(f"[parity {tag}] {len(got)} card keys, {len(ref)} CPU keys, "
        f"{len(cmp.entries)} compared; card dump "
        f"{sum(v.nbytes for v in got.values())} bytes; "
        "worst entries (err / max|cpu|, max_abs_err): " + ", ".join(
            f"{k} {r:.3e} ({e:.3e})" for k, r, e in worst[:5])
        + f"; gate {atol} + {scale} x max|cpu|")
    if cmp.only_a or cmp.only_b:
        raise AssertionError(f"parity {tag}: keys on one side only: "
                             f"{cmp.only_a} / {cmp.only_b}")
    if not cmp.ok:
        raise AssertionError(f"parity {tag}: entries over the gate: "
                             f"{cmp.failed()[:10]}")


def dump_on_card(model, batch, tag, mcfg):
    """One card dump with the counts zeroed just before and read just
    after: conv_layers forward launches per attention window, no backward.
    Returns (dump, counts per shape)."""
    import torch
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.utils.parity import dump_activations

    reset_launch_counts()
    dump = dump_activations(model, batch)
    torch.cuda.synchronize()
    counts, shapes = launch_counts(), launch_shapes()
    expect = {"fwd": mcfg.conv_layers * len(windows_of(batch)), "bwd": 0,
              "reduce": 0}
    log(f"[parity {tag}] card dump: launches {counts} (expected {expect})")
    if counts != expect:
        raise AssertionError(f"parity {tag}: launches {counts}, expected "
                             f"{expect}")
    return dump, shapes


def parity_dumps(cfg, device, qm9, packed):
    """Phase 14: per-layer dumps of the flagship (weights from
    torch.Generator().manual_seed(0), phase 4's) on the first
    serving batch (N=1024, D=24, one window) and the first packed training
    batch (N=744, D=32, 8 tiers): card (hand kernels) against CPU (plain
    versions) per entry, a rerun of the card dump bitwise, and the bf16
    model card against CPU. Returns {tag: (batch, counts per shape)} of
    the float32 card dumps."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.data.batching import batch_iterator, pad_budget_for
    from x2gnn_tpu_torch.infer import quantize_budgets
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.utils.parity import dump_activations

    t0 = time.perf_counter()
    model = X2GNN(cfg, torch.Generator().manual_seed(0), device=device)
    serving = next(batch_iterator(qm9, 32, budgets=quantize_budgets(
        pad_budget_for(qm9, 32))))
    batches = {"serving": serving, "packed": first_host_batch(packed)}
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    models = {
        "cpu": X2GNN(cfg, torch.Generator().manual_seed(0), device="cpu"),
        "bf16 card": X2GNN(bf16, torch.Generator().manual_seed(0),
                           device=device),
        "bf16 cpu": X2GNN(bf16, torch.Generator().manual_seed(0),
                          device="cpu")}
    for name, other in models.items():
        for (n, p), q in zip(model.named_parameters(), other.parameters()):
            if not torch.equal(p.cpu(), q.cpu()):
                raise AssertionError(f"parity: {name} model's {n} differs")
    out = {}
    for tag, batch in batches.items():
        n, d = batch.in_edges.shape
        tag = f"{tag} N={n} D={d} windows={len(windows_of(batch))}"
        on_card = batch.to(device)
        got, shapes = dump_on_card(model, on_card, tag, cfg)
        again, _ = dump_on_card(model, on_card, tag + " rerun", cfg)
        if got.keys() != again.keys() or not all(
                np.array_equal(got[k], again[k]) for k in got):
            raise AssertionError(f"parity {tag}: two card dumps differ")
        log(f"[parity {tag}] a rerun of the card dump is bitwise equal "
            f"({len(got)} entries)")
        ref = dump_activations(models["cpu"], batch.to("cpu"))
        report_dumps(tag + " float32", got, ref, PARITY_SCALE)
        del ref, again
        got_bf16, _ = dump_on_card(models["bf16 card"], on_card,
                                   tag + " bf16", bf16)
        report_dumps(tag + " bf16", got_bf16,
                     dump_activations(models["bf16 cpu"], batch.to("cpu")),
                     BF16_GRAD_TOL, output_scale=BF16_PRED_TOL)
        out[tag] = (batch, shapes)
        del got, got_bf16
    log(f"[phase 14] took {time.perf_counter() - t0:.1f} s")
    return out


# ---- phase 15: the A12 cut's training curve against the JAX Trainer ----

CURVE_FIXTURE = os.path.join(REPO, "tests", "torch_port_curve_jax.json")
# the phase's gates (PERF.md §6, fixed before its first card run): per epoch
# e, |port - JAX| / JAX of val_mae and of loss within max(3 x the noise
# of e, 5e-3), the noise of e being the largest gap |twin - JAX| / JAX of
# that metric between the JAX run and any of its perturbed twins at any
# epoch up to e (rounding's effect on the curve grows with training; one
# twin's gap at one epoch undersold it: the CPU port, the same function,
# fell outside a single twin's 3x at epoch 2); the atomref fit and the
# standardization within 1e-8 relative; occupancy_pairs bitwise; the
# set's labels within 1e-9 relative (the eigensolver's threads move their
# last bits) and its edge features within 1e-6 (each host builds the
# integral engine with -march=native); the initial weights' sum |w| per
# parameter within 1e-6 relative (QR in another LAPACK may round
# otherwise)
CURVE_GAP_FACTOR, CURVE_FLOOR = 3.0, 5e-3
CURVE_METRICS = ("val_mae", "loss")
STATS_RTOL = 1e-8
LABEL_RTOL, FEAT_RTOL = 1e-9, 1e-6
INIT_RTOL = 1e-6


def curve_noise(fixture):
    """{(epoch, metric): the largest |twin - JAX| / JAX over the fixture's
    perturbed twins and the epochs up to this one}."""
    ref = fixture["runs"]["jax"]
    noise, worst = {}, dict.fromkeys(CURVE_METRICS, 0.0)
    for e, r in enumerate(ref):
        for m in CURVE_METRICS:
            for twin in fixture["runs"]["perturbed"].values():
                worst[m] = max(worst[m],
                               abs(twin[e][m] - r[m]) / abs(r[m]))
            noise[(r["epoch"], m)] = worst[m]
    return noise


def curve_gate(records, fixture):
    """Rows (epoch, metric, port, JAX, |port - JAX| / JAX, limit, ok) of
    each epoch of `records` against the fixture's JAX run; the limit is
    max(CURVE_GAP_FACTOR x `curve_noise`, CURVE_FLOOR)."""
    noise = curve_noise(fixture)
    rows = []
    for got, ref in zip(records, fixture["runs"]["jax"]):
        for m in CURVE_METRICS:
            limit = max(CURVE_GAP_FACTOR * noise[(ref["epoch"], m)],
                        CURVE_FLOOR)
            rel = abs(got[m] - ref[m]) / abs(ref[m])
            rows.append((ref["epoch"], m, got[m], ref[m], rel, limit,
                         rel <= limit))
    return rows


def _close(got, want, rtol):
    return abs(got - want) <= rtol * abs(want)


def set_checksums(graphs, first: int = 16) -> dict:
    """Sums of a set's edge features and labels, and per molecule for its
    first `first` molecules (float64 sums of the stored values): the
    fixture's record of the A12 cut (tests/torch_port_make_curve.py)."""
    import numpy as np

    def one(g):
        return {"atoms": int(len(g.numbers)),
                "edges": int(g.edge_feat.shape[0]),
                "edge_feat_sum": float(np.sum(g.edge_feat,
                                              dtype=np.float64)),
                "y": [float(v) for v in np.asarray(g.y, np.float64)]}
    return {"molecules": len(graphs),
            "atoms": int(sum(len(g.numbers) for g in graphs)),
            "edge_feat_sum": float(sum(np.sum(g.edge_feat, dtype=np.float64)
                                       for g in graphs)),
            "y_sum": [float(v) for v in np.sum(
                [np.asarray(g.y, np.float64) for g in graphs], axis=0)],
            "first": [one(g) for g in graphs[:first]]}


def check_curve_set(graphs, fixture):
    """The built set against the fixture's checksums: atoms and edges
    exactly, labels within LABEL_RTOL, edge features within FEAT_RTOL;
    raises on a mismatch."""
    want = fixture["set"]
    got = set_checksums(graphs, len(want["first"]))
    bad = [(key, got[key], want[key]) for key in ("molecules", "atoms")
           if got[key] != want[key]]

    def rel(a, b):
        return abs(a - b) / abs(b)
    pairs_feat = [(got["edge_feat_sum"], want["edge_feat_sum"])]
    pairs_y = list(zip(got["y_sum"], want["y_sum"]))
    for i, (g, w) in enumerate(zip(got["first"], want["first"])):
        if (g["atoms"], g["edges"]) != (w["atoms"], w["edges"]):
            bad.append((f"molecule {i}", g, w))
        pairs_feat.append((g["edge_feat_sum"], w["edge_feat_sum"]))
        pairs_y += list(zip(g["y"], w["y"]))
    worst_feat = max(rel(a, b) for a, b in pairs_feat)
    worst_y = max(rel(a, b) for a, b in pairs_y)
    log(f"[curve] set: {got['molecules']} molecules, {got['atoms']} atoms; "
        f"edge feature sums (the set's and the first {len(got['first'])} "
        f"molecules') within {worst_feat:.3e} relative (gate {FEAT_RTOL}), "
        f"labels within {worst_y:.3e} (gate {LABEL_RTOL})")
    if worst_feat > FEAT_RTOL or worst_y > LABEL_RTOL:
        bad.append(("sums", worst_feat, worst_y))
    if bad:
        raise AssertionError(f"curve: the built set is not the fixture's: "
                             f"{bad[:5]}")


def curve_labels(graphs, tcfg, atomref=True):
    """The training CLI's [--atomref-fit] --standardize
    (train/__main__.py, train.py:257-286) with the port's functions:
    targets, minus the atomref fit on the train split with `atomref`,
    standardized (without it in the targets' float32, as the CLI does).
    Returns (targets, std, atomref table with str keys or None, mu,
    sigma)."""
    import numpy as np
    from x2gnn_tpu_torch.data.dataset import prepare_targets
    from x2gnn_tpu_torch.data.molecule import fit_linear_atomref
    from x2gnn_tpu_torch.train.trainer import make_split, resolve_division

    targets = prepare_targets(graphs, tcfg.target)
    table = None
    if atomref:
        n = len(graphs)
        fit_idx, _, _ = make_split(n, tcfg.random_seed,
                                   resolve_division(n, tcfg.division))
        pred, table = fit_linear_atomref([g.numbers for g in graphs],
                                         targets, fit_idx)
        targets = np.asarray(targets, np.float64) - pred
        table = {str(k): v for k, v in table.items()}
    mu, sigma = float(np.mean(targets)), float(np.std(targets) + 1e-12)
    targets = ((targets - mu) / sigma).astype(np.float32)
    return targets, sigma, table, mu, sigma


def check_curve_stats(atomref, mu, sigma, fixture, tag="curve",
                      source="the fixture's"):
    """The atomref table (None for a recipe without one, whose fixture
    then has no "atomref") and the standardization within STATS_RTOL of
    the fixture's (a dict with its "standardization" and "atomref")."""
    got = {**{f"atomref {k}": v for k, v in (atomref or {}).items()},
           "mu": mu, "sigma": sigma}
    want = {**{f"atomref {k}": v
               for k, v in fixture.get("atomref", {}).items()},
            **fixture["standardization"]}
    if got.keys() != want.keys():
        raise AssertionError(f"{tag}: atomref elements {sorted(got)} vs "
                             f"{sorted(want)}")
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
    worst = max(rel, key=rel.get)
    what = ("standardization" if atomref is None else
            f"atomref ({len(atomref)} terms) and standardization")
    log(f"[{tag}] {what} (mu "
        f"{mu!r}, sigma {sigma!r}) within {rel[worst]:.3e} relative of "
        f"{source} (worst {worst}; gate {STATS_RTOL})")
    if rel[worst] > STATS_RTOL:
        raise AssertionError(f"{tag}: {worst} {got[worst]!r} vs "
                             f"{source} {want[worst]!r}")


def curve_model(mcfg, device, fixture):
    """The flagship from torch.Generator().manual_seed(the fixture's
    seed) on `device`: its parameters are drawn on the CPU and moved, so
    the card's bits are the CPU's (checked against a CPU build here), and
    each parameter's sum |w| within INIT_RTOL of the fixture's."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.utils.parity import export_params_flat

    seed = fixture["init"]["seed"]
    model = X2GNN(mcfg, torch.Generator().manual_seed(seed), device=device)
    flat = export_params_flat(model)
    cpu = export_params_flat(X2GNN(mcfg, torch.Generator().manual_seed(seed),
                                   device="cpu"))
    same = flat.keys() == cpu.keys() and all(
        np.array_equal(flat[k], cpu[k]) for k in flat)
    sums = fixture["init"]["abs_sums"]
    if flat.keys() != sums.keys():
        raise AssertionError("curve: the fixture's parameters are not the "
                             "model's")
    # zero-initialised biases sum to 0 on both sides
    rel = max(abs(float(np.abs(v.astype(np.float64)).sum()) - sums[k])
              / (sums[k] or 1.0) for k, v in flat.items())
    log(f"[curve] initial weights from torch.Generator().manual_seed({seed})"
        f", drawn on the CPU: the {device} model's {len(flat)} parameters "
        f"{'are' if same else 'are NOT'} bitwise a CPU build's; sum |w| "
        f"per parameter within {rel:.3e} relative of the fixture's (gate "
        f"{INIT_RTOL})")
    if not same or rel > INIT_RTOL:
        raise AssertionError("curve: initial weights differ")
    return model


def training_curve(device, epochs=None, work=None):
    """Phase 15 (A12's cut): the fixture's 1,024 molecules built by the
    port's builder (a subprocess) and checked against the fixture's
    checksums, the atomref fit and standardization checked, the flagship
    recipe trained from the fixture's initial weights through
    Trainer.fit(state=init_state()) for the fixture's epochs (or
    `epochs`), and every epoch's val_mae and loss held to the fixture's
    JAX curve by `curve_gate`; occupancy_pairs bitwise. On the card, the
    launch counts are zeroed just before fit and read just after, and
    the kernels are checked and timed on every tier of the first training
    batch. Returns (records, gate rows, kernels rows)."""
    import torch
    from x2gnn_tpu_torch.data.dataset import load_graph_cache
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.profile_training import flagship_training_configs
    from x2gnn_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    with open(CURVE_FIXTURE) as f:
        fixture = json.load(f)
    epochs = epochs or fixture["epochs"]
    device = torch.device(device)
    on_card = device.type == "cuda"
    mcfg, tcfg = flagship_training_configs()
    own = work is None
    work = work or tempfile.mkdtemp()
    try:
        n = fixture["builder"]["n"]
        path = os.path.join(work, "a12_cut.npz")
        t0 = time.perf_counter()
        if not os.path.exists(path):
            run_cli(["x2gnn_tpu_torch.data.make_synthetic", "--n", str(n),
                     "--name", "a12_cut", "--cache-dir", work, "--workers",
                     str(os.cpu_count()), "--basis", "6311", "--gap-label"],
                    "A12 builder")
        build_s = time.perf_counter() - t0
        graphs = load_graph_cache(path)
        log(f"[curve] builder: {n} molecules in {build_s:.1f} s, "
            f"{build_s * 1e3 / n:.1f} ms per molecule over "
            f"{os.cpu_count()} host cores")
        check_curve_set(graphs, fixture)
        targets, std, atomref, mu, sigma = curve_labels(graphs, tcfg)
        check_curve_stats(atomref, mu, sigma, fixture)
        model = curve_model(mcfg, device, fixture)
        trainer = Trainer(model, mcfg, tcfg, graphs, targets,
                          workdir=os.path.join(work, "run"), std=std,
                          device=device)
        split = {"test": len(trainer.test_idx), "val": len(trainer.val_idx),
                 "train": len(trainer.train_idx)}
        if split != fixture["split"]:
            raise AssertionError(f"curve: split {split}, fixture "
                                 f"{fixture['split']}")
        reset_launch_counts()
        t0 = time.perf_counter()
        state, _ = trainer.fit(epochs=epochs, state=trainer.init_state())
        if on_card:
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts, shapes = launch_counts(), launch_shapes()
        with open(os.path.join(work, "run", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        first = first_host_batch(trainer)
        train_b = trainer.batches(trainer.train_idx)
        val_w = n_windows(trainer.batches(trainer.val_idx))
        test_w = n_windows(trainer.batches(trainer.test_idx))
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)
    steps = len(train_b) * epochs
    log(f"[curve] {split} molecules, {len(train_b)} packed steps per epoch, "
        f"{epochs} epochs in {fit_s:.1f} s ({fit_s * 1e3 / steps:.1f} ms "
        f"per step with evaluation); first batch N={first.in_edges.shape[0]}"
        f", D={first.in_edges.shape[1]}, tiers {first.tiers}")
    if len(records) != epochs or int(state.bad_steps) != 0 or int(
            state.step) != steps:
        raise AssertionError(f"curve: {len(records)} records, step "
                             f"{int(state.step)} of {steps}, bad steps "
                             f"{int(state.bad_steps)}")
    occ = [r["occupancy_pairs"] for r in records]
    log(f"[curve] occupancy_pairs {occ[0]!r} (fixture "
        f"{fixture['occupancy_pairs']!r}, bitwise)")
    if any(o != fixture["occupancy_pairs"] for o in occ):
        raise AssertionError(f"curve: occupancy_pairs {occ}")
    rows = curve_gate(records, fixture)
    noise = curve_noise(fixture)
    log("[curve] epoch | metric | port | JAX | |port - JAX| / JAX | twins' "
        "noise | limit")
    for epoch, m, got, ref, rel, limit, ok in rows:
        log(f"[curve] {epoch} | {m} | {got!r} | {ref!r} | {rel:.3e} | "
            f"{noise[(epoch, m)]:.3e} | {limit:.3e}{'' if ok else ' OVER'}")
    bad = [r for r in rows if not r[-1]]
    kernels = []
    if on_card:
        L = mcfg.conv_layers
        train_w = n_windows(train_b) * epochs
        improved = sum(r["test_mae"] is not None
                       and r["val_mae"] == r["best_val_mae"]
                       for r in records)
        # fit(state=) evaluates the starting weights on the val set once
        eval_w = val_w * (epochs + 1) + test_w * improved
        expect = {"fwd": L * (train_w + eval_w), "bwd": L * train_w,
                  "reduce": L * train_w}
        log(f"[curve] launches {counts} (expected {expect})")
        if counts != expect:
            raise AssertionError(f"curve: launches {counts}, expected "
                                 f"{expect}")
        kernels = curve_kernel_rows(first.to(device), mcfg, shapes, counts)
    log(f"[phase 15] took {time.perf_counter() - t_phase:.1f} s "
        f"(builder {build_s:.1f} s, fit {fit_s:.1f} s)")
    if bad:
        raise AssertionError(f"curve: {len(bad)} gates over their limit: "
                             f"{bad}")
    return records, rows, kernels


def curve_kernel_rows(batch, mcfg, shapes, counts):
    """The three kernels against their plain versions, timed, on every
    tier window of the A12 cut's first training batch; rows of the
    kernels line with the launches of phase 15's run at each shape."""
    fwd_src = "x2gnn_tpu_torch/ops/csrc/blocked_attn_fwd.cu"
    bwd_src = "x2gnn_tpu_torch/ops/csrc/blocked_attn_bwd.cu"
    args = batch_kernel_inputs(batch, mcfg, seed=150)
    rows, reduces = [], []
    for t, win in enumerate(windows_of(batch)):
        fwd, (bwd, red) = check_window(
            f"A12 tier {t}", window_args(args, win), mcfg, seed=151 + t,
            fwd_timed=True, bwd_timed=True)
        ichunk = win[3] > 40
        note = f"A12 cut tier {t}, {win} of the first training batch"
        rows += [
            {"name": f"blocked_attn_fwd (A12 tier {t})", "route": "cuda",
             "source": fwd_src,
             "replaces": f"{PALLAS}:{282 if ichunk else 166}",
             "launches": shapes["fwd"].get(window_shape(win), 0),
             "window": note, **fwd},
            {"name": f"blocked_attn_bwd (A12 tier {t})", "route": "cuda",
             "source": bwd_src,
             "replaces": f"{PALLAS}:{346 if ichunk else 198}",
             "launches": shapes["bwd"].get(window_shape(win), 0),
             "window": note, **bwd}]
        reduces.append((win[1] - win[0], win, red))
    _, win, red = max(reduces, key=lambda r: r[0])
    rows.append({"name": "blocked_attn_bwd_reduce (A12 tiers)",
                 "route": "cuda", "source": bwd_src,
                 "replaces": f"{PALLAS}:271", "launches": counts["reduce"],
                 "window": f"partials of A12 tier {win}", **red})
    return rows


# ---- phase 16: the evaluation and measurement scripts ----

# AID-scale molecules (the real AID set's 451 have up to 77 atoms): sizes
# around 64, so that a batch's top degree tier has more than 40 slots
AID_SEED, AID_MOLECULES, AID_CHUNK = 16, 18, 6
AID_FOLDS, AID_EPOCHS, AID_BATCH = 3, 3, 4
# the recipe's warm-up (300 of 1,500 steps: 5 folds x 150 epochs x ~10
# steps) scaled to the cut's 3 epochs of 2 steps (8 train molecules a fold)
AID_WARMUP = 1
GEO_MOLECULES = 2048


def aid_molecule(index):
    """Molecule `index` of phase 16's AID-format set: its own seeded
    geometry of 48-80 atoms, labelled with its independent-particle energy
    on the x2sv basis, in kcal/mol. Module-level, for spawned workers."""
    from x2gnn_tpu_torch.data.integrals.basis import get_basis
    from x2gnn_tpu_torch.data.integrals.engine import one_electron_matrices
    from x2gnn_tpu_torch.data.molecule import EV_TO_KCALMOL, Molecule
    from x2gnn_tpu_torch.data.synthetic import (
        HARTREE_TO_EV, independent_particle_energy, synthetic_geometry)
    numbers, pos = synthetic_geometry(index, seed=AID_SEED, mean_atoms=64,
                                      min_atoms=48, max_atoms=80)
    s, h, _ = one_electron_matrices(numbers, pos, basis=get_basis("x2sv"))
    energy = independent_particle_energy(numbers, pos, s, h)
    return Molecule(numbers, pos, [energy * HARTREE_TO_EV * EV_TO_KCALMOL],
                    index)


def captured(fn, argv):
    """fn(argv) with its standard output captured; that output is logged
    and returned."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    out = buf.getvalue()
    for line in out.strip().splitlines():
        log(f"  | {line}")
    if rc != 0:
        raise AssertionError(f"{fn.__module__}: exit {rc}")
    return out


def aid_cross_validation(device, work):
    """Phase 16a: an AID-format xyz of AID_MOLECULES molecules, featurized
    by `scripts.featurize_aid` in parts of AID_CHUNK; `scripts.aid_cv`
    over AID_FOLDS folds of AID_EPOCHS epochs at batch AID_BATCH, its
    launches counted per window shape and held to conv_layers x the windows
    of its steps, evaluations and fold-out predictions; fold 0 again in a
    fresh workdir, result.json and every metrics record but the wall
    clock's bitwise; fold 0's fold-out predictions from its ckpt_best.pt on
    the card reproducing its test MAE bitwise and within MODEL_RTOL /
    MODEL_ATOL of the CPU's (plain kernels); the three kernels checked and
    timed on every window of the first training batch, one with more than
    40 key slots. Returns the kernels line's rows."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
    from x2gnn_tpu_torch.data.dataset import load_dataset, worker_pool
    from x2gnn_tpu_torch.data.molecule import write_xyz
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.scripts import aid_cv, featurize_aid

    t0 = time.perf_counter()
    with worker_pool(os.cpu_count()) as pool:
        mols = pool.map(aid_molecule, range(AID_MOLECULES))
    xyz = os.path.join(work, "aid_scale.xyz")
    write_xyz(xyz, mols)
    label_s = time.perf_counter() - t0
    sizes = [len(m.numbers) for m in mols]
    log(f"[aid] {AID_MOLECULES} molecules of {min(sizes)}-{max(sizes)} atoms "
        f"(mean {np.mean(sizes):.1f}) labelled in {label_s:.1f} s "
        f"({label_s * 1e3 / AID_MOLECULES:.1f} ms per molecule, integrals "
        f"and eigensolve, {os.cpu_count()} host cores)")
    cache = os.path.join(work, "processed")
    common = ["--cache-dir", cache, "--backend", "native"]
    t0 = time.perf_counter()
    captured(featurize_aid.main, ["--xyz", xyz, "--chunk", str(AID_CHUNK)]
             + common)
    feat_s = time.perf_counter() - t0
    parts = -(-AID_MOLECULES // AID_CHUNK)
    log(f"[aid] featurize_aid: {parts} parts of {AID_CHUNK} in {feat_s:.1f} s,"
        f" {feat_s * 1e3 / AID_MOLECULES:.1f} ms per molecule ({os.cpu_count()}"
        f" host cores); cache {sorted(os.listdir(cache))}")
    if parts < 3 or os.listdir(cache) != ["aid_scale_native_c5.npz"]:
        raise AssertionError(f"featurize_aid: {os.listdir(cache)}")
    graphs = load_dataset(xyz, cache_dir=cache, backend="native")

    cv_args = ["--data", xyz, "--folds", str(AID_FOLDS), "--epochs",
               str(AID_EPOCHS), "--batch-size", str(AID_BATCH),
               "--warmup-steps", str(AID_WARMUP)] + common
    reset_launch_counts()
    t0 = time.perf_counter()
    cv = os.path.join(work, "cv")
    out = captured(aid_cv.main, cv_args + ["--workdir", cv])
    torch.cuda.synchronize()
    cv_s = time.perf_counter() - t0
    counts, shapes = launch_counts(), launch_shapes()
    summary = json.loads(out)
    with open(os.path.join(cv, "summary.json")) as f:
        folds = json.load(f)["folds"]
    log(f"[aid] aid_cv: {AID_FOLDS} folds x {AID_EPOCHS} epochs in "
        f"{cv_s:.1f} s; test MAE {summary['test_mae_kcal']} kcal/mol, "
        f"baseline {summary['baseline_mae_kcal']}")
    if (sum(r["n_test"] for r in folds) != AID_MOLECULES
            or not all(np.isfinite(list(v.values())).all()
                       for v in summary.values())):
        raise AssertionError(f"aid_cv: {folds}")

    # fold 0 from its ckpt_best.pt, on the card and on the CPU
    y = np.array([g.y[0] for g in graphs], dtype=np.float64)
    parts_idx = aid_cv.fold_splits(len(graphs), AID_FOLDS, 41)
    fold = aid_cv.prepare_fold(graphs, y, parts_idx, 0, AID_BATCH)
    mcfg = ModelConfig(attention_layout="blocked", readout="atomwise")
    tcfg = TrainConfig(batch_size=AID_BATCH, warmup_steps=AID_WARMUP,
                       random_seed=41, ckpt_after_epoch=0)
    ckpt = os.path.join(cv, "fold_0", "ckpt_best.pt")
    preds, trainers = {}, {}
    for dev in (device, torch.device("cpu")):
        model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=dev)
        tr = aid_cv.fold_trainer(model, mcfg, tcfg, graphs, fold, "unused",
                                 dev)
        preds[dev.type] = aid_cv.fold_out_predictions(tr, tr.restore(ckpt),
                                                      fold)
        trainers[dev.type] = tr
    test = fold["test_idx"]
    mae = float(np.abs(preds["cuda"] - y[test]).mean())
    if mae != folds[0]["test_mae_kcal"]:
        raise AssertionError(f"aid fold 0: predictions from ckpt_best give "
                             f"{mae!r}, result.json "
                             f"{folds[0]['test_mae_kcal']!r}")

    def standardized(p):
        return (p - fold["atomref"][test] - fold["mu"]) / fold["sigma"]

    got, ref = standardized(preds["cuda"]), standardized(preds["cpu"])
    diff = np.abs(got - ref)
    log(f"[aid] fold 0's {len(test)} fold-out predictions (standardized "
        f"residuals), card vs CPU: max_abs {diff.max():.3e}, |pred| max "
        f"{np.abs(ref).max():.3e}; the card's reproduce result.json's "
        f"test MAE {mae!r} bitwise")
    np.testing.assert_allclose(got, ref, rtol=MODEL_RTOL, atol=MODEL_ATOL)

    # launches: conv_layers x the windows of every step, evaluation and
    # fold-out prediction of every fold (one set of budgets for all)
    first = trainers["cuda"].batches(trainers["cuda"].train_idx)[0]
    windows = windows_of(first)
    per_batch, train_w, eval_w = len(windows), 0, 0
    for k, r in enumerate(folds):
        with open(os.path.join(cv, f"fold_{k}", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        improved = sum(m["test_mae"] is not None
                       and m["val_mae"] == m["best_val_mae"] for m in recs)
        n_val = max((AID_MOLECULES - r["n_test"]) // 8, AID_BATCH)
        train_w += -(-r["n_train"] // AID_BATCH) * AID_EPOCHS
        eval_w += (-(-n_val // AID_BATCH) * AID_EPOCHS
                   + -(-r["n_test"] // AID_BATCH) * (improved + 1))
    L = mcfg.conv_layers
    expect = {"fwd": L * per_batch * (train_w + eval_w),
              "bwd": L * per_batch * train_w,
              "reduce": L * per_batch * train_w}
    log(f"[aid] launches {counts} (expected {expect}: {L} layers x "
        f"{per_batch} windows x ({train_w} steps + {eval_w} evaluation "
        f"batches for the forward)); windows {windows} of N, D = "
        f"{tuple(first.in_edges.shape)}")
    if counts != expect:
        raise AssertionError(f"aid_cv: launches {counts}, expected {expect}")
    if not any(w[3] > 40 and shapes["bwd"].get(window_shape(w), 0)
               for w in windows):
        raise AssertionError(f"aid_cv: no window with more than 40 key "
                             f"slots launched: {windows}")

    # fold 0 again, in a fresh workdir: the same bits
    cv2 = os.path.join(work, "cv_rerun")
    captured(aid_cv.main, cv_args + ["--fold", "0", "--workdir", cv2])

    def records(d):
        with open(os.path.join(d, "fold_0", "metrics.jsonl")) as f:
            return [{k: v for k, v in json.loads(line).items()
                     if k != "seconds" and not k.endswith("_per_sec")}
                    for line in f]

    with open(os.path.join(cv2, "fold_0", "result.json")) as f:
        again = json.load(f)
    if again != folds[0] or records(cv2) != records(cv):
        raise AssertionError(f"aid fold 0 rerun differs: {again} vs "
                             f"{folds[0]}")
    log(f"[aid] fold 0 rerun: result.json and {len(records(cv))} metrics "
        "records bitwise the first run's (but the wall clock's)")

    # the three kernels on every window of the first training batch
    fwd_src = "x2gnn_tpu_torch/ops/csrc/blocked_attn_fwd.cu"
    bwd_src = "x2gnn_tpu_torch/ops/csrc/blocked_attn_bwd.cu"
    args = batch_kernel_inputs(first, mcfg, seed=160)
    rows, reduces = [], []
    for t, win in enumerate(windows):
        fwd, (bwd, red) = check_window(
            f"AID CV window {t}", window_args(args, win), mcfg, seed=161 + t,
            fwd_timed=True, bwd_timed=True)
        ichunk = win[3] > 40
        note = f"AID CV window {t}, {win} of fold 0's first training batch"
        rows += [
            {"name": f"blocked_attn_fwd (AID CV, window {win})",
             "route": "cuda", "source": fwd_src,
             "replaces": f"{PALLAS}:{282 if ichunk else 166}",
             "launches": shapes["fwd"].get(window_shape(win), 0),
             "window": note, **fwd},
            {"name": f"blocked_attn_bwd (AID CV, window {win})",
             "route": "cuda", "source": bwd_src,
             "replaces": f"{PALLAS}:{346 if ichunk else 198}",
             "launches": shapes["bwd"].get(window_shape(win), 0),
             "window": note, **bwd}]
        reduces.append((win[1] - win[0], win, red))
    _, win, red = max(reduces, key=lambda r: r[0])
    rows.append({"name": "blocked_attn_bwd_reduce (AID CV)", "route": "cuda",
                 "source": bwd_src, "replaces": f"{PALLAS}:271",
                 "launches": counts["reduce"],
                 "window": f"partials of AID CV window {win}", **red})
    return rows


def measurement_scripts(card, device, serving_rate, packed_records,
                        fixed_records):
    """Phase 16: the evaluation and measurement scripts
    (`x2gnn_tpu_torch/scripts/`), each through its `main` as its command
    line calls it: (a) `aid_cross_validation`; (b) `profile_step` on the
    flagship at batch 32, every component printed, no attention launch in
    `no_kernel` and conv_layers x the batch's windows of the forward and
    the backward per step in `full`; (c) `bench_infer` on 256 molecules,
    its rate beside phase 5's; (d) `debug_ep_cost` at world size 1; (e)
    `bench_scaling` on the one card (its single line); (f) `pack_ab
    --report-only` over phase 6a's packed and 6b's fixed-budget runs of the
    recipe (2 epochs each on the same 512 molecules); (g) `pipeline_demo`
    on a geometry-only cache of GEO_MOLECULES molecules, 2 streamed
    epochs. Returns the kernels line's rows."""
    from x2gnn_tpu_torch.config import ModelConfig
    from x2gnn_tpu_torch.scripts import (
        bench_infer, bench_scaling, debug_ep_cost, pack_ab, pipeline_demo,
        profile_step)

    t_phase = time.perf_counter()
    times = {}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        rows = aid_cross_validation(device, work)
        times["a"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        ms, launches, windows = profile_step.profile(32, iters=5,
                                                     device=device)
        full = ms["full"]
        log(json.dumps({"batch": 32, "components": {
            k: {"ms": round(v, 3), "delta_vs_full_ms": round(full - v, 3)}
            for k, v in ms.items()}}))
        n = ModelConfig(attention_layout="blocked").conv_layers * windows
        log(f"[profile_step] attention launches per step: {launches} "
            f"(full: {n} = 4 layers x {windows} windows)")
        if launches["no_kernel"] != {"fwd": 0.0, "bwd": 0.0} or \
                launches["full"] != {"fwd": float(n), "bwd": float(n)}:
            raise AssertionError(f"profile_step: launches {launches}")
        times["b"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        out = captured(bench_infer.main, ["--molecules", "256"])
        rate = json.loads(out.strip().splitlines()[-1])["value"]
        log(f"[bench_infer] {rate} molecules/s on {card}; phase 5's "
            f"throughput {serving_rate:.1f}")
        times["c"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        out = captured(debug_ep_cost.main, [])
        keys = [line.split()[0] for line in out.strip().splitlines()[1:]]
        if keys != ["fwd_ms", "blocked_fwd_ms", "exchange_ms", "norm_ms",
                    "kernel_fullD_ms", "geom_ms", "emb_ms"]:
            raise AssertionError(f"debug_ep_cost: {keys}")
        times["d"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        out = captured(bench_scaling.main, [])
        lines = [json.loads(x) for x in out.strip().splitlines()]
        if [x["mode"] for x in lines] != ["single"] or lines[0]["virtual"]:
            raise AssertionError(f"bench_scaling: {lines}")
        times["e"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        for name, recs in (("packed", packed_records),
                           ("fixed", fixed_records)):
            os.makedirs(os.path.join(work, name))
            with open(os.path.join(work, name, "metrics.jsonl"), "w") as f:
                f.writelines(json.dumps(r) + "\n" for r in recs)
        ab = json.loads(captured(pack_ab.main, [
            "--packed", os.path.join(work, "packed"), "--workdir",
            os.path.join(work, "fixed"), "--mixed",
            os.path.join(work, "no_mixed"), "--report-only"]))
        want = [pack_ab.val_at_steps(fixed_records, r["steps"])
                for r in ab["rows"]]
        if [r["fixed_best_val"] for r in ab["rows"]] != want or \
                ab["packed_steps_per_epoch"] != packed_records[0]["step"]:
            raise AssertionError(f"pack_ab: {ab}")
        times["f"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        run_cli(["x2gnn_tpu_torch.data.make_synthetic", "--n",
                 str(GEO_MOLECULES), "--name", "geo", "--geometry-only",
                 "--cache-dir", work, "--workers", str(os.cpu_count())],
                "geometry-only builder")
        demo = json.loads(captured(pipeline_demo.main, [
            "--cache", os.path.join(work, "geo.npz"), "--division",
            str(GEO_MOLECULES // 10), str(GEO_MOLECULES // 5), "--workdir",
            os.path.join(work, "demo")]))
        log(f"[pipeline_demo] {demo['steps_per_epoch']} streamed steps per "
            f"epoch: {demo['ms_per_step_prefetch']:.3f} ms per step in epoch "
            f"2 (evaluation included), epoch 1 {demo['epoch1_s']:.2f} s, "
            f"epoch 2 {demo['epoch2_s']:.2f} s, on {card}")
        times["g"] = time.perf_counter() - t0
    log(f"[phase 16] took {time.perf_counter() - t_phase:.1f} s: " + ", ".join(
        f"16{k} {v:.1f} s" for k, v in times.items()))
    return rows


# ---- --a12-full, --gap-full: a recipe of the repo on the whole A12 set ----

# the two JAX runs of the flagship recipe on the A12 set (the same
# args.json but max_epoch, the same atomref.json and standardization.json)
A12_RUNS = ("flagship_r5_regression", "flagship_r4_mixed")
A12_N, A12_NAME = 50000, "synthq50k_6311"
# the mode's gates (PERF.md §6, fixed before its first card run): at least
# A12_MIN_EPOCHS epochs; every record with bad_steps 0, a finite loss and
# step = the reference's steps per epoch x epoch; occupancy_pairs bitwise
# r5_regression's (the planner is held bitwise to the reference's); the
# port's best_val_mae at most A12_EARLY_FACTOR x the larger of the two
# JAX runs' at epochs 1-A12_EARLY_EPOCHS (the runs differ by 30% at epoch
# 1) and A12_FACTOR x from there on (they differ by at most 9%), and the
# best epoch's test_mae at the last epoch reached at most A12_FACTOR x the
# larger JAX test_mae at that epoch; the atomref fit and the
# standardization within STATS_RTOL of the reference's
A12_MIN_EPOCHS = 5
A12_EARLY_EPOCHS, A12_EARLY_FACTOR = 2, 1.5
A12_FACTOR = 1.25
# the two JAX runs of the gap recipe on the same set: r5 (dropout 0.1,
# patience 6, 87 epochs) and r4 (dropout 0, patience 3, 60 epochs; its
# occupancy_pairs are an earlier planner's, so the port is held to r5's)
GAP_RUNS = ("gap_r5_50k", "gap_molwise_r4")
# the gap mode's gates (PERF.md §6): the records' bookkeeping as A12's,
# from GAP_MIN_EPOCHS epochs; at the last epoch reached E, the port's
# best_val_mae keeps at least GAP_SHARE of the worse JAX run's gain over
# the better constant predictor (the train split's mean or median label,
# whichever has the smaller val MAE), and lies at most GAP_BAND_FACTOR x
# the runs' spread above that worse run; the best epoch's test_mae the
# same against the test split's constants and the runs' test_mae.
# The share: the JAX curves are nearly flat (best val 2.0017 -> 1.9721 by
# epoch 10), and the median constant is their best rival: its val MAE on
# the set is 2.0270, 0.0549 above the worse run's best from epoch 9 to
# 23, its test MAE 2.0924, 0.0392 above the worse run's test. A model
# that learns nothing drifts towards such a constant (smooth_l1 pulls it
# between the mean and the median), so the share is taken from the
# better constant, and a curve at it keeps none of the gain. The worse
# of the two JAX runs keeps 0.73-0.92 of the better one's val gain over
# it at every cut from 10 epochs (0.76-0.89 of its test gain, bar r5's
# best epochs 24-26, whose test MAE lies 0.0085 under the constant); half
# leaves room for what the port changes beyond what the runs differ in
# (initial weights, the mask stream: JAX's threefry against torch's
# Philox, ROADMAP §C) and holds the port
# 0.027 eV (val) and 0.020 eV (test) under the median constant at E =
# 10-23. The band: the spread is the runs' largest per-epoch |r5 - r4| of
# val_mae over epochs 1-E (0.0157 at E = 10, 0.0283 at E = 11-21), the
# noise of one evaluation of 3,000 molecules under another mask stream; a
# best val MAE is the least of such evaluations and a test_mae one of
# them, so they move by no more; the factor 2 is for the initial weights
# and the mask stream again. Where that band is wider than the share's
# limit (at every cut of the JAX runs: the per-epoch noise is as large
# as the gain), the share is the check that tells learning from a
# constant.
GAP_MIN_EPOCHS = 10
GAP_SHARE = 0.5
GAP_BAND_FACTOR = 2.0
# the modes stop the trainer when its next epoch would end past this many
# seconds from the mode's start: a 3600 s call less the tail's time
A12_DEADLINE_S = 3300.0
A12_POLL_S = 5.0
# training steps timed in-process after the run, on that many batches
A12_TIMED_BATCHES = 40


@dataclasses.dataclass(frozen=True)
class FullRecipe:
    """A recipe of the repository trained on the whole A12 set by a mode
    of its own (`--<tag>-full`)."""
    tag: str
    runs: tuple       # the JAX runs it is held to; the first gives the
                      # statistics, steps per epoch and occupancy_pairs
    args: str         # its args.json
    flags: tuple      # the training CLI's flags beside --config,
                      # --data-npz and --workdir
    gate: object      # (records, refs, baselines) -> (rows, faults)
    report: object    # the gate's rows -> the lines of its table

    @property
    def atomref(self) -> bool:
        return "--atomref-fit" in self.flags

    @property
    def feat_dtype(self) -> str:
        if "--feat-dtype" in self.flags:
            return self.flags[self.flags.index("--feat-dtype") + 1]
        return "float32"


def recipe_references(recipe, runs_dir=os.path.join(REPO, "runs")):
    """The JAX records `recipe` is held to, read from `runs_dir`: each
    run's metrics records, the first run's standardization (and atomref
    table, where the recipe fits one), its steps per epoch and
    occupancy_pairs."""
    def read(run, name):
        with open(os.path.join(runs_dir, run, name)) as f:
            if name.endswith(".jsonl"):
                return [json.loads(line) for line in f if line.strip()]
            return json.load(f)

    curves = {run: read(run, "metrics.jsonl") for run in recipe.runs}
    first = curves[recipe.runs[0]][0]
    refs = {"curves": curves,
            "standardization": read(recipe.runs[0], "standardization.json"),
            "steps_per_epoch": first["step"] // first["epoch"],
            "occupancy_pairs": first["occupancy_pairs"]}
    if recipe.atomref:
        refs["atomref"] = read(recipe.runs[0], "atomref.json")
    return refs


def a12_references(runs_dir=os.path.join(REPO, "runs")):
    """`recipe_references` of the flagship recipe (A12_RUNS)."""
    return recipe_references(A12, runs_dir)


def record_faults(records, refs, min_epochs):
    """The bookkeeping of a full-scale run's metrics records, each failed
    check as text: one record at least; consecutive epochs from 1,
    bad_steps 0, finite losses and step = the steps per epoch x epoch
    (the reference's, or without `refs` the first record's); with `refs`
    also `min_epochs` records at least and occupancy_pairs bitwise the
    reference's."""
    if not records:
        return ["no complete epoch"]
    faults = []
    if refs is not None and len(records) < min_epochs:
        faults.append(f"{len(records)} epochs reached, fewer than "
                      f"{min_epochs}")
    spe = (refs["steps_per_epoch"] if refs is not None
           else records[0]["step"] // max(records[0]["epoch"], 1))
    for i, r in enumerate(records, 1):
        if r["epoch"] != i:
            faults.append(f"record {i} is epoch {r['epoch']}")
        if r["bad_steps"] != 0:
            faults.append(f"epoch {i}: bad_steps {r['bad_steps']}")
        if not math.isfinite(r["loss"]):
            faults.append(f"epoch {i}: loss {r['loss']!r}")
        if r["step"] != spe * i:
            faults.append(f"epoch {i}: step {r['step']}, not {spe * i}")
        if refs is not None and (r.get("occupancy_pairs")
                                 != refs["occupancy_pairs"]):
            faults.append(f"epoch {i}: occupancy_pairs "
                          f"{r.get('occupancy_pairs')!r}, not "
                          f"{refs['occupancy_pairs']!r}")
    return faults


def a12_gate(records, refs, baselines=None):
    """The A12 mode's gate on the port's metrics records. Returns (rows,
    faults): rows (metric, epoch, port, r5, r4, port / the larger JAX
    value, limit, ok) of best_val_mae at every epoch and of test_mae at
    the last; faults, each check that failed as text. With `refs` None (a
    set other than the A12 set) only `record_faults`' checks that need no
    JAX record. `baselines` is not read: the gate holds the port to the
    JAX runs alone."""
    faults = record_faults(records, refs, A12_MIN_EPOCHS)
    if not records or refs is None:
        return [], faults
    curves = [refs["curves"][run] for run in A12_RUNS]
    rows = []
    for r in records:
        e = r["epoch"]
        if e > min(len(c) for c in curves):
            faults.append(f"epoch {e}: no JAX record")
            continue
        factor = A12_EARLY_FACTOR if e <= A12_EARLY_EPOCHS else A12_FACTOR
        jax_best = [c[e - 1]["best_val_mae"] for c in curves]
        ratio = r["best_val_mae"] / max(jax_best)
        rows.append(("best_val_mae", e, r["best_val_mae"], *jax_best,
                     ratio, factor, ratio <= factor))
    last = records[-1]
    e = last["epoch"]
    if e <= min(len(c) for c in curves):
        jax_test = [c[e - 1]["test_mae"] for c in curves]
        got = last["test_mae"]
        ratio = math.inf if got is None else got / max(jax_test)
        rows.append(("test_mae", e, got, *jax_test, ratio, A12_FACTOR,
                     ratio <= A12_FACTOR))
    faults += [f"{m} at epoch {e}: {got!r} is {ratio:.4f} x the larger "
               f"JAX value ({max(r5, r4)!r}), over {limit}"
               for m, e, got, r5, r4, ratio, limit, ok in rows if not ok]
    return rows, faults


def a12_report(rows):
    """The lines of `a12_gate`'s table."""
    head = ["metric | epoch | port | r5_regression | r4_mixed | port / the "
            "larger JAX | limit | verdict"] if rows else []
    return head + [f"{m} | {e} | {got!r} | {r5!r} | {r4!r} | {ratio:.4f} | "
                   f"{limit} | {'pass' if ok else 'FAIL'}"
                   for m, e, got, r5, r4, ratio, limit, ok in rows]


def gap_spread(curves, epoch):
    """The two runs' largest |r5 - r4| of val_mae over epochs 1-`epoch`."""
    a, b = (c[:epoch] for c in curves)
    return max(abs(x["val_mae"] - y["val_mae"]) for x, y in zip(a, b))


def gap_gate(records, refs, baselines):
    """The gap mode's gate on the port's metrics records. Returns (rows,
    faults): rows (metric, E, port, the better constant, r5, r4, share of
    the gain kept, GAP_SHARE, port - the larger JAX value, band, ok) of
    best_val_mae and of the best epoch's test_mae at the last epoch
    reached E, the better constant being the smaller of the split's two
    constant MAEs, the share (constant - port) / (constant - the larger
    JAX value at E) and the band GAP_BAND_FACTOR x `gap_spread` up to E;
    faults, each check that failed as text. `baselines`: the constant
    predictors' MAEs, as `constant_baselines` gives them. With `refs` None
    only `record_faults`' checks that need no JAX record."""
    faults = record_faults(records, refs, GAP_MIN_EPOCHS)
    if not records or refs is None:
        return [], faults
    curves = [refs["curves"][run] for run in GAP_RUNS]
    e = records[-1]["epoch"]
    if e > min(len(c) for c in curves):
        return [], faults + [f"epoch {e}: no JAX record"]
    rows = []
    for metric, split in (("best_val_mae", "val"), ("test_mae", "test")):
        got = records[-1][metric]
        jax = [c[e - 1][metric] for c in curves]
        base = min(baselines[split], baselines[f"{split}_median"])
        if base <= max(jax):
            faults.append(f"{metric}: the better constant {split} baseline "
                          f"{base!r} is not above the JAX runs' {max(jax)!r}")
            continue
        band = GAP_BAND_FACTOR * gap_spread(curves, e)
        if got is None or not math.isfinite(got):
            share, over = -math.inf, math.inf
        else:
            share, over = (base - got) / (base - max(jax)), got - max(jax)
        rows.append((metric, e, got, base, *jax, share, GAP_SHARE, over,
                     band, share >= GAP_SHARE and over <= band))
    faults += [f"{m} at epoch {e}: {got!r} keeps {share:.4f} of the worse "
               f"JAX run's gain over the better constant {base!r} (at "
               f"least {limit}) and lies {over:+.5f} from that run (band "
               f"{band:.5f})"
               for m, e, got, base, r5, r4, share, limit, over, band, ok
               in rows if not ok]
    return rows, faults


def gap_report(rows):
    """The lines of `gap_gate`'s table."""
    head = ["metric | epoch | port | better constant | gap_r5_50k | "
            "gap_molwise_r4 | share of the gain kept | at least | port - "
            "the larger JAX | band | verdict"] if rows else []
    return head + [f"{m} | {e} | {got!r} | {base!r} | {r5!r} | {r4!r} | "
                   f"{share:.4f} | {limit} | {over:+.5f} | {band:.5f} | "
                   f"{'pass' if ok else 'FAIL'}"
                   for m, e, got, base, r5, r4, share, limit, over, band, ok
                   in rows]


A12 = FullRecipe(
    tag="a12", runs=A12_RUNS, args=FLAGSHIP_ARGS,
    flags=("--atomref-fit", "--standardize", "--cache-batches", "on"),
    gate=a12_gate, report=a12_report)
# the flags of scripts/run_gap_r5.sh that args.json does not record
GAP = FullRecipe(
    tag="gap", runs=GAP_RUNS, args=GAP_ARGS,
    flags=("--standardize", "--pack-mixed", "--cache-batches", "on",
           "--feat-dtype", "float16"),
    gate=gap_gate, report=gap_report)


def constant_baselines(graphs, tcfg):
    """The val-split and test-split MAE, in the label's units, of
    predicting every molecule the train split's mean label, and of
    predicting its median (host arithmetic on the recipe's split of the
    raw targets)."""
    import numpy as np
    from x2gnn_tpu_torch.data.dataset import prepare_targets
    from x2gnn_tpu_torch.train.trainer import make_split, resolve_division

    y = np.asarray(prepare_targets(graphs, tcfg.target), np.float64)
    n = len(graphs)
    train, val, test = make_split(n, tcfg.random_seed,
                                  resolve_division(n, tcfg.division))
    mean, median = float(np.mean(y[train])), float(np.median(y[train]))
    return {"train_mean": mean,
            "val": float(np.mean(np.abs(y[val] - mean))),
            "test": float(np.mean(np.abs(y[test] - mean))),
            "train_median": median,
            "val_median": float(np.mean(np.abs(y[val] - median))),
            "test_median": float(np.mean(np.abs(y[test] - median)))}


def train_command(recipe, npz, run):
    """The training CLI's command line of `recipe` on the cache `npz`,
    writing into `run`, as a user runs it."""
    return [sys.executable, "-m", "x2gnn_tpu_torch.train", "--config",
            recipe.args, "--data-npz", npz, *recipe.flags, "--workdir", run]


def complete_records(path):
    """The metrics records of the complete lines of `path` (each ends
    with a newline; a line cut short by a kill is not one)."""
    try:
        with open(path) as f:
            text = f.read()
    except FileNotFoundError:
        return []
    return [json.loads(line) for line in text.split("\n")[:-1]]


def stop_process(proc, grace: float = 30.0):
    """Terminate `proc` and its process group, kill them after `grace`
    seconds, and wait."""
    import signal
    if proc.poll() is not None:
        return
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGTERM)
    try:
        proc.wait(grace)
    except subprocess.TimeoutExpired:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def train_until(cmd, metrics, deadline, poll_s=A12_POLL_S, on_poll=None,
                log_path=os.devnull, cwd=REPO):
    """Run `cmd` (a trainer writing one line to `metrics` per epoch) in a
    process group of its own and poll `metrics` every `poll_s` seconds;
    stop it when its next epoch would end past `deadline` (a
    time.perf_counter() value): the longest wall time between two
    records after the first, or before the second record the first's,
    from now. `on_poll(proc)` is called at every poll. Returns (the
    complete records once the process has ended, its exit code, whether
    it was stopped, {epoch: seconds from the start when its record was
    first seen})."""
    t0 = time.perf_counter()
    seen = {}
    stopped = False
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=cwd, stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            while proc.poll() is None:
                now = time.perf_counter()
                for r in complete_records(metrics):
                    seen.setdefault(r["epoch"], now - t0)
                if on_poll is not None:
                    on_poll(proc)
                at = [0.0] + [seen[e] for e in sorted(seen)]
                gaps = [b - a for a, b in zip(at, at[1:])]
                next_epoch = max(gaps[1:] or gaps or [0.0])
                if now + next_epoch + poll_s > deadline:
                    stopped = True
                    break
                time.sleep(poll_s)
        finally:
            stop_process(proc)
    records = complete_records(metrics)
    for r in records:     # finished after the last poll
        seen.setdefault(r["epoch"], time.perf_counter() - t0)
    return records, proc.returncode, stopped, seen


def _host_lines(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()


def full_step_timings(graphs, targets, std, mcfg, tcfg, device, work,
                      feat_dtype):
    """In-process timings of the recipe on the whole set, after the run:
    the plan of the training split (seconds), the host assembly of a
    packed batch (ms), a packed training step (with its dropout masks,
    where the model has dropout) on the plan's first A12_TIMED_BATCHES
    batches, cached (ms, CUDA events, median of 30; the plan puts its
    largest molecules first, so these are its heaviest steps), the val
    and test passes from the device cache (s, warm) and the peak device
    memory of these steps (GB). Returns (the timings, the trainer, its
    state after the steps, the timed device batches)."""
    import torch
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.train.trainer import Trainer

    model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)
    t0 = time.perf_counter()
    trainer = Trainer(model, mcfg, tcfg, graphs, targets, workdir=work,
                      std=std, device=device, cache_batches=True,
                      feat_dtype=feat_dtype)
    plan = trainer._plan_of(trainer.train_idx)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [trainer._assemble(e) for e in plan[:A12_TIMED_BATCHES]]
    assemble_ms = (time.perf_counter() - t0) * 1e3 / len(host)
    batches = [b.to(device) for b in host]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, state, _ = step_ms(trainer, trainer.init_state(), batches, reps=30)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    evals = {}
    for name, idx in (("val", trainer.val_idx), ("test", trainer.test_idx)):
        trainer.evaluate(state, idx)          # builds its device cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.evaluate(state, idx)
        torch.cuda.synchronize()
        evals[name] = time.perf_counter() - t0
    return ({"plan_s": plan_s, "plan_batches": len(plan),
             "n_train": len(trainer.train_idx),
             "assemble_ms": assemble_ms, "step_ms": ms,
             "step_peak_gb": peak_gb, "val_s": evals["val"],
             "test_s": evals["test"]}, trainer, state, batches)


def drop_kernel_rows(trainer, state, batch, card, label):
    """The kernels' <drop> instances at the set's scale, on `batch`, the
    plan's first (its heaviest): every tier window's forward and backward
    under seeded masks against their plain versions within phase 3's
    gates and timed (`check_masked_window`), the reduce on each tier's
    <drop> partials against a float64 sum and timed against
    partial.sum(0); the launches of one training step on the batch,
    counted with the counters zeroed just before it. An epoch's launches
    are logged as the training split's plan gives them (conv_layers x the
    windows of each planned step), not counted: the training CLI runs in
    a process of its own. `label` names the recipe and the set in the
    rows and the log. Returns the kernels line's rows."""
    import torch
    from x2gnn_tpu_torch.models.x2gnn import attention_windows
    from x2gnn_tpu_torch.ops.blocked_attn import (
        blocked_attention_bwd_partials, blocked_attention_fwd,
        reset_launch_counts)

    mcfg = trainer.mcfg
    H, K, L = mcfg.heads, mcfg.rbf_dim, mcfg.conv_layers
    windows = windows_of(batch)
    # an epoch's launches of each kernel by the plan's arithmetic
    per_epoch = L * sum(len(attention_windows(b.n_node, b.n_deg, b.n_hi,
                                              b.n_deg_lo, b.tiers))
                        for _, b, _ in trainer._plan_of(trainer.train_idx))
    reset_launch_counts()
    step = int(state.step)
    trainer.train_step(state, batch, step)
    torch.cuda.synchronize()
    shapes, counts = launch_shapes(), launch_counts()
    expect = L * len(windows)
    log(f"[{label}] one training step on the plan's first batch (N="
        f"{batch.in_edges.shape[0]}, D={batch.in_edges.shape[1]}, "
        f"{len(windows)} windows): launches {json.dumps(counts)}, per "
        f"variant fwd {per_variant(shapes['fwd_variants'])}, bwd "
        f"{per_variant(shapes['bwd_variants'])} (expected {expect} of "
        f"each, all <drop>)")
    if (counts != dict.fromkeys(("fwd", "bwd", "reduce"), expect)
            or per_variant(shapes["fwd_variants"]) != {"drop": expect}
            or per_variant(shapes["bwd_variants"]) != {"drop": expect}):
        raise AssertionError(f"{label}: a step's launches {counts}, "
                             f"{shapes}")
    args = batch_kernel_inputs(batch, mcfg, seed=194)
    rows = []
    for t, win in enumerate(windows):
        wargs = window_args(args, win)
        recs = check_masked_window(f"{label} tier {t}", wargs, mcfg,
                                   seed=200 + 10 * t, timed=True)
        shape = window_shape(win)
        ichunk = win[3] > 40
        note = f"tier {t}, {win} of the {label} plan's heaviest batch"
        N, DI, DK = shape
        m = keep_mask((N, DI, DK, H), DROP_RATES[0], 300 + t,
                      wargs[0].device)
        out = blocked_attention_fwd(*wargs, heads=H, num_radial=K,
                                    dropout_mask=m)
        g = torch.ones_like(out)
        partial = blocked_attention_bwd_partials(
            *wargs, g, heads=H, num_radial=K, out=out, dropout_mask=m)[-1]
        tag = f"{label} tier {t} N={N} DI={DI} DK={DK}"
        red, red_err = check_reduce(tag, partial)
        recs["reduce"] = time_reduce(tag, partial, red, red_err)
        for name, line, source in (
                ("fwd drop", 282 if ichunk else 166, "blocked_attn_fwd.cu"),
                ("bwd drop", 346 if ichunk else 198, "blocked_attn_bwd.cu"),
                ("reduce", 271, "blocked_attn_bwd.cu")):
            side = name.split()[0]
            kernel = ("reduce_rows (the <drop> backward's partials"
                      if side == "reduce" else f"blocked_attn_{side} (drop")
            step_n = (counts["reduce"] // len(windows) if side == "reduce"
                      else shapes[f"{side}_variants"].get(
                          ("drop", *shape), 0))
            rows.append({
                "name": f"{kernel}, {label} tier {t})", "route": "cuda",
                "source": f"x2gnn_tpu_torch/ops/csrc/{source}",
                "replaces": f"{PALLAS}:{line}", "launches": step_n,
                "window": note, **recs[name]})
    reset_launch_counts()
    for side in ("fwd drop", "bwd drop", "reduce"):
        sel = [r for r in rows if r["name"].startswith(
            "reduce_rows" if side == "reduce"
            else f"blocked_attn_{side.split()[0]} (drop")]
        log(f"[{card}] {label} {side} over the {len(sel)} tiers: "
            f"{sum(r['ms'] for r in sel):.4f} ms back to back, bound "
            f"{sum(r['bound_ms'] for r in sel):.5f} ms, plain "
            f"{sum(r['plain_ms'] for r in sel):.4f} ms; "
            f"{sum(r['launches'] for r in sel)} launches a step (counted); "
            f"{per_epoch} an epoch by the plan's arithmetic (conv_layers x "
            f"the windows of each planned step; not counted)")
    return rows


def full_recipe(recipe, n=A12_N, deadline_s=A12_DEADLINE_S):
    """`recipe` at full scale: the A12 set of `n` molecules built by the
    port's builder, its label statistics (and atomref fit) held to the
    first JAX run's, the constant predictors' MAEs printed and handed to
    the recipe's gate, the recipe trained by the training CLI until
    its next epoch would end past `deadline_s` seconds from the start,
    and its records held to the JAX runs by the recipe's gate; then the
    timings and, where the model has dropout, the kernels' <drop>
    instances at the set's heaviest batch (`drop_kernel_rows`).
    Everything is written into a temporary directory. With `n` other than
    A12_N the JAX checks are skipped. Returns (whether every check passed
    (always False for another `n`: only the A12 set can pass), the
    kernels line's rows)."""
    import torch
    t_start = time.perf_counter()
    tag = recipe.tag
    if not torch.cuda.is_available():
        raise RuntimeError(f"--{tag}-full: no CUDA device; the mode runs "
                           "only on the card")
    from x2gnn_tpu_torch.config import load_configs
    from x2gnn_tpu_torch.data.dataset import load_graph_cache
    from x2gnn_tpu_torch.ops import _build

    card = _host_lines(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"])[0]
    print(card, flush=True)
    deadline = t_start + deadline_s
    full = n == A12_N
    refs = recipe_references(recipe) if full else None
    if not full:
        log(f"[{tag}] n={n}: a trial of the mechanics; the JAX checks are "
            f"skipped and no ok line is printed (the acceptance run is "
            f"n={A12_N})")
    cores = len(os.sched_getaffinity(0))
    mcfg, tcfg = load_configs(recipe.args)
    device = torch.device("cuda")
    for name, built in _build.build_all().items():
        log(f"[{tag}] kernel {name}: {built.seconds:.2f} s nvcc")
    work = tempfile.mkdtemp(prefix=f"{tag}_full_")
    rows = []
    try:
        for line in (_host_lines(["free", "-g"])
                     + _host_lines(["df", "-h", work])):
            log(f"[{tag}] host: {line}")
        # 1. the set
        t0 = time.perf_counter()
        run_cli(["x2gnn_tpu_torch.data.make_synthetic", "--n", str(n),
                 "--name", A12_NAME, "--basis", "6311", "--gap-label",
                 "--workers", str(cores), "--cache-dir", work],
                f"{tag} build",
                timeout=max(deadline - time.perf_counter(), 60))
        build_s = time.perf_counter() - t0
        npz = os.path.join(work, f"{A12_NAME}.npz")
        log(f"[{tag}] build: {n} molecules in {build_s:.1f} s, "
            f"{build_s * 1e3 / n:.2f} ms per molecule over {cores} host "
            f"cores; {os.path.getsize(npz) / 1e9:.2f} GB npz")
        for line in (_host_lines(["free", "-g"])
                     + _host_lines(["df", "-h", work])):
            log(f"[{tag}] host: {line}")
        # 2. the labels: the atomref fit and the standardization
        t0 = time.perf_counter()
        graphs = load_graph_cache(npz)
        targets, std, atomref, mu, sigma = curve_labels(
            graphs, tcfg, atomref=recipe.atomref)
        log(f"[{tag}] loaded the set and fitted its labels in "
            f"{time.perf_counter() - t0:.1f} s")
        source = f"runs/{recipe.runs[0]}'s"
        if full:
            check_curve_stats(atomref, mu, sigma, refs, tag=tag,
                              source=source)
        # 3. the constant baselines
        baselines = constant_baselines(graphs, tcfg)
        log(f"[{tag}] constant baselines (every molecule predicted the "
            f"train split's mean label {baselines['train_mean']!r}): val "
            f"MAE {baselines['val']!r}, test MAE {baselines['test']!r}; "
            f"its median {baselines['train_median']!r}: val MAE "
            f"{baselines['val_median']!r}, test MAE "
            f"{baselines['test_median']!r}")
        # 4. the recipe as a user runs it
        run = os.path.join(work, "run")
        metrics = os.path.join(run, "metrics.jsonl")
        cmd = train_command(recipe, npz, run)
        log(f"[{tag}] training: {' '.join(cmd[1:])}; stopped when its next "
            f"epoch would end past {deadline_s:.0f} s from the start "
            f"({deadline - time.perf_counter():.0f} s from now)")
        samples = []

        def sample(proc):
            if proc.poll() is not None:
                return
            used = _host_lines(["nvidia-smi", "--query-gpu=memory.used",
                                "--format=csv,noheader,nounits"])
            with contextlib.suppress(OSError), \
                    open(f"/proc/{proc.pid}/status") as f:
                rss = [int(line.split()[1]) for line in f
                       if line.startswith("VmRSS")]
                if rss and rss[0] > 0:     # none once it is exiting
                    samples.append((time.perf_counter(), int(used[0]),
                                    rss[0] / 1e6))

        t_train = time.perf_counter()
        records, rc, stopped, seen = train_until(
            cmd, metrics, deadline, on_poll=sample,
            log_path=os.path.join(work, "train.log"))
        train_s = time.perf_counter() - t_train
        with open(os.path.join(work, "train.log")) as f:
            for line in f.read().strip().splitlines()[-8:]:
                log(f"[{tag}] trainer: {line}")
        how = "stopped by the deadline" if stopped else "ended"
        log(f"[{tag}] trainer {how} after {train_s:.1f} s (exit {rc}); "
            f"{len(records)} complete "
            f"epochs of {tcfg.max_epoch}: the run's cut")
        if not stopped and rc != 0:
            raise AssertionError(f"{tag}: the trainer exited {rc}")
        if full:
            # the files the training CLI wrote beside its run
            written = None
            if recipe.atomref:
                with open(os.path.join(run, "atomref.json")) as f:
                    written = json.load(f)
            with open(os.path.join(run, "standardization.json")) as f:
                written_std = json.load(f)
            check_curve_stats(written, written_std["mu"],
                              written_std["sigma"], refs, tag=f"{tag} CLI",
                              source=source)
        # 5. the gate
        gate_rows, faults = recipe.gate(records, refs, baselines)
        for line in recipe.report(gate_rows):
            log(f"[{tag}] {line}")
        for r in records:
            log(f"[{tag}] epoch {r['epoch']}: val_mae {r['val_mae']!r}, "
                f"best_val_mae {r['best_val_mae']!r}, test_mae "
                f"{r['test_mae']!r}, loss {r['loss']!r}, lr_scale "
                f"{r.get('lr_scale')!r}")
        # 6. the timings
        secs = [r["seconds"] for r in records]
        log(f"[{card}] epoch seconds (wall clock, with evaluation and "
            f"checkpoints): {', '.join(f'{s:.1f}' for s in secs)}")
        if len(secs) > 1:
            steady = statistics.median(secs[1:])
            rate = statistics.median(r["molecules_per_sec"]
                                     for r in records[1:])
            log(f"[{card}] seconds per epoch with evaluation: median "
                f"{steady:.1f} (epochs 2-{len(secs)}); the first epoch's "
                f"extra seconds (batch planning, the device cache): "
                f"{secs[0] - steady:.1f}; training molecules/s with "
                f"evaluation: median {rate:.1f}")
        log(f"[{card}] from the trainer's start to its first record "
            f"{seen.get(1, math.nan):.1f} s (of which epoch 1 "
            f"{secs[0] if secs else math.nan:.1f} s)")
        if samples:
            log(f"[{card}] peak device memory (nvidia-smi memory.used, the "
                f"whole card) {max(s[1] for s in samples)} MiB; trainer "
                f"host RSS peak {max(s[2] for s in samples):.2f} GB")
            for e in sorted(seen):
                at = t_train + seen[e]
                near = min(samples, key=lambda s: abs(s[0] - at))
                if near[0] > at + 2 * A12_POLL_S:
                    continue      # the trainer had ended
                log(f"[{tag}] at epoch {e}'s record: card {near[1]} MiB, "
                    f"trainer RSS {near[2]:.2f} GB")
        t0 = time.perf_counter()
        timed, trainer, state, batches = full_step_timings(
            graphs, targets, std, mcfg, tcfg, device,
            os.path.join(work, "timing"), recipe.feat_dtype)
        spe = records[0]["step"] if records else timed["plan_batches"]
        masks = (", with its dropout masks" if mcfg.dropout > 0 else "")
        log(f"[{card}] in-process after the run "
            f"({time.perf_counter() - t0:.1f} s): plan of the training "
            f"split {timed['plan_s']:.1f} s ({timed['plan_batches']} "
            f"batches), host assembly "
            f"{timed['assemble_ms']:.2f} ms per packed batch, "
            f"{timed['step_ms']:.3f} ms per packed training step{masks} "
            f"(median of 30 on the plan's first {A12_TIMED_BATCHES} "
            f"batches, its largest molecules, cached; CUDA events), "
            f"peak allocated {timed['step_peak_gb']:.2f} GB; val pass "
            f"{timed['val_s']:.2f} s, test pass {timed['test_s']:.2f} s "
            f"(cached, warm)")
        train_only = spe * timed["step_ms"] / 1e3
        log(f"[{card}] an epoch of such steps without evaluation: "
            f"{train_only:.1f} s ({spe} steps x {timed['step_ms']:.3f} ms), "
            f"{timed['n_train'] / train_only:.1f} training molecules/s")
        # 7. the dropout kernels at the set's scale
        if mcfg.dropout > 0:
            t0 = time.perf_counter()
            rows = drop_kernel_rows(trainer, state, batches[0], card,
                                    f"{tag} n={n}")
            log(f"[{tag}] the <drop> kernels on the heaviest batch took "
                f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[{tag}] done in {time.perf_counter() - t_start:.1f} s")
    if faults:
        raise AssertionError(f"{tag}: {len(faults)} checks failed: {faults}")
    return full, rows


def a12_full(n=A12_N, deadline_s=A12_DEADLINE_S):
    """A12 at full scale: `full_recipe` of the flagship recipe. Returns
    whether every check passed (always False for an `n` other than
    A12_N)."""
    return full_recipe(A12, n, deadline_s)[0]


def gap_full(n=A12_N, deadline_s=A12_DEADLINE_S):
    """The gap recipe at full scale: `full_recipe` of
    runs/gap_r5_50k/args.json with scripts/run_gap_r5.sh's flags,
    held to the two JAX gap runs by `gap_gate`. Returns (whether every
    check passed, the <drop> kernels' rows)."""
    return full_recipe(GAP, n, deadline_s)


# ---- --multi-card: the parallel paths on four cards over NCCL ----

MC_RANKS = 4
# the whole mode, inside a 900 s limit
MC_DEADLINE_S = 800.0
# each torch.distributed.run's own deadline, capped by what the mode has
# left: the rank group of (a)-(d) and (f), each training CLI run,
# bench_scaling
MC_RANKS_S, MC_CLI_S, MC_BENCH_S = 360.0, 200.0, 200.0
MC_REPS = 20            # (f): timed steps and exchanges, median
MC_CLI_N = 512          # (e): the CLI's --synthetic molecules
# the mode's logs and results, in the output directory that .gitignore
# lists
MC_OUT = os.path.join(REPO, "chiprun_out", "multi_card")
# the mode's gates (PERF.md §6, fixed before its first 4-card run):
# gradients by held_grads (GRAD_RTOL of each element plus GRAD_ATOL of
# the largest magnitude, the card-vs-CPU gate), the step's loss within
# MC_LOSS_RTOL relative, EP predictions within MODEL_ATOL + MODEL_RTOL x
# |ref| (phase 13c's), each rank's first window by phase 3's kernel
# gates; bitwise: the parameters on every rank after every step, a rerun
# of the DP steps, ring against allgather (predictions, gradients, the
# loss, a step's parameters), the resumed CLI run against the straight
# one; the val MAE of Predictor.from_run on the CLI run within
# MC_MAE_RTOL of rank 0's logged one
MC_LOSS_RTOL = 1e-5
MC_MAE_RTOL = 1e-4


def mc_torchrun(args, nproc=MC_RANKS):
    """The command line that starts `args` (a script and its arguments,
    or -m and a module) on `nproc` ranks of this host."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(nproc), *args]


def child_pids(pid):
    """Every process below `pid` (Linux /proc)."""
    parent = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        parent[int(name)] = int(stat.rsplit(")", 1)[1].split()[1])
    out, frontier = [], [pid]
    while frontier:
        ppid = frontier.pop()
        kids = [c for c, p in parent.items() if p == ppid]
        out += kids
        frontier += kids
    return out


def _running(pid):
    """`pid` exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def stop_tree(proc, grace: float = 10.0):
    """SIGTERM `proc`, every process below it and their process groups
    (torch.distributed.run starts each rank in a session of its own),
    SIGKILL what is left after `grace` seconds, and wait for `proc`."""
    import signal
    pids = [proc.pid] + child_pids(proc.pid)
    for sig, wait in ((signal.SIGTERM, grace), (signal.SIGKILL, 10.0)):
        for pid in pids:
            for kill in (os.killpg, os.kill):
                with contextlib.suppress(ProcessLookupError,
                                         PermissionError):
                    kill(pid, sig)
        end = time.monotonic() + wait
        while proc.poll() is None or any(_running(p) for p in pids):
            if time.monotonic() > end:
                break
            time.sleep(0.1)
        else:
            return
    proc.wait()


def mc_note(run_dir, rank, phase):
    """Record in `run_dir` that `rank` entered `phase`: what a deadline's
    message names."""
    with open(os.path.join(run_dir, f"phase.rank{rank}"), "w") as f:
        f.write(phase)


def mc_where(run_dir):
    """{rank: the phase it last entered} from the notes in `run_dir`."""
    where = {}
    for name in sorted(os.listdir(run_dir)):
        if name.startswith("phase.rank"):
            with open(os.path.join(run_dir, name)) as f:
                where[int(name[len("phase.rank"):])] = f.read()
    return where


def mc_launch(cmd, phase, deadline_s, stem, run_dir=None):
    """Run `cmd` (a torch.distributed.run command line) from the
    repository root in a session of its own, its standard output into
    stem.out and its standard error into stem.err, for at most
    `deadline_s` seconds. At the deadline it and every process it started
    are stopped (`stop_tree`) and AssertionError names `phase` and, from
    the notes in `run_dir`, the phase each rank was in; a non-zero exit
    raises with the end of its standard error. Returns (standard output,
    standard error, seconds)."""
    t0 = time.perf_counter()
    with open(stem + ".out", "w") as out, open(stem + ".err", "w") as err:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=out, stderr=err,
                                start_new_session=True)
        try:
            proc.wait(timeout=max(deadline_s, 1.0))
        except subprocess.TimeoutExpired:
            where = mc_where(run_dir) if run_dir else {}
            stop_tree(proc)
            raise AssertionError(
                f"{phase}: still running at its deadline of "
                f"{deadline_s:.0f} s, stopped with every process it started"
                + (f"; the ranks were in {where}" if where else "")) from None
        finally:
            if proc.poll() is None:
                stop_tree(proc)
    seconds = time.perf_counter() - t0
    with open(stem + ".out") as f:
        stdout = f.read()
    with open(stem + ".err") as f:
        stderr = f.read()
    if proc.returncode != 0:
        tail = "\n".join(stderr.strip().splitlines()[-30:])
        raise AssertionError(f"{phase}: exit {proc.returncode} after "
                             f"{seconds:.1f} s; its standard error ends:\n"
                             f"{tail}")
    return stdout, stderr, seconds


# the rank functions: fn(rank, world, device, ...) on every rank of an
# initialized process group (the card's NCCL group in the mode, a gloo
# group of CPU processes in tests/test_torch_port_multicard.py). Every
# gate runs through mc_agree, so a failure raises on every rank at once
# and no rank is left waiting in a later collective.

def mc_agree(tag, check):
    """`check()` on every rank; if it raised AssertionError on any rank,
    every rank raises one naming each failing rank. Returns check()'s
    value."""
    try:
        out, err = check(), None
    except AssertionError as e:
        out, err = None, str(e)
    errors = gather_objects(err)
    bad = [f"rank {r}: {e}" for r, e in enumerate(errors) if e is not None]
    if bad:
        raise AssertionError(f"{tag}: " + " | ".join(bad))
    return out


def gather_objects(obj):
    """Every rank's `obj`, in rank order."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def params_digest(leaves):
    """sha256 of the parameters' bytes, in order."""
    import hashlib
    import torch
    flat = torch.cat([p.detach().reshape(-1) for p in leaves])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def same_bits(tag, values):
    """Raise unless every rank's value (gathered) is the same."""
    if len(set(values)) != 1:
        raise AssertionError(f"{tag}: not the same bits on every rank "
                             f"({values})")


def loss_gate(tag, got, want):
    if not abs(got - want) <= MC_LOSS_RTOL * abs(want):
        raise AssertionError(f"{tag}: loss {got!r} against the plain "
                             f"step's {want!r}")


def pred_gate(tag, pred, ref):
    """Phase 13c's gate on EP predictions against the blocked model's."""
    import torch
    err = (pred - ref).abs()
    if not torch.isfinite(pred).all() or \
            (err > MODEL_ATOL + MODEL_RTOL * ref.abs()).any():
        raise AssertionError(f"{tag}: predictions differ (max_abs "
                             f"{float(err.max()):.3e})")
    return float(err.max())


def launches_gate(tag, counts, n):
    """`n` launches of each kernel: one per conv (one window per rank) on
    the card."""
    if counts != {"fwd": n, "bwd": n, "reduce": n}:
        raise AssertionError(f"{tag}: launches {counts}, expected {n} of "
                             "each")


def ring_gate(tag, ring, allgather):
    """The two exchanges' (predictions, flat gradients, loss) bitwise."""
    import torch
    for name, a, b in zip(("predictions", "gradients", "loss"), ring,
                          allgather):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: ring and allgather {name} "
                                 "differ")


def placement_gate(records, world):
    """(a): one record per rank; each on the card of its LOCAL_RANK (the
    device index, the current device and LOCAL_RANK agree), NCCL, and
    `world` distinct card UUIDs."""
    if [r["rank"] for r in records] != list(range(world)):
        raise AssertionError(f"placement: records of ranks "
                             f"{[r['rank'] for r in records]}")
    for r in records:
        if not r["index"] == r["current"] == r["local_rank"]:
            raise AssertionError(f"placement: rank {r['rank']} on card "
                                 f"{r['index']} (current {r['current']}), "
                                 f"LOCAL_RANK {r['local_rank']}")
        if r["backend"] != "nccl":
            raise AssertionError(f"placement: rank {r['rank']} over "
                                 f"{r['backend']}")
    uuids = [r["uuid"] for r in records]
    if None in uuids or len(set(uuids)) != world:
        raise AssertionError(f"placement: card UUIDs {uuids}")


def seed0_model(mcfg, device):
    """The flagship's seed-0 weights, as phase 13 makes them."""
    import torch
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    return X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)


def fresh_state(model, tcfg):
    """(optimizer, the initial TrainState over the model's parameters)."""
    import torch
    from x2gnn_tpu_torch.train.ema import ema_init
    from x2gnn_tpu_torch.train.optim import Optimizer
    from x2gnn_tpu_torch.train.trainer import TrainState
    leaves = list(model.parameters())
    opt = Optimizer(tcfg)
    zero = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    return opt, TrainState(leaves, opt.init(leaves), ema_init(leaves), zero,
                           zero.clone())


def restore_params(leaves, start):
    import torch
    with torch.no_grad():
        for p, s in zip(leaves, start):
            p.copy_(s)


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, device, reps, warmup=3, barrier=False):
    """Median ms of one fn() over `reps` calls after `warmup`: CUDA events
    on the card (the host clock on the CPU, for the tests only); with
    `barrier`, every rank enters each call together."""
    import torch
    import torch.distributed as dist
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(reps):
        if barrier:
            dist.barrier()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            times.append((start, end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    sync(device)
    if device.type == "cuda":
        times = [s.elapsed_time(e) for s, e in times]
    return statistics.median(times)


def mc_packed_hosts(mcfg, tcfg, graphs, count):
    """The first `count` host batches of the train split's plan, as phase
    6's Trainer plans and assembles them (packed, degree-sorted, tiered);
    no weights or card needed."""
    import numpy as np
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.train.trainer import Trainer
    targets = np.array([g.y[0] for g in graphs], np.float32)
    t = Trainer(X2GNN(mcfg, device="cpu"), mcfg, tcfg, graphs, targets,
                workdir="unused", device="cpu")
    plan = t._plan_of(t.train_idx)
    if len(plan) < count:
        raise ValueError(f"{len(plan)} planned batches, {count} wanted")
    return [t._assemble(e) for e in plan[:count]]


def whole_batch(graphs):
    """`graphs` as one host batch at pad_budget_for's budgets."""
    from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
    return pad_graphs(graphs, pad_budget_for(graphs, len(graphs)))


def mc_placement(rank, world, device):
    """(a): every rank's card (index, current device, UUID, name), its
    LOCAL_RANK and the group's backend, gathered and gated."""
    import torch
    import torch.distributed as dist
    device = torch.device(device)
    cuda = device.type == "cuda"
    rec = {"rank": rank, "local_rank": int(os.environ.get("LOCAL_RANK", -1)),
           "index": device.index if cuda else None,
           "current": torch.cuda.current_device() if cuda else None,
           "uuid": (str(torch.cuda.get_device_properties(device).uuid)
                    if cuda else None),
           "name": torch.cuda.get_device_name(device) if cuda else "cpu",
           "backend": dist.get_backend()}
    records = gather_objects(rec)
    for r in records:
        log(f"[multi-card (a)] rank {r['rank']} LOCAL_RANK {r['local_rank']}"
            f": cuda:{r['index']} (current {r['current']}), {r['name']}, "
            f"UUID {r['uuid']}, {r['backend']}")
    placement_gate(records, world)
    return records


def mc_dp(rank, world, device, mcfg, tcfg, hosts):
    """(b) data parallelism: the seed-0 model takes one step per group of
    `world` consecutive host batches of `hosts` (the last group ragged:
    `empty_like_batch` fillers on the ranks past its batches), each rank
    its member through `dp_batch_iterator`. Before each step every rank
    computes the all-reduced gradient and loss of its member and, on its
    own device, the plain step of the whole group (`group_grads`), and
    holds one to the other; after each step the parameters are the same
    bits on every rank; the steps run again from the same start give the
    same bits; no step is skipped."""
    import torch
    from x2gnn_tpu_torch.parallel import (
        dp_batch_iterator, make_dp_train_step, make_mesh)
    from x2gnn_tpu_torch.parallel.data_parallel import reduced_gradients
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss
    device = torch.device(device)
    mesh = make_mesh()
    groups = [hosts[lo:lo + world] for lo in range(0, len(hosts), world)]
    if len(groups[-1]) == world:
        raise ValueError(f"{len(hosts)} batches over {world} ranks leave "
                         "no ragged group")
    model = seed0_model(mcfg, device)
    leaves = list(model.parameters())
    start = [p.detach().clone() for p in leaves]

    def run(check):
        restore_params(leaves, start)
        opt, state = fresh_state(model, tcfg)
        step = make_dp_train_step(model, opt, tcfg.ema_decay, mesh)
        rows = []
        for i, group in enumerate(groups, 1):
            mine = next(dp_batch_iterator(group, world, rank)).to(device)
            row = {"graphs_here": int(mine.graph_mask.sum())}
            if check:
                tag = f"DP {world} ranks, step {i}"
                loss = smooth_l1_loss(model(mine), mine.y,
                                      mask=mine.graph_mask)
                flat, gloss, total = reduced_gradients(
                    loss, leaves, mine.graph_mask.sum())
                want, ref = group_grads(model, group, device)
                row.update(graphs=int(total), loss=float(gloss),
                           plain_loss=want)
                row["worst"] = mc_agree(
                    f"{tag}: gradients",
                    lambda: held_grads(tag, split_grads(flat, model), ref))
                mc_agree(f"{tag}: loss",
                         lambda: loss_gate(tag, float(gloss), want))
            state, _, _ = step(state, mine)
            row["digest"] = params_digest(leaves)
            rows.append(row)
        return rows, int(state.bad_steps)

    rows, bad = run(check=True)
    again, _ = run(check=False)
    restore_params(leaves, start)
    every = gather_objects([r["digest"] for r in rows])
    for i in range(len(rows)):
        same_bits(f"DP step {i + 1}: the parameters", [d[i] for d in every])

    def rerun():
        if [r["digest"] for r in again] != [r["digest"] for r in rows]:
            raise AssertionError("DP: a rerun of the steps differs")
        if bad:
            raise AssertionError(f"DP: {bad} steps skipped")

    mc_agree("DP rerun", rerun)
    for i, r in enumerate(rows, 1):
        log(f"[multi-card (b)] DP step {i}: {r['graphs']} real graphs over "
            f"{world} ranks ({r['graphs_here']} here), loss {r['loss']!r} "
            f"(plain {r['plain_loss']!r}), largest max|err|/max|g| "
            f"{r['worst']:.3e}, parameters the same bits on every rank")
    log(f"[multi-card (b)] DP: {len(rows)} steps, the last group "
        f"{len(groups[-1])} batches of {world}; a rerun bitwise")
    return {"steps": [{k: v for k, v in r.items() if k != "digest"}
                      for r in rows], "digest": rows[-1]["digest"]}


def first_ep_window(model, local, mesh):
    """The attention inputs (q, k, v, e, rbf, W, bias, z, a_ids, b_ids) of
    the first kernel call of this rank's EP forward: conv 0's window
    (Nl, D, D), detached copies."""
    import torch
    from x2gnn_tpu_torch.parallel import ep_model, make_ep_forward
    seen = []
    call = ep_model.blocked_attention

    def spy(*args, **kw):
        if not seen:
            seen.append(tuple(a.detach().clone() for a in args[:10]))
        return call(*args, **kw)

    ep_model.blocked_attention = spy
    try:
        with torch.no_grad():
            make_ep_forward(mesh)(model, local)
    finally:
        ep_model.blocked_attention = call
    return seen[0]


def exchange_ms(local, mesh, mode, width, reps):
    """(f): median ms of one row exchange (`ep_model.py::exchange`, a
    conv's K, V and radial rows, (Nl·D, width) float32) on this rank,
    every rank entering each call together."""
    import torch
    from x2gnn_tpu_torch.parallel.ep_model import _Axis, exchange
    Nl, D = local.in_mask.shape
    device = local.in_mask.device
    x = torch.randn((Nl * D, width),
                    generator=torch.Generator().manual_seed(7)).to(device)
    axis = _Axis.of(mesh, mode)
    return timed_ms(lambda: exchange(x, local, axis), device, reps,
                    barrier=True)


def mc_ep(rank, world, device, mcfg, tcfg, batches, reps):
    """(c) edge partitioning over every rank, for each host batch of
    `batches` ({name: GraphBatch}) and each exchange: the seed-0 model's
    predictions against the single-device blocked model on the batch as
    one window, every reduced gradient against its plain step, ring
    bitwise the allgather, one launch of each kernel per conv; this
    rank's first window against the plain kernels (on the card) and the
    row exchange timed. Then one EP training step on the first batch per
    exchange: the parameters the same bits on every rank and in both
    exchanges, the launches of a step."""
    import torch
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.parallel import (
        make_ep_batch, make_ep_forward, make_ep_train_step, make_mesh,
        shard_ep_batch)
    from x2gnn_tpu_torch.parallel.data_parallel import reduced_gradients
    from x2gnn_tpu_torch.parallel.ep_model import KV_EXCHANGES
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss
    device = torch.device(device)
    mesh = make_mesh()
    model = seed0_model(mcfg, device)
    leaves = list(model.parameters())
    # one launch of each kernel per conv on the card; the plain versions
    # on the CPU launch and count nothing
    L = mcfg.conv_layers if device.type == "cuda" else 0
    width = 2 * mcfg.in_channels + mcfg.sbf_dim * mcfg.rbf_dim
    out, first = {}, None
    for name, hb in batches.items():
        tag = f"EP {world} ranks, {name}"
        epb = make_ep_batch(hb, world)
        local = shard_ep_batch(epb, mesh, device)
        if first is None:
            first = local
        one = dataclasses.replace(hb, tiers=(), n_hi=0, d_lo=0).to(device)
        with torch.no_grad():
            ref_pred = model(one)
        _, ref = plain_grads(model, one)
        got, rec = {}, {}
        for mode in KV_EXCHANGES:
            mtag = f"{tag}, {mode}"
            reset_launch_counts()
            pred = make_ep_forward(mesh, mode)(model, local)
            loss = smooth_l1_loss(pred, local.y, mask=local.graph_mask)
            flat, gloss, _ = reduced_gradients(loss, leaves,
                                               local.graph_mask.sum())
            sync(device)
            counts = launch_counts()
            pred = pred.detach()
            got[mode] = (pred, flat, gloss)
            rec[f"pred_err_{mode}"] = mc_agree(
                f"{mtag}: predictions", lambda: pred_gate(mtag, pred,
                                                          ref_pred))
            rec[f"worst_{mode}"] = mc_agree(
                f"{mtag}: gradients", lambda: held_grads(
                    mtag, split_grads(flat, model), ref))
            mc_agree(f"{mtag}: launches",
                     lambda: launches_gate(mtag, counts, L))
            rec["launches"] = counts
        mc_agree(f"{tag}: exchanges",
                 lambda: ring_gate(tag, got["ring"], got["allgather"]))
        Nl, D = local.in_mask.shape
        rec.update(N=int(epb.numbers.shape[0]), Nl=int(Nl), D=int(D),
                   valid_pairs=piece_valid_pairs(epb.shard(rank, world)))
        args = first_ep_window(model, local, mesh)
        rec["window"] = list(args[0].shape[:2]) + [int(args[1].shape[1])]
        if device.type == "cuda":
            fwd, (bwd, red) = mc_agree(
                f"{tag}: the window's kernels", lambda: check_window(
                    f"EP rank {rank} {name}", args, mcfg, seed=50 + rank,
                    fwd_timed=True, bwd_timed=True))
            rec.update(fwd=fwd, bwd=bwd, reduce=red)
        rec["exchange_ms"] = {m: exchange_ms(local, mesh, m, width, reps)
                              for m in KV_EXCHANGES}
        pairs = gather_objects(rec["valid_pairs"])
        log(f"[multi-card (c)] {tag}: N={rec['N']}, {Nl} rows and D={D} "
            f"here, valid pairs per rank {pairs}; predictions within "
            f"{rec['pred_err_ring']:.3e} of the blocked model, gradients "
            f"{rec['worst_ring']:.3e} of max|g|, ring = allgather bitwise, "
            f"launches {rec['launches']}; row exchange "
            + ", ".join(f"{m} {v:.4f} ms" for m, v in
                        rec["exchange_ms"].items()) + " per conv")
        out[name] = rec
    # one EP training step per exchange on the first batch
    local = first
    start = [p.detach().clone() for p in leaves]
    steps = {}
    for mode in KV_EXCHANGES:
        restore_params(leaves, start)
        opt, state = fresh_state(model, tcfg)
        step = make_ep_train_step(model, opt, tcfg.ema_decay, mesh, mode,
                                  tcfg.random_seed)
        reset_launch_counts()
        state, loss, _ = step(state, local)
        sync(device)
        counts = launch_counts()
        mc_agree(f"EP step ({mode}): launches",
                 lambda: launches_gate(f"EP step ({mode})", counts, L))
        digest = params_digest(leaves)
        same_bits(f"EP step ({mode}): the parameters",
                  gather_objects(digest))
        steps[mode] = {"loss": float(loss), "digest": digest,
                       "launches": counts, "bad_steps": int(state.bad_steps)}
    restore_params(leaves, start)

    def step_gate():
        if steps["ring"]["digest"] != steps["allgather"]["digest"]:
            raise AssertionError("EP step: ring and allgather parameters "
                                 "differ")
        if any(s["bad_steps"] for s in steps.values()):
            raise AssertionError(f"EP step skipped: {steps}")

    mc_agree("EP step", step_gate)
    log(f"[multi-card (c)] one EP step per exchange: loss "
        f"{steps['ring']['loss']!r}, parameters the same bits on every "
        f"rank and in both exchanges, launches {steps['ring']['launches']}")
    out["steps"] = steps
    return out


def mc_hybrid(rank, world, device, mcfg, tcfg, hosts):
    """(d) DP x EP on a (2, world / 2) layout: row i splits host batch
    `hosts[i]` over its ranks. For each exchange the reduced gradient and
    loss against the plain step over the two batches (`group_grads`),
    ring bitwise the allgather, one launch of each kernel per conv; one
    hybrid training step per exchange, the parameters the same bits on
    every rank and in both exchanges."""
    import torch
    from x2gnn_tpu_torch.ops.blocked_attn import reset_launch_counts
    from x2gnn_tpu_torch.parallel import (
        make_ep_batch, make_hybrid_forward, make_hybrid_mesh,
        make_hybrid_train_step, shard_hybrid_batch, stack_ep_batches)
    from x2gnn_tpu_torch.parallel.data_parallel import reduced_gradients
    from x2gnn_tpu_torch.parallel.ep_model import KV_EXCHANGES
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss
    device = torch.device(device)
    dp, ep = 2, world // 2
    mesh = make_hybrid_mesh(dp, ep)
    rows = hosts[:dp]
    local = shard_hybrid_batch(stack_ep_batches(
        [make_ep_batch(b, ep) for b in rows]), mesh, device)
    model = seed0_model(mcfg, device)
    leaves = list(model.parameters())
    start = [p.detach().clone() for p in leaves]
    L = mcfg.conv_layers if device.type == "cuda" else 0
    want, ref = group_grads(model, rows, device)
    got, rec = {}, {"plain_loss": want}
    for mode in KV_EXCHANGES:
        tag = f"DP x EP {dp} x {ep}, {mode}"
        reset_launch_counts()
        pred = make_hybrid_forward(mesh, mode)(model, local)
        loss = smooth_l1_loss(pred, local.y, mask=local.graph_mask)
        flat, gloss, total = reduced_gradients(loss, leaves,
                                               local.graph_mask.sum())
        sync(device)
        counts = launch_counts()
        got[mode] = (pred.detach(), flat, gloss)
        rec[f"worst_{mode}"] = mc_agree(
            f"{tag}: gradients",
            lambda: held_grads(tag, split_grads(flat, model), ref))
        mc_agree(f"{tag}: loss", lambda: loss_gate(tag, float(gloss), want))
        mc_agree(f"{tag}: launches", lambda: launches_gate(tag, counts, L))
        rec.update(loss=float(gloss), graphs=float(total) / ep,
                   launches=counts)
    mc_agree("DP x EP: exchanges", lambda: ring_gate(
        "DP x EP", got["ring"], got["allgather"]))
    digests = {}
    for mode in KV_EXCHANGES:
        restore_params(leaves, start)
        opt, state = fresh_state(model, tcfg)
        step = make_hybrid_train_step(model, opt, tcfg.ema_decay, mesh, mode,
                                      tcfg.random_seed)
        state, _, _ = step(state, local)
        digests[mode] = params_digest(leaves)
        same_bits(f"DP x EP step ({mode}): the parameters",
                  gather_objects(digests[mode]))
        if int(state.bad_steps):    # replicated: every rank raises
            raise AssertionError(f"DP x EP step ({mode}) skipped")
    restore_params(leaves, start)
    same_bits("DP x EP step: ring against allgather",
              list(digests.values()))
    log(f"[multi-card (d)] DP x EP {dp} x {ep}: {rec['graphs']:.0f} real "
        f"graphs, loss {rec['loss']!r} (plain {want!r}), gradients "
        f"{rec['worst_ring']:.3e} of max|g|, ring = allgather bitwise, "
        f"launches {rec['launches']}; one step per exchange, the parameters "
        "the same bits on every rank and in both exchanges")
    return rec


def mc_turns(rank, world, device, mcfg, tcfg, hosts, reps):
    """(f): ms per training step on this rank, median of `reps`, in turns
    (each path, then each again in reverse order): the plain single-device
    step on this rank's batch `hosts[rank]`, DP with that batch as its
    member of the group `hosts[:world]`, EP on `hosts[0]` and DP x EP (2 x
    world / 2) on `hosts[:2]`, each with both exchanges."""
    import torch
    from x2gnn_tpu_torch.parallel import (
        make_dp_train_step, make_ep_batch, make_ep_train_step,
        make_hybrid_mesh, make_hybrid_train_step, make_mesh, shard_ep_batch,
        shard_hybrid_batch, stack_ep_batches)
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss
    from x2gnn_tpu_torch.train.optim import apply_update_skip_nonfinite
    device = torch.device(device)
    model = seed0_model(mcfg, device)
    leaves = list(model.parameters())
    mesh = make_mesh()
    hmesh = make_hybrid_mesh(2, world // 2)
    mine = hosts[rank].to(device)
    ep_local = shard_ep_batch(make_ep_batch(hosts[0], world), mesh, device)
    hy_local = shard_hybrid_batch(stack_ep_batches(
        [make_ep_batch(b, world // 2) for b in hosts[:2]]), hmesh, device)
    opt, _ = fresh_state(model, tcfg)

    def plain_step(state, batch):
        loss = smooth_l1_loss(model(batch), batch.y, mask=batch.graph_mask)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return apply_update_skip_nonfinite(state, loss.detach(), list(grads),
                                           opt, tcfg.ema_decay)

    ema = tcfg.ema_decay
    paths = {
        "plain": (plain_step, mine),
        "dp": (make_dp_train_step(model, opt, ema, mesh), mine),
        "ep allgather": (make_ep_train_step(model, opt, ema, mesh,
                                            "allgather"), ep_local),
        "ep ring": (make_ep_train_step(model, opt, ema, mesh, "ring"),
                    ep_local),
        "dp x ep allgather": (make_hybrid_train_step(
            model, opt, ema, hmesh, "allgather"), hy_local),
        "dp x ep ring": (make_hybrid_train_step(model, opt, ema, hmesh,
                                                "ring"), hy_local)}
    states = {name: fresh_state(model, tcfg)[1] for name in paths}
    turns = {}
    for name in list(paths) + list(paths)[::-1]:
        step, batch = paths[name]

        def one():
            states[name] = step(states[name], batch)[0]

        turns.setdefault(name, []).append(timed_ms(one, device, reps))
    log(f"[multi-card (f)] rank {rank}: ms per step (median of {reps}), in "
        "turns: " + "; ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}"
                              for k, v in turns.items()))
    return turns


def mc_rank_phases(rank, world, device, note):
    """What each rank runs in the mode: (a), then (b)-(d) and (f) on the
    flagship at full width with the seed-0 weights, over phase 6's packed
    batches (512 molecules, mean_atoms=18, seed=11: N=744, D=32, 8 tiers)
    and, for EP, an AID-scale batch of 32 molecules (mean_atoms=64,
    seed=3; D > 40). `note(phase)` records each phase."""
    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    from x2gnn_tpu_torch.profile_training import flagship_training_configs
    mcfg, tcfg = flagship_training_configs()
    out = {}
    note("(a) placement")
    out["placement"] = mc_placement(rank, world, device)
    note("planning the batches")
    hosts = mc_packed_hosts(mcfg, tcfg, synthetic_dataset(
        512, mean_atoms=18, seed=11), 10)
    aid = whole_batch(synthetic_dataset(32, mean_atoms=64, seed=3))
    if aid.in_edges.shape[1] <= 40:
        raise AssertionError(f"the AID-scale batch {aid.in_edges.shape} is "
                             "not D > 40")
    note("(b) DP")
    out["dp"] = mc_dp(rank, world, device, mcfg, tcfg, hosts)
    note("(c) EP")
    out["ep"] = mc_ep(rank, world, device, mcfg, tcfg,
                      {"flagship": hosts[0], "AID": aid}, MC_REPS)
    note("(d) DP x EP")
    out["hybrid"] = mc_hybrid(rank, world, device, mcfg, tcfg, hosts)
    note("(f) step times")
    clocks = ["nvidia-smi", "--query-gpu=index,clocks.sm,power.draw,"
              "temperature.gpu", "--format=csv,noheader"]
    if rank == 0 and device.type == "cuda":
        log(f"[multi-card (f)] before the turns: {_host_lines(clocks)}")
    out["turns"] = mc_turns(rank, world, device, mcfg, tcfg, hosts, MC_REPS)
    if rank == 0 and device.type == "cuda":
        log(f"[multi-card (f)] after the turns: {_host_lines(clocks)}")
    note("done")
    return out


def mc_rank_main(run_dir):
    """One rank of the mode under torch.distributed.run: joins through the
    port's initialize_distributed (NCCL on the card of LOCAL_RANK), runs
    `mc_rank_phases`, and writes rank<r>.json and its log rank<r>.log
    into `run_dir`."""
    import torch.distributed as dist
    from x2gnn_tpu_torch.parallel import initialize_distributed
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    # NCCL's account of its transports and topology, into the rank's
    # standard output (`nccl_transports` reads it)
    os.environ.setdefault("NCCL_DEBUG", "INFO")
    os.environ.setdefault("NCCL_DEBUG_SUBSYS", "INIT,GRAPH")
    with open(os.path.join(run_dir, f"rank{rank}.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        mc_note(run_dir, rank, "joining the process group")
        device = initialize_distributed()
        try:
            out = mc_rank_phases(rank, world, device,
                                 lambda p: mc_note(run_dir, rank, p))
        finally:
            dist.destroy_process_group()
    with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def mc_kernel_rows(results):
    """The kernels line's rows of each rank's first EP window of each
    batch: the forward, the backward and its reduce, checked and timed on
    that rank's card, with the launches of one EP step there."""
    src = "x2gnn_tpu_torch/ops/csrc/"
    rows = []
    world = len(results)
    for r, res in enumerate(results):
        for name, rec in res["ep"].items():
            if name == "steps":
                continue
            ichunk = rec["D"] > 40
            note = (f"rank {r} of {world}: conv 0's window "
                    f"{tuple(rec['window'])} of the {name} batch "
                    f"(N={rec['N']}), {rec['valid_pairs']} valid pairs")
            for kernel, file, line, key in (
                    ("blocked_attn_fwd", "blocked_attn_fwd.cu",
                     282 if ichunk else 166, "fwd"),
                    ("blocked_attn_bwd", "blocked_attn_bwd.cu",
                     346 if ichunk else 198, "bwd"),
                    ("blocked_attn_bwd_reduce", "blocked_attn_bwd.cu", 271,
                     "reduce")):
                rows.append({"name": f"{kernel} (EP rank {r}/{world}, "
                                     f"{name})",
                             "route": "cuda", "source": src + file,
                             "replaces": f"{PALLAS}:{line}",
                             "launches": rec["launches"][key],
                             "window": note, **rec[key]})
    return rows


def mc_report(results, card):
    """The rank group's results, as lines: (a) every rank's card, (b) each
    DP step, (c) the EP batches' rows, valid pairs and the row exchange's
    ms per conv on every rank, (d), (f) the step times in turns. The
    kernels' numbers are the kernels line's."""
    world = len(results)
    for r in results[0]["placement"]:
        log(f"[{card}] (a) rank {r['rank']} on cuda:{r['index']} "
            f"(LOCAL_RANK {r['local_rank']}), {r['uuid']}, {r['backend']}")
    for i, step in enumerate(results[0]["dp"]["steps"]):
        here = [res["dp"]["steps"][i]["graphs_here"] for res in results]
        log(f"[{card}] (b) DP step {i + 1}: {step['graphs']} graphs, per "
            f"rank {here}, loss {step['loss']!r} (plain "
            f"{step['plain_loss']!r}), largest max|err|/max|g| "
            f"{step['worst']:.3e}")
    for name in results[0]["ep"]:
        if name == "steps":
            continue
        recs = [res["ep"][name] for res in results]
        log(f"[{card}] (c) EP {name}: rows per rank "
            f"{[r['Nl'] for r in recs]}, D={recs[0]['D']}, valid pairs per "
            f"rank {[r['valid_pairs'] for r in recs]}, predictions within "
            f"{max(r['pred_err_ring'] for r in recs):.3e}, gradients "
            f"{recs[0]['worst_ring']:.3e} of max|g|")
        for mode in ("allgather", "ring"):
            log(f"[{card}] (f) row exchange ({mode}) of the {name} batch, "
                f"ms per conv on ranks 0-{world - 1}: "
                + ", ".join(f"{r['exchange_ms'][mode]:.4f}" for r in recs))
    hy = results[0]["hybrid"]
    log(f"[{card}] (d) DP x EP: loss {hy['loss']!r} (plain "
        f"{hy['plain_loss']!r}), gradients {hy['worst_ring']:.3e} of "
        "max|g|")
    for name in results[0]["turns"]:
        per = [res["turns"][name] for res in results]
        log(f"[{card}] (f) {name}: ms per step on ranks 0-{world - 1}, two "
            "turns each: " + "; ".join(f"{a:.3f} / {b:.3f}"
                                       for a, b in per))


def plan_batches(config, n):
    """The packed batches of the train split that the training CLI plans
    for `--config config --synthetic n` (host arithmetic)."""
    import numpy as np
    from x2gnn_tpu_torch.config import load_configs
    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.train.trainer import Trainer
    mcfg, tcfg = load_configs(config)
    graphs = synthetic_dataset(n, cutoff=mcfg.cutoff,
                               edge_feat_dim=mcfg.edge_feat_dim)
    targets = np.array([g.y[0] for g in graphs], np.float32)
    t = Trainer(X2GNN(mcfg, device="cpu"), mcfg, tcfg, graphs, targets,
                workdir="unused", device="cpu")
    return graphs, t.val_idx, len(t._plan_of(t.train_idx))


def cli_gate(tag, workdir, stdout, stderr, epochs, steps_per_epoch, mode):
    """(e) a training CLI run over the ranks: `epochs` metrics records
    numbered 1.. with finite losses, no skipped step and the step count
    the plan gives; rank 0 alone wrote (one record and one train.log line
    per epoch, one summary line, `mode` announced once). Returns the
    records."""
    import numpy as np
    records = read_records(workdir)
    with open(os.path.join(workdir, "train.log")) as f:
        log_lines = f.read().splitlines()
    summaries = [line for line in stdout.splitlines()
                 if line.startswith("{")]
    faults = []
    if [r["epoch"] for r in records] != list(range(1, epochs + 1)):
        faults.append(f"epochs {[r['epoch'] for r in records]}")
    if len(log_lines) != epochs or len(summaries) != 1 \
            or stderr.count(mode) != 1:
        faults.append(f"{len(log_lines)} train.log lines, {len(summaries)} "
                      f"summaries, {stderr.count(mode)} x {mode!r}: not rank "
                      "0 alone")
    for r in records:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["val_mae"])) \
                or r["bad_steps"] != 0:
            faults.append(f"epoch {r['epoch']}: loss {r['loss']}, bad_steps "
                          f"{r['bad_steps']}")
        if r["step"] != r["epoch"] * steps_per_epoch:
            faults.append(f"epoch {r['epoch']}: step {r['step']}, the plan "
                          f"gives {r['epoch'] * steps_per_epoch}")
    if faults:
        raise AssertionError(f"{tag}: {faults}")
    for r in records:
        log(f"[{tag}] epoch {r['epoch']}: loss {r['loss']!r} val_mae "
            f"{r['val_mae']!r} best {r['best_val_mae']!r} step {r['step']} "
            f"{r['seconds']:.2f} s, {r['molecules_per_sec']:.1f} molecules/s")
    return records


def checkpoint_diffs(a, b):
    """The leaves of two checkpoint files that differ, bitwise."""
    from x2gnn_tpu_torch.train.checkpoint import restore_checkpoint
    from x2gnn_tpu_torch.utils.determinism import tree_bitwise_diff

    def kept(t):
        if isinstance(t, dict):
            return {k: kept(v) for k, v in t.items() if v is not None}
        return t

    return tree_bitwise_diff(kept(restore_checkpoint(a)),
                             kept(restore_checkpoint(b)))


def mc_entry_points(work, device, left, config=FLAGSHIP_ARGS, n=MC_CLI_N,
                    extra=()):
    """(e) the training CLI under torch.distributed.run on MC_RANKS ranks:
    `--config config --synthetic n` for 2 epochs with --data-parallel; 1
    epoch, then --resume its ckpt_last.pt to 2, which must give the 2-epoch
    run's records (but the wall clock's) and its last checkpoint bitwise;
    1 epoch with --edge-partition ring --dp-groups 2. Each run by
    `cli_gate`; Predictor.from_run of the 2-epoch run on `device`
    reproduces rank 0's logged best val MAE (its ckpt_best's) on the val
    molecules within MC_MAE_RTOL. `left(limit)`: the seconds a launch may
    take; `extra`: more CLI flags (--device cpu in a rehearsal)."""
    import numpy as np
    from x2gnn_tpu_torch.infer import Predictor
    graphs, val_idx, n_batches = plan_batches(config, n)
    dp_spe = math.ceil(n_batches / MC_RANKS)
    hy_spe = math.ceil(n_batches / 2)
    base = ["-m", "x2gnn_tpu_torch.train", "--config", config,
            "--synthetic", str(n), *extra]
    backend = "nccl" if device.type == "cuda" else "gloo"
    dp_mode = f"data parallel over {MC_RANKS} ranks ({backend})"
    hy_mode = (f"hybrid DP x EP (2 groups x {MC_RANKS // 2}-way ring) over "
               f"{MC_RANKS} ranks ({backend})")
    straight, dp1, hy = (os.path.join(work, d)
                         for d in ("dp2", "dp1", "dpxep1"))
    runs = {}
    for tag, wd, flags, epochs, spe, mode in (
            ("dp 2 epochs", straight, ["--epochs", "2", "--data-parallel"],
             2, dp_spe, dp_mode),
            ("dp 1 epoch", dp1, ["--epochs", "1", "--data-parallel"], 1,
             dp_spe, dp_mode),
            ("dp 1 + 1 epochs", dp1, [
                "--epochs", "2", "--data-parallel", "--resume",
                os.path.join(dp1, "ckpt_last.pt")], 2, dp_spe, dp_mode),
            ("dp x ep 1 epoch", hy, ["--epochs", "1", "--edge-partition",
                                     "ring", "--dp-groups", "2"], 1, hy_spe,
             hy_mode)):
        stdout, stderr, secs = mc_launch(
            mc_torchrun(base + flags + ["--workdir", wd]), f"(e) {tag}",
            left(MC_CLI_S), os.path.join(work, tag.replace(" ", "_")))
        log(f"[(e) {tag}] {MC_RANKS} ranks: {secs:.1f} s")
        runs[tag] = cli_gate(f"(e) {tag}", wd, stdout, stderr, epochs, spe,
                             mode)
    straight = os.path.join(work, "dp2")
    diffs = (resumed_record_diffs(runs["dp 2 epochs"],
                                  runs["dp 1 + 1 epochs"], 1)
             + checkpoint_diffs(os.path.join(straight, "ckpt_last.pt"),
                                os.path.join(dp1, "ckpt_last.pt")))
    log(f"[(e) resume] 1 + 1 epochs on {MC_RANKS} ranks against 2 straight: "
        f"differences {json.dumps(diffs)}")
    if diffs:
        raise AssertionError("(e) resume: the resumed run differs")
    pred = Predictor.from_run(straight, device=device)
    val = [graphs[i] for i in val_idx]
    got = pred.predict(val)
    targets = np.array([g.y[0] for g in val], np.float64)
    mae = float(np.abs(got - targets).mean())
    want = runs["dp 2 epochs"][-1]["best_val_mae"]
    rel = abs(mae - want) / abs(want)
    log(f"[(e) from_run] the {MC_RANKS}-rank run's checkpoint on one "
        f"device: val MAE {mae!r} over {len(val)} molecules against rank 0's "
        f"logged {want!r}: relative {rel:.3e} (limit {MC_MAE_RTOL})")
    if not rel <= MC_MAE_RTOL:
        raise AssertionError("(e) from_run: the val MAE differs")
    for wd in (straight, dp1, hy):       # the records and logs stay
        for name in os.listdir(wd):
            if name.endswith(".pt"):
                os.remove(os.path.join(wd, name))
    return {"steps_per_epoch": {"dp": dp_spe, "dp x ep": hy_spe},
            "from_run_rel": rel}


def mc_bench_scaling(work, left, extra=()):
    """(f) `scripts.bench_scaling` on MC_RANKS ranks: its single, dp, ep
    and hybrid lines."""
    stdout, _, secs = mc_launch(
        mc_torchrun(["-m", "x2gnn_tpu_torch.scripts.bench_scaling", *extra]),
        "(f) bench_scaling", left(MC_BENCH_S),
        os.path.join(work, "bench_scaling"))
    lines = [json.loads(line) for line in stdout.splitlines()
             if line.startswith("{")]
    modes = [r["mode"] for r in lines]
    if modes != ["single", "dp", "ep", "hybrid"] or any(
            r["n_devices"] != (1 if r["mode"] == "single" else MC_RANKS)
            for r in lines):
        raise AssertionError(f"(f) bench_scaling: lines {lines}")
    for r in lines:
        log(f"[(f) bench_scaling] {json.dumps(r)}")
    log(f"[(f) bench_scaling] {secs:.1f} s")
    return lines


def nvlink_summary():
    """Per card, from `nvidia-smi nvlink --status`: its links and their
    speeds (what the command printed, if it printed no link)."""
    lines = _host_lines(["nvidia-smi", "nvlink", "--status"])
    cards = []
    for line in lines:
        if line.startswith("GPU"):
            cards.append((line.split(":")[0], []))
        elif line.strip().startswith("Link") and cards:
            cards[-1][1].append(line.split(":", 1)[1].strip())
    if not cards:
        return lines[:3]
    return [f"{gpu}: {len(links)} links, {sorted(set(links))}"
            for gpu, links in cards]


def nccl_transports(path):
    """NCCL's own account of how it connects the ranks (NCCL_DEBUG=INFO,
    subsystems INIT and GRAPH, in the ranks' standard output): the
    distinct lines naming a transport or a topology search's result."""
    keys = ("via P2P", "via SHM", "via NET", "NVLS", "Pattern", "NVL",
            "nvlink", "NCCL version")
    seen = []
    with open(path, errors="replace") as f:
        for line in f:
            if "NCCL INFO" not in line:
                continue
            text = line.split("NCCL INFO", 1)[1].strip()
            if any(k in text for k in keys) and text not in seen:
                seen.append(text)
    return seen[:24]


class _Tee:
    """A text stream that writes to each of `streams`."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def multi_card(deadline_s=MC_DEADLINE_S):
    """The --multi-card mode on MC_RANKS cards of this host: the kernels
    built once; the cards and their topology logged; (a)-(d) and (f)'s
    step times in one torch.distributed.run rank group
    (`mc_rank_phases`); (e) the training CLI and (f) bench_scaling under
    torch.distributed.run. Each launch has a deadline of its own within
    `deadline_s`. What it prints also goes to MC_OUT/mode.log, beside
    each rank's log and results and the kernel rows in full
    (kernels.json). Returns the kernels line's rows."""
    t_start = time.perf_counter()
    shutil.rmtree(MC_OUT, ignore_errors=True)
    os.makedirs(MC_OUT)
    with open(os.path.join(MC_OUT, "mode.log"), "w") as f, \
            contextlib.redirect_stdout(_Tee(sys.stdout, f)):
        rows = _multi_card(t_start + deadline_s)
        log(f"[multi-card] done in {time.perf_counter() - t_start:.1f} s")
    with open(os.path.join(MC_OUT, "kernels.json"), "w") as f:
        json.dump(rows, f, indent=1)
    keep = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "window")
    return [{k: row[k] for k in keep} for row in rows]


def _multi_card(deadline):
    import torch
    from x2gnn_tpu_torch.ops import _build

    def left(limit):
        return min(limit, deadline - time.perf_counter())

    card = _host_lines(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"])[0]
    print(card, flush=True)
    for line in _host_lines(["nvidia-smi", "--query-gpu=index,name,"
                             "power.limit,uuid", "--format=csv,noheader"]):
        log(f"[multi-card] {line}")
    for line in _host_lines(["nvidia-smi", "topo", "-m"]):
        log(f"[multi-card] topo: {line}")
    for line in nvlink_summary():
        log(f"[multi-card] nvlink: {line}")
    n = torch.cuda.device_count()
    peers = [[int(i == j or torch.cuda.can_device_access_peer(i, j))
              for j in range(n)] for i in range(n)]
    log(f"[multi-card] peer access (torch.cuda.can_device_access_peer): "
        f"{peers}")
    log(f"[multi-card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"nccl {torch.cuda.nccl.version()} python "
        f"{sys.version.split()[0]}; {torch.cuda.device_count()} cards, "
        f"{len(os.sched_getaffinity(0))} host cores")
    for name, built in _build.build_all().items():
        log(f"[multi-card] kernel {name}: {built.seconds:.2f} s nvcc, once, "
            "before any rank starts")
    ok = False
    try:
        _, _, secs = mc_launch(
            mc_torchrun([os.path.join(REPO, "chip_smoke.py"),
                         "--multi-card-rank", MC_OUT]),
            "the rank group of (a)-(d), (f)", left(MC_RANKS_S),
            os.path.join(MC_OUT, "ranks"), run_dir=MC_OUT)
        ok = True
    finally:
        # rank 0's summary lines; every rank's end after a failure
        for r in range(1 if ok else MC_RANKS):
            path = os.path.join(MC_OUT, f"rank{r}.log")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                lines = f.read().splitlines()
            shown = ([line for line in lines
                      if line.startswith("[multi-card")] if ok
                     else lines[-40:])
            for line in shown:
                log(f"[rank {r}] {line}")
    log(f"[multi-card] the rank group: {secs:.1f} s; each rank's log in "
        f"{os.path.relpath(MC_OUT, REPO)}/")
    for line in nccl_transports(os.path.join(MC_OUT, "ranks.out")):
        log(f"[multi-card] NCCL: {line}")
    results = []
    for r in range(MC_RANKS):
        with open(os.path.join(MC_OUT, f"rank{r}.json")) as f:
            results.append(json.load(f))
    mc_report(results, card)
    work = os.path.join(MC_OUT, "cli")
    os.makedirs(work)
    mc_entry_points(work, torch.device("cuda", 0), left)
    mc_bench_scaling(MC_OUT, left)
    return mc_kernel_rows(results)


def parse_args(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--a12-full", action="store_true",
                   help="run only A12 at full scale: the flagship recipe on "
                        "the whole A12 set, held to the JAX runs")
    p.add_argument("--gap-full", action="store_true",
                   help="run only the gap recipe at full scale: "
                        "runs/gap_r5_50k/args.json on the whole A12 set, "
                        "held to the two JAX gap runs")
    p.add_argument("--deadline-s", type=float, default=A12_DEADLINE_S,
                   help="--a12-full, --gap-full: stop training when its "
                        "next epoch would end past this many seconds from "
                        "the start")
    p.add_argument("--n", type=int, default=A12_N,
                   help="--a12-full, --gap-full: molecules to build; any "
                        "other count than the A12 set's tries the "
                        "mechanics only")
    p.add_argument("--multi-card", action="store_true",
                   help=f"run only the parallel paths on {MC_RANKS} cards "
                        "of this host over NCCL")
    p.add_argument("--multi-card-rank", metavar="DIR", default=None,
                   help="(the --multi-card mode's rank entry point under "
                        "torch.distributed.run; writes into DIR)")
    return p.parse_args(argv)


def ok_line():
    import torch
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    if args.multi_card_rank:
        mc_rank_main(args.multi_card_rank)
        return 0
    if args.multi_card:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < MC_RANKS:
            print(f"chip_smoke --multi-card: {n} CUDA devices; the mode "
                  f"runs on {MC_RANKS} cards of one host and nowhere else",
                  file=sys.stderr)
            return 1
        print(json.dumps({"kernels": multi_card()}), flush=True)
        print(ok_line(), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke test runs only on the "
              "card", file=sys.stderr)
        return 1
    if args.a12_full:
        if a12_full(args.n, args.deadline_s):
            print(ok_line(), flush=True)
        return 0
    if args.gap_full:
        full, rows = gap_full(args.n, args.deadline_s)
        print(json.dumps({"kernels": rows}), flush=True)
        if full:
            print(ok_line(), flush=True)
        return 0

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
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = resolve_device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- 2. build ----
    log(f"[phase 2] starts at {time.perf_counter() - t_start:.1f} s")
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
    log(f"[phase 3] starts at {time.perf_counter() - t_start:.1f} s")
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
    log(f"[phase 4] starts at {time.perf_counter() - t_start:.1f} s")
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
    log(f"[phase 5] starts at {time.perf_counter() - t_start:.1f} s")
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        pred.predict(qm9)
    dt = (time.perf_counter() - t0) / iters
    serving_rate = len(qm9) / dt
    log(f"[serve] throughput {serving_rate:.1f} molecules/s "
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
    log(f"[phase 6] starts at {time.perf_counter() - t_start:.1f} s")
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
    # the same batch as one window, the alternative the tiers replace:
    # logged beside the tiers; the EP path at world size 1 launches it
    # (phase 13 gives these records its launches)
    packed_one_fwd, (packed_one_bwd, packed_one_red) = check_window(
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
    # the mask and alpha instances at that width (phase 9a's checks): the
    # pair arrays indexed across 8 channel groups of 16 heads
    check_masked_window("train HC=1024", window_args(
        wide_args, (0, 128, n_slots, n_slots)), cfg_wide, seed=33,
        timed=False)
    del wide_args
    # every other head width the kernel takes, on the same batch: C = 1, 2
    # (scalar scores), 4, 16, 32 (16-byte loads), beside the flagship's 8
    for heads in (128, 64, 32, 8, 4):
        cfg_c = dataclasses.replace(mcfg, heads=heads)
        check_fwd_kernel(f"train C={mcfg.in_channels // heads}",
                         batch_kernel_inputs(train_batch, cfg_c, seed=32),
                         cfg_c, timed=False)

    # ---- 7. training times ----
    log(f"[phase 7] starts at {time.perf_counter() - t_start:.1f} s")
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

    # ---- 8. determinism, resume, caches, the CLIs, from_run, .pth ----
    log(f"[phase 8] starts at {time.perf_counter() - t_start:.1f} s")
    check_step_determinism(mcfg, tcfg, train_graphs, qm9, device, card)
    spe = check_resume(mcfg, tcfg, train_graphs, device, card,
                       packed_records)
    kept = tempfile.TemporaryDirectory()    # 8c's run, for phase 12c
    check_run_io(mcfg, train_graphs, qm9, device, card, spe, keep=kept.name)

    # ---- 9. the gap recipe: molwise readout, attention dropout ----
    log(f"[phase 9] starts at {time.perf_counter() - t_start:.1f} s")
    gap_rows, _ = gap_recipe(card, device, train_graphs, aid, packed, pstate,
                             packed_records)

    # ---- 10. bf16 storage, feature dtypes, remat, accumulation ----
    log(f"[phase 10] starts at {time.perf_counter() - t_start:.1f} s")
    bf16_rows = bf16_recipe(card, device, train_graphs, aid, qm9, packed,
                            pstate, pred, train_batch)
    log(f"[phase 10] done at {time.perf_counter() - t_start:.1f} s")

    # ---- 11. the host data pipeline and the profiling hooks ----
    log(f"[phase 11] starts at {time.perf_counter() - t_start:.1f} s")
    data_rows = data_pipeline(card, device)
    log(f"[phase 11] done at {time.perf_counter() - t_start:.1f} s")

    # ---- 12. v2 and the beta gate; the segment and padded layouts ----
    t12 = time.perf_counter()
    log(f"[phase 12] starts at {t12 - t_start:.1f} s")
    v2_beta_blocked(card, device, qm9, train_graphs, mcfg, tcfg, pred,
                    packed, pstate)
    log(f"[phase 12a] done at {time.perf_counter() - t_start:.1f} s")
    flat_layouts(card, device, qm9, train_graphs, mcfg, tcfg, model, pred,
                 packed, pstate)
    log(f"[phase 12b, d, e] done at {time.perf_counter() - t_start:.1f} s")
    layout_clis(card, device, train_graphs, kept.name)
    kept.cleanup()
    log(f"[phase 12] took {time.perf_counter() - t12:.1f} s; done at "
        f"{time.perf_counter() - t_start:.1f} s")

    # ---- 13. the parallel paths: DP, EP, DP x EP ----
    log(f"[phase 13] starts at {time.perf_counter() - t_start:.1f} s")
    parallel_rows = parallel_paths(
        card, device, train_graphs, mcfg, tcfg, packed,
        (packed_one_fwd, packed_one_bwd, packed_one_red))
    log(f"[phase 13] done at {time.perf_counter() - t_start:.1f} s")

    # ---- 14. per-layer dumps, card against CPU, at full width ----
    log(f"[phase 14] starts at {time.perf_counter() - t_start:.1f} s")
    dumped = parity_dumps(cfg, device, qm9, packed)

    # ---- 15. the A12 cut's training curve against the JAX Trainer ----
    log(f"[phase 15] starts at {time.perf_counter() - t_start:.1f} s")
    _, _, curve_rows = training_curve(device)
    log(f"[phase 15] done at {time.perf_counter() - t_start:.1f} s")

    # ---- 16. the evaluation and measurement scripts ----
    log(f"[phase 16] starts at {time.perf_counter() - t_start:.1f} s")
    script_rows = measurement_scripts(card, device, serving_rate,
                                      packed_records, fixed_records)
    log(f"[phase 16] done at {time.perf_counter() - t_start:.1f} s")

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
    # phase 14's dumps launch the forward at the serving shape (phase 3's
    # record) and at the packed batch's tiers (phase 6's records)
    (serving_batch, serving_shapes), (_, packed_dump_shapes) = \
        dumped.values()
    kernels.append(
        {"name": "blocked_attn_fwd (per-layer dump, serving batch)",
         "route": "cuda", "source": fwd_src, "replaces": f"{PALLAS}:166",
         "launches": serving_shapes["fwd"].get(
             window_shape(windows_of(serving_batch)[0]), 0),
         "window": "phase 14's card dump of the first serving batch, "
                   "phase 3's record", **records["serving"]})
    for t, (win, fwd, _, _) in enumerate(tiers):
        kernels.append(
            {"name": f"blocked_attn_fwd (per-layer dump, packed tier {t})",
             "route": "cuda", "source": fwd_src,
             "replaces": f"{PALLAS}:{282 if win[3] > 40 else 166}",
             "launches": packed_dump_shapes["fwd"].get(window_shape(win), 0),
             "window": f"phase 14's card dump of the first packed batch, "
                       f"tier {win}, phase 6's record", **fwd})
    kernels += (gap_rows + bf16_rows + data_rows + parallel_rows + curve_rows
                + script_rows)
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise AssertionError(f"rows not launched on their path: {idle}")
    log(f"[chip_smoke] every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(ok_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
