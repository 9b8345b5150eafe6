#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port: builds the port's CUDA
kernels, holds each against its plain PyTorch version on the card, serves
the flagship X2GNN through the port's Predictor and times it.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. card: name and power limit from nvidia-smi; no CUDA device -> exit 1;
  2. build: nvcc for sm_90a from the sources under x2gnn_tpu_torch/ops/csrc;
  3. kernel vs plain version at the serving shape (N=1024, D=24) and at a
     D>40 AID-scale shape (N=512, D=48), on real padded batches;
  4. the slice: the flagship model (4 layers, 128 channels, 16 heads,
     L=7, K=6, 338 edge features, random weights from a seeded generator)
     serves 256 QM9-scale molecules at batch 32, then 16 AID-scale
     molecules at batch 4, counting kernel launches; one batch is checked
     against the same weights on the CPU (plain version);
  5. times: kernel and plain version per launch (CUDA events, median of
     30 after warm-up) and serving throughput in molecules/s including
     host batching.
The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time

# float32 tolerances of a kernel against its plain version on the card:
# both sum in float32 in different orders (shuffle-tree head sums, FMA
# contraction, an online vs a two-pass softmax denominator) over at most
# DK*L ~ 450 terms, a few ulp each, i.e. ~1e-5 relative in the worst case
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# card vs CPU predictions of the whole model: float32 matmuls in other
# summation orders through ~20 layers and 5 readouts
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-4

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


def attention_work(args, heads: int, num_radial: int, out_bytes: int):
    """(bytes, FP32 operations) the attention function needs on these
    inputs: each input read once and the output written once; per valid
    pair 2L+5 operations per channel (score product and sum, L FMAs of the
    angular sum, message and accumulation), one exp per head and 4(L-2)
    for the Legendre recurrence; 2*L*K per channel for G of each key that
    takes part in a valid pair."""
    q, k, v, e, rbf, w, bias, z, a_ids, b_ids = args
    HC = q.shape[-1]
    L = rbf.shape[-1] // num_radial
    valid = ((a_ids[:, :, None] != b_ids[:, None, :])
             & (a_ids >= 0)[:, :, None] & (b_ids >= 0)[:, None, :])
    n_pairs = int(valid.sum())
    n_keys = int(valid.any(dim=1).sum())
    ops = (n_pairs * (HC * (2 * L + 5) + heads + 4 * max(L - 2, 0))
           + n_keys * 2 * L * num_radial * HC)
    nbytes = sum(t.numel() * t.element_size() for t in args) + out_bytes
    return nbytes, ops, n_pairs


def kernel_inputs(graphs, batch_size, cfg, device, seed):
    """Attention inputs at the shape the model gives the kernel: geometry,
    masks and ids from the first padded batch of `graphs`, activations and
    weights from a seeded numpy generator."""
    import numpy as np
    import torch
    from x2gnn_tpu_torch.data.batching import batch_iterator, pad_budget_for
    from x2gnn_tpu_torch.infer import quantize_budgets
    from x2gnn_tpu_torch.models.x2gnn import blocked_geometry

    budgets = quantize_budgets(pad_budget_for(graphs, batch_size))
    batch = next(batch_iterator(graphs, batch_size, budgets=budgets))
    geo = blocked_geometry(batch.to(device), cfg)
    N, D = batch.in_edges.shape
    HC, LK = cfg.in_channels, cfg.sbf_dim * cfg.rbf_dim
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32)).to(device)

    return (normal(N, D, HC), normal(N, D, HC), normal(N, D, HC),
            normal(N, HC), geo.rbf_env_out, normal(LK, HC, scale=0.3),
            normal(HC), geo.z, geo.a_ids, geo.b_ids)


def check_kernel(tag, args, cfg):
    """Kernel vs plain version on the card; returns its JSON record."""
    import torch
    from x2gnn_tpu_torch.ops.blocked_attn import (
        blocked_attention, blocked_attention_plain)

    H, K = cfg.heads, cfg.rbf_dim
    got = blocked_attention(*args, heads=H, num_radial=K)
    ref = blocked_attention_plain(*args, heads=H, num_radial=K)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp(min=1e-30)).max())
    bad = int((err > KERNEL_ATOL + KERNEL_RTOL * ref.abs()).sum())
    N, DI, HC = args[0].shape
    log(f"[kernel {tag}] N={N} DI={DI} DK={args[1].shape[1]} HC={HC}: "
        f"max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"(|ref| max {float(ref.abs().max()):.3e}), "
        f"{bad} elements outside atol={KERNEL_ATOL} rtol={KERNEL_RTOL}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"kernel {tag}: non-finite output")
    if bad:
        raise AssertionError(f"kernel {tag}: {bad} elements disagree with "
                             "the plain version")
    ms = median_ms(lambda: blocked_attention(*args, heads=H, num_radial=K))
    plain_ms = median_ms(
        lambda: blocked_attention_plain(*args, heads=H, num_radial=K))
    nbytes, ops, n_pairs = attention_work(args, H, K, got.numel() * 4)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    log(f"[kernel {tag}] kernel {ms:.4f} ms/launch, plain {plain_ms:.4f} "
        f"ms; {nbytes} bytes ({t_bytes:.4f} ms at 3.35 TB/s), {ops} FP32 "
        f"ops over {n_pairs} valid pairs ({t_ops:.4f} ms at 67 TFLOP/s)")
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": max_abs, "library_ms": None}


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
    built = _build.build()
    log(f"[build] blocked_attn_fwd: {built.seconds:.2f} s nvcc -> "
        f"{built.path}")
    for line in built.log.splitlines():
        if "registers" in line or "smem" in line:
            log(f"[build]   {line.strip()}")
    log(f"[build] total {time.perf_counter() - t0:.2f} s")

    cfg = ModelConfig(attention_layout="blocked")   # the flagship
    qm9 = synthetic_dataset(256, mean_atoms=18, seed=11)
    aid = synthetic_dataset(16, mean_atoms=64, seed=3)

    # ---- 3. kernel against its plain version ----
    serving_args = kernel_inputs(qm9, 32, cfg, device, seed=1)
    aid_args = kernel_inputs(aid, 4, cfg, device, seed=2)
    if tuple(serving_args[0].shape[:2]) != (1024, 24):
        raise AssertionError(f"serving shape {serving_args[0].shape}")
    if aid_args[1].shape[1] <= 40:
        raise AssertionError(f"AID-scale shape {aid_args[1].shape} is not "
                             "D > 40")
    records = {
        "serving": check_kernel("serving D=24", serving_args, cfg),
        "aid": check_kernel(f"AID D={aid_args[1].shape[1]}", aid_args, cfg),
    }

    # ---- 4. the slice ----
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

    # ---- 5. times ----
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

    src = "x2gnn_tpu_torch/ops/csrc/blocked_attn_fwd.cu"
    kernels = [
        {"name": "blocked_attn_fwd", "route": "cuda", "source": src,
         "replaces": f"{PALLAS}:166", "launches": launches_qm9,
         **records["serving"]},
        {"name": "blocked_attn_fwd (D>40)", "route": "cuda", "source": src,
         "replaces": f"{PALLAS}:282", "launches": launches_aid,
         **records["aid"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
