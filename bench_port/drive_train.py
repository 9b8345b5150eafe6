"""Training cells: the port's Trainer on the benchmark's molecules.

Set-up builds the molecules' graphs (the port's `build_mol_graph`), the
model with the benchmark's weights, and one `Trainer`, with the keyword
arguments of the traffic's "trainer" block over TRAINER_DEFAULTS (by
default the Trainer plans and caches its batches on the device). Epoch 0
runs through `Trainer.train_step` over `Trainer.train_batches(0)`: its
first three steps are the ones the reference checks (loss, gradient,
parameters and their moving average), the rest warm every batch shape
up. The window continues the same object, epoch after epoch, for
`--seconds`. With `--trace 1` a traced slice of `trace_steps` steps
follows the window. Once the window has closed and the peak memory has
been read, the program is freed and the reference follows the first three
steps.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from bench_port import check, harness, inputs, trace
from bench_port.counts import work
from bench_port.harness import Marks, Run
from bench_port.reference import train as ref_train

CHECK_STEPS = 3
# the Trainer's keyword arguments where the traffic's "trainer" block
# leaves them out
TRAINER_DEFAULTS = {"cache_batches": True}


def _launches() -> int:
    from x2gnn_tpu_torch.ops import blocked_attn as ba
    return (ba.blocked_attention.launches
            + ba.blocked_attention_bwd_partials.launches
            + ba.reduce_partials.launches)


def _split(flat_or_list: List[torch.Tensor], model) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor on the host} of a state that holds one
    tensor per parameter, or one flat vector of them all in
    `model.parameters()` order."""
    named = list(model.named_parameters())
    if len(flat_or_list) == 1 and len(named) > 1:
        parts = torch.split(flat_or_list[0].detach(),
                            [p.numel() for _, p in named])
    else:
        parts = [t.detach() for t in flat_or_list]
    return {n: t.reshape(p.shape).cpu()
            for (n, p), t in zip(named, parts)}


def run(r: Run) -> dict:
    from x2gnn_tpu_torch.config import TrainConfig
    from x2gnn_tpu_torch.data.batching import pad_budget_for
    from x2gnn_tpu_torch.train.trainer import Trainer

    m, t = r.model_cfg, r.config["train"]
    dev = r.device
    mols = inputs.make_molecules(r.traffic, r.seed, m["cutoff"],
                                 m["edge_feat_dim"], dev)
    weights = inputs.make_weights(m, r.seed, dev)
    graphs = harness.build_graphs(mols, m["cutoff"])
    mcfg, model = harness.port_model(m, weights, dev)
    tcfg = TrainConfig(**{**t, "division": tuple(t["division"])})
    budgets = None
    if not r.config.get("degree_tiers", True):
        budgets = pad_budget_for(graphs, tcfg.batch_size)._replace(
            tiers=(), n_deg_lo=0, n_hi=0)
    trainer = Trainer(model, mcfg, tcfg, graphs,
                      np.array([g.y[0] for g in graphs]), workdir="unused",
                      device=dev, budgets=budgets,
                      **{**TRAINER_DEFAULTS, **r.traffic.get("trainer", {})})
    state = trainer.init_state()
    label = inputs.by_label(mols)
    stats = [work.mol_stats(mol.positions, m["cutoff"]) for mol in mols]

    def batch_work(steps):
        """[(molecule indices, Stats, FLOPs)] of each step's (labels,
        graph mask): the batch's molecules, named by their labels. The
        caller holds every step's tensors, so no two share an id."""
        memo, out = {}, []
        for y, mask in steps:
            if id(y) not in memo:
                idx = [label[np.float32(v).item()]
                       for v in y[mask].cpu().numpy()]
                s = work.total([stats[i] for i in idx])
                memo[id(y)] = (idx, s, work.step_flops(s, m))
            out.append(memo[id(y)])
        return out

    # epoch 0: the checked steps, then warm-up over every batch
    losses, checked, grad1, params3, ema3 = [], [], None, None, None
    n0 = 0
    for n0, b in enumerate(trainer.train_batches(0), 1):
        state, loss = trainer.train_step(state, b)
        if n0 <= CHECK_STEPS:
            losses.append(loss)
            checked.append((b.y, b.graph_mask))
        if n0 == 1:
            grad1 = state.opt_state.mu
        if n0 == CHECK_STEPS:
            params3 = [p.detach().clone() for p in state.params]
            ema3 = {k: v.detach().cpu()
                    for k, v in trainer.ema_parameters(state).items()}
    if n0 < CHECK_STEPS:
        raise RuntimeError(f"an epoch has {n0} steps, fewer than the "
                           f"{CHECK_STEPS} the check follows")
    bad0 = int(state.bad_steps)
    harness.sync(dev)

    def feed():
        epoch = 1
        while True:
            yield from trainer.train_batches(epoch)
            epoch += 1

    batches = feed()
    marks, dispatch, done = Marks(dev), [], []
    launches0 = _launches()
    setup_s = time.perf_counter() - r.started
    t0 = time.perf_counter()
    marks.mark()
    while time.perf_counter() - t0 < r.seconds:
        b = next(batches)
        h = time.perf_counter()
        state, _ = trainer.train_step(state, b)
        dispatch.append(time.perf_counter() - h)
        marks.mark()
        done.append((b.y, b.graph_mask))
    harness.sync(dev)
    window_s = time.perf_counter() - t0
    launches = _launches() - launches0
    step_ms = marks.intervals_ms()
    failed = int(state.bad_steps) - bad0
    per_step = batch_work(done)
    molecules = sum(s.molecules for _, s, _ in per_step)
    del done, b

    rec = {"kind": "train", "window": {
        "seconds": window_s, "steps": len(per_step),
        "molecules": molecules,
        "flops": sum(f for _, _, f in per_step), "dispatch_s": dispatch,
        "launches": launches}}
    if r.trace:
        rec["trace"] = _traced(r, trainer, state, batches, batch_work)
    batches.close()
    peak = harness.peak_bytes(dev)

    # the program's readings, then the program is freed
    prog_losses = [float(x) for x in losses]
    prog_grad = {k: v / (1 - ref_train.B1)
                 for k, v in _split(grad1, model).items()}
    p3 = _split(params3, model)
    p0 = {k: v.detach().cpu() for k, v in weights.items()}
    prog_change = {k: p3[k] - p0[k] for k in p0}
    prog_ema = {k: ema3[k] - p0[k] for k in p0}
    checked = [[mols[i] for i in idx] for idx, _, _ in batch_work(checked)]
    del trainer, model, state, batches, graphs, grad1, params3
    harness.free(dev)

    ref_p, ref_ema, results = ref_train.run_steps(weights, checked, m, t,
                                                  dev)
    numbers, leaves = check.train_numbers(
        prog_losses, prog_grad, prog_change, prog_ema,
        [x.loss for x in results],
        {k: v.cpu() for k, v in results[0].grads.items()},
        {k: ref_p[k].cpu() - p0[k] for k in p0},
        {k: ref_ema[k].cpu() - p0[k] for k in p0})
    return {"attempted": len(per_step), "failed": failed,
            "setup_s": setup_s,
            "end_to_end": {"train_mol_per_s": molecules / window_s,
                           "train_step_p95_ms": harness.p95(step_ms),
                           "setup_s": setup_s},
            "records": rec, "peak": peak, "numbers": numbers,
            "worst_leaves": leaves}


def _traced(r: Run, trainer, state, batches, batch_work) -> dict:
    """`trace_steps` more steps under the profiler, the fused attention's
    calls in labelled ranges; each step's attention at its own bound."""
    m = r.model_cfg
    traced = []
    harness.sync(r.device)
    with trace.attention_ranges(), trace.profiled() as prof:
        t0 = time.perf_counter()
        for _ in range(r.traffic["trace_steps"]):
            b = next(batches)
            state, _ = trainer.train_step(state, b)
            traced.append((b.y, b.graph_mask))
        harness.sync(r.device)
        window_s = time.perf_counter() - t0
    out = trace.summarize(prof)
    each = [s for _, s, _ in batch_work(traced)]
    layers = m["conv_layers"]
    out.update(window_s=window_s, steps=len(traced),
               attn_fwd_bound_s=sum(layers * work.bound_s(
                   *work.attn_fwd(s, m)) for s in each),
               attn_bwd_bound_s=sum(layers * work.bound_s(
                   *work.attn_bwd(s, m)) for s in each))
    return out
