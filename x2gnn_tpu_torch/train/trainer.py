"""Training loop (x2gnn_tpu/train/trainer.py, single-device path): EMA
training with a per-step schedule, masked losses, best-val checkpoints,
`metrics.jsonl` and the reference-style `train.log`.

Batches are fixed-budget (`pad_budget_for` over the whole dataset, or the
caller's `budgets`) and taken in split order every epoch, as the
reference trainer does when packing is off (:382-389). They are cached on
the device across epochs (as the reference does for datasets under ~20k
molecules), so each is copied to the card once per run.
Each step runs the model forward, autograd's backward (the attention's
through the CUDA backward kernel), then clip, Adam and the EMA, with the
non-finite skip decided on the device. The parameters are updated in
place; with `fused_update` they are views into one flat vector, which the
optimizer and the EMA update as a whole.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from x2gnn_tpu_torch.config import ModelConfig, TrainConfig, dump_configs
from x2gnn_tpu_torch.data.batching import (
    Budgets, GraphBatch, batch_iterator, pad_budget_for)
from x2gnn_tpu_torch.device import resolve_device
from x2gnn_tpu_torch.train.checkpoint import save_checkpoint
from x2gnn_tpu_torch.train.ema import EmaState, ema_init, unflatten
from x2gnn_tpu_torch.train.loss import masked_mae, smooth_l1_loss
from x2gnn_tpu_torch.train.optim import (
    AdamState, Optimizer, PlateauController, apply_update_skip_nonfinite,
    set_plateau_scale)


class TrainState(NamedTuple):
    params: List[torch.Tensor]   # the model's parameters, or [flat vector]
    opt_state: AdamState
    ema: EmaState
    step: torch.Tensor           # int32 scalar
    bad_steps: torch.Tensor      # int32 scalar: skipped non-finite updates


def resolve_division(n: int, division) -> tuple:
    """Scale the reference 10k/10k division down for small datasets
    (x2gnn_tpu/train/trainer.py:39-48)."""
    d0, d1 = division
    if n <= d1:
        d0 = max(1, n // 10)
        d1 = min(n - 1, 2 * d0)
    return d0, d1


def make_split(n: int, seed: int, division) -> tuple:
    """Fixed-permutation split: test=[:d0], val=[d0:d1], train=[d1:]
    (trainer.py:22-27; numpy's legacy RandomState, as the reference)."""
    perm = np.random.RandomState(seed).permutation(n)
    d0, d1 = division
    return perm[d1:], perm[d0:d1], perm[:d0]  # train, val, test


def _flatten_parameters(params: Sequence[torch.nn.Parameter]) -> torch.Tensor:
    """Move the parameters into one flat vector and make each parameter a
    view of it; returns the vector."""
    with torch.no_grad():
        flat = torch.cat([p.detach().reshape(-1) for p in params])
    off = 0
    for p in params:
        n = p.numel()
        p.data = flat[off:off + n].view_as(p)
        off += n
    return flat


class Trainer:
    def __init__(
        self,
        model: torch.nn.Module,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        graphs: Sequence,
        targets: np.ndarray,
        workdir: str = "./runs/run0",
        std: float = 1.0,
        budgets: Optional[Budgets] = None,
        mesh=None,
        edge_partition: Optional[str] = None,
        feat_dtype: str = "float32",
        device="cuda",
    ):
        """`std`: MAE report calibration (trainer.py:57). `budgets`: the
        padding budgets of every batch (default: `pad_budget_for` over
        all graphs)."""
        unported = [
            (train_cfg.pack_mixed, "pack_mixed (mixed-FFD packing)", "A8"),
            (train_cfg.bucket_shapes, "bucket_shapes", "A8"),
            (train_cfg.pack_budget, "pack_budget", "A8"),
            (mesh is not None, "a device mesh (data parallelism)", "A10"),
            (edge_partition is not None, "edge_partition", "A10"),
            (feat_dtype != "float32", f"feat_dtype={feat_dtype!r}", "A8"),
            (model_cfg.dropout > 0, "attention dropout", "A8"),
        ]
        for bad, what, item in unported:
            if bad:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP {item})")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.mcfg = model_cfg
        self.tcfg = train_cfg
        self.graphs = list(graphs)
        self.targets = np.asarray(targets, dtype=np.float32)
        self.workdir = workdir
        self.std = std
        self.optimizer = Optimizer(train_cfg)

        n = len(self.graphs)
        d0, d1 = resolve_division(n, train_cfg.division)
        self.train_idx, self.val_idx, self.test_idx = make_split(
            n, train_cfg.random_seed, (d0, d1))
        self.budgets = budgets or pad_budget_for(
            self.graphs, train_cfg.batch_size)
        self._batch_cache = {}
        self._totals = {}

        self._names = [name for name, _ in model.named_parameters()]
        self._leaves = list(model.parameters())
        self._flat = (_flatten_parameters(self._leaves)
                      if train_cfg.fused_update else None)

    # ---- steps -----------------------------------------------------------
    def train_step(self, state: TrainState, batch: GraphBatch):
        """One optimization step (trainer.py:239-264); returns (state,
        loss) with the loss still on the device."""
        pred = self.model(batch)
        loss = smooth_l1_loss(pred, batch.y, mask=batch.graph_mask)
        grads = torch.autograd.grad(loss, self._leaves)
        if self._flat is not None:
            grads = [torch.cat([g.reshape(-1) for g in grads])]
        return apply_update_skip_nonfinite(state, loss.detach(), grads,
                                           self.optimizer,
                                           self.tcfg.ema_decay)

    def ema_parameters(self, state: TrainState) -> dict:
        """{parameter name: EMA tensor} (views of the flat EMA if fused)."""
        ema = state.ema.params
        if self._flat is not None:
            ema = unflatten(ema[0], self._leaves)
        return dict(zip(self._names, ema))

    def eval_step(self, ema_params: dict, batch: GraphBatch):
        """(sum of |err| over the batch's real graphs, their count), both on
        the device; the calibration is applied by `evaluate`
        (trainer.py:266-274)."""
        with torch.no_grad():
            pred = torch.func.functional_call(self.model, ema_params,
                                              (batch,))
            err = masked_mae(pred, batch.y, mask=batch.graph_mask)
        return err, batch.graph_mask.sum()

    # ---- state -----------------------------------------------------------
    def init_state(self) -> TrainState:
        """Optimizer and EMA state for the model's current parameters."""
        params = [self._flat] if self._flat is not None else self._leaves
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return TrainState(params, self.optimizer.init(params),
                          ema_init(params, flat=self._flat is not None),
                          zero, zero.clone())

    def _record_totals(self, key, idx):
        if key in self._totals:
            return
        steps = -(-len(idx) // self.tcfg.batch_size)
        b = self.budgets
        self._totals[key] = {
            "real": (sum(self.graphs[i].num_atoms for i in idx),
                     sum(self.graphs[i].num_edges for i in idx),
                     sum(self.graphs[i].num_triplets for i in idx)),
            "padded": (b.n_node * steps, b.n_edge * steps,
                       b.n_trip * steps),
            "shapes": 1,
        }

    @staticmethod
    def _cache_key(idx):
        return (len(idx), hash(np.ascontiguousarray(idx).tobytes()))

    def batches(self, idx) -> List[GraphBatch]:
        """The device batches of the molecules `idx`, in order, made once
        and cached."""
        key = self._cache_key(idx)
        if key not in self._batch_cache:
            self._record_totals(key, idx)
            idx = np.asarray(idx)
            self._batch_cache[key] = [b.to(self.device) for b in
                                      batch_iterator(
                [self.graphs[i] for i in idx], self.tcfg.batch_size,
                budgets=self.budgets, targets=self.targets[idx])]
        return self._batch_cache[key]

    def steps_per_epoch(self) -> int:
        return max(-(-len(self.train_idx) // self.tcfg.batch_size), 1)

    # ---- loops -----------------------------------------------------------
    def run_epoch(self, state: TrainState):
        """One pass over the train split in its fixed order; returns
        (state, mean loss per molecule). The losses stay on the device
        until the epoch ends (one transfer, no per-step sync)."""
        losses, counts = [], []
        for batch in self.batches(self.train_idx):
            state, loss = self.train_step(state, batch)
            losses.append(loss)
            counts.append(batch.graph_mask.sum())
        losses = torch.stack(losses).cpu().numpy().astype(np.float64)
        counts = torch.stack(counts).cpu().numpy()
        return state, float((losses * counts).sum() / max(counts.sum(), 1))

    def evaluate(self, state: TrainState, idx) -> float:
        """MAE over the molecules `idx` on the EMA weights, calibrated."""
        ema = self.ema_parameters(state)
        accum = [self.eval_step(ema, b) for b in self.batches(idx)]
        errs = torch.stack([e for e, _ in accum]).cpu().numpy()
        counts = torch.stack([c for _, c in accum]).cpu().numpy()
        total = float(errs.astype(np.float64).sum())
        return self.std * total / max(int(counts.sum()), 1)

    def fit(self, epochs: Optional[int] = None):
        """Train for `epochs` (default max_epoch) from `init_state()`:
        plateau control, the best-val gate with ckpt_best.pt, ckpt_last.pt
        every ckpt_every epochs, one metrics.jsonl record and one train.log
        line per epoch (trainer.py:557-709). Returns (state,
        {"best_val_mae", "test_mae"})."""
        epochs = self.tcfg.max_epoch if epochs is None else epochs
        os.makedirs(self.workdir, exist_ok=True)
        dump_configs(self.mcfg, self.tcfg,
                     os.path.join(self.workdir, "args.json"))
        log_path = os.path.join(self.workdir, "train.log")
        jsonl_path = os.path.join(self.workdir, "metrics.jsonl")
        best_meta = os.path.join(self.workdir, "ckpt_best_val.json")
        state = self.init_state()
        plateau = None
        if self.tcfg.scheduler == "plateau":
            plateau = PlateauController(factor=self.tcfg.reduce_factor,
                                        patience=self.tcfg.patience,
                                        min_scale=self.tcfg.decay_rate)
        plateau_logged = plateau.scale if plateau is not None else None

        best_val, test_err = None, None
        for epoch in range(epochs):
            t0 = time.time()
            state, loss = self.run_epoch(state)
            val_err = self.evaluate(state, self.val_idx)
            if plateau is not None:
                new_scale = plateau.step(val_err)
                if new_scale != plateau_logged:
                    state = state._replace(opt_state=set_plateau_scale(
                        state.opt_state, new_scale))
                plateau_logged = new_scale
            if best_val is None or val_err <= best_val:
                best_val = val_err
                if epoch >= self.tcfg.ckpt_after_epoch:
                    test_err = self.evaluate(state, self.test_idx)
                    save_checkpoint(
                        os.path.join(self.workdir, "ckpt_best.pt"), state)
                    tmp = best_meta + ".tmp"
                    with open(tmp, "w") as f:
                        json.dump({"best_val_mae": float(best_val)}, f)
                    os.replace(tmp, best_meta)
            if (self.tcfg.ckpt_every
                    and (epoch + 1) % self.tcfg.ckpt_every == 0):
                save_checkpoint(os.path.join(self.workdir, "ckpt_last.pt"),
                                state)
            seconds = time.time() - t0
            n_train = len(self.train_idx)
            record = {
                "epoch": epoch + 1,
                "loss": float(loss),
                "val_mae": float(val_err),
                "best_val_mae": float(best_val),
                "test_mae": None if test_err is None else float(test_err),
                "step": int(state.step),
                "bad_steps": int(state.bad_steps),
                "seconds": seconds,
                "molecules_per_sec": n_train / max(seconds, 1e-9),
            }
            tot = self._totals.get(self._cache_key(self.train_idx))
            if tot is not None:
                # throughput from real entity counts and padded-vs-real
                # occupancy, as the reference's north-star counters
                real_n, real_e, real_t = tot["real"]
                pad_n, pad_e, pad_t = tot["padded"]
                record.update({
                    "edges_per_sec": real_e / max(seconds, 1e-9),
                    "triplets_per_sec": real_t / max(seconds, 1e-9),
                    "occupancy_nodes": real_n / max(pad_n, 1),
                    "occupancy_edges": real_e / max(pad_e, 1),
                    "occupancy_triplets": real_t / max(pad_t, 1),
                    "budget_shapes": tot["shapes"],
                })
            if plateau_logged is not None:
                record["lr_scale"] = plateau_logged
            with open(jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")
            with open(log_path, "a") as f:
                f.write(
                    f"{time.strftime('%m_%d_%H_%M_%S')}"
                    f"\t[epoch]:{epoch + 1:03d}"
                    f"\t[Loss]:{loss:.7f}"
                    f"\t[ValMAE]:{val_err:.7f}"
                    f"\t[TestMAE]:"
                    f"{test_err if test_err is not None else -1.0:.7f}"
                    "\n")
        return state, {"best_val_mae": best_val, "test_mae": test_err}
