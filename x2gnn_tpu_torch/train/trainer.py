"""Training loop (x2gnn_tpu/train/trainer.py, single-device path): EMA
training with a per-step schedule, masked losses, best-val checkpoints,
`metrics.jsonl` and the reference-style `train.log`.

Batches are fixed-budget (`pad_budget_for` over the whole dataset, or the
caller's `budgets`) and taken in split order every epoch, as the
reference trainer does when packing is off (:382-389); or planned
(:359-381): `pack_mixed` bins each split by mixed first-fit-decreasing
packing into one shape, `bucket_shapes` groups it by size into a few
shapes (`pack_budget` fills each batch to its class budget), and the
training batches are then visited in a per-(seed, epoch) shuffled order
(:332-345). With the default budgets, and under `pack_mixed`, batches are
degree-sorted and carry degree tiers, so each blocked conv runs one
attention kernel per tier. The segment and padded layouts' batches carry
the triplet arrays and neighbour tables as well (`pad_graphs(...,
with_triplets=True)`, trainer.py:122-128). `cache_batches` chooses where the batches live, as in
the reference (trainer.py:170-173, :347-420): True keeps them on the
device across epochs, each copied to the card once per run (the default
for datasets up to 20,000 molecules); False assembles each epoch's
batches in a prefetch thread and copies each to the card (larger
datasets); "host" assembles them once into host memory and streams them
to the card every epoch. A streamed batch is pinned and copied on a CUDA
stream of its own, ahead of the step that reads it; that step's stream
waits for the copy. With `feat_dtype` "float16" or "int8" (per-edge
scales) the batches hold the edge features in that dtype (`cast_feat`,
trainer.py:309-330), which the model upcasts at entry.
Each step runs the model forward, autograd's backward (the blocked
attention's through the CUDA backward kernel), then clip, Adam and the
EMA, with the
non-finite skip decided on the device. With attention dropout, a step
draws its masks from a generator seeded by (random_seed, step), as the
reference folds the step into its dropout key (:244-254): a step repeats
bit for bit, and a resumed run drops what an unbroken one drops. With
accum_steps > 1 every batch is a micro-step: the optimizer state holds the
gradient mean and the micro-step counter (`train/optim.py`), the
parameters move on every accum_steps-th one, and `step`, the EMA and the
dropout masks' seeds advance on each, as in the reference. The
parameters are updated in place; with `fused_update` they are views into
one flat vector, which the optimizer and the EMA update as a whole. A
state handed in from outside (`restore`, `fit(state=)`) is first copied
into those live tensors (`use_state`). A resumed run counts epochs
globally from its restored step (trainer.py:571-609). `fit(profile_dir=)`
traces the second epoch with torch.profiler (trainer.py:612-617).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from x2gnn_tpu_torch.config import ModelConfig, TrainConfig, dump_configs
from x2gnn_tpu_torch.data.batching import (
    Budgets, GraphBatch, mixed_packed_plan, pad_budget_for, pad_graphs,
    size_bucketed_plan)
from x2gnn_tpu_torch.data.prefetch import prefetch
from x2gnn_tpu_torch.device import resolve_device
from x2gnn_tpu_torch.models.x2gnn import needs_triplets
from x2gnn_tpu_torch.train.checkpoint import (
    restore_checkpoint, save_checkpoint)
from x2gnn_tpu_torch.train.ema import EmaState, ema_init, unflatten
from x2gnn_tpu_torch.train.loss import masked_mae, smooth_l1_loss
from x2gnn_tpu_torch.train.optim import (
    AdamState, Optimizer, PlateauController, apply_update_skip_nonfinite,
    get_plateau_scale, set_plateau_scale)
from x2gnn_tpu_torch.weights import parameter_list


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


FEAT_DTYPES = ("float32", "float16", "int8")
CACHE_MODES = (None, True, False, "host")
# cache_batches=None keeps batches on the device up to this many molecules
# (trainer.py:170-173)
DEVICE_CACHE_MAX_MOLECULES = 20000


def cast_feat(batch: GraphBatch, feat_dtype: str) -> GraphBatch:
    """A host batch with its edge features in `feat_dtype`, as the
    reference's `Trainer._cast_feat` (trainer.py:309-330): float16, or int8
    by symmetric per-edge quantization, q = rint(x / s) clipped to +-127
    with s = max|row| / 127 (1 for an all-zero row), s kept as the batch's
    float32 `edge_feat_scale`."""
    if feat_dtype == "float32":
        return batch
    x = np.asarray(batch.edge_feat, np.float32)
    if feat_dtype == "int8":
        amax = np.abs(x).max(axis=1)
        scale = np.where(amax > 0, amax / 127.0, 1.0)
        q = np.clip(np.rint(x / scale[:, None]), -127, 127)
        return dataclasses.replace(batch, edge_feat=q.astype(np.int8),
                                   edge_feat_scale=scale.astype(np.float32))
    return dataclasses.replace(batch, edge_feat=x.astype(np.float16))


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
        cache_batches=None,
    ):
        """`std`: MAE report calibration (trainer.py:57). `budgets`: the
        padding budgets of every fixed-budget batch, and the base of the
        packing planners (default: `pad_budget_for` over all graphs).
        `feat_dtype`: the edge features' dtype in the batches, one of
        FEAT_DTYPES (`cast_feat`). `cache_batches`: one of CACHE_MODES
        (see the module's docstring); None is True for up to
        DEVICE_CACHE_MAX_MOLECULES molecules, else False."""
        if feat_dtype not in FEAT_DTYPES:
            raise ValueError(f"feat_dtype must be one of {FEAT_DTYPES}, "
                             f"got {feat_dtype!r}")
        if not (cache_batches is None or isinstance(cache_batches, bool)
                or cache_batches == "host"):
            raise ValueError(f"cache_batches must be one of {CACHE_MODES}, "
                             f"got {cache_batches!r}")
        unported = [
            (mesh is not None, "a device mesh (data parallelism)", "A10"),
            (edge_partition is not None, "edge_partition", "A10"),
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
        self.feat_dtype = feat_dtype
        self._with_triplets = needs_triplets(model_cfg)
        self.optimizer = Optimizer(train_cfg)

        n = len(self.graphs)
        d0, d1 = resolve_division(n, train_cfg.division)
        self.train_idx, self.val_idx, self.test_idx = make_split(
            n, train_cfg.random_seed, (d0, d1))
        self.budgets = budgets or pad_budget_for(
            self.graphs, train_cfg.batch_size)
        # mixed-FFD packing supersedes the per-class planner (:141-150)
        self.pack_mixed = bool(train_cfg.pack_mixed)
        self.bucket_shapes = 0 if self.pack_mixed else int(
            train_cfg.bucket_shapes)
        self.pack_budget = (not self.pack_mixed) and bool(
            train_cfg.pack_budget)
        if self.pack_budget and not self.bucket_shapes:
            raise ValueError("pack_budget requires bucket_shapes >= 1 "
                             "(packing fills the per-class budgets)")
        if cache_batches is None:
            cache_batches = n <= DEVICE_CACHE_MAX_MOLECULES
        self.cache_batches = cache_batches
        self._plans = {}         # split key -> [(chunk, budgets, n_graph)]
        self._totals = {}        # split key -> real/padded totals
        self._batch_cache = {}   # split key -> device (True) or host batches

        self._names = [name for name, _ in model.named_parameters()]
        self._leaves = list(model.parameters())
        self._flat = (_flatten_parameters(self._leaves)
                      if train_cfg.fused_update else None)

    # ---- steps -----------------------------------------------------------
    def dropout_generator(self, step: int) -> torch.Generator:
        """The generator of the dropout masks of optimizer step `step`, on
        the trainer's device: seeded by (random_seed, step), so the same
        step draws the same masks in every run."""
        g = torch.Generator(device=self.device)
        return g.manual_seed((self.tcfg.random_seed << 32) + int(step))

    def train_step(self, state: TrainState, batch: GraphBatch,
                   step: Optional[int] = None):
        """One optimization step (trainer.py:239-264); returns (state,
        loss) with the loss still on the device. With attention dropout,
        the masks come from `dropout_generator` of `step`, state.step's
        value (read from the device when not given)."""
        if self.mcfg.dropout > 0:
            if step is None:
                step = int(state.step)
            pred = self.model(batch, deterministic=False,
                              generator=self.dropout_generator(step))
        else:
            pred = self.model(batch)
        loss = smooth_l1_loss(pred, batch.y, mask=batch.graph_mask)
        # v2 leaves the atom embedding unused: zeros, as the reference's
        grads = torch.autograd.grad(loss, self._leaves,
                                    materialize_grads=True)
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

    def use_state(self, state: TrainState) -> TrainState:
        """`state` on the model's live parameters: each of its parameter
        tensors that is not the live one is copied into it. `train_step`
        differentiates the model's parameters and updates state.params in
        place, so a state must hold them."""
        live = [self._flat] if self._flat is not None else self._leaves
        if len(state.params) != len(live):
            raise ValueError(f"state has {len(state.params)} parameter "
                             f"tensors, the trainer {len(live)}")
        with torch.no_grad():
            for p, v in zip(live, state.params):
                if p is not v:
                    p.copy_(v)
        return state._replace(params=live)

    def _own_layout(self, tensors) -> List[torch.Tensor]:
        """Saved parameter-shaped tensors (one flat vector, or one per
        parameter) in this trainer's layout, on its device."""
        per = parameter_list(self.model, [t.to(self.device)
                                          for t in tensors])
        if self._flat is not None:
            return [torch.cat([t.reshape(-1) for t in per])]
        return [t.clone() for t in per]

    def restore(self, path: str) -> TrainState:
        """The TrainState of the checkpoint `path`, its parameters copied
        into the model. A checkpoint of the other parameter layout (a
        per-parameter EMA under `fused_update`'s flat one, or the reverse)
        is adapted: parameters and EMA are converted, the Adam moments and
        count start again at zero, as the reference does
        (trainer.py:712-750)."""
        template = self.init_state()
        try:
            return self.use_state(restore_checkpoint(path, template))
        except ValueError:
            raw = restore_checkpoint(path)
        params = self._own_layout(raw["params"])
        state = self.use_state(template._replace(params=params))
        ema = EmaState(self._own_layout(raw["ema"]["params"]),
                       raw["ema"]["count"].to(self.device))
        return state._replace(
            opt_state=self.optimizer.init(state.params), ema=ema,
            step=raw["step"].to(self.device),
            bad_steps=raw["bad_steps"].to(self.device))

    @property
    def packed(self) -> bool:
        """Whether batches come from a packing or bucketing plan."""
        return bool(self.pack_mixed or self.bucket_shapes)

    def plan(self, idx):
        """(chunks, budgets, stats) of the planner over the molecules
        `idx` (trainer.py:362-369)."""
        if self.pack_mixed:
            return mixed_packed_plan(self.graphs, idx, self.tcfg.batch_size,
                                     self.budgets)
        return size_bucketed_plan(self.graphs, idx, self.tcfg.batch_size,
                                  self.bucket_shapes, self.budgets,
                                  pack=self.pack_budget)

    def _fixed_totals(self, idx) -> dict:
        steps = -(-len(idx) // self.tcfg.batch_size)
        b = self.budgets
        return {
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

    def _plan_of(self, idx) -> list:
        """[(molecule indices, budgets, graph slots)] of each batch of the
        molecules `idx`, in plan order (split order for fixed budgets),
        made once; the split's real/padded totals are recorded beside
        it."""
        key = self._cache_key(idx)
        if key not in self._plans:
            idx = np.asarray(idx)
            bs = self.tcfg.batch_size
            if self.packed:
                chunks, budgets, stats = self.plan(idx)
                plan = [(np.asarray(c), b, b.n_graph or bs)
                        for c, b in zip(chunks, budgets)]
            else:
                stats = self._fixed_totals(idx)
                plan = [(idx[lo:lo + bs], self.budgets, bs)
                        for lo in range(0, len(idx), bs)]
            self._totals[key] = stats
            self._plans[key] = plan
        return self._plans[key]

    def _assemble(self, entry) -> GraphBatch:
        """The host batch of one plan entry, its features cast to
        `feat_dtype` (trainer.py:372-381)."""
        chunk, budgets, n_graph = entry
        return cast_feat(pad_graphs(
            [self.graphs[i] for i in chunk], budgets, n_graph=n_graph,
            targets=self.targets[chunk], with_triplets=self._with_triplets),
            self.feat_dtype)

    def batches(self, idx) -> List[GraphBatch]:
        """The device cache (cache_batches=True): the device batches of
        the molecules `idx` in plan order, made once. The streamed modes
        keep no batch on the device; `device_batches` streams theirs."""
        if self.cache_batches is not True:
            raise ValueError(
                f"cache_batches={self.cache_batches!r} keeps no device "
                "batches: stream them with device_batches(idx)")
        key = self._cache_key(idx)
        if key not in self._batch_cache:
            self._batch_cache[key] = [self._assemble(e).to(self.device)
                                      for e in self._plan_of(idx)]
        return self._batch_cache[key]

    def _host_batches(self, idx) -> List[GraphBatch]:
        """cache_batches="host": the host batches of `idx`, assembled once
        (pinned for the card)."""
        key = self._cache_key(idx)
        if key not in self._batch_cache:
            host = [self._assemble(e) for e in self._plan_of(idx)]
            if self.device.type == "cuda":
                host = [b.pin_memory() for b in host]
            self._batch_cache[key] = host
        return self._batch_cache[key]

    def _stream(self, host: Iterator[GraphBatch]) -> Iterator[GraphBatch]:
        """Host batches to device batches, two ahead of the consumer: the
        prefetch thread takes each from `host` (assembling it there if
        `host` does), and for the card pins it and copies it on a stream of
        its own, recording an event. The consumer's stream waits on that
        event before it reads the batch, and each tensor is marked as used
        on the consumer's stream, so its memory is not handed out again
        while a step may still read it (trainer.py:347-353)."""
        device = self.device
        if device.type != "cuda":
            yield from prefetch((b.to(device) for b in host), depth=2)
            return
        copy_stream = torch.cuda.Stream(device=device)

        def copies():
            for b in host:
                if not isinstance(b.numbers, torch.Tensor):
                    b = b.pin_memory()
                with torch.cuda.stream(copy_stream):
                    dev = b.to(device, non_blocking=True)
                    landed = torch.cuda.Event()
                    landed.record(copy_stream)
                yield dev, landed

        compute = torch.cuda.current_stream(device)
        for dev, landed in prefetch(copies(), depth=2):
            compute.wait_event(landed)
            for t in dev.arrays():
                t.record_stream(compute)
            yield dev

    def device_batches(self, idx, epoch=None) -> Iterator[GraphBatch]:
        """The batches of the molecules `idx` on the device, in plan order
        (for planned batches with `epoch` given, in the order `_shuffle`
        gives that epoch): from the device cache (cache_batches=True),
        streamed from the host cache ("host"), or assembled in the
        prefetch thread and streamed (False)."""
        if self.cache_batches is True:
            items = self.batches(idx)
        elif self.cache_batches == "host":
            items = self._host_batches(idx)
        else:
            items = self._plan_of(idx)
        if epoch is not None and self.packed:
            items = [items[j] for j in self._shuffle(len(items), epoch)]
        if self.cache_batches is True:
            return iter(items)
        if self.cache_batches is False:
            items = (self._assemble(e) for e in items)
        return self._stream(iter(items))

    def first_batch(self, idx) -> GraphBatch:
        """The first device batch of the molecules `idx` in plan order; a
        stream is stopped after it."""
        batches = self.device_batches(idx)
        try:
            return next(batches)
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()

    def steps_per_epoch(self) -> int:
        """Optimizer steps per epoch: the plan's batch count when packed
        (trainer.py:461-486)."""
        return max(len(self._plan_of(self.train_idx)), 1)

    def _shuffle(self, n: int, epoch: int) -> np.ndarray:
        """The permutation of `n` planned batches that epoch `epoch`
        visits, seeded by (random_seed, epoch): the plans are size-sorted
        (trainer.py:332-345)."""
        rs = np.random.RandomState(
            (self.tcfg.random_seed * 1000003 + epoch) % (2 ** 31))
        return rs.permutation(n)

    def train_order(self, epoch: int) -> List[GraphBatch]:
        """`train_batches(epoch)` as a list."""
        return list(self.train_batches(epoch))

    def train_batches(self, epoch: int) -> Iterator[GraphBatch]:
        """The training batches of epoch `epoch` on the device, from
        wherever `cache_batches` keeps them: split order for fixed
        budgets, `_shuffle` for planned batches."""
        return self.device_batches(self.train_idx, epoch)

    # ---- loops -----------------------------------------------------------
    def run_epoch(self, state: TrainState, epoch: int = 0):
        """One pass over the train split in `train_batches(epoch)`; returns
        (state, mean loss per molecule). The losses stay on the device
        until the epoch ends (one transfer, no per-step sync)."""
        losses, counts = [], []
        # the steps' numbers for their dropout masks, read once per epoch
        step = int(state.step) if self.mcfg.dropout > 0 else None
        for batch in self.train_batches(epoch):
            state, loss = self.train_step(state, batch, step)
            if step is not None:
                step += 1
            losses.append(loss)
            counts.append(batch.graph_mask.sum())
        losses = torch.stack(losses).cpu().numpy().astype(np.float64)
        counts = torch.stack(counts).cpu().numpy()
        return state, float((losses * counts).sum() / max(counts.sum(), 1))

    def evaluate(self, state: TrainState, idx) -> float:
        """MAE over the molecules `idx` on the EMA weights, calibrated."""
        ema = self.ema_parameters(state)
        accum = [self.eval_step(ema, b) for b in self.device_batches(idx)]
        errs = torch.stack([e for e, _ in accum]).cpu().numpy()
        counts = torch.stack([c for _, c in accum]).cpu().numpy()
        total = float(errs.astype(np.float64).sum())
        return self.std * total / max(int(counts.sum()), 1)

    def fit(self, epochs: Optional[int] = None,
            state: Optional[TrainState] = None,
            profile_dir: Optional[str] = None):
        """Train for `epochs` (default max_epoch) from `state` (a resumed
        run, e.g. `restore`) or `init_state()`: plateau control, the
        best-val gate with ckpt_best.pt, ckpt_last.pt every ckpt_every
        epochs, one metrics.jsonl record and one train.log line per epoch
        (trainer.py:557-709). Epochs count globally from the state's step,
        epoch0 = step // steps_per_epoch: the shuffle, the
        ckpt_after_epoch gate and the records' numbering continue the
        run. A resumed run starts the plateau controller at the restored
        scale (its best and patience counters start again, as in the
        reference) and the best-val gate at the restored weights' val MAE
        or the smaller recorded ckpt_best_val.json. `profile_dir`: trace
        the second epoch (the first builds the batches and the kernels)
        into that directory (`utils/profiling.py::trace`). Returns (state,
        {"best_val_mae", "test_mae"})."""
        epochs = self.tcfg.max_epoch if epochs is None else epochs
        os.makedirs(self.workdir, exist_ok=True)
        dump_configs(self.mcfg, self.tcfg,
                     os.path.join(self.workdir, "args.json"))
        log_path = os.path.join(self.workdir, "train.log")
        jsonl_path = os.path.join(self.workdir, "metrics.jsonl")
        best_meta = os.path.join(self.workdir, "ckpt_best_val.json")
        resumed = state is not None
        state = self.use_state(state) if resumed else self.init_state()
        epoch0 = int(state.step) // self.steps_per_epoch()
        plateau = None
        if self.tcfg.scheduler == "plateau":
            plateau = PlateauController(
                factor=self.tcfg.reduce_factor, patience=self.tcfg.patience,
                min_scale=self.tcfg.decay_rate,
                scale=(get_plateau_scale(state.opt_state) if resumed
                       else 1.0))
        plateau_logged = plateau.scale if plateau is not None else None

        best_val, test_err = None, None
        if resumed:
            # an early, worse epoch of the resumed run must not overwrite
            # ckpt_best: the gate starts at the better of the restored
            # weights' val MAE and the value recorded beside ckpt_best
            best_val = self.evaluate(state, self.val_idx)
            try:
                with open(best_meta) as f:
                    best_val = min(best_val,
                                   float(json.load(f)["best_val_mae"]))
            except (FileNotFoundError, ValueError, KeyError):
                pass   # absent or torn file: the evaluation stands
        for epoch in range(epochs):
            t0 = time.time()
            if profile_dir is not None and epoch == 1:
                from x2gnn_tpu_torch.utils.profiling import trace
                with trace(profile_dir, self.device):
                    state, loss = self.run_epoch(state, epoch0 + epoch)
            else:
                state, loss = self.run_epoch(state, epoch0 + epoch)
            val_err = self.evaluate(state, self.val_idx)
            if plateau is not None:
                new_scale = plateau.step(val_err)
                if new_scale != plateau_logged:
                    state = state._replace(opt_state=set_plateau_scale(
                        state.opt_state, new_scale))
                plateau_logged = new_scale
            if best_val is None or val_err <= best_val:
                best_val = val_err
                if epoch0 + epoch >= self.tcfg.ckpt_after_epoch:
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
                "epoch": epoch0 + epoch + 1,
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
                if "pairs" in tot:
                    # pair slots: what the attention kernels' work scales
                    # with (the tier windows of a planned batch)
                    real_p, cap_p = tot["pairs"]
                    record["occupancy_pairs"] = real_p / max(cap_p, 1)
            if plateau_logged is not None:
                record["lr_scale"] = plateau_logged
            with open(jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")
            with open(log_path, "a") as f:
                f.write(
                    f"{time.strftime('%m_%d_%H_%M_%S')}"
                    f"\t[epoch]:{epoch0 + epoch + 1:03d}"
                    f"\t[Loss]:{loss:.7f}"
                    f"\t[ValMAE]:{val_err:.7f}"
                    f"\t[TestMAE]:"
                    f"{test_err if test_err is not None else -1.0:.7f}"
                    "\n")
        return state, {"best_val_mae": best_val, "test_mae": test_err}
