"""Run a function on every rank of a small gloo process group, one spawned
process per rank, for the port's parallel tests (tests/test_torch_port_
parallel*.py, ..._ep_model.py, ..._hybrid.py).

`Ranks(fn, world, tmp_path, *args)` starts `world` processes with
torch.multiprocessing's spawn method and returns, so that several groups
run at once; each joins a gloo group through a file store under
`tmp_path` (no TCP port) with the port's own
`parallel.mesh.initialize_distributed`, runs fn(rank, world, *args) on
one torch thread and pickles what it returns. `wait()` waits with a
deadline, stops every rank as soon as one fails or the deadline passes,
raises with the failing ranks' tracebacks, and returns what each rank
returned. `fn` must be importable (a module-level function), and so must
everything in `args`. This module imports no JAX: the ranks start faster
without it.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(fn, rank, world, run_dir, args):
    from x2gnn_tpu_torch.parallel import initialize_distributed
    torch.set_num_threads(1)
    try:
        # the product's own group creation: its explicit-coordinator
        # branch, gloo for the CPU; `Ranks.wait`'s deadline stops a hung
        # rank
        initialize_distributed(f"file://{run_dir}/store", world, rank,
                               device="cpu")
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(run_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(run_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


class Ranks:
    """`world` spawned processes running fn(rank, world, *args); `wait`
    returns what each returned, in rank order."""

    def __init__(self, fn, world: int, tmp_path, *args,
                 timeout: float = 300.0):
        self.world, self.timeout = world, timeout
        self.run_dir = tempfile.mkdtemp(dir=tmp_path, prefix="ranks")
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(fn, r, world, self.run_dir, args))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def wait(self) -> list:
        procs = self.procs
        try:
            while any(p.is_alive() for p in procs):
                failed = any(p.exitcode not in (None, 0) for p in procs)
                if failed or time.monotonic() > self.deadline:
                    break
                time.sleep(0.05)
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        errors = []
        for r in range(self.world):
            err = os.path.join(self.run_dir, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad or errors:
            what = (f"ranks {hung} still running after {self.timeout} s; "
                    if hung and not errors else "")
            raise AssertionError(f"{what}ranks {bad} failed\n"
                                 + "\n".join(errors))
        out = []
        for r in range(self.world):
            with open(os.path.join(self.run_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ---- what the ranks run ----------------------------------------------------

def jobs(rank, world, calls):
    """Several functions on the same ranks, one start-up: [fn(rank, world,
    *args) for fn, args in calls]."""
    return [fn(rank, world, *args) for fn, args in calls]


def _model(cfg_kw, flat):
    from x2gnn_tpu_torch.config import ModelConfig
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.weights import load_flax_params
    model = X2GNN(ModelConfig(**cfg_kw), device="cpu")
    load_flax_params(model, flat)
    return model


def _numpy(t):
    return t.detach().cpu().numpy()


def _reduced_gradients(model, loss, count):
    """The true gradients of the step's loss by flax path, and the global
    loss: `reduced_gradients`, as the parallel steps take them."""
    from x2gnn_tpu_torch.parallel.data_parallel import reduced_gradients
    from x2gnn_tpu_torch.train.ema import unflatten
    from x2gnn_tpu_torch.weights import export_flax_params
    leaves = list(model.parameters())
    flat, total_loss, _ = reduced_gradients(loss, leaves, count)
    names = [n for n, _ in model.named_parameters()]
    return float(total_loss), export_flax_params(
        model, dict(zip(names, unflatten(flat, leaves))))


def ep_cases(rank, world, cases):
    """Each case {name, cfg, flat, batch, modes[, masks]}: the EP forward
    of `batch` (a host GraphBatch) split over the ranks, in each exchange
    mode, with the loss and its reduced gradients; `masks`, global
    (N, D, D, H) keep masks, one per conv, are cut to this rank's atoms.
    Returns {name: {mode: (pred, loss, grads)}}."""
    from x2gnn_tpu_torch.parallel import (
        make_ep_batch, make_ep_forward, make_mesh, shard_ep_batch)
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss
    mesh = make_mesh()
    out = {}
    for case in cases:
        model = _model(case["cfg"], case["flat"])
        epb = make_ep_batch(case["batch"], world)
        local = shard_ep_batch(epb, mesh, "cpu")
        n = epb.numbers.shape[0]
        masks = None
        if case.get("masks") is not None:
            lo, hi = rank * n // world, (rank + 1) * n // world
            masks = [torch.from_numpy(np.pad(
                m, [(0, n - m.shape[0])] + [(0, 0)] * 3)[lo:hi])
                for m in case["masks"]]
        res = {}
        for mode in case["modes"]:
            pred = make_ep_forward(mesh, mode)(model, local,
                                               dropout_masks=masks)
            loss = smooth_l1_loss(pred, local.y, mask=local.graph_mask)
            total, grads = _reduced_gradients(model, loss,
                                              local.graph_mask.sum())
            res[mode] = (_numpy(pred), total, grads)
        out[case["name"]] = res
    return out


def ep_exchange(rank, world, x, cot, batch):
    """The row exchange of the rows x (N*D, C) of `batch`'s EP layout,
    split over the ranks, in both modes: {mode: (this rank's output
    rows, this rank's rows of the gradient of sum(out * cot))}."""
    from x2gnn_tpu_torch.parallel import make_ep_batch, make_mesh
    from x2gnn_tpu_torch.parallel.ep_model import _Axis, exchange
    mesh = make_mesh()
    epb = make_ep_batch(batch, world)
    local = epb.shard(rank, world).to("cpu")
    n, d = epb.in_mask.shape
    rows = slice(rank * n // world * d, (rank + 1) * n // world * d)
    out = {}
    for mode in ("allgather", "ring"):
        xl = torch.from_numpy(x[rows]).requires_grad_(True)
        got = exchange(xl, local, _Axis.of(mesh, mode))
        cl = torch.from_numpy(cot[rows].reshape(got.shape))
        (dx,) = torch.autograd.grad((got * cl).sum(), xl)
        out[mode] = (_numpy(got), _numpy(dx))
    return out


def ep_attention_op(rank, world, inputs, cot, heads):
    """make_ep_blocked_attention on this rank's pieces of `inputs` (q, k,
    v, G split by edges; e_atom, cbf, in/out_edges, pair_mask by atoms;
    s_bias whole): (this rank's output, the gradients of sum(out * cot)
    with respect to its pieces of q, k, v, e_atom, G)."""
    from x2gnn_tpu_torch.parallel import make_ep_blocked_attention, make_mesh
    names = ("q", "k", "v", "e_atom", "G", "s_bias", "cbf", "in_edges",
             "out_edges", "pair_mask")
    local = {}
    for name in names:
        a = torch.from_numpy(inputs[name])
        if name != "s_bias":
            step = a.shape[0] // world
            a = a[rank * step:(rank + 1) * step]
        if a.is_floating_point() and name in ("q", "k", "v", "e_atom", "G"):
            a.requires_grad_(True)
        local[name] = a
    out = make_ep_blocked_attention(make_mesh(), heads)(
        *[local[n] for n in names])
    step = cot.shape[0] // world
    c = torch.from_numpy(cot[rank * step:(rank + 1) * step])
    grads = torch.autograd.grad((out * c).sum(), [
        local[n] for n in ("q", "k", "v", "e_atom", "G")])
    return _numpy(out), [_numpy(g) for g in grads]


def _fresh_state(model, tcfg):
    from x2gnn_tpu_torch.train.ema import ema_init
    from x2gnn_tpu_torch.train.optim import Optimizer
    from x2gnn_tpu_torch.train.trainer import TrainState
    opt = Optimizer(tcfg)
    leaves = list(model.parameters())
    zero = torch.zeros((), dtype=torch.int32)
    return opt, TrainState(leaves, opt.init(leaves), ema_init(leaves), zero,
                           zero.clone())


def ep_steps(rank, world, cfg_kw, flat, batch, tcfg_kw, steps, mode):
    """`steps` EP training steps on one batch: (losses, step count, the
    step's real graphs, the parameters after the first step, the same
    again from the same start)."""
    from x2gnn_tpu_torch.config import TrainConfig
    from x2gnn_tpu_torch.parallel import (
        make_ep_batch, make_ep_train_step, make_mesh, shard_ep_batch)
    from x2gnn_tpu_torch.utils.determinism import copy_tree
    model = _model(cfg_kw, flat)
    mesh = make_mesh()
    epb = make_ep_batch(batch, world)
    local = shard_ep_batch(epb, mesh, "cpu")
    tcfg = TrainConfig(**tcfg_kw)
    opt, state = _fresh_state(model, tcfg)
    step = make_ep_train_step(model, opt, tcfg.ema_decay, mesh, mode,
                              tcfg.random_seed)
    start = copy_tree(state)
    losses, firsts = [], []
    for _ in range(steps):
        state, loss, count = step(state, local)
        losses.append(float(loss))
        if not firsts:
            firsts.append([_numpy(p).copy() for p in state.params])
    with torch.no_grad():
        for p, v in zip(state.params, start.params):
            p.copy_(v)
    again, _, _ = step(start._replace(params=state.params), local)
    firsts.append([_numpy(p).copy() for p in again.params])
    return losses, int(state.step), float(count), firsts


def trainer_fit(rank, world, cfg_kw, flat, graphs, targets, tcfg_kw,
                workdir, mode, dp_groups, epochs):
    """Trainer.fit over a mesh: data parallelism (mode None), edge
    partitioning (mode "allgather"/"ring") or, with dp_groups, DP x EP;
    every rank trains, rank 0 writes `workdir`. Returns (summary, the
    final parameters, the first step's rank-local batch count)."""
    from x2gnn_tpu_torch.config import TrainConfig
    from x2gnn_tpu_torch.parallel import make_hybrid_mesh, make_mesh
    from x2gnn_tpu_torch.train.trainer import Trainer
    model = _model(cfg_kw, flat)
    mesh = (make_hybrid_mesh(dp_groups, world // dp_groups) if dp_groups
            else make_mesh())
    trainer = Trainer(model, model.config, TrainConfig(**tcfg_kw), graphs,
                      targets, workdir=workdir, device="cpu", mesh=mesh,
                      edge_partition=mode)
    _, summary = trainer.fit(epochs=epochs)
    return summary, [_numpy(p).copy() for p in model.parameters()], \
        trainer.steps_per_epoch()


def dp_cases(rank, world, cfg_kw, flat, tcfg_kw, cases, std):
    """Data parallelism: the mesh this rank sees, then for each case
    (name, host batches, one per rank or fewer: the last ranks get
    fillers) this rank's reduced gradients and loss, the DP step from
    `flat` twice (the parameters by flax path, loss, real graphs and
    bad_steps after it; whether the rerun gave the same bits) and the DP
    eval step's (sum |err|·std, count) on the starting weights."""
    from x2gnn_tpu_torch.config import TrainConfig
    from x2gnn_tpu_torch.parallel import (
        device_count, dp_batch_iterator, make_dp_eval_step,
        make_dp_train_step, make_mesh)
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss
    from x2gnn_tpu_torch.weights import export_flax_params, load_flax_params
    mesh = make_mesh()
    out = {"mesh": (mesh.shape, mesh.axis_names, mesh.axis_index("data"),
                    device_count())}
    model = _model(cfg_kw, flat)
    tcfg = TrainConfig(**tcfg_kw)
    for name, batches in cases:
        batch = next(dp_batch_iterator(batches, world, rank)).to("cpu")
        with torch.no_grad():
            err, cnt = make_dp_eval_step(model, mesh, std)(
                dict(model.named_parameters()), batch)
        loss = smooth_l1_loss(model(batch), batch.y, mask=batch.graph_mask)
        total_loss, grads = _reduced_gradients(model, loss,
                                               batch.graph_mask.sum())
        steps = []
        for _ in range(2):
            load_flax_params(model, flat)
            opt, state = _fresh_state(model, tcfg)
            step = make_dp_train_step(model, opt, tcfg.ema_decay, mesh)
            state, loss, total = step(state, batch)
            steps.append(({k: v.copy() for k, v in
                           export_flax_params(model).items()}, float(loss),
                          float(total), int(state.bad_steps)))
        load_flax_params(model, flat)
        same = all(np.array_equal(steps[0][0][k], steps[1][0][k])
                   for k in steps[0][0]) and np.array_equal(
                       steps[0][1:], steps[1][1:], equal_nan=True)
        out[name] = dict(grads=grads, loss=total_loss, step=steps[0],
                         rerun_equal=same, eval=(float(err), float(cnt)))
    return out


def mesh_errors(rank, world):
    """The mesh constructors' refusals on this world size."""
    from x2gnn_tpu_torch.parallel import make_hybrid_mesh, make_mesh
    out = []
    for make in (lambda: make_mesh(world + 1),
                 lambda: make_hybrid_mesh(3, 3)):
        try:
            make()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def hybrid_cases(rank, world, dp, cases, tcfg_kw, steps, std):
    """DP x EP on a (dp, world // dp) layout: the layout this rank sees,
    then for each case {name, cfg, flat, batches (one host GraphBatch per
    row), modes}: per mode this row's predictions, the global loss and its
    reduced gradients; the eval step's (sum |err|·std, count) on the
    starting weights; `steps` hybrid training steps from `flat` (ring):
    their losses, the parameters after them, and whether a rerun of the
    first step gave the same bits."""
    from x2gnn_tpu_torch.config import TrainConfig
    from x2gnn_tpu_torch.parallel import (
        make_ep_batch, make_hybrid_eval_step, make_hybrid_forward,
        make_hybrid_mesh, make_hybrid_train_step, shard_hybrid_batch,
        stack_ep_batches)
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss
    from x2gnn_tpu_torch.weights import load_flax_params
    ep = world // dp
    mesh = make_hybrid_mesh(dp, ep)
    out = {"mesh": (mesh.axis_names, mesh.shape, mesh.axis_index("dp"),
                    mesh.axis_index("data"), mesh.axis_ranks("dp"),
                    mesh.axis_ranks("data"))}
    tcfg = TrainConfig(**tcfg_kw)
    for case in cases:
        model = _model(case["cfg"], case["flat"])
        stacked = stack_ep_batches([make_ep_batch(b, ep)
                                    for b in case["batches"]])
        local = shard_hybrid_batch(stacked, mesh, "cpu")
        res = {}
        for mode in case["modes"]:
            pred = make_hybrid_forward(mesh, mode)(model, local)
            loss = smooth_l1_loss(pred, local.y, mask=local.graph_mask)
            total, grads = _reduced_gradients(model, loss,
                                              local.graph_mask.sum())
            res[mode] = (_numpy(pred), total, grads)
        with torch.no_grad():
            err, cnt = make_hybrid_eval_step(model, mesh, std)(
                dict(model.named_parameters()), local)
        res["eval"] = (float(err), float(cnt))
        firsts, losses = [], []
        for rerun in (False, True):
            load_flax_params(model, case["flat"])
            opt, state = _fresh_state(model, tcfg)
            step = make_hybrid_train_step(model, opt, tcfg.ema_decay, mesh,
                                          "ring", tcfg.random_seed)
            for i in range(1 if rerun else steps):
                state, loss, _ = step(state, local)
                if i == 0:
                    firsts.append(([_numpy(p).copy() for p in state.params],
                                   float(loss)))
                if not rerun:
                    losses.append(float(loss))
            if not rerun:
                final = [_numpy(p).copy() for p in state.params]
        res["rerun_equal"] = firsts[0][1] == firsts[1][1] and all(
            np.array_equal(a, b) for a, b in zip(firsts[0][0], firsts[1][0]))
        res["steps"] = (losses, final)
        out[case["name"]] = res
    return out


def spoiled(rank, world, spoil, fn, args):
    """fn(rank, world, *args), one of chip_smoke.py's --multi-card rank
    functions, with one input spoiled on one rank: "ulp" rank 1's
    parameters one ulp off where their digest is taken, "grad" one
    gradient of rank 2's plain reference off by 1e-2 of its largest
    magnitude, "ring" rank 0's ring exchange scaled by 1 + 2^-20. Returns
    the message of the AssertionError that fn raised, or None."""
    import chip_smoke
    from x2gnn_tpu_torch.parallel import ep_model
    patched = []

    def patch(module, name, fn):
        patched.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    digest, group_grads = chip_smoke.params_digest, chip_smoke.group_grads
    gather_rows = ep_model._gather_rows
    if spoil == "ulp" and rank == 1:
        def off_digest(leaves):
            first = leaves[0].detach().clone().reshape(-1)
            first[0] = torch.nextafter(first[0], torch.tensor(np.inf))
            return digest([first] + list(leaves[1:]))
        patch(chip_smoke, "params_digest", off_digest)
    if spoil == "grad" and rank == 2:
        def off_grads(model, group, device):
            loss, ref = group_grads(model, group, device)
            name = next(n for n in ref if not n.endswith("lin_key.bias"))
            g = ref[name].clone()
            g.view(-1)[0] += 1e-2 * float(g.abs().max())
            return loss, {**ref, name: g}
        patch(chip_smoke, "group_grads", off_grads)
    if spoil == "ring" and rank == 0:
        def off_rows(x, ids, take, axis):
            out = gather_rows(x, ids, take, axis)
            return out * (1 + 2 ** -20) if axis.mode == "ring" else out
        patch(ep_model, "_gather_rows", off_rows)
    try:
        fn(rank, world, *args)
        return None
    except AssertionError as e:
        return str(e)
    finally:
        for module, name, value in patched:
            setattr(module, name, value)
