"""The port's data parallelism (x2gnn_tpu_torch/parallel/mesh.py,
data_parallel.py, the Trainer's mesh mode) on 1, 2 and 4 gloo ranks on
the CPU, against the JAX package's make_dp_train_step /
make_dp_eval_step / Trainer(mesh) on a 4-device CPU mesh and against the
port's single-process gradients of the ranks' batches: the counterparts
of tests/test_parallel.py."""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_model import one_torch_thread  # noqa: F401
from torch_port_ranks import Ranks, dp_cases, jobs, mesh_errors, trainer_fit
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.config import TrainConfig as JaxTrainConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.parallel import data_parallel as jdp
from x2gnn_tpu.parallel import make_mesh as jmake_mesh
from x2gnn_tpu.train import ema as jema
from x2gnn_tpu.train import optim as joptim
from x2gnn_tpu.train.trainer import Trainer as JaxTrainer
from x2gnn_tpu.train.trainer import TrainState as JaxTrainState
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.ops.attention import dropout_generator
from x2gnn_tpu_torch.parallel import dp_batch_iterator, empty_like_batch
from x2gnn_tpu_torch.train.loss import smooth_l1_loss
from x2gnn_tpu_torch.train.trainer import Trainer
from x2gnn_tpu_torch.weights import export_flax_params, load_flax_params

CFG = dict(conv_layers=1, in_channels=32, embedding_size=32, heads=4,
           sbf_dim=3, rbf_dim=4, edge_feat_dim=8, attention_layout="blocked")
TCFG = dict(batch_size=2, max_lr=1e-3, warmup_steps=5, grad_clip=True,
            max_grad=100.0, ema_decay=0.9)
WORLDS = (1, 2, 4)
STD = 2.0

# The reduced gradients against the count-weighted mean of the
# single-process gradients of the ranks' batches: the same float32 math,
# summed in another order: each parameter's
# gradient within 1e-4 of its own magnitude plus 1e-5 of its largest (the
# port's layouts against one another); lin_key's bias, 0 in exact
# arithmetic, within 1e-6 absolute.
GRAD_RTOL, GRAD_ATOL, NOISE_ATOL = 1e-4, 1e-5, 1e-6
# Parameters after one step against the JAX step: Adam's first update
# divides each gradient by its own magnitude, so rounding in a near-zero
# gradient moves its parameter by up to lr; tests/test_parallel.py holds
# its DP step against a serial one at these bounds.
STEP_RTOL, STEP_ATOL = 1e-3, 1e-5
# At one rank the weighting computes (g·cnt)/cnt: one rounding per
# element, so the gradients are within 2 float32 ulps of the plain ones.
ONE_RANK_RTOL = 2.5e-7
# Whole runs, epoch by epoch: 1e-3 relative, as the port's two-epoch runs
# against JAX (tests/test_torch_port_train.py).
RUN_RTOL = 1e-3


def _graphs(n, seed):
    return synthetic_dataset(n, mean_atoms=6, seed=seed, edge_feat_dim=8,
                             target="random")


def _flat():
    return export_flax_params(X2GNN(ModelConfig(**CFG),
                                    torch.Generator().manual_seed(0),
                                    device="cpu"))


def _flax_tree(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(value)
    return {"params": tree}


def _assert_grads(got, want, rtol, atol, what=""):
    assert set(got) == set(want)
    for path in want:
        w, g = np.asarray(want[path]), np.asarray(got[path])
        if path.endswith("lin_key/Dense_0/bias"):
            np.testing.assert_allclose(g, w, atol=NOISE_ATOL,
                                       err_msg=f"{what} {path}")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol,
                                       atol=atol * np.abs(w).max(),
                                       err_msg=f"{what} {path}")


@pytest.fixture(scope="module")
def data():
    """8 molecules in 4 batches of 2 at one set of budgets, and the
    weights of a seeded port model."""
    graphs = _graphs(8, seed=21)
    bud = pad_budget_for(graphs, 2)
    batches = [pad_graphs(graphs[2 * i:2 * i + 2], bud,
                          targets=np.array([g.y[0] for g in
                                            graphs[2 * i:2 * i + 2]],
                                           np.float32))
               for i in range(4)]
    return graphs, bud, batches, _flat()


def _cases(batches, world):
    """(name, the batches of the ranks) of each case on `world` ranks: one
    batch per rank; on 4, also 3 batches (the last rank gets a filler)
    and a NaN target on rank 0's batch."""
    cases = [("full", batches[:world])]
    if world == 4:
        nan = dataclasses.replace(batches[0],
                                  y=np.full_like(batches[0].y, np.nan))
        cases += [("ragged", batches[:3]), ("nan", [nan] + batches[1:])]
    return cases


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    """Each world size's ranks at once: `dp_cases`; on 2 ranks also the
    mesh refusals; on 4 also Trainer.fit in data-parallel mode (12
    molecules at batch 2: 5 training batches, a ragged last group)."""
    graphs, _, batches, flat = data
    tmp = tmp_path_factory.mktemp("dp")
    train = _graphs(12, seed=22)
    targets = np.array([g.y[0] for g in train], np.float32)
    calls = {w: [(dp_cases, (CFG, flat, TCFG, _cases(batches, w), STD))]
             for w in WORLDS}
    calls[2].append((mesh_errors, ()))
    calls[4].append((trainer_fit, (CFG, flat, train, targets,
                                   {**TCFG, "ckpt_after_epoch": 0},
                                   str(tmp / "dp_run"), None, 0, 2)))
    started = {w: Ranks(jobs, w, tmp, c) for w, c in calls.items()}
    return {w: r.wait() for w, r in started.items()}, tmp, train, targets


def _weighted_grads(flat, batches):
    """The count-weighted mean of the single-process gradients of each
    batch's mean loss, by flax path, and the loss so weighted: the mean
    over the batches' real molecules. (The embedding's gradient divides
    by each index's count in its own batch, torch's scale_grad_by_freq,
    so it is not the gradient of the union padded into one batch.)"""
    model = X2GNN(ModelConfig(**CFG), device="cpu")
    load_flax_params(model, flat)
    names = [n for n, _ in model.named_parameters()]
    total, loss_sum, acc = 0, 0.0, None
    for b in batches:
        batch = b.to("cpu")
        cnt = int(batch.graph_mask.sum())
        loss = smooth_l1_loss(model(batch), batch.y, mask=batch.graph_mask)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    materialize_grads=True)
        g = export_flax_params(model, dict(zip(names, grads)))
        acc = ({k: v.astype(np.float64) * cnt for k, v in g.items()}
               if acc is None else {k: acc[k] + g[k] * cnt for k in acc})
        total += cnt
        loss_sum += float(loss.detach()) * cnt
    return loss_sum / total, {k: v / total for k, v in acc.items()}


def test_mesh_lays_out_every_rank(ranks):
    out, _, _, _ = ranks
    for world, res in out.items():
        for rank, r in enumerate(res):
            shape, names, index, count = r[0]["mesh"]
            assert shape == (world,) and names == ("data",)
            assert index == rank and count == world
    for errors in (r[1] for r in out[2]):
        assert "n_devices=3" in errors[0] and "dp*ep = 9" in errors[1]


@pytest.mark.parametrize("world", WORLDS)
def test_dp_gradients_are_the_count_weighted_mean(data, ranks, world):
    """Each rank's gradient of its own batch, weighted by its real graph
    count and all-reduced, is the count-weighted mean of the
    single-process gradients of the ranks' batches (data_parallel.py:
    109-114), and the loss the mean over all their molecules."""
    _, _, batches, flat = data
    out, _, _, _ = ranks
    loss, want = _weighted_grads(flat, batches[:world])
    for r in out[world]:
        np.testing.assert_allclose(r[0]["full"]["loss"], loss, rtol=1e-6)
        _assert_grads(r[0]["full"]["grads"], want, GRAD_RTOL, GRAD_ATOL)


def test_ragged_group_filler_changes_nothing(data, ranks):
    """4 ranks, 3 batches: the last rank's all-masked filler weighs
    nothing."""
    _, _, batches, flat = data
    out, _, _, _ = ranks
    loss, want = _weighted_grads(flat, batches[:3])
    filler = empty_like_batch(batches[2])
    assert not filler.graph_mask.any() and not filler.node_mask.any()
    for r in out[4]:
        np.testing.assert_allclose(r[0]["ragged"]["loss"], loss, rtol=1e-6)
        _assert_grads(r[0]["ragged"]["grads"], want, GRAD_RTOL, GRAD_ATOL)
        assert r[0]["ragged"]["step"][2] == 6     # real graphs of the step


def _jax_state(flat, tcfg):
    params = _flax_tree(flat)
    opt = joptim.make_optimizer(tcfg)
    return opt, JaxTrainState(params, opt.init(params), jema.ema_init(params),
                              jnp.zeros((), jnp.int32),
                              jnp.zeros((), jnp.int32))


def _jax_batches(graphs, bud, batches):
    return [jbatching.pad_graphs(graphs[2 * i:2 * i + 2],
                                 jbatching.Budgets(*bud),
                                 targets=np.asarray(b.y, np.float32),
                                 with_triplets=False)
            for i, b in enumerate(batches)]


@pytest.mark.parametrize("world", WORLDS)
def test_dp_step_matches_jax(data, ranks, world):
    """One DP step from the same weights on the same batches: the loss
    and every parameter against JAX make_dp_train_step on `world`
    virtual devices; every rank holds the same bits."""
    graphs, bud, batches, flat = data
    out, _, _, _ = ranks
    jcfg = JaxModelConfig(**CFG, use_pallas=False)
    tcfg = JaxTrainConfig(**TCFG)
    opt, state = _jax_state(flat, tcfg)
    mesh = jmake_mesh(world)
    jb = _jax_batches(graphs, bud, batches)[:world]
    step = jdp.make_dp_train_step(JaxX2GNN(jcfg), opt, tcfg.ema_decay,
                                  mesh)
    new, loss = step(state, jdp.shard_batches(jb, mesh))
    want = {k: np.asarray(v, np.float32)
            for k, v in export_params_flat(new.params).items()}
    params, got_loss, _, bad = out[world][0][0]["full"]["step"]
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    assert bad == 0
    for path in want:
        np.testing.assert_allclose(params[path], want[path], rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=path)
    for r in out[world][1:]:
        for path in params:
            np.testing.assert_array_equal(r[0]["full"]["step"][0][path],
                                          params[path])


@pytest.mark.parametrize("world", WORLDS)
def test_dp_step_is_bitwise_on_a_rerun(ranks, world):
    out, _, _, _ = ranks
    for r in out[world]:
        assert all(r[0][name]["rerun_equal"] for name in r[0]
                   if name != "mesh")


def test_one_rank_is_the_plain_step_within_rounding(data, ranks):
    """World size 1: (g·cnt)/cnt is g up to one rounding, not bit for
    bit."""
    graphs, _, batches, flat = data
    out, _, _, _ = ranks
    model = X2GNN(ModelConfig(**CFG), device="cpu")
    load_flax_params(model, flat)
    batch = batches[0].to("cpu")
    loss = smooth_l1_loss(model(batch), batch.y, mask=batch.graph_mask)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                materialize_grads=True)
    names = [n for n, _ in model.named_parameters()]
    want = export_flax_params(model, dict(zip(names, grads)))
    got = out[1][0][0]["full"]["grads"]
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=ONE_RANK_RTOL,
                                   atol=0, err_msg=path)


def test_dp_eval_psum(data, ranks):
    """The DP eval step's all-reduced (sum |err|·std, count) against JAX
    make_dp_eval_step on 4 virtual devices."""
    graphs, bud, batches, flat = data
    out, _, _, _ = ranks
    mesh = jmake_mesh(4)
    jcfg = JaxModelConfig(**CFG, use_pallas=False)
    err, cnt = jdp.make_dp_eval_step(JaxX2GNN(jcfg), mesh, std=STD)(
        _flax_tree(flat), jdp.shard_batches(
            _jax_batches(graphs, bud, batches), mesh))
    for r in out[4]:
        got_err, got_cnt = r[0]["full"]["eval"]
        assert got_cnt == float(cnt) == 8
        np.testing.assert_allclose(got_err, float(err), rtol=1e-5)


def test_dp_nonfinite_loss_skips_update_and_counts(data, ranks):
    """A NaN target on rank 0 makes the global loss NaN: every rank keeps
    its parameters, bit for bit, and counts a bad step."""
    _, _, _, flat = data
    out, _, _, _ = ranks
    for r in out[4]:
        params, loss, _, bad = r[0]["nan"]["step"]
        assert not np.isfinite(loss) and bad == 1
        for path in flat:
            np.testing.assert_array_equal(params[path], flat[path])


def test_dropout_generator_folds_the_rank():
    """Rank 0 draws the single-device Trainer's masks, other ranks other
    ones; a step's masks repeat."""
    from x2gnn_tpu_torch.ops.attention import pair_dropout_mask
    model = X2GNN(ModelConfig(**CFG), device="cpu")
    trainer = Trainer(model, model.config, TrainConfig(), [], np.zeros(0),
                      device="cpu")

    def mask(gen):
        return pair_dropout_mask(gen, 0.3, 4, 8, 4)

    ref = mask(trainer.dropout_generator(7))
    np.testing.assert_array_equal(mask(dropout_generator(41, 7, "cpu", 0)),
                                  ref)
    np.testing.assert_array_equal(mask(dropout_generator(41, 7, "cpu", 1)),
                                  mask(dropout_generator(41, 7, "cpu", 1)))
    for rank in (1, 2, 3):
        assert not np.array_equal(mask(dropout_generator(41, 7, "cpu", rank)),
                                  ref)


def test_dp_batch_iterator_fills_the_last_group(data):
    _, _, batches, _ = data
    for world in (2, 4):
        for rank in range(world):
            got = list(dp_batch_iterator(batches[:3], world, rank))
            assert len(got) == -(-3 // world)
            for g, i in zip(got, range(rank, 3 + world, world)):
                if i < 3:
                    assert g is batches[i]
                else:
                    assert not g.graph_mask.any() and not g.y.any()
                    assert g.edge_feat.shape == batches[2].edge_feat.shape


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_with_mesh(ranks):
    """Trainer(mesh=) over 4 ranks for 2 epochs (a ragged last group of
    each epoch and of the validation split) trains as the JAX
    Trainer(mesh=) on 4 virtual devices does from the same weights (the
    single-process Trainer takes one step per batch, not per group); the
    ranks end with the same parameters; rank 0 alone wrote the run
    directory."""
    out, tmp, train, targets = ranks
    fits = [r[1] for r in out[4]]
    for summary, _, spe in fits:
        assert np.isfinite(summary["best_val_mae"]) and spe == 2
    for r in fits[1:]:
        for a, b in zip(fits[0][1], r[1]):
            np.testing.assert_array_equal(a, b)
    got = _records(tmp / "dp_run")
    assert len(got) == 2 and all(r["bad_steps"] == 0 for r in got)
    assert [r["step"] for r in got] == [2, 4]
    tcfg = {**TCFG, "ckpt_after_epoch": 0}
    jcfg = JaxModelConfig(**CFG, use_pallas=False)
    jt = JaxTrainer(JaxX2GNN(jcfg), jcfg, JaxTrainConfig(**tcfg), train,
                    targets, workdir=str(tmp / "jax"), mesh=jmake_mesh(4))
    st = jt.init_state()
    params = _flax_tree(_flat())
    st = st._replace(params=params, opt_state=jt.optimizer.init(params),
                     ema=jema.ema_init(params))
    jt.init_state = lambda: jax.tree_util.tree_map(jnp.copy, st)
    jt.fit(epochs=2)
    want = _records(tmp / "jax")
    assert len(want) == 2
    for g, w in zip(got, want):
        for key in ("loss", "val_mae", "best_val_mae", "step"):
            np.testing.assert_allclose(g[key], w[key], rtol=RUN_RTOL,
                                       err_msg=key)
