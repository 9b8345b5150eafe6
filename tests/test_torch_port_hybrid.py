"""The port's hybrid DP x EP (x2gnn_tpu_torch/parallel/hybrid.py) on a 2x2
layout of 4 gloo ranks on the CPU, against the JAX package's make_hybrid_*
on 4 virtual devices and against the port's single-process model with the
same weights and batches: the counterparts of tests/test_hybrid.py."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_model import one_torch_thread  # noqa: F401
from torch_port_ranks import Ranks, hybrid_cases, jobs, mesh_errors, \
    trainer_fit
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.config import TrainConfig as JaxTrainConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.parallel import hybrid as jhybrid
from x2gnn_tpu.parallel.ep_model import make_ep_batch as jmake_ep_batch
from x2gnn_tpu.train import ema as jema
from x2gnn_tpu.train import loss as jloss
from x2gnn_tpu.train import optim as joptim
from x2gnn_tpu.train.trainer import TrainState as JaxTrainState
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.train.loss import smooth_l1_loss
from x2gnn_tpu_torch.weights import export_flax_params, load_flax_params

CFG = dict(conv_layers=2, in_channels=32, embedding_size=32, heads=4,
           sbf_dim=3, rbf_dim=4, edge_feat_dim=8, attention_layout="blocked")
DP, EP = 2, 2
MODES = ("allgather", "ring")
TCFG = dict(batch_size=3, warmup_steps=2)
STEPS = 4
STD = 2.0

# The split model against the single-process one (tests/
# test_torch_port_ep_model.py states the reasons): predictions within 1e-5
# relative plus 1e-6 of the largest, gradients within 1e-4 of their own
# magnitude plus 1e-5 of their largest, lin_key's bias (0 in exact
# arithmetic) within 1e-6 absolute; against JAX, its model-parity and
# training tolerances. Losses over several steps or epochs: 1e-3
# relative, as the port's two-epoch runs against JAX.
PRED_RTOL, PRED_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL, NOISE_ATOL = 1e-4, 1e-5, 1e-6
JAX_PRED_RTOL, JAX_PRED_ATOL = 2e-5, 2e-6
JAX_GRAD_RTOL, JAX_GRAD_ATOL = 1e-3, 1e-4
RUN_RTOL = 1e-3


def _flat(cfg_kw):
    return export_flax_params(X2GNN(ModelConfig(**cfg_kw),
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
    """Two groups of 3 molecules at one set of budgets (tests/
    test_hybrid.py:_setup), the seeded weights of the plain and the
    dropout model."""
    groups = [synthetic_dataset(3, mean_atoms=8, seed=7 + i, edge_feat_dim=8)
              for i in range(DP)]
    bud = pad_budget_for([g for gs in groups for g in gs], 3)
    batches = [pad_graphs(gs, bud) for gs in groups]
    return groups, bud, batches, _flat(CFG)


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    """At once: on the 2x2 layout `hybrid_cases` (the plain model in both
    exchanges; with dropout 0.35), the layout refusals, and Trainer.fit in
    DP x EP mode (18 molecules at batch 4: 4 training batches, 2 steps an
    epoch, a ragged validation group); on 2 ranks Trainer.fit in plain
    data parallelism on the same data."""
    groups, bud, batches, flat = data
    tmp = tmp_path_factory.mktemp("hybrid")
    cases = [dict(name="plain", cfg=CFG, flat=flat, batches=batches,
                  modes=MODES),
             dict(name="dropout", cfg={**CFG, "dropout": 0.35}, flat=flat,
                  batches=batches, modes=())]
    train = synthetic_dataset(18, mean_atoms=8, seed=3, edge_feat_dim=8)
    targets = np.array([g.y[0] for g in train], np.float32)
    tcfg = dict(batch_size=4, warmup_steps=4, ckpt_after_epoch=0)
    hybrid = Ranks(jobs, 4, tmp, [
        (hybrid_cases, (DP, cases, TCFG, STEPS, STD)), (mesh_errors, ()),
        (trainer_fit, (CFG, flat, train, targets, tcfg,
                       str(tmp / "hybrid_run"), "allgather", DP, 3))])
    dp = Ranks(trainer_fit, 2, tmp, CFG, flat, train, targets, tcfg,
               str(tmp / "dp_run"), None, 0, 3)
    return hybrid.wait(), dp.wait(), tmp


def _jax_setup(groups, bud, flat, cfg=CFG):
    jcfg = JaxModelConfig(**cfg, use_pallas=False)
    jb = [jbatching.pad_graphs(gs, jbatching.Budgets(*bud),
                               with_triplets=False) for gs in groups]
    mesh = jhybrid.make_hybrid_mesh(DP, EP, jax.devices()[:DP * EP])
    stacked = jhybrid.stack_ep_batches([jmake_ep_batch(b, EP) for b in jb])
    sharded = jhybrid.shard_hybrid_batch(stacked, mesh)
    return jcfg, jb, mesh, stacked, sharded, _flax_tree(flat)


def test_hybrid_layout(ranks):
    """Rank r sits at row r // 2, column r % 2; each row is an EP group,
    each column a DP group; make_hybrid_mesh(3, 3) on 4 ranks raises."""
    hybrid, _, _ = ranks
    for rank, r in enumerate(hybrid):
        names, shape, row, col, dp_ranks, ep_ranks = r[0]["mesh"]
        assert names == ("dp", "data") and shape == (DP, EP)
        assert (row, col) == divmod(rank, EP)
        assert dp_ranks == (col, col + EP)
        assert ep_ranks == (row * EP, row * EP + 1)
        assert "dp*ep = 9" in r[1][1]


@pytest.mark.parametrize("mode", MODES)
def test_hybrid_forward_matches_model_per_group(data, ranks, mode):
    """Each row predicts its own group: the single-process model on that
    group's batch, and JAX make_hybrid_forward's row."""
    groups, bud, batches, flat = data
    hybrid, _, _ = ranks
    model = X2GNN(ModelConfig(**CFG), device="cpu")
    load_flax_params(model, flat)
    jcfg, _, mesh, stacked, sharded, params = _jax_setup(groups, bud, flat)
    ref = np.asarray(jhybrid.make_hybrid_forward(
        jcfg, mesh, stacked.numbers.shape[1], kv_exchange=mode)(
            params, sharded))
    for rank, r in enumerate(hybrid):
        row = rank // EP
        got = r[0]["plain"][mode][0]
        with torch.no_grad():
            want = model(batches[row].to("cpu")).numpy()
        np.testing.assert_allclose(got, want, rtol=PRED_RTOL,
                                   atol=PRED_ATOL * np.abs(want).max())
        np.testing.assert_allclose(got, ref[row], rtol=JAX_PRED_RTOL,
                                   atol=JAX_PRED_ATOL * np.abs(ref).max())


def _weighted_grads(flat, batches):
    """The gradient of the mean loss over every group's real molecules,
    as the single-process model gives it group by group (each group's
    embedding counts its own batch, as the EP row all-reduces them), and
    that loss."""
    model = X2GNN(ModelConfig(**CFG), device="cpu")
    load_flax_params(model, flat)
    names = [n for n, _ in model.named_parameters()]
    preds = [model(b.to("cpu")) for b in batches]
    y = torch.cat([torch.from_numpy(b.y) for b in batches])
    mask = torch.cat([torch.from_numpy(b.graph_mask) for b in batches])
    loss = smooth_l1_loss(torch.cat(preds), y, mask=mask)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                materialize_grads=True)
    return float(loss.detach()), export_flax_params(
        model, dict(zip(names, grads)))


def test_hybrid_param_gradients_match_combined_loss(data, ranks):
    """The global masked mean over both groups, differentiated through
    both rows' EP forwards and one all-reduce: the single-process
    gradient of the same loss, and JAX's hybrid gradient."""
    groups, bud, batches, flat = data
    hybrid, _, _ = ranks
    loss, want = _weighted_grads(flat, batches)
    jcfg, _, mesh, stacked, sharded, params = _jax_setup(groups, bud, flat)
    fwd = jhybrid.make_hybrid_forward(jcfg, mesh, stacked.numbers.shape[1])

    def loss_fn(p):
        return jloss.smooth_l1_loss(fwd(p, sharded).reshape(-1),
                                    sharded.y.reshape(-1),
                                    mask=sharded.graph_mask.reshape(-1))

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    jwant = {k: np.asarray(v, np.float32)
             for k, v in export_params_flat(jg).items()}
    for r in hybrid:
        for mode in MODES:
            got_loss, grads = r[0]["plain"][mode][1:]
            np.testing.assert_allclose(got_loss, loss, rtol=PRED_RTOL)
            np.testing.assert_allclose(got_loss, float(jl),
                                       rtol=JAX_PRED_RTOL)
            _assert_grads(grads, want, GRAD_RTOL, GRAD_ATOL, mode)
            _assert_grads(grads, jwant, JAX_GRAD_RTOL, JAX_GRAD_ATOL,
                          f"jax {mode}")


def test_hybrid_train_step_matches_jax(data, ranks):
    """STEPS steps of make_hybrid_train_step from the same weights: the
    losses against JAX's, every rank's parameters the same bits, the
    first step the same bits on a rerun, the eval step's sums against
    JAX's."""
    groups, bud, batches, flat = data
    hybrid, _, _ = ranks
    jcfg, _, mesh, stacked, sharded, params = _jax_setup(groups, bud, flat)
    n = stacked.numbers.shape[1]
    tcfg = JaxTrainConfig(**TCFG)
    opt = joptim.make_optimizer(tcfg)
    state = JaxTrainState(params, opt.init(params), jema.ema_init(params),
                          jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    step = jhybrid.make_hybrid_train_step(jcfg, opt, tcfg.ema_decay, mesh,
                                          n, kv_exchange="ring")
    jlosses = []
    for _ in range(STEPS):
        state, loss = step(state, sharded)
        jlosses.append(float(loss))
    err, cnt = jhybrid.make_hybrid_eval_step(jcfg, mesh, n, std=STD)(
        _flax_tree(flat), sharded)
    losses, final = hybrid[0][0]["plain"]["steps"]
    np.testing.assert_allclose(losses, jlosses, rtol=RUN_RTOL)
    assert losses[-1] < losses[0]
    for r in hybrid:
        assert r[0]["plain"]["rerun_equal"]
        for a, b in zip(r[0]["plain"]["steps"][1], final):
            np.testing.assert_array_equal(a, b)
        got_err, got_cnt = r[0]["plain"]["eval"]
        assert got_cnt == float(cnt) == 6
        np.testing.assert_allclose(got_err, float(err), rtol=1e-5)


def test_hybrid_dropout_train_step(ranks):
    """Dropout on the hybrid path: each rank draws its own masks; the
    steps stay finite and a step repeats bit for bit."""
    hybrid, _, _ = ranks
    for r in hybrid:
        losses, final = r[0]["dropout"]["steps"]
        assert len(losses) == STEPS and all(np.isfinite(losses))
        assert r[0]["dropout"]["rerun_equal"]
        for a, b in zip(hybrid[0][0]["dropout"]["steps"][1], final):
            np.testing.assert_array_equal(a, b)


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_hybrid_mode(ranks):
    """Trainer on the 2x2 layout for 3 epochs: the rows split each step's
    group of 2 batches, the EP ranks of a row each batch's atoms; it
    trains as plain data parallelism over 2 ranks does on the same data,
    the ranks end with the same parameters and rank 0 alone wrote the run
    directory."""
    hybrid, dp, tmp = ranks
    fits = [r[2] for r in hybrid]
    for summary, _, spe in fits:
        assert np.isfinite(summary["best_val_mae"]) and spe == 2
    for r in fits[1:]:
        for a, b in zip(fits[0][1], r[1]):
            np.testing.assert_array_equal(a, b)
    got, want = _records(tmp / "hybrid_run"), _records(tmp / "dp_run")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("loss", "val_mae", "best_val_mae", "step"):
            np.testing.assert_allclose(g[key], w[key], rtol=RUN_RTOL,
                                       err_msg=key)
    # Adam moves a parameter by at most about lr a step, whatever its
    # gradient's size: where a gradient is near 0, rounding can flip that
    # move, so the runs' parameters agree to steps x max_lr
    steps, max_lr = got[-1]["step"], TrainConfig().max_lr
    for a, b in zip(fits[0][1], dp[0][1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=steps * max_lr)
