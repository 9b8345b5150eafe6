"""The port's training path against the JAX package on the CPU, at small
widths: the masked gather's and the embedding's gradients, loss and MAE,
clip + Adam + EMA with the non-finite skip, the plateau controller, the
split, whole-model gradients, a two-epoch Trainer run, the CLI, the
checkpoint round trip and the weight mapping in both directions."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_model import (  # noqa: F401 (autouse fixture)
    SMALL, _graphs, one_torch_thread)
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.config import TrainConfig as JaxTrainConfig
from x2gnn_tpu.data import batching as jbatching
from x2gnn_tpu.data.molecule import fit_linear_atomref as jfit_atomref
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.nn.layers import EmbeddingBlock as FlaxEmbeddingBlock
from x2gnn_tpu.ops.attention import injective_gather as jinjective_gather
from x2gnn_tpu.train import ema as jema
from x2gnn_tpu.train import loss as jloss
from x2gnn_tpu.train import optim as joptim
from x2gnn_tpu.train.trainer import Trainer as JaxTrainer
from x2gnn_tpu.train.trainer import TrainState as JaxTrainState
from x2gnn_tpu.train.trainer import make_split as jmake_split
from x2gnn_tpu.utils.parity import export_params_flat
from x2gnn_tpu_torch.config import (
    ModelConfig, TrainConfig, dump_configs, load_configs)
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.data.molecule import fit_linear_atomref
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.nn.layers import EmbeddingBlock
from x2gnn_tpu_torch.ops.attention import injective_gather, inverse_slots
from x2gnn_tpu_torch.train import optim
from x2gnn_tpu_torch.train.__main__ import main as cli_main
from x2gnn_tpu_torch.train.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint)
from x2gnn_tpu_torch.train.ema import ema_init
from x2gnn_tpu_torch.train.loss import masked_mae, smooth_l1_loss
from x2gnn_tpu_torch.train.trainer import (
    TrainState, Trainer, make_split, resolve_division)
from x2gnn_tpu_torch.weights import export_flax_params, load_flax_params


def _np(t):
    return t.detach().numpy()


# ---- masked gather and embedding ----------------------------------------

@pytest.mark.parametrize("table", ["in_edges", "out2in"])
def test_injective_gather_gradient_is_the_reference_masked_gather(table):
    """The two gathers of the model on a real batch: edge rows into the
    in-table (pad slots point at row 0, a real edge) and in-slot rows into
    the out-table (pad slots point at edge 0's in-slot). The cotangent's
    gather must give those rows only their own slot's gradient, and rows
    that no slot lists none."""
    graphs = _graphs(3, seed=21)
    bud = pad_budget_for(graphs, 3)
    b = pad_graphs(graphs, bud._replace(n_edge=bud.n_edge + 8))
    N, D = b.in_edges.shape
    if table == "in_edges":
        tab, tab_mask = b.in_edges, b.in_mask
        inv, row_mask = b.edge_inpos, b.edge_mask
        assert (tab[~tab_mask] == 0).all() and b.edge_mask[0]
    else:
        tab, tab_mask = b.edge_inpos[b.out_edges], b.out_mask
        row_mask = b.in_mask.reshape(-1)
        # the reference's inverse table (x2gnn_tpu/models/x2gnn.py:129-132)
        safe = np.where(b.edge_mask, b.edge_inpos, N * D)
        inv = np.asarray(jnp.zeros(N * D, jnp.int32).at[safe].set(
            b.edge_outpos, mode="drop"))
        got_inv = inverse_slots(torch.from_numpy(tab).long(),
                                torch.from_numpy(tab_mask), N * D)
        np.testing.assert_array_equal(got_inv.numpy(), inv)
        assert (tab[~tab_mask] == b.edge_inpos[0]).all()
    assert (~tab_mask).any() and (~row_mask).any()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(row_mask.shape[0], 5)).astype(np.float32)
    w = rng.normal(size=(N, D, 5)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = injective_gather(xt, torch.from_numpy(tab).long(),
                           torch.from_numpy(np.array(inv)).long(),
                           torch.from_numpy(row_mask))
    np.testing.assert_array_equal(_np(out), x[tab])
    (got,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), xt)
    _, vjp = jax.vjp(lambda v: jinjective_gather(
        v, jnp.asarray(tab), jnp.asarray(inv), jnp.asarray(row_mask)),
        jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(w))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
    assert (_np(got)[~row_mask] == 0).all()


def test_embedding_gradient_matches_flax():
    """Repeated atomic numbers and Z=0 pads: each row's gradient divided
    by its count in the batch, row 0 none."""
    numbers = np.array([0, 1, 6, 6, 6, 8, 1, 0, 0, 9], np.int32)
    flax_mod = FlaxEmbeddingBlock(16)
    params = jax.jit(flax_mod.init)(jax.random.PRNGKey(2),
                                    jnp.asarray(numbers))
    w = np.random.default_rng(4).normal(size=(10, 16)).astype(np.float32)
    ref = jax.jit(jax.grad(lambda p: (flax_mod.apply(
        p, jnp.asarray(numbers)) * w).sum()))(params)
    port = EmbeddingBlock(16)
    load_flax_params(port, export_params_flat(params))
    out = port(torch.from_numpy(numbers).long())
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                list(port.parameters()))
    names = [n for n, _ in port.named_parameters()]
    got = export_flax_params(port, dict(zip(names, grads)))
    want = export_params_flat(ref)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-5,
                                   atol=1e-6, err_msg=path)
    assert (got["embedding"][0] == 0).all()


# ---- loss, optimizer, EMA ------------------------------------------------

def test_loss_and_mae_match_reference():
    rng = np.random.default_rng(5)
    pred = (rng.normal(size=12) * 2).astype(np.float32)
    y = rng.normal(size=12).astype(np.float32)
    for mask in (rng.uniform(size=12) > 0.3, np.ones(12, bool)):
        j = [jnp.asarray(a) for a in (pred, y, mask)]
        t = [torch.from_numpy(a) for a in (pred, y, mask)]
        np.testing.assert_allclose(float(smooth_l1_loss(*t)),
                                   float(jloss.smooth_l1_loss(*j)),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(masked_mae(*t)),
                                   float(jloss.masked_mae(*j)), rtol=1e-6)


def _adam_of(s):
    """The ScaleByAdamState inside an optax state tree."""
    if hasattr(s, "mu") and hasattr(s, "nu"):
        return s
    if isinstance(s, tuple):
        for c in s:
            found = _adam_of(c)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("scheduler,fused", [
    ("warmup_exp", False), ("warmup_exp", True), ("plateau", False),
    ("plateau", True)])
def test_clip_adam_ema_match_optax(scheduler, fused):
    """Identical gradients over 3 steps (the first two clipped at
    max_grad, the plateau scale lowered after step 1): parameters, Adam
    moments and count, and the EMA agree with the reference's
    apply_update_skip_nonfinite at rtol 1e-6. The global norm's float32
    sum runs in another order than XLA's (1 ulp), which can move a moment
    element that nearly cancels by more than 1e-6 of itself: elements are
    also allowed 1e-7 of their tensor's largest magnitude."""
    kw = dict(scheduler=scheduler, fused_update=fused, max_grad=2.0,
              warmup_steps=2, decay_steps=10, ema_decay=0.9)
    rng = np.random.default_rng(6)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    keys = sorted(shapes)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jopt = joptim.make_optimizer(JaxTrainConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = JaxTrainState(jp, jopt.init(jp), jema.ema_init(jp, flat=fused),
                           jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))
    popt = optim.Optimizer(TrainConfig(**kw))
    leaves = [torch.from_numpy(p0[k].copy()) for k in keys]
    params = [torch.cat([t.reshape(-1) for t in leaves])] if fused else leaves
    zero = torch.zeros((), dtype=torch.int32)
    pstate = TrainState(params, popt.init(params), ema_init(params), zero,
                        zero.clone())
    for step in range(3):
        scale = (3.0, 1.5, 0.1)[step]
        g = {k: (rng.normal(size=s) * scale).astype(np.float32)
             for k, s in shapes.items()}
        jstate, _ = joptim.apply_update_skip_nonfinite(
            jstate, jnp.float32(1.0), {k: jnp.asarray(v) for k, v in
                                       g.items()}, jopt, 0.9)
        pg = [torch.from_numpy(g[k]) for k in keys]
        if fused:
            pg = [torch.cat([t.reshape(-1) for t in pg])]
        pstate, _ = optim.apply_update_skip_nonfinite(
            pstate, torch.tensor(1.0), pg, popt, 0.9)
        if scheduler == "plateau" and step == 0:
            jstate = jstate._replace(opt_state=joptim.set_plateau_scale(
                jstate.opt_state, 0.5))
            pstate = pstate._replace(opt_state=optim.set_plateau_scale(
                pstate.opt_state, 0.5))

    def flat(tree):
        return np.concatenate([np.asarray(tree[k]).reshape(-1)
                               for k in keys])

    def port_flat(ts):
        return np.concatenate([t.numpy().reshape(-1) for t in ts])

    jadam = _adam_of(jstate.opt_state)
    want = {"params": flat(jstate.params), "ema": (
        np.asarray(jstate.ema.params) if fused else flat(jstate.ema.params)),
        "mu": (np.asarray(jadam.mu) if fused else flat(jadam.mu)),
        "nu": (np.asarray(jadam.nu) if fused else flat(jadam.nu))}
    got = {"params": port_flat(pstate.params),
           "ema": port_flat(pstate.ema.params),
           "mu": port_flat(pstate.opt_state.mu),
           "nu": port_flat(pstate.opt_state.nu)}
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   atol=1e-7 * np.abs(want[name]).max(),
                                   err_msg=name)
    assert int(pstate.opt_state.count) == int(jadam.count) == 3
    assert int(pstate.ema.count) == int(jstate.ema.count) == 3


def test_nonfinite_loss_skips_the_update():
    cfg = TrainConfig(scheduler="plateau", fused_update=True)
    opt = optim.Optimizer(cfg)
    params = [torch.arange(6, dtype=torch.float32)]
    zero = torch.zeros((), dtype=torch.int32)
    state = TrainState(params, opt.init(params), ema_init(params), zero,
                       zero.clone())
    g = [torch.ones(6)]
    state, _ = optim.apply_update_skip_nonfinite(state, torch.tensor(0.5),
                                                 g, opt, 0.95)
    before = (params[0].clone(), state.opt_state, state.ema)
    for bad in (float("nan"), float("inf")):
        state, _ = optim.apply_update_skip_nonfinite(
            state, torch.tensor(bad), [torch.full((6,), bad)], opt, 0.95)
    assert torch.equal(params[0], before[0])
    assert torch.equal(state.opt_state.mu[0], before[1].mu[0])
    assert torch.equal(state.opt_state.nu[0], before[1].nu[0])
    assert int(state.opt_state.count) == 1
    assert torch.equal(state.ema.params[0], before[2].params[0])
    assert int(state.ema.count) == 1
    assert (int(state.step), int(state.bad_steps)) == (3, 2)


def test_plateau_controller_matches_reference():
    metrics = [5.0, 4.0, 4.0, 4.1, 3.9996, 4.2, 4.0, 3.0, 3.1, 3.2, 3.3,
               3.4, 3.5, 3.6, 3.7, 3.8, 2.0, 2.1, 2.2, 2.3, 2.4]
    ref = joptim.PlateauController(factor=0.5, patience=2, min_scale=0.2)
    got = optim.PlateauController(factor=0.5, patience=2, min_scale=0.2)
    assert [got.step(m) for m in metrics] == [ref.step(m) for m in metrics]
    assert got.scale == 0.2


@pytest.mark.parametrize("n", [24, 512, 30000])
def test_make_split_matches_reference(n):
    division = resolve_division(n, (10000, 20000))
    for a, b in zip(make_split(n, 41, division),
                    jmake_split(n, 41, division)):
        np.testing.assert_array_equal(a, b)


# ---- whole model, Trainer, CLI ------------------------------------------

def _whole_model_gradients():
    """(port loss, JAX loss, port gradients, JAX gradients) by flax path
    of one smooth-L1 step on 4 small molecules."""
    graphs = _graphs(4, seed=22)
    targets = np.random.default_rng(7).normal(size=4).astype(np.float32)
    bud = pad_budget_for(graphs, 4)
    jb = jbatching.pad_graphs(graphs, jbatching.Budgets(*bud),
                              targets=targets, with_triplets=False)
    jmodel = JaxX2GNN(JaxModelConfig(use_pallas=True, **SMALL))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb)

    def loss_fn(p):
        return jloss.smooth_l1_loss(jmodel.apply(p, jb), jb.y,
                                    mask=jb.graph_mask)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = X2GNN(ModelConfig(**SMALL), device="cpu")
    load_flax_params(model, export_params_flat(params))
    pb = pad_graphs(graphs, bud, targets=targets).to("cpu")
    loss = smooth_l1_loss(model(pb), pb.y, mask=pb.graph_mask)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = export_flax_params(model, dict(zip(names, grads)))
    want = export_params_flat(jg)
    return loss.item(), float(jl), got, want


def test_whole_model_gradients_match_jax():
    """jax.grad of the smooth-L1 loss of X2GNN(use_pallas=True) (interpret
    mode) against the port's autograd (plain attention backward), leaf by
    leaf through export_flax_params, at rtol 1e-3 and 1e-4 of the leaf's
    largest magnitude. The lin_key biases are the exception: adding the
    same vector to every key shifts all scores of a query alike, which the
    softmax ignores, so their gradient is 0 in exact arithmetic and
    rounding noise in both packages; it must stay below 1e-6 of the
    model's largest gradient."""
    loss, jl, got, want = _whole_model_gradients()
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert set(got) == set(want)
    top = max(float(np.abs(r).max()) for r in want.values())
    for path, ref in want.items():
        ref = np.asarray(ref, np.float32)
        if path.endswith("lin_key/Dense_0/bias"):
            assert np.abs(ref).max() < 1e-6 * top, path
            assert np.abs(got[path]).max() < 1e-6 * top, path
            continue
        np.testing.assert_allclose(got[path], ref, rtol=1e-3,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=path)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    return _trainer_runs(tmp_path_factory.mktemp)


def _trainer_runs(mktemp):
    """Two epochs of the flagship recipe (plateau, fused update, clip,
    EMA) in both packages on 24 small molecules, same initial weights and
    the same default budgets, whose degree tiers both run (one Pallas
    call per tier in interpret mode, one kernel call per tier in the
    port); plus one step of each from those weights."""
    graphs = _graphs(24, seed=23)
    targets = np.array([g.y[0] for g in graphs], np.float32)
    bud = pad_budget_for(graphs, 8)
    kw = dict(batch_size=8, max_epoch=2, scheduler="plateau",
              fused_update=True, ckpt_after_epoch=100, max_lr=1e-3)
    jcfg = JaxModelConfig(use_pallas=True, **SMALL)
    jt = JaxTrainer(JaxX2GNN(jcfg), jcfg, JaxTrainConfig(**kw), graphs,
                    targets, workdir=str(mktemp("jax")),
                    budgets=jbatching.Budgets(*bud))
    jstate0 = jt.init_state()
    flat0 = export_params_flat(jstate0.params)
    jbatch = next(jt._batches(jt.train_idx))
    # the step donates its state: hand it a copy
    jstate1, _ = jt._train_step(jax.tree_util.tree_map(jnp.copy, jstate0),
                                jbatch)
    jflat1 = export_params_flat(jstate1.params)
    # fit starts from init_state(): hand it a copy of the same initial
    # state instead of initializing the flax model a second time
    jt.init_state = lambda: jax.tree_util.tree_map(jnp.copy, jstate0)
    jt.fit(epochs=2)
    jrecords = [json.loads(line) for line in
                open(f"{jt.workdir}/metrics.jsonl")]

    def port_trainer(workdir):
        model = X2GNN(ModelConfig(**SMALL), device="cpu")
        load_flax_params(model, flat0)
        return Trainer(model, ModelConfig(**SMALL), TrainConfig(**kw),
                       graphs, targets, workdir=workdir, budgets=bud,
                       device="cpu")

    pt = port_trainer(str(mktemp("port_step")))
    pt.train_step(pt.init_state(), pt.batches(pt.train_idx)[0])
    pflat1 = export_flax_params(pt.model)
    pt = port_trainer(str(mktemp("port")))
    pt.fit(epochs=2)
    precords = [json.loads(line) for line in
                open(f"{pt.workdir}/metrics.jsonl")]
    return jrecords, precords, flat0, jflat1, pflat1


def test_trainer_two_epochs_match_reference(trainer_runs):
    jrec, prec, _, _, _ = trainer_runs
    assert len(jrec) == len(prec) == 2
    for j, p in zip(jrec, prec):
        for key in ("loss", "val_mae", "best_val_mae"):
            np.testing.assert_allclose(p[key], j[key], rtol=1e-3,
                                       err_msg=key)
        for key in ("epoch", "step", "bad_steps", "lr_scale",
                    "occupancy_nodes", "occupancy_edges", "budget_shapes"):
            assert p[key] == j[key], key


def test_trainer_first_step_parameters_match_reference(trainer_runs):
    """Every leaf after the first step at atol 1e-5, a hundredth of the
    step's lr. The lin_key biases are the exception: their gradient is
    rounding noise in both packages (see test_whole_model_gradients_match_
    jax), so Adam's first step, about lr * sign(g), moves them by up to lr
    either way; each side must move them by at most lr."""
    _, _, flat0, jflat1, pflat1 = trainer_runs
    assert set(jflat1) == set(pflat1) == set(flat0)
    lr = 1e-3
    for path, ref in jflat1.items():
        ref = np.asarray(ref, np.float32)
        if path.endswith("lin_key/Dense_0/bias"):
            start = np.asarray(flat0[path], np.float32)
            for side in (ref, pflat1[path]):
                assert np.abs(side - start).max() <= lr * (1 + 1e-3), path
            continue
        np.testing.assert_allclose(pflat1[path], ref, rtol=0, atol=1e-5,
                                   err_msg=path)


def _small_config(tmp_path, **train):
    path = tmp_path / "args.json"
    path.write_text(json.dumps({"model": SMALL, "train": {
        "batch_size": 8, "ckpt_after_epoch": 0, **train}}))
    return str(path)


def test_cli_trains_on_the_cpu(tmp_path):
    workdir = tmp_path / "run"
    rc = cli_main(["--device", "cpu", "--synthetic", "24", "--epochs", "2",
                   "--config", _small_config(tmp_path, ckpt_every=1),
                   "--scheduler", "plateau", "--fused-update",
                   "--standardize", "--workdir", str(workdir)])
    assert rc == 0
    records = [json.loads(line) for line in
               (workdir / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["bad_steps"] == 0
               for r in records)
    mcfg, tcfg = load_configs(str(workdir / "args.json"))
    assert mcfg == ModelConfig(**SMALL)
    assert (tcfg.max_epoch, tcfg.scheduler, tcfg.fused_update) == (
        2, "plateau", True)
    for name in ("provenance.json", "standardization.json", "train.log",
                 "ckpt_best.pt", "ckpt_last.pt"):
        assert (workdir / name).exists(), name


@pytest.mark.parametrize("flag", ["--data-parallel", "--edge-partition=ring",
                                  "--dp-groups=2"])
def test_cli_refuses_unported_flags(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        cli_main(["--device", "cpu", "--synthetic", "4", flag,
                  "--workdir", str(tmp_path)])


def test_cli_trains_in_the_segment_layout(tmp_path):
    """--layout=segment runs the flat-edge model on batches padded with
    triplets, and the determinism check passes there."""
    workdir = tmp_path / "run"
    assert cli_main(["--device", "cpu", "--synthetic", "16",
                     "--layout=segment", "--config",
                     _small_config(tmp_path), "--epochs", "1",
                     "--check-determinism", "--workdir", str(workdir)]) == 0
    mcfg, _ = load_configs(str(workdir / "args.json"))
    assert mcfg.attention_layout == "segment"


def test_cli_resumes_from_a_checkpoint(tmp_path):
    """--resume trains the epochs left of --epochs from the checkpoint's
    step and numbers them on; a graph cache (--data-npz, --limit) feeds
    the run and its basis tag goes to provenance.json."""
    from x2gnn_tpu_torch.data.dataset import save_graph_cache
    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    cache = str(tmp_path / "cache.npz")
    save_graph_cache(cache, synthetic_dataset(30, mean_atoms=7,
                                              edge_feat_dim=8), basis="x2sv")
    workdir = tmp_path / "run"
    common = ["--device", "cpu", "--data-npz", cache, "--limit", "24",
              "--config", _small_config(tmp_path, ckpt_every=1),
              "--workdir", str(workdir)]
    assert cli_main(common + ["--epochs", "1"]) == 0
    ckpt = str(tmp_path / "epoch1.pt")
    (workdir / "ckpt_last.pt").rename(ckpt)
    assert cli_main(common + ["--epochs", "3", "--resume", ckpt]) == 0
    records = [json.loads(line) for line in
               (workdir / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [1, 2, 3]
    assert [r["step"] for r in records] == [records[0]["step"] * k
                                            for k in (1, 2, 3)]
    assert json.loads((workdir / "provenance.json").read_text()) == {
        "basis": "x2sv"}


@pytest.mark.parametrize("change", [
    dict(accum_steps=2, mesh=object()), dict(mesh=object()),
    dict(edge_partition="ring"),
    dict(feat_dtype="float16", edge_partition="ring")])
def test_trainer_refuses_unported_options(change):
    """The parallel paths (ROADMAP A10) stay refused, also beside the
    options ported since (accum_steps, feat_dtype)."""
    graphs = _graphs(4, seed=24)
    targets = np.zeros(4, np.float32)
    train = {k: v for k, v in change.items() if k == "accum_steps"}
    other = {k: v for k, v in change.items() if k not in train}
    model = X2GNN(ModelConfig(**SMALL), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(model, ModelConfig(**SMALL), TrainConfig(**train), graphs,
                targets, device="cpu", **other)


@pytest.mark.parametrize("how", ["cli --pack-mixed", "pack_mixed",
                                 "bucket_shapes=2, pack_budget"])
def test_packed_training_runs_on_the_cpu(how, tmp_path):
    """One epoch of planned batches on 16 small molecules through the CLI
    or the Trainer: finite loss, one step per planned batch, the pair
    occupancy recorded."""
    workdir = tmp_path / "run"
    if how.startswith("cli"):
        assert cli_main(["--device", "cpu", "--synthetic", "16", "--epochs",
                         "1", "--config", _small_config(tmp_path),
                         "--pack-mixed", "--workdir", str(workdir)]) == 0
        _, tcfg = load_configs(str(workdir / "args.json"))
        assert tcfg.pack_mixed
        n_steps = None
    else:
        train = (dict(pack_mixed=True) if how == "pack_mixed"
                 else dict(bucket_shapes=2, pack_budget=True))
        graphs = _graphs(16, seed=29)
        model = X2GNN(ModelConfig(**SMALL), device="cpu")
        trainer = Trainer(model, ModelConfig(**SMALL),
                          TrainConfig(batch_size=4, ckpt_after_epoch=0,
                                      **train),
                          graphs, np.array([g.y[0] for g in graphs]),
                          workdir=str(workdir), device="cpu")
        trainer.fit(epochs=1)
        _, budgets, _ = trainer.plan(trainer.train_idx)
        batches = trainer.batches(trainer.train_idx)
        n_steps = len(batches)
        assert n_steps > 1
        for b, bud in zip(batches, budgets):
            assert b.y.shape[0] == bud.n_graph > 0
            assert (b.tiers, b.n_hi, b.d_lo) == (bud.tiers, bud.n_hi,
                                                 bud.n_deg_lo)
    (record,) = [json.loads(line) for line in
                 (workdir / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite(record["loss"]) and record["bad_steps"] == 0
    assert 0 < record["occupancy_pairs"] <= 1
    if n_steps is not None:
        assert record["step"] == n_steps


# ---- configs, batching, checkpoints, weights ------------------------------

def test_load_configs_reads_the_flagship_args(tmp_path):
    mcfg, tcfg = load_configs("runs/flagship_r5_regression/args.json")
    raw = json.load(open("runs/flagship_r5_regression/args.json"))
    for f in dataclasses.fields(tcfg):
        want = raw["train"][f.name]
        assert getattr(tcfg, f.name) == (tuple(want) if f.name == "division"
                                         else want), f.name
    assert [f.name for f in dataclasses.fields(TrainConfig)] == [
        f.name for f in dataclasses.fields(JaxTrainConfig)]
    assert TrainConfig() == TrainConfig(**dataclasses.asdict(
        JaxTrainConfig()))
    dump_configs(mcfg, tcfg, str(tmp_path / "a.json"))
    assert load_configs(str(tmp_path / "a.json")) == (mcfg, tcfg)


def test_pad_graphs_targets_match_reference():
    graphs = _graphs(5, seed=25)
    targets = np.arange(5, dtype=np.float32) * 1.5
    bud = pad_budget_for(graphs, 6)
    got = pad_graphs(graphs, bud, n_graph=6, targets=targets)
    ref = jbatching.pad_graphs(graphs, jbatching.Budgets(*bud), n_graph=6,
                               targets=targets, with_triplets=False)
    np.testing.assert_array_equal(got.y, np.asarray(ref.y))
    assert got.y[:5].tolist() == targets.tolist()


def test_fit_linear_atomref_matches_reference():
    graphs = _graphs(12, seed=26)
    y = np.random.default_rng(8).normal(size=12) * 10
    idx = np.arange(3, 12)
    got, table = fit_linear_atomref([g.numbers for g in graphs], y, idx)
    ref, jtable = jfit_atomref([g.numbers for g in graphs], y, idx)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert table.keys() == jtable.keys()


def test_checkpoint_round_trip(tmp_path):
    graphs = _graphs(8, seed=27)
    targets = np.random.default_rng(9).normal(size=8).astype(np.float32)
    model = X2GNN(ModelConfig(**SMALL), torch.Generator().manual_seed(1),
                  device="cpu")
    trainer = Trainer(model, ModelConfig(**SMALL),
                      TrainConfig(batch_size=4, scheduler="plateau",
                                  fused_update=True),
                      graphs, targets, workdir=str(tmp_path), device="cpu")
    state = trainer.init_state()
    state, _ = trainer.train_step(state, trainer.batches(trainer.train_idx)[0])
    state = state._replace(opt_state=optim.set_plateau_scale(
        state.opt_state, 0.7))
    save_checkpoint(str(tmp_path / "ckpt_last.pt"), state)
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_last.pt")
    restored = restore_checkpoint(str(tmp_path / "ckpt_last.pt"),
                                  trainer.init_state())
    for a, b in [(restored.params, state.params),
                 (restored.opt_state.mu, state.opt_state.mu),
                 (restored.opt_state.nu, state.opt_state.nu),
                 (restored.ema.params, state.ema.params)]:
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in [(restored.opt_state.count, state.opt_state.count),
                 (restored.opt_state.plateau_scale,
                  state.opt_state.plateau_scale),
                 (restored.ema.count, state.ema.count),
                 (restored.step, state.step),
                 (restored.bad_steps, state.bad_steps)]:
        assert torch.equal(a, b)
    assert float(restored.opt_state.plateau_scale) == pytest.approx(0.7)


def test_weights_round_trip_flax_port_flax_is_bitwise():
    graphs = _graphs(3, seed=28)
    jb = jbatching.pad_graphs(graphs, jbatching.pad_budget_for(graphs, 3),
                              with_triplets=False)
    params = jax.jit(JaxX2GNN(JaxModelConfig(use_pallas=True,
                                             **SMALL)).init)(
        jax.random.PRNGKey(3), jb)
    flat = export_params_flat(params)
    model = X2GNN(ModelConfig(**SMALL), device="cpu")
    load_flax_params(model, flat)
    back = export_flax_params(model)
    assert set(back) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(back[path], np.asarray(value),
                                      err_msg=path)
        assert back[path].dtype == np.float32


if __name__ == "__main__":
    # the measured differences of the port's training path from the JAX
    # package at small width:
    #   env JAX_PLATFORMS=cpu python tests/test_torch_port_train.py
    import tempfile
    jax.config.update("jax_enable_x64", True)
    loss, jl, got, want = _whole_model_gradients()
    print(f"loss: port {loss:.8f} jax {jl:.8f}")
    worst = max((float(np.abs(got[k] - np.asarray(v)).max()
                       / np.abs(np.asarray(v)).max()), k)
                for k, v in want.items()
                if not k.endswith("lin_key/Dense_0/bias"))
    print(f"gradients: largest max|err|/max|g| over {len(want)} leaves "
          f"{worst[0]:.3e} ({worst[1]})")
    root = tempfile.mkdtemp()
    counter = iter(range(100))
    jrec, prec, _, jflat1, pflat1 = _trainer_runs(
        lambda name: f"{root}/{name}{next(counter)}")
    for j, p in zip(jrec, prec):
        print(f"epoch {p['epoch']}: loss port {p['loss']:.8f} jax "
              f"{j['loss']:.8f}; val_mae port {p['val_mae']:.8f} jax "
              f"{j['val_mae']:.8f}")
    step = max((float(np.abs(pflat1[k] - np.asarray(v)).max()), k)
               for k, v in jflat1.items()
               if not k.endswith("lin_key/Dense_0/bias"))
    print(f"first step: largest parameter difference {step[0]:.3e} "
          f"({step[1]}), lin_key biases left out")
