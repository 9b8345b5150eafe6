"""The port's featurizing entry points against the JAX package, on the
CPU: a 2-epoch `python -m x2gnn_tpu_torch.train --data` run against the
JAX Trainer, and Predictor.predict_xyz / predict_molecules against the
JAX Predictor."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_data_pipeline import _xyz, same_engine  # noqa: F401
from test_torch_port_model import SMALL, one_torch_thread  # noqa: F401
from x2gnn_tpu.config import ModelConfig as JaxModelConfig
from x2gnn_tpu.config import TrainConfig as JaxTrainConfig
from x2gnn_tpu.data import dataset as jdataset
from x2gnn_tpu.infer import Predictor as JaxPredictor
from x2gnn_tpu.models import X2GNN as JaxX2GNN
from x2gnn_tpu.train.ema import ema_init as jax_ema_init
from x2gnn_tpu.train.trainer import Trainer as JaxTrainer
from x2gnn_tpu_torch.config import ModelConfig, load_configs
from x2gnn_tpu_torch.data import synthetic
from x2gnn_tpu_torch.infer import Predictor
from x2gnn_tpu_torch.models.x2gnn import X2GNN
from x2gnn_tpu_torch.train.__main__ import main as train_main
from x2gnn_tpu_torch.weights import export_flax_params, load_flax_params

# the flagship's structure at small width, on the 338 integral features
SMALL_338 = {**SMALL, "edge_feat_dim": 338}


def test_data_cli_two_epochs_match_the_jax_trainer(same_engine, tmp_path):
    """`python -m x2gnn_tpu_torch.train --data F.xyz --backend native
    --pack-mixed`, 2 epochs of a small config on 16 molecules, against the
    JAX Trainer on the JAX package's load_dataset of the same file, from
    the CLI's initial weights: loss and MAEs within rtol 1e-3, counters
    equal. The CLI writes the reference's cache and provenance."""
    xyz = tmp_path / "mols.xyz"
    _xyz(xyz, 16, seed=21)
    config = tmp_path / "small.json"
    train = dict(batch_size=8, max_epoch=2, scheduler="plateau",
                 ckpt_after_epoch=100, max_lr=1e-3)
    config.write_text(json.dumps({"model": SMALL_338, "train": train}))
    workdir = tmp_path / "run"
    cache = tmp_path / "processed"
    assert train_main(["--device", "cpu", "--data", str(xyz), "--backend",
                       "native", "--cache-dir", str(cache), "--config",
                       str(config), "--pack-mixed", "--cache-batches", "off",
                       "--workdir", str(workdir)]) == 0
    assert os.listdir(cache) == ["mols_native_c5.npz"]
    assert json.loads((workdir / "provenance.json").read_text()) == {
        "basis": "x2sv"}
    precords = [json.loads(line) for line in
                (workdir / "metrics.jsonl").read_text().splitlines()]

    graphs = jdataset.load_dataset(str(xyz), cache_dir=str(tmp_path / "j"),
                                   backend="native", num_workers=1)
    targets = jdataset.prepare_targets(graphs, 7)
    mcfg, _ = load_configs(str(workdir / "args.json"))
    jcfg = JaxModelConfig(**{**dataclasses.asdict(mcfg),
                             "use_pallas": False})
    jt = JaxTrainer(JaxX2GNN(jcfg), jcfg,
                    JaxTrainConfig(**train, pack_mixed=True), graphs,
                    targets, workdir=str(tmp_path / "jax"))
    st = jt.init_state()
    # the CLI's initial weights (X2GNN from torch.Generator seed 0)
    flat = export_flax_params(X2GNN(mcfg, torch.Generator().manual_seed(0),
                                    device="cpu"))
    tree = {}
    for path, value in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(value)
    params = {"params": tree}
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(st.params))
    st = st._replace(params=params, opt_state=jt.optimizer.init(params),
                     ema=jax_ema_init(params))
    jt.init_state = lambda: jax.tree_util.tree_map(jnp.copy, st)
    jt.fit(epochs=2)
    jrecords = [json.loads(line) for line in
                open(f"{jt.workdir}/metrics.jsonl")]
    assert len(jrecords) == len(precords) == 2
    for j, p in zip(jrecords, precords):
        for key in ("loss", "val_mae", "best_val_mae"):
            np.testing.assert_allclose(p[key], j[key], rtol=1e-3,
                                       err_msg=key)
        for key in ("epoch", "step", "bad_steps", "lr_scale",
                    "occupancy_nodes", "occupancy_edges",
                    "occupancy_pairs", "budget_shapes"):
            assert p[key] == j[key], key


# ---- predict_xyz / predict_molecules ----------------------------------------

@pytest.fixture(scope="module")
def jax_predictor_weights():
    from x2gnn_tpu.data import batching as jbatching
    graphs = synthetic.synthetic_dataset(4, mean_atoms=7, seed=2)
    jcfg = JaxModelConfig(**SMALL_338)
    jb = jbatching.pad_graphs(graphs, jbatching.pad_budget_for(graphs, 4),
                              with_triplets=False)
    params = jax.jit(JaxX2GNN(jcfg).init)(jax.random.PRNGKey(0), jb)
    from x2gnn_tpu.utils.parity import export_params_flat
    return jcfg, params, export_params_flat(params)


@pytest.mark.parametrize("entry", ["predict_xyz", "predict_molecules"])
def test_predict_featurizing_matches_jax(jax_predictor_weights, tmp_path,
                                         entry):
    """Both packages featurize the same molecules with their own engines
    and predict with the same weights: rtol 1e-4, atol 1e-4 of the
    largest prediction (the tolerances of from_run against the JAX
    Predictor, test_torch_port_run_io.py); a mismatched basis raises."""
    jcfg, params, flat = jax_predictor_weights
    xyz = tmp_path / "q.xyz"
    mols = _xyz(xyz, 9, seed=31)
    stats = {"mu": 1.5, "sigma": 2.0}
    # featurized here in one process: a forked pool in a process running
    # JAX's threads risks a deadlock
    jdataset.load_dataset(str(xyz), cache_dir=str(tmp_path / "j"),
                          backend="native", num_workers=1)
    ref = JaxPredictor(jcfg, params, stats=stats, batch_size=4).predict_xyz(
        str(xyz), backend="native", cache_dir=str(tmp_path / "j"))
    model = X2GNN(ModelConfig(**SMALL_338), device="cpu")
    load_flax_params(model, flat)
    pred = Predictor(ModelConfig(**SMALL_338), model, stats=stats,
                     batch_size=4, device="cpu", basis="x2sv")
    if entry == "predict_xyz":
        got = pred.predict_xyz(str(xyz), backend="native",
                               cache_dir=str(tmp_path / "p"))
        assert os.listdir(tmp_path / "p") == ["q_native_c5.npz"]
    else:
        got = pred.predict_molecules(mols, backend="native")
    assert got.shape == (9,)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    with pytest.raises(ValueError, match="basis mismatch"):
        getattr(pred, entry)(str(xyz) if entry == "predict_xyz" else mols,
                             backend="native6311")
