"""Guards of the port: it imports nothing of JAX or the JAX package, and
its entry points never fall back to the CPU when no card is present."""

import ast
import pathlib

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "x2gnn_tpu")


def _port_files():
    files = sorted((REPO / "x2gnn_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 25
    scanned = {str(p.relative_to(REPO)) for p in files}
    for module in ("train/trainer.py", "train/optim.py", "train/ema.py",
                   "train/loss.py", "train/checkpoint.py",
                   "train/__main__.py", "data/molecule.py",
                   "profile_training.py", "data/dataset.py",
                   "data/featurize.py", "evaluate.py", "infer.py",
                   "utils/determinism.py", "utils/torch_ckpt.py"):
        assert f"x2gnn_tpu_torch/{module}" in scanned, module
    bad = [(str(p.relative_to(REPO)), name) for p in files
           for name in _imports(p)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from x2gnn_tpu_torch.config import ModelConfig
    from x2gnn_tpu_torch.infer import Predictor
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    cfg = ModelConfig(conv_layers=1, in_channels=32, embedding_size=32,
                      heads=4, edge_feat_dim=8, attention_layout="blocked")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        X2GNN(cfg)
    model = X2GNN(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, model)


def test_training_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import numpy as np
    from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.train.__main__ import main
    from x2gnn_tpu_torch.train.trainer import Trainer
    cfg = ModelConfig(conv_layers=1, in_channels=32, embedding_size=32,
                      heads=4, edge_feat_dim=8, attention_layout="blocked")
    graphs = synthetic_dataset(4, mean_atoms=5, edge_feat_dim=8)
    model = X2GNN(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, cfg, TrainConfig(), graphs, np.zeros(4, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--synthetic", "4"])


def test_run_io_entry_points_default_to_the_card(tmp_path):
    """Predictor.from_run / from_checkpoint, the evaluate CLI and the
    .pth import CLI want the card unless told device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from x2gnn_tpu_torch.config import ModelConfig, TrainConfig, dump_configs
    from x2gnn_tpu_torch.evaluate import main as evaluate_main
    from x2gnn_tpu_torch.infer import Predictor
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.train.checkpoint import save_checkpoint
    from x2gnn_tpu_torch.train.ema import ema_init
    from x2gnn_tpu_torch.train.optim import Optimizer
    from x2gnn_tpu_torch.train.trainer import TrainState
    from x2gnn_tpu_torch.utils.torch_ckpt import main as import_main
    cfg = ModelConfig(conv_layers=1, in_channels=32, embedding_size=32,
                      heads=4, edge_feat_dim=8, attention_layout="blocked")
    params = list(X2GNN(cfg, device="cpu").parameters())
    zero = torch.zeros((), dtype=torch.int32)
    save_checkpoint(str(tmp_path / "ckpt_best.pt"), TrainState(
        params, Optimizer(TrainConfig()).init(params), ema_init(params),
        zero, zero))
    dump_configs(cfg, TrainConfig(), str(tmp_path / "args.json"))
    ckpt = str(tmp_path / "ckpt_best.pt")
    for call in (lambda: Predictor.from_run(str(tmp_path)),
                 lambda: Predictor.from_checkpoint(ckpt),
                 lambda: evaluate_main(["--ckpt", ckpt, "--synthetic", "2"]),
                 lambda: import_main(["--pth", ckpt, "--out",
                                      str(tmp_path / "out")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert Predictor.from_run(str(tmp_path), device="cpu").device.type == \
        "cpu"
