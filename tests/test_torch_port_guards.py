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
    assert len(files) > 15
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
