"""Nothing of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
the reference imports nothing of the port, and a run refuses a machine
without a card."""

import ast
import os

import pytest
import torch

from bench_port import run

FILES = [os.path.join(d, f) for d, _, fs in os.walk(run.HERE)
         for f in fs if f.endswith(".py")]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_guard_compares_top_level_names_whole():
    mods = ["x2gnn_tpu_torch", "x2gnn_tpu_torch.ops", "jaxlib", "jax.numpy",
            "x2gnn_tpu.ops", "optax", "flaxen", "jaxtyping", "numpy"]
    assert run.forbidden_modules(mods) == [
        "jax.numpy", "jaxlib", "optax", "x2gnn_tpu.ops"]


def test_no_file_imports_jax_or_the_jax_package():
    for path in FILES:
        for name in _imports(path):
            assert name.split(".")[0] not in run.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(run.HERE, "reference")
    for path in FILES:
        if path.startswith(ref):
            for name in _imports(path):
                assert name.split(".")[0] != "x2gnn_tpu_torch", (path, name)


def test_a_run_refuses_a_machine_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "aid.train", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_run_refuses_an_unknown_workload(capsys):
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""
