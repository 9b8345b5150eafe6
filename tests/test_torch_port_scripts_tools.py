"""The port's measurement scripts (`x2gnn_tpu_torch.scripts.merge_chunks`,
`profile_step`, `bench_infer`, `debug_ep_cost`, `bench_scaling`,
`pack_ab`, `pipeline_demo`) on the CPU at small sizes, against the JAX
package's scripts of the same names: the keys each prints are the JAX
script's (read from its source), merge_chunks' and pack_ab's outputs are
the JAX scripts' own on the same files (run through runpy), profile_step's
stubs keep the parameters and `no_kernel` runs no attention, and
bench_scaling's gloo ranks print their lines with "virtual": true."""

import ast
import contextlib
import functools
import io
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import x2gnn_tpu.data.dataset as jdataset
from test_torch_port_model import one_torch_thread  # noqa: F401
from test_torch_port_run_io import _assert_graphs_equal
from x2gnn_tpu_torch.config import ModelConfig
from x2gnn_tpu_torch.data import dataset, make_synthetic
from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
from x2gnn_tpu_torch.models.x2gnn import X2GNN, attention_windows
from x2gnn_tpu_torch.ops import blocked_attn
from x2gnn_tpu_torch.scripts import (
    bench_infer, debug_ep_cost, merge_chunks, pack_ab, pipeline_demo,
    profile_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    return os.path.join(REPO, "scripts", f"{name}.py")


def _dict_keys(name):
    """Every string key of a dict literal in the JAX script `name`."""
    tree = ast.parse(open(_jax_script(name)).read())
    return {k.value for node in ast.walk(tree) if isinstance(node, ast.Dict)
            for k in node.keys if isinstance(k, ast.Constant)
            and isinstance(k.value, str)}


def _printed_names(name):
    """The string constants the JAX script `name` prints first."""
    tree = ast.parse(open(_jax_script(name)).read())
    return [node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "id", "") == "print" and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)]


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue()


def _run_jax_script(name, argv):
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [_jax_script(name)] + argv
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(_jax_script(name), run_name="__main__")
    finally:
        sys.argv = saved
    return buf.getvalue()


# ---- merge_chunks -------------------------------------------------------------

def test_merge_chunks_takes_the_first_n_as_the_jax_script(tmp_path):
    graphs = synthetic_dataset(7, mean_atoms=5, seed=3, edge_feat_dim=8)
    prefix = str(tmp_path / "_build_chunk")
    for lo in range(0, 7, 3):
        dataset.save_graph_cache(f"{prefix}{lo:07d}.npz", graphs[lo:lo + 3],
                                 basis="x2sv" if lo == 0 else "other")
    args = ["--prefix", prefix, "--n", "5", "--chunk", "3"]
    assert merge_chunks.main(args + ["--out", str(tmp_path / "p.npz")]) == 0
    _run_jax_script("merge_chunks", args + ["--out", str(tmp_path / "j.npz")])
    got = dataset.load_graph_cache(str(tmp_path / "p.npz"))
    _assert_graphs_equal(got, graphs[:5])
    _assert_graphs_equal(got, jdataset.load_graph_cache(str(tmp_path /
                                                            "j.npz")))
    assert dataset.read_cache_basis(str(tmp_path / "p.npz")) == "x2sv"
    assert merge_chunks.main(args + ["--out", str(tmp_path / "b.npz"),
                                     "--basis", "given"]) == 0
    assert dataset.read_cache_basis(str(tmp_path / "b.npz")) == "given"
    # a part that is not there yet: exit code 1, as the JAX script's
    assert merge_chunks.main(["--prefix", prefix, "--n", "10", "--chunk",
                              "3", "--out", str(tmp_path / "m.npz")]) == 1
    assert not (tmp_path / "m.npz").exists()
    with pytest.raises(SystemExit) as exc:
        _run_jax_script("merge_chunks", ["--prefix", prefix, "--n", "10",
                                         "--chunk", "3", "--out",
                                         str(tmp_path / "jm.npz")])
    assert exc.value.code == 1


# ---- profile_step -------------------------------------------------------------

COMPONENTS = ["full", "no_kernel", "no_norm", "readout_mlp_depth1",
              "no_radial_sbf", "opt_ema_only"]


def test_profile_step_components_stubs_and_keys(monkeypatch):
    """Every component the JAX script times, in its order and keys; the
    stubs run on the same parameters; no_kernel and opt_ema_only run no
    attention forward or backward, the others conv_layers x the batch's
    windows per step."""
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("blocked_attention_fwd", "fwd"),
                      ("blocked_attention_bwd", "bwd")):
        real = getattr(blocked_attn, name)

        def counted(*args, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(blocked_attn, name, counted)
    seen = []
    real_chain = profile_step.chain_time

    def chain_time(step, state, batch, iters, device):
        calls.update(fwd=0, bwd=0)
        ms = real_chain(step, state, batch, iters, device)
        seen.append((dict(calls), [tuple(p.shape) for p in state.params]))
        return ms

    monkeypatch.setattr(profile_step, "chain_time", chain_time)
    out = json.loads(_stdout(profile_step.main, ["--batch", "2", "--iters",
                                                 "1", "--device", "cpu"]))
    assert set(out) == {"batch", "components"} <= _dict_keys("profile_step")
    assert list(out["components"]) == COMPONENTS
    jax_src = open(_jax_script("profile_step")).read()
    for name in COMPONENTS:
        assert f'"{name}"' in jax_src, name
        assert set(out["components"][name]) == {"ms", "delta_vs_full_ms"}
    counts = dict(zip(COMPONENTS, [c for c, _ in seen]))
    shapes = dict(zip(COMPONENTS, [s for _, s in seen]))
    flagship = [tuple(p.shape) for p in X2GNN(
        ModelConfig(attention_layout="blocked"), device="cpu").parameters()]
    for name in ("full", "no_kernel", "no_norm", "no_radial_sbf",
                 "opt_ema_only"):
        assert shapes[name] == flagship, name
    assert len(shapes["readout_mlp_depth1"]) < len(flagship)
    graphs = synthetic_dataset(2, mean_atoms=13, seed=5)
    b = pad_graphs(graphs, pad_budget_for(graphs, 2))
    steps = 2 + 3 * 1
    per = 4 * len(attention_windows(*b.in_edges.shape, b.n_hi, b.d_lo,
                                    b.tiers)) * steps
    for name in ("full", "no_norm", "readout_mlp_depth1", "no_radial_sbf"):
        assert counts[name] == {"fwd": per, "bwd": per}, name
    for name in ("no_kernel", "opt_ema_only"):
        assert counts[name] == {"fwd": 0, "bwd": 0}, name


# ---- bench_infer, debug_ep_cost -------------------------------------------------

def test_bench_infer_prints_the_jax_scripts_keys():
    out = _stdout(bench_infer.main, ["--molecules", "8", "--batch-size",
                                     "4", "--iters", "1", "--device", "cpu"])
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == _dict_keys("bench_infer")
    assert line["metric"] == "serving_throughput" and line["value"] > 0
    assert line["vs_baseline"] is None


def test_debug_ep_cost_prints_the_jax_scripts_pieces(monkeypatch):
    # 2 molecules and one timed call each: the CPU runs the full width
    monkeypatch.setattr(debug_ep_cost, "run", functools.partial(
        debug_ep_cost.run, B=2, iters=1))
    out = _stdout(debug_ep_cost.main, ["--device", "cpu"])
    lines = out.strip().splitlines()
    assert lines[0].startswith("N=") and " D=" in lines[0]
    names = [ln.split()[0] for ln in lines[1:]]
    assert names == _printed_names("debug_ep_cost")
    assert all(float(ln.split()[1]) > 0 for ln in lines[1:])
    assert not torch.distributed.is_initialized()


# ---- bench_scaling ------------------------------------------------------------

def test_bench_scaling_on_two_gloo_ranks_prints_virtual_dp_lines():
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "x2gnn_tpu_torch.scripts.bench_scaling",
         "--force-cpu-devices", "2", "--modes", "dp,ep", "--mols-per-device",
         "2", "--mean-atoms", "5", "--iters", "1"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert [(x["mode"], x["n_devices"]) for x in lines] == [
        ("single", 1), ("dp", 2), ("ep", 2)]
    keys = _dict_keys("bench_scaling")
    for x in lines:
        assert x["virtual"] is True and set(x) <= keys
        assert x["ms_per_step"] > 0 and x["edges_per_s"] > 0
    assert lines[0]["efficiency"] == 1.0


# ---- pack_ab ------------------------------------------------------------------

def _metrics(path, steps_per_epoch, vals):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "metrics.jsonl"), "w") as f:
        for e, v in enumerate(vals):
            f.write(json.dumps({"epoch": e + 1,
                                "step": steps_per_epoch * (e + 1),
                                "best_val_mae": v}) + "\n")
        f.write("torn line\n")


def test_pack_ab_report_is_the_jax_scripts(tmp_path):
    """val_at_steps equals the JAX function at every step; --report-only
    prints and writes what the JAX script does on the same runs."""
    jax_ns = runpy.run_path(_jax_script("pack_ab"))
    _metrics(tmp_path / "packed", 11, [9.0, 7.5, 7.5, 6.0, 5.2])
    for name in ("port", "jax"):
        _metrics(tmp_path / name, 13, [9.5, 8.0, 6.1])
    _metrics(tmp_path / "mixed", 12, [8.8, 7.0, 6.6, 6.5])
    packed = pack_ab.read_metrics(str(tmp_path / "packed" / "metrics.jsonl"))
    assert packed == jax_ns["read_metrics"](
        str(tmp_path / "packed" / "metrics.jsonl"))
    for step in range(0, 60):
        assert pack_ab.val_at_steps(packed, step) == \
            jax_ns["val_at_steps"](packed, step)
    common = ["--packed", str(tmp_path / "packed"), "--mixed",
              str(tmp_path / "mixed"), "--report-only", "--steps", "40"]
    got = _stdout(pack_ab.main, common + ["--workdir", str(tmp_path /
                                                           "port")])
    want = _run_jax_script("pack_ab", common + ["--workdir",
                                                str(tmp_path / "jax")])
    assert got == want
    for name in ("port", "jax"):
        with open(tmp_path / name / "ab_summary.json") as f:
            assert json.load(f) == json.loads(got)


# ---- pipeline_demo ----------------------------------------------------------------

def test_pipeline_demo_streams_two_epochs(tmp_path):
    """The JAX script's keys but the TPU run's constant, two epochs of
    streamed steps."""
    cache = make_synthetic.build_dataset(
        40, "geo40", seed=7, mean_atoms=6, chunk=20,
        cache_dir=str(tmp_path), workers=1, geometry_only=True)
    out = json.loads(_stdout(pipeline_demo.main, [
        "--cache", cache, "--division", "4", "8", "--workdir",
        str(tmp_path / "demo"), "--device", "cpu"]))
    dropped = "cached_50k_flagship_ms_per_step_prior_run"
    assert set(out) == _dict_keys("pipeline_demo") - {dropped}
    assert out["steps_per_epoch"] == 1            # 32 training molecules
    assert out["epoch1_s"] > 0 and out["epoch2_s"] > 0
    np.testing.assert_allclose(out["ms_per_step_prefetch"],
                               1e3 * out["epoch2_s"])
    with open(tmp_path / "demo" / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2
