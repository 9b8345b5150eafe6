"""Guards of the port: it imports nothing of JAX or the JAX package, and
its entry points never fall back to the CPU when no card is present."""

import ast
import os
import pathlib

import numpy as np
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


# modules of the port the no-JAX scan must reach (each is checked to be
# among the scanned files)
SCANNED_MODULES = (
    "train/trainer.py", "train/optim.py", "train/ema.py", "train/loss.py",
    "train/checkpoint.py", "train/__main__.py", "data/molecule.py",
    "profile_training.py", "data/dataset.py", "data/featurize.py",
    "evaluate.py", "infer.py", "utils/determinism.py",
    "utils/torch_ckpt.py", "utils/profiling.py", "utils/parity.py",
    "data/prefetch.py", "data/synthetic.py", "data/make_synthetic.py",
    "data/integrals/basis.py", "data/integrals/md.py",
    "data/integrals/engine.py", "data/integrals/build.py",
    "models/x2gnn.py", "nn/conv.py", "ops/attention.py", "ops/segment.py",
    "ops/basis.py", "data/batching.py", "parallel/mesh.py",
    "parallel/data_parallel.py", "parallel/ep_model.py",
    "parallel/hybrid.py", "parallel/edge_partition.py",
    "parallel/__init__.py", "__init__.py", "scripts/aid_cv.py",
    "scripts/featurize_aid.py", "scripts/merge_chunks.py",
    "scripts/profile_step.py", "scripts/bench_infer.py",
    "scripts/debug_ep_cost.py", "scripts/bench_scaling.py",
    "scripts/pack_ab.py", "scripts/pipeline_demo.py",
    "scripts/prepare_qm9.py")


def test_port_imports_no_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 25
    scanned = {str(p.relative_to(REPO)) for p in files}
    for module in SCANNED_MODULES:
        assert f"x2gnn_tpu_torch/{module}" in scanned, module
    bad = [(str(p.relative_to(REPO)), name) for p in files
           for name in _imports(p)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


# the reference's top-level names (x2gnn_tpu/__init__.py:20-37): three at
# import, three on first use
EXPORTS = ("__version__", "ModelConfig", "TrainConfig")
LAZY_EXPORTS = ("X2GNN", "Predictor", "Trainer")


def _fresh_python(code):
    """Run `code` in a new interpreter from the repository root; its
    stdout's last line as JSON."""
    import json
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_package_exports_the_reference_names():
    """`import x2gnn_tpu_torch` gives every name `import x2gnn_tpu` gives:
    __version__, ModelConfig and TrainConfig at import, X2GNN, Predictor
    and Trainer on first use; the package's import loads no torch."""
    code = """
import json, sys
import x2gnn_tpu, x2gnn_tpu_torch as p
eager = {n: hasattr(p, n) for n in %r}
torch_loaded = "torch" in sys.modules
lazy = {n: getattr(p, n).__module__ for n in %r}
ref = [n for n in %r + %r if hasattr(x2gnn_tpu, n)]
print(json.dumps([eager, torch_loaded, lazy, ref, p.__version__,
                  x2gnn_tpu.__version__]))
""" % (EXPORTS, LAZY_EXPORTS, EXPORTS, LAZY_EXPORTS)
    eager, torch_loaded, lazy, ref, version, ref_version = \
        _fresh_python(code)
    assert all(eager.values()) and not torch_loaded
    assert lazy == {"X2GNN": "x2gnn_tpu_torch.models.x2gnn",
                    "Predictor": "x2gnn_tpu_torch.infer",
                    "Trainer": "x2gnn_tpu_torch.train.trainer"}
    assert ref == list(EXPORTS + LAZY_EXPORTS) and version == ref_version
    import x2gnn_tpu_torch
    with pytest.raises(AttributeError):
        x2gnn_tpu_torch.NoSuchName


def test_importing_the_package_starts_no_process_group_or_process():
    """Importing the package and every module of its parallel paths
    initializes no torch.distributed process group and starts no child
    process or thread."""
    code = """
import json, multiprocessing, threading
before = threading.active_count()
import x2gnn_tpu_torch
import x2gnn_tpu_torch.parallel
from x2gnn_tpu_torch import Trainer, X2GNN, Predictor
import x2gnn_tpu_torch.train.__main__
import torch.distributed as dist
print(json.dumps([dist.is_initialized(),
                  len(multiprocessing.active_children()),
                  threading.active_count() - before]))
"""
    assert _fresh_python(code) == [False, 0, 0]


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


def test_training_entry_points_default_to_the_card(tmp_path):
    """The Trainer, the training CLI and every `x2gnn_tpu_torch.scripts`
    module that runs the model want the card unless given --device cpu
    (the scripts' tests run each so: tests/test_torch_port_scripts_*.py);
    featurize_aid, merge_chunks and prepare_qm9 touch no device, and
    pack_ab only to launch its arm."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import importlib
    import json
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
    packed = tmp_path / "packed"
    packed.mkdir()
    (packed / "metrics.jsonl").write_text(json.dumps(
        {"step": 1, "best_val_mae": 1.0}) + "\n")
    argv = {"aid_cv": ["--data", str(tmp_path / "none.xyz")],
            "profile_step": [], "bench_infer": [], "debug_ep_cost": [],
            "bench_scaling": [],
            "pack_ab": ["--packed", str(packed), "--workdir",
                        str(tmp_path / "arm")],
            "pipeline_demo": ["--cache", str(tmp_path / "none.npz")]}
    scripts = sorted(p.stem for p in (REPO / "x2gnn_tpu_torch" /
                                      "scripts").glob("[!_]*.py"))
    assert scripts == sorted(set(argv) | {"featurize_aid", "merge_chunks",
                                          "prepare_qm9"})
    for name, args in argv.items():
        main = importlib.import_module(f"x2gnn_tpu_torch.scripts.{name}").main
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)
    assert not os.path.exists(tmp_path / "arm")


# every file of the JAX package's scripts/ and bench.py: the port's
# counterpart, or why it has none
JAX_SCRIPTS = {
    "aid_cv.py": "x2gnn_tpu_torch.scripts.aid_cv",
    "bench_dropout.py": "chip_smoke.py phase 9 (the kernels' dropout mask)",
    "bench_ep_kernel.py": "chip_smoke.py phase 13 (the kernel in the EP "
                          "step)",
    "bench_infer.py": "x2gnn_tpu_torch.scripts.bench_infer",
    "bench_kernel_ba.py": "x2gnn_tpu_torch.ops.blocked_attn (fwd_plan, "
                          "bwd_plan: the CUDA kernels' launch plans)",
    "bench_kernel_lscaling.py": "chip_smoke.py (K=9, head widths), "
                                "x2gnn_tpu_torch.profile_training",
    "bench_large_degree.py": "chip_smoke.py phases 3, 6 and 16 (D > 40)",
    "bench_scaling.py": "x2gnn_tpu_torch.scripts.bench_scaling",
    "debug_ep_cost.py": "x2gnn_tpu_torch.scripts.debug_ep_cost",
    "dist_smoke.py": "x2gnn_tpu_torch.parallel.mesh (initialize_distributed)",
    "featurize_aid.py": "x2gnn_tpu_torch.scripts.featurize_aid",
    "import_torch_ckpt.py": "x2gnn_tpu_torch.utils.torch_ckpt",
    "make_synthetic_dataset.py": "x2gnn_tpu_torch.data.make_synthetic",
    "merge_chunks.py": "x2gnn_tpu_torch.scripts.merge_chunks",
    "pack_ab.py": "x2gnn_tpu_torch.scripts.pack_ab",
    "pipeline_demo.py": "x2gnn_tpu_torch.scripts.pipeline_demo",
    "prepare_qm9.py": "x2gnn_tpu_torch.scripts.prepare_qm9",
    "profile_step.py": "x2gnn_tpu_torch.scripts.profile_step",
    "profile_trace.py": "x2gnn_tpu_torch.profile_training, "
                        "Trainer.fit(profile_dir=)",
    "run_flagship.sh": "x2gnn_tpu_torch.train --config "
                       "runs/flagship_r5_regression/args.json",
    "run_gap_molwise.sh": "x2gnn_tpu_torch.train --config "
                          "runs/gap_molwise_r4/args.json",
    "run_gap_r5.sh": "x2gnn_tpu_torch.train --config "
                     "runs/gap_r5_50k/args.json",
    "run_ref134k.sh": "x2gnn_tpu_torch.train --config "
                      "runs/ref_scale_134k/args.json",
    "../bench.py": "none: what a benchmark measures is a benchmark PR's "
                   "BENCHMARK.json",
}


def test_every_jax_script_has_a_counterpart_or_a_reason():
    """The table names every file of scripts/ (a new one fails here until
    it is ported or given its reason); each module it names imports, and
    each other counterpart names a module that imports, chip_smoke.py or
    none with its reason."""
    import importlib
    files = {p.name for p in (REPO / "scripts").iterdir() if p.is_file()}
    assert files | {"../bench.py"} == set(JAX_SCRIPTS)
    for script, counterpart in JAX_SCRIPTS.items():
        head = counterpart.split()[0].rstrip(",")
        if head.startswith("x2gnn_tpu_torch."):
            module = head
            while module:
                try:
                    importlib.import_module(module)
                    break
                except ImportError:
                    module = module.rpartition(".")[0]
            assert module.count(".") >= 1, (script, counterpart)
        else:
            assert head in ("chip_smoke.py", "none:"), (script, counterpart)
        if counterpart.startswith("x2gnn_tpu_torch.scripts."):
            assert head == f"x2gnn_tpu_torch.scripts.{script[:-3]}"
    for config in ("flagship_r5_regression", "gap_molwise_r4", "gap_r5_50k",
                   "ref_scale_134k"):
        assert (REPO / "runs" / config / "args.json").exists(), config


# every module of the JAX package (x2gnn_tpu/, relative to it) and every
# Python file at the repository's root but chip_smoke.py (as ../<name>):
# the port's counterpart, a module that must import, with the files it
# needs after "+"; or chip_smoke.py, a tests/ file, or none with its reason
JAX_MODULES = {
    "__init__.py": "x2gnn_tpu_torch",
    "config.py": "x2gnn_tpu_torch.config",
    "data/__init__.py": "x2gnn_tpu_torch.data",
    "data/batching.py": "x2gnn_tpu_torch.data.batching",
    "data/dataset.py": "x2gnn_tpu_torch.data.dataset",
    "data/featurize.py": "x2gnn_tpu_torch.data.featurize",
    "data/graphs.py": "x2gnn_tpu_torch.data.graphs",
    "data/integrals/__init__.py": "x2gnn_tpu_torch.data.integrals",
    "data/integrals/basis.py": "x2gnn_tpu_torch.data.integrals.basis",
    "data/integrals/build.py": "x2gnn_tpu_torch.data.integrals.build",
    "data/integrals/engine.py": "x2gnn_tpu_torch.data.integrals.engine "
                                "+ x2gnn_tpu_torch/data/integrals/csrc/"
                                "integrals.cpp",
    "data/integrals/md.py": "x2gnn_tpu_torch.data.integrals.md",
    "data/molecule.py": "x2gnn_tpu_torch.data.molecule",
    "data/prefetch.py": "x2gnn_tpu_torch.data.prefetch",
    "data/synthetic.py": "x2gnn_tpu_torch.data.synthetic",
    "infer.py": "x2gnn_tpu_torch.infer",
    "models/__init__.py": "x2gnn_tpu_torch.models",
    "models/x2gnn.py": "x2gnn_tpu_torch.models.x2gnn",
    "nn/__init__.py": "x2gnn_tpu_torch.nn",
    "nn/conv.py": "x2gnn_tpu_torch.nn.conv",
    "nn/init.py": "x2gnn_tpu_torch.nn.init",
    "nn/layers.py": "x2gnn_tpu_torch.nn.layers",
    "nn/norm.py": "x2gnn_tpu_torch.nn.norm",
    "nn/readout.py": "x2gnn_tpu_torch.nn.readout",
    "ops/__init__.py": "x2gnn_tpu_torch.ops",
    "ops/attention.py": "x2gnn_tpu_torch.ops.attention",
    "ops/basis.py": "x2gnn_tpu_torch.ops.basis",
    "ops/segment.py": "x2gnn_tpu_torch.ops.segment",
    # the Pallas package: its one kernel file's entry, re-exported
    "ops/pallas/__init__.py": "x2gnn_tpu_torch.ops.blocked_attn",
    "ops/pallas/blocked_attn.py": "x2gnn_tpu_torch.ops.blocked_attn "
                                  "+ x2gnn_tpu_torch/ops/csrc/"
                                  "blocked_attn_fwd.cu "
                                  "+ x2gnn_tpu_torch/ops/csrc/"
                                  "blocked_attn_bwd.cu "
                                  "+ x2gnn_tpu_torch/ops/_build.py",
    "parallel/__init__.py": "x2gnn_tpu_torch.parallel",
    "parallel/data_parallel.py": "x2gnn_tpu_torch.parallel.data_parallel",
    "parallel/edge_partition.py": "x2gnn_tpu_torch.parallel.edge_partition",
    "parallel/ep_model.py": "x2gnn_tpu_torch.parallel.ep_model",
    "parallel/hybrid.py": "x2gnn_tpu_torch.parallel.hybrid",
    "parallel/mesh.py": "x2gnn_tpu_torch.parallel.mesh",
    "train/__init__.py": "x2gnn_tpu_torch.train",
    "train/checkpoint.py": "x2gnn_tpu_torch.train.checkpoint",
    "train/ema.py": "x2gnn_tpu_torch.train.ema",
    "train/loss.py": "x2gnn_tpu_torch.train.loss",
    "train/optim.py": "x2gnn_tpu_torch.train.optim",
    "train/trainer.py": "x2gnn_tpu_torch.train.trainer",
    "utils/__init__.py": "x2gnn_tpu_torch.utils",
    "utils/determinism.py": "x2gnn_tpu_torch.utils.determinism",
    "utils/parity.py": "x2gnn_tpu_torch.utils.parity",
    "utils/profiling.py": "x2gnn_tpu_torch.utils.profiling",
    "utils/torch_ckpt.py": "x2gnn_tpu_torch.utils.torch_ckpt",
    "utils/torch_oracle.py": "tests/test_torch_port_oracle.py: the JAX "
                             "package's test oracle; the port is held to "
                             "it and keeps no copy",
    "../train.py": "x2gnn_tpu_torch.train.__main__",
    "../evaluate.py": "x2gnn_tpu_torch.evaluate",
    "../bench.py": JAX_SCRIPTS["../bench.py"],
    "../__graft_entry__.py": "chip_smoke.py: the card's entry, which "
                             "checks the kernels and drives the main path",
}


def jax_module_files(root):
    """The JAX package's modules under `root` (x2gnn_tpu/**/*.py, relative
    to x2gnn_tpu/) and the root's Python files but chip_smoke.py (as
    ../<name>)."""
    root = pathlib.Path(root)
    package = root / "x2gnn_tpu"
    files = {p.relative_to(package).as_posix()
             for p in package.rglob("*.py")}
    return files | {f"../{p.name}" for p in root.glob("*.py")
                    if p.name != "chip_smoke.py"}


def unmapped_jax_modules(root):
    """(the files of `jax_module_files(root)` JAX_MODULES lacks, the
    entries of JAX_MODULES with no such file)."""
    files = jax_module_files(root)
    return files - set(JAX_MODULES), set(JAX_MODULES) - files


def test_every_jax_module_has_a_counterpart_or_a_reason():
    """JAX_MODULES names exactly the JAX package's modules and the root's
    files (a new JAX module fails here until it is ported or given its
    reason); each module it names imports, each file after "+" exists,
    and the others name chip_smoke.py, a tests/ file that exists, or
    none with its reason."""
    import importlib
    assert unmapped_jax_modules(REPO) == (set(), set())
    for jax_file, counterpart in JAX_MODULES.items():
        head, *needs = [t.strip() for t in counterpart.split(" + ")]
        name = head.split()[0].rstrip(":")
        if name.startswith("x2gnn_tpu_torch"):
            importlib.import_module(name)
        elif name.startswith("tests/"):
            assert (REPO / name).is_file(), (jax_file, counterpart)
        else:
            assert name in ("chip_smoke.py", "none"), (jax_file, counterpart)
            assert len(head.split()) > 3, (jax_file, "a reason is given")
        for path in needs:
            assert (REPO / path).is_file(), (jax_file, path)
    ported = {m.split()[0] for m in JAX_MODULES.values()}
    assert "x2gnn_tpu_torch.data.integrals.build" in ported


@pytest.mark.parametrize("change", ["a new module", "a removed module",
                                    "a new root file"])
def test_the_module_table_flags_a_changed_jax_tree(tmp_path, change):
    """In a copy of the JAX package and the root's files, an extra .py file
    is a module the table lacks, and a removed one an entry without a
    file."""
    import shutil
    shutil.copytree(REPO / "x2gnn_tpu", tmp_path / "x2gnn_tpu",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for p in REPO.glob("*.py"):
        shutil.copy(p, tmp_path / p.name)
    assert unmapped_jax_modules(tmp_path) == (set(), set())
    if change == "a new module":
        (tmp_path / "x2gnn_tpu" / "ops" / "extra.py").write_text("")
        assert unmapped_jax_modules(tmp_path) == ({"ops/extra.py"}, set())
    elif change == "a removed module":
        (tmp_path / "x2gnn_tpu" / "nn" / "norm.py").unlink()
        assert unmapped_jax_modules(tmp_path) == (set(), {"nn/norm.py"})
    else:
        (tmp_path / "serve.py").write_text("")
        assert unmapped_jax_modules(tmp_path) == ({"../serve.py"}, set())


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


# ---- every configuration field is honoured or refused -----------------------
#
# A field of the port's ModelConfig or TrainConfig that a run's args.json
# sets must change what the port does, or raise NotImplementedError naming
# its ROADMAP item: a field that is read and ignored fails here. Each field
# has a probe that sets one non-default value the reference honours and
# compares what the port does with it against a base run.

# read for compatibility with the reference's args.json, which records them:
# the port always runs the kernel formulation (use_pallas), plans its own
# budgets (pad_*), and, as the reference, trains with smooth L1 and
# evaluates on the EMA weights (loss, eval_on_ema are read by neither);
# param_dtype's only use in the reference is its definition
# (x2gnn_tpu/config.py:48): parameters are float32 whatever it says
COMPAT_ONLY = {"use_pallas", "pad_nodes", "pad_edges", "pad_triplets",
               "loss", "eval_on_ema", "param_dtype"}

GUARD_MODEL = dict(conv_layers=1, in_channels=32, embedding_size=32,
                   heads=4, sbf_dim=7, rbf_dim=6, edge_feat_dim=8,
                   attention_layout="blocked")

# ModelConfig field -> (value, how the probe observes it)
MODEL_PROBES = {
    "conv_layers": (2, "predict"), "sbf_dim": (5, "predict"),
    "rbf_dim": (4, "predict"), "in_channels": (64, "predict"),
    "embedding_size": (16, "predict"), "heads": (8, "predict"),
    "cutoff": (4.0, "predict"), "envelope_exponent": (6, "predict"),
    "edge_feat_dim": (6, "predict"), "readout": ("molwise_add", "predict"),
    "mlp_depth": (2, "predict"), "compute_dtype": ("bfloat16", "predict"),
    "dropout": (0.3, "train forward"),
    "remat": (True, "attention forwards in a backward"),
    "beta": (True, "predict"), "attention_layout": ("padded", "predict"),
    "variant": ("v2", "predict"),
}

GUARD_TRAIN = dict(batch_size=4, max_epoch=2, ckpt_after_epoch=5)
# TrainConfig field -> (value, base run's own settings): the probe is a
# short Trainer.fit, observed through its metrics, files, state and
# parameters; `target` through the training CLI, which picks the readout
TRAIN_PROBES = {
    "target": (4, None), "batch_size": (3, {}), "random_seed": (7, {}),
    "division": ((3, 6), {}), "max_epoch": (3, {}), "max_lr": (5e-3, {}),
    "scheduler": ("plateau", {}), "warmup_steps": (1, {}),
    "decay_steps": (1, {}), "decay_rate": (0.5, {}),
    # the plateau's scale with frozen weights (max_lr 0): a worse-or-equal
    # val MAE every epoch
    "reduce_factor": (0.5, dict(scheduler="plateau", patience=0,
                                max_lr=0.0)),
    "patience": (1, dict(scheduler="plateau", patience=0, max_lr=0.0)),
    "grad_clip": (False, dict(max_grad=1e-3)), "max_grad": (1e-3, {}),
    "ema_decay": (0.5, {}), "accum_steps": (2, {}),
    "ckpt_after_epoch": (0, {}), "ckpt_every": (1, {}),
    "bucket_shapes": (2, {}), "pack_budget": (True, dict(bucket_shapes=1)),
    "pack_mixed": (True, {}), "fused_update": (True, {}),
}


def _guard_graphs(cfg, n=12):
    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    return synthetic_dataset(n, mean_atoms=6, seed=5, cutoff=cfg.cutoff,
                             edge_feat_dim=cfg.edge_feat_dim)


def _model_observation(cfg, how):
    from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
    from x2gnn_tpu_torch.models.x2gnn import X2GNN, needs_triplets
    from x2gnn_tpu_torch.ops import blocked_attn
    graphs = _guard_graphs(cfg, 4)
    batch = pad_graphs(graphs, pad_budget_for(graphs, 4),
                       with_triplets=needs_triplets(cfg)).to("cpu")
    model = X2GNN(cfg, torch.Generator().manual_seed(0), device="cpu")
    if how == "predict":
        with torch.no_grad():
            return model(batch).numpy()
    if how == "train forward":
        with torch.no_grad():
            return model(batch, deterministic=False,
                         generator=torch.Generator().manual_seed(1)).numpy()
    calls = []
    real = blocked_attn.blocked_attention_fwd

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocked_attn, "blocked_attention_fwd", counted)
        pred = model(batch)
        torch.autograd.grad(pred.sum(), list(model.parameters()))
    return len(calls)


@pytest.mark.parametrize("field", [
    f.name for f in __import__("dataclasses").fields(
        __import__("x2gnn_tpu_torch.config", fromlist=["ModelConfig"])
        .ModelConfig)])
def test_every_model_config_field_is_honoured_or_refused(field):
    import dataclasses
    import numpy as np
    from x2gnn_tpu_torch.config import ModelConfig
    if field in COMPAT_ONLY:
        return
    assert field in MODEL_PROBES, f"no probe for ModelConfig.{field}"
    value, how = MODEL_PROBES[field]
    base = ModelConfig(**GUARD_MODEL)
    assert getattr(base, field) != value
    changed = dataclasses.replace(base, **{field: value})
    if how == "refused":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _model_observation(changed, "predict")
        return
    got = _model_observation(changed, how)
    ref = _model_observation(base, how)
    assert not np.array_equal(got, ref), f"ModelConfig.{field}={value!r} " \
        "changes nothing"


def _train_observation(tcfg, workdir):
    """What a short run shows: its metrics but the wall clock's, its
    files, the number of parameter tensors the optimizer holds and the
    final parameters."""
    import json
    import os
    import numpy as np
    from x2gnn_tpu_torch.config import ModelConfig
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.train.trainer import Trainer
    cfg = ModelConfig(**GUARD_MODEL)
    graphs = _guard_graphs(cfg)
    model = X2GNN(cfg, torch.Generator().manual_seed(0), device="cpu")
    trainer = Trainer(model, cfg, tcfg, graphs,
                      np.array([g.y[0] for g in graphs], np.float32),
                      workdir=str(workdir), device="cpu")
    state, _ = trainer.fit()
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        records = [{k: v for k, v in json.loads(line).items()
                    if k != "seconds" and not k.endswith("_per_sec")}
                   for line in f]
    params = np.concatenate([p.detach().numpy().reshape(-1)
                             for p in model.parameters()])
    return (records, sorted(os.listdir(workdir)), len(state.params),
            params.tobytes())


def _cli_readout(tmp_path, name, train):
    import json
    from x2gnn_tpu_torch.config import load_configs
    from x2gnn_tpu_torch.train.__main__ import main
    config = tmp_path / f"{name}.json"
    config.write_text(json.dumps({"model": GUARD_MODEL, "train": train}))
    workdir = tmp_path / name
    assert main(["--device", "cpu", "--synthetic", "8", "--epochs", "1",
                 "--config", str(config), "--workdir", str(workdir)]) == 0
    return load_configs(str(workdir / "args.json"))[0].readout


@pytest.mark.parametrize("field", [
    f.name for f in __import__("dataclasses").fields(
        __import__("x2gnn_tpu_torch.config", fromlist=["TrainConfig"])
        .TrainConfig)])
def test_every_train_config_field_is_honoured_or_refused(field, tmp_path):
    import dataclasses
    from x2gnn_tpu_torch.config import TrainConfig
    if field in COMPAT_ONLY:
        return
    assert field in TRAIN_PROBES, f"no probe for TrainConfig.{field}"
    value, own = TRAIN_PROBES[field]
    if own is None:    # read by the CLI: the target picks the readout
        base = _cli_readout(tmp_path, "base", GUARD_TRAIN)
        got = _cli_readout(tmp_path, "changed", {**GUARD_TRAIN,
                                                 field: value})
        assert got != base, f"TrainConfig.{field}={value!r} changes nothing"
        return
    base = TrainConfig(**{**GUARD_TRAIN, **own})
    assert getattr(base, field) != value
    changed = dataclasses.replace(base, **{field: value})
    got = _train_observation(changed, tmp_path / "changed")
    ref = _train_observation(base, tmp_path / "base")
    assert got != ref, f"TrainConfig.{field}={value!r} changes nothing"


def test_the_probes_name_real_fields():
    import dataclasses
    from x2gnn_tpu_torch.config import ModelConfig, TrainConfig
    model = {f.name for f in dataclasses.fields(ModelConfig)}
    train = {f.name for f in dataclasses.fields(TrainConfig)}
    assert set(MODEL_PROBES) | (COMPAT_ONLY & model) == model
    assert set(TRAIN_PROBES) | (COMPAT_ONLY & train) == train


# ---- the featurizing entry points are honoured, the rest refused -----------

GUARD_338 = {**GUARD_MODEL, "edge_feat_dim": 338}


def _guard_xyz(tmp_path):
    from x2gnn_tpu_torch.data.molecule import Molecule, write_xyz
    from x2gnn_tpu_torch.data.synthetic import synthetic_geometry
    mols = [Molecule(*synthetic_geometry(i, seed=4, mean_atoms=5), [0.5 * i],
                     i) for i in range(8)]
    path = tmp_path / "guard.xyz"
    write_xyz(str(path), mols)
    return path, mols


def test_featurizing_entry_points_are_honoured(tmp_path, capsys):
    """--data (the training CLI and evaluate) and Predictor.predict_xyz /
    predict_molecules featurize molecules, once, into the cache they
    share."""
    import json
    from x2gnn_tpu_torch.evaluate import main as evaluate_main
    from x2gnn_tpu_torch.infer import Predictor
    from x2gnn_tpu_torch.train.__main__ import main
    xyz, mols = _guard_xyz(tmp_path)
    config = tmp_path / "guard.json"
    config.write_text(json.dumps({"model": GUARD_338,
                                  "train": {**GUARD_TRAIN, "max_epoch": 1,
                                            "ckpt_after_epoch": 0}}))
    cache = tmp_path / "processed"
    common = ["--data", str(xyz), "--backend", "native", "--cache-dir",
              str(cache), "--device", "cpu"]
    assert main(common + ["--config", str(config), "--workdir",
                          str(tmp_path / "run")]) == 0
    assert sorted(os.listdir(cache)) == ["guard_native_c5.npz"]
    capsys.readouterr()
    assert evaluate_main(common + ["--ckpt", str(tmp_path / "run" /
                                                 "ckpt_best.pt")]) == 0
    assert json.loads(capsys.readouterr().out)["count"] == 8
    pred = Predictor.from_run(str(tmp_path / "run"), device="cpu")
    got = pred.predict_xyz(str(xyz), backend="native",
                           cache_dir=str(cache))
    np.testing.assert_array_equal(
        got, pred.predict_molecules(mols, backend="native"))
    assert got.shape == (8,) and np.isfinite(got).all()


@pytest.mark.parametrize("layout", ["padded", "segment"])
def test_layout_flags_train_and_evaluate(layout, tmp_path, capsys):
    """--layout trains the flat-edge model (its args.json records the
    layout) and evaluate --layout evaluates in it."""
    import json
    from x2gnn_tpu_torch.config import load_configs
    from x2gnn_tpu_torch.evaluate import main as evaluate_main
    from x2gnn_tpu_torch.train.__main__ import main
    config = tmp_path / "guard.json"
    config.write_text(json.dumps({"model": GUARD_MODEL,
                                  "train": {**GUARD_TRAIN, "max_epoch": 1,
                                            "ckpt_after_epoch": 0}}))
    workdir = tmp_path / "run"
    assert main(["--device", "cpu", "--synthetic", "8", "--config",
                 str(config), "--layout", layout, "--workdir",
                 str(workdir)]) == 0
    assert load_configs(str(workdir / "args.json"))[0].attention_layout \
        == layout
    capsys.readouterr()
    assert evaluate_main(["--ckpt", str(workdir / "ckpt_best.pt"),
                          "--synthetic", "8", "--layout", layout,
                          "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["count"] == 8 and np.isfinite(out["mae"])


def test_param_dtype_is_read_and_ignored_in_both_packages():
    """param_dtype="bfloat16" gives the float32 predictions and float32
    parameters in the JAX package, which reads it nowhere, and in the
    port."""
    import dataclasses
    import jax
    from x2gnn_tpu.config import ModelConfig as JaxModelConfig
    from x2gnn_tpu.data import batching as jbatching
    from x2gnn_tpu.models import X2GNN as JaxX2GNN
    from x2gnn_tpu_torch.config import ModelConfig
    from x2gnn_tpu_torch.data.batching import pad_budget_for, pad_graphs
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    cfg = ModelConfig(**GUARD_MODEL)
    graphs = _guard_graphs(cfg, 4)
    bud = pad_budget_for(graphs, 4)
    batch = pad_graphs(graphs, bud).to("cpu")
    jb = jbatching.pad_graphs(graphs, jbatching.Budgets(*bud),
                              with_triplets=False)
    preds, jpreds = [], []
    for dtype in ("float32", "bfloat16"):
        model = X2GNN(dataclasses.replace(cfg, param_dtype=dtype),
                      torch.Generator().manual_seed(0), device="cpu")
        assert {p.dtype for p in model.parameters()} == {torch.float32}
        with torch.no_grad():
            preds.append(model(batch).numpy())
        jcfg = JaxModelConfig(**{**GUARD_MODEL, "param_dtype": dtype,
                                 "use_pallas": False})
        params = JaxX2GNN(jcfg).init(jax.random.PRNGKey(0), jb)
        assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(
            params)} == {np.dtype(np.float32)}
        jpreds.append(np.asarray(JaxX2GNN(jcfg).apply(params, jb)))
    np.testing.assert_array_equal(preds[1], preds[0])
    np.testing.assert_array_equal(jpreds[1], jpreds[0])
