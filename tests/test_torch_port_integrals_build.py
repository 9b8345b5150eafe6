"""The integral engine's build CLI, `python -m
x2gnn_tpu_torch.data.integrals.build` (the port of
x2gnn_tpu/data/integrals/build.py): it prints the library the engine
loads, a second run rebuilds nothing, a compile prints its g++ command on
stderr, and a host without g++ is told so."""

import os
import subprocess
import sys

import pytest

from test_torch_port_guards import REPO, SCANNED_MODULES
from x2gnn_tpu_torch.data.integrals import build, engine


def _cli():
    out = subprocess.run(
        [sys.executable, "-m", "x2gnn_tpu_torch.data.integrals.build"],
        cwd=str(REPO), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def test_the_cli_prints_the_engines_library_and_rebuilds_nothing_twice():
    """The first run (which compiles on a host without the library)
    prints one path, the one the engine loads, and the file is there; the
    second prints the same path, runs no g++ (no command on stderr) and
    the engine then finds the library built."""
    first = _cli()
    lines = first.stdout.strip().splitlines()
    assert len(lines) == 1
    assert lines[0] == engine.library_path()
    assert os.path.isfile(lines[0])
    second = _cli()
    assert second.stdout == first.stdout
    assert second.stderr == ""
    assert engine.build() == (lines[0], 0.0)


def test_a_compile_prints_its_gxx_command(tmp_path, monkeypatch, capsys):
    """In an empty build directory `build()` compiles: the g++ command
    (the reference's flags, the output beside the library) goes to stderr
    and the library lands where `library_path` says; a second call prints
    nothing and returns the same path."""
    monkeypatch.setattr(engine, "_BUILD_DIR", str(tmp_path))
    path = build.build()
    err = capsys.readouterr().err.strip().splitlines()
    assert path == engine.library_path()
    assert os.path.dirname(path) == str(tmp_path) and os.path.isfile(path)
    assert len(err) == 1
    cmd = err[0].split()
    assert os.path.basename(cmd[0]) == "g++"
    assert tuple(cmd[1:6]) == engine.GXX_FLAGS
    assert cmd[-3] == "-o" and cmd[-2].startswith(path)
    assert cmd[-1].endswith(os.path.join("csrc", "integrals.cpp"))
    assert build.build() == path
    assert capsys.readouterr().err == ""
    assert build.build(verbose=False) == path


def test_without_gxx_the_build_raises_naming_it(monkeypatch):
    monkeypatch.setattr(engine.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        build.build()


def test_the_cli_is_in_the_no_jax_scan():
    assert "data/integrals/build.py" in SCANNED_MODULES
