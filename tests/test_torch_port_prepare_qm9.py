"""`x2gnn_tpu_torch.scripts.prepare_qm9` against scripts/prepare_qm9.py on
a synthetic mini QM9 tree, offline: the repacked file byte for byte, the
port's `read_xyz_allprop` against the JAX reader on it, and `main` on a
pre-placed tarball with the download replaced by one that raises."""

import io
import os
import sys
import tarfile
import urllib.request

import numpy as np
import pytest

from x2gnn_tpu.data.molecule import read_xyz_allprop as jax_read_xyz_allprop
from x2gnn_tpu_torch.data.molecule import read_xyz_allprop
from x2gnn_tpu_torch.scripts import prepare_qm9

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import prepare_qm9 as jax_prepare_qm9  # noqa: E402


# the synthetic mini tree of tests/test_prepare_qm9.py: one real-format
# QM9 entry per molecule (atom count; comment line of gdb tag, index, 3
# rotational constants and 12 properties; atom lines with a fifth
# Mulliken column; frequencies, SMILES and InChI trailer lines)
def _qm9_file(n_atoms, index, props15, atoms):
    lines = [f"{n_atoms}"]
    lines.append("gdb " + str(index) + "\t" + "\t".join(props15))
    lines += atoms
    lines.append("100.0\t200.0\t300.0")      # frequencies
    lines.append("C\tC")                     # SMILES
    lines.append("InChI=1S/C\tInChI=1S/C")   # InChI
    return "\n".join(lines) + "\n"


def _mini_tree():
    """{file name: text} of three molecules, with QM9's `*^` exponents in
    properties and positions."""
    props1 = [f"{100 + k:.4f}" for k in range(15)]
    atoms1 = [
        "C\t-0.012698\t1.085804\t0.008001\t-0.535689",
        "H\t0.002150\t-0.006031\t0.001976\t0.133921",
        "H\t1.011731\t1.463751\t0.000277\t0.133922",
        "H\t-0.540815\t1.447527\t-0.876644\t0.133923",
        "H\t-0.523814\t1.437933\t0.906397\t0.133923",
    ]
    props2 = [f"{k:.3f}" for k in range(13)] + ["1.2*^-5", "2.5*^-6"]
    atoms2 = ["N\t0.0\t0.0\t5.975*^-3\t-0.3", "N\t0.0\t0.0\t1.1\t0.3"]
    props3 = [f"{-k * 0.731:.6f}" for k in range(15)]
    atoms3 = ["O\t0.1\t-0.2\t0.3\t-0.4", "H\t0.9*^0\t0.0\t0.0\t0.2",
              "H\t-0.3\t0.87\t-1.5*^-2\t0.2"]
    return {"dsgdb9nsd_000001.xyz": _qm9_file(5, 1, props1, atoms1),
            "dsgdb9nsd_000002.xyz": _qm9_file(2, 2, props2, atoms2),
            "dsgdb9nsd_000003.xyz": _qm9_file(3, 3, props3, atoms3)}


def _write_tree(directory):
    directory.mkdir()
    for name, text in _mini_tree().items():
        (directory / name).write_text(text)


def test_repack_equals_the_jax_scripts_byte_for_byte(tmp_path):
    _write_tree(tmp_path / "dsgdb9nsd_xyz")
    ours, ref = tmp_path / "port.xyz", tmp_path / "jax.xyz"
    prepare_qm9.repack(str(tmp_path / "dsgdb9nsd_xyz"), str(ours), count=3)
    jax_prepare_qm9.repack(str(tmp_path / "dsgdb9nsd_xyz"), str(ref),
                           count=3)
    assert ours.read_bytes() == ref.read_bytes()
    content = ours.read_text()
    assert "InChI" not in content and "200.0" not in content


def test_read_xyz_allprop_equals_the_jax_reader(tmp_path):
    _write_tree(tmp_path / "dsgdb9nsd_xyz")
    out = str(tmp_path / "qm9.xyz")
    prepare_qm9.repack(str(tmp_path / "dsgdb9nsd_xyz"), out, count=3)
    got, want = read_xyz_allprop(out), jax_read_xyz_allprop(out)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.index == w.index
        for field in ("numbers", "positions", "labels"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
    np.testing.assert_array_equal(got[1].labels[-2:], [1.2e-5, 2.5e-6])
    assert got[1].positions[0, 2] == 5.975e-3


def test_repack_missing_file_raises(tmp_path):
    (tmp_path / "dsgdb9nsd_xyz").mkdir()
    with pytest.raises(FileNotFoundError):
        prepare_qm9.repack(str(tmp_path / "dsgdb9nsd_xyz"),
                           str(tmp_path / "out.xyz"), count=1)


def test_main_runs_offline_on_a_placed_tarball(tmp_path, monkeypatch,
                                               capsys):
    """A tarball placed in --workdir is used as it is: the download (made
    to raise) is never called, the tree is extracted and repacked into
    the same bytes as the JAX repack of the same files; a second run
    extracts nothing again."""
    work = tmp_path / "raw"
    work.mkdir()
    with tarfile.open(work / "dsgdb9nsd.xyz.tar.bz2", "w:bz2") as tf:
        for name, text in _mini_tree().items():
            data = text.encode()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))

    def no_network(*args, **kw):
        raise AssertionError("the download was called")
    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    monkeypatch.setattr(prepare_qm9, "QM9_COUNT", 3)
    out = tmp_path / "qm9_origin.xyz"
    argv = ["--out", str(out), "--workdir", str(work)]
    assert prepare_qm9.main(argv) == 0
    assert capsys.readouterr().out.strip() == str(out)
    ref = tmp_path / "jax.xyz"
    jax_prepare_qm9.repack(str(work / "dsgdb9nsd_xyz"), str(ref), count=3)
    assert out.read_bytes() == ref.read_bytes()
    # an extracted tree is kept: its files are what a second run repacks
    (work / "dsgdb9nsd_xyz" / "dsgdb9nsd_000003.xyz").write_text(
        _mini_tree()["dsgdb9nsd_000001.xyz"])
    assert prepare_qm9.main(argv) == 0
    assert out.read_bytes() != ref.read_bytes()
    assert len(read_xyz_allprop(str(out))) == 3
