"""The port's featurizer against the JAX package's, on the CPU: the xyz
readers, the basis sets, the numpy integral engine (bitwise), the port's
g++-built C++ engine (within the tolerances tests/test_integrals.py holds
the reference's to), the symmetry-adapted compression and the edge
features of every backend (bitwise on the same integrals)."""

import os

import numpy as np
import pytest

import x2gnn_tpu.data.integrals as jintegrals
from test_torch_port_model import one_torch_thread  # noqa: F401 (autouse)
from x2gnn_tpu.data import featurize as jfeaturize
from x2gnn_tpu.data import molecule as jmolecule
from x2gnn_tpu.data.graphs import radius_graph as jradius_graph
from x2gnn_tpu.data.integrals import basis as jbasis
from x2gnn_tpu.data.integrals import engine as jengine
from x2gnn_tpu.data.integrals import md as jmd
from x2gnn_tpu_torch.data import featurize, molecule
from x2gnn_tpu_torch.data.graphs import radius_graph
from x2gnn_tpu_torch.data.integrals import basis, engine, md

# S and H of the C++ engine against the numpy engine
# (tests/test_integrals.py::test_cpp_matches_numpy): the two sum the same
# terms in other orders, and the C++ engine screens negligible primitive
# pairs
S_TOL = dict(rtol=1e-10, atol=1e-12)
H_TOL = dict(rtol=1e-8, atol=1e-10)

# (name, atomic numbers, basis names the numpy engine runs them in): small,
# because the numpy engine takes ~1 s per heavy atom pair
MOLECULES = [("water", [8, 1, 1], ("x2sv", "6311")),
             ("HCN+H", [6, 1, 1, 7], ("x2sv", "6311")),
             ("CH3F", [1, 6, 1, 1, 9], ("x2sv",))]
BASIS_NAMES = {"x2sv": "x2sv", "6311": "6-311+g(3df,2p)"}


def _positions(n, seed):
    """Atoms 1.0-1.6 Angstrom apart on a random walk."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3))
    for i in range(1, n):
        step = rng.normal(size=3)
        pos[i] = pos[i - 1] + step / np.linalg.norm(step) * rng.uniform(
            1.0, 1.6)
    return pos


@pytest.fixture(scope="module")
def integrals():
    """{(molecule, basis): (numbers, positions, port numpy, JAX numpy,
    port C++)}: each engine run once per molecule and basis."""
    out = {}
    for k, (name, numbers, bases) in enumerate(MOLECULES):
        numbers = np.array(numbers)
        pos = _positions(len(numbers), seed=70 + k)
        for b in bases:
            out[name, b] = (
                numbers, pos,
                md.one_electron_matrices_numpy(
                    numbers, pos, basis.get_basis(BASIS_NAMES[b])),
                jmd.one_electron_matrices_numpy(
                    numbers, pos, jbasis.get_basis(BASIS_NAMES[b])),
                engine.one_electron_matrices(
                    numbers, pos, basis.get_basis(BASIS_NAMES[b])))
    return out


# ---- readers ---------------------------------------------------------------

def _write_concat_xyz(path, rng, n_mols, n_props, sci=False):
    """A concatenated xyz file: per molecule its atom count, `n_props`
    labels on one tab-joined line (Mathematica's `*^` exponent if `sci`),
    then the atoms."""
    lines = []
    for _ in range(n_mols):
        n = int(rng.integers(2, 7))
        lines.append(str(n))
        labels = rng.normal(size=n_props) * 10.0 ** rng.integers(-6, 4,
                                                                  n_props)
        fmt = [f"{v:.6e}".replace("e", "*^") if sci else repr(float(v))
               for v in labels]
        lines.append("\t".join(fmt))
        for _ in range(n):
            el = rng.choice(list(jmolecule.ATOMIC_NUMBER))
            x, y, z = rng.normal(size=3) * 2
            lines.append(f"{el}\t{x:.6f}\t{y:.6f}\t{z:.6f}")
    path.write_text("\n".join(lines) + "\n")


def _assert_molecules_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("numbers", "positions", "labels"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert g.index == w.index
        assert g.geometry_string() == w.geometry_string()


@pytest.mark.parametrize("layout", ["one label", "one label *^",
                                    "12 properties"])
def test_readers_match_jax(tmp_path, layout):
    """read_xyz (both layouts) and read_xyz_allprop, the `*^` exponent
    included, molecule for molecule; a QM9 reader refuses a file with
    another label count."""
    rng = np.random.default_rng(3)
    path = tmp_path / "mols.xyz"
    n_props = 12 if layout == "12 properties" else 1
    _write_concat_xyz(path, rng, 7, n_props, sci="*^" in layout)
    _assert_molecules_equal(molecule.read_xyz(str(path)),
                            jmolecule.read_xyz(str(path)))
    if n_props == 12:
        _assert_molecules_equal(molecule.read_xyz_allprop(str(path)),
                                jmolecule.read_xyz_allprop(str(path)))
    else:
        with pytest.raises(ValueError, match="expected 12 properties"):
            molecule.read_xyz_allprop(str(path))
    assert molecule.ATOMIC_NUMBER == jmolecule.ATOMIC_NUMBER
    assert molecule.ELEMENT_SYMBOL == jmolecule.ELEMENT_SYMBOL


def test_write_xyz_round_trips_bitwise(tmp_path):
    """write_xyz then read_xyz (either package's) gives the molecules back
    bit for bit, float64 positions and labels included."""
    rng = np.random.default_rng(4)
    mols = [molecule.Molecule(rng.choice([1, 6, 7, 8, 9], size=n),
                              rng.normal(size=(n, 3)) * 3,
                              rng.normal(size=k) * 1e3, i)
            for i, (n, k) in enumerate([(3, 1), (6, 2), (1, 12)])]
    path = str(tmp_path / "out.xyz")
    molecule.write_xyz(path, mols)
    _assert_molecules_equal(molecule.read_xyz(path), mols)
    _assert_molecules_equal(jmolecule.read_xyz(path), mols)


def test_readers_refuse_unknown_elements_and_truncation(tmp_path):
    for text, match in (("2\n1.0\nH 0 0 0\nS 1 0 0\n", "unknown element"),
                        ("3\n1.0\nH 0 0 0\nH 1 0 0\n", "truncated")):
        path = tmp_path / "bad.xyz"
        path.write_text(text)
        for reader in (molecule.read_xyz, jmolecule.read_xyz):
            with pytest.raises(ValueError, match=match):
                reader(str(path))


# ---- basis sets ------------------------------------------------------------

@pytest.mark.parametrize("name", ["x2sv", "6311"])
def test_basis_matches_jax_shell_for_shell(name):
    got = basis.get_basis(BASIS_NAMES[name])
    want = jbasis.get_basis(BASIS_NAMES[name])
    assert sorted(got.shells) == sorted(want.shells) == [1, 6, 7, 8, 9]
    for z in want.shells:
        assert len(got.shells_for(z)) == len(want.shells_for(z))
        assert got.nao(z) == want.nao(z) == (9 if z == 1 else 39)
        for a, b in zip(got.shells_for(z), want.shells_for(z)):
            assert a.l == b.l
            for f in ("exponents", "coefficients", "weighted_coefficients"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    with pytest.raises(ValueError, match="unknown basis"):
        basis.get_basis("sto-3g")


def test_basis_data_is_the_ports_own_copy():
    """The port reads its own copies of the basis data and the engine's
    source, none under the JAX package."""
    port = os.path.dirname(os.path.dirname(os.path.abspath(
        featurize.__file__)))
    for path in (basis._G94_DIR, engine._SRC):
        assert os.path.commonpath([port, os.path.abspath(path)]) == port
        assert os.path.exists(path)
    text = basis.parse_gaussian94(open(os.path.join(
        jbasis._G94_DIR, "6-311+g_3df_2p.g94")).read())
    assert text.nao(8) == basis.pople_6311g_3df_2p().nao(8)


# ---- integral engines ------------------------------------------------------

def test_numpy_engine_tables_match_jax():
    for l in range(4):
        assert md.cart_monomials(l) == jmd.cart_monomials(l)
        np.testing.assert_array_equal(md.solid_harmonic_coeffs(l),
                                      jmd.solid_harmonic_coeffs(l))
    for t in (0.0, 1e-13, 0.3, 7.5, 40.0):
        np.testing.assert_array_equal(md.boys(6, t), jmd.boys(6, t))


@pytest.mark.parametrize("key", [(name, b) for name, _, bases in MOLECULES
                                 for b in bases])
def test_numpy_engine_is_bitwise_the_reference(integrals, key):
    _, _, port, ref, _ = integrals[key]
    for got, want in zip(port, ref):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", [(name, b) for name, _, bases in MOLECULES
                                 for b in bases])
def test_cpp_engine_matches_both_numpy_engines(integrals, key):
    """The port's g++-built engine against the port's numpy engine and
    the JAX package's, S at rtol 1e-10 and H at rtol 1e-8; and against the
    JAX package's own C++ engine where that library loads."""
    numbers, pos, port, ref, (s, h, ao) = integrals[key]
    for s_np, h_np, ao_np in (port, ref):
        np.testing.assert_allclose(s, s_np, **S_TOL)
        np.testing.assert_allclose(h, h_np, **H_TOL)
        np.testing.assert_array_equal(ao, ao_np)
    np.testing.assert_allclose(np.diag(s), 1.0, rtol=1e-12)
    if jengine.native_available():
        js, jh, _ = jengine.one_electron_matrices_cpp(
            numbers, pos, jbasis.get_basis(BASIS_NAMES[key[1]]))
        np.testing.assert_allclose(s, js, **S_TOL)
        np.testing.assert_allclose(h, jh, **H_TOL)


def test_engine_library_is_named_by_its_source_and_loaded_once():
    built = engine.build()
    assert os.path.basename(built.path).startswith("libx2integrals-")
    assert engine.library_path() == built.path
    assert engine.build().seconds == 0.0          # built before: kept
    assert engine.load() is engine.load()
    engine.set_num_threads(1)


def test_engine_build_failure_raises(monkeypatch, tmp_path):
    """A g++ failure raises; nothing falls back to the numpy engine."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(engine, "_SRC", str(bad))
    monkeypatch.setattr(engine, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(engine, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        engine.one_electron_matrices(np.array([1, 1]),
                                     np.array([[0, 0, 0], [0.7, 0, 0.0]]))


# ---- compression and edge features -----------------------------------------

@pytest.mark.parametrize("replicate", [False, True])
def test_sa_compress_is_bitwise_the_reference(integrals, replicate):
    """On the same integral matrices, every directed edge's 338 features
    (and, with replicate_reference_bug, scf.py:69's top-left H rows)."""
    for key, (numbers, pos, port, _, _) in integrals.items():
        s, h, ao = port
        edges, _ = radius_graph(pos, 5.0)
        np.testing.assert_array_equal(edges, jradius_graph(pos, 5.0)[0])
        got = featurize.sa_compress(s, h, ao, edges, replicate)
        want = jfeaturize.sa_compress(s, h, ao, edges, replicate)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == (edges.shape[1], featurize.EDGE_FEAT_DIM)
        np.testing.assert_array_equal(got, want, err_msg=str(key))
    block = np.random.default_rng(6).normal(size=(9, 39))
    np.testing.assert_array_equal(
        featurize._pad_block(block, replicate),
        jfeaturize._pad_block(block, replicate))


@pytest.fixture
def same_integrals(integrals, monkeypatch):
    """Both packages' native backends on the port's numpy integrals of
    the molecule and basis they ask for (bitwise the JAX package's own,
    test_numpy_engine_is_bitwise_the_reference)."""
    def numpy_engine(numbers, positions, basis=None):
        basis = basis if basis is not None else jbasis.fallback_basis()
        first = basis.shells_for(1)[0].exponents[0]
        for name, b in integrals:
            numbers_k, pos_k, port, _, _ = integrals[name, b]
            if (np.array_equal(numbers_k, numbers)
                    and np.array_equal(pos_k, positions)
                    and first == jbasis.get_basis(
                        BASIS_NAMES[b]).shells_for(1)[0].exponents[0]):
                return port
        raise KeyError("molecule not in the fixture")

    monkeypatch.setattr(engine, "one_electron_matrices", numpy_engine)
    monkeypatch.setattr(jintegrals, "one_electron_matrices", numpy_engine)


@pytest.mark.parametrize("backend,replicate", [
    ("native", False), ("native", True), ("native6311", False),
    ("zero", False)])
def test_edge_features_are_bitwise_the_reference(same_integrals, integrals,
                                                  backend, replicate):
    want_basis = "6311" if backend == "native6311" else "x2sv"
    for (name, b), (numbers, pos, _, _, _) in integrals.items():
        if b != want_basis:
            continue
        mol = molecule.Molecule(numbers, pos, [0.0], 3)
        jmol = jmolecule.Molecule(numbers, pos, [0.0], 3)
        edges, _ = radius_graph(pos, 5.0)
        got = featurize.edge_features(mol, edges, backend=backend,
                                      replicate_reference_bug=replicate)
        want = jfeaturize.edge_features(jmol, edges, backend=backend,
                                        replicate_reference_bug=replicate)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert (backend == "zero") == (not got.any())
    with pytest.raises(ValueError, match="unknown featurizer backend"):
        featurize.edge_features(mol, edges, backend="sto")


@pytest.mark.parametrize("backend", ["auto", "pyscf", "native",
                                     "native6311", "zero"])
def test_backend_resolution_matches_jax(backend):
    assert featurize.pyscf_available() == jfeaturize.pyscf_available()
    assert featurize.resolve_backend(backend) == jfeaturize.resolve_backend(
        backend)
    assert featurize.basis_provenance(backend) == \
        jfeaturize.basis_provenance(backend)
    assert featurize.SA_DIM == jfeaturize.SA_DIM == 13
    assert featurize.EDGE_FEAT_DIM == jfeaturize.EDGE_FEAT_DIM == 338
