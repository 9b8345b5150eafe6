"""The native integral engine: csrc/integrals.cpp, built by g++ at first
use and loaded through ctypes (x2gnn_tpu/data/integrals/engine.py:25-126,
build.py:14-20).

    g++ -O3 -march=native -shared -fPIC -fopenmp -o <lib> csrc/integrals.cpp

The library goes to `build/integrals/` beside the package (a directory
that .gitignore lists), named by a hash of its source, the flags and the
host's `-march=native` target, so an edited source or another host's CPU
gets a build of its own and a stale library is never loaded. It is
written to a temporary file and renamed, so processes that build it at
once never load a half-written one.

`one_electron_matrices` runs the C++ engine and raises if g++ or the load
fails: it never drops to the numpy engine. That engine
(`md.one_electron_matrices_numpy`) is the plain version, which the tests
hold the C++ engine against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np

from x2gnn_tpu_torch.data.integrals.basis import (
    ANGSTROM_TO_BOHR, BasisSet, fallback_basis)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "integrals.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "build", "integrals")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")

_lib: Optional[ctypes.CDLL] = None


class Built(NamedTuple):
    path: str        # the shared library
    seconds: float   # wall time of the g++ run, 0.0 if it was built before


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: it builds the native integral "
                           "engine (csrc/integrals.cpp)")
    return found


def library_path() -> str:
    """Where the library for this source, these flags and this host's CPU
    lives (built or not)."""
    # the target options -march=native resolves to on this host: a library
    # built for another CPU may hold instructions this one lacks
    target = subprocess.run(
        [_gxx(), "-march=native", "-Q", "--help=target"],
        check=True, capture_output=True, text=True).stdout
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(
            f.read() + " ".join(GXX_FLAGS).encode() + target.encode()
        ).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libx2integrals-{digest}.so")


def build(verbose: bool = False) -> Built:
    """Compile the engine if this host has no library for its source yet;
    with `verbose`, the g++ command goes to stderr before it runs.
    Raises if g++ fails."""
    path = library_path()
    if os.path.exists(path):
        return Built(path, 0.0)
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_gxx(), *GXX_FLAGS, "-o", tmp, _SRC]
    if verbose:
        print(" ".join(cmd), file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC} (exit {proc.returncode})"
                           f":\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return Built(path, time.perf_counter() - t0)


def load() -> ctypes.CDLL:
    """The engine's library, built first if needed; loaded once per
    process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build().path)
    lib.x2_one_electron.restype = ctypes.c_int
    lib.x2_one_electron.argtypes = [
        ctypes.c_int,                                      # natoms
        np.ctypeslib.ndpointer(np.int64, flags="C"),       # Z
        np.ctypeslib.ndpointer(np.float64, flags="C"),     # xyz (bohr)
        ctypes.c_int,                                      # nshells
        np.ctypeslib.ndpointer(np.int64, flags="C"),       # shell_atom
        np.ctypeslib.ndpointer(np.int64, flags="C"),       # shell_l
        np.ctypeslib.ndpointer(np.int64, flags="C"),       # prim_offset
        np.ctypeslib.ndpointer(np.int64, flags="C"),       # prim_count
        np.ctypeslib.ndpointer(np.float64, flags="C"),     # exps
        np.ctypeslib.ndpointer(np.float64, flags="C"),     # coefs
        ctypes.c_int,                                      # nao
        np.ctypeslib.ndpointer(np.float64, flags="C"),     # S out
        np.ctypeslib.ndpointer(np.float64, flags="C"),     # T out
        np.ctypeslib.ndpointer(np.float64, flags="C"),     # V out
    ]
    # OpenMP's own entry point, found through the library's libgomp
    lib.omp_set_num_threads.argtypes = [ctypes.c_int]
    lib.omp_set_num_threads.restype = None
    _lib = lib
    return lib


def set_num_threads(n: int) -> None:
    """OpenMP threads of the engine's calls from the calling thread (a
    process pool's worker sets its share of the cores). In a process that
    has loaded torch, the engine links torch's OpenMP runtime, so this
    sets torch's intra-op threads of the calling thread too."""
    load().omp_set_num_threads(max(int(n), 1))


def _flatten_basis(numbers: np.ndarray, basis: BasisSet):
    shell_atom, shell_l, prim_off, prim_cnt = [], [], [], []
    exps, coefs = [], []
    nao = 0
    ao_slices = np.zeros((len(numbers), 2), dtype=np.int64)
    for ia, z in enumerate(numbers):
        ao_slices[ia, 0] = nao
        for sh in basis.shells_for(int(z)):
            shell_atom.append(ia)
            shell_l.append(sh.l)
            prim_off.append(len(exps))
            prim_cnt.append(len(sh.exponents))
            exps.extend(sh.exponents.tolist())
            # primitive norms folded in (Shell.weighted_coefficients) so
            # the C++ loop's plain ca*cb contraction is correct for
            # multi-primitive shells
            coefs.extend(sh.weighted_coefficients.tolist())
            nao += sh.num_sph
        ao_slices[ia, 1] = nao
    return (np.asarray(shell_atom, np.int64), np.asarray(shell_l, np.int64),
            np.asarray(prim_off, np.int64), np.asarray(prim_cnt, np.int64),
            np.asarray(exps, np.float64), np.asarray(coefs, np.float64),
            nao, ao_slices)


def one_electron_matrices(
    numbers: np.ndarray,
    positions_angstrom: np.ndarray,
    basis: Optional[BasisSet] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(S, Hcore/nelec, ao_slices) of a molecule from the C++ engine, every
    AO normalized to unit self-overlap; `basis` defaults to 'x2sv'."""
    lib = load()
    basis = basis or fallback_basis()
    numbers = np.ascontiguousarray(numbers, dtype=np.int64)
    xyz = np.ascontiguousarray(
        np.asarray(positions_angstrom, np.float64) * ANGSTROM_TO_BOHR)
    (shell_atom, shell_l, prim_off, prim_cnt, exps, coefs, nao,
     ao_slices) = _flatten_basis(numbers, basis)
    S = np.zeros((nao, nao))
    T = np.zeros((nao, nao))
    V = np.zeros((nao, nao))
    rc = lib.x2_one_electron(
        len(numbers), numbers, xyz, len(shell_atom), shell_atom, shell_l,
        prim_off, prim_cnt, exps, coefs, nao, S, T, V)
    if rc != 0:
        raise RuntimeError(f"native integral engine failed: rc={rc}")
    norm = 1.0 / np.sqrt(np.diag(S))
    S = S * norm[:, None] * norm[None, :]
    H = (T + V) * norm[:, None] * norm[None, :]
    nelec = int(numbers.sum())
    return S, H / max(nelec, 1), ao_slices
