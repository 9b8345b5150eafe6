"""xyz files to featurized MolGraphs, graph caches and training targets
(x2gnn_tpu/data/dataset.py).

`featurize_molecules` builds each molecule's graph and integral features
(over a process pool for the quantum backends); `load_dataset` does it
for an xyz file once and keeps the result as a cache under `cache_dir`,
tagged as the reference tags it (`<name>_<backend>_c<cutoff>[_n<limit>]`),
so each package finds the other's caches. A cache is one uncompressed
npz of the molecules' ragged arrays, concatenated, with per-molecule
counts and a featurization-basis tag. The port reads caches the JAX
package writes and the other way round: every field keeps the dtype it
was saved with.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
from typing import List, Optional, Sequence

import numpy as np

from x2gnn_tpu_torch.data.featurize import (
    EDGE_FEAT_DIM, basis_provenance, edge_features, resolve_backend)
from x2gnn_tpu_torch.data.graphs import MolGraph, build_mol_graph
from x2gnn_tpu_torch.data.molecule import (
    EXTENSIVE_TARGETS, Molecule, atomization_target, read_xyz,
    read_xyz_allprop)


def _featurize_one(args) -> MolGraph:
    idx, numbers, positions, labels, cutoff, backend, replicate_bug = args
    mol = Molecule(numbers, positions, labels, idx)
    g = build_mol_graph(numbers, positions, labels, cutoff=cutoff,
                        edge_feat_dim=EDGE_FEAT_DIM, index=idx)
    if backend != "zero":
        g.edge_feat[:] = edge_features(
            mol, g.edge_index, backend=backend,
            replicate_reference_bug=replicate_bug)
    return g


def _worker_threads(threads: int) -> None:
    """Pool initializer: the integral engine's OpenMP threads in this
    worker."""
    from x2gnn_tpu_torch.data.integrals.engine import set_num_threads
    set_num_threads(threads)


# the thread counts of OpenMP and of the BLAS libraries (numpy's and
# scipy's eigensolvers), read when a process loads them
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS")


@contextlib.contextmanager
def worker_pool(workers: int):
    """A pool of `workers` processes, each running the integral engine and
    the BLAS on its share of the host's cores (`workers` x threads never
    oversubscribes them). The workers are spawned, not forked: a spawned
    process reads its thread counts when it starts, and a fork of a
    process that holds the card or runs threads can hang. The features
    are the same either way."""
    threads = max((os.cpu_count() or 1) // workers, 1)
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update({k: str(threads) for k in _THREAD_VARS})
    try:
        pool = multiprocessing.get_context("spawn").Pool(
            processes=workers, initializer=_worker_threads,
            initargs=(threads,))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with pool:
        yield pool


def featurize_molecules(
    mols: Sequence[Molecule],
    cutoff: float = 5.0,
    backend: str = "zero",
    num_workers: Optional[int] = None,
    replicate_reference_bug: bool = False,
) -> List[MolGraph]:
    """MolGraphs (graph structure and integral features) of `mols`, in
    order. A quantum backend fans out over `num_workers` processes (all
    cores by default; 1 or fewer featurizes in this process), each running
    the engine on its share of the cores."""
    jobs = [(m.index, m.numbers, m.positions, m.labels, cutoff, backend,
             replicate_reference_bug) for m in mols]
    if backend == "zero" or (num_workers is not None and num_workers <= 1):
        return [_featurize_one(j) for j in jobs]
    if resolve_backend(backend) != "pyscf":
        # build the engine once here, not in every worker at once
        from x2gnn_tpu_torch.data.integrals.engine import build
        build()
    workers = num_workers or os.cpu_count() or 1
    with worker_pool(workers) as pool:
        return pool.map(_featurize_one, jobs,
                        chunksize=max(1, min(16, len(jobs) // workers)))


def save_graph_cache(path: str, graphs: Sequence[MolGraph],
                     basis: Optional[str] = None) -> None:
    """Write `graphs` to the npz `path`: concatenated ragged arrays plus
    counts. `basis` tags the featurization provenance
    (`featurize.BACKEND_BASIS`); evaluation checks it against the
    training run's tag."""
    payload = {
        "basis": np.array(basis if basis is not None else "unknown"),
        "numbers": np.concatenate([g.numbers for g in graphs]),
        "positions": np.concatenate([g.positions for g in graphs]),
        "edge_index": np.concatenate(
            [g.edge_index for g in graphs], axis=1),
        "edge_feat": np.concatenate([g.edge_feat for g in graphs]),
        "triplet_index": np.concatenate(
            [g.triplet_index for g in graphs], axis=1),
        "atom_j": np.concatenate([g.atom_j for g in graphs]),
        "atom_i": np.concatenate([g.atom_i for g in graphs]),
        "atom_k": np.concatenate([g.atom_k for g in graphs]),
        "y": np.stack([g.y for g in graphs]),
        "n_atoms": np.array([g.num_atoms for g in graphs]),
        "n_edges": np.array([g.num_edges for g in graphs]),
        "n_trips": np.array([g.num_triplets for g in graphs]),
        "index": np.array([g.index for g in graphs]),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # uncompressed: a compressed member is decompressed whole on every
    # read. Written to a temporary file and renamed, so a crash never
    # leaves a truncated cache that a reader would trust.
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def read_cache_basis(path: str) -> str:
    """Featurization-basis tag of a graph cache ('unknown' for caches
    written before provenance tagging)."""
    with np.load(path) as zf:
        if "basis" in zf.files:
            return str(zf["basis"])
    return "unknown"


def load_graph_cache(path: str) -> List[MolGraph]:
    """The MolGraphs of a cache, each field with its saved dtype."""
    with np.load(path) as zf:
        # read every member once: indexing a lazy NpzFile member reads it
        # again on each access
        z = {k: np.asarray(zf[k]) for k in zf.files}
    n_off = np.concatenate([[0], np.cumsum(z["n_atoms"])])
    e_off = np.concatenate([[0], np.cumsum(z["n_edges"])])
    t_off = np.concatenate([[0], np.cumsum(z["n_trips"])])
    graphs = []
    for m in range(len(z["n_atoms"])):
        a0, a1 = n_off[m], n_off[m + 1]
        e0, e1 = e_off[m], e_off[m + 1]
        t0, t1 = t_off[m], t_off[m + 1]
        graphs.append(MolGraph(
            numbers=z["numbers"][a0:a1],
            positions=z["positions"][a0:a1],
            edge_index=z["edge_index"][:, e0:e1],
            edge_feat=z["edge_feat"][e0:e1],
            triplet_index=z["triplet_index"][:, t0:t1],
            atom_j=z["atom_j"][t0:t1],
            atom_i=z["atom_i"][t0:t1],
            atom_k=z["atom_k"][t0:t1],
            y=z["y"][m],
            index=int(z["index"][m]),
        ))
    return graphs


def load_dataset(
    xyz_path: str,
    cache_dir: str = "./processed",
    cutoff: float = 5.0,
    backend: str = "auto",
    multi_property: Optional[bool] = None,
    limit: Optional[int] = None,
    num_workers: Optional[int] = None,
) -> List[MolGraph]:
    """The featurized MolGraphs of an xyz file, from the cache
    `<cache_dir>/<name>_<backend>_c<cutoff>[_n<limit>].npz` if it exists,
    else featurized and saved there with the backend's basis tag. The
    labels stay raw (`prepare_targets` makes training targets). The tag
    names the resolved backend: 'auto' features differ between hosts with
    and without pyscf."""
    name = os.path.splitext(os.path.basename(xyz_path))[0]
    backend = resolve_backend(backend)
    tag = f"{name}_{backend}_c{cutoff:g}" + (f"_n{limit}" if limit else "")
    cache = os.path.join(cache_dir, tag + ".npz")
    if os.path.exists(cache):
        return load_graph_cache(cache)
    if multi_property is None:
        mols = read_xyz(xyz_path)   # the generic reader reads both layouts
    else:
        mols = (read_xyz_allprop if multi_property else read_xyz)(xyz_path)
    if limit:
        mols = mols[:limit]
    graphs = featurize_molecules(mols, cutoff=cutoff, backend=backend,
                                 num_workers=num_workers)
    save_graph_cache(cache, graphs, basis=basis_provenance(backend))
    return graphs


def prepare_targets(graphs: Sequence[MolGraph], target: int) -> np.ndarray:
    """Training targets (num_mols,) float32 from the graphs' labels: a
    single label as it is; the synthetic [energy, gap] pair by target
    family (extensive targets train the energy, intensive ones the gap,
    train_ema.py:41-44); 12 QM9 labels through `atomization_target`
    (train_ema.py:28-38)."""
    numbers = [g.numbers for g in graphs]
    labels = np.stack([g.y for g in graphs])
    if labels.shape[1] == 1:
        return labels[:, 0].astype(np.float32)
    if labels.shape[1] == 2:
        col = 0 if target in EXTENSIVE_TARGETS else 1
        return labels[:, col].astype(np.float32)
    return atomization_target(numbers, labels, target).astype(np.float32)
