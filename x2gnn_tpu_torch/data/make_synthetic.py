"""Resumable builder of a labelled synthetic dataset, the port's
scripts/make_synthetic_dataset.py:

    python -m x2gnn_tpu_torch.data.make_synthetic --n 50000 \\
        --name synth6311_50k --basis 6311 [--gap-label] [--workers 8]

N deterministic synthetic molecules (`synthetic_labeled_graph`: sizes
around --mean-atoms, QM9-like degree statistics) with the native
integral engine's edge features and the independent-particle energy
label (and the HOMO-LUMO gap with --gap-label). Each molecule's geometry
comes from its own random stream, seeded by (--seed, index), so the
graphs and features do not depend on the chunking or the worker count
(the labels' last bits do: the eigensolver's threads sum in other
orders). The
molecules are featurized in chunks, each saved as
`<cache-dir>/_<name>_chunk<lo>.npz` and skipped when it exists (a killed
build resumes), then merged into `<cache-dir>/<name>.npz`, the cache that
`python -m x2gnn_tpu_torch.train --data-npz` reads. --geometry-only
skips the integrals: the same graphs with zero features and labels.
Each of the --workers processes runs the engine on its share of the
cores.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from x2gnn_tpu_torch.data.dataset import (
    load_graph_cache, save_graph_cache, worker_pool)
from x2gnn_tpu_torch.data.featurize import BACKEND_BASIS


def _make_one(args):
    index, seed, mean_atoms, featurize, basis, gap_label = args
    from x2gnn_tpu_torch.data.synthetic import synthetic_labeled_graph
    return synthetic_labeled_graph(index, seed=seed, mean_atoms=mean_atoms,
                                   featurize=featurize, basis=basis,
                                   gap_label=gap_label)


def basis_tag(basis: str, geometry_only: bool) -> str:
    """The cache's basis tag, as featurize.BACKEND_BASIS names it."""
    if geometry_only:
        return "geometry-only"
    return BACKEND_BASIS["native6311" if basis == "6311" else "native"]


def build_dataset(n: int, name: str, seed: int = 7, mean_atoms: int = 13,
                  chunk: int = 2000, cache_dir: str = "./processed",
                  workers: int = None, basis: str = "x2sv",
                  gap_label: bool = False,
                  geometry_only: bool = False) -> str:
    """Build (or finish building) `<cache_dir>/<name>.npz`; returns its
    path. An existing file is kept as it is."""
    os.makedirs(cache_dir, exist_ok=True)
    final = os.path.join(cache_dir, f"{name}.npz")
    if os.path.exists(final):
        print(f"{final} already exists", file=sys.stderr)
        return final
    tag = basis_tag(basis, geometry_only)
    workers = workers or os.cpu_count() or 1
    if not geometry_only:
        from x2gnn_tpu_torch.data.integrals.engine import build
        built = build()
        print(f"integral engine {built.path} ({built.seconds:.2f} s g++)",
              file=sys.stderr, flush=True)
    chunk_paths = []
    t_start = time.time()
    with worker_pool(workers) as pool:
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            part = os.path.join(cache_dir, f"_{name}_chunk{lo:07d}.npz")
            chunk_paths.append(part)
            if os.path.exists(part):
                print(f"chunk {lo}: cached", file=sys.stderr, flush=True)
                continue
            t0 = time.time()
            jobs = [(i, seed, mean_atoms, not geometry_only, basis,
                     gap_label) for i in range(lo, hi)]
            graphs = pool.map(_make_one, jobs, chunksize=max(
                1, min(16, len(jobs) // workers)))
            save_graph_cache(part, graphs, basis=tag)
            dt = max(time.time() - t0, 1e-9)
            print(f"chunk {lo}: {hi - lo} molecules in {dt:.1f} s "
                  f"({(hi - lo) / dt:.1f} mol/s; {hi}/{n})",
                  file=sys.stderr, flush=True)
    graphs = []
    for part in chunk_paths:
        graphs.extend(load_graph_cache(part))
    save_graph_cache(final, graphs, basis=tag)
    print(f"wrote {final} ({len(graphs)} graphs) in "
          f"{time.time() - t_start:.1f} s", file=sys.stderr)
    for part in chunk_paths:
        os.remove(part)
    return final


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=100000)
    p.add_argument("--name", default="synthq100k")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--mean-atoms", type=int, default=13)
    p.add_argument("--chunk", type=int, default=2000)
    p.add_argument("--cache-dir", default="./processed")
    p.add_argument("--workers", type=int, default=os.cpu_count())
    p.add_argument("--basis", default="x2sv", choices=["x2sv", "6311"],
                   help="integral basis: the project's stand-in or the "
                        "embedded published 6-311+G(3df,2p) (scf.py:31)")
    p.add_argument("--gap-label", action="store_true",
                   help="store y = [IP energy Hartree, HOMO-LUMO gap eV] "
                        "instead of the energy alone")
    p.add_argument("--geometry-only", action="store_true",
                   help="skip the integrals: the same graph per index, "
                        "zero edge features and labels (the batch shapes "
                        "of the featurized dataset)")
    args = p.parse_args(argv)
    print(build_dataset(args.n, args.name, seed=args.seed,
                        mean_atoms=args.mean_atoms, chunk=args.chunk,
                        cache_dir=args.cache_dir, workers=args.workers,
                        basis=args.basis, gap_label=args.gap_label,
                        geometry_only=args.geometry_only))
    return 0


if __name__ == "__main__":
    sys.exit(main())
