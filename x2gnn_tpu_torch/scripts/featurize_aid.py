"""Resumable featurizing of an xyz file in chunks (scripts/featurize_aid.py):

    python -m x2gnn_tpu_torch.scripts.featurize_aid --xyz AID_kcal.xyz \\
        [--chunk 24] [--cache-dir ./processed] [--backend native]

Featurizes --chunk molecules at a time with `featurize_molecules` (the
port's integral engine over a pool of all cores), saves each part as
<cache-dir>/_<name>_<backend>_chunk<lo:05d>.npz and skips a part that
exists with the expected number of molecules; a part of another length
(an earlier run with another --chunk) is featurized again (:56-67). Then
writes the canonical cache <name>_<backend>_c5.npz that `load_dataset`
(and so the training CLI's --data, evaluate and aid_cv) finds, and
removes the parts. Does nothing if that cache exists. It touches no
device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from x2gnn_tpu_torch.data.dataset import (
    featurize_molecules, load_graph_cache, save_graph_cache)
from x2gnn_tpu_torch.data.featurize import basis_provenance, resolve_backend
from x2gnn_tpu_torch.data.molecule import read_xyz


def part_path(cache_dir: str, name: str, backend: str, lo: int) -> str:
    return os.path.join(cache_dir, f"_{name}_{backend}_chunk{lo:05d}.npz")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--xyz", required=True)
    ap.add_argument("--chunk", type=int, default=24)
    ap.add_argument("--cache-dir", default="./processed")
    ap.add_argument("--backend", default="native")
    args = ap.parse_args(argv)

    # the resolved name, so that load_dataset finds the cache
    backend = resolve_backend(args.backend)
    os.makedirs(args.cache_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(args.xyz))[0]
    final = os.path.join(args.cache_dir, f"{name}_{backend}_c5.npz")
    if os.path.exists(final):
        print(f"{final} already exists", file=sys.stderr)
        return 0

    mols = read_xyz(args.xyz)
    print(f"{len(mols)} molecules", file=sys.stderr, flush=True)
    starts = range(0, len(mols), args.chunk)
    all_graphs = []
    for lo in starts:
        part = part_path(args.cache_dir, name, backend, lo)
        expected = len(mols[lo:lo + args.chunk])
        if os.path.exists(part):
            cached = load_graph_cache(part)
            # a part is named by its start only: under another --chunk it
            # holds other molecules and is featurized again
            if len(cached) == expected:
                all_graphs.extend(cached)
                print(f"chunk {lo}: cached", file=sys.stderr, flush=True)
                continue
            print(f"chunk {lo}: cached length {len(cached)} != {expected} "
                  "(different --chunk?) - refeaturizing", file=sys.stderr,
                  flush=True)
        t0 = time.time()
        graphs = featurize_molecules(mols[lo:lo + args.chunk],
                                     backend=backend)
        save_graph_cache(part, graphs, basis=basis_provenance(backend))
        all_graphs.extend(graphs)
        print(f"chunk {lo}: {len(graphs)} molecules in "
              f"{time.time() - t0:.0f}s", file=sys.stderr, flush=True)
    save_graph_cache(final, all_graphs, basis=basis_provenance(backend))
    print(f"wrote {final} ({len(all_graphs)} graphs)", file=sys.stderr)
    for lo in starts:
        part = part_path(args.cache_dir, name, backend, lo)
        if os.path.exists(part):
            os.remove(part)
    return 0


if __name__ == "__main__":
    sys.exit(main())
