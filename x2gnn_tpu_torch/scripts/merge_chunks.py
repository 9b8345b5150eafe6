"""The first N molecules of a chunked build as one graph cache
(scripts/merge_chunks.py), e.g. the 50k slice of a running 134k build:

    python -m x2gnn_tpu_torch.scripts.merge_chunks \\
        --prefix processed/_synthq134k_6311_chunk --n 50000 --chunk 2000 \\
        --out processed/synthq50k_6311.npz [--basis "6-311+g(3df,2p)-native"]

Reads the parts <prefix><lo:07d>.npz that `data/make_synthetic.py` writes
(each written to a temporary file and renamed, so reading finished parts
while later ones are being built is safe) and keeps the first --n
molecules. The basis tag is the first part's unless --basis is given. A
missing part exits with code 1.
"""

from __future__ import annotations

import argparse
import os
import sys

from x2gnn_tpu_torch.data.dataset import (
    load_graph_cache, read_cache_basis, save_graph_cache)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prefix", required=True)
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--chunk", type=int, default=2000)
    ap.add_argument("--out", required=True)
    ap.add_argument("--basis", default=None)
    args = ap.parse_args(argv)

    graphs = []
    basis = args.basis
    for lo in range(0, args.n, args.chunk):
        part = f"{args.prefix}{lo:07d}.npz"
        if not os.path.exists(part):
            print(f"missing {part} - featurizer not there yet",
                  file=sys.stderr)
            return 1
        graphs.extend(load_graph_cache(part))
        if basis is None:
            basis = read_cache_basis(part)
    graphs = graphs[:args.n]
    save_graph_cache(args.out, graphs, basis=basis)
    print(f"wrote {args.out}: {len(graphs)} graphs, basis={basis}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
