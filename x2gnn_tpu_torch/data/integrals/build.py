"""Build the native integral engine ahead of its first use:

    python -m x2gnn_tpu_torch.data.integrals.build

The port of x2gnn_tpu/data/integrals/build.py:14-25. It compiles
csrc/integrals.cpp with g++ (the command goes to stderr, as the
reference prints it) and prints the library's path on stdout, so a host
compiles the engine once before it spawns featurizing workers, which
then load it (`engine.load`) and build nothing of their own.

Two deliberate differences from the reference:

- the library goes to `build/integrals/libx2integrals-<hash>.so`
  (`engine.library_path`: a hash of the source, the flags and the host's
  `-march=native` target), not into csrc/: the port never writes into its
  source tree;
- a second run rebuilds nothing: it finds the library of this source,
  these flags and this CPU, prints its path and runs no g++.
"""

from __future__ import annotations

import sys

from x2gnn_tpu_torch.data.integrals import engine


def build(verbose: bool = True) -> str:
    """The engine's library, compiled first if this host has none for its
    source; returns its path. Raises if g++ is missing or fails."""
    return engine.build(verbose=verbose).path


def main() -> int:
    print(build())
    return 0


if __name__ == "__main__":
    sys.exit(main())
