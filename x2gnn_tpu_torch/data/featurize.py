"""Featurization provenance (x2gnn_tpu/data/featurize.py:160-195).

Graph caches and training runs carry the basis tag of the integral
features they were built from; evaluation refuses to mix two tags. The
featurizer itself (the integral engine, `basis_provenance`,
`resolve_backend`) is not ported yet (ROADMAP A11).
"""

from __future__ import annotations

import warnings

# The pyscf backend computes exact 6-311+G(3df,2p) integrals; the native
# engine runs either the embedded published 6-311+G(3df,2p) data
# ('native6311', tagged -native since its precision differs from libcint)
# or the project-defined 'x2sv' stand-in (same AO structure, other
# exponents). Different tags are NOT numerically interchangeable.
BACKEND_BASIS = {"pyscf": "6-311+g(3df,2p)",
                 "native6311": "6-311+g(3df,2p)-native",
                 "native": "x2sv",
                 "zero": "zero"}


def check_basis_compatible(run_basis, data_basis, allow: bool = False,
                           context: str = "") -> None:
    """Raise ValueError (or warn with allow=True) when a checkpoint's
    featurization basis and the evaluation data's basis are both known and
    different. 'unknown'/None tags (caches written before provenance
    tagging) are not checked."""
    def known(b):
        return b not in (None, "", "unknown")

    if known(run_basis) and known(data_basis) and run_basis != data_basis:
        msg = (f"featurization basis mismatch{context}: the checkpoint "
               f"was trained on '{run_basis}' features but this data is "
               f"'{data_basis}' — the two bases (pyscf 6-311+G(3df,2p), "
               "scf.py:31, vs the native 'x2sv') are not numerically "
               "interchangeable and predictions would be silently wrong. "
               "Refeaturize with the matching backend, or override with "
               "allow_basis_mismatch / --allow-basis-mismatch.")
        if allow:
            warnings.warn(msg)
        else:
            raise ValueError(msg)
