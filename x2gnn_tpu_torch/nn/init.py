"""Parameter initializers with the reference statistics
(x2gnn_tpu/nn/init.py:20-68), drawn from an explicit torch.Generator.

Weights are torch-layout (out, in). Bitwise parity with the JAX package's
random draws is out of scope; parity tests load identical weights.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def glorot_orthogonal_(w: torch.Tensor, scale: float = 2.0,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Fill `w` with an orthogonal matrix rescaled so that
    var(W) * (fan_in + fan_out) = scale, with the empirical unbiased
    variance in the denominator."""
    rows, cols = w.shape
    a = torch.randn(max(rows, cols), min(rows, cols), generator=generator,
                    dtype=torch.float32)
    qm, r = torch.linalg.qr(a)
    qm = qm * torch.sign(torch.diagonal(r))[None, :]
    if rows < cols:
        qm = qm.T
    qm = qm * torch.sqrt(scale / ((rows + cols) * torch.var(qm)))
    with torch.no_grad():
        w.copy_(qm)
    return w


def torch_linear_(w: torch.Tensor, b: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> None:
    """torch.nn.Linear's default: weight and bias U(-1/sqrt(fan_in),
    1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(w.shape[1])
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=generator)
        if b is not None:
            b.uniform_(-bound, bound, generator=generator)
