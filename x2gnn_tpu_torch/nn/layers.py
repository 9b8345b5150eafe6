"""Core building blocks (x2gnn_tpu/nn/layers.py:20-183).

Parameters are created on the CPU from an explicit torch.Generator and
moved with `.to(device)`. Module and parameter names follow the flax
tree (`weights.load_flax_params` maps one onto the other).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from x2gnn_tpu_torch.nn.init import glorot_orthogonal_, torch_linear_
from x2gnn_tpu_torch.ops.basis import radial_frequencies_init


class _Linear(nn.Module):
    """y = x W^T + b with a torch-layout (out, in) weight."""

    # the flax counterpart nests its kernel in a `Dense_0` (the reference's
    # Dense/TorchDense wrappers); a plain flax nn.Dense sets this False
    flax_nested = True

    def __init__(self, in_features: int, features: int, use_bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Dense(_Linear):
    """Linear with a Glorot-orthogonal weight and a zero bias."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, scale: float = 2.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, use_bias)
        glorot_orthogonal_(self.weight, scale, generator)


class TorchDense(_Linear):
    """Linear with torch.nn.Linear's default init, where the reference
    leaves its projections at that default (the attention projections)."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, features, use_bias)
        torch_linear_(self.weight, self.bias, generator)


class ResidualLayer(nn.Module):
    """x + silu(lin1(silu(lin0(x))))."""

    def __init__(self, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin0 = Dense(features, features, generator=generator)
        self.lin1 = Dense(features, features, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.lin1(F.silu(self.lin0(x)))) + x


class _FreqScaledLookup(torch.autograd.Function):
    """table[idx] whose backward divides each looked-up row's gradient by
    the count of its index in the batch (torch's `scale_grad_by_freq`) and
    gives row 0 none (torch's `padding_idx=0`), as the reference's
    `_freq_scaled_lookup` (x2gnn_tpu/nn/layers.py:77-104). The counts and
    the row sums are one-hot products, so the gradient is the same bit for
    bit on every run (no atomics)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.vocab = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        onehot = F.one_hot(idx, ctx.vocab).to(g.dtype)       # (n, vocab)
        counts = onehot.sum(0)
        scale = 1.0 / torch.clamp(counts[idx], min=1.0)
        scale = torch.where(idx == 0, 0.0, scale)
        return onehot.t() @ (g * scale[:, None]), None


class EmbeddingBlock(nn.Module):
    """silu(Dense(embed(Z))) atom embedding.

    Row 0 (padding, Z=0) starts at zero and gets no gradient; each row's
    gradient is divided by its index's count in the batch. The max_norm
    renorm is applied to the table inside the forward with a safe norm
    (1e-24 under the sqrt), as the reference does, instead of torch's
    in-place `max_norm`."""

    def __init__(self, embedding_size: int = 128, vocab: int = 10,
                 max_norm: float = 3.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        table = torch.randn(vocab, embedding_size, generator=generator)
        table[0] = 0.0
        self.embedding = nn.Parameter(table)
        self.max_norm = max_norm
        self.lin = Dense(embedding_size, embedding_size, generator=generator)

    def forward(self, numbers: torch.Tensor) -> torch.Tensor:
        table = self.embedding
        norms = torch.sqrt((table * table).sum(-1, keepdim=True) + 1e-24)
        table = table * torch.clamp(self.max_norm / norms, max=1.0)
        return F.silu(self.lin(_FreqScaledLookup.apply(table, numbers)))


class MLPHead(nn.Module):
    """(depth-1) x [Linear, SiLU] + Linear(num_target). Its layers are
    Dense (Glorot-orthogonal, the atom-wise readout), or with
    `torch_default_init` TorchDense, as the molecule-wise readout leaves
    them (x2gnn_tpu/nn/layers.py:147-170)."""

    def __init__(self, features: int, num_target: int = 1, depth: int = 3,
                 torch_default_init: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = depth
        cls = TorchDense if torch_default_init else Dense
        for i in range(depth - 1):
            self.add_module(f"mlp_{i}", cls(features, features,
                                            generator=generator))
        self.mlp_out = cls(features, num_target, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth - 1):
            x = F.silu(getattr(self, f"mlp_{i}")(x))
        return self.mlp_out(x)


class RadialBasisLayer(nn.Module):
    """sin(freq_n * d / cutoff) with trainable frequencies initialised to
    n*pi."""

    def __init__(self, rbf_dim: int = 6, cutoff: float = 5.0):
        super().__init__()
        self.frequencies = nn.Parameter(
            torch.from_numpy(radial_frequencies_init(rbf_dim)))
        self.cutoff = cutoff

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        return torch.sin(self.frequencies
                         * (d * (1.0 / self.cutoff))[..., None])
