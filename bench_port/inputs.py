"""The benchmark's inputs, all made from `--seed`: molecules (a copy of the
port's synthetic QM9-like geometry), their edge features and labels, and
the model's weights.

A traffic file fixes its set of molecules (sizes, geometry, elements)
with its own `geometry_seed`, so every run seed works on the same
molecules, and so on the same padded shapes, in another order; the run
seed draws that order, the edge features, the labels and the weights.
Edge features and weights are drawn on the run's device by one
torch.Generator, in one call each.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from bench_port.reference.graphs import radius_edges
from bench_port.reference.model import Molecule, param_spec

ELEMENTS = (1, 1, 1, 6, 6, 6, 6, 7, 8, 9)
# separates the streams drawn from one run seed
FEATURE_STREAM, WEIGHT_STREAM = 0x5EED_F00D, 0x5EED_BEEF


def random_molecule(rng: np.random.Generator, n_atoms: int,
                    min_dist: float = 1.0, density: float = 0.08):
    """Positions drawn in a cube sized for ~`density` atoms per cubic
    Angstrom with a minimum pairwise distance, and H/C/N/O/F numbers
    (the port's `data/synthetic.py::random_molecule`)."""
    box = (n_atoms / density) ** (1.0 / 3.0) / 2.0
    pos = np.zeros((n_atoms, 3))
    placed = tries = 0
    while placed < n_atoms:
        cand = rng.uniform(-box, box, size=3)
        if placed == 0 or np.linalg.norm(
                pos[:placed] - cand, axis=1).min() >= min_dist:
            pos[placed] = cand
            placed += 1
        tries += 1
        if tries > 100000:
            raise RuntimeError("packing failed; lower density")
    numbers = rng.choice(ELEMENTS, size=n_atoms).astype(np.int32)
    return numbers, pos


def geometry(traffic: dict):
    """The traffic's molecules as (numbers, float32 positions), fixed by
    its geometry_seed: sizes around mean_atoms, clipped, then each
    molecule's own stream."""
    g = traffic["geometry_seed"]
    n = np.random.default_rng(g).normal(
        traffic["mean_atoms"], traffic["size_sd"], traffic["molecules"])
    n = np.clip(np.rint(n), traffic["min_atoms"], traffic["max_atoms"])
    out = []
    for i, size in enumerate(n.astype(int)):
        numbers, pos = random_molecule(np.random.default_rng([g, i]),
                                       int(size))
        out.append((numbers, pos.astype(np.float32)))
    return out


def make_molecules(traffic: dict, seed: int, cutoff: float, feat_dim: int,
                   device) -> List[Molecule]:
    """The traffic's molecules for run `seed`: in a seeded order, with
    N(0, feat_scale) edge features drawn on `device` and N(0, 1) labels
    (all distinct, so a label names its molecule)."""
    rng = np.random.default_rng([seed, 1])
    mols = geometry(traffic)
    geo = [(mols[j][0], mols[j][1],
            radius_edges(mols[j][1], cutoff).src.shape[0])
           for j in rng.permutation(len(mols))]
    total = sum(g[2] for g in geo)
    gen = torch.Generator(device=device).manual_seed(
        (seed ^ FEATURE_STREAM) % (1 << 63))
    feat = (torch.randn(total, feat_dim, generator=gen, device=device)
            * traffic["feat_scale"]).cpu().numpy()
    y = rng.standard_normal(len(geo)).astype(np.float32)
    while True:   # float32 labels collide now and then: draw those again
        dup = np.setdiff1d(np.arange(len(y)),
                           np.unique(y, return_index=True)[1])
        if not len(dup):
            break
        y[dup] = rng.standard_normal(len(dup)).astype(np.float32)
    out, e0 = [], 0
    for (numbers, pos, n_edges), label in zip(geo, y):
        out.append(Molecule(numbers, pos, feat[e0:e0 + n_edges],
                            float(label)))
        e0 += n_edges
    return out


def make_weights(model_cfg: dict, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} of every parameter of `param_spec`, from
    one normal and one uniform draw on `device`: Glorot-scaled normals
    (variance 2 / (fan_in + fan_out)) for the Glorot weights, U(-b, b)
    with b = 1 / sqrt(fan_in) for the torch-default layers, zero biases
    after Glorot weights, an N(0, 1) embedding with a zero padding row,
    radial frequencies n pi."""
    spec = param_spec(model_cfg)
    numel = [int(np.prod(s.shape)) for s in spec]
    gen = torch.Generator(device=device).manual_seed(
        (seed ^ WEIGHT_STREAM) % (1 << 63))
    normal = torch.randn(sum(numel), generator=gen, device=device)
    uniform = torch.rand(sum(numel), generator=gen, device=device) * 2 - 1
    out, off = {}, 0
    for s, n in zip(spec, numel):
        z, u = normal[off:off + n].view(s.shape), uniform[off:off + n]
        off += n
        if s.init == "glorot":
            w = z * (2.0 / sum(s.shape)) ** 0.5
        elif s.init in ("uniform", "uniform_bias"):
            w = u.view(s.shape) / s.fan_in ** 0.5
        elif s.init == "zeros":
            w = torch.zeros(s.shape, device=device)
        elif s.init == "embedding":
            w = z.clone()
            w[0] = 0.0
        elif s.init == "frequencies":
            w = torch.pi * torch.arange(1, n + 1, dtype=torch.float32,
                                        device=device)
        else:
            raise ValueError(f"{s.name}: unknown init {s.init!r}")
        out[s.name] = w.contiguous()
    return out


def by_label(mols: Sequence[Molecule]) -> Dict[float, int]:
    """{label: molecule index}: the labels are distinct."""
    return {np.float32(m.y).item(): i for i, m in enumerate(mols)}
