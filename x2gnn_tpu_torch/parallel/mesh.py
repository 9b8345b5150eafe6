"""Rank layout and process-group initialization
(x2gnn_tpu/parallel/mesh.py).

The reference lays its devices out in a `jax.sharding.Mesh` inside one
process. The port runs one process per rank, as `torchrun` starts them:
`initialize_distributed` joins this process to the default process group
(NCCL on the card, gloo on the CPU), and `make_mesh` (or
`hybrid.make_hybrid_mesh`) gives a `Mesh`, the rank layout that stands
where the reference's mesh stands in `Trainer(mesh=)`: the axis names and
shape, this rank, its coordinate on each axis and, per axis, the process
group of the ranks that share its other coordinates. Ranks are laid out
row-major over the axes, as the reference reshapes its device list.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from x2gnn_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a row-major layout of `shape` ranks.
    `groups[a]` is the process group along axis a (the default group when
    the axis spans every rank), `ranks[a]` its global ranks in axis
    order."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    groups: tuple
    ranks: Tuple[Tuple[int, ...], ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def _axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise KeyError(f"mesh axes {self.axis_names} have no {name!r}")
        return self.axis_names.index(name)

    def axis_size(self, name: str) -> int:
        return self.shape[self._axis(name)]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along axis `name`."""
        return self.ranks[self._axis(name)].index(self.rank)

    def group(self, name: str):
        return self.groups[self._axis(name)]

    def axis_ranks(self, name: str) -> Tuple[int, ...]:
        return self.ranks[self._axis(name)]


def device_count() -> int:
    """The ranks of the run: the default process group's world size, 1
    without one (the reference counts its devices, jax.device_count())."""
    return dist.get_world_size() if dist.is_initialized() else 1


def layout_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A Mesh of `shape` over every rank of the default process group.
    Every rank creates every axis group, in one order, as new_group asks
    of all ranks."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    world, rank = dist.get_world_size(), dist.get_rank()
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does "
                         f"not lay out {world} ranks")
    coords = [tuple((r // math.prod(shape[a + 1:])) % shape[a]
                    for a in range(len(shape))) for r in range(world)]
    groups, ranks = [], []
    for a in range(len(shape)):
        lines = {}
        for r, c in enumerate(coords):
            lines.setdefault(c[:a] + c[a + 1:], []).append(r)
        for line in lines.values():
            if len(line) == world:
                group = dist.group.WORLD
            else:
                group = dist.new_group(line)
            if rank in line:
                groups.append(group)
                ranks.append(tuple(line))
    return Mesh(axis_names, shape, rank, tuple(groups), tuple(ranks))


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",)) -> Mesh:
    """A mesh over every rank: shape (world,) for one axis, (world, 1, ...)
    for more (x2gnn_tpu/parallel/mesh.py:23-32). A process-per-rank run
    has no devices beyond its ranks: `n_devices`, if given, must be the
    world size."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}: the mesh spans the "
                         f"{world} ranks of the process group")
    return layout_mesh((world,) + (1,) * (len(axis_names) - 1), axis_names)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> torch.device:
    """Join the default process group (x2gnn_tpu/parallel/mesh.py:35-44)
    and return this rank's device: `device` ("cuda" is the card of the
    LOCAL_RANK that torchrun sets, 0 without it; a missing card raises).
    The backend follows the device: NCCL for the card, gloo for the CPU.
    The group is found from `coordinator` (an init_method such as
    "tcp://host:port" or "file:///path", with `num_processes` and this
    `process_id`), else from torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), else it is a group of this process
    alone."""
    if dist.is_initialized():
        raise RuntimeError("the default process group is initialized "
                           "already")
    device = resolve_device(device, int(os.environ.get("LOCAL_RANK", 0)))
    backend, kw = "gloo", {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        # NCCL binds the group to this rank's card, not a guess
        backend, kw = "nccl", {"device_id": device}
    if coordinator is not None:
        dist.init_process_group(backend, init_method=coordinator,
                                world_size=num_processes, rank=process_id,
                                **kw)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return device
