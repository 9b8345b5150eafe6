"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a CUDA
device that is missing raises, it never falls back to the CPU. A rank of
a parallel run (one process per rank, as `torchrun` starts them) takes
the card of its local rank.
"""

from __future__ import annotations

import torch


def resolve_device(device, local_rank=None) -> torch.device:
    """torch.device for `device`; raises if it names CUDA and no card is
    present. With `local_rank`, a CUDA device without an index is
    `cuda:{local_rank}`. Also turns TF32 off: the flagship runs in float32
    and its parity with the reference assumes full-precision matmuls and
    convolutions."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None \
            and local_rank is not None:
        device = torch.device("cuda", local_rank)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device
