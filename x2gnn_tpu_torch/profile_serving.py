"""Where the serving time goes on the card: one `Predictor.predict` of the
flagship X2GNN (random weights from seed 0) over the 256 QM9-scale
molecules of the serving benchmark (synthetic_dataset(256, mean_atoms=18,
seed=11), batch 32), traced by torch.profiler.

    python3 -m x2gnn_tpu_torch.profile_serving [--top 15]

Prints the wall time of the traced call, the device time summed over its
kernels (busy), the idle share 1 - busy/wall, and the device time per
kernel name, largest first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from x2gnn_tpu_torch.config import ModelConfig
    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    from x2gnn_tpu_torch.device import resolve_device
    from x2gnn_tpu_torch.infer import Predictor
    from x2gnn_tpu_torch.models.x2gnn import X2GNN

    device = resolve_device("cuda")
    cfg = ModelConfig(attention_layout="blocked")
    graphs = synthetic_dataset(256, mean_atoms=18, seed=11)
    model = X2GNN(cfg, torch.Generator().manual_seed(0), device=device)
    pred = Predictor(cfg, model, batch_size=32, device=device)
    pred.predict(graphs)                  # warm-up, builds the kernel
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(graphs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    print_device_profile(prof, wall_us, args.top)


def device_rows(prof):
    """(device us, count, name) of each kernel or copy of a finished
    torch.profiler run, largest first; raises if it recorded no device
    time."""
    from torch.autograd import DeviceType

    # device-side events only (kernels, copies): a CPU op's own device
    # time repeats that of the kernels it launched
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        raise RuntimeError("the profiler recorded no device time")
    return rows


def print_device_profile(prof, wall_us: float, top: int) -> None:
    """Print device busy time, idle share 1 - busy/wall and the device
    time per kernel name, largest first, of a finished torch.profiler
    run over `wall_us` microseconds; raise if it recorded no device time."""
    import torch

    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    print(f"{torch.cuda.get_device_name(0)}: wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / wall_us:.3f}")
    for us, count, key in rows[:top]:
        print(f"{us / 1e3:10.3f} ms {100 * us / busy_us:6.2f}% "
              f"{count:6d}x  {key[:90]}")


if __name__ == "__main__":
    main()
