"""Where the training time goes on the card: steps of the flagship X2GNN's
training cell (random weights from seed 0; synthetic_dataset(512,
mean_atoms=18, seed=11), batch 32, the flagship recipe with
pack_mixed off) traced by torch.profiler.

    python3 -m x2gnn_tpu_torch.profile_training [--steps 5] [--top 20]

Builds the Trainer, runs 3 warm-up steps on the cached device batches
(which builds the kernels), then traces `--steps` steps and a final
synchronize. Prints the wall time of the traced window, the device time
summed over its kernels (busy), the idle share 1 - busy/wall, and the
device time per kernel name, largest first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from x2gnn_tpu_torch.data.synthetic import synthetic_dataset
    from x2gnn_tpu_torch.device import resolve_device
    from x2gnn_tpu_torch.models.x2gnn import X2GNN
    from x2gnn_tpu_torch.profile_serving import print_device_profile
    from x2gnn_tpu_torch.train.trainer import Trainer

    device = resolve_device("cuda")
    mcfg, tcfg = flagship_training_configs()
    graphs = synthetic_dataset(512, mean_atoms=18, seed=11)
    targets = np.array([g.y[0] for g in graphs], np.float32)
    model = X2GNN(mcfg, torch.Generator().manual_seed(0), device=device)
    trainer = Trainer(model, mcfg, tcfg, graphs, targets,
                      workdir="/dev/null", device=device)
    batches = trainer.batches(trainer.train_idx)
    state = trainer.init_state()
    for i in range(3):
        state, _ = trainer.train_step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            state, _ = trainer.train_step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    print(f"{args.steps} training steps, batch {tcfg.batch_size}, "
          f"N={batches[0].in_edges.shape[0]} D={batches[0].in_edges.shape[1]}")
    print_device_profile(prof, wall_us, args.top)


def flagship_training_configs():
    """The flagship run's (ModelConfig, TrainConfig) from
    runs/flagship_r5_regression/args.json, with pack_mixed off: the
    port's trainer runs fixed budgets (packing is ROADMAP A8)."""
    import os

    from x2gnn_tpu_torch.config import load_configs
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mcfg, tcfg = load_configs(os.path.join(
        root, "runs", "flagship_r5_regression", "args.json"))
    return mcfg, dataclasses.replace(tcfg, pack_mixed=False)


if __name__ == "__main__":
    main()
