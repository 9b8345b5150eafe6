"""Packed against fixed budgets at equal optimizer steps
(scripts/pack_ab.py):

    python -m x2gnn_tpu_torch.scripts.pack_ab --packed runs/flagship \\
        --workdir runs/pack_ab_fixed --steps 40000      # train the arm
    python -m x2gnn_tpu_torch.scripts.pack_ab --packed runs/flagship \\
        --workdir runs/pack_ab_fixed --report-only      # compare

Arm A is an existing packed run's metrics.jsonl (--packed). Unless
--report-only, this launches arm B, `python -m x2gnn_tpu_torch.train` on
--data with --config and the recipe's flags (blocked layout,
--standardize --atomref-fit, plateau, batches cached on the card as
float16, a checkpoint every 5 epochs, --auto-resume), for enough epochs
to cover --steps (default: arm A's last step, at most 45,000): without
bucketing or packing into --workdir, or with --run-mixed the mixed-FFD
packed arm into --mixed. Then reports, at 1/4, 1/2, 3/4 and all of the
step budget, each arm's best_val_mae of its last epoch at or before that
step (`val_at_steps`; the mixed arm's where its metrics.jsonl exists),
prints it as JSON and writes it to <workdir>/ab_summary.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from x2gnn_tpu_torch.device import resolve_device


def read_metrics(path):
    out = []
    with open(path) as f:
        for ln in f:
            try:
                out.append(json.loads(ln))
            except json.JSONDecodeError:
                pass
    return out


def val_at_steps(metrics, step):
    """best_val_mae of the last epoch with step <= `step` (what a
    step-budgeted run would have selected by then)."""
    best = None
    for m in metrics:
        if m["step"] <= step:
            best = m["best_val_mae"]
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--packed", default="runs/flagship_r3")
    ap.add_argument("--workdir", default="runs/pack_ab_fixed")
    ap.add_argument("--data", default="processed/synthq50k.npz")
    ap.add_argument("--config", default="configs/flagship_synthq.json")
    ap.add_argument("--steps", type=int, default=None,
                    help="fixed-arm step budget (default: packed arm's "
                         "final step count, capped at 45k)")
    ap.add_argument("--report-only", action="store_true")
    ap.add_argument("--mixed", default="runs/pack_ab_mixed",
                    help="mixed-FFD arm workdir (reported when its "
                         "metrics.jsonl exists)")
    ap.add_argument("--run-mixed", action="store_true",
                    help="launch the --pack-mixed arm (same recipe as the "
                         "fixed arm, FFD mixed-composition packing) instead "
                         "of the fixed arm")
    ap.add_argument("--device", default="cuda",
                    help="the launched arm's device")
    args = ap.parse_args(argv)

    packed = read_metrics(os.path.join(args.packed, "metrics.jsonl"))
    if not packed:
        sys.exit(f"no metrics in {args.packed}")
    target_steps = args.steps or min(packed[-1]["step"], 45000)

    fixed_path = os.path.join(args.workdir, "metrics.jsonl")
    if not args.report_only:
        # the arm trains on the card unless --device cpu: no card raises
        # here, before the launch
        resolve_device(args.device)
        if args.run_mixed:
            # the fixed arm's recipe + mixed-FFD packing (~1333 steps per
            # epoch on synthq50k at fill 0.75)
            workdir, steps_pe, extra = args.mixed, 1333, ["--pack-mixed"]
        else:
            # the same flags without bucketing or packing (1375 steps per
            # epoch at batch 32 over 44k molecules)
            workdir, steps_pe, extra = args.workdir, 1375, []
        epochs = -(-target_steps // steps_pe)
        cmd = [sys.executable, "-m", "x2gnn_tpu_torch.train",
               "--data-npz", args.data, "--workdir", workdir,
               "--config", args.config, "--epochs", str(epochs),
               "--layout", "blocked", "--standardize", "--atomref-fit",
               "--scheduler", "plateau", "--cache-batches", "on",
               "--feat-dtype", "float16", "--ckpt-every", "5",
               "--auto-resume", "--ckpt-after-epoch", "0",
               "--device", args.device] + extra
        print("launching arm:", " ".join(cmd), file=sys.stderr)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p)}
        rc = subprocess.call(cmd, env=env)
        if rc != 0:
            return rc

    fixed = read_metrics(fixed_path)
    mixed_path = os.path.join(args.mixed, "metrics.jsonl")
    mixed = read_metrics(mixed_path) if os.path.exists(mixed_path) else []
    rows = []
    for frac in (0.25, 0.5, 0.75, 1.0):
        s = int(target_steps * frac)
        row = {"steps": s,
               "packed_best_val": val_at_steps(packed, s),
               "fixed_best_val": val_at_steps(fixed, s)}
        if mixed:
            row["mixed_best_val"] = val_at_steps(mixed, s)
        rows.append(row)
    out = {"target_steps": target_steps, "rows": rows,
           "packed_steps_per_epoch": packed[0]["step"],
           "fixed_steps_per_epoch": fixed[0]["step"] if fixed else None,
           "mixed_steps_per_epoch": mixed[0]["step"] if mixed else None}
    with open(os.path.join(args.workdir, "ab_summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
