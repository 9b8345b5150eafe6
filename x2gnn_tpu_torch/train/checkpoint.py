"""Training-state checkpoints with torch.save (counterpart of
x2gnn_tpu/train/checkpoint.py, which writes orbax trees).

A checkpoint is one file holding the parameters, the Adam state (count,
moments, plateau scale and, with accum_steps > 1, the micro-step counter
and the gradient mean), the EMA, the step and `bad_steps`, all as CPU
tensors. It is written to a temporary file and renamed, so a crash never
leaves a torn checkpoint. `Trainer.restore` resumes a run from one,
copying its parameters into the model's live tensors. The port reads
no orbax directory: the reference X2-GNN's `.pth` files go through
`utils/torch_ckpt.py`.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def _cpu(tensors):
    return [t.detach().cpu().clone() for t in tensors]


def save_checkpoint(path: str, state) -> None:
    """Write `state` (a TrainState) to the file `path` as a dict of CPU
    tensors, atomically."""
    opt = state.opt_state
    raw = {
        "params": _cpu(state.params),
        "opt_state": {"count": opt.count.cpu(), "mu": _cpu(opt.mu),
                      "nu": _cpu(opt.nu),
                      "plateau_scale": (None if opt.plateau_scale is None
                                        else opt.plateau_scale.cpu()),
                      "mini_step": (None if opt.mini_step is None
                                    else opt.mini_step.cpu()),
                      "acc": None if opt.acc is None else _cpu(opt.acc)},
        "ema": {"params": _cpu(state.ema.params),
                "count": state.ema.count.cpu()},
        "step": state.step.cpu(),
        "bad_steps": state.bad_steps.cpu(),
    }
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(raw, tmp)
    os.replace(tmp, path)


def _check_like(what, saved, ref):
    if len(saved) != len(ref) or any(
            tuple(s.shape) != tuple(r.shape) for s, r in zip(saved, ref)):
        raise ValueError(
            f"checkpoint {what} ({len(saved)} tensors) do not match the "
            f"template's ({len(ref)} tensors): a flat (fused_update) "
            "against a per-parameter state, or another model")


def restore_checkpoint(path: str, template=None):
    """The checkpoint at `path`: a dict of CPU tensors, or, given a
    TrainState `template` of the same structure, a TrainState of new
    tensors on the template's devices (the template's parameters are not
    touched: `Trainer.use_state` copies them into the model). Raises
    ValueError if the structure differs from the template's."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if template is None:
        return raw

    def like(saved, ref):
        return [s.to(r.device) for s, r in zip(saved, ref)]

    opt, t_opt = raw["opt_state"], template.opt_state
    for what, saved, ref in (("parameters", raw["params"], template.params),
                             ("Adam moments", opt["mu"], t_opt.mu),
                             ("EMA", raw["ema"]["params"],
                              template.ema.params)):
        _check_like(what, saved, ref)
    scale = opt["plateau_scale"]
    if (scale is None) != (t_opt.plateau_scale is None):
        raise ValueError("checkpoint and template disagree on the plateau "
                         "scheduler's scale")
    acc = opt.get("acc")
    if (acc is None) != (t_opt.acc is None):
        raise ValueError("checkpoint and template disagree on gradient "
                         "accumulation (accum_steps > 1)")
    if acc is not None:
        _check_like("gradient mean", acc, t_opt.acc)
    return template._replace(
        params=like(raw["params"], template.params),
        opt_state=t_opt._replace(
            count=opt["count"].to(t_opt.count.device),
            mu=like(opt["mu"], t_opt.mu), nu=like(opt["nu"], t_opt.nu),
            plateau_scale=(None if scale is None
                           else scale.to(t_opt.plateau_scale.device)),
            mini_step=(None if acc is None
                       else opt["mini_step"].to(t_opt.mini_step.device)),
            acc=None if acc is None else like(acc, t_opt.acc)),
        ema=template.ema._replace(
            params=like(raw["ema"]["params"], template.ema.params),
            count=raw["ema"]["count"].to(template.ema.count.device)),
        step=raw["step"].to(template.step.device),
        bad_steps=raw["bad_steps"].to(template.bad_steps.device))


def latest_checkpoint(workdir: str) -> Optional[str]:
    """The newest `ckpt_*.pt` file under workdir, or None. Every
    checkpoint the Trainer writes (ckpt_last, ckpt_best) is a whole
    TrainState, so recency alone decides: preferring ckpt_last could roll
    back past a ckpt_best saved later. A numeric step suffix
    (`ckpt_<step>.pt`) breaks mtime ties (x2gnn_tpu/train/checkpoint.py:
    37-57)."""
    if not os.path.isdir(workdir):
        return None
    cands = [f for f in os.listdir(workdir)
             if f.startswith("ckpt_") and f.endswith(".pt")
             and os.path.isfile(os.path.join(workdir, f))]
    if not cands:
        return None

    def key(f):
        tail = f[:-len(".pt")].split("_")[-1]
        return (os.path.getmtime(os.path.join(workdir, f)),
                int(tail) if tail.isdigit() else -1)

    return os.path.join(workdir, max(cands, key=key))
