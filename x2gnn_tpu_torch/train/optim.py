"""Optimizer and LR schedule (x2gnn_tpu/train/optim.py), with optax's
arithmetic.

The reference recipe: clip the gradients by their global norm, then Adam
(lr 1e-3, amsgrad off; train_ema.py:48), stepped per batch with
LinearWarmupExponentialDecay (scheduler.py:3-28), or the plateau scale.
The JAX package composes optax's `clip_by_global_norm` and `adam`; this
module computes the same numbers step by step:
  * clip: t if norm < max_norm else t / norm * max_norm, where norm is the
    global L2 norm (optax has no eps; torch's clip_grad_norm_ divides by
    norm + 1e-6 and is not used);
  * Adam with b1 0.9, b2 0.999, eps 1e-8, eps_root 0 and bias correction:
    mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu,
    u = (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps), update = -lr u.
The schedule and the bias corrections are computed on the device from the
step count in float64 and rounded to float32, as optax does under
jax_enable_x64, so a step needs no host synchronization.

The optimizer works on a list of tensors: the model's parameters, or a
single flat vector of all of them (`fused_update`, like optax.flatten).

With accum_steps = k > 1 it has optax.MultiSteps' semantics
(x2gnn_tpu/train/optim.py:142-146; optax/transforms/_accumulation.py): a
running mean of the micro-batch gradients, acc + (g - acc) / (m + 1) at
micro-step m; clip and Adam run on it, but their state (count, moments,
so also the schedule) takes the new values only on the emitting micro-step
m = k - 1, whose update is applied; the other micro-steps' updates are
multiplied by 0; the mean restarts at 0 after an emission. With
`fused_update` the mean is one flat vector.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from x2gnn_tpu_torch.config import TrainConfig

B1, B2, EPS = 0.9, 0.999, 1e-8


def warmup_exponential_decay(max_lr: float, warmup_steps: int,
                             decay_steps: int, decay_rate: float):
    """lr(step) = max_lr * min((step+1)/warmup, 1) * decay_rate^(step/decay)
    (scheduler.py:19-26): the warmup factor reaches 1 at step W-1, the
    decay is continuous. `step` is a tensor; the result is a float64
    tensor."""
    warmup_steps = max(warmup_steps, 1)

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.double()
        w = torch.clamp((step + 1.0) / warmup_steps, max=1.0)
        return max_lr * w * torch.pow(decay_rate, step / decay_steps)

    return schedule


class PlateauController:
    """Host-side ReduceLROnPlateau with torch semantics (train_ema.py:53:
    mode='min', factor=reduce_factor, patience, min_lr=max_lr*decay_rate;
    threshold 1e-4 relative, cooldown 0), stepped once per epoch on the
    validation MAE; the scale goes into the optimizer state
    (`set_plateau_scale`). A resumed run starts at `scale`, the restored
    optimizer's (`get_plateau_scale`)."""

    threshold = 1e-4

    def __init__(self, factor: float = 0.7, patience: int = 3,
                 min_scale: float = 0.01, scale: float = 1.0):
        self.factor = factor
        self.patience = patience
        self.min_scale = min_scale
        self.scale = scale
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        """Consume one epoch's validation metric; return the LR scale."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale


class AdamState(NamedTuple):
    count: torch.Tensor                    # int32 scalar: updates applied
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    plateau_scale: Optional[torch.Tensor]  # float32 scalar, plateau only
    # accum_steps > 1 only (optax.MultiSteps' mini_step and acc_grads): the
    # micro-step counter and the running mean of the micro-batch gradients
    mini_step: Optional[torch.Tensor] = None   # int32 scalar
    acc: Optional[List[torch.Tensor]] = None


def set_plateau_scale(state: AdamState, scale: float) -> AdamState:
    return state._replace(plateau_scale=torch.full_like(
        state.plateau_scale, scale))


def get_plateau_scale(state: AdamState) -> float:
    """The plateau LR scale of the optimizer state (1.0 if it has none),
    which a resumed run's PlateauController starts from
    (x2gnn_tpu/train/optim.py:95)."""
    if state.plateau_scale is None:
        return 1.0
    return float(state.plateau_scale)


class Optimizer:
    """clip-by-global-norm (if cfg.grad_clip) then Adam with cfg's
    schedule, accumulated over cfg.accum_steps micro-batches: the
    reference's `make_optimizer`."""

    def __init__(self, cfg: TrainConfig):
        if cfg.accum_steps < 1:
            raise ValueError(f"accum_steps={cfg.accum_steps} < 1")
        if cfg.scheduler not in ("warmup_exp", "plateau"):
            raise ValueError(f"unknown scheduler {cfg.scheduler!r}")
        self.cfg = cfg
        self.schedule = warmup_exponential_decay(
            cfg.max_lr, cfg.warmup_steps, cfg.decay_steps, cfg.decay_rate)

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        device = params[0].device
        zeros = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                 for p in params]
        scale = (torch.ones((), dtype=torch.float32, device=device)
                 if self.cfg.scheduler == "plateau" else None)
        count = torch.zeros((), dtype=torch.int32, device=device)
        if self.cfg.accum_steps == 1:
            return AdamState(count, zeros, [z.clone() for z in zeros], scale)
        return AdamState(count, zeros, [z.clone() for z in zeros], scale,
                         count.clone(), [z.clone() for z in zeros])

    def _step_size(self, state: AdamState) -> torch.Tensor:
        """-lr as a float32 scalar tensor for the update of `state`."""
        cfg = self.cfg
        if cfg.scheduler == "plateau":
            # optax.inject_hyperparams: lr = max_lr * max(scale, min) in f32
            scale = torch.clamp(state.plateau_scale,
                                min=float(np.float32(cfg.decay_rate)))
            return -(scale * float(np.float32(cfg.max_lr)))
        return (-self.schedule(state.count)).float()

    def update(self, grads: Sequence[torch.Tensor], state: AdamState):
        """(updates, new state) for `grads`; the updates are to be added
        to the parameters. Computes new tensors throughout; with
        accum_steps > 1 as optax.MultiSteps does (module docstring), the
        choice to emit made on the device."""
        k = self.cfg.accum_steps
        if k == 1:
            return self._update(grads, state)
        with torch.no_grad():
            m = state.mini_step
            acc = [a + (g - a) / (m + 1) for g, a in zip(grads, state.acc)]
            updates, new = self._update(acc, state)
            emit = m == k - 1
            keep = ~emit
            return [u * emit for u in updates], AdamState(
                torch.where(emit, new.count, state.count),
                [torch.where(emit, a, b) for a, b in zip(new.mu, state.mu)],
                [torch.where(emit, a, b) for a, b in zip(new.nu, state.nu)],
                state.plateau_scale, (m + 1) % k, [a * keep for a in acc])

    def _update(self, grads, state: AdamState):
        """clip and Adam on `grads`: (updates, state with the new count
        and moments)."""
        with torch.no_grad():
            if self.cfg.grad_clip:
                grads = clip_by_global_norm(grads, self.cfg.max_grad)
            count = state.count + 1
            t = count.double()
            bc1 = (1.0 - torch.pow(B1, t)).float()
            bc2 = (1.0 - torch.pow(B2, t)).float()
            step_size = self._step_size(state)
            mu = [(1 - B1) * g + B1 * m for g, m in zip(grads, state.mu)]
            nu = [(1 - B2) * (g * g) + B2 * v
                  for g, v in zip(grads, state.nu)]
            updates = [step_size * ((m / bc1) / (torch.sqrt(v / bc2) + EPS))
                       for m, v in zip(mu, nu)]
        return updates, state._replace(count=count, mu=mu, nu=nu)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(torch.stack([(t * t).sum() for t in tensors]).sum())


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: t if norm < max_norm, else
    (t / norm) * max_norm."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def apply_update_skip_nonfinite(state, loss: torch.Tensor,
                                grads: Sequence[torch.Tensor],
                                optimizer: Optimizer, ema_decay: float):
    """Optimizer and EMA update with non-finite-loss containment
    (x2gnn_tpu/train/optim.py:158-191): a NaN/inf loss leaves the
    parameters, the optimizer state (with accum_steps > 1 also the
    gradient mean and the micro-step counter: the bad micro-batch does not
    count) and the EMA as they were and adds one to `bad_steps`; `step`
    and, on finite micro-steps, the EMA advance on every call. The choice is a
    device-side torch.where, so no step waits for the host. The parameters
    (state.params) are updated in place; the other fields are new tensors.
    Returns (new state, loss)."""
    from x2gnn_tpu_torch.train.ema import ema_update

    finite = torch.isfinite(loss)
    with torch.no_grad():
        safe = [torch.where(finite, g, 0.0) for g in grads]
        updates, new = optimizer.update(safe, state.opt_state)
        for p, u in zip(state.params, updates):
            p.add_(torch.where(finite, u, 0.0))
        old = state.opt_state
        opt_state = AdamState(
            torch.where(finite, new.count, old.count),
            [torch.where(finite, a, b) for a, b in zip(new.mu, old.mu)],
            [torch.where(finite, a, b) for a, b in zip(new.nu, old.nu)],
            old.plateau_scale)
        if old.acc is not None:
            opt_state = opt_state._replace(
                mini_step=torch.where(finite, new.mini_step, old.mini_step),
                acc=[torch.where(finite, a, b)
                     for a, b in zip(new.acc, old.acc)])
        ema_new = ema_update(state.ema, state.params, ema_decay)
        ema = type(state.ema)(
            [torch.where(finite, a, b)
             for a, b in zip(ema_new.params, state.ema.params)],
            torch.where(finite, ema_new.count, state.ema.count))
        bad = state.bad_steps + (~finite).to(state.bad_steps.dtype)
    return state._replace(opt_state=opt_state, ema=ema,
                          step=state.step + 1, bad_steps=bad), loss
