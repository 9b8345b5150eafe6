"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have (one chip, so no exchange between
chips to leave out)."""

import contextlib

import pytest
import torch

from bench_port import calibrate
from bench_port.tests.tiny import run_tiny


@contextlib.contextmanager
def unchanged():
    """A training step that computes the loss and returns the state it
    was given."""
    from x2gnn_tpu_torch.train.loss import smooth_l1_loss
    from x2gnn_tpu_torch.train.trainer import Trainer

    def step(self, state, batch, step=None):
        with torch.no_grad():
            loss = smooth_l1_loss(self.model(batch), batch.y,
                                  batch.graph_mask)
        return state, loss
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trainer, "train_step", step)
        yield


@contextlib.contextmanager
def ema_unchanged():
    """A training step whose moving average keeps its initial copy of the
    parameters."""
    from x2gnn_tpu_torch.train import ema

    def update(state, params, decay):
        return ema.EmaState(state.params, state.count + 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ema, "ema_update", update)
        yield


@contextlib.contextmanager
def ema_wrong_decay():
    """A training step whose moving average takes a decay of 0.5 instead
    of the configuration's."""
    from x2gnn_tpu_torch.train import ema
    real = ema.ema_update
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ema, "ema_update",
                   lambda state, params, decay: real(state, params, 0.5))
        yield


@pytest.mark.parametrize("fault", [unchanged, calibrate.half_batch,
                                   ema_unchanged, ema_wrong_decay])
def test_training_fault_is_caught(fault):
    with fault():
        res = run_tiny("aid.train", seconds=0.5)
    assert not res["correct"], res["checks"]

