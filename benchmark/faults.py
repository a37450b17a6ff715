"""Faults planted in the program, to show that `correct` catches them.

Each is a context manager that patches one method of the program's
classes for the length of the block:

- `unchanged_state`: the optimizer step returns the state it was given;
- `half_batch`: the step's loss and gradients leave out the second half
  of the batch (its mask is zero) and take the mean over the first;
- `altered_answer`: each wave's scores come back one user off (the user
  in row i is ranked by the scores of row i + 1).
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(cls, name, make):
    real = getattr(cls, name)
    setattr(cls, name, make(real))
    try:
        yield
    finally:
        setattr(cls, name, real)


def unchanged_state():
    from sparrowrecsys_torch.training.loop import Trainer

    return _patched(Trainer, "apply_grads",
                    lambda real: lambda self, params, opt_state, grads, feats: (params, opt_state))


def half_batch():
    from sparrowrecsys_torch.training.loop import Trainer

    def make(real):
        def loss_and_grads(self, params, opt_state, feats, labels, mask, generator=None):
            kept = mask.clone()
            kept[labels.shape[0] // 2:] = 0
            return real(self, params, opt_state, feats, labels, kept, generator)
        return loss_and_grads

    return _patched(Trainer, "loss_and_grads", make)


def altered_answer():
    from sparrowrecsys_torch.serving.rankers import ModelScorer

    return _patched(ModelScorer, "score_wave",
                    lambda real: lambda self, user_ids: np.roll(real(self, user_ids), -1, axis=0))


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
