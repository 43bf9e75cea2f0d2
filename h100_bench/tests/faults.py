"""Faults planted in the timed path underneath a run, for the tests that
see ``correct`` come out false. Each patches the port in the process that
calls it and returns a function that undoes it."""

from __future__ import annotations


def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    return lambda: setattr(obj, name, old)


def state_unchanged():
    """Every training step returns the state it was given."""
    from ssdn_tpu_torch.train.step import TrainStep

    real = TrainStep.__call__

    def call(self, state, batch):
        return state, real(self, state, batch)[1]

    return _patch(TrainStep, "__call__", call)


def half_batch():
    """Every step trains on the first half of its rows, its mean over
    them."""
    from ssdn_tpu_torch.train.step import TrainStep

    real = TrainStep.rows

    def rows(self, x, y, noise_params, y2=None):
        x, y, p, y2 = real(self, x, y, noise_params, y2)
        h = x.shape[0] // 2
        return (x[:h], y[:h], {k: v[:h] for k, v in p.items()},
                None if y2 is None else y2[:h])

    return _patch(TrainStep, "rows", rows)


def answer_altered():
    """Each denoised image has its top eighth of rows moved by a quarter
    of the range where the posterior mean is produced."""
    from ssdn_tpu_torch import estimator

    real = estimator.posterior_mean

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[:, :max(1, out.shape[1] // 8)] += 0.25
        return out

    return _patch(estimator, "posterior_mean", altered)
