"""Learning-rate schedules as functions of the step.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.train.schedules`
(``piecewise_linear``).  Schedules are evaluated on the host in numpy float32
with ``jnp.interp``'s arithmetic, so the values equal the JAX step's bitwise
and reading them never syncs the device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

__all__ = ["piecewise_linear"]

Schedule = Callable[[float], np.float32]


def piecewise_linear(knots: Sequence[float], vals: Sequence[float]) -> Schedule:
    """``PiecewiseLinear(knots, vals)(t)``: linear interpolation, clamped at
    the ends (``t`` in the caller's unit; the CIFAR harness uses fractional
    epochs)."""
    xp = np.asarray(knots, np.float32)
    fp = np.asarray(vals, np.float32)
    eps = np.spacing(np.finfo(np.float32).eps)

    def schedule(t) -> np.float32:
        x = np.float32(t)
        i = int(np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1))
        df = fp[i] - fp[i - 1]
        dx = xp[i] - xp[i - 1]
        delta = x - xp[i - 1]
        f = fp[i - 1] if abs(dx) <= eps else fp[i - 1] + (delta / dx) * df
        if x < xp[0]:
            f = fp[0]
        if x > xp[-1]:
            f = fp[-1]
        return np.float32(f)

    return schedule
