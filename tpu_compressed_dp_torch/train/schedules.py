"""Learning-rate schedules as functions of the step.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.train.schedules`
(``piecewise_linear``, ``lr_phases_to_knots`` and the ImageNet harness's
``phase_lr_schedule``, ``epoch_from_steps`` and
``phase_lr_schedule_variable_bs``).  Schedules are evaluated on
the host in numpy float32 with ``jnp.interp``'s arithmetic, so the values
equal the JAX step's bitwise and reading them never syncs the device.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

__all__ = ["piecewise_linear", "lr_phases_to_knots", "phase_lr_schedule", "epoch_from_steps",
           "phase_lr_schedule_variable_bs"]

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


def lr_phases_to_knots(phases: List[dict]) -> Tuple[List[float], List[float]]:
    """Flatten ImageNet-style lr phases into ``(knots, vals)`` for
    :func:`piecewise_linear`.  A phase ``{'ep': (e0, e1), 'lr': (v0, v1)}``
    ramps linearly; ``'ep': e`` with a scalar ``lr`` holds the value until the
    next phase starts.  A start knot that would repeat the previous end is
    nudged by 1e-6 so the jump has one side."""
    knots: List[float] = []
    vals: List[float] = []
    lr_phases = [p for p in phases if "lr" in p]
    for i, p in enumerate(lr_phases):
        ep, lr = p["ep"], p["lr"]
        if isinstance(ep, (tuple, list)):
            e0, e1 = float(ep[0]), float(ep[1])
        else:
            e0 = float(ep)
            if i + 1 < len(lr_phases):
                nxt = lr_phases[i + 1]["ep"]
                e1 = float(nxt[0] if isinstance(nxt, (tuple, list)) else nxt)
            else:
                e1 = e0 + 1.0
        if isinstance(lr, (tuple, list)):
            v0, v1 = float(lr[0]), float(lr[1])
        else:
            v0 = v1 = float(lr)
        if knots and e0 <= knots[-1]:
            e0 = knots[-1] + 1e-6
        knots += [e0, e1]
        vals += [v0, v1]
    return knots, vals


def phase_lr_schedule(phases: List[dict], batches_per_epoch: int) -> Schedule:
    """Per-batch LR from ImageNet phase dicts; the input is the global step."""
    knots, vals = lr_phases_to_knots(phases)
    base = piecewise_linear(knots, vals)
    bpe = np.float32(batches_per_epoch)

    def schedule(step) -> np.float32:
        return base(np.float32(step) / bpe)

    return schedule


def epoch_from_steps(epoch_batches: Sequence[int]) -> Schedule:
    """A global step as a fractional epoch when the batches per epoch vary
    (progressive resizing changes the batch size mid-run): epoch ``e`` spans
    ``epoch_batches[e]`` steps."""
    cum = [0.0]
    for n in epoch_batches:
        cum.append(cum[-1] + float(max(n, 1)))
    return piecewise_linear(cum, [float(e) for e in range(len(cum))])


def phase_lr_schedule_variable_bs(phases: List[dict], epoch_batches: Sequence[int]) -> Schedule:
    """Phase LR under progressive resizing: ``lr(step) = lr_by_epoch(epoch(step))``."""
    knots, vals = lr_phases_to_knots(phases)
    by_epoch = piecewise_linear(knots, vals)
    to_epoch = epoch_from_steps(epoch_batches)

    def schedule(step) -> np.float32:
        return by_epoch(to_epoch(np.float32(step)))

    return schedule
