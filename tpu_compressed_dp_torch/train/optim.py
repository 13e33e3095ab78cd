"""SGD with schedule-valued hyper-parameters.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.train.optim`: the
``torch.optim.SGD`` update (including Nesterov) with hyper-parameters that
may be callables of the step, evaluated on the host as float32 values (see
``train/schedules.py``).  Parameters and momentum buffers are updated in
place, which saves the copy the JAX package's functional update makes; the
arithmetic is the same, op for op.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

__all__ = ["SGD", "bn_wd_mask"]

ScalarOrSchedule = Union[float, Callable[[int], float]]


def _value(v: ScalarOrSchedule, step: int) -> float:
    """A hyper-parameter's float32 value at ``step`` (as a Python float)."""
    return float(np.float32(v(step) if callable(v) else v))


@dataclasses.dataclass(frozen=True)
class SGD:
    """``d = g + wd*p; buf = mu*buf + (1-damp)*d; d = d + mu*buf if nesterov
    else buf; p -= lr*d``.  ``wd_mask`` maps parameter paths to whether they
    receive weight decay (default: all)."""

    lr: ScalarOrSchedule = 0.0
    momentum: ScalarOrSchedule = 0.0
    weight_decay: ScalarOrSchedule = 0.0
    dampening: float = 0.0
    nesterov: bool = False
    wd_mask: Optional[Dict[str, bool]] = None

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Zero momentum buffers (identical to torch's first-gradient seeding
        when ``dampening == 0``)."""
        return {"momentum": {k: torch.zeros_like(p, dtype=torch.float32)
                             for k, p in params.items()}}

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              opt_state: Dict[str, Any], step: int) -> None:
        lr = _value(self.lr, step)
        mu = _value(self.momentum, step)
        wd = _value(self.weight_decay, step)
        bufs = opt_state["momentum"]
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            use_wd = True if self.wd_mask is None else bool(self.wd_mask[k])
            d = g + wd * p if use_wd else g
            buf = bufs[k]
            buf.copy_(mu * buf + (1.0 - self.dampening) * d)
            d = d + mu * buf if self.nesterov else buf
            p.copy_(p - lr * d)


def bn_wd_mask(params: Mapping[str, Any],
               is_excluded: Optional[Callable[[tuple], bool]] = None) -> Dict[str, bool]:
    """True where weight decay applies, False for BatchNorm parameters (the
    JAX ``bn_wd_mask``, the reference's ``bnwd_optim_params``): by default a
    leaf is excluded when a component of its flax path mentions ``bn`` or
    ``batchnorm`` (``layer1_0/bn1/scale``, ``BatchNorm_0/bias``)."""

    def default_excluded(path: tuple) -> bool:
        return any("bn" in k.lower() or "batchnorm" in k.lower() for k in path)

    pred = is_excluded or default_excluded
    return {k: not pred(tuple(k.split("/"))) for k in params}
