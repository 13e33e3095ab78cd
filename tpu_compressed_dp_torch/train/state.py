"""Train state: everything a step mutates, in one place.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.train.state`.  The model
(parameters and BatchNorm running statistics) is an ``nn.Module``; momentum
and the EF residual are dicts of tensors keyed like
``models/common.param_leaves``.  The EF residual is this rank's own (one
process per worker, so no leading device axis); the compressor state
(PowerSGD's warm starts, ``parallel/dp.init_comp_state``) is the same on
every rank, as are the step guard's state (``train/guard.GuardState``, ``()``
when the guard is off) and the adaptive controller's
(``control/state.ControlState``, ``()`` without ``--adaptive``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch.nn as nn

__all__ = ["TrainState"]


@dataclasses.dataclass
class TrainState:
    step: int            # global step counter
    model: nn.Module     # parameters (fp32) and BatchNorm running stats
    opt_state: Any       # optimizer buffers ({"momentum": {...}})
    ef: Any              # error-feedback residual, or () when off
    seed: int = 0        # base seed of the run; each step's compression seed is
                         # compressors.fold_in(seed, step)
    comp: Any = ()       # persistent compressor state, or () for stateless methods
    guard: Any = ()      # the step guard's state (train/guard.py), or () when off
    control: Any = ()    # the compression controller's state (control/state.py), or ()

    @classmethod
    def create(cls, model: nn.Module, opt_state: Any, ef: Any, seed: int = 0,
               comp: Any = (), guard: Any = (), control: Any = ()) -> "TrainState":
        return cls(step=0, model=model, opt_state=opt_state, ef=ef, seed=seed, comp=comp,
                   guard=guard, control=control)
