"""The controller's cross-step carry: one more ``TrainState`` occupant.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.control.state`.
:class:`ControlState` follows the port's
:class:`~tpu_compressed_dp_torch.train.guard.GuardState`: host scalars of
JAX's types (int32 counters, float32 window accumulators), the same on
every rank (every rank's controller reads the same all-reduced metrics),
saved by the checkpoint as 0-d tensors and broadcast by the elastic
coordinator after a remesh, so a resumed or remeshed run continues the
decision sequence bitwise.  The train step never reads or writes it: the
host controller (:mod:`tpu_compressed_dp_torch.control.controller`)
replaces it between steps, which is exactly when rung switches are legal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpu_compressed_dp_torch.control.config import ControlConfig

__all__ = ["ControlState", "init_control_state", "control_to_dict", "control_from_dict"]


@dataclasses.dataclass(frozen=True)
class ControlState:
    """Everything a resumed run needs to continue the decision sequence
    bitwise: the ladder position, the open window's start on the
    applied-update clock, its accumulators, and the decision-log cursor."""

    rung: np.int32            # current ladder index (0 = least compressed)
    window_start: np.int32    # applied-update count when the window opened
    win_updates: np.int32     # applied updates accumulated in the window
    win_bits: np.float32      # billed bits accumulated (sum over updates)
    win_comm_ms: np.float32   # comm-time signal accumulated, ms
    win_budget_ms: np.float32  # hideable-compute budget accumulated, ms
    decisions: np.int32       # windows closed so far (the event-log cursor)


_INTS = ("rung", "window_start", "win_updates", "decisions")


def _typed(**vals) -> ControlState:
    return ControlState(**{k: (np.int32(v) if k in _INTS else np.float32(v))
                           for k, v in vals.items()})


def init_control_state(cfg: Optional[ControlConfig]) -> Any:
    """Fresh :class:`ControlState` (``()`` when adaptive control is off,
    mirroring ``ef`` / ``comp`` / ``guard``)."""
    if cfg is None:
        return ()
    return _typed(rung=cfg.start_rung, window_start=0, win_updates=0, win_bits=0.0,
                  win_comm_ms=0.0, win_budget_ms=0.0, decisions=0)


def control_to_dict(cs: ControlState) -> Dict[str, torch.Tensor]:
    """The state as 0-d tensors (int32 / float32), for the checkpoint."""
    return {f.name: torch.tensor(getattr(cs, f.name)) for f in dataclasses.fields(cs)}


def control_from_dict(d: Dict[str, Any]) -> ControlState:
    return _typed(**{f.name: (d[f.name].item() if isinstance(d[f.name], torch.Tensor)
                              else d[f.name]) for f in dataclasses.fields(ControlState)})
