"""Closed-loop adaptive compression control plane.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.control`: a host-side
controller consumes the engines' billed bits (or the measured step time)
each decision window and retunes the compression knob (Top-K/Random-K
``ratio``, PowerSGD ``rank``) along a discrete rung ladder to fit comm time
under the compute it can hide behind.  Decisions key off APPLIED-update
counts (``guard.schedule_step``), every window close is a
``control_decision`` event, and the controller's state rides
``TrainState.control`` through checkpoints and elastic remeshes, so a
resumed run replays the decision sequence bitwise.  No module here reads
the wall clock.
"""

from tpu_compressed_dp_torch.control.config import ControlConfig
from tpu_compressed_dp_torch.control.controller import Controller, Decision
from tpu_compressed_dp_torch.control.rungs import (build_ladder, comp_for_rung, ladder_knob,
                                                   migrate_comp_state)
from tpu_compressed_dp_torch.control.signals import hideable_budget_ms, modeled_comm_ms
from tpu_compressed_dp_torch.control.state import (ControlState, control_from_dict,
                                                   control_to_dict, init_control_state)

__all__ = [
    "ControlConfig", "Controller", "Decision", "ControlState",
    "init_control_state", "control_to_dict", "control_from_dict",
    "build_ladder", "comp_for_rung", "ladder_knob", "migrate_comp_state",
    "modeled_comm_ms", "hideable_budget_ms",
]
