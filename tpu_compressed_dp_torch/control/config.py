"""Controller configuration: the rung ladder and the decision rule's knobs.

PyTorch-port copy of :mod:`tpu_compressed_dp.control.config` (the same
fields, defaults and checks).

A :class:`ControlConfig` is frozen at harness start (CLI ``--adaptive*``
flags, :func:`tpu_compressed_dp_torch.harness.loop.build_control`); everything the
controller decides at runtime lives in
:class:`~tpu_compressed_dp_torch.control.state.ControlState` so it checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ControlConfig", "TUNABLE_METHODS", "RATIO_METHODS", "RANK_METHODS"]

#: methods whose compression knob is the keep ``ratio``
RATIO_METHODS = ("topk", "blocktopk", "randomk")
#: methods whose compression knob is the low-rank ``rank``
RANK_METHODS = ("powersgd",)
TUNABLE_METHODS = RATIO_METHODS + RANK_METHODS


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Closed-loop compression-control knobs.

    method:         canonical compressor name the ladder tunes (one of
                    :data:`TUNABLE_METHODS`; threshold/quantizer methods have
                    no discrete payload knob a trace-cached ladder can swap)
    rungs:          descending knob values, rung 0 = least compressed.  For
                    ratio methods these are keep ratios in (0, 1]; for
                    powersgd they are integral ranks >= 1.  Small and static
                    by design: each rung is a separately-compiled step
                    variant, so the ladder size bounds the trace-cache cost.
    window:         decision-window length in APPLIED updates (the
                    ``guard.schedule_step`` clock — skipped steps never close
                    a window, so replay under chaos stays aligned)
    deadband:       relative hysteresis around the budget: comm above
                    ``budget*(1+deadband)`` steps DOWN the ladder (more
                    compression), below ``budget*(1-deadband)`` steps UP —
                    and only when the projected comm at the cheaper rung
                    still fits, so the controller doesn't oscillate across
                    the band
    signal:         'modeled' (default) — per-update comm time is the
                    engines' analytic billed bits over ``bandwidth_mbps``,
                    which makes every decision a pure function of
                    checkpointed state + deterministic metrics (bitwise
                    replayable); 'measured' — the harness feeds StepTimeline
                    wall-time signals instead (production mode; documented
                    as NOT cross-run bitwise)
    model:          how the 'modeled' signal prices bits: 'flat' (default)
                    divides by ``bandwidth_mbps``; 'twin' prices the
                    transport's collective schedule through the calibrated
                    per-fabric twin (``twin/``); the Controller then needs a
                    :class:`~tpu_compressed_dp_torch.control.signals.TwinPricer`
    bandwidth_mbps: modeled per-chip wire bandwidth, Mbit/s ('modeled' only)
    budget_ms:      hideable-compute budget per update, ms.  > 0 pins the
                    budget; 0 means the harness must derive it (measured
                    compute time x the overlap schedule's hideable fraction,
                    :func:`tpu_compressed_dp_torch.control.signals.hideable_budget_ms`)
    start_rung:     initial ladder position
    """

    method: str
    rungs: Tuple[float, ...]
    window: int = 8
    deadband: float = 0.25
    signal: str = "modeled"
    model: str = "flat"
    bandwidth_mbps: float = 100.0
    budget_ms: float = 0.0
    start_rung: int = 0

    def __post_init__(self):
        if self.method not in TUNABLE_METHODS:
            raise ValueError(
                f"adaptive control tunes {TUNABLE_METHODS}, got "
                f"{self.method!r} (threshold/quantizer methods have no "
                "discrete payload knob to ladder)")
        if len(self.rungs) < 2:
            raise ValueError(
                f"a ladder needs >= 2 rungs to control anything, got "
                f"{self.rungs}")
        if any(b >= a for a, b in zip(self.rungs, self.rungs[1:])):
            raise ValueError(
                f"rungs must strictly descend (rung 0 = least compressed), "
                f"got {self.rungs}")
        if self.method in RATIO_METHODS:
            if any(not (0.0 < r <= 1.0) for r in self.rungs):
                raise ValueError(
                    f"ratio rungs must lie in (0, 1], got {self.rungs}")
        else:
            if any(r < 1 or r != int(r) for r in self.rungs):
                raise ValueError(
                    f"rank rungs must be integers >= 1, got {self.rungs}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if not (0.0 <= self.deadband < 1.0):
            raise ValueError(
                f"deadband must be in [0, 1), got {self.deadband}")
        if self.signal not in ("modeled", "measured"):
            raise ValueError(
                f"signal must be modeled|measured, got {self.signal!r}")
        if self.model not in ("flat", "twin"):
            raise ValueError(
                f"model must be flat|twin, got {self.model!r}")
        if self.signal == "modeled" and self.bandwidth_mbps <= 0:
            raise ValueError(
                f"bandwidth_mbps must be positive for the modeled signal, "
                f"got {self.bandwidth_mbps}")
        if self.budget_ms < 0:
            raise ValueError(f"budget_ms must be >= 0, got {self.budget_ms}")
        if not (0 <= self.start_rung < len(self.rungs)):
            raise ValueError(
                f"start_rung {self.start_rung} out of range for "
                f"{len(self.rungs)} rungs")
