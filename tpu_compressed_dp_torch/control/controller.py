"""The host-side decision loop: window accounting + the rung rule.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.control.controller`.
One :class:`Controller` per run.  The harness calls :meth:`Controller.tick`
at its metric-fetch cadence (per epoch in the CNN harnesses, per log window
in the LM) with the applied-update count and that span's per-update
signals; the controller accumulates them into the open window (the
accumulators live in the checkpointed
:class:`~tpu_compressed_dp_torch.control.state.ControlState`, so a crash
mid-window resumes the very same window), closes the window once it spans
``cfg.window`` applied updates, and applies the rule:

  * comm above ``budget*(1+deadband)``       -> one rung DOWN the ladder
    (more compression);
  * comm below ``budget*(1-deadband)`` AND the projected comm at the
    cheaper rung still inside the band     -> one rung UP;
  * otherwise                               -> hold.

Every window close — holds included — is a ``control_decision`` record on
the ``--events`` stream.  A tick adds in Python doubles and stores the
accumulators as float32, as the JAX controller does, so the two packages'
decision sequences agree bit for bit.  Nothing here reads a clock.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from tpu_compressed_dp_torch.control.config import ControlConfig
from tpu_compressed_dp_torch.control.rungs import ladder_knob, rung_value
from tpu_compressed_dp_torch.control.signals import (WindowSignals, hideable_budget_ms,
                                                     modeled_comm_ms)
from tpu_compressed_dp_torch.control.state import ControlState, _typed

__all__ = ["Controller", "Decision"]


@dataclasses.dataclass(frozen=True)
class Decision:
    """One closed window, exactly as it lands on the event stream."""

    index: int         # the decision-log cursor (ControlState.decisions)
    applied: int       # applied-update count at the window close
    window_start: int  # applied-update count when the window opened
    updates: int       # applied updates the window spanned
    rung_from: int
    rung_to: int
    value_from: float  # knob value (ratio or rank) before
    value_to: float    # knob value after
    comm_ms: float     # window-mean comm signal per update
    budget_ms: float   # window-mean hideable budget per update
    bits: float        # window-mean billed bits per update
    direction: str     # 'down' (more compression) | 'up' | 'hold'

    def event_fields(self) -> dict:
        return dataclasses.asdict(self)


class Controller:
    """Host half of the control plane.  Stateless beyond ``cfg`` — all
    run-state rides ``TrainState.control`` so resume replays decisions
    bitwise."""

    def __init__(self, cfg: ControlConfig, *, events: Any = None, pricer: Any = None):
        self.cfg = cfg
        self.knob = ladder_knob(cfg.method)
        self.events = events
        # the calibrated twin's bit pricer (--adaptive_model twin): still a
        # pure function of billed bits, so decisions stay replayable
        self.pricer = pricer
        if cfg.model == "twin" and pricer is None:
            raise ValueError(
                "cfg.model='twin' needs a TwinPricer (build one from the "
                "records dir: harness.loop.build_twin_pricer)")

    def window_signals(self, *, mean_bits: float, measured_comm_ms: Optional[float] = None,
                       compute_ms: Optional[float] = None,
                       hideable_fraction: float = 1.0) -> WindowSignals:
        """Assemble one tick's per-update signals per ``cfg.signal``."""
        if self.cfg.signal == "modeled":
            if self.cfg.model == "twin":
                comm = self.pricer.comm_ms(mean_bits)
            else:
                comm = modeled_comm_ms(mean_bits, self.cfg.bandwidth_mbps)
        else:
            if measured_comm_ms is None:
                raise ValueError("signal='measured' needs measured_comm_ms from the "
                                 "harness timeline")
            comm = float(measured_comm_ms)
        budget = hideable_budget_ms(self.cfg, compute_ms=compute_ms,
                                    hideable_fraction=hideable_fraction)
        return WindowSignals(bits=float(mean_bits), comm_ms=comm, budget_ms=budget)

    def tick(self, control: ControlState, *, applied: int,
             signals: WindowSignals) -> Tuple[ControlState, List[Decision]]:
        """Fold one observation span into the open window; close it when it
        spans ``cfg.window`` applied updates.  ``applied`` is the
        applied-update count NOW (``guard.schedule_step``); a tick with no
        new applied updates leaves the window clock frozen."""
        applied = int(applied)
        delta = applied - (int(control.window_start) + int(control.win_updates))
        if delta <= 0:
            return control, []
        rung = int(control.rung)
        window_start = int(control.window_start)
        n_dec = int(control.decisions)
        win_updates = int(control.win_updates) + delta
        # doubles here, float32 in the stored state (the JAX controller's
        # float(...) of its f32 arrays, then jnp.asarray(..., float32))
        win_bits = float(control.win_bits) + signals.bits * delta
        win_comm = float(control.win_comm_ms) + signals.comm_ms * delta
        win_budget = float(control.win_budget_ms) + signals.budget_ms * delta

        decisions: List[Decision] = []
        if win_updates >= self.cfg.window:
            comm = win_comm / win_updates
            budget = win_budget / win_updates
            new_rung, direction = self._decide(rung, comm, budget)
            dec = Decision(
                index=n_dec, applied=applied, window_start=window_start,
                updates=win_updates, rung_from=rung, rung_to=new_rung,
                value_from=rung_value(self.cfg, rung),
                value_to=rung_value(self.cfg, new_rung),
                comm_ms=comm, budget_ms=budget, bits=win_bits / win_updates,
                direction=direction,
            )
            decisions.append(dec)
            self._emit(dec)
            rung, window_start, n_dec = new_rung, applied, n_dec + 1
            win_updates, win_bits = 0, 0.0
            win_comm, win_budget = 0.0, 0.0

        return _typed(rung=rung, window_start=window_start, win_updates=win_updates,
                      win_bits=win_bits, win_comm_ms=win_comm, win_budget_ms=win_budget,
                      decisions=n_dec), decisions

    def _decide(self, rung: int, comm_ms: float, budget_ms: float) -> Tuple[int, str]:
        hi = budget_ms * (1.0 + self.cfg.deadband)
        lo = budget_ms * (1.0 - self.cfg.deadband)
        last = len(self.cfg.rungs) - 1
        if comm_ms > hi and rung < last:
            return rung + 1, "down"
        if comm_ms < lo and rung > 0:
            # step up only if the cheaper rung's projected comm still fits
            # (payloads scale ~linearly in the knob); without the projection
            # the controller ping-pongs across the deadband every window
            scale = rung_value(self.cfg, rung - 1) / rung_value(self.cfg, rung)
            if comm_ms * scale <= hi:
                return rung - 1, "up"
        return rung, "hold"

    def _emit(self, dec: Decision) -> None:
        ev = self.events
        if ev is None:
            return
        try:
            ev.emit("control_decision", knob=self.knob, **dec.event_fields())
        except Exception:
            pass  # telemetry must never fail a decision

    def metrics(self, control: Any) -> dict:
        """Host-emitter gauges for heartbeat/Prometheus (``control/*`` and,
        with a twin pricer, ``twin/*`` in ``obs/registry.py``), derived
        from the checkpointed state only."""
        if control == ():
            return {}
        rung = int(control.rung)
        n = max(1, int(control.win_updates))
        out = {
            "control/rung": float(rung),
            "control/value": float(rung_value(self.cfg, rung)),
            "control/decisions": float(int(control.decisions)),
            "control/window_updates": float(int(control.win_updates)),
            "control/comm_ms": float(control.win_comm_ms) / n,
            "control/budget_ms": float(control.win_budget_ms) / n,
        }
        if self.pricer is not None and int(control.win_updates) > 0:
            # the twin's price for the open window's mean billed bits, and
            # its discrepancy against the flat-bandwidth price
            mean_bits = float(control.win_bits) / n
            twin_comm = self.pricer.comm_ms(mean_bits)
            flat_comm = modeled_comm_ms(mean_bits, self.cfg.bandwidth_mbps)
            out["twin/pred_step_ms"] = float(self.pricer.compute_anchor_ms) + twin_comm
            out["twin/pred_err_frac"] = (twin_comm - flat_comm) / max(flat_comm, 1e-9)
            out["twin/calib_rows"] = float(self.pricer.calib_rows)
        return out

    def heartbeat_fields(self, control: Any) -> dict:
        if control == ():
            return {}
        return {"control_rung": int(control.rung),
                "control_value": float(rung_value(self.cfg, int(control.rung)))}
