"""Deterministic signal models feeding the controller.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.control.signals`.
The controller equalizes two per-update quantities: **comm time** (what the
sync costs) against the **hideable-compute budget** (how much of that cost
the ``--overlap`` chunk schedule can bury under the remaining backward
pass).  Nothing here reads a clock: the 'modeled' path is a pure function
of the engines' analytic billed bits, and the 'measured' path takes
wall-times the HARNESS observed (StepTimeline) as plain arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

from tpu_compressed_dp_torch.control.config import ControlConfig

__all__ = ["WindowSignals", "modeled_comm_ms", "hideable_budget_ms", "billed_signal_bits",
           "mean_or_zero", "TwinPricer"]


@dataclasses.dataclass(frozen=True)
class WindowSignals:
    """One tick's per-update signals, as the harness hands them to
    :meth:`~tpu_compressed_dp_torch.control.controller.Controller.tick`."""

    bits: float       # billed wire bits per update (``comm/sent_bits`` mean)
    comm_ms: float    # comm-time signal per update, ms
    budget_ms: float  # hideable-compute budget per update, ms


def modeled_comm_ms(bits_per_update: float, bandwidth_mbps: float) -> float:
    """Analytic per-update comm time: billed bits over the configured wire
    bandwidth.  ``bits / (Mbit/s)`` = microseconds; divide by 1e3 for ms.
    ``comm/sent_bits`` is computed analytically (simulate) or from the
    payload's layout (wire), so a replayed run models the identical time."""
    return float(bits_per_update) / (float(bandwidth_mbps) * 1e3)


def billed_signal_bits(comm_means, pods: int = 1) -> float:
    """The billed-bits series the modeled signal prices: on a flat world
    the whole ``comm/sent_bits``; at ``pods > 1`` the DCN-billed share
    (``comm/sent_bits`` less ``comm/sent_bits_ici``) — the inter-pod link
    is the constraint a cross-pod bandwidth budget is set against."""
    total = float(comm_means.get("comm/sent_bits", 0.0))
    if pods <= 1:
        return total
    ici = float(comm_means.get("comm/sent_bits_ici", 0.0))
    return total - ici


@dataclasses.dataclass(frozen=True)
class TwinPricer:
    """Prices billed bits through the calibrated digital twin
    (``--adaptive_model twin``): the bits are laid onto the run's transport
    schedule at its (world, pods) topology and priced with the fitted
    per-fabric alpha/beta/gamma, so a rung's comm cost carries the dispatch
    latency and per-hop terms the flat ``bits / bandwidth`` division cannot
    see.  At ``pods > 1`` the bits handed in are the DCN-billed share
    (:func:`billed_signal_bits`), which is why the sharded / hierarchical
    route and return split ``route_frac`` / ``1 - route_frac`` over one
    fabric.  A frozen pure function of its inputs.

    model:             a fitted :class:`tpu_compressed_dp_torch.twin.CostModel`
    world / pods:      the run's dp topology
    transport:         psum | all_gather | sharded | hierarchical
    num_collectives:   dispatches per update (reduction-group count)
    route_frac:        share of sparse bits riding the route all_to_all
                       (the rest ride the shard-return all_gather)
    calib_rows:        evidence rows behind ``model`` (``twin/calib_rows``)
    compute_anchor_ms: calibrated non-comm step time for the run's context
                       (the ``twin/pred_step_ms`` baseline)
    """

    model: Any
    world: int
    pods: int = 1
    transport: str = "psum"
    num_collectives: float = 1.0
    route_frac: float = 0.888
    calib_rows: int = 0
    compute_anchor_ms: float = 0.0

    def comm_ms(self, bits_per_update: float) -> float:
        from tpu_compressed_dp_torch.twin.model import flat_schedule

        mb = float(bits_per_update) / 8.0 / 1e6
        kw = dict(world=self.world, pods=self.pods, count=self.num_collectives)
        if self.transport == "all_gather":
            sched = flat_schedule(allgather_mb=mb, **kw)
        elif self.transport in ("sharded", "hierarchical"):
            # route bits ride the all_to_all bucket, return bits the
            # all_gather; hierarchical's DCN share splits the same way
            sched = flat_schedule(alltoall_mb=mb * self.route_frac,
                                  allgather_mb=mb * (1.0 - self.route_frac), **kw)
        else:
            sched = flat_schedule(psum_mb=mb, **kw)
        return self.model.comm_ms(sched)

    def step_ms(self, bits_per_update: float) -> float:
        return self.compute_anchor_ms + self.comm_ms(bits_per_update)


def hideable_budget_ms(cfg: ControlConfig, *, compute_ms: Optional[float] = None,
                       hideable_fraction: float = 1.0) -> float:
    """The per-update compute budget comm should be tuned to fit inside:
    ``cfg.budget_ms`` when > 0, else the measured per-update compute time
    scaled by the overlap schedule's hideable fraction
    (:func:`tpu_compressed_dp_torch.parallel.overlap.hideable_byte_fraction`)."""
    if cfg.budget_ms > 0.0:
        return float(cfg.budget_ms)
    if compute_ms is None:
        raise ValueError(
            "budget_ms=0 needs a measured compute_ms to derive the budget "
            "from (pass --adaptive_budget_ms, or use signal='measured' with "
            "a timeline)")
    return float(compute_ms) * float(hideable_fraction)


def mean_or_zero(values: Sequence[float]) -> float:
    """Mean of a possibly-empty sequence (0.0 when empty) — tick inputs for
    epochs where every step was skipped."""
    vals = list(values)
    return sum(vals) / len(vals) if vals else 0.0
