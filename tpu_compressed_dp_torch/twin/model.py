"""The scale-out digital twin's cost model (the port's copy of
:mod:`tpu_compressed_dp.twin.model`).

An alpha-beta-gamma model per FABRIC in the methodology of "Near-Optimal
Sparse Allreduce for Distributed Deep Learning" (arXiv 2201.07598): one
collective on fabric ``f`` costs

    T = count * alpha_f  +  beta_f * per_chip_mb  +  gamma_f * hops

where ``alpha`` is the per-dispatch latency (ms), ``beta`` the inverse
bandwidth (ms per per-chip link MB), and ``gamma`` the per-hop cost (ms per
ring round, scaled by how many pod boundaries a round crosses).  A step's
comm time is the sum over the collective schedule its transport actually
emits — the same schedules the engines bill analytically:

  * ``psum``          ring all-reduce: per-chip traffic ``2(W-1)/W x``
                      payload, ``2(W-1)`` rounds per collective
  * ``all_gather``    ``(W-1) x`` payload per chip, ``W-1`` rounds
  * ``all_to_all``    ``(W-1)/W x`` payload per chip, 1 round (the sharded
                      transport's route stage)
  * ``sharded``       route ``all_to_all`` + shard-return ``all_gather``
  * ``hierarchical``  two dense ICI psums over the ``C = W/pods`` intra-pod
                      ring + a DCN ``all_to_all`` route and ``all_gather``
                      return over ``pods`` participants

Fabric billing follows the repo's binding-constraint convention
(:func:`tpu_compressed_dp_torch.utils.meters.per_fabric_traffic_bytes`): flat
whole-world collectives bill to DCN when ``pods > 1`` (the slow fabric
limits a whole-world ring) and to ICI on a flat mesh; only the
hierarchical transport's group collectives bill per fabric directly.

Everything here is a pure function of its arguments — no clocks, no
filesystem — so fits and predictions replay bitwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Collective", "FabricParams", "CostModel", "TwinPoint",
    "UncalibratedFabricError", "flat_fabric", "flat_schedule",
    "hier_schedule", "schedule_for_point", "predict_step_ms",
    "TOPK_BITS_PER_COORD", "DENSE_BITS_PER_ELEM",
]

#: sparse wire format: fp32 value + int32 index per kept coordinate
TOPK_BITS_PER_COORD = 64
#: dense wire format: fp32 per element
DENSE_BITS_PER_ELEM = 32

#: methods whose payload is a (value, index) coordinate list priced at
#: :data:`TOPK_BITS_PER_COORD` — the twin's forward payload model covers
#: these plus 'none'/'dense'; other methods need explicit payload MB
SPARSE_METHODS = ("topk", "blocktopk", "randomk")


class UncalibratedFabricError(ValueError):
    """Raised when a prediction needs a fabric the calibration has zero
    evidence rows for — the twin refuses to extrapolate it."""


@dataclasses.dataclass(frozen=True)
class Collective:
    """One (possibly aggregated) collective on one fabric.

    count:       how many collective dispatches this entry aggregates
    per_chip_mb: total MB through each chip's links across all of them
    hops:        total ring rounds x pod-boundary span across all of them
    """

    fabric: str
    count: float
    per_chip_mb: float
    hops: float


@dataclasses.dataclass(frozen=True)
class FabricParams:
    """Calibrated alpha/beta/gamma for one fabric plus the evidence count
    behind them (``rows == 0`` means the fabric may not be priced)."""

    alpha_ms: float = 0.0
    beta_ms_per_mb: float = 0.0
    gamma_ms_per_hop: float = 0.0
    rows: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "FabricParams":
        return cls(alpha_ms=float(d["alpha_ms"]),
                   beta_ms_per_mb=float(d["beta_ms_per_mb"]),
                   gamma_ms_per_hop=float(d["gamma_ms_per_hop"]),
                   rows=int(d["rows"]))


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-fabric calibrated terms; prices any collective schedule."""

    fabrics: Dict[str, FabricParams]

    def collective_ms(self, c: Collective) -> float:
        p = self.fabrics.get(c.fabric)
        if p is None or p.rows <= 0:
            raise UncalibratedFabricError(
                f"fabric {c.fabric!r} has no calibration rows — the twin "
                f"refuses to extrapolate it (calibrated: "
                f"{sorted(f for f, q in self.fabrics.items() if q.rows)})")
        return (c.count * p.alpha_ms + p.beta_ms_per_mb * c.per_chip_mb
                + p.gamma_ms_per_hop * c.hops)

    def comm_ms(self, schedule: List[Collective],
                hideable_fraction: float = 0.0) -> float:
        """Exposed comm time for a schedule: the summed collective cost
        with the overlap schedule's hideable fraction discounted — bytes
        the ``sync_overlap`` chunk pipeline buries under remaining
        backward compute don't extend the step."""
        total = sum(self.collective_ms(c) for c in schedule)
        hid = min(max(float(hideable_fraction), 0.0), 1.0)
        return total * (1.0 - hid)


def flat_fabric(pods: int) -> str:
    """Which fabric a flat whole-world collective bills to (the
    binding-constraint convention ``per_fabric_traffic_bytes`` prices)."""
    return "dcn" if pods > 1 else "ici"


def flat_schedule(*, world: int, pods: int = 1, count: float = 1.0,
                  psum_mb: float = 0.0, allgather_mb: float = 0.0,
                  alltoall_mb: float = 0.0) -> List[Collective]:
    """Schedule entries for flat whole-world collectives given their
    summed payload MB (the engines' billed buffers).  ``count`` is the
    number of dispatches the payload is spread across (one per reduction
    group); a whole-world round crosses ``pods`` pod boundaries when the
    mesh is 2-level, which is the span factor on hops."""
    w = max(int(world), 1)
    span = max(int(pods), 1) if pods > 1 else 1
    fab = flat_fabric(pods)
    out: List[Collective] = []
    if psum_mb > 0.0 or (allgather_mb <= 0.0 and alltoall_mb <= 0.0):
        out.append(Collective(
            fabric=fab, count=count,
            per_chip_mb=2.0 * (w - 1) / w * psum_mb,
            hops=count * 2.0 * (w - 1) * span))
    if allgather_mb > 0.0:
        out.append(Collective(
            fabric=fab, count=count,
            per_chip_mb=(w - 1) * allgather_mb,
            hops=count * (w - 1) * span))
    if alltoall_mb > 0.0:
        out.append(Collective(
            fabric=fab, count=count,
            per_chip_mb=(w - 1) / w * alltoall_mb,
            hops=count * 1.0 * span))
    return out


def hier_schedule(*, world: int, pods: int, count: float = 1.0,
                  ici_mb: float = 0.0, dcn_route_mb: float = 0.0,
                  dcn_return_mb: float = 0.0) -> List[Collective]:
    """Schedule entries for the hierarchical transport's group
    collectives: two dense intra-pod psums (``ici_mb`` is their summed
    payload, as billed), then the inter-pod route ``all_to_all`` and
    shard-return ``all_gather`` over ``pods`` participants on DCN."""
    pods = max(int(pods), 1)
    chips = max(int(world) // pods, 1)
    out: List[Collective] = []
    if ici_mb > 0.0 and chips > 1:
        out.append(Collective(
            fabric="ici", count=2.0 * count,
            per_chip_mb=2.0 * (chips - 1) / chips * ici_mb,
            hops=2.0 * count * 2.0 * (chips - 1)))
    if pods > 1:
        out.append(Collective(
            fabric="dcn", count=count,
            per_chip_mb=(pods - 1) / pods * dcn_route_mb,
            hops=count * 1.0))
        out.append(Collective(
            fabric="dcn", count=count,
            per_chip_mb=(pods - 1) * dcn_return_mb,
            hops=count * (pods - 1)))
    return out


# --------------------------------------------------------------- forward


@dataclasses.dataclass(frozen=True)
class TwinPoint:
    """One (W, pods, transport, method, knob) point to price.

    ``n_params`` sizes the gradient; the payload per update is derived
    from the method/knob through the engines' own analytic payload
    functions (``topk_keep_count``, ``sharded_payload_bits``,
    ``hier_payload_bits``) so the twin can never disagree with the billed
    wire accounting.  ``compute_ms`` is the non-comm step time anchor
    (from a calibrated context, or measured); ``hideable_fraction`` is
    the overlap schedule's dischargeable byte share (0.0 = nothing
    pipelines, the entiremodel/sync_overlap=1 case).
    """

    world: int
    transport: str                      # psum|all_gather|sharded|hierarchical
    n_params: int
    dp_pods: int = 1
    method: str = "none"                # none|dense|topk|blocktopk|randomk
    ratio: float = 1.0
    num_collectives: float = 1.0
    compute_ms: float = 0.0
    hideable_fraction: float = 0.0
    route_factor: float = 1.25
    return_factor: float = 1.25


def _sparse_keep(point: TwinPoint) -> int:
    from tpu_compressed_dp_torch.ops.compressors import topk_keep_count
    return topk_keep_count(int(point.n_params), float(point.ratio))


def schedule_for_point(point: TwinPoint) -> List[Collective]:
    """The collective schedule ``point``'s transport emits, with payload
    MB derived analytically from the method/knob."""
    n = int(point.n_params)
    w = max(int(point.world), 1)
    pods = max(int(point.dp_pods), 1)
    t = point.transport
    dense_mb = n * DENSE_BITS_PER_ELEM / 8.0 / 1e6
    if point.method in ("none", "dense") or t == "psum":
        if t != "psum":
            raise ValueError(
                f"dense payloads ride the psum transport, got {t!r}")
        return flat_schedule(world=w, pods=pods,
                             count=point.num_collectives, psum_mb=dense_mb)
    if point.method not in SPARSE_METHODS:
        raise ValueError(
            f"the twin's forward payload model covers {SPARSE_METHODS} and "
            f"dense; got method {point.method!r} (price it via an explicit "
            "schedule instead)")
    keep = _sparse_keep(point)
    if t == "all_gather":
        ag_mb = keep * TOPK_BITS_PER_COORD / 8.0 / 1e6
        return flat_schedule(world=w, pods=pods,
                             count=point.num_collectives, allgather_mb=ag_mb)
    if t == "sharded":
        from tpu_compressed_dp_torch.ops.wire_sharded import sharded_payload_bits
        route_bits, ret_bits = sharded_payload_bits(
            n, keep, w, 1, point.route_factor, point.return_factor)
        return flat_schedule(world=w, pods=pods,
                             count=point.num_collectives,
                             alltoall_mb=route_bits / 8.0 / 1e6,
                             allgather_mb=ret_bits / 8.0 / 1e6)
    if t == "hierarchical":
        from tpu_compressed_dp_torch.ops.wire_sharded import hier_payload_bits
        ici_bits, route_bits, ret_bits = hier_payload_bits(
            n, keep, w, pods, point.route_factor, point.return_factor)
        if pods == 1:
            # single pod: the lone dense psum already reduces the world
            return flat_schedule(world=w, pods=1,
                                 count=point.num_collectives,
                                 psum_mb=ici_bits / 8.0 / 1e6)
        return hier_schedule(world=w, pods=pods,
                             count=point.num_collectives,
                             ici_mb=ici_bits / 8.0 / 1e6,
                             dcn_route_mb=route_bits / 8.0 / 1e6,
                             dcn_return_mb=ret_bits / 8.0 / 1e6)
    raise ValueError(f"unknown transport {t!r}")


def predict_step_ms(model: CostModel, point: TwinPoint) -> float:
    """Modeled step time at ``point``: the compute anchor plus the
    exposed comm of the transport's schedule."""
    sched = schedule_for_point(point)
    return float(point.compute_ms) + model.comm_ms(
        sched, hideable_fraction=point.hideable_fraction)


def schedule_features(schedule: List[Collective]
                      ) -> Dict[str, Tuple[float, float, float]]:
    """Per-fabric ``(count, per_chip_mb, hops)`` sums — the calibration
    fitter's design-matrix features for one row."""
    out: Dict[str, List[float]] = {}
    for c in schedule:
        acc = out.setdefault(c.fabric, [0.0, 0.0, 0.0])
        acc[0] += c.count
        acc[1] += c.per_chip_mb
        acc[2] += c.hops
    return {f: (a, b, h) for f, (a, b, h) in sorted(out.items())}
