"""Timing and communication meters.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.utils.meters` (the
reference's ``IMAGENET/training/meter.py``):

  * ``TimeMeter``: the host's split of the train loop, data wait vs
    dispatch (CUDA launches return before the card finishes, so per-step
    device time is the epoch barrier's, ``harness/loop.py``);
  * ``NetworkMeter``: real NIC Gbit/s from ``/proc/net/dev`` deltas;
  * ``CommMeter`` and the traffic helpers: analytic bytes on the wire from
    the train step's ``comm/*`` metrics, split by collective kind;
  * ``GuardMeter``: the step guard's skip rate from its ``guard/*``
    metrics (``train/guard.py``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

__all__ = ["TimeMeter", "NetworkMeter", "CommMeter", "GuardMeter",
           "network_bytes", "per_chip_traffic_bytes", "per_chip_comm_bytes",
           "per_fabric_traffic_bytes", "per_fabric_comm_bytes"]


def per_chip_traffic_bytes(psum_bytes: float, allgather_bytes: float,
                           world: int, alltoall_bytes: float = 0.0) -> float:
    """Per-chip link traffic for one gradient sync at ``world`` chips.

    The method-aware transport arithmetic: a ring psum moves ``2(W-1)/W x payload`` through each
    chip's links; an all_gather of worker-distinct payloads moves
    ``(W-1) x payload`` per chip (every worker's packet visits every other
    chip); an all_to_all moves ``(W-1)/W x payload`` per chip (each worker
    keeps its own ``1/W`` bucket locally and sends one bucket to each peer
    — the sharded transport's route stage, whose shard-return all_gather
    bills in the allgather bucket).  The sync engines report the split as
    ``comm/sent_bits_psum`` / ``comm/sent_bits_allgather`` /
    ``comm/sent_bits_alltoall``.
    """
    ring = 2 * (world - 1) / max(world, 1)
    return (ring * psum_bytes + (world - 1) * allgather_bytes
            + (world - 1) / max(world, 1) * alltoall_bytes)


def per_fabric_traffic_bytes(psum_bytes: float, allgather_bytes: float,
                             world: int, alltoall_bytes: float = 0.0,
                             ici_bytes: float = 0.0,
                             dcn_route_bytes: float = 0.0,
                             dcn_return_bytes: float = 0.0,
                             pods: int = 1) -> Tuple[float, float]:
    """Per-chip link traffic split ``(ici_bytes, dcn_bytes)`` for one sync
    on a ``pods x (world/pods)`` virtual mesh.

    The hierarchical transport's group collectives bill per fabric
    directly: the dense pod psums ride the ``C = world/pods``-chip
    intra-pod ring (``2(C-1)/C x`` their summed payload); the inter-pod
    route is an all_to_all over ``pods`` participants (``(P-1)/P x``) and
    the shard return an all_gather (``(P-1) x``).  Whole-world collectives
    (the flat psum/allgather/alltoall buckets from non-hierarchical
    groups) span BOTH fabrics; they bill to DCN when ``pods > 1`` — the
    slow fabric is the binding constraint a whole-world ring is limited by
    — and to ICI on a flat mesh (``pods == 1``), where they are the whole
    story and ``dcn == 0``.
    """
    pods = max(pods, 1)
    chips = max(world // pods, 1)
    flat = per_chip_traffic_bytes(psum_bytes, allgather_bytes, world,
                                  alltoall_bytes)
    ici = 2 * (chips - 1) / chips * ici_bytes
    dcn = ((pods - 1) / pods * dcn_route_bytes
           + (pods - 1) * dcn_return_bytes)
    if pods > 1:
        dcn += flat
    else:
        ici += flat
    return ici, dcn


def per_chip_comm_bytes(m: Dict[str, float], world: int,
                        pods: int = 1) -> Optional[float]:
    """Per-chip link bytes of ONE step from a ``comm/*`` metrics dict
    (per-step values or epoch means), applying the transport split through
    :func:`per_chip_traffic_bytes` (plus the hierarchical transport's
    per-fabric terms when present).  None when comm metrics are absent
    (compression off)."""
    fabric = per_fabric_comm_bytes(m, world, pods)
    if fabric is None:
        return None
    return fabric[0] + fabric[1]


def per_fabric_comm_bytes(m: Dict[str, float], world: int,
                          pods: int = 1) -> Optional[Tuple[float, float]]:
    """``(ici_bytes, dcn_bytes)`` per chip for ONE step from a ``comm/*``
    metrics dict — :func:`per_fabric_traffic_bytes` fed from the engines'
    billed split.  None when comm metrics are absent."""
    if "comm/sent_bits" not in m:
        return None
    psum_b = float(m.get("comm/sent_bits_psum", m["comm/sent_bits"])) / 8
    ag_b = float(m.get("comm/sent_bits_allgather", 0.0)) / 8
    a2a_b = float(m.get("comm/sent_bits_alltoall", 0.0)) / 8
    ici_b = float(m.get("comm/sent_bits_ici", 0.0)) / 8
    dcn_b = float(m.get("comm/sent_bits_dcn", 0.0)) / 8
    rt_b = float(m.get("comm/sent_bits_dcn_route", 0.0)) / 8
    return per_fabric_traffic_bytes(
        psum_b, ag_b, world, a2a_b, ici_b, rt_b, max(dcn_b - rt_b, 0.0),
        pods)


class TimeMeter:
    """Host-side split of the train loop: data wait vs dispatch."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.data_time = 0.0
        self.dispatch_time = 0.0
        self.batches = 0
        self._t = time.perf_counter()

    def batch_loaded(self):
        now = time.perf_counter()
        self.data_time += now - self._t
        self._t = now

    def batch_dispatched(self):
        now = time.perf_counter()
        self.dispatch_time += now - self._t
        self._t = now
        self.batches += 1

    def summary(self) -> Dict[str, float]:
        n = max(self.batches, 1)
        return {
            "data ms/batch": self.data_time / n * 1e3,
            "dispatch ms/batch": self.dispatch_time / n * 1e3,
        }


def network_bytes() -> Tuple[int, int]:
    """Total (recv, transmit) bytes across non-loopback NICs."""
    recv = transmit = 0
    try:
        with open("/proc/net/dev") as f:
            lines = f.read().splitlines()
    except OSError:
        return 0, 0
    for line in lines[2:]:
        iface, _, rest = line.partition(":")
        if iface.strip() == "lo" or not rest:
            continue
        cols = rest.split()
        recv += int(cols[0])
        transmit += int(cols[8])
    return recv, transmit


class NetworkMeter:
    """Real NIC bandwidth over the interval since the last call."""

    def __init__(self):
        self.last_t = time.perf_counter()
        self.last_recv, self.last_transmit = network_bytes()

    def update_bandwidth(self) -> Tuple[float, float]:
        """Returns (recv_gbit/s, transmit_gbit/s) since the previous call."""
        now = time.perf_counter()
        recv, transmit = network_bytes()
        dt = max(now - self.last_t, 1e-9)
        rg = (recv - self.last_recv) * 8 / 1e9 / dt
        tg = (transmit - self.last_transmit) * 8 / 1e9 / dt
        self.last_t, self.last_recv, self.last_transmit = now, recv, transmit
        return rg, tg



class GuardMeter:
    """Step-guard bookkeeping from the train step's ``guard/*`` metrics.

    ``update(metrics, step)`` takes fetched metrics at global step ``step``;
    the skip rate is the delta of the cumulative ``guard/skipped`` over the
    step delta since the previous update (sampling per-step verdicts at the
    log cadence would alias against periodic faults).  The first update
    only seeds the window (a resumed run's counters start nonzero).
    ``summary`` gives the latest guard scalars and ``guard/skip_rate``;
    empty while the guard is off."""

    def __init__(self):
        self.last: Dict[str, float] = {}
        self._prev_skipped = 0.0
        self._prev_step = 0.0
        self._seeded = False
        self._rate = 0.0

    def update(self, metrics: Dict[str, float], step: float) -> None:
        if "guard/skipped" not in metrics:
            return
        self.last = {k: float(v) for k, v in metrics.items() if k.startswith("guard/")}
        cur = float(metrics["guard/skipped"])
        if self._seeded and step > self._prev_step:
            self._rate = (cur - self._prev_skipped) / (step - self._prev_step)
        self._prev_skipped, self._prev_step = cur, float(step)
        self._seeded = True

    def summary(self) -> Dict[str, float]:
        if not self.last:
            return {}
        return {**self.last, "guard/skip_rate": self._rate}

class CommMeter:
    """Analytic gradient-sync traffic accumulated from ``comm/*`` metrics.

    ``update`` takes one step's metrics dict; ``gbps`` converts the payload
    accumulated since the last call into ring-allreduce GB/s per chip.
    """

    def __init__(self, world: int):
        self.world = max(world, 1)
        self.reset()

    def reset(self):
        self.payload_bytes = 0.0
        self.dense_bytes = 0.0
        self.steps = 0
        self._t = time.perf_counter()

    def update(self, metrics: Dict[str, float]) -> None:
        if "comm/sent_bits" not in metrics:
            return
        self.payload_bytes += float(metrics["comm/sent_bits"]) / 8
        self.dense_bytes += float(metrics["comm/dense_elems"]) * 4
        self.steps += 1

    def gbps(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self._t, 1e-9)
        ring = 2 * (self.world - 1) / self.world
        out = {
            "net/payload_mb_per_step": self.payload_bytes / max(self.steps, 1) / 1e6,
            "net/allreduce_gbps_per_chip": ring * self.payload_bytes / 1e9 / dt,
            "net/compression_frac": self.payload_bytes / max(self.dense_bytes, 1e-9),
        }
        self.reset()
        return out
