"""Phase-level step tracing: profiler ranges + a host-side timeline.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.obs.trace`.  Two
complementary views of where a step's time goes:

  * **Device view** — :func:`phase` wraps each pipeline phase (compress /
    ef / route / reduce / return / update, :data:`PHASES`) in a
    ``torch.profiler.record_function("tcdp.<name>")`` range, so a
    ``torch.profiler`` trace (``--profile_epoch``) attributes the kernels
    launched inside it to named phases.  JAX's ``named_scope`` exists only
    at trace time; a ``record_function`` costs host time at every enter,
    profiler or not, and the engines enter one per group and phase.  So
    :func:`phase`, :func:`chunk` and :func:`host_span` hand back one shared
    no-op context unless the autograd profiler is running (the check is one
    C call), and only a profiled run pays for the ranges.
  * **Host view** — :class:`StepTimeline` is a ring buffer of per-step
    host timings the loop can observe without stalling the device queue:
    input-pipeline wait and dispatch time every step, plus an optional
    sampled device drain (``device_sync_every``).  It yields p50/p95/p99
    step latency, the data-wait fraction and the step rate — the numbers
    the heartbeat telemetry snapshot and the JSONL event stream carry.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["PHASES", "phase", "chunk", "host_span", "StepTimeline", "percentile"]

#: The phase taxonomy — every range the engines and step factories emit
#: uses one of these (a trace filters on the ``tcdp.`` prefix):
#:   grad      forward + backward of the model
#:   ef        error-feedback residual accumulation
#:   compress  compression operator (top-k / quantize / low-rank factor)
#:   route     sharded transport: per-destination bucketing + all_to_all
#:   reduce    the reduction collective (all-reduce / owner scatter-add)
#:   return    un-flatten / shard-return all_gather back to leaf shapes
#:   update    optimizer apply
#:   ici_reduce  hierarchical transport: dense intra-pod sum (both the
#:             contribution-in and combined-partial-out hops)
#:   recompress  hierarchical transport: pack + slice the pod-reduced
#:             gradient's nonzero union for the inter-pod exchange
PHASES = ("grad", "ef", "compress", "route", "reduce", "return", "update",
          "ici_reduce", "recompress")

#: the shared context entered when no profiler is recording
_OFF = contextlib.nullcontext()


def _profiling() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def _range(name: str):
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(name)


def phase(name: str):
    """Phase annotation: ``with phase('compress'): ...`` names the enclosed
    work ``tcdp.<name>`` in a ``torch.profiler`` trace; a no-op context
    while no profiler runs."""
    return _range(f"tcdp.{name}")


def chunk(index: int):
    """Per-chunk range for the overlap subsystem
    (:mod:`tpu_compressed_dp_torch.parallel.overlap`): chunk ``index``'s
    sync nests the :data:`PHASES` ranges under ``tcdp.chunk<ii>``, so a
    trace attributes each chunk's collectives and its ``tcdp.update`` slice
    to it.  The index is the issue order (0 = first issued)."""
    return _range(f"tcdp.chunk{index:02d}")


def host_span(name: str):
    """Host-side span for the parts of the loop that are not step
    computation (input pipeline, checkpoint saves); the same range
    machinery as :func:`phase`."""
    return _range(f"tcdp.{name}")


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list (empty -> 0.0) — the
    one percentile definition the live snapshot and the offline
    trace_report share."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class StepTimeline:
    """Ring buffer of per-step host timings.

    Protocol (driven by the epoch loop):

    >>> tl = StepTimeline()
    >>> for batch in batches:        # `next()` runs the input pipeline
    ...     tl.batch_ready()         # end of data wait
    ...     state, m = train_step(state, batch)
    ...     tl.step_dispatched()     # end of dispatch (the card runs on)

    Each record splits the step into ``data`` (input-pipeline wait),
    ``dispatch`` (host time to launch the step) and — on sampled steps when
    ``device_sync_every > 0`` — ``device`` (the drain measured by ``sync``,
    by default :func:`tpu_compressed_dp_torch.utils.timer.device_sync` of
    the current CUDA device, which bounds the work still queued behind the
    dispatch).  Un-sampled steps carry no ``device``; their ``total`` is
    the host-visible latency.  Memory is O(``capacity``).
    """

    def __init__(self, capacity: int = 1024, device_sync_every: int = 0,
                 clock: Callable[[], float] = time.perf_counter,
                 sync: Optional[Callable[[], None]] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.device_sync_every = device_sync_every
        self._clock = clock
        if sync is None:
            from tpu_compressed_dp_torch.utils.timer import device_sync

            def sync():
                if torch.cuda.is_available():
                    device_sync(torch.device("cuda", torch.cuda.current_device()))
        self._sync = sync
        self.records: collections.deque = collections.deque(maxlen=capacity)
        # since last drain(); a ring like `records`, so on overflow both
        # keep the NEWEST spans and drained step_spans stay consistent
        # with the snapshot() computed over the same window
        self._pending: collections.deque = collections.deque(maxlen=capacity)
        self.steps = 0
        self._t = clock()   # step start = end of previous dispatch
        self._mark = self._t

    def resume(self) -> None:
        """Re-stamp the step-start mark, excluding everything since the
        last dispatch from the next step's ``data`` split.  Call on entry
        to a train loop/epoch and after any blocking between-step work
        (eval, checkpointing, a log-cadence metrics fetch)."""
        self._t = self._clock()
        self._mark = self._t
        self._data = 0.0

    def batch_ready(self) -> None:
        now = self._clock()
        self._data = now - self._t
        self._mark = now

    def step_dispatched(self) -> None:
        now = self._clock()
        rec: Dict[str, float] = {
            "t0": self._t,
            "data": getattr(self, "_data", now - self._t),
            "dispatch": now - self._mark,
        }
        self.steps += 1
        if self.device_sync_every and self.steps % self.device_sync_every == 0:
            self._sync()
            now2 = self._clock()
            rec["device"] = now2 - now
            now = now2
        rec["total"] = now - rec["t0"]
        self._t = now
        self._data = 0.0
        self.records.append(rec)
        self._pending.append(rec)

    # --- aggregates over the ring window --------------------------------

    def percentiles(self) -> Dict[str, float]:
        totals = sorted(r["total"] for r in self.records)
        return {"p50": percentile(totals, 0.50),
                "p95": percentile(totals, 0.95),
                "p99": percentile(totals, 0.99)}

    def data_wait_frac(self) -> float:
        tot = sum(r["total"] for r in self.records)
        if tot <= 0:
            return 0.0
        return sum(r["data"] for r in self.records) / tot

    def steps_per_sec(self) -> float:
        if len(self.records) < 1:
            return 0.0
        span = sum(r["total"] for r in self.records)
        return len(self.records) / span if span > 0 else 0.0

    def snapshot(self) -> Dict[str, float]:
        """The registry-named telemetry summary (heartbeat / event stream /
        Prometheus payload)."""
        p = self.percentiles()
        return {
            "time/step_p50_ms": p["p50"] * 1e3,
            "time/step_p95_ms": p["p95"] * 1e3,
            "time/step_p99_ms": p["p99"] * 1e3,
            "time/data_wait_frac": self.data_wait_frac(),
            "time/steps_per_sec": self.steps_per_sec(),
        }

    def drain(self) -> List[Dict[str, float]]:
        """Per-step records accumulated since the previous drain — the
        event stream attaches these to epoch/window records so a trace
        report can rebuild the host timeline.  Ring-bounded at
        ``capacity``: a longer window keeps its NEWEST spans."""
        out = list(self._pending)
        self._pending.clear()
        return out
