"""Unified telemetry subsystem (PyTorch-port counterpart of
:mod:`tpu_compressed_dp.obs`).

  * :mod:`~tpu_compressed_dp_torch.obs.registry` — typed metric registry:
    every stat key the system emits, declared once with kind/unit/
    cross-worker reduction.
  * :mod:`~tpu_compressed_dp_torch.obs.trace` — ``tcdp.<phase>`` profiler
    ranges through the sync engines and the step factories (free while no
    profiler runs), plus the host-side
    :class:`~tpu_compressed_dp_torch.obs.trace.StepTimeline` ring buffer.
  * :mod:`~tpu_compressed_dp_torch.obs.export` — schema-versioned JSONL
    event stream, Prometheus textfile exporter, and the heartbeat
    telemetry snapshot consumed by ``harness/watchdog.py --check``.
  * :mod:`~tpu_compressed_dp_torch.obs.flight` — per-rank flight recorder:
    bounded ring buffers, atomic ``blackbox.rank<R>.json`` dumps on the
    failure paths, and the live cross-rank ``straggler/*`` gauges;
    ``harness/postmortem.py`` merges the bundles into a root-cause verdict.
"""

from tpu_compressed_dp_torch.obs import export, flight, registry, trace
from tpu_compressed_dp_torch.obs.export import (EventStream, SCHEMA_VERSION, read_events,
                                                telemetry_snapshot, write_prometheus)
from tpu_compressed_dp_torch.obs.flight import (FLIGHT_SCHEMA, FlightRecorder,
                                                classify_failure, read_bundles,
                                                straggler_gauges, validate_bundle)
from tpu_compressed_dp_torch.obs.registry import MetricSpec
from tpu_compressed_dp_torch.obs.trace import PHASES, StepTimeline, phase

__all__ = [
    "registry", "trace", "export", "flight",
    "MetricSpec", "PHASES", "StepTimeline", "phase",
    "EventStream", "SCHEMA_VERSION", "read_events", "telemetry_snapshot",
    "write_prometheus",
    "FLIGHT_SCHEMA", "FlightRecorder", "classify_failure", "read_bundles",
    "straggler_gauges", "validate_bundle",
]
