"""Typed metric registry: the single source of truth for every stat key.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.obs.registry`, spec
for spec (name, kind, unit, reduction, emitter, help), so the port's
exporters write the JAX files' names and help lines.  Every metric the
system emits is declared ONCE, with:

  * ``kind`` — ``counter`` (monotone / additive volume), ``gauge``
    (point-in-time value) or ``timing`` (latency/duration);
  * ``unit`` — what one unit of the value means (``bits``, ``elems``,
    ``examples``, ``seconds``...), so exporters never guess;
  * ``reduction`` — how the value combines ACROSS WORKERS: ``mean`` /
    ``sum`` for volumes, ``min`` / ``max`` for 0/1 diagnostics and
    monotone watermarks (``sync_agree`` is a unanimity verdict — MIN;
    ``guard/nonfinite`` is an any-worker alarm — MAX).  The partitioned
    sync engine (:mod:`tpu_compressed_dp_torch.parallel.dp`) derives its
    diagnostic-combine table from these declarations, and
    ``utils/loggers.MetricAccumulator`` its sum keys;
  * ``emitter`` — which layer produces it: ``engine`` (inside
    ``sync(...)``, raw key later prefixed ``comm/`` by the step factories),
    ``step`` (the train step), ``eval`` (the eval step), or ``host``
    (harness-side derived telemetry: throughput, MFU, latency percentiles).

The port's tests run every engine over the method x transport x
granularity matrix and fail on any emitted key that is not declared here.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List

__all__ = [
    "MetricSpec", "REGISTRY", "declare", "canonical", "spec", "is_declared",
    "undeclared", "engine_diag_reductions", "prometheus_name",
    "COUNTER", "GAUGE", "TIMING",
]

COUNTER = "counter"
GAUGE = "gauge"
TIMING = "timing"
_KINDS = (COUNTER, GAUGE, TIMING)
_REDUCTIONS = ("mean", "sum", "min", "max")
_EMITTERS = ("engine", "step", "eval", "host")


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    name: str       # canonical full name (engines emit it without "comm/")
    kind: str       # counter | gauge | timing
    unit: str       # bits, elems, examples, tokens, seconds, ratio, ...
    reduction: str  # cross-worker combine: mean | sum | min | max
    emitter: str    # engine | step | eval | host
    help: str = ""


REGISTRY: Dict[str, MetricSpec] = {}


def declare(name: str, kind: str, unit: str, reduction: str, emitter: str,
            help: str = "") -> MetricSpec:
    """Register one metric; redeclaring with a different spec is an error
    (two subsystems fighting over one key is exactly the bug class the
    registry exists to kill)."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    if reduction not in _REDUCTIONS:
        raise ValueError(
            f"reduction must be one of {_REDUCTIONS}, got {reduction!r}")
    if emitter not in _EMITTERS:
        raise ValueError(f"emitter must be one of {_EMITTERS}, got {emitter!r}")
    ms = MetricSpec(name, kind, unit, reduction, emitter, help)
    prev = REGISTRY.get(name)
    if prev is not None and prev != ms:
        raise ValueError(f"metric {name!r} already declared as {prev}")
    REGISTRY[name] = ms
    return ms


# --- engine-emitted (sync stats; step factories prefix raw keys "comm/",
#     except guard/* which the guard wrapper emits pre-prefixed) ----------
declare("comm/sent_elems", COUNTER, "elems", "mean", "engine",
        "elements the wire representation carries this step")
declare("comm/sent_bits", COUNTER, "bits", "mean", "engine",
        "payload bits on the wire this step (analytic in simulate mode, "
        "measured in wire mode)")
declare("comm/sent_bits_psum", COUNTER, "bits", "mean", "engine",
        "payload bits riding the psum ring (2(W-1)/W per-chip traffic)")
declare("comm/sent_bits_allgather", COUNTER, "bits", "mean", "engine",
        "payload bits riding an all_gather ((W-1)x per-chip traffic)")
declare("comm/sent_bits_alltoall", COUNTER, "bits", "mean", "engine",
        "payload bits riding the sharded transport's all_to_all route "
        "((W-1)/W per-chip traffic)")
declare("comm/sent_bits_ici", COUNTER, "bits", "mean", "engine",
        "hierarchical transport: bits on the fast intra-pod ICI fabric "
        "(the dense pod psums; 2(C-1)/C per-chip traffic within a pod)")
declare("comm/sent_bits_dcn", COUNTER, "bits", "mean", "engine",
        "hierarchical transport: bits crossing the slow inter-pod DCN "
        "fabric (sparse route + shard return; the binding constraint)")
declare("comm/sent_bits_dcn_route", COUNTER, "bits", "mean", "engine",
        "the all_to_all route share of sent_bits_dcn ((P-1)/P per-chip; "
        "the remainder is the (P-1)x shard-return all_gather)")
declare("comm/dense_elems", GAUGE, "elems", "mean", "engine",
        "uncompressed gradient size (the compression denominator)")
declare("comm/num_collectives", GAUGE, "collectives", "mean", "engine",
        "collectives issued per sync (granularity-dependent)")
declare("comm/sync_agree", GAUGE, "bool", "min", "engine",
        "check_sync verdict: 1.0 = every worker selected identical "
        "indices / holds an identical warm start (unanimity -> pmin)")
declare("comm/threshold_overflow", COUNTER, "elems", "mean", "engine",
        "threshold-method survivors clipped by the fixed wire capacity")
declare("comm/topk_surplus_dropped", COUNTER, "elems", "mean", "engine",
        "above-threshold tie survivors beyond keep, truncated (EF off)")
declare("comm/shard_overflow", COUNTER, "elems", "mean", "engine",
        "coordinates clipped by the sharded transport's route/return caps")
declare("guard/nonfinite", GAUGE, "bool", "max", "engine",
        "1.0 = this step was vetoed by the finiteness vote "
        "(any-worker alarm -> pmax)")

# --- step-emitted (jitted train step, already globally reduced) ---------
declare("loss", GAUGE, "nats", "mean", "step", "global mean train loss")
declare("lr", GAUGE, "lr", "mean", "step", "learning rate at this step")
declare("correct", COUNTER, "examples", "sum", "step",
        "top-1 correct examples this step (global)")
declare("count", COUNTER, "examples", "sum", "step",
        "examples this step (global)")
declare("tokens", COUNTER, "tokens", "sum", "step",
        "tokens this step (global)")
declare("guard/loss_scale", GAUGE, "scale", "mean", "step",
        "live dynamic loss scale (replicated)")
declare("guard/skipped", COUNTER, "steps", "max", "step",
        "cumulative vetoed steps (monotone, replicated)")
declare("guard/skip_streak", GAUGE, "steps", "max", "step",
        "consecutive vetoed steps ending at this step")
declare("guard/last_good_step", GAUGE, "steps", "max", "step",
        "last step whose update was applied")

# --- eval-step emitted ---------------------------------------------------
declare("loss_sum", COUNTER, "nats", "sum", "eval", "summed eval loss")
declare("correct5", COUNTER, "examples", "sum", "eval",
        "top-5 correct examples (global)")

# --- host-derived telemetry (harness epilogues / exporters) -------------
declare("throughput/examples_per_sec", GAUGE, "examples/s", "mean", "host",
        "global training throughput over the window")
declare("throughput/tokens_per_sec", GAUGE, "tokens/s", "mean", "host",
        "global token throughput over the window")
declare("throughput/model_tflops_per_chip", GAUGE, "tflops", "mean", "host",
        "model (fwd+bwd) TFLOP/s per chip at the measured rate")
declare("throughput/mfu", GAUGE, "ratio", "mean", "host",
        "model FLOPs utilisation vs the chip's bf16 peak")
declare("net/comm_mb_per_sec", GAUGE, "MB/s", "mean", "host",
        "analytic per-chip gradient-sync link traffic at the measured rate")
declare("net/payload_mb_per_step", GAUGE, "MB", "mean", "host",
        "wire payload per step from comm/sent_bits (NetMeter window mean)")
declare("net/allreduce_gbps_per_chip", GAUGE, "Gb/s", "mean", "host",
        "per-chip ring-allreduce traffic rate over the NetMeter window")
declare("net/compression_frac", GAUGE, "ratio", "mean", "host",
        "wire payload / dense gradient bytes over the NetMeter window")
declare("net/dcn_mb_per_step", GAUGE, "MB", "mean", "host",
        "per-chip bytes crossing the inter-pod DCN fabric per step "
        "(hierarchical transport; 0 on a flat mesh)")
declare("net/dcn_gbps_per_chip", GAUGE, "Gb/s", "mean", "host",
        "per-chip DCN traffic rate over the NetMeter window — the number "
        "to hold under the inter-pod link budget")
declare("net/ici_gbps_per_chip", GAUGE, "Gb/s", "mean", "host",
        "per-chip intra-pod ICI traffic rate over the NetMeter window")
declare("net/recv_gbit_s", GAUGE, "Gb/s", "mean", "host",
        "received Gbit/s at the measured step rate (TB net/ tab parity "
        "with the reference's in_gb counters)")
declare("net/transmit_gbit_s", GAUGE, "Gb/s", "mean", "host",
        "transmitted Gbit/s at the measured step rate")
declare("guard/skip_rate", GAUGE, "ratio", "mean", "host",
        "vetoed-step fraction over the logging window "
        "(windowed mean of guard/nonfinite)")
declare("time/step_p50_ms", TIMING, "ms", "mean", "host",
        "median host-observed step latency over the timeline window")
declare("time/step_p95_ms", TIMING, "ms", "mean", "host",
        "p95 host-observed step latency")
declare("time/step_p99_ms", TIMING, "ms", "mean", "host",
        "p99 host-observed step latency")
declare("time/data_wait_frac", GAUGE, "ratio", "mean", "host",
        "fraction of step wall time spent waiting on the input pipeline")
declare("time/steps_per_sec", GAUGE, "steps/s", "mean", "host",
        "host-observed step rate over the timeline window")

# --- elastic runtime (train/elastic.py; every survivor derives identical
#     values from the same coordinated failure, hence max = identity) ----
declare("elastic/peer_failures", COUNTER, "workers", "max", "host",
        "workers declared dead over the run (gossip, fetch timeout, or "
        "chaos mid-collective kill)")
declare("elastic/remesh_count", COUNTER, "remeshes", "max", "host",
        "completed W -> W-1 (or readmission) remesh barriers")
declare("elastic/dropped_ef_norm", COUNTER, "l2", "max", "host",
        "L2 norm of departed workers' EF residual mass discarded under "
        "the drop policy (0 under fold)")
declare("elastic/remesh_latency_ms", TIMING, "ms", "mean", "host",
        "host latency of the latest remesh (state migration + re-place)")
declare("elastic/remesh_ms", TIMING, "ms", "max", "host",
        "cumulative training downtime spent in elastic world transitions "
        "(remesh + rendezvous re-init + readmission) over the run")

# --- checkpoint subsystem (utils/checkpoint.py; host-side) --------------
declare("ckpt/save_ms", TIMING, "ms", "mean", "host",
        "wall time of the newest committed checkpoint write (Orbax save + "
        "manifest commit + GC; runs on a background thread for save_async)")
declare("ckpt/blocked_ms", TIMING, "ms", "max", "host",
        "cumulative step-loop time spent barriered on an in-flight async "
        "checkpoint write (a save/drain overlapping the previous one)")
declare("ckpt/inflight", GAUGE, "writes", "max", "host",
        "1 while a background checkpoint write is in flight, else 0")
declare("ckpt/last_step", GAUGE, "steps", "max", "host",
        "train step of the newest committed checkpoint (-1 before the "
        "first commit)")
declare("ckpt/age_s", GAUGE, "s", "max", "host",
        "seconds since the newest committed checkpoint (since the "
        "checkpointer opened, before the first commit)")
declare("ckpt/rollback_steps", COUNTER, "steps", "max", "host",
        "steps walked back past corrupt/unreadable checkpoints to reach "
        "the newest verifiable one at restore time")

# --- delta state streaming (stream/; host-side — writer counters on the
#     training ranks, reader gauges on stream_serve consumers) -----------
declare("stream/segments", COUNTER, "segments", "max", "host",
        "delta/keyframe segments committed to the stream directory over "
        "the writer's lifetime")
declare("stream/keyframes", COUNTER, "segments", "max", "host",
        "full-keyframe segments among the committed total (window anchors "
        "plus forced re-anchors after remesh/checkpoint)")
declare("stream/bytes", COUNTER, "bytes", "max", "host",
        "cumulative payload bytes across all committed segments (the "
        "steady-state stream cost BENCH compares against full "
        "checkpoint bytes)")
declare("stream/keyframe_bytes", COUNTER, "bytes", "max", "host",
        "payload bytes spent on full keyframes (the dense fraction of "
        "stream/bytes)")
declare("stream/append_ms", TIMING, "ms", "mean", "host",
        "commit wall time of the newest segment (payload + digest + "
        "manifest + head; background thread for append_async)")
declare("stream/residual_norm", GAUGE, "norm", "mean", "host",
        "L2 norm of the writer's untransmitted drift (params minus "
        "last_streamed); exactly 0 after a keyframe or window flush")
declare("stream/last_step", GAUGE, "steps", "max", "host",
        "train step of the newest committed segment on the writer, or "
        "the newest applied segment on a reader (-1 before the first)")
declare("stream/lag_s", GAUGE, "s", "max", "host",
        "reader staleness: seconds since the newest applied segment's "
        "write timestamp (-1 before anything applied)")
declare("stream/rejoin_bytes", GAUGE, "bytes", "max", "host",
        "bytes a warm rejoin moved over the delta stream in place of the "
        "full params broadcast (0 = no warm rejoin yet)")
declare("stream/corrupt_segments", COUNTER, "segments", "max", "host",
        "segments a reader rejected at verification (each triggers a "
        "walk-back to the last keyframe)")

# --- adaptive compression control plane (control/; host-side — every
#     worker's controller consumes identical psum'd metrics, so values are
#     identical across workers) -------------------------------------------
declare("control/rung", GAUGE, "index", "mean", "host",
        "current compression-ladder position (0 = least compressed)")
declare("control/value", GAUGE, "knob", "mean", "host",
        "active rung's knob value (keep ratio, or PowerSGD rank)")
declare("control/decisions", COUNTER, "windows", "max", "host",
        "decision windows closed so far (the control_decision event cursor)")
declare("control/window_updates", GAUGE, "updates", "mean", "host",
        "applied updates accumulated in the open decision window")
declare("control/comm_ms", TIMING, "ms", "mean", "host",
        "open window's mean per-update comm-time signal (modeled: billed "
        "bits over configured bandwidth; measured: timeline)")
declare("control/budget_ms", TIMING, "ms", "mean", "host",
        "open window's mean per-update hideable-compute budget")

# --- scale-out digital twin (twin/; host-side — the calibrated
#     alpha/beta/gamma cost model pricing the run's comm, exported when
#     the controller runs with --adaptive_model twin) --------------------
declare("twin/pred_step_ms", TIMING, "ms", "mean", "host",
        "twin-modeled step time at the open window's mean billed bits: "
        "the calibrated context's compute anchor plus the priced comm")
declare("twin/pred_err_frac", GAUGE, "frac", "mean", "host",
        "relative discrepancy between the twin's comm price and the flat "
        "--adaptive_bw_mbps price for the same billed bits (the audit "
        "signal tools/control_report.py tabulates)")
declare("twin/calib_rows", GAUGE, "rows", "max", "host",
        "calibration rows behind the twin's fitted fabric parameters")


# --- fleet control plane (fleet/scheduler.py; host-side — the scheduler
#     process is the single writer, per-job values carry a job="<id>"
#     label in the textfile exposition) ----------------------------------
declare("fleet/world", GAUGE, "devices", "max", "host",
        "devices currently assigned to this job (0 while waiting)")
declare("fleet/priority", GAUGE, "priority", "max", "host",
        "the job spec's admission/preemption priority")
declare("fleet/applied_updates", COUNTER, "updates", "max", "host",
        "the job's applied-update watermark as last reported by its "
        "controller poll")
declare("fleet/restarts", COUNTER, "restarts", "max", "host",
        "crash restarts burned from the job's budget (preemptions and "
        "evictions are free, like the watchdog's preempt accounting)")
declare("fleet/jobs_running", GAUGE, "jobs", "max", "host",
        "jobs currently holding devices")
declare("fleet/jobs_waiting", GAUGE, "jobs", "max", "host",
        "admitted jobs waiting for capacity (incl. evicted jobs queued "
        "for resume)")
declare("fleet/devices_free", GAUGE, "devices", "max", "host",
        "unassigned devices in the pool")
declare("fleet/evictions", COUNTER, "jobs", "max", "host",
        "priority preemptions executed over the fleet's lifetime "
        "(SIGTERM -> emergency save -> exit 75)")
declare("fleet/shrinks", COUNTER, "jobs", "max", "host",
        "elastic shrinks executed to fund higher-priority placements")
declare("fleet/readmits", COUNTER, "jobs", "max", "host",
        "growth actions readmitting freed capacity into shrunken jobs "
        "through the elastic readmit barrier")


# --- flight recorder + live straggler detection (obs/flight.py;
#     host-side, observation-only — per-rank values) ---------------------
declare("flight/records", COUNTER, "records", "max", "host",
        "records accepted into the flight recorder's ring buffers over "
        "the process lifetime")
declare("flight/dumps", COUNTER, "bundles", "max", "host",
        "blackbox bundle dumps committed to the shared dir (>0 means a "
        "failure path fired)")
declare("flight/last_dump_step", GAUGE, "step", "max", "host",
        "global step of the most recent blackbox dump (-1 = none)")
declare("straggler/skew_s", GAUGE, "s", "max", "host",
        "cross-rank skew of the mean host step time (slowest minus "
        "fastest rank, from the shared flight phase profiles)")
declare("straggler/rank", GAUGE, "rank", "max", "host",
        "the slowest rank by mean host step time (-1 when fewer than "
        "two ranks report)")
declare("straggler/frac", GAUGE, "frac", "max", "host",
        "straggler skew relative to the fastest rank's mean step time")


def canonical(key: str) -> str:
    """Map a raw engine stat key to its canonical registry name.

    The step factories prefix engine stats with ``comm/`` (guard/* keys
    pass through); this applies the same mapping so conformance checks can
    consume either form."""
    if key in REGISTRY or "/" in key:
        return key
    prefixed = f"comm/{key}"
    return prefixed if prefixed in REGISTRY else key


def is_declared(key: str) -> bool:
    return canonical(key) in REGISTRY


def spec(key: str) -> MetricSpec:
    return REGISTRY[canonical(key)]


def undeclared(keys: Iterable[str]) -> List[str]:
    """The subset of ``keys`` (raw or canonical) missing from the registry."""
    return sorted(k for k in keys if not is_declared(k))


def engine_diag_reductions() -> Dict[str, str]:
    """Raw engine keys whose cross-worker reduction is min/max — the 0/1
    diagnostics the partitioned sync must NOT psum over model axes.  Keyed
    by the raw (un-prefixed) name the engines emit; the single source the
    engine's diagnostic table is built from."""
    out = {}
    for name, ms in REGISTRY.items():
        if ms.emitter != "engine" or ms.reduction not in ("min", "max"):
            continue
        raw = name[len("comm/"):] if name.startswith("comm/") else name
        out[raw] = ms.reduction
    return out


def prometheus_name(key: str) -> str:
    """``comm/sent_bits`` -> ``tcdp_comm_sent_bits`` (exposition-safe)."""
    return "tcdp_" + re.sub(r"[^a-zA-Z0-9_]", "_", canonical(key))
