"""Epoch loops and the robustness surface shared by the harnesses.

PyTorch-port counterpart of ``run_train_epoch``, ``run_eval``,
``train_epoch``, ``comm_summary``, ``guard_summary``, ``pad_batch`` and the
robustness helpers (``add_robustness_args``, ``add_checkpoint_args``,
``build_robustness``, ``build_elastic``, ``elastic_distributed_init``,
``make_heartbeat``, ``make_preemption``, ``preempt_exit``) and the
telemetry and control helpers (``add_telemetry_args``,
``add_adaptive_args``, ``make_event_stream``, ``make_flight_recorder``,
``flight_update``, ``job_scoped``, ``prom_labels``, ``fabric_gauges``,
``build_control``, ``control_summary``, ``profile_trace``) and the delta
stream's (``add_stream_args``, ``make_stream``, ``stream_join_seq``,
``stream_rejoin_params``) of
:mod:`tpu_compressed_dp.harness.loop`, plus :func:`run_local_eval` for
loaders that hand each process its own (possibly empty) batches,
:func:`local_device` for the entry points and :func:`add_process_args` for
the process flags.  Train metrics stay on the device until the epoch ends
and come back in one copy (under ``--elastic`` with the peer-timeout
deadline).  Before each dispatch :func:`run_train_epoch` runs the chaos
crash check, then the preemption check (a ``crash=preempt`` self-SIGTERM
is seen in the same iteration), then the elastic gossip poll; right after
the dispatch, the ``mid_collective`` crash check.  A ``timeline``
(``obs/trace.StepTimeline``) splits each step's host time into data wait
and dispatch; a ``flight`` recorder rings the fetched metrics before the
guard's wedge check reads them.  An exception leaving the epoch carries the
live state as ``err.train_state`` for the emergency save and the elastic
remesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.utils.loggers import MetricAccumulator
from tpu_compressed_dp_torch.utils.timer import Timer

__all__ = ["run_train_epoch", "run_eval", "run_local_eval", "train_epoch", "comm_summary",
           "guard_summary", "control_summary", "fabric_gauges", "pad_batch", "to_device",
           "local_device", "add_robustness_args", "add_adaptive_args", "add_telemetry_args",
           "job_scoped", "prom_labels", "add_checkpoint_args", "add_process_args",
           "build_robustness", "build_control", "build_elastic", "elastic_distributed_init",
           "Launch", "launch_rank_world", "make_heartbeat", "make_event_stream",
           "make_flight_recorder", "flight_update", "make_preemption", "preempt_exit",
           "profile_trace", "hideable_fraction", "Telemetry", "control_tick", "add_stream_args",
           "make_stream", "stream_join_seq", "stream_rejoin_params"]


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """A ``torch.profiler`` capture (host ranges, and the card's kernels on
    CUDA) with a guaranteed stop: the Chrome trace is written to
    ``<trace_dir>/trace.json`` when the block ends, by an exception too, so
    a raise inside the profiled epoch never leaves a profiler running.
    No-op (yields None) when ``trace_dir`` is falsy; yields the profiler."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def add_telemetry_args(p) -> None:
    """The ``--events`` / ``--prom`` / ``--job_id`` / ``--events_max_mb`` /
    ``--flight_dir`` / ``--flight_capacity`` flags (the JAX surface)."""
    p.add_argument("--events", type=str, default=None,
                   help="JSONL telemetry event stream path (schema-versioned; one record per "
                        "step/epoch/guard event — the JAX tools/trace_report.py reads it)")
    p.add_argument("--prom", type=str, default=None,
                   help="Prometheus textfile path, rewritten atomically at each epoch/log "
                        "window with the latest metrics")
    p.add_argument("--job_id", type=str, default=os.environ.get("TCDP_JOB_ID") or None,
                   help="fleet job id (default: $TCDP_JOB_ID): prefixes the --events/--prom/"
                        "--heartbeat file names (obs.export.job_scoped_path) and labels the "
                        "Prometheus exposition job=\"<id>\"")
    p.add_argument("--events_max_mb", type=float, default=0.0,
                   help="rotate the --events JSONL when the live file would cross this many "
                        "MB (atomic rename to <path>.<seg>; records carry their segment "
                        "index; 0 = unbounded)")
    p.add_argument("--flight_dir", type=str, default=None,
                   help="shared dir for the per-rank flight recorder (obs/flight.py): "
                        "ring-buffered telemetry, blackbox.rank<R>.json dumps on failure "
                        "paths, live straggler/* gauges — feed the dir to "
                        "harness/postmortem.py after a crash")
    p.add_argument("--flight_capacity", type=int, default=256,
                   help="flight-recorder ring capacity per channel (memory is O(channels x "
                        "capacity))")


def add_adaptive_args(p) -> None:
    """The ``--adaptive*`` flags: the closed-loop compression controller
    (``control/``).  It decides at the harness's metric-fetch cadence (the
    epoch in the CNN harnesses, the log window in the LM); its own
    ``--adaptive_window`` counts APPLIED updates inside those fetches."""
    p.add_argument("--adaptive", action="store_true",
                   help="arm the closed-loop compression controller: retune the compression "
                        "knob (Top-K/Random-K ratio, PowerSGD rank) along a rung ladder to "
                        "fit comm under the hideable-compute budget (control/controller.py)")
    p.add_argument("--adaptive_window", type=int, default=8,
                   help="applied updates per control decision window")
    p.add_argument("--adaptive_deadband", type=float, default=0.25,
                   help="relative comm/budget deadband before a rung move")
    p.add_argument("--adaptive_rungs", type=str, default=None,
                   help="comma-separated explicit rung ladder (strictly descending knob "
                        "values; rung 0 is the static baseline).  Default: halve the "
                        "configured ratio/rank per rung, 5 rungs deep")
    p.add_argument("--adaptive_budget_ms", type=float, default=0.0,
                   help="explicit per-update hideable-comm budget in ms; 0 = derive from "
                        "measured compute x the overlap schedule's hideable byte fraction")
    p.add_argument("--adaptive_bw_mbps", type=float, default=100.0,
                   help="modeled interconnect bandwidth (Mbit/s) used to turn sent-bits into "
                        "comm ms under --adaptive_signal modeled")
    p.add_argument("--adaptive_signal", type=str, default="modeled",
                   choices=("modeled", "measured"),
                   help="'modeled' prices comm from sent-bits / --adaptive_bw_mbps (bitwise "
                        "replay-deterministic); 'measured' uses harness-observed wall times "
                        "(NOT replay-deterministic)")
    p.add_argument("--adaptive_model", type=str, default="flat", choices=("flat", "twin"),
                   help="how 'modeled' prices bits: 'flat' divides by --adaptive_bw_mbps; "
                        "'twin' prices the transport's collective schedule through the "
                        "calibrated per-fabric digital twin (twin/, fitted from "
                        "--twin_records).  Both are pure functions of billed bits "
                        "(replay-deterministic)")
    p.add_argument("--twin_records", type=str, default=".",
                   help="directory holding the BENCH_r*/MULTICHIP_r* records the twin "
                        "calibrates from (--adaptive_model twin)")


def build_control(args, comp_cfg):
    """The ``--adaptive*`` flags as a :class:`~tpu_compressed_dp_torch.control.ControlConfig`
    (or None).  Raises on a non-tunable compression method (silently
    running static under ``--adaptive`` would void the comparison the run
    was launched for)."""
    if not getattr(args, "adaptive", False):
        return None
    from tpu_compressed_dp_torch.control import ControlConfig, build_ladder
    from tpu_compressed_dp_torch.control.config import TUNABLE_METHODS
    from tpu_compressed_dp_torch.control.rungs import assert_ladder_traceable, ladder_knob
    from tpu_compressed_dp_torch.ops.compressors import canonical_name

    method = (canonical_name(comp_cfg.method)
              if comp_cfg is not None and comp_cfg.method else None)
    if method not in TUNABLE_METHODS:
        raise SystemExit(f"--adaptive requires a tunable compression method "
                         f"{TUNABLE_METHODS}, got {method!r}")
    if args.adaptive_rungs:
        cast = float if ladder_knob(method) == "ratio" else int
        rungs = tuple(cast(v) for v in args.adaptive_rungs.split(","))
    else:
        rungs = build_ladder(method, comp_cfg.ratio, comp_cfg.rank)
    cfg = ControlConfig(method=method, rungs=rungs, window=args.adaptive_window,
                        deadband=args.adaptive_deadband, signal=args.adaptive_signal,
                        model=args.adaptive_model, bandwidth_mbps=args.adaptive_bw_mbps,
                        budget_ms=args.adaptive_budget_ms)
    assert_ladder_traceable(cfg)
    return cfg


def build_twin_pricer(args, comp_cfg, *, world: int):
    """Fit the digital twin from ``--twin_records`` and wrap it as the
    Controller's bit pricer — None unless ``--adaptive_model twin``.  The
    fit runs once at harness start (a least-squares over the records,
    milliseconds of host work); every decision window then prices its
    billed bits through the frozen result, so the loop stays
    replay-deterministic."""
    if getattr(args, "adaptive_model", "flat") != "twin":
        return None
    from tpu_compressed_dp_torch.control.signals import TwinPricer
    from tpu_compressed_dp_torch.twin import calibration_rows, fit

    rows = calibration_rows(args.twin_records)
    calib = fit(rows)
    mode = getattr(comp_cfg, "mode", "simulate") if comp_cfg else "simulate"
    transport = getattr(comp_cfg, "transport", None) if comp_cfg else None
    if mode != "wire" or not transport:
        transport = "psum"   # simulate bills compressed payloads on psum
    elif transport == "allgather":
        transport = "all_gather"
    return TwinPricer(model=calib.model, world=max(int(world), 1),
                      pods=int(getattr(args, "dp_pods", 1) or 1), transport=transport,
                      calib_rows=len(rows))


def hideable_fraction(params, comp_cfg) -> float:
    """The overlap schedule's hideable byte fraction
    (``overlap.hideable_byte_fraction(plan_chunks(...))``) over fp32 leaves
    of ``params``' sizes: what scales the measured compute into the
    controller's budget when ``--adaptive_budget_ms`` does not pin it."""
    from tpu_compressed_dp_torch.parallel.overlap import hideable_byte_fraction, plan_chunks

    return hideable_byte_fraction(plan_chunks([p.numel() * 4 for p in params.values()],
                                              comp_cfg))


def control_tick(controller, state: TrainState, *, guard_cfg, mean_bits: float,
                 wall_ms: Optional[float], hide_frac: float, flight=None,
                 note: Optional[Dict] = None) -> TrainState:
    """One controller tick at a metric fetch, keyed to APPLIED updates
    (``guard.schedule_step`` of the fetched state): ``state`` with the new
    ``control``.  ``wall_ms`` (the window's per-step wall time) is the
    measured comm signal and the compute the budget derives from; ``note``
    names the window in the flight recorder's control ring."""
    from tpu_compressed_dp_torch.train.guard import schedule_step

    applied = (schedule_step(guard_cfg, state.guard, state.step) if guard_cfg is not None
               else state.step)
    new_control, _ = controller.tick(
        state.control, applied=applied,
        signals=controller.window_signals(mean_bits=mean_bits, measured_comm_ms=wall_ms,
                                          compute_ms=wall_ms, hideable_fraction=hide_frac))
    if flight is not None:
        flight.note_control({**(note or {}), "rung": int(new_control.rung),
                             "applied": applied})
    return dataclasses.replace(state, control=new_control)


def control_summary(controller, control) -> Dict[str, float]:
    """The summary line's ``rung`` and knob-value columns (empty when the
    controller is off)."""
    if controller is None or control == ():
        return {}
    m = controller.metrics(control)
    return {"rung": m["control/rung"], controller.knob: m["control/value"]}


def fabric_gauges(comm_means: Dict[str, float], world: int, pods: int, steps: int,
                  seconds: float) -> Dict[str, float]:
    """Per-fabric ``net/`` gauges from a window's mean ``comm/*`` metrics:
    DCN MB per step per worker and the Gb/s each fabric must sustain at the
    measured step rate.  Empty on a flat world (``pods <= 1``)."""
    from tpu_compressed_dp_torch.utils.meters import per_fabric_comm_bytes

    if pods <= 1:
        return {}
    fabric = per_fabric_comm_bytes(comm_means, world, pods)
    if fabric is None:
        return {}
    ici_b, dcn_b = fabric
    out = {"net/dcn_mb_per_step": dcn_b / 1e6}
    if seconds > 0 and steps > 0:
        rate = steps / seconds
        out["net/dcn_gbps_per_chip"] = dcn_b * rate * 8 / 1e9
        out["net/ici_gbps_per_chip"] = ici_b * rate * 8 / 1e9
    return out


def job_scoped(args, path):
    """Apply the ``--job_id`` namespace to one telemetry path (no-op for
    single-job runs)."""
    from tpu_compressed_dp_torch.obs.export import job_scoped_path

    return job_scoped_path(path, getattr(args, "job_id", None))


def prom_labels(args, **labels) -> Dict[str, str]:
    """The harness's Prometheus label set: the caller's labels plus
    ``job="<id>"`` under a fleet job id."""
    job = getattr(args, "job_id", None)
    if job:
        labels["job"] = job
    return labels


def make_event_stream(args, **meta):
    """``--events``: a started :class:`~tpu_compressed_dp_torch.obs.export.EventStream`
    on rank 0 (metrics are world-reduced: every rank would write the same
    records), or None.  The path and metadata are job-scoped under
    ``--job_id``."""
    if not getattr(args, "events", None) or mesh.rank() != 0:
        return None
    from tpu_compressed_dp_torch.obs.export import EventStream

    if getattr(args, "job_id", None):
        meta = dict(meta, job=args.job_id)
    max_mb = getattr(args, "events_max_mb", 0.0) or 0.0
    return EventStream(job_scoped(args, args.events), meta=dict(meta),
                       max_bytes=int(max_mb * 1e6) if max_mb > 0 else None)


def make_flight_recorder(args, **meta):
    """``--flight_dir``: a per-rank
    :class:`~tpu_compressed_dp_torch.obs.flight.FlightRecorder` (or None).
    EVERY rank gets one (per-rank evidence is the point), keyed by its rank
    when it starts (JAX's process index), writing into the job-scoped
    shared dir."""
    if not getattr(args, "flight_dir", None):
        return None
    from tpu_compressed_dp_torch.obs.flight import FlightRecorder

    directory = args.flight_dir
    if getattr(args, "job_id", None):
        directory = os.path.join(directory, args.job_id)
        meta = dict(meta, job=args.job_id)
    rank, _ = launch_rank_world(args)
    return FlightRecorder(rank=rank, capacity=getattr(args, "flight_capacity", 256),
                          directory=directory, meta=dict(meta))


class Telemetry:
    """One harness run's item-13 surface, built once and closed in the
    harness's ``finally``: the :class:`~tpu_compressed_dp_torch.obs.trace.StepTimeline`,
    the ``--events`` stream (rank 0), the ``--flight_dir`` recorder (every
    rank; armed with the chaos scenario, hooked into the crash injector and
    the checkpointer), ``--prom`` and ``--tensorboard``.  :meth:`window`
    publishes one epoch or log window everywhere at once, as the JAX
    harnesses do inline.  ``--tensorboard`` needs the ``tensorboard``
    package and raises at start without it."""

    def __init__(self, args, *, harness: str, meta: Dict, flight_meta: Dict, log_dir=None,
                 chaos=None, crash=None, ckpt=None):
        from tpu_compressed_dp_torch.obs.trace import StepTimeline
        from tpu_compressed_dp_torch.utils.loggers import TensorboardLogger

        self.args, self.harness = args, harness
        self.rank0 = mesh.rank() == 0
        self.timeline = StepTimeline()
        self.events = make_event_stream(args, harness=harness, **meta)
        self.flight = make_flight_recorder(args, harness=harness, **flight_meta)
        if self.flight is not None and chaos is not None:
            self.flight.note_chaos(chaos)
        if crash is not None:
            crash.flight = self.flight
        if ckpt is not None:
            ckpt.events, ckpt.flight = self.events, self.flight
        self.tb = TensorboardLogger(
            os.path.join(log_dir, "tb") if log_dir and getattr(args, "tensorboard", False)
            else None, is_master=self.rank0)
        self._prev_skipped = 0.0

    def observe(self, err: BaseException, step: Optional[int]) -> None:
        """An unconverted failure about to unwind the run: the dump here is
        the only evidence this rank leaves (preemption dumps in
        :func:`preempt_exit`)."""
        from tpu_compressed_dp_torch.utils.resilience import Preempted

        if self.flight is not None and not isinstance(err, Preempted):
            self.flight.observe(err, step=step)

    def drain(self, *, step=None, metrics=None):
        """Drain the timeline's spans into the flight recorder (with the
        window's ``metrics`` at ``step``, when given): ``(spans, gauges)``,
        the gauges the ``flight/*`` and ``straggler/*`` ones."""
        spans = self.timeline.drain()
        return spans, flight_update(self.flight, step=step, metrics=metrics, spans=spans)

    def window(self, kind: str, ids: Dict, *, summary: Dict, loss: float, thr: Dict,
               comm: Dict, guard: Dict, control: Dict, prom_extra: Dict, hb=None,
               hb_fields: Optional[Dict] = None, drained=None) -> Dict[str, float]:
        """Publish one window: refresh the heartbeat with the telemetry
        snapshot, emit the ``kind`` record (and a ``guard`` record when the
        skip count rose), and rewrite the Prometheus file.  ``ids`` names
        the window (``epoch``/``step``); ``drained`` is :meth:`drain`'s
        result when the caller drained first (the LM, whose flight rings
        must fill before its wedge check), else this drains.  Returns the
        flight gauges."""
        from tpu_compressed_dp_torch.obs.export import telemetry_snapshot, write_prometheus

        tl = self.timeline
        spans, fgauges = drained if drained is not None else self.drain()
        if hb is not None:
            hb.update(**(hb_fields or {}), telemetry=telemetry_snapshot(tl),
                      **({"straggler_skew_s": fgauges["straggler/skew_s"],
                          "straggler_rank": fgauges["straggler/rank"]}
                         if "straggler/skew_s" in fgauges else {}))
        if self.events is not None:
            self.events.emit(kind, **ids,
                             metrics={k: v for k, v in summary.items()
                                      if isinstance(v, (int, float))},
                             throughput=thr, comm=comm, guard=guard, control=control,
                             timeline=tl.snapshot(), step_spans=spans)
            skipped = guard.get("guard/skipped", 0.0)
            if skipped > self._prev_skipped:
                self.events.emit("guard", **ids, **guard)
            self._prev_skipped = skipped
        if self.args.prom and self.rank0:
            write_prometheus({"loss": loss, **thr, **comm, **guard, **control,
                              **tl.snapshot(), **prom_extra, **fgauges},
                             job_scoped(self.args, self.args.prom),
                             labels=prom_labels(self.args, harness=self.harness))
        return fgauges

    def close(self) -> None:
        """Close TensorBoard and the event stream (after the checkpointer's
        close: its background writer may still emit a ``ckpt_save``)."""
        self.tb.close()
        if self.events is not None:
            self.events.close()


def flight_update(flight, *, step=None, metrics=None, spans=None) -> Dict[str, float]:
    """Per-epoch/window flight upkeep: ring the drained timeline spans and
    the window's metrics, publish this rank's phase profile, and return the
    ``flight/*`` and ``straggler/*`` gauges ({} when the recorder is off)."""
    if flight is None:
        return {}
    if spans:
        flight.note_spans(spans)
    if step is not None:
        flight.note_step(step, metrics or {})
    gauges = dict(flight.metrics())
    gauges.update(flight.publish())
    return gauges


def local_device(name: str) -> torch.device:
    """The entry points' ``--device``: ``cuda`` is this process's card
    (``LOCAL_RANK`` under ``torchrun``) and raises where CUDA is missing."""
    if name == "cuda" and "LOCAL_RANK" in os.environ:
        name = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return mesh.resolve_device(name)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def pad_batch(batch: Dict[str, np.ndarray], size: int) -> Dict[str, np.ndarray]:
    """Pad a short final batch to ``size`` rows with a 0/1 mask."""
    n = len(batch["target"])
    if n == size and "mask" in batch:
        return batch
    mask = np.zeros((size,), np.float32)
    mask[:n] = 1.0
    if n == size:
        return {**batch, "mask": mask}
    pad_n = size - n
    x = np.concatenate([batch["input"],
                        np.zeros((pad_n,) + batch["input"].shape[1:], batch["input"].dtype)])
    y = np.concatenate([batch["target"], np.full((pad_n,), -1, batch["target"].dtype)])
    return {"input": x, "target": y, "mask": mask}


def add_robustness_args(p, *, check_note: str) -> None:
    """The ``--guard*`` / ``--chaos`` / ``--heartbeat*`` / ``--elastic*``
    flags (the JAX surface); ``check_note`` names the harness's wedge-check
    cadence."""
    p.add_argument("--guard", action="store_true",
                   help="arm the step guard: a cross-worker finiteness vote skips nonfinite "
                        "steps and holds params/momentum/BN/EF/comp bitwise, with dynamic loss "
                        "scaling on 16-bit dtypes (train/guard.py)")
    p.add_argument("--guard_init_scale", type=float, default=2.0 ** 15)
    p.add_argument("--guard_backoff", type=float, default=0.5)
    p.add_argument("--guard_growth_interval", type=int, default=200)
    p.add_argument("--guard_max_skips", type=int, default=25,
                   help=f"raise GuardExceeded past this many CONSECUTIVE skipped steps "
                        f"({check_note})")
    p.add_argument("--chaos", type=str, default=None,
                   help="deterministic fault injection, e.g. 'nan,target=grads,steps=3+7,"
                        "worker=1', 'crash=120', 'crash=preempt,crash_at_step=12' or "
                        "'crash=mid_collective,crash_at_step=3,worker=1' (utils/chaos.py; "
                        "in-step injection arms --guard)")
    p.add_argument("--heartbeat", type=str, default=None,
                   help="liveness JSON path (utils/resilience.Heartbeat); the payload "
                        "carries step and last_good_step")
    p.add_argument("--heartbeat_interval", type=float, default=10.0)
    p.add_argument("--elastic", action="store_true",
                   help="survive a dead worker without a whole-job restart: detect (heartbeat "
                        "gossip, collective errors, bounded fetches), agree a W-1 world "
                        "through --elastic_dir, re-initialise the process group over it and "
                        "replay the epoch; readmit relaunched workers at epoch boundaries "
                        "(train/elastic.py)")
    p.add_argument("--elastic_dir", type=str, default=None,
                   help="shared directory of the per-rank heartbeat gossip and the "
                        "rendezvous records (needed with more than one process)")
    p.add_argument("--peer_timeout", type=float, default=60.0,
                   help="seconds without a fresh peer heartbeat (or a blocked collective or "
                        "metrics fetch) before declaring the peer dead; --chaos "
                        "peer_timeout=<s> overrides")
    p.add_argument("--elastic_ef", type=str, default="drop", choices=("fold", "drop"),
                   help="the departing worker's EF residual: a dead process's EF is lost "
                        "with it, so every remesh drops it; fold is refused")
    p.add_argument("--elastic_min_world", type=int, default=2,
                   help="refuse to remesh below this many workers")


def add_process_args(p) -> None:
    """The process flags: the JAX ``--devices --coordinator --num_processes
    --process_id`` (here ``init_process_group``'s ``init_method``,
    ``world_size`` and ``rank``) and the port's ``--dist_backend``."""
    p.add_argument("--devices", type=int, default=None,
                   help="the world's workers; the port's workers are processes with one "
                        "device each, so this must equal the process group's size")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of the process group's rendezvous (rank 0 listens)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", type=str, default=None, choices=("nccl", "gloo"),
                   help="torch.distributed backend (default: NCCL on CUDA, gloo on the CPU; "
                        "gloo puts several ranks on one card)")


def add_checkpoint_args(p, *, cadence_help: str) -> None:
    """The ``--checkpoint_dir`` / ``--resume`` / ``--ckpt_every`` flags."""
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="checkpoint directory (async saves, checksummed manifests, "
                        "preemption emergency saves; utils/checkpoint.py)")
    p.add_argument("--resume", type=str, default=None,
                   help="restore the newest verifiable checkpoint from this directory "
                        "before training")
    p.add_argument("--ckpt_every", type=int, default=1, help=cadence_help)


def add_stream_args(p, *, cadence_help: str) -> None:
    """The ``--stream*`` flags: delta-compressed state streaming
    (``stream/``: incremental checkpoints, warm rejoin, model push).
    ``cadence_help`` names the harness's append cadence unit."""
    p.add_argument("--stream_dir", type=str, default=None,
                   help="delta state-stream directory (keyframe + Top-K drift segments, "
                        "manifest-checksummed; feeds warm rejoin and harness/stream_serve.py)")
    p.add_argument("--stream_every", type=int, default=1, help=cadence_help)
    p.add_argument("--stream_keyframe_every", type=int, default=8,
                   help="segments per stream window (one full keyframe, Top-K deltas, one "
                        "window-closing flush; the flush makes keyframe+deltas == params "
                        "bitwise)")
    p.add_argument("--stream_ratio", type=float, default=0.01,
                   help="Top-K density of each delta segment (fraction of model coordinates)")
    p.add_argument("--stream_rejoin", action="store_true",
                   help="on a watchdog relaunch, catch up from the delta stream instead of the "
                        "survivors' parameter broadcast (falls back to the broadcast when the "
                        "stream is absent or corrupt); requires --stream_dir on every process")


def make_stream(args, *, flight=None, events=None, log=print):
    """``--stream_dir`` as a :class:`~tpu_compressed_dp_torch.stream.writer.StreamWriter`
    on rank 0 (or None): every rank holds the replicated parameters, and two
    writers would race the segment sequence."""
    if not getattr(args, "stream_dir", None) or mesh.rank() != 0:
        return None
    from tpu_compressed_dp_torch.stream import StreamWriter

    return StreamWriter(args.stream_dir, ratio=getattr(args, "stream_ratio", 0.01),
                        keyframe_every=getattr(args, "stream_keyframe_every", 8),
                        flight=flight, events=events, log=log)


def stream_join_seq(args) -> Optional[int]:
    """The joiner's pre-admission stream probe: the segment seq it can catch
    up to, or None when warm rejoin is off or unavailable.  It goes into the
    rendezvous join record, so the survivors take the parameter-skipping
    barrier only for joiners that really can adopt from the stream (the
    probe runs a verifying catch-up, not just a head read)."""
    if not (getattr(args, "stream_rejoin", False) and getattr(args, "stream_dir", None)):
        return None
    from tpu_compressed_dp_torch.stream import StreamCorrupt, StreamReader, is_stream_dir

    if not is_stream_dir(args.stream_dir):
        return None
    try:
        reader = StreamReader(args.stream_dir)
        reader.catch_up()
    except StreamCorrupt as e:
        print(f"stream: rejoin probe failed ({e}); joining cold")
        return None
    return int(reader.applied_seq) if reader.applied_seq >= 0 else None


def stream_rejoin_params(args, state, decision=None, *, flight=None, log=print):
    """Joiner-side warm rejoin: ``(adopted parameters, info)`` for
    ``ElasticRuntime.join_world`` (the parameters already copied into
    ``state.model``), or ``(None, None)`` to take the survivors' broadcast.
    Runs after admission, so the coordinator's barrier flush is on disk and
    the reconstruction is bitwise the live parameters.  ``decision``'s
    committed ``warm`` bit is the world's agreement on the broadcast's
    layout: when it says cold the catch-up is skipped."""
    if not (getattr(args, "stream_rejoin", False) and getattr(args, "stream_dir", None)):
        return None, None
    if decision is not None and not getattr(decision, "warm", False):
        log("stream: epoch committed a cold admission — skipping the warm-rejoin catch-up")
        return None, None
    from tpu_compressed_dp_torch.stream import warm_rejoin
    from tpu_compressed_dp_torch.stream.delta import param_dict

    state, info = warm_rejoin(state, args.stream_dir, log=log, flight=flight)
    if info is None:
        return None, None
    return param_dict(state.model), info


def build_robustness(args, dtype):
    """``(guard_cfg, chaos, crash_injector)`` from the flags.  In-step chaos
    injection arms the guard; loss scaling follows ``dtype``
    (``GuardConfig.for_dtype``)."""
    from tpu_compressed_dp_torch.train.guard import GuardConfig
    from tpu_compressed_dp_torch.utils.chaos import ChaosConfig, maybe_crash_injector

    chaos = ChaosConfig.parse(args.chaos) if args.chaos else None
    want_guard = args.guard or (chaos is not None and chaos.injects_in_graph)
    if want_guard and not args.guard and mesh.rank() == 0:
        print("chaos: in-step injection requested — arming the step guard")
    guard_cfg = GuardConfig.for_dtype(
        dtype, init_scale=args.guard_init_scale, backoff=args.guard_backoff,
        growth_interval=args.guard_growth_interval,
        max_consecutive_skips=args.guard_max_skips) if want_guard else None
    return guard_cfg, chaos, maybe_crash_injector(chaos)


@dataclasses.dataclass(frozen=True)
class Launch:
    """How this process entered its world: ``rank`` its ORIGINAL launch rank
    (the gossip's and the rendezvous' key), ``base_port`` the port the
    rendezvous counts epochs up from, ``decision`` the rendezvous epoch it
    joined (a watchdog-relaunched worker) or None, ``made_group`` whether
    this call made the process group."""

    rank: int
    base_port: Optional[int]
    decision: object = None
    made_group: bool = False


def peer_timeout(args, chaos=None) -> float:
    """``--peer_timeout``, or ``--chaos peer_timeout=<s>`` where set."""
    if chaos is not None and chaos.peer_timeout > 0:
        return float(chaos.peer_timeout)
    return float(getattr(args, "peer_timeout", 60.0))


def elastic_distributed_init(args, device) -> Launch:
    """Make this process's group, replacing the bare ``init_process_group``.

    A worker relaunched by ``harness/watchdog.py --relaunch --elastic_dir``
    carries the running world's epoch in its environment
    (``TCDP_RENDEZVOUS_EPOCH``): under ``--elastic`` it parks in the
    rendezvous join barrier until the survivors commit an epoch that
    readmits it, then joins that world (the harness hands
    :attr:`Launch.decision` to ``ElasticRuntime.join_world``).  Otherwise
    ``--coordinator/--num_processes/--process_id`` (``tcp://`` init), the
    ``torchrun`` environment, or a 1-rank group.  Under ``--elastic`` the
    group's collective timeout is the peer timeout.  ``--devices`` must
    equal the world.  A blown join deadline raises: the process exits
    nonzero and the watchdog's backoff is the park-and-retry loop."""
    import torch.distributed as dist

    from tpu_compressed_dp_torch.utils.chaos import ChaosConfig

    elastic = getattr(args, "elastic", False)
    chaos = ChaosConfig.parse(args.chaos) if getattr(args, "chaos", None) else None
    timeout = peer_timeout(args, chaos) if elastic else None
    rank, _ = launch_rank_world(args)
    backend = getattr(args, "dist_backend", None)
    made = not dist.is_initialized()
    decision = None
    base_port = None
    if elastic:
        from tpu_compressed_dp_torch.train.rendezvous import maybe_rejoin_from_env

        decision = maybe_rejoin_from_env(args.elastic_dir, rank, deadline_s=4 * timeout,
                                         stream_seq=stream_join_seq(args))
    if decision is not None:
        base_port = int(decision.address.rsplit(":", 1)[1]) - int(decision.epoch)
        mesh.destroy()
        mesh.init_process_group(device, backend=backend,
                                init_method=f"tcp://{decision.address}",
                                world_size=decision.num_processes, rank=decision.process_id,
                                timeout_s=timeout)
        made = True
    else:
        init = f"tcp://{args.coordinator}" if getattr(args, "coordinator", None) else None
        mesh.init_process_group(device, backend=backend, init_method=init,
                                world_size=getattr(args, "num_processes", None),
                                rank=getattr(args, "process_id", None) if init else None,
                                timeout_s=timeout)
        base_port = mesh.port_of(init)
        rank = mesh.rank()
    devices = getattr(args, "devices", None)
    if devices is not None and int(devices) != mesh.world():
        raise ValueError(f"--devices {devices}: the port's workers are processes with one "
                         f"device each (launch them with torchrun --nproc_per_node, or "
                         f"--coordinator/--num_processes/--process_id), and this world has "
                         f"{mesh.world()}")
    return Launch(rank=rank, base_port=base_port, decision=decision, made_group=made)


def build_elastic(args, launch: Launch, *, chaos=None, crash=None, device=None, ckpt=None,
                  ckpt_layout=None, events=None, flight=None, stream=None, log=print):
    """The ``--elastic*`` flags as a started
    :class:`~tpu_compressed_dp_torch.train.elastic.ElasticRuntime` (or None
    without ``--elastic``).  ``--elastic_dir`` arms the gossip and the
    rendezvous (needed with more than one process: every remesh goes
    through a committed epoch); the chaos-conversion and bounded-fetch
    planes are always on; ``crash`` lets the runtime probe the
    ``during_remesh`` phase.  ``--elastic_ef fold`` raises: a dead
    process's EF cannot be folded.  A relaunched worker's runtime starts in the
    world it joined (``launch.decision``).  ``stream`` is rank 0's
    :func:`make_stream` writer; ``--stream_dir`` on every process arms the
    warm readmission (``stream_armed``, a value every rank shares)."""
    if not getattr(args, "elastic", False):
        return None
    from tpu_compressed_dp_torch.train.elastic import ElasticConfig, ElasticRuntime, PeerGossip
    from tpu_compressed_dp_torch.train.rendezvous import DEFAULT_BASE_PORT, Rendezvous

    world = mesh.world()
    if world > 1 and not args.elastic_dir:
        raise ValueError("--elastic over several processes needs --elastic_dir: the "
                         "survivors agree their new world through its rendezvous files")
    if args.elastic_ef != "drop":
        raise ValueError("--elastic_ef fold: a dead worker's EF residual lived only in its "
                         "process and is lost with it, so every remesh drops it (the JAX "
                         "runtime's multi-process rule); use --elastic_ef drop")
    cfg = ElasticConfig(gossip_dir=args.elastic_dir, rank=launch.rank,
                        peer_timeout_s=peer_timeout(args, chaos),
                        min_world=args.elastic_min_world)
    ranks = (tuple(launch.decision.ranks) if launch.decision is not None
             else tuple(range(world)))
    if launch.decision is None and launch.rank != mesh.rank():
        raise ValueError(f"--process_id {launch.rank} is not this process's rank "
                         f"{mesh.rank()} in its group")
    gossip = rendezvous = None
    if cfg.gossip_dir:
        gossip = PeerGossip(cfg.gossip_dir, cfg.rank, max(max(ranks) + 1, world),
                            peer_timeout_s=cfg.peer_timeout_s)
        rendezvous = Rendezvous(cfg.gossip_dir, cfg.rank,
                                base_port=launch.base_port or DEFAULT_BASE_PORT)
    return ElasticRuntime(cfg, gossip=gossip, crash=crash, rendezvous=rendezvous,
                          ranks=ranks, device=device, ckpt=ckpt, ckpt_layout=ckpt_layout,
                          events=events, flight=flight, stream=stream,
                          stream_armed=bool(getattr(args, "stream_dir", None)), log=log)


def launch_rank_world(args) -> Tuple[int, int]:
    """This process's launch rank and world from the process group, else the
    flags (``--process_id`` / ``--num_processes``), else the ``torchrun``
    environment: known before the group is made."""
    import torch.distributed as dist

    if dist.is_initialized():
        return mesh.rank(), mesh.world()
    rank = getattr(args, "process_id", None)
    world = getattr(args, "num_processes", None)
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world = int(os.environ.get("WORLD_SIZE", 1)) if world is None else int(world)
    return rank, world


def make_heartbeat(args):
    """A started :class:`~tpu_compressed_dp_torch.utils.resilience.Heartbeat`
    for ``--heartbeat`` (its payload names the rank, and the job under
    ``--job_id``, which also prefixes the file name), or None.  Each rank of
    a multi-process or ``--elastic`` run writes ``<path>.rank<r>``, ``r``
    its launch rank, which a remesh never renumbers.  The entry points start
    it before they make the process group, so a relaunched worker parked in
    the elastic join barrier reads as alive to the watchdog."""
    if not args.heartbeat:
        return None
    from tpu_compressed_dp_torch.utils.resilience import Heartbeat

    rank, world = launch_rank_world(args)
    multi = world > 1 or getattr(args, "elastic", False)
    base = job_scoped(args, args.heartbeat)
    path = f"{base}.rank{rank}" if multi else base
    payload = {"rank": rank}
    if getattr(args, "job_id", None):
        payload["job"] = args.job_id
    return Heartbeat(path, interval_s=args.heartbeat_interval, payload=payload)


def make_preemption(log=print):
    """The installed SIGTERM/SIGINT flag; pair with ``uninstall()`` in a
    finally."""
    from tpu_compressed_dp_torch.utils.resilience import PreemptionHandler

    return PreemptionHandler(log=log).install()


def preempt_exit(err, *, ckpt=None, state=None, meta=None, events=None, flight=None,
                 log=print):
    """The preemption epilogue: drain any write in flight (its failure is
    superseded), cut a synchronous emergency checkpoint, dump the flight
    recorder's blackbox, emit a ``preempt`` event, and return the
    ``SystemExit`` of :data:`~tpu_compressed_dp_torch.utils.resilience.
    PREEMPT_EXIT` for the caller to raise."""
    from tpu_compressed_dp_torch.utils.resilience import PREEMPT_EXIT

    saved = None
    if ckpt is not None and state is not None:
        try:
            ckpt.drain(raise_error=False)
            saved = ckpt.save(state, {**(meta or {}), "emergency": True})
        except Exception as save_err:
            log(f"preempt: emergency checkpoint FAILED: {save_err!r}")
    if flight is not None:
        # the last write before the process dies: the postmortem's only
        # evidence that this rank exited on a reclaim, not a crash
        flight.observe(err, step=getattr(err, "step", None), saved_step=saved)
    if events is not None:
        try:
            events.emit("preempt", step=getattr(err, "step", None),
                        signum=getattr(err, "signum", None), saved_step=saved)
        except Exception:
            pass
    log("preempt: "
        + (f"emergency checkpoint committed at step {saved}" if saved is not None
           else "no checkpoint directory — progress since the last save is lost")
        + f"; exiting {PREEMPT_EXIT} for immediate relaunch")
    return SystemExit(PREEMPT_EXIT)


def guard_summary(acc: MetricAccumulator) -> Dict[str, float]:
    """The epoch's guard columns: 'skipped' (the cumulative count at the
    epoch's end) and 'loss scale'.  Empty when the guard is off."""
    if "guard/nonfinite" not in acc.sums:
        return {}
    return {"skipped": acc.last.get("guard/skipped", 0.0),
            "loss scale": acc.last.get("guard/loss_scale", 1.0)}


def run_train_epoch(train_step, state: TrainState, batches: Iterable[Dict], device, *,
                    crash=None, step_offset: int = 0, guard_cfg=None, preempt=None,
                    elastic=None, timeline=None, flight=None
                    ) -> Tuple[TrainState, MetricAccumulator]:
    """One epoch's steps.  ``crash`` (``utils/chaos.CrashInjector``) and
    ``preempt`` (``utils/resilience.PreemptionHandler``) are checked before
    each dispatch at the attempted step ``step_offset + i``, and ``crash``
    again right after it (phase ``mid_collective``); ``elastic``
    (``train/elastic.ElasticRuntime``) polls the gossip before each
    dispatch and bounds the epoch-end metrics fetch by the peer timeout;
    ``guard_cfg`` runs the wedge check on the epoch's last metrics;
    ``timeline`` (``obs/trace.StepTimeline``) times each step's data wait
    and dispatch on the host; ``flight`` (``obs/flight.FlightRecorder``)
    rings each step's fetched metrics before the wedge check and dumps its
    blackbox if the check raises."""
    step_metrics = []
    if timeline is not None:
        # what happened since the previous epoch's last dispatch (eval,
        # checkpoint saves) is not step 0's data wait
        timeline.resume()
    try:
        for i, batch in enumerate(batches):
            if timeline is not None:
                timeline.batch_ready()
            if crash is not None:
                crash.check(step_offset + i)
            if preempt is not None:
                preempt.check(step_offset + i)
            if elastic is not None:
                elastic.poll(step_offset + i)
            state, metrics = train_step(state, to_device(batch, device))
            if crash is not None:
                crash.check(step_offset + i, phase="mid_collective")
            if timeline is not None:
                timeline.step_dispatched()
            step_metrics.append(metrics)
    except Exception as err:
        # the steps so far replaced the caller's state: ride the live one out
        # for the emergency save and the elastic remesh
        err.train_state = state
        raise
    acc = MetricAccumulator()
    if step_metrics:
        keys = [k for k, v in step_metrics[0].items() if isinstance(v, torch.Tensor)]

        def fetch():
            return torch.stack([torch.stack([m[k] for k in keys])
                                for m in step_metrics]).cpu().numpy()

        try:
            fetched = (fetch() if elastic is None else
                       elastic.bounded_get(fetch, step=step_offset + len(step_metrics)))
        except Exception as err:
            err.train_state = state
            raise
        for j, (row, m) in enumerate(zip(fetched, step_metrics)):
            host = dict(zip(keys, row.tolist()))
            host.update({k: v for k, v in m.items() if not isinstance(v, torch.Tensor)})
            acc.update(host)
            if flight is not None:
                # ringed BEFORE the wedge check: the streak history that
                # trips it is already in the blackbox
                flight.note_step(step_offset + j, host)
    if guard_cfg is not None and step_metrics:
        from tpu_compressed_dp_torch.train.guard import check_guard_metrics

        try:
            check_guard_metrics(acc.last, guard_cfg, flight=flight)
        except Exception as err:
            err.train_state = state
            raise
    return state, acc


def _shard(batch: Dict[str, np.ndarray], rank: int, world: int) -> Dict[str, np.ndarray]:
    per = len(batch["target"]) // world
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def run_eval(eval_step, state: TrainState, batches: Iterable[Dict], batch_size: int,
             device, rank: int = 0, world: int = 1) -> Dict[str, float]:
    """Every batch is padded to ``batch_size`` rows; each rank evaluates its
    ``batch_size / world`` share and the eval step sums over the world."""
    return _eval_sums(eval_step, state, (_shard(pad_batch(b, batch_size), rank, world)
                                         for b in batches), device)


def run_local_eval(eval_step, state: TrainState, batches: Iterable[Dict], batch_size: int,
                   device) -> Dict[str, float]:
    """Each process evaluates its own batches, each padded (an empty one
    wholly) to ``batch_size`` rows with a 0/1 mask; every process must run
    the same number of batches (``ValLoader``'s contract), since the eval
    step sums over the world.  Loss and accuracies (top-1 ``acc``, top-5
    ``acc5``) are over the real examples."""
    return _eval_sums(eval_step, state, (pad_batch(b, batch_size) for b in batches), device)


def _eval_sums(eval_step, state: TrainState, batches: Iterable[Dict], device
               ) -> Dict[str, float]:
    sums = torch.zeros(4, dtype=torch.float64)
    keys = ("loss_sum", "correct", "correct5", "count")
    outs = [eval_step(state, to_device(b, device)) for b in batches]
    if outs:
        sums = torch.stack([torch.stack([o[k] for k in keys]) for o in outs]).cpu().double()
        sums = sums.sum(0)
    loss_sum, correct, correct5, count = sums.tolist()
    n = max(count, 1.0)
    return {"loss": loss_sum / n, "acc": correct / n, "acc5": correct5 / n, "count": count}


def comm_summary(acc: MetricAccumulator) -> Dict[str, float]:
    """'sent frac' = elements that travel; 'wire frac' = bits that travel
    vs a dense fp32 all-reduce."""
    if "comm/sent_elems" not in acc.sums:
        return {}
    dense = max(acc.mean("comm/dense_elems"), 1.0)
    return {
        "sent frac": acc.mean("comm/sent_elems") / dense,
        "wire frac": acc.mean("comm/sent_bits") / (32.0 * dense),
    }


def train_epoch(train_step, eval_step, state: TrainState, train_batches, test_batches,
                timer: Timer, batch_size: int, device, rank: int = 0, world: int = 1, *,
                crash=None, step_offset: int = 0, guard_cfg=None, preempt=None, elastic=None,
                timeline=None, flight=None
                ) -> Tuple[TrainState, Dict[str, float], MetricAccumulator]:
    """One train + eval pass with the reference's epoch-summary shape
    (`core.py:324-331`); ``crash`` / ``step_offset`` / ``guard_cfg`` /
    ``preempt`` / ``elastic`` / ``timeline`` / ``flight`` pass through to
    :func:`run_train_epoch`.  A failure in the eval carries the trained
    state as ``err.train_state``."""
    state, train_acc = run_train_epoch(train_step, state, train_batches, device, crash=crash,
                                       step_offset=step_offset, guard_cfg=guard_cfg,
                                       preempt=preempt, elastic=elastic, timeline=timeline,
                                       flight=flight)
    train_time = timer()
    try:
        test_stats = run_eval(eval_step, state, test_batches, batch_size, device, rank, world)
    except Exception as err:
        err.train_state = state
        raise
    test_time = timer(False)  # eval time stays out of the DAWNBench total
    summary = {
        "train time": train_time,
        "train loss": train_acc.mean("loss"),
        "train acc": train_acc.mean("correct"),
        "test time": test_time,
        "test loss": test_stats["loss"],
        "test acc": test_stats["acc"],
        "total time": timer.total_time,
    }
    summary.update(comm_summary(train_acc))
    summary.update(guard_summary(train_acc))
    return state, summary, train_acc
