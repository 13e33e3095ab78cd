"""Exportable telemetry: JSONL event stream + Prometheus textfile.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.obs.export`, with its
schema version, record layout and file formats, so the JAX readers
(``read_events``, ``tools/trace_report.py``) read the port's files as
they are.

  * :class:`EventStream` — one JSON record per run/step/epoch/guard event,
    schema-versioned (``v``), append-only, flushed per record so a watchdog
    or ``tail -f`` sees events as they happen.
  * :func:`write_prometheus` — node-exporter-textfile-style exposition of
    the latest metric values, with ``# TYPE`` / ``# HELP`` lines sourced
    from the metric registry (:mod:`tpu_compressed_dp_torch.obs.registry`).
    Atomic replace, so a scraper never reads a partial file.
  * :func:`telemetry_snapshot` — the compact health payload the heartbeat
    carries (step rate, p95 latency, ``last_good_step``), consumed by
    ``harness/watchdog.py --check``.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

from tpu_compressed_dp_torch.obs import registry

__all__ = ["SCHEMA_VERSION", "EventStream", "read_events", "read_all_events",
           "list_segments", "write_prometheus", "telemetry_snapshot",
           "job_scoped_path"]

#: Bump when a record's field meaning changes incompatibly; consumers
#: (trace_report, watchdog, tests) check it before interpreting fields.
SCHEMA_VERSION = 1


class EventStream:
    """Append-only JSONL event writer.

    Every record carries ``v`` (schema version), ``kind`` and ``ts``
    (host epoch seconds); the constructor writes a ``run_start`` record
    with the caller's metadata, ``close()`` a ``run_end``.  Values must be
    JSON-serialisable — pass plain floats, not device arrays.

    Thread-safe: the async checkpointer's background writer emits
    ``ckpt_save`` records concurrently with the step loop's own events, so
    write+flush is serialised under a lock and records stay whole-line.  An
    ``emit`` racing (or after) ``close`` is dropped silently — a late
    background commit must not crash the run epilogue.

    ``max_bytes`` bounds the LIVE file: when appending the next record
    would cross it, the file rotates to ``<path>.<seg:04d>`` via an atomic
    ``os.replace`` (a tailing reader sees either the old whole file or the
    fresh one, never a truncation) and the stream reopens empty.  Every
    record carries its segment index as ``seg``, so consumers can stitch
    rotated segments back into one ordered stream
    (:func:`read_all_events`); on resume, numbering continues after the
    segments already on disk.  ``max_bytes=None`` (the default) keeps the
    historic unbounded single-file behaviour.
    """

    def __init__(self, path: str, meta: Optional[Dict[str, Any]] = None,
                 *, max_bytes: Optional[int] = None):
        self.path = path
        self.max_bytes = max_bytes
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._seg = len(list_segments(path))
        self._f = open(path, "a")
        self._closed = False
        self.emit("run_start", **(meta or {}))

    def _rotate_locked(self) -> None:
        # caller holds self._lock
        self._f.close()
        os.replace(self.path, f"{self.path}.{self._seg:04d}")
        self._seg += 1
        self._f = open(self.path, "a")

    def emit(self, kind: str, **fields: Any) -> None:
        rec = {"v": SCHEMA_VERSION, "kind": kind, "ts": time.time(), **fields}
        with self._lock:
            if self._closed:
                return
            rec["seg"] = self._seg
            line = json.dumps(rec) + "\n"
            if (self.max_bytes is not None and self._f.tell() > 0
                    and self._f.tell() + len(line) > self.max_bytes):
                self._rotate_locked()
                rec["seg"] = self._seg
                line = json.dumps(rec) + "\n"
            self._f.write(line)
            self._f.flush()

    def close(self) -> None:
        if self._closed:
            return
        self.emit("run_end")
        with self._lock:
            self._closed = True
            self._f.close()

    def __enter__(self) -> "EventStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def job_scoped_path(path: Optional[str], job_id: Optional[str]) -> Optional[str]:
    """Namespace a telemetry file path per job: ``dir/file`` becomes
    ``dir/<job_id>.file``.

    Two jobs sharing one device pool typically also share one textfile
    collector / heartbeat directory; without a per-job prefix the second
    job's atomic ``os.replace`` silently clobbers the first's export.  The
    prefix keeps the atomic-replace semantics (same directory, same
    filesystem) and leaves the file's registry HELP/TYPE content
    untouched — only the NAME is scoped; the job identity inside the
    exposition rides a ``job="<id>"`` label instead.  No-op when either
    argument is falsy, so single-job runs keep their exact paths."""
    if not path or not job_id:
        return path
    d, base = os.path.split(path)
    return os.path.join(d, f"{job_id}.{base}")


def read_events(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL event stream (strict: a malformed line raises — a
    partial tail line is a bug, the writer flushes whole records)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def list_segments(path: str) -> List[str]:
    """Rotated segment files for a stream (``<path>.0000``, ...),
    ascending by segment index."""
    d, base = os.path.split(path)
    seg_re = re.compile(re.escape(base) + r"\.(\d{4})$")
    try:
        names = os.listdir(d or ".")
    except OSError:
        return []
    found = []
    for name in names:
        m = seg_re.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(d, name)))
    return [p for _, p in sorted(found)]


def read_all_events(path: str) -> List[Dict[str, Any]]:
    """Events across every rotated segment plus the live file, stitched in
    segment order — the reader-side pair of ``EventStream(max_bytes=...)``."""
    out: List[Dict[str, Any]] = []
    for p in list_segments(path) + [path]:
        if os.path.exists(p):
            out.extend(read_events(p))
    return out


def write_prometheus(metrics: Dict[str, float], path: str,
                     labels: Optional[Dict[str, str]] = None) -> str:
    """Write ``metrics`` in Prometheus text exposition format to ``path``.

    Keys may be registry-canonical (``comm/sent_bits``) or ad-hoc; declared
    metrics get a ``# HELP`` line from their spec.  Everything is exposed
    as ``gauge``: the harnesses write per-step/per-window aggregates
    (epoch means, the latest window's value), not process-lifetime running
    totals — exposing those as Prometheus counters would make ``rate()``
    treat every dip as a counter reset.  (The registry's ``counter`` kind
    describes the metric's additive nature across workers/steps, not its
    exposition form here.)  Non-numeric values are skipped.  Atomic
    tmp+replace so scrapers never see a torn file."""
    label_str = ""
    if labels:
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        label_str = "{" + inner + "}"
    lines = []
    for key in sorted(metrics):
        val = metrics[key]
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            continue
        pname = registry.prometheus_name(key)
        if registry.is_declared(key):
            ms = registry.spec(key)
            if ms.help:
                lines.append(f"# HELP {pname} {ms.help}")
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname}{label_str} {float(val):g}")
    body = "\n".join(lines) + "\n"
    tmp = path + ".tmp"
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(tmp, "w") as f:
        f.write(body)
    os.replace(tmp, path)
    return body


def telemetry_snapshot(timeline=None, *, step: Optional[int] = None,
                       last_good_step: Optional[int] = None
                       ) -> Dict[str, float]:
    """The heartbeat's health payload: step rate + p95 latency from the
    :class:`~tpu_compressed_dp_torch.obs.trace.StepTimeline` window, plus the
    progress watermarks the watchdog's wedge check reads."""
    out: Dict[str, float] = {}
    if step is not None:
        out["step"] = int(step)
    if last_good_step is not None:
        out["last_good_step"] = int(last_good_step)
    if timeline is not None:
        snap = timeline.snapshot()
        out["steps_per_sec"] = snap["time/steps_per_sec"]
        out["step_p95_ms"] = snap["time/step_p95_ms"]
        out["data_wait_frac"] = snap["time/data_wait_frac"]
    return out
