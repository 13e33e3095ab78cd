"""Per-rank flight recorder: bounded rings + atomic blackbox bundles.

When one of the stack's five failure planes fires (guard, elastic,
preemption, checkpoint corruption, fleet eviction) the evidence of *why*
— which rank saw the NaN first, whose heartbeat went stale, what the
controller decided two windows ago — normally evaporates with the
process.  The :class:`FlightRecorder` keeps the last N records of every
stream already flowing through the system in O(capacity) ring buffers
(one per :data:`CHANNELS` entry, ``deque(maxlen=...)`` like
:class:`~tpu_compressed_dp_torch.obs.trace.StepTimeline`), and every failure
path dumps them as one atomic, schema-versioned
``blackbox.rank<R>.json`` bundle into the shared dir before dying.
``harness/postmortem.py`` merges the per-rank bundles offline into a
cross-rank timeline and names the root cause.  PyTorch-port counterpart of
:mod:`tpu_compressed_dp.obs.flight`: the same bundle and profile files, so
either package's postmortem reads the other's.

Straggler detection also runs *live*: :meth:`FlightRecorder.publish`
writes this rank's per-phase host-timing profile
(``flight.rank<R>.phases.json``, atomic) next to its peers', reads them
all back and returns the ``straggler/*`` gauges — cross-rank skew of the
mean host step time — which the harnesses feed to heartbeat and
Prometheus so ``watchdog --check --max_straggler_skew`` and the fleet
scheduler can act on a slow rank *before* it wedges a collective.

House rules: the recorder is wall-clock-free — timestamps come from an
injectable ``clock`` (monotonic by default) so replay-deterministic
callers stay deterministic; all ring and counter mutation is lock-guarded
because the async checkpointer's background writer tees ``ckpt_save``
records in from its own thread; and both the bundle dump and the phase
profile commit via ``<path>.<pid>.tmp`` + ``os.replace`` so a
concurrently-reading postmortem or scraper never sees a torn file.  Recording is
observation-only: no device collectives, no effect on the training
trajectory.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "FLIGHT_SCHEMA", "CHANNELS", "FlightRecorder", "classify_failure",
    "bundle_path", "read_bundles", "validate_bundle", "describe_error",
    "profile_path", "profile_from_spans", "write_phase_profile",
    "read_phase_profiles", "straggler_gauges",
]

#: Bump when a bundle field's meaning changes incompatibly; consumers
#: (harness/postmortem.py, the forensics drill) check it before interpreting.
FLIGHT_SCHEMA = 1

#: One bounded ring per channel:
#:   step     per-step scalar metrics (epoch-end fetched, host floats)
#:   guard    guard counters split out of the step metrics (skip streaks)
#:   control  adaptive-compression ``control_decision`` payloads
#:   elastic  gossip / remesh / readmit transitions
#:   ckpt     checkpoint lifecycle (save / rollback / prune)
#:   chaos    armed fault-injection specs (what WAS configured to misfire)
#:   timing   per-phase host spans drained from the StepTimeline
#:   fault    observed exceptions (the dump trigger trail)
#:   stream   delta-stream lifecycle (keyframe / flush / warm rejoin)
CHANNELS = ("step", "guard", "control", "elastic", "ckpt", "chaos",
            "timing", "fault", "stream")

#: exception class name (anywhere in the MRO) -> bundle ``reason``;
#: matched by NAME so this module imports none of the failure planes
#: (guard/elastic/resilience/checkpoint all import freely from obs).
_FAILURE_KINDS = (
    ("GuardExceeded", "guard_exceeded"),
    ("PeerFailed", "peer_failed"),
    ("Preempted", "preempt"),
    ("CheckpointCorrupt", "ckpt_corrupt"),
    ("ChaosCrash", "chaos_crash"),
)

#: attributes lifted verbatim off an exception into the bundle's error
#: record when present — the union of what the five failure planes carry.
_ERROR_ATTRS = ("step", "worker", "failed", "signum", "mode", "reason",
                "phase")

_BUNDLE_RE = re.compile(r"^blackbox\.rank(\d+)\.json$")
_PROFILE_RE = re.compile(r"^flight\.rank(\d+)\.phases\.json$")


def classify_failure(exc: BaseException) -> str:
    """Map an exception to a bundle ``reason`` by MRO class name (see
    :data:`_FAILURE_KINDS`); anything unrecognised is ``"error"``."""
    names = {c.__name__ for c in type(exc).__mro__}
    for cls_name, reason in _FAILURE_KINDS:
        if cls_name in names:
            return reason
    return "error"


def describe_error(exc: BaseException) -> Dict[str, Any]:
    """JSON-safe error record: type, truncated message, and whichever of
    the failure planes' well-known attributes the exception carries."""
    rec: Dict[str, Any] = {
        "type": type(exc).__name__,
        "message": str(exc)[:500],
    }
    for attr in _ERROR_ATTRS:
        val = getattr(exc, attr, None)
        if val is None:
            continue
        if isinstance(val, tuple):
            val = list(val)
        if isinstance(val, (int, float, str, bool, list)):
            rec[attr] = val
    return rec


def _jsonable(val: Any) -> Any:
    """Coerce a record field to something json.dumps accepts (device
    scalars arrive via ``float()``-able duck types; everything else is
    stringified rather than dropped — forensics wants lossy over silent)."""
    if val is None or isinstance(val, (bool, int, float, str)):
        return val
    if isinstance(val, (list, tuple)):
        return [_jsonable(v) for v in val]
    if isinstance(val, dict):
        return {str(k): _jsonable(v) for k, v in val.items()}
    try:
        return float(val)
    except (TypeError, ValueError):
        return str(val)[:200]


def bundle_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"blackbox.rank{int(rank)}.json")


def profile_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"flight.rank{int(rank)}.phases.json")


class FlightRecorder:
    """Bounded multi-channel ring recorder for one rank.

    ``capacity`` bounds EVERY channel ring, so memory is O(channels x
    capacity) regardless of run length.  ``clock`` is the injection seam
    (monotonic by default — bundle timestamps are relative, merge order
    across ranks comes from per-record ``seq`` plus the trigger step).
    ``directory=None`` disables dumping (records still accumulate, and
    :meth:`metrics` still exports) so tests and dry runs need no shared
    dir.
    """

    def __init__(self, rank: int = 0, capacity: int = 256,
                 directory: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 meta: Optional[Dict[str, Any]] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.rank = int(rank)
        self.capacity = int(capacity)
        self.directory = directory
        self.meta = dict(meta or {})
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._rings: Dict[str, collections.deque] = {
            ch: collections.deque(maxlen=capacity) for ch in CHANNELS}
        self._seq = 0
        self._records = 0
        self._dumps = 0
        self._last_dump_step = -1

    # ------------------------------------------------------------ recording

    def record(self, channel: str, kind: str, **fields: Any) -> None:
        """Append one record to ``channel``'s ring.  Unknown channels
        raise — a typo here would silently lose forensic evidence."""
        if channel not in self._rings:
            raise ValueError(f"unknown flight channel {channel!r}; "
                             f"expected one of {CHANNELS}")
        rec = {"kind": kind, "t": self._clock() - self._t0}
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            self._records += 1
            self._rings[channel].append(rec)

    def note_step(self, step: int, metrics: Optional[Dict[str, Any]] = None
                  ) -> None:
        """One fetched per-step metrics dict; guard counters split into
        the ``guard`` ring so the postmortem NaN-origin scan stays O(N)."""
        metrics = metrics or {}
        guard = {k: metrics[k] for k in metrics if k.startswith("guard/")}
        rest = {k: metrics[k] for k in metrics if not k.startswith("guard/")}
        self.record("step", "metrics", step=int(step), metrics=rest)
        if guard:
            self.record("guard", "counters", step=int(step), metrics=guard)

    def note_spans(self, spans: List[Dict[str, float]]) -> None:
        """Per-step host spans drained from the StepTimeline (data /
        dispatch / total splits) — the straggler evidence."""
        for span in spans:
            self.record("timing", "span",
                        **{k: span[k] for k in span if k != "t0"})

    def note_chaos(self, cfg: Any) -> None:
        """The armed fault-injection scenario (a ChaosConfig, its spec
        string, or None).  Recording what was CONFIGURED to misfire is
        what lets postmortem name the injected worker exactly."""
        if cfg is None:
            return
        if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
            fields = {k: v for k, v in dataclasses.asdict(cfg).items()
                      if v is not None}
            # the fault kind ('nan'/'inf') becomes the record kind — the
            # postmortem NaN-origin scan matches on it directly
            self.record("chaos", str(fields.pop("kind", "armed")), **fields)
        else:
            self.record("chaos", "armed", spec=str(cfg))

    def note_control(self, decision: Dict[str, Any]) -> None:
        self.record("control", "decision", **decision)

    # ------------------------------------------------------------- dumping

    def observe(self, exc: BaseException, step: Optional[int] = None,
                **extra: Any) -> Optional[str]:
        """Record a failure-plane exception into the ``fault`` ring and
        dump the blackbox bundle.  Returns the bundle path (None when no
        directory is configured).  Never raises: forensics must not mask
        the failure it is documenting."""
        reason = classify_failure(exc)
        err = describe_error(exc)
        if step is None:
            step = err.get("step")
        try:
            self.record("fault", reason, step=step, error=err, **extra)
        except Exception:
            pass
        return self.dump(reason, error=err, step=step, extra=extra or None)

    def dump(self, reason: str, *, error: Optional[Dict[str, Any]] = None,
             step: Optional[int] = None,
             extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Atomically write ``blackbox.rank<R>.json`` (tmp + os.replace).
        Best-effort by design: returns None on any I/O error — the
        process is usually dying and the original exception must win."""
        if not self.directory:
            return None
        with self._lock:
            body = {
                "v": FLIGHT_SCHEMA,
                "kind": "blackbox",
                "rank": self.rank,
                "reason": reason,
                "step": None if step is None else int(step),
                "seq": self._seq,
                "capacity": self.capacity,
                "meta": _jsonable(self.meta),
                "error": error,
                "extra": _jsonable(extra) if extra else None,
                "counts": {"records": self._records,
                           "dumps": self._dumps + 1},
                "rings": {ch: list(ring)
                          for ch, ring in self._rings.items()},
            }
            self._dumps += 1
            if step is not None:
                self._last_dump_step = int(step)
        path = bundle_path(self.directory, self.rank)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            os.makedirs(self.directory, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(body, f)
            os.replace(tmp, path)
        except OSError:
            return None
        return path

    # ------------------------------------------------------------ exports

    def snapshot(self) -> Dict[str, Any]:
        """A consistent copy of every ring plus the counters (test /
        debug surface; the dump is this plus the trigger context)."""
        with self._lock:
            return {
                "rank": self.rank,
                "seq": self._seq,
                "records": self._records,
                "dumps": self._dumps,
                "rings": {ch: list(ring)
                          for ch, ring in self._rings.items()},
            }

    def metrics(self) -> Dict[str, float]:
        """Registry-declared gauges for heartbeat / Prometheus."""
        with self._lock:
            return {
                "flight/records": float(self._records),
                "flight/dumps": float(self._dumps),
                "flight/last_dump_step": float(self._last_dump_step),
            }

    # --------------------------------------------------------- stragglers

    def phase_profile(self) -> Dict[str, Any]:
        """This rank's per-phase host-timing totals over the ``timing``
        ring window — the unit the cross-rank skew is computed from."""
        with self._lock:
            spans = list(self._rings["timing"])
        return profile_from_spans(self.rank, spans)

    def publish(self) -> Dict[str, float]:
        """Write this rank's phase profile into the shared dir, read every
        peer's, and return the live ``straggler/*`` gauges.  With no
        directory (or alone in it) the gauges degrade to zero skew."""
        if not self.directory:
            return straggler_gauges({self.rank: self.phase_profile()})
        write_phase_profile(self.directory, self.rank, self.phase_profile())
        return straggler_gauges(read_phase_profiles(self.directory))


# ------------------------------------------------------------------ bundles

def read_bundles(directory: str) -> Dict[int, Dict[str, Any]]:
    """All parseable ``blackbox.rank<R>.json`` bundles in ``directory``,
    keyed by rank.  Unreadable/corrupt files are skipped (a half-written
    bundle from a rank that died mid-replace is expected, not fatal)."""
    out: Dict[int, Dict[str, Any]] = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        m = _BUNDLE_RE.match(name)
        if not m:
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                out[int(m.group(1))] = json.load(f)
        except (OSError, ValueError):
            continue
    return out


def validate_bundle(rec: Dict[str, Any]) -> List[str]:
    """Schema check for one bundle; returns problem strings (empty =
    valid).  The forensics drill runs every dumped bundle through this."""
    problems: List[str] = []
    if rec.get("v") != FLIGHT_SCHEMA:
        problems.append(f"schema version {rec.get('v')!r} != {FLIGHT_SCHEMA}")
    if rec.get("kind") != "blackbox":
        problems.append(f"kind {rec.get('kind')!r} != 'blackbox'")
    if not isinstance(rec.get("rank"), int) or rec["rank"] < 0:
        problems.append(f"bad rank {rec.get('rank')!r}")
    if not isinstance(rec.get("reason"), str) or not rec.get("reason"):
        problems.append("missing reason")
    rings = rec.get("rings")
    if not isinstance(rings, dict):
        problems.append("missing rings")
        return problems
    for ch, ring in rings.items():
        if ch not in CHANNELS:
            problems.append(f"unknown channel {ch!r}")
            continue
        if not isinstance(ring, list):
            problems.append(f"channel {ch!r} is not a list")
            continue
        cap = rec.get("capacity")
        if isinstance(cap, int) and len(ring) > cap:
            problems.append(f"channel {ch!r} overflows capacity {cap}")
        for i, r in enumerate(ring):
            if not isinstance(r, dict) or "kind" not in r or "seq" not in r:
                problems.append(f"channel {ch!r} record {i} malformed")
                break
    return problems


# ----------------------------------------------------------- phase profiles

def profile_from_spans(rank: int, spans: List[Dict[str, Any]]
                       ) -> Dict[str, Any]:
    """Aggregate per-step span records (live ``timing``-ring entries or a
    dumped bundle's ring) into one rank's phase profile — every numeric
    field summed, ``steps`` counted.  Shared with ``harness/postmortem.py``
    so the live gauges and the offline verdict use one definition."""
    phases: Dict[str, float] = {}
    for rec in spans:
        for k, v in rec.items():
            if k in ("kind", "t", "seq") or not isinstance(
                    v, (int, float)) or isinstance(v, bool):
                continue
            phases[k] = phases.get(k, 0.0) + float(v)
    return {"v": FLIGHT_SCHEMA, "rank": int(rank),
            "steps": len(spans), "phases": phases}


def write_phase_profile(directory: str, rank: int,
                        profile: Dict[str, Any]) -> str:
    """Atomic (tmp + replace) per-rank profile write; peers and the
    postmortem read these concurrently."""
    os.makedirs(directory, exist_ok=True)
    path = profile_path(directory, rank)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(profile, f)
    os.replace(tmp, path)
    return path


def read_phase_profiles(directory: str) -> Dict[int, Dict[str, Any]]:
    out: Dict[int, Dict[str, Any]] = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        m = _PROFILE_RE.match(name)
        if not m:
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                out[int(m.group(1))] = json.load(f)
        except (OSError, ValueError):
            continue
    return out


def _mean_step_total(profile: Dict[str, Any]) -> Optional[float]:
    steps = profile.get("steps") or 0
    phases = profile.get("phases") or {}
    total = phases.get("total")
    if not steps or not isinstance(total, (int, float)):
        return None
    return float(total) / float(steps)


def straggler_gauges(profiles: Dict[int, Dict[str, Any]]
                     ) -> Dict[str, float]:
    """Cross-rank skew of the mean host step time.

    ``straggler/skew_s``  max - min mean step seconds across ranks
    ``straggler/rank``    the slowest rank (-1 when < 2 ranks report)
    ``straggler/frac``    skew relative to the fastest rank's mean

    Single-rank (or empty) input degrades to zero skew / rank -1, so the
    gauges are always exportable.
    """
    means = {r: m for r, m in
             ((r, _mean_step_total(p)) for r, p in profiles.items())
             if m is not None}
    if len(means) < 2:
        return {"straggler/skew_s": 0.0, "straggler/rank": -1.0,
                "straggler/frac": 0.0}
    slow = max(means, key=lambda r: means[r])
    fast = min(means, key=lambda r: means[r])
    skew = means[slow] - means[fast]
    frac = skew / means[fast] if means[fast] > 0 else 0.0
    return {"straggler/skew_s": skew, "straggler/rank": float(slow),
            "straggler/frac": frac}
