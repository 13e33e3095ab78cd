"""Failure detection and crash recovery.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.utils.resilience` (a
copy of its host-side Python; the port imports nothing of the JAX package):

  * :class:`Heartbeat` writes ``{ts, step, incarnation, payload}`` to a JSON
    file from a background thread; :func:`read_heartbeat`,
    :func:`is_stale` and :func:`check_heartbeat` read it back for a
    watchdog (dead, wedged, stalled, slow-tail, checkpoint-stale,
    stream-stale and straggler checks);
  * :func:`run_with_recovery` runs an epoch loop and, on an exception,
    restores the newest checkpoint and replays from it, up to
    ``max_retries`` failures in a row;
  * :class:`PreemptionHandler` turns SIGTERM/SIGINT into :class:`Preempted`
    at the next step boundary, which the harnesses answer with an emergency
    checkpoint and exit code :data:`PREEMPT_EXIT`;
  * :func:`spawn_supervised` launches one supervised child with the
    incarnation environment (``TCDP_RESTART_COUNT``) and, given the elastic
    run's directory, the rejoin hint (``TCDP_ELASTIC_DIR``, and the
    committed world epoch and address where the directory holds one:
    ``train/rendezvous.py``).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

__all__ = ["Heartbeat", "read_heartbeat", "is_stale", "check_heartbeat",
           "run_with_recovery", "Preempted", "PreemptionHandler",
           "PREEMPT_EXIT", "spawn_supervised"]

#: exit code of a preempted-and-checkpointed harness (EX_TEMPFAIL), apart
#: from a clean exit (0) and a crash (1), so a supervisor relaunches at once
PREEMPT_EXIT = 75


class Preempted(Exception):
    """The preemption flag was seen at a step boundary.  ``run_with_recovery``
    re-raises it: a preemption takes the emergency-save path, never a
    restore-and-replay retry."""

    def __init__(self, msg: str, *, step: Optional[int] = None,
                 signum: Optional[int] = None):
        super().__init__(msg)
        self.step = step
        self.signum = signum


class PreemptionHandler:
    """Signal flag between the platform's preemption notice and the step loop.

    >>> handler = PreemptionHandler().install()
    >>> handler.check(step)     # raises Preempted once SIGTERM/SIGINT landed
    >>> handler.uninstall()     # always, in a finally

    The signal handler only sets an event; the loop raises at the next step
    boundary, so the state it leaves is a consistent between-steps state.
    Off the main thread ``install`` leaves the process's handlers alone
    (``installed`` False, ``check`` never raises).
    """

    def __init__(self, *, signals=(signal.SIGTERM, signal.SIGINT),
                 log: Callable[[str], None] = print):
        self.signals = tuple(signals)
        self.log = log
        self.installed = False
        self._event = threading.Event()
        self.signum: Optional[int] = None
        self._prev: Dict[int, Any] = {}

    def install(self) -> "PreemptionHandler":
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._on_signal)
            self.installed = True
        except ValueError:
            # not on the main thread: leave the process default in place
            self._prev.clear()
            self.installed = False
        return self

    def _on_signal(self, signum, frame) -> None:
        self.signum = signum
        self._event.set()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def check(self, step: Optional[int] = None) -> None:
        """Raise :class:`Preempted` if the flag is set (call once a step)."""
        if self._event.is_set():
            try:
                name = signal.Signals(self.signum).name
            except (ValueError, TypeError):
                name = str(self.signum)
            self.log(f"preempt: {name} received; stopping at step {step}")
            raise Preempted(f"preempted by {name}", step=step, signum=self.signum)

    def uninstall(self) -> None:
        """Restore the previous handlers."""
        if not self.installed:
            return
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError, OSError):
                pass
        self._prev.clear()
        self.installed = False


class Heartbeat:
    """Background liveness file writer.

    >>> hb = Heartbeat(path, interval_s=10)
    >>> hb.update(step=123)   # cheap; call from the train loop
    >>> hb.stop()

    Every record carries an ``incarnation`` seeded from
    ``TCDP_RESTART_COUNT``, so a restarted worker's heartbeat outranks the
    file its previous life left behind.
    """

    def __init__(self, path: str, interval_s: float = 10.0,
                 payload: Optional[Dict[str, Any]] = None,
                 incarnation: Optional[int] = None):
        self.path = path
        self.interval_s = interval_s
        self.payload = dict(payload or {})
        if incarnation is None:
            incarnation = int(os.environ.get("TCDP_RESTART_COUNT", "0") or 0)
        self.incarnation = int(incarnation)
        self._step = 0
        # update() mutates the payload on the loop's thread while _write()
        # reads it on the writer's: the lock guards both
        self._lock = threading.Lock()
        #: the writer thread's first error (None = healthy)
        self.last_error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._write()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def update(self, step: int, **payload) -> None:
        with self._lock:
            self._step = int(step)
            self.payload.update(payload)

    def _write(self) -> None:
        with self._lock:
            rec = {"ts": time.time(), "step": self._step,
                   "incarnation": self.incarnation, **self.payload}
        # a pid-unique tmp name: two lives racing on one path never share it
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)  # atomic: readers never see partial JSON

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._write()
            except Exception as e:  # e.g. disk full: record, keep beating
                with self._lock:
                    self.last_error = e

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=self.interval_s + 1)
        self._write()


def spawn_supervised(cmd: Sequence[str], *, restart_count: int,
                     elastic_dir: Optional[str] = None,
                     env: Optional[Dict[str, str]] = None,
                     extra_env: Optional[Dict[str, str]] = None,
                     popen: Callable[..., "subprocess.Popen"] = subprocess.Popen,
                     log: Callable[[str], None] = print):
    """Launch one supervised child: a copy of ``env`` (default
    ``os.environ``) with ``TCDP_RESTART_COUNT`` set to ``restart_count``;
    with ``elastic_dir``, ``TCDP_ELASTIC_DIR`` and, when the directory holds
    a committed world epoch, ``TCDP_RENDEZVOUS_EPOCH`` / ``_ADDR``, the hint
    that lands a restarted worker in the running world's join barrier
    (``train/rendezvous.maybe_rejoin_from_env``) instead of a fresh world;
    ``extra_env`` layered last.  ``popen`` is injectable for tests."""
    child_env = dict(os.environ if env is None else env)
    child_env["TCDP_RESTART_COUNT"] = str(int(restart_count))
    if elastic_dir:
        from tpu_compressed_dp_torch.train.rendezvous import DIR_ENV, export_env, read_epoch

        child_env[DIR_ENV] = elastic_dir
        rec = read_epoch(elastic_dir)
        if rec is not None:
            export_env(child_env, rec)
            log(f"spawn: rejoin hint: world epoch {rec['epoch']} @ {rec.get('address')}")
    if extra_env:
        child_env.update({str(k): str(v) for k, v in extra_env.items()})
    return popen(list(cmd), env=child_env)


def read_heartbeat(path: str) -> Optional[Dict[str, Any]]:
    """Parse a heartbeat file; ``None`` on any unreadable content."""
    try:
        with open(path, "rb") as f:
            rec = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) else None


def is_stale(path: str, max_age_s: float) -> bool:
    """True when the heartbeat is missing, unreadable, lacks a numeric
    ``ts``, or is older than ``max_age_s``."""
    hb = read_heartbeat(path)
    if hb is None:
        return True
    ts = hb.get("ts")
    if not isinstance(ts, (int, float)) or isinstance(ts, bool):
        return True
    return (time.time() - ts) > max_age_s


def check_heartbeat(path: str, *, max_age_s: float = 60.0,
                    max_wedge_steps: Optional[int] = None,
                    min_steps_per_sec: Optional[float] = None,
                    max_step_p95_ms: Optional[float] = None,
                    max_ckpt_age_s: Optional[float] = None,
                    max_stream_lag_s: Optional[float] = None,
                    max_straggler_skew_s: Optional[float] = None,
                    now: Optional[float] = None,
                    hb: Optional[Dict[str, Any]] = None) -> list:
    """Health-check a heartbeat file; returns problem strings (empty =
    healthy), the JAX ``check_heartbeat``'s checks and wording: stale (the
    record older than ``max_age_s``), wedged (``last_good_step`` more than
    ``max_wedge_steps`` behind ``step``), stalled (``telemetry.steps_per_sec``
    below the floor), slow tail (``telemetry.step_p95_ms`` above the bound),
    checkpoint stale (``ckpt_age_s`` plus the record's age above the bound),
    stream stale (``stream_lag_s`` likewise) and straggler
    (``straggler_skew_s``).  A check whose field is absent is skipped.
    Pass ``hb`` to check an already-parsed record."""
    now = time.time() if now is None else now
    if hb is None:
        hb = read_heartbeat(path)
    if hb is None:
        return [f"heartbeat missing or unreadable: {path}"]
    problems = []
    age = now - float(hb.get("ts", 0.0))
    if age > max_age_s:
        problems.append(
            f"stale: heartbeat is {age:.1f}s old (> {max_age_s:g}s) — "
            "worker dead or hung")
    if max_wedge_steps is not None and "last_good_step" in hb:
        lag = int(hb.get("step", 0)) - int(hb["last_good_step"])
        if lag > max_wedge_steps:
            problems.append(
                f"wedged: last applied update is {lag} steps behind the "
                f"attempt counter (> {max_wedge_steps}) — every step is "
                "being skipped")
    tele = hb.get("telemetry") or {}
    if (min_steps_per_sec is not None
            and tele.get("steps_per_sec") is not None
            and float(tele["steps_per_sec"]) < min_steps_per_sec):
        problems.append(
            f"stalled: step rate {float(tele['steps_per_sec']):.4g}/s "
            f"below the {min_steps_per_sec:g}/s floor")
    if (max_step_p95_ms is not None
            and tele.get("step_p95_ms") is not None
            and float(tele["step_p95_ms"]) > max_step_p95_ms):
        problems.append(
            f"slow tail: p95 step time {float(tele['step_p95_ms']):.4g}ms "
            f"exceeds the {max_step_p95_ms:g}ms bound — the tail regressed "
            "past the run's modeled/pinned budget")
    if max_ckpt_age_s is not None and hb.get("ckpt_age_s") is not None:
        # add the record's own age, so a dying writer cannot freeze the
        # checkpoint clock at a healthy value
        ckpt_age = float(hb["ckpt_age_s"]) + max(age, 0.0)
        if ckpt_age > max_ckpt_age_s:
            problems.append(
                f"checkpoint stale: last durable save {ckpt_age:.1f}s ago "
                f"(> {max_ckpt_age_s:g}s, last_ckpt_step="
                f"{hb.get('last_ckpt_step')}) — a crash now loses that much "
                "work")
    if max_stream_lag_s is not None and hb.get("stream_lag_s") is not None:
        lag = float(hb["stream_lag_s"]) + max(age, 0.0)
        if lag > max_stream_lag_s:
            problems.append(
                f"stream stale: last delta segment {lag:.1f}s ago "
                f"(> {max_stream_lag_s:g}s, stream_last_step="
                f"{hb.get('stream_last_step')}) — warm rejoin and serving "
                "consumers are falling behind the run")
    skew = hb.get("straggler_skew_s", tele.get("straggler_skew_s"))
    if max_straggler_skew_s is not None and skew is not None:
        if float(skew) > max_straggler_skew_s:
            rank = hb.get("straggler_rank")
            problems.append(
                f"straggler: cross-rank step-time skew {float(skew):.4g}s "
                f"exceeds the {max_straggler_skew_s:g}s bound"
                + (f" (slowest rank {int(rank)})"
                   if isinstance(rank, (int, float)) and rank >= 0 else "")
                + " — one rank is pacing the whole world's collectives")
    return problems


def run_with_recovery(epoch_fn: Callable[[Any, int], Any], state: Any, epochs: int, *,
                      checkpointer=None, start_epoch: int = 0, max_retries: int = 3,
                      on_restore: Optional[Callable[[Any], Any]] = None,
                      passthrough: Tuple[type, ...] = ()
                      ) -> Tuple[Any, Dict[str, int]]:
    """Run ``state = epoch_fn(state, epoch)`` for each epoch; after an
    exception restore ``checkpointer``'s newest verifiable checkpoint and
    replay from the epoch after its meta's ``epoch``, up to ``max_retries``
    failures in a row (progress resets the count).  ``on_restore`` maps a
    restored state.  :class:`Preempted`, ``KeyboardInterrupt`` and
    ``SystemExit`` pass through; a failure before the first checkpoint
    re-raises the failure itself.  Returns ``(state, {'failures',
    'restores'})``."""
    failures = restores = 0
    epoch = start_epoch
    while epoch < epochs:
        try:
            state = epoch_fn(state, epoch)
            failures = 0  # progress resets the retry budget
            epoch += 1
        except (KeyboardInterrupt, SystemExit, Preempted, *passthrough):
            raise
        except Exception as train_err:
            failures += 1
            if checkpointer is None or failures > max_retries:
                raise
            try:
                state, meta = checkpointer.restore(state)
            except FileNotFoundError:
                # nothing to replay from: the training failure is the news
                raise train_err
            if on_restore is not None:
                state = on_restore(state)
            restores += 1
            epoch = int(meta.get("epoch", epoch - 1)) + 1
    return state, {"failures": failures, "restores": restores}
