"""Deterministic fault injection ("chaos") for the robustness layer.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.utils.chaos`.  Both
planes key off the step counter, never the clock or a random draw, so a
replay after a restore meets the same faults:

  * **in the step** (:func:`inject`): one worker's gradients or loss become
    NaN/Inf at chosen steps, before the guard's vote
    (``train/guard.py``);
  * **on the host** (:class:`CrashInjector`): :class:`ChaosCrash` raised
    before a chosen step is dispatched (``crash=N``), right after it
    (``crash=mid_collective,crash_at_step=N``: the elastic runtime reads it
    as the death of ``worker``), inside the elastic remesh handler
    (``crash=during_remesh``: a second death, which cascades), or a real
    ``SIGTERM`` to this process before the step
    (``crash=preempt,crash_at_step=N``), which
    ``utils/resilience.PreemptionHandler`` turns into an emergency
    checkpoint and exit code 75.  Each fires once a process.

``--chaos SPEC`` takes comma-separated ``key=value`` tokens (a bare
``nan``/``inf`` sets ``kind``), parsed exactly as the JAX package parses
them::

    --chaos "nan,target=grads,steps=3+7,worker=1"
    --chaos "inf,target=loss,every=50"
    --chaos "crash=120"
    --chaos "crash=preempt,crash_at_step=12"
    --chaos "crash=mid_collective,crash_at_step=3,worker=1,peer_timeout=30"

``peer_timeout`` overrides the elastic runtime's ``--peer_timeout``
(``harness/loop.build_elastic``).
"""

from __future__ import annotations

import dataclasses
import signal
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["ChaosConfig", "ChaosCrash", "CrashInjector", "fires_at", "inject",
           "maybe_crash_injector"]


class ChaosCrash(RuntimeError):
    """The injected host-side failure."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """One fault-injection scenario (the JAX ``ChaosConfig``'s fields).

    kind:          'nan' | 'inf'
    target:        'grads' (every element of the worker's gradients) | 'loss'
    steps:         step counters (the value of ``TrainState.step`` going into
                   the step) at which the in-step fault fires
    every:         also fire whenever ``step % every == 0`` (0 = off)
    worker:        the compression worker to poison (``guard.worker_index``)
    crash_at_step: raise :class:`ChaosCrash` (or send SIGTERM in mode
                   'preempt') at this step (-1 = off)
    crash_mode:    'step' (before dispatch) | 'mid_collective' (after
                   dispatch: the elastic runtime's simulated death of
                   ``worker``) | 'during_remesh' (inside the remesh
                   handler: a cascading death) | 'preempt'
    peer_timeout:  the elastic runtime's failure-detection budget in
                   seconds (0 = the ``--peer_timeout`` flag's)
    """

    kind: str = "nan"
    target: str = "grads"
    steps: Tuple[int, ...] = ()
    every: int = 0
    worker: int = 0
    crash_at_step: int = -1
    crash_mode: str = "step"
    peer_timeout: float = 0.0

    def __post_init__(self):
        if self.kind not in ("nan", "inf"):
            raise ValueError(f"chaos kind must be nan|inf, got {self.kind!r}")
        if self.target not in ("grads", "loss"):
            raise ValueError(f"chaos target must be grads|loss, got {self.target!r}")
        if self.every < 0 or self.worker < 0:
            raise ValueError("chaos every/worker must be >= 0")
        if self.crash_mode not in ("step", "mid_collective", "during_remesh", "preempt"):
            raise ValueError("chaos crash_mode must be step|mid_collective|"
                             f"during_remesh|preempt, got {self.crash_mode!r}")
        if self.peer_timeout < 0:
            raise ValueError("chaos peer_timeout must be >= 0")

    @property
    def injects_in_graph(self) -> bool:
        return bool(self.steps) or self.every > 0

    @classmethod
    def parse(cls, spec: str) -> "ChaosConfig":
        """Parse the ``--chaos`` string (see the module docstring)."""
        kw: Dict[str, Any] = {}
        for tok in filter(None, (t.strip() for t in spec.split(","))):
            if "=" not in tok:
                if tok not in ("nan", "inf"):
                    raise ValueError(
                        f"bad --chaos token {tok!r}: bare tokens must be "
                        "nan|inf; everything else is key=value")
                kw["kind"] = tok
                continue
            k, v = tok.split("=", 1)
            k = k.strip()
            v = v.strip()
            if k in ("kind", "target"):
                kw[k] = v
            elif k == "steps":
                kw["steps"] = tuple(int(s) for s in v.split("+") if s)
            elif k in ("every", "worker"):
                kw[k] = int(v)
            elif k == "crash" and v in ("mid_collective", "during_remesh", "preempt"):
                # the mode rides the crash key; the step comes from crash_at_step
                kw["crash_mode"] = v
            elif k in ("crash", "crash_at_step"):
                kw["crash_at_step"] = int(v)
            elif k == "crash_mode":
                kw["crash_mode"] = v
            elif k == "peer_timeout":
                kw["peer_timeout"] = float(v)
            else:
                raise ValueError(
                    f"unknown --chaos key {k!r} (kind|target|steps|every|"
                    "worker|crash|crash_mode|peer_timeout)")
        return cls(**kw)

    def to_spec(self) -> str:
        """The canonical ``--chaos`` string: ``parse(c.to_spec()) == c``."""
        toks = [self.kind]
        if self.target != "grads":
            toks.append(f"target={self.target}")
        if self.steps:
            toks.append("steps=" + "+".join(str(s) for s in self.steps))
        if self.every:
            toks.append(f"every={self.every}")
        if self.worker:
            toks.append(f"worker={self.worker}")
        if self.crash_at_step >= 0:
            toks.append(f"crash_at_step={self.crash_at_step}")
        if self.crash_mode != "step":
            toks.append(f"crash={self.crash_mode}")
        if self.peer_timeout:
            toks.append(f"peer_timeout={self.peer_timeout:g}")
        return ",".join(toks)


def fires_at(chaos: ChaosConfig, step: int) -> bool:
    """Does the in-step fault fire at ``step``?  A function of the step
    counter alone."""
    step = int(step)
    return step in chaos.steps or (chaos.every > 0 and step % chaos.every == 0)


@torch.no_grad()
def inject(chaos: ChaosConfig, step: int, widx: int, loss: torch.Tensor,
           grads: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Poison ``loss`` or every gradient of the targeted worker at firing
    steps (the identity elsewhere), before the guard's vote.  The
    gradients are the step's own and are filled in place."""
    if not (fires_at(chaos, step) and int(widx) == chaos.worker):
        return loss, grads
    bad = float("nan") if chaos.kind == "nan" else float("inf")
    if chaos.target == "loss":
        return torch.full_like(loss, bad), grads
    for g in grads.values():
        g.fill_(bad)
    return loss, grads


class CrashInjector:
    """The host-side crash at a global step, once a process.

    >>> crash = CrashInjector(chaos.crash_at_step)
    >>> crash.check(global_step)   # raises ChaosCrash at/after the step

    ``check(step, phase)`` fires only in the injector's own phase: the loop
    calls ``check(step)`` before dispatch (phase ``'step'``) and
    ``check(step, phase='mid_collective')`` right after it; the elastic
    remesh handler probes ``phase='during_remesh'``.  The raised
    :class:`ChaosCrash` carries ``step`` / ``mode`` / ``worker``, which the
    elastic runtime turns into the death of ``worker``.  Mode
    ``'preempt'`` raises nothing: it sends this process a real ``SIGTERM``
    at the armed step, in phase ``'step'``.
    """

    def __init__(self, crash_at_step: int, mode: str = "step", worker: int = 0):
        if mode not in ("step", "mid_collective", "during_remesh", "preempt"):
            raise ValueError("crash mode must be step|mid_collective|during_remesh|preempt, "
                             f"got {mode!r}")
        self.crash_at_step = int(crash_at_step)
        self.mode = mode
        self.worker = int(worker)
        self.fired = False
        #: optional ``obs/flight.FlightRecorder``: the injector notes the
        #: injection into the chaos ring the instant it fires — for the
        #: preempt mode the only record the dying process gets to make
        #: before the SIGTERM lands
        self.flight = None

    def _note_fired(self, step: int) -> None:
        if self.flight is None:
            return
        try:
            self.flight.record("chaos", "crash_fired", step=int(step), mode=self.mode,
                               worker=self.worker, crash_at_step=self.crash_at_step)
        except Exception:
            pass  # forensics must never alter the injected failure

    def check(self, step: int, phase: str = "step") -> None:
        # >= not ==: epoch-granular callers must not miss the mark when a
        # resume lands the counter past it
        if (self.fired or self.crash_at_step < 0 or int(step) < self.crash_at_step
                or phase != ("step" if self.mode == "preempt" else self.mode)):
            return
        self.fired = True
        self._note_fired(step)
        if self.mode == "preempt":
            # what a spot-VM reclaim does, raised in this thread so the
            # handler has run when this returns; PreemptionHandler's flag,
            # checked right after, turns it into the emergency save
            signal.raise_signal(signal.SIGTERM)
            return
        err = ChaosCrash(f"chaos: injected host crash at step {int(step)}"
                         + (" (mid-collective)" if self.mode == "mid_collective" else ""))
        err.step = int(step)
        err.mode = self.mode
        err.worker = self.worker
        raise err


def maybe_crash_injector(chaos: Optional[ChaosConfig]) -> Optional[CrashInjector]:
    """An armed injector, or None."""
    if chaos is None or chaos.crash_at_step < 0:
        return None
    return CrashInjector(chaos.crash_at_step, mode=chaos.crash_mode, worker=chaos.worker)
