"""StreamWriter: continuous incremental checkpoints on the delta wire.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.stream.writer`, with
its segments, sequence rules, window accounting, metrics, heartbeat fields
and telemetry records.  One writer owns a directory; ``append_async``
hands the disk write to a background thread and re-raises its failure at
the next barrier.  A full keyframe every ``keyframe_every`` appends, Top-K
drift deltas between, and a window-closing flush (every bitwise-changed
coordinate) as the last delta of each window, so ``keyframe + sum(deltas)``
reproduces the live parameters exactly in fp32 at every window boundary.

The codec (flatten, selection, the ``last_streamed`` update, window
accounting) runs on the CALLER's thread, on the parameters' device:
``last_streamed`` is a device vector beside the parameters, the drift's
search and select+pack run there (``stream/delta.py``), and only the
keyframe's vector or the delta's ``idx`` / ``vals`` come to the host.  The
port's SGD and BatchNorm update the parameters in place (JAX's arrays are
immutable), so the codec finishes with host copies that no later step can
change before :meth:`StreamWriter.append_async` returns, and every device
read of the parameters is done by then (each host copy synchronises the
stream the codec ran on); only the ``write_segment`` commit goes to the
background thread.  ``codec_ms`` is the last append's time on the caller's
thread (``stream/append_ms`` is the commit's, as in JAX).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tpu_compressed_dp_torch.stream import delta as dcodec
from tpu_compressed_dp_torch.stream import store

__all__ = ["StreamWriter"]


def _host(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy no later in-place update of ``t`` can reach."""
    a = t.detach().cpu()
    return (a.clone() if a.data_ptr() == t.data_ptr() else a).numpy()


class StreamWriter:
    """Appends delta-compressed state segments to a shared directory.

    ``ratio`` is the Top-K density per delta (fraction of model
    coordinates); ``keyframe_every`` is the window length in segments (one
    keyframe, ``keyframe_every - 2`` Top-K deltas, one flush).  On restart
    over an existing stream the sequence continues past the newest
    committed segment (manifest or head pointer, whichever is newer: a
    crash can commit a manifest the head never saw) and the first append is
    forced to a keyframe, since the new writer has no ``last_streamed`` to
    delta against.  ``params`` is a model or a tree (``stream/delta.py``).

    Set ``.flight`` / ``.events`` (or pass them) the way the Checkpointer's
    are set to tee keyframe/flush records into the ``stream`` flight ring
    and the ``--events`` stream.
    """

    def __init__(self, directory: str, *, ratio: float = 0.01, keyframe_every: int = 8,
                 flight=None, events=None, log=print, now=time.monotonic, wall=time.time):
        if keyframe_every < 2:
            raise ValueError(f"keyframe_every must be >= 2 (a keyframe and its flush), "
                             f"got {keyframe_every}")
        self.directory = os.path.abspath(directory)
        self.ratio = float(ratio)
        self.keyframe_every = int(keyframe_every)
        self.flight = flight
        self.events = events
        self._log = log
        self._now = now
        self._wall = wall
        #: last background commit failure popped by a non-raising barrier
        self.last_append_error: Optional[BaseException] = None
        #: the last append's codec time on the caller's thread, in ms
        self.codec_ms = 0.0
        self._thread: Optional[threading.Thread] = None
        self._bg_error: Optional[BaseException] = None
        self._op = threading.RLock()   # serialises codec + commit ordering
        self._mx = threading.Lock()    # guards the metric counters
        self._last: Optional[torch.Tensor] = None   # last_streamed vector (device)
        self._spec: Optional[List[Dict[str, Any]]] = None
        self._since_keyframe = 0
        self._keyframe_seq = -1
        self._force_keyframe = False
        # continue past the newest COMMITTED segment, not just the head
        # pointer: write_segment commits payload -> manifest -> head, so a
        # crash between the manifest and head replaces leaves a committed
        # segment at head.seq+1 that a head-only restart would overwrite
        head = store.read_head(self.directory)
        seqs = store.list_segments(self.directory)
        last = max(int(head["seq"]) if head is not None else -1, seqs[-1] if seqs else -1)
        self._seq = last + 1 if last >= 0 else 0
        self._force_keyframe = last >= 0   # the first append must anchor
        self._segments = 0
        self._keyframes = 0
        self._bytes = 0
        self._keyframe_bytes = 0
        self._append_ms = 0.0
        self._residual_norm = 0.0
        self._last_step: Optional[int] = None
        self._mark_wall = wall()      # newest commit (or open) wall time

    # ---------------------------------------------------------------- append

    def append(self, params, *, step: int) -> int:
        """Synchronous append: barrier on any in-flight async commit, run
        the codec, and block until the segment is durable.  Returns the
        committed segment seq."""
        self._barrier(raise_error=True)
        seq, kind, man_args = self._encode(params, step=int(step))
        self._commit_timed(seq, kind, int(step), man_args)
        return seq

    def append_async(self, params, *, step: int) -> int:
        """Codec on the caller's thread (so ``last_streamed`` and the window
        accounting stay ordered, and the parameters are read before the next
        step writes them), disk commit in the background.  A background
        failure re-raises at the next barrier and forces the following
        append to a keyframe: the stream must re-anchor past the hole."""
        self._barrier(raise_error=True)
        seq, kind, man_args = self._encode(params, step=int(step))

        def _bg():
            try:
                self._commit_timed(seq, kind, int(step), man_args)
            except BaseException as e:  # surfaced at the next barrier
                with self._mx:
                    self._bg_error = e

        self._thread = threading.Thread(target=_bg, name=f"stream-append-{seq}", daemon=True)
        self._thread.start()
        return seq

    def sync(self, params, *, step: int) -> int:
        """Barrier + window-closing flush: after this returns, the stream
        head reconstructs to ``params`` bitwise (fp32).  The rejoin
        barrier's primitive: the coordinator calls it so a joiner catching
        up from the stream adopts exactly the live state."""
        self._barrier(raise_error=True)
        seq, kind, man_args = self._encode(params, step=int(step), force_flush=True)
        self._commit_timed(seq, kind, int(step), man_args)
        return seq

    def request_keyframe(self) -> None:
        """Force the next append to emit a full keyframe (membership
        changes, a committed checkpoint, post-failure re-anchoring)."""
        with self._op:
            self._force_keyframe = True

    # ----------------------------------------------------------------- codec

    @torch.no_grad()
    def _encode(self, params, *, step: int, force_flush: bool = False):
        """Flatten + select on the caller's thread; returns the
        ``write_segment`` arguments (host arrays only) for the commit."""
        t0 = self._now()
        with self._op:
            vec, spec = dcodec.flatten_params(params)
            respec = self._spec is not None and spec != self._spec
            keyframe = (self._last is None or respec or self._force_keyframe
                        or self._since_keyframe == 0)
            seq = self._seq
            self._seq += 1
            if keyframe:
                self._force_keyframe = False
                self._keyframe_seq = seq
                self._since_keyframe = 1
                self._spec = spec
                self._last = vec
                self._residual_norm = 0.0
                out = seq, "keyframe", dict(
                    step=step, keyframe_seq=seq, window_close=True,
                    arrays={"vals": _host(vec)}, spec=spec, ts=self._wall())
            else:
                window_close = force_flush or self._since_keyframe >= self.keyframe_every - 1
                if window_close:
                    idx, vals = dcodec.flush_delta(vec, self._last)
                    self._since_keyframe = 0      # next append re-anchors
                else:
                    keep = dcodec.keep_for_ratio(vec.shape[0], self.ratio)
                    idx, vals = dcodec.topk_delta(vec, self._last, keep)
                    self._since_keyframe += 1
                dcodec.apply_delta(self._last, idx, vals)
                self._residual_norm = float(torch.linalg.vector_norm(
                    dcodec.residual_of(vec, self._last)))
                del vec
                out = seq, "delta", dict(
                    step=step, keyframe_seq=self._keyframe_seq, window_close=window_close,
                    arrays={"idx": _host(idx), "vals": _host(vals)}, ts=self._wall())
        self.codec_ms = (self._now() - t0) * 1e3
        return out

    def _commit(self, seq: int, kind: str, man_args: Dict[str, Any]) -> None:
        """The blocking commit seam for ONE segment (payload + digest +
        manifest + head, each atomic).  Tests inject failures here."""
        spec = man_args.pop("spec", None)
        if spec is not None:
            man_args["spec"] = [dict(e) for e in spec]
        store.write_segment(self.directory, seq=seq, kind=kind, **man_args)

    def _commit_timed(self, seq: int, kind: str, step: int, man_args: Dict[str, Any]) -> None:
        t0 = self._now()
        self._commit(seq, kind, man_args)
        self._committed(seq, kind, step, (self._now() - t0) * 1e3, man_args)

    def _committed(self, seq: int, kind: str, step: int, ms: float,
                   man_args: Dict[str, Any]) -> None:
        nbytes = sum(int(a.nbytes) for a in man_args["arrays"].values())
        with self._mx:
            self._segments += 1
            self._bytes += nbytes
            if kind == "keyframe":
                self._keyframes += 1
                self._keyframe_bytes += nbytes
            self._append_ms = ms
            self._last_step = step
            self._mark_wall = self._wall()
        if kind == "keyframe" or man_args.get("window_close"):
            self._emit("stream_keyframe" if kind == "keyframe" else "stream_flush",
                       seq=seq, step=step, bytes=nbytes, ms=round(ms, 3))

    # ------------------------------------------------------------- barriers

    def _barrier(self, *, raise_error: bool) -> None:
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        err, self._bg_error = self._bg_error, None
        if err is not None:
            self.last_append_error = err
            # a lost commit leaves a hole: re-anchor past it
            with self._op:
                self._force_keyframe = True
            if raise_error:
                raise err

    def drain(self, *, raise_error: bool = True) -> None:
        """Block until any in-flight async commit lands; with
        ``raise_error=False`` (shutdown paths) a background failure is
        recorded in ``last_append_error`` instead of raised."""
        self._barrier(raise_error=raise_error)

    def close(self) -> None:
        """Drain without raising: close runs in ``finally`` blocks."""
        self._barrier(raise_error=False)

    # --------------------------------------------------------------- surface

    @property
    def head_seq(self) -> int:
        """Seq of the newest ENCODED segment (-1 before the first append)."""
        with self._op:
            return self._seq - 1

    @property
    def spec(self) -> Optional[List[Dict[str, Any]]]:
        with self._op:
            return None if self._spec is None else [dict(e) for e in self._spec]

    def metrics(self) -> Dict[str, float]:
        """Host-emitter counters/gauges; keys declared in ``obs/registry.py``."""
        with self._mx:
            return {
                "stream/segments": float(self._segments),
                "stream/keyframes": float(self._keyframes),
                "stream/bytes": float(self._bytes),
                "stream/keyframe_bytes": float(self._keyframe_bytes),
                "stream/append_ms": self._append_ms,
                "stream/residual_norm": self._residual_norm,
                "stream/last_step": float(-1 if self._last_step is None else self._last_step),
            }

    def heartbeat_fields(self) -> Dict[str, float]:
        """The fields the watchdog's ``--max_stream_lag`` check reads out of
        the heartbeat payload."""
        with self._mx:
            return {
                "stream_last_step": int(-1 if self._last_step is None else self._last_step),
                "stream_lag_s": max(self._wall() - self._mark_wall, 0.0),
            }

    def _emit(self, kind: str, **fields) -> None:
        fl = self.flight
        if fl is not None:
            try:
                fl.record("stream", kind, **fields)
            except Exception:
                pass  # telemetry must never fail an append
        ev = self.events
        if ev is None:
            return
        try:
            ev.emit(kind, **fields)
        except Exception:
            pass  # telemetry must never fail an append
