"""StreamReader: tail-and-apply consumer for the delta segment stream.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.stream.reader`: host
numpy, set-semantics apply, so after any keyframe or window-closing flush
the reader's vector is bitwise the writer's parameters at that segment,
whichever package wrote the stream.  Used by ``harness/stream_serve.py``
(model push to eval/serving replicas) and by
:func:`tpu_compressed_dp_torch.stream.rejoin.warm_rejoin` (a joiner catching
up at the rendezvous barrier).

Corruption policy (the ``stream_corrupt`` chaos drill pins both arms):

* a delta that fails verification WALKS BACK: the reconstruction reverts
  to the stored copy of the current keyframe (bitwise) and the reader
  skips forward to the next verifiable keyframe, which re-anchors it
  exactly;
* a stream with NO verifiable keyframe to anchor on raises
  :class:`~tpu_compressed_dp_torch.stream.store.StreamCorrupt`: the caller
  falls back to a full restore (a cold join).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from tpu_compressed_dp_torch.stream import delta as dcodec
from tpu_compressed_dp_torch.stream import store

__all__ = ["StreamReader"]


class StreamReader:
    """Incremental consumer over one stream directory.

    ``catch_up()`` scans committed segments past the last scanned seq and
    applies them; call it in a poll loop (serving) or once (rejoin).
    ``exact`` is True when the reconstruction is pinned bitwise to the
    writer's params at the stream head — last applied segment was a
    keyframe or window-closing flush AND nothing newer is committed.
    """

    def __init__(self, directory: str, *, log=print,
                 now=time.monotonic, wall=time.time):
        self.directory = directory
        self._log = log
        self._now = now
        self._wall = wall
        self._vec: Optional[np.ndarray] = None
        self._spec: Optional[List[Dict[str, Any]]] = None
        self._keyframe_vec: Optional[np.ndarray] = None
        self._keyframe_seq = -1
        self._keyframe_step = -1
        self._await_keyframe = False
        self._anchored = False
        self._scanned_seq = -1    # newest seq examined (advances monotonically)
        self._applied_seq = -1    # newest seq reflected in the reconstruction
        self._applied_step = -1
        self._last_ts = 0.0
        self.bytes_read = 0
        self.segments_applied = 0
        self.corrupt_segments = 0

    # --------------------------------------------------------------- tailing

    def catch_up(self) -> int:
        """Apply every committed segment newer than the last scanned one;
        returns the number applied.  The FIRST catch-up of a fresh reader
        seeks to the newest verifiable keyframe and starts there — older
        segments are dead history and are never read.  Raises
        ``StreamCorrupt`` only when the stream leaves NOTHING to anchor
        on (see module docstring)."""
        applied = 0
        seqs = store.list_segments(self.directory)
        if self._scanned_seq < 0 and self._vec is None and seqs:
            anchor = self._seek_anchor(seqs)
            if anchor is not None:
                self._scanned_seq = anchor - 1
        for seq in seqs:
            if seq <= self._scanned_seq:
                continue
            self._scanned_seq = seq
            man = store.read_segment_manifest(self.directory, seq)
            kind = None if man is None else man.get("kind")
            if self._await_keyframe and kind == "delta":
                continue  # skipping forward to the next anchor
            try:
                man, arrays = store.load_segment(self.directory, seq)
            except store.StreamCorrupt as e:
                self.corrupt_segments += 1
                self._walk_back(seq, e)
                continue
            if man["kind"] == "keyframe":
                self._apply_keyframe(man, arrays)
            else:
                if self._vec is None:
                    # deltas before any keyframe we hold: nothing to apply
                    # them to — keep waiting for an anchor
                    self._await_keyframe = True
                    continue
                self._apply_delta(man, arrays)
            applied += 1
            self.segments_applied += 1
            self.bytes_read += int(man.get("bytes", 0))
            self._applied_seq = seq
            self._applied_step = int(man["step"])
            self._last_ts = float(man.get("ts", 0.0))
        if self._vec is None and self._scanned_seq >= 0:
            # segments exist but none anchors: nothing trustworthy to serve
            raise store.StreamCorrupt(
                f"no verifiable keyframe in {self.directory!r} "
                f"(scanned through seq {self._scanned_seq})")
        return applied

    def _seek_anchor(self, seqs: List[int]) -> Optional[int]:
        """A FRESH consumer (rejoin, relaunched server) needs nothing
        before the newest verifiable keyframe — every segment older than
        that anchor is dead history, so skip it unread rather than
        replaying the whole stream.  Returns the seq to start from, or
        None when no keyframe verifies (the forward scan then reports
        corruption exactly as before).  On a pruned stream this is a
        near-no-op; on an unpruned one it caps rejoin cost at one window."""
        for seq in reversed(seqs):
            man = store.read_segment_manifest(self.directory, seq)
            if man is None or man.get("kind") != "keyframe":
                continue
            if not store.verify_segment(self.directory, seq):
                return seq
        return None

    def _apply_keyframe(self, man: Dict[str, Any],
                        arrays: Dict[str, np.ndarray]) -> None:
        vec = arrays["vals"].astype(np.float32, copy=True)
        self._vec = vec
        self._keyframe_vec = vec.copy()
        self._keyframe_seq = int(man["seq"])
        self._keyframe_step = int(man["step"])
        if man.get("spec") is not None:
            self._spec = man["spec"]
        self._await_keyframe = False
        self._anchored = True

    def _apply_delta(self, man: Dict[str, Any],
                     arrays: Dict[str, np.ndarray]) -> None:
        dcodec.apply_delta(self._vec, arrays["idx"],
                           arrays["vals"].astype(np.float32, copy=False))
        self._anchored = bool(man.get("window_close"))

    def _walk_back(self, seq: int, err: BaseException) -> None:
        """A corrupt segment mid-stream: revert to the keyframe copy
        (bitwise) and re-anchor at the next verifiable keyframe."""
        self._log(f"[stream] segment {seq} corrupt ({err}); walking back "
                  f"to keyframe seq {self._keyframe_seq}")
        if self._keyframe_vec is not None:
            self._vec = self._keyframe_vec.copy()
            self._applied_seq = self._keyframe_seq
            self._applied_step = self._keyframe_step
            self._anchored = True
        self._await_keyframe = True

    # --------------------------------------------------------------- surface

    @property
    def applied_seq(self) -> int:
        return self._applied_seq

    @property
    def applied_step(self) -> int:
        return self._applied_step

    @property
    def spec(self) -> Optional[List[Dict[str, Any]]]:
        return self._spec

    @property
    def exact(self) -> bool:
        """Reconstruction is bitwise the writer's params at the head: the
        last applied segment closes a window (or IS a keyframe) and no
        newer segment is committed."""
        if not self._anchored or self._vec is None:
            return False
        head = store.read_head(self.directory)
        if head is not None:
            return int(head["seq"]) <= self._applied_seq
        # no/torn head pointer: it is also what a mid-rewrite or damaged
        # stream looks like, so claim exactness only against the committed
        # segments actually on disk — never by default
        seqs = store.list_segments(self.directory)
        return bool(seqs) and seqs[-1] <= self._applied_seq

    def params_like(self, template_params):
        """The reconstruction in the TEMPLATE's form, spec-checked
        (:func:`stream.delta.unflatten_like`): for a model, ``{param_leaves
        key: CPU tensor}`` in the port's layout; for a tree, the tree."""
        if self._vec is None or self._spec is None:
            raise store.StreamCorrupt(
                f"nothing reconstructed yet from {self.directory!r}")
        return dcodec.unflatten_like(template_params, self._vec, self._spec)

    def params_dict(self) -> Dict[str, np.ndarray]:
        """Template-free ``{leaf path: array}`` view (serving consumers)."""
        if self._vec is None or self._spec is None:
            raise store.StreamCorrupt(
                f"nothing reconstructed yet from {self.directory!r}")
        return dcodec.unflatten_dict(self._vec, self._spec)

    def metrics(self) -> Dict[str, float]:
        """Host-emitter gauges; keys declared in ``obs/registry.py``."""
        lag = (self._wall() - self._last_ts) if self._last_ts else -1.0
        return {
            "stream/lag_s": max(lag, 0.0) if self._last_ts else -1.0,
            "stream/corrupt_segments": float(self.corrupt_segments),
            "stream/last_step": float(self._applied_step),
        }
