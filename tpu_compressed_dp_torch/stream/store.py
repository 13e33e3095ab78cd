"""Segment store: manifest-checksummed delta/keyframe files on a shared dir.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.stream.store`, byte
layout for byte layout, so either package reads the other's stream.  One
monotone segment sequence per stream directory::

    seg-00000000.npz    payload (numpy archive: vals [+ idx for deltas])
    seg-00000000.json   manifest: schema, kind, step, sha256, byte count
    stream.json         head pointer (latest committed seq), atomic

The manifest is the commit marker, as the Checkpointer's
``manifest-<step>.json`` is: payload first, digest, then manifest, then the
head pointer, each via ``<path>.<pid>.tmp`` + ``os.replace``, so a tailing
consumer never sees a torn segment and a bit-flipped payload is
*detectable* (:func:`verify_segment`) rather than silently applied.

Pure host-side file I/O on numpy: ``harness/stream_serve.py`` needs no
model, no card and no training imports.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tpu_compressed_dp_torch.utils.checkpoint import digest_file

__all__ = [
    "STREAM_SCHEMA", "StreamCorrupt", "head_path", "segment_payload_path",
    "segment_manifest_path", "write_segment", "read_head", "list_segments",
    "read_segment_manifest", "verify_segment", "load_segment",
    "verify_stream", "prune_segments", "is_stream_dir",
]

#: bump on incompatible segment/manifest layout changes; consumers check
#: it before applying (a newer writer must not be silently misread).  The
#: JAX package's value: the two packages share the layout
STREAM_SCHEMA = 1

#: segment kinds: a ``keyframe`` carries the full dense vector (recovery
#: anchor), a ``delta`` carries ``(idx, vals)`` set-semantics updates; a
#: delta with ``window_close`` carries EVERY bitwise-changed coordinate,
#: making ``keyframe + sum(deltas)`` reproduce the live params exactly.
KINDS = ("keyframe", "delta")


class StreamCorrupt(RuntimeError):
    """A segment failed manifest verification (missing payload, size or
    digest mismatch, torn/unreadable manifest, schema skew)."""


def head_path(directory: str) -> str:
    return os.path.join(directory, "stream.json")


def segment_payload_path(directory: str, seq: int) -> str:
    return os.path.join(directory, f"seg-{int(seq):08d}.npz")


def segment_manifest_path(directory: str, seq: int) -> str:
    return os.path.join(directory, f"seg-{int(seq):08d}.json")


def _write_atomic(path: str, data: bytes) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[Dict[str, Any]]:
    """Tolerant read: None for missing/torn content (the rendezvous /
    heartbeat contract — a reader never crashes on in-flight state)."""
    try:
        with open(path, "rb") as f:
            rec = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) else None


def write_segment(directory: str, *, seq: int, kind: str, step: int,
                  keyframe_seq: int, window_close: bool,
                  arrays: Dict[str, np.ndarray],
                  spec: Optional[List[Dict[str, Any]]] = None,
                  meta: Optional[Dict[str, Any]] = None,
                  ts: float = 0.0) -> Dict[str, Any]:
    """Commit one segment: payload, digest, manifest, head — in that
    order, each atomic.  ``ts`` is the writer's injected wall clock
    (informational; consumers compute lag from it)."""
    if kind not in KINDS:
        raise ValueError(f"unknown segment kind {kind!r}; expected {KINDS}")
    os.makedirs(directory, exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = segment_payload_path(directory, seq)
    _write_atomic(payload, buf.getvalue())
    man: Dict[str, Any] = {
        "v": STREAM_SCHEMA, "seq": int(seq), "kind": kind, "step": int(step),
        "keyframe_seq": int(keyframe_seq), "window_close": bool(window_close),
        "payload": os.path.basename(payload),
        "sha256": digest_file(payload),
        "bytes": os.path.getsize(payload),
        "nnz": int(arrays["vals"].shape[0]) if "vals" in arrays else 0,
        "ts": float(ts), "meta": dict(meta or {}),
    }
    if spec is not None:
        man["spec"] = spec
    _write_atomic(segment_manifest_path(directory, seq),
                  json.dumps(man).encode("utf-8"))
    _write_atomic(head_path(directory), json.dumps({
        "v": STREAM_SCHEMA, "seq": int(seq), "step": int(step),
        "keyframe_seq": int(keyframe_seq), "ts": float(ts),
    }).encode("utf-8"))
    return man


def read_head(directory: str) -> Optional[Dict[str, Any]]:
    """The head pointer (latest committed seq), or None before the first
    segment / on a torn read."""
    rec = _read_json(head_path(directory))
    if rec is None or "seq" not in rec:
        return None
    return rec


def read_segment_manifest(directory: str, seq: int) -> Optional[Dict[str, Any]]:
    return _read_json(segment_manifest_path(directory, seq))


def list_segments(directory: str) -> List[int]:
    """Committed segment seqs on disk (by manifest presence), sorted."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in names:
        if name.startswith("seg-") and name.endswith(".json"):
            body = name[len("seg-"):-len(".json")]
            if body.isdigit():
                out.append(int(body))
    return sorted(out)


def is_stream_dir(directory: str) -> bool:
    """True when ``directory`` holds a segment stream (head pointer or at
    least one committed segment manifest)."""
    return (os.path.isfile(head_path(directory))
            or bool(list_segments(directory)))


def verify_segment(directory: str, seq: int) -> List[str]:
    """Verify one segment against its manifest; returns problem strings
    (empty = verifiable).  Unlike legacy checkpoints, a stream segment
    without a manifest is ALWAYS a problem — the manifest is the commit
    marker and this layout never shipped without one."""
    man = read_segment_manifest(directory, seq)
    if man is None:
        if os.path.exists(segment_manifest_path(directory, seq)):
            return ["manifest unreadable (torn commit?)"]
        return ["manifest missing"]
    if man.get("v") != STREAM_SCHEMA:
        return [f"manifest schema {man.get('v')!r} != {STREAM_SCHEMA}"]
    if man.get("kind") not in KINDS:
        return [f"unknown segment kind {man.get('kind')!r}"]
    payload = segment_payload_path(directory, seq)
    if not os.path.isfile(payload):
        return [f"missing payload: {os.path.basename(payload)}"]
    if os.path.getsize(payload) != int(man.get("bytes", -1)):
        return [f"size mismatch: {os.path.getsize(payload)} != "
                f"{man.get('bytes')}"]
    if digest_file(payload) != man.get("sha256"):
        return ["digest mismatch"]
    return []


def load_segment(directory: str, seq: int
                 ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Verify then load one segment; raises :class:`StreamCorrupt` on any
    verification problem (callers walk back to the last keyframe)."""
    problems = verify_segment(directory, seq)
    if problems:
        raise StreamCorrupt(
            f"segment {seq} in {directory}: " + "; ".join(problems))
    man = read_segment_manifest(directory, seq)
    with np.load(segment_payload_path(directory, seq)) as z:
        arrays = {k: z[k] for k in z.files}
    return man, arrays


def verify_stream(directory: str) -> Tuple[List[str], List[int]]:
    """fsck surface: verify every committed segment plus the head pointer.
    Returns ``(problems, segment seqs)`` — empty problems = verifiable."""
    seqs = list_segments(directory)
    problems: List[str] = []
    for seq in seqs:
        for pr in verify_segment(directory, seq):
            problems.append(f"segment {seq}: {pr}")
    head = read_head(directory)
    if head is None and os.path.exists(head_path(directory)):
        problems.append("head pointer unreadable (torn commit?)")
    elif head is not None and seqs and int(head["seq"]) not in seqs:
        problems.append(
            f"head points at segment {head['seq']} with no manifest")
    # orphaned payloads: a crash between the payload replace and the
    # manifest commit leaves an .npz no manifest vouches for
    try:
        names = os.listdir(directory)
    except OSError:
        names = []
    for name in sorted(names):
        if name.startswith("seg-") and name.endswith(".npz"):
            body = name[len("seg-"):-len(".npz")]
            if body.isdigit() and int(body) not in seqs:
                problems.append(f"orphaned payload: {name}")
    return problems, seqs


def prune_segments(directory: str, *, keep_windows: int = 2,
                   dry_run: bool = False) -> List[int]:
    """Drop segments older than the ``keep_windows``-newest *verifiable*
    keyframes (a window is everything from one keyframe up to the next).
    Never removes the newest keyframe chain — pruning can only shorten
    history a recovery no longer needs.  Returns the pruned seqs."""
    if keep_windows < 1:
        raise ValueError(f"keep_windows must be >= 1, got {keep_windows}")
    seqs = list_segments(directory)
    keyframes = []
    for seq in seqs:
        man = read_segment_manifest(directory, seq)
        if (man is not None and man.get("kind") == "keyframe"
                and not verify_segment(directory, seq)):
            keyframes.append(seq)
    if len(keyframes) <= keep_windows:
        return []
    cutoff = keyframes[-keep_windows]
    pruned = [s for s in seqs if s < cutoff]
    if not dry_run:
        for seq in pruned:
            for path in (segment_payload_path(directory, seq),
                         segment_manifest_path(directory, seq)):
                try:
                    os.remove(path)
                except OSError:
                    pass
    return pruned
