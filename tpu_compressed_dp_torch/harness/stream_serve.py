"""Tail-and-apply consumer for the delta state stream (model-push channel).

PyTorch-port counterpart of the JAX package's ``tools/stream_serve.py``,
with its CLI, files and exit codes.  A training job armed with
``--stream_dir`` appends Top-K parameter deltas (plus periodic full
keyframes) to a shared directory (:mod:`tpu_compressed_dp_torch.stream`).
This tool is the read-only side of that channel: an eval or serving replica
tails the segment stream, applies each verified segment to its host-side
reconstruction, and publishes materialised snapshots.  It reads a stream
either package wrote.

  * default / ``--poll N``: poll the stream every N seconds (default 5),
    apply new segments as they commit, write the heartbeat after every
    scan.  Runs until killed; Ctrl-C exits 0.
  * ``--once``: catch up once and exit.  Exit 0 = caught up, 1 = the
    stream is unusable (no verifiable keyframe: fall back to a full
    checkpoint), 2 = not (yet) a stream directory.
  * ``--snapshot_dir``: materialise ``snapshot-<step>.npz`` (one array per
    parameter path) whenever the reconstruction is *exact* (anchored at a
    window boundary AND caught up to the producer's head), so a serving
    process only ever loads bitwise-faithful parameters.
  * ``--heartbeat``: JSON liveness file (``stream_lag_s``, applied
    seq/step, corrupt-segment count) for ``harness/watchdog.py --check
    --max_stream_lag``.

All published files go through the shared-dir protocol (a ``*.<pid>.tmp``
sibling, ``os.replace`` into place): concurrent readers never see a torn
snapshot or heartbeat::

    python -m tpu_compressed_dp_torch.harness.stream_serve /runs/lm17/stream --once \
        --snapshot_dir /serve
    python -m tpu_compressed_dp_torch.harness.stream_serve /runs/lm17/stream --poll 10 \
        --heartbeat hb.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from tpu_compressed_dp_torch.stream.reader import StreamReader
from tpu_compressed_dp_torch.stream.store import StreamCorrupt, is_stream_dir


def _publish(path: str, data: bytes) -> None:
    """Atomic shared-dir write: tmp sibling + os.replace."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _write_heartbeat(path: str, reader: StreamReader) -> None:
    m = reader.metrics()
    hb = {
        "ts": time.time(),
        "applied_seq": int(reader.applied_seq),
        "applied_step": int(reader.applied_step),
        "exact": bool(reader.exact),
        "stream_lag_s": float(m["stream/lag_s"]),
        "stream_corrupt_segments": float(m["stream/corrupt_segments"]),
        "stream_bytes_read": float(reader.bytes_read),
    }
    _publish(path, json.dumps(hb).encode("utf-8"))


def _write_snapshot(directory: str, reader: StreamReader) -> str:
    """Materialise the current (exact) reconstruction as one npz, one
    array per parameter path, published atomically."""
    os.makedirs(directory, exist_ok=True)
    params = reader.params_dict()
    path = os.path.join(directory, f"snapshot-{int(reader.applied_step)}.npz")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **params)
    os.replace(tmp, path)
    return path


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dir", help="delta stream directory (harness --stream_dir)")
    p.add_argument("--once", action="store_true",
                   help="catch up once and exit (cron-friendly)")
    p.add_argument("--poll", type=float, default=5.0,
                   help="seconds between stream scans (default 5)")
    p.add_argument("--snapshot_dir", type=str, default=None,
                   help="publish snapshot-<step>.npz here whenever the "
                        "reconstruction is exact (window boundary + caught "
                        "up to head)")
    p.add_argument("--heartbeat", type=str, default=None,
                   help="JSON liveness file for watchdog --check "
                        "(stream_lag_s et al.), rewritten after every scan")
    args = p.parse_args(argv)

    if not os.path.isdir(args.dir):
        print(f"stream_serve: no such directory: {args.dir}")
        return 2
    reader = StreamReader(args.dir)
    last_snapshot_step = None
    while True:
        try:
            applied = reader.catch_up()
        except StreamCorrupt as err:
            # no verifiable keyframe anywhere: this stream cannot seed a
            # consumer; the caller falls back to a full checkpoint
            print(f"stream_serve: UNUSABLE: {err}")
            return 1
        if applied:
            print(f"stream_serve: applied {applied} segment(s), "
                  f"seq={reader.applied_seq} step={reader.applied_step} "
                  f"exact={reader.exact}")
        if (args.snapshot_dir and reader.exact
                and reader.applied_step != last_snapshot_step):
            out = _write_snapshot(args.snapshot_dir, reader)
            last_snapshot_step = reader.applied_step
            print(f"stream_serve: snapshot {out}")
        if args.heartbeat:
            _write_heartbeat(args.heartbeat, reader)
        if args.once:
            if not is_stream_dir(args.dir):
                print(f"stream_serve: not a stream dir (yet): {args.dir}")
                return 2
            return 0
        try:
            time.sleep(max(args.poll, 0.1))
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
