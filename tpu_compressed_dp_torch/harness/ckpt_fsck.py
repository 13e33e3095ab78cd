"""Offline checkpoint fsck: verify / list / prune a checkpoint directory.

The PyTorch port's counterpart of ``tools/ckpt_fsck.py``, with its verbs,
output and exit codes.  Every checkpoint the
:class:`~tpu_compressed_dp_torch.utils.checkpoint.Checkpointer` commits
carries a checksummed manifest (``manifest-<step>.json`` next to the step
directory: per-file sha256 + byte counts, schema-versioned, committed
atomically AFTER the ranks' files are in place; the JAX manifest format).
This tool re-verifies those digests offline — before resuming a long run on a directory that survived a
preemption, or from cron over a fleet's checkpoint trees:

  * default — verify every step; print OK / CORRUPT per step (legacy steps
    without a manifest are tolerated and flagged), plus orphaned manifests
    whose step directory is gone.  Exit 0 = all verifiable, 1 = something
    is corrupt, 2 = the directory is missing/empty.
  * ``--list`` — one line per step with its manifest summary (file count,
    payload bytes, meta keys), no verification.  Exit 0.
  * ``--prune`` — delete corrupt step directories and their manifests (and
    orphaned manifests), leaving only steps a restore can actually use.
    Exit 0 after pruning.

Delta state streams (:mod:`tpu_compressed_dp_torch.stream`, harness
``--stream_dir``) use the same manifest-checksum discipline per segment,
and fsck covers them with the same verbs: if the target directory is a
stream dir — or has a ``stream/`` subdirectory next to the checkpoints —
segments are verified (``seg N: OK/CORRUPT``) and listed, and ``--prune``
drops superseded delta windows via
:func:`tpu_compressed_dp_torch.stream.store.prune_segments` (``--keep_windows``,
default 2).  Exit semantics are unchanged: 1 = any step OR segment is
corrupt, 2 = nothing verifiable at all (no steps and no segments).

Pure host-side file I/O (no card, no ``--device``)::

    python -m tpu_compressed_dp_torch.harness.ckpt_fsck CKPT_DIR
    python -m tpu_compressed_dp_torch.harness.ckpt_fsck CKPT_DIR --list
    python -m tpu_compressed_dp_torch.harness.ckpt_fsck CKPT_DIR --prune
    python -m tpu_compressed_dp_torch.harness.ckpt_fsck STREAM_DIR   # a stream dir
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import List, Optional

from tpu_compressed_dp_torch.stream.store import (is_stream_dir, list_segments,
                                                  prune_segments, read_segment_manifest,
                                                  verify_stream)
from tpu_compressed_dp_torch.utils.checkpoint import (list_step_dirs, manifest_path,
                                                      read_manifest, verify_step_dir)


def _find_stream_dir(directory: str) -> Optional[str]:
    """The directory itself if it is a delta stream, else its ``stream/``
    subdirectory when a harness kept checkpoints and stream side by side."""
    if is_stream_dir(directory):
        return directory
    sub = os.path.join(directory, "stream")
    if is_stream_dir(sub):
        return sub
    return None


def _orphan_manifests(directory: str, steps: List[int]) -> List[str]:
    """manifest-<step>.json files whose step directory no longer exists
    (a crash between a step directory's delete and the manifest cleanup)."""
    have = {str(s) for s in steps}
    out = []
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("manifest-") and name.endswith(".json")):
            continue
        step = name[len("manifest-"):-len(".json")]
        if step.isdigit() and step not in have:
            out.append(os.path.join(directory, name))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dir", help="checkpoint directory (harness --checkpoint_dir)")
    p.add_argument("--list", action="store_true",
                   help="list steps + manifest summaries, no verification")
    p.add_argument("--prune", action="store_true",
                   help="delete corrupt step dirs + orphaned manifests; for "
                        "streams, drop superseded delta windows")
    p.add_argument("--keep_windows", type=int, default=2,
                   help="stream --prune: keyframe windows to retain "
                        "(default 2)")
    args = p.parse_args(argv)

    if not os.path.isdir(args.dir):
        print(f"ckpt_fsck: no such directory: {args.dir}")
        return 2
    steps = list_step_dirs(args.dir)
    stream_dir = _find_stream_dir(args.dir)
    seqs = list_segments(stream_dir) if stream_dir is not None else []
    if not steps and not seqs:
        print(f"ckpt_fsck: no checkpoints under {args.dir}")
        return 2

    if args.list:
        for s in steps:
            man = read_manifest(args.dir, s)
            if man is None:
                print(f"step {s}: (no manifest — legacy checkpoint)")
                continue
            files = man.get("files", {}) or {}
            total = sum(int(e.get("bytes", 0)) for e in files.values())
            meta_keys = ",".join(sorted((man.get("meta") or {}).keys())) or "-"
            print(f"step {s}: {len(files)} files, {total} bytes, "
                  f"meta[{meta_keys}]")
        for q in seqs:
            man = read_segment_manifest(stream_dir, q)
            if man is None:
                print(f"seg {q}: (manifest unreadable)")
                continue
            close = " window-close" if man.get("window_close") else ""
            print(f"seg {q}: {man.get('kind')} step {man.get('step')}, "
                  f"{man.get('bytes')} bytes, nnz {man.get('nnz')}{close}")
        return 0

    bad: List[int] = []
    for s in steps:
        problems = verify_step_dir(args.dir, s)
        if problems:
            bad.append(s)
            for pr in problems:
                print(f"step {s}: CORRUPT: {pr}")
        elif read_manifest(args.dir, s) is None and not os.path.exists(
                manifest_path(args.dir, s)):
            print(f"step {s}: OK (legacy, no manifest)")
        else:
            print(f"step {s}: OK")
    orphans = _orphan_manifests(args.dir, steps)
    for o in orphans:
        print(f"orphaned manifest: {o}")

    stream_problems: List[str] = []
    if stream_dir is not None:
        stream_problems, all_seqs = verify_stream(stream_dir)
        bad_seqs = set()
        for pr in stream_problems:
            print(f"stream: CORRUPT: {pr}")
            if pr.startswith("segment "):
                head = pr[len("segment "):].split(":", 1)[0]
                if head.isdigit():
                    bad_seqs.add(int(head))
        for q in all_seqs:
            if q not in bad_seqs:
                print(f"seg {q}: OK")

    if args.prune:
        for s in bad:
            shutil.rmtree(os.path.join(args.dir, str(s)), ignore_errors=True)
            try:
                os.remove(manifest_path(args.dir, s))
            except OSError:
                pass
            print(f"pruned step {s}")
        for o in orphans:
            try:
                os.remove(o)
                print(f"pruned {o}")
            except OSError:
                pass
        if stream_dir is not None:
            dropped = prune_segments(stream_dir,
                                     keep_windows=args.keep_windows)
            for q in dropped:
                print(f"pruned seg {q}")
        return 0
    return 1 if (bad or stream_problems) else 0


if __name__ == "__main__":
    sys.exit(main())
