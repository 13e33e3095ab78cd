"""Cross-rank postmortem: merge blackbox bundles, name the root cause.

PyTorch-port counterpart of the JAX package's ``tools/postmortem.py``, with
its verdicts, priority and output.  When a run dies, every rank's
:class:`~tpu_compressed_dp_torch.obs.flight.FlightRecorder` dumps its ring
buffers as ``blackbox.rank<R>.json`` into the shared dir.  This tool merges those per-rank bundles into one
cross-rank timeline and classifies the failure with a one-line verdict:

  ``corruption``  a rank's checkpoint failed manifest verification
  ``preempt``     a rank received the platform's preemption notice
  ``dead_peer``   a peer vanished (crash/kill); names the dead rank from
                  the survivors' ``PeerFailed`` evidence or the armed
                  chaos scenario
  ``nan``         the step guard wedged AND a rank was injecting
                  nan/inf — names the origin rank from the chaos arm
  ``guard``       the step guard wedged with no injection evidence
  ``straggler``   no distinguished failure, but one rank's mean host
                  step time skews far above its peers'
  ``unknown``     bundles exist but match no signature

Priority is the order above: a preempted rank also makes its peers raise
``PeerFailed``, a corrupt checkpoint surfaces after a crash — the
earliest cause in the chain wins.  All ordering comes from per-record
``seq`` + the trigger step (bundle timestamps are per-rank monotonic
offsets, never compared across ranks).

Usage::

    python -m tpu_compressed_dp_torch.harness.postmortem /shared/run_dir
    python -m tpu_compressed_dp_torch.harness.postmortem /shared/run_dir --json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from tpu_compressed_dp_torch.obs.flight import (FLIGHT_SCHEMA, profile_from_spans,
                                          read_bundles, straggler_gauges,
                                          validate_bundle)

#: relative skew (slowest vs fastest rank's mean step time) above which
#: the fallback classification blames a straggler
STRAGGLER_FRAC = 0.25

VERDICT_KINDS = ("corruption", "preempt", "dead_peer", "nan", "guard",
                 "straggler", "unknown")


# ------------------------------------------------------------------ merging

def merge_timeline(bundles: Dict[int, Dict[str, Any]]
                   ) -> List[Dict[str, Any]]:
    """One cross-rank record list: every ring record annotated with its
    ``rank`` and ``channel``, ordered by (step, rank, seq).  Records
    without a step sort after stepped ones at the same rank — per-rank
    ``seq`` preserves their true local order."""
    merged: List[Dict[str, Any]] = []
    for rank in sorted(bundles):
        rings = bundles[rank].get("rings") or {}
        for channel, ring in rings.items():
            if not isinstance(ring, list):
                continue
            for rec in ring:
                if isinstance(rec, dict):
                    merged.append({"rank": rank, "channel": channel, **rec})

    def order(rec: Dict[str, Any]):
        step = rec.get("step")
        return (step if isinstance(step, int) else sys.maxsize,
                rec.get("rank", 0), rec.get("seq", 0))

    merged.sort(key=order)
    return merged


def rank_lane_events(spans_by_rank: Dict[int, List[Dict[str, Any]]]
                     ) -> List[Dict[str, Any]]:
    """chrome://tracing trace events with one PROCESS LANE PER RANK
    (``pid=rank``) from per-rank step-span lists (the ``step_spans`` a
    harness event stream carries, ``t0`` included).  Spans are aligned on each rank's
    earliest ``t0`` — host clocks are per-process, so cross-rank offsets
    show relative pacing (who lags inside a step), not absolute order."""
    out: List[Dict[str, Any]] = []
    for rank in sorted(spans_by_rank):
        spans = [s for s in spans_by_rank[rank] if "t0" in s]
        if not spans:
            continue
        out.append({"name": "process_name", "ph": "M", "pid": rank,
                    "args": {"name": f"rank {rank}"}})
        t_base = min(s["t0"] for s in spans)
        for i, s in enumerate(spans):
            t = (s["t0"] - t_base) * 1e6
            for ph in ("data", "dispatch", "device"):
                dur = s.get(ph)
                if dur is None:
                    continue
                out.append({"name": ph, "cat": "host", "ph": "X",
                            "pid": rank, "tid": 0, "ts": t,
                            "dur": dur * 1e6,
                            "args": {"step_index": i, "rank": rank}})
                t += dur * 1e6
    return out


# ------------------------------------------------------- classification

def straggler_from_bundles(bundles: Dict[int, Dict[str, Any]]
                           ) -> Dict[str, float]:
    """The live ``straggler/*`` gauges recomputed offline from the
    bundles' ``timing`` rings (same aggregation as the recorder)."""
    profiles = {}
    for rank, rec in bundles.items():
        ring = (rec.get("rings") or {}).get("timing") or []
        profiles[rank] = profile_from_spans(rank, ring)
    return straggler_gauges(profiles)


def _chaos_records(bundles: Dict[int, Dict[str, Any]]):
    for rank in sorted(bundles):
        for rec in (bundles[rank].get("rings") or {}).get("chaos") or []:
            if isinstance(rec, dict):
                yield rank, rec


def _verdict(kind: str, rank: int, step: Optional[int],
             detail: str) -> Dict[str, Any]:
    return {"kind": kind, "rank": int(rank),
            "step": step if isinstance(step, int) else None,
            "detail": detail}


def verdict_line(v: Dict[str, Any]) -> str:
    step = v["step"] if v["step"] is not None else "?"
    return (f"postmortem: {v['kind']} rank={v['rank']} step={step} "
            f"— {v['detail']}")


def classify(bundles: Dict[int, Dict[str, Any]]) -> Dict[str, Any]:
    """Root-cause verdict over all per-rank bundles (see module
    docstring for the taxonomy and its priority order)."""
    if not bundles:
        return _verdict("unknown", -1, None, "no blackbox bundles found")
    by_reason: Dict[str, List[int]] = {}
    for rank in sorted(bundles):
        by_reason.setdefault(str(bundles[rank].get("reason")), []).append(rank)

    def step_of(rank: int) -> Optional[int]:
        s = bundles[rank].get("step")
        return s if isinstance(s, int) else None

    if "ckpt_corrupt" in by_reason:
        r = min(by_reason["ckpt_corrupt"])
        msg = (bundles[r].get("error") or {}).get("message", "")
        return _verdict(
            "corruption", r, step_of(r),
            f"rank {r}'s checkpoint failed verification: {msg[:120]}")

    if "preempt" in by_reason:
        r = min(by_reason["preempt"])
        sig = (bundles[r].get("error") or {}).get("signum")
        return _verdict(
            "preempt", r, step_of(r),
            f"rank {r} received the preemption notice"
            + (f" (signal {sig})" if sig else ""))

    if "peer_failed" in by_reason or "chaos_crash" in by_reason:
        dead = set()
        for r in by_reason.get("peer_failed", ()):
            for f in (bundles[r].get("error") or {}).get("failed") or []:
                dead.add(int(f))
        # a crashed rank that managed to dump names itself
        dead.update(by_reason.get("chaos_crash", ()))
        if not dead:
            # survivors raised a bare timeout: fall back to the armed
            # chaos scenario every rank recorded
            for _, rec in _chaos_records(bundles):
                w, at = rec.get("worker"), rec.get("crash_at_step")
                if isinstance(at, (int, float)) and at >= 0 and w is not None:
                    dead.add(int(w))
        reporters = (by_reason.get("peer_failed")
                     or by_reason.get("chaos_crash"))
        rank = min(dead) if dead else -1
        return _verdict(
            "dead_peer", rank, step_of(min(reporters)),
            (f"rank {rank} vanished; {len(reporters)} survivor(s) raised "
             "PeerFailed") if dead else
            "a peer vanished but no bundle names it")

    if "guard_exceeded" in by_reason:
        reporter = min(by_reason["guard_exceeded"])
        for _, rec in _chaos_records(bundles):
            kind, w = rec.get("kind"), rec.get("worker")
            if kind in ("nan", "inf") and w is not None:
                return _verdict(
                    "nan", int(w), step_of(reporter),
                    f"step guard wedged; {kind} was injected into "
                    f"{rec.get('target', '?')} on worker {w}")
        return _verdict(
            "guard", -1, step_of(reporter),
            "step guard wedged (skip streak exceeded) with no injection "
            "evidence — inspect the guard rings for the first bad step")

    gauges = straggler_from_bundles(bundles)
    if (gauges["straggler/frac"] > STRAGGLER_FRAC
            and gauges["straggler/rank"] >= 0):
        r = int(gauges["straggler/rank"])
        return _verdict(
            "straggler", r, None,
            f"rank {r}'s mean host step time skews "
            f"{gauges['straggler/frac'] * 100:.0f}% above the fastest "
            f"rank ({gauges['straggler/skew_s'] * 1e3:.1f} ms/step)")

    first = min(bundles)
    return _verdict(
        "unknown", -1, step_of(first),
        f"{len(bundles)} bundle(s) with reason(s) "
        f"{sorted(by_reason)} match no known signature")


# ----------------------------------------------------------------- report

def render_report(bundles: Dict[int, Dict[str, Any]], *,
                  tail: int = 20) -> str:
    v = classify(bundles)
    lines = [verdict_line(v), ""]
    lines.append(f"{'rank':>6} {'reason':<16} {'step':>8} {'records':>9} "
                 f"{'dumps':>7}  schema")
    for rank in sorted(bundles):
        b = bundles[rank]
        counts = b.get("counts") or {}
        problems = validate_bundle(b)
        lines.append(
            f"{rank:>6} {str(b.get('reason')):<16} "
            f"{str(b.get('step')):>8} {counts.get('records', '?'):>9} "
            f"{counts.get('dumps', '?'):>7}  "
            + ("ok" if not problems else "; ".join(problems)))
    gauges = straggler_from_bundles(bundles)
    if gauges["straggler/rank"] >= 0:
        lines.append("")
        lines.append(
            f"straggler gauges: skew {gauges['straggler/skew_s'] * 1e3:.2f} "
            f"ms/step, slowest rank {int(gauges['straggler/rank'])} "
            f"(+{gauges['straggler/frac'] * 100:.0f}% vs fastest)")
    merged = merge_timeline(bundles)
    if merged:
        lines.append("")
        lines.append(f"cross-rank timeline (last {min(tail, len(merged))} "
                     f"of {len(merged)} records):")
        for rec in merged[-tail:]:
            ctx = {k: v2 for k, v2 in rec.items()
                   if k not in ("rank", "channel", "kind", "seq", "t")}
            lines.append(f"  r{rec['rank']} {rec['channel']:<8} "
                         f"{rec.get('kind', '?'):<12} {json.dumps(ctx)}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("directory",
                   help="shared dir holding blackbox.rank<R>.json bundles")
    p.add_argument("--json", action="store_true",
                   help="emit verdict + per-rank summaries + merged "
                        "timeline as JSON")
    p.add_argument("--tail", type=int, default=20,
                   help="merged-timeline records to show (text mode)")
    args = p.parse_args(argv)
    bundles = read_bundles(args.directory)
    if not bundles:
        print(f"postmortem: no blackbox bundles in {args.directory}")
        return 2
    if args.json:
        payload = {
            "v": FLIGHT_SCHEMA,
            "verdict": classify(bundles),
            "straggler": straggler_from_bundles(bundles),
            "ranks": {
                str(r): {"reason": b.get("reason"), "step": b.get("step"),
                         "counts": b.get("counts"),
                         "problems": validate_bundle(b)}
                for r, b in sorted(bundles.items())},
            "timeline": merge_timeline(bundles),
        }
        print(json.dumps(payload, indent=2))
    else:
        print(render_report(bundles, tail=args.tail))
    return 0


if __name__ == "__main__":
    sys.exit(main())
