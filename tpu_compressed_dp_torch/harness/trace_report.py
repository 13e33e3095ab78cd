"""Offline report from a JSONL telemetry event stream (``--events``).

The PyTorch port's counterpart of ``tools/trace_report.py``, with its
entry points, flags and output.  Renders, from the records the port's
harnesses emit through :mod:`tpu_compressed_dp_torch.obs.export` (the JAX
event format):

  * a **per-phase step-time breakdown** — mean/p50/p95 of the host
    timeline's data-wait / dispatch / (sampled) device-drain splits, and
    the data-wait fraction — the "where does a step's wall time go"
    table the paper's thesis needs;
  * a **throughput trajectory** — per epoch / log window: examples|tokens
    per second, MFU, per-chip comm MB/s, loss;
  * optionally (``--chrome out.json``) a **chrome://tracing /
    ui.perfetto.dev trace-event export** of the host timeline, one span
    per phase per step.

With ``--merge``, takes MULTIPLE per-rank event streams and emits one
cross-rank chrome://tracing export with a process lane per rank (lane
index = argument position; reuses ``harness/postmortem.py``'s merge) — the
visual the straggler gauges summarise to one number.

Host-side file reading only (no card, no ``--device``)::

    python -m tpu_compressed_dp_torch.harness.trace_report events.jsonl
    python -m tpu_compressed_dp_torch.harness.trace_report events.jsonl --chrome trace.json
    python -m tpu_compressed_dp_torch.harness.trace_report r0.jsonl r1.jsonl r2.jsonl \\
        --merge --chrome merged.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from tpu_compressed_dp_torch.obs.export import SCHEMA_VERSION, read_all_events
from tpu_compressed_dp_torch.obs.trace import percentile

WINDOW_KINDS = ("epoch", "step")  # records that carry metrics + timeline


def check_schema(events: List[Dict[str, Any]]) -> None:
    vs = {e.get("v") for e in events}
    unknown = vs - {SCHEMA_VERSION}
    if unknown:
        raise ValueError(
            f"event stream carries unknown schema version(s) {sorted(unknown)}"
            f" (this tool understands v{SCHEMA_VERSION})")


def step_spans(events: List[Dict[str, Any]]) -> List[Dict[str, float]]:
    """All per-step host-timeline records, in stream order."""
    out: List[Dict[str, float]] = []
    for e in events:
        if e.get("kind") in WINDOW_KINDS:
            out.extend(e.get("step_spans") or [])
    return out


def phase_breakdown(events: List[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """``{phase: {mean_ms, p50_ms, p95_ms, share}}`` over every step span
    in the stream.  ``share`` is the phase's fraction of step wall time —
    computed against the SAME steps the phase was measured on, so the
    sampled ``device`` split (``device_sync_every > 0`` records it only
    every Nth step) is not diluted by the unsampled steps' totals."""
    spans = step_spans(events)
    out: Dict[str, Dict[str, float]] = {}
    for ph in ("data", "dispatch", "device", "total"):
        have = [s for s in spans if s.get(ph) is not None and ph in s]
        if not have:
            continue
        vals = sorted(s[ph] for s in have)
        denom = sum(s.get("total", 0.0) for s in have)
        out[ph] = {
            "mean_ms": sum(vals) / len(vals) * 1e3,
            "p50_ms": percentile(vals, 0.50) * 1e3,
            "p95_ms": percentile(vals, 0.95) * 1e3,
            "share": (sum(vals) / denom) if denom > 0 else 0.0,
        }
    return out


def throughput_rows(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """One row per epoch/step window: loss + throughput + MFU + comm rate."""
    rows = []
    for e in events:
        if e.get("kind") not in WINDOW_KINDS:
            continue
        m = e.get("metrics") or {}
        thr = e.get("throughput") or {}
        rows.append({
            "window": e.get("epoch", e.get("step", "?")),
            "kind": e["kind"],
            "loss": m.get("train loss", m.get("loss")),
            "rate": thr.get("throughput/examples_per_sec",
                            thr.get("throughput/tokens_per_sec")),
            "rate_unit": ("ex/s" if "throughput/examples_per_sec" in thr
                          else "tok/s"),
            "mfu": thr.get("throughput/mfu"),
            "tflops": thr.get("throughput/model_tflops_per_chip"),
            "comm_mb_s": m.get("comm MB/s"),
            "skipped": (e.get("guard") or {}).get("guard/skipped"),
        })
    return rows


def chrome_trace_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Trace-event-format spans (``ph='X'``, microseconds) of the host
    timeline — load in chrome://tracing or ui.perfetto.dev."""
    spans = step_spans(events)
    if not spans:
        return []
    t_base = min(s["t0"] for s in spans)
    out = []
    for i, s in enumerate(spans):
        t = (s["t0"] - t_base) * 1e6
        for ph in ("data", "dispatch", "device"):
            dur = s.get(ph)
            if dur is None:
                continue
            out.append({"name": ph, "cat": "host", "ph": "X", "pid": 0,
                        "tid": 0, "ts": t, "dur": dur * 1e6,
                        "args": {"step_index": i}})
            t += dur * 1e6
    return out


def _fmt(v: Optional[float], spec: str = "10.2f") -> str:
    return format(v, spec) if isinstance(v, (int, float)) else " " * 7 + "-"


def render_report(events: List[Dict[str, Any]]) -> str:
    check_schema(events)
    lines = []
    start = next((e for e in events if e.get("kind") == "run_start"), {})
    ctx = {k: v for k, v in start.items()
           if k not in ("v", "kind", "ts")}
    lines.append(f"run: {json.dumps(ctx)}")

    bd = phase_breakdown(events)
    lines.append("")
    lines.append("per-phase step-time breakdown (host timeline):")
    lines.append(f"  {'phase':<10}{'mean ms':>10}{'p50 ms':>10}"
                 f"{'p95 ms':>10}{'share':>8}")
    for ph in ("data", "dispatch", "device", "total"):
        if ph not in bd:
            continue
        r = bd[ph]
        share = "" if ph == "total" else f"{r['share']*100:7.1f}%"
        lines.append(f"  {ph:<10}{r['mean_ms']:>10.2f}{r['p50_ms']:>10.2f}"
                     f"{r['p95_ms']:>10.2f}{share:>8}")
    if not bd:
        lines.append("  (no step spans in stream)")

    lines.append("")
    lines.append("throughput trajectory:")
    lines.append(f"  {'window':>8}  {'loss':>10}{'rate':>12} unit "
                 f"{'MFU':>8}{'TF/chip':>10}{'comm MB/s':>11}{'skipped':>9}")
    for r in throughput_rows(events):
        lines.append(
            f"  {r['window']:>8}  {_fmt(r['loss'], '10.4f')}"
            f"{_fmt(r['rate'], '12.1f')} {r['rate_unit']:<4}"
            f"{_fmt(r['mfu'], '8.4f')}{_fmt(r['tflops'], '10.3f')}"
            f"{_fmt(r['comm_mb_s'], '11.3f')}{_fmt(r['skipped'], '9.0f')}")

    guard = [e for e in events if e.get("kind") == "guard"]
    if guard:
        lines.append("")
        lines.append(f"guard events: {len(guard)} "
                     f"(last: {json.dumps({k: v for k, v in guard[-1].items() if k.startswith('guard/')})})")
    return "\n".join(lines)


def render_schedule(path: str) -> str:
    """Render the per-chunk collective placement recorded by the
    reference's ``tools/overlap_evidence.py`` (``benchmarks/overlap_hlo_r8.txt``)
    alongside the host report: which ``tcdp.chunk<ii>`` collective sits
    where in the compiled schedule, and how much model compute remains to
    hide it — the overlap, directly.  The host timeline cannot see device
    phases; the AOT schedule artifact is the device-side view."""
    lines = ["", f"compiled-schedule overlap ({path}):"]
    try:
        txt = open(path).read()
    except OSError as e:
        return "\n".join(lines + [f"  (unreadable: {e})"])
    for ln in txt.splitlines():
        if ln.startswith("== ") or "chunk=" in ln or "summary:" in ln:
            lines.append("  " + ln.strip())
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("events", nargs="+",
                   help="JSONL event stream(s) (harness --events); more "
                        "than one requires --merge")
    p.add_argument("--merge", action="store_true",
                   help="treat each events argument as one rank's stream "
                        "and emit a cross-rank chrome trace with rank "
                        "lanes (requires --chrome)")
    p.add_argument("--chrome", type=str, default=None,
                   help="write a chrome://tracing trace-event JSON here")
    p.add_argument("--json", action="store_true",
                   help="emit the breakdown/trajectory as JSON instead of text")
    p.add_argument("--schedule", type=str, default=None,
                   help="also render the per-chunk collective placement "
                        "from an overlap_evidence output file "
                        "(benchmarks/overlap_hlo_r8.txt)")
    p.add_argument("--control", action="store_true",
                   help="also render the adaptive-controller rung "
                        "trajectory (control_decision records; see "
                        "harness/control_report.py for the full report)")
    args = p.parse_args(argv)
    if args.merge:
        if not args.chrome:
            p.error("--merge requires --chrome OUT.json")
        from tpu_compressed_dp_torch.harness.postmortem import rank_lane_events
        spans_by_rank: Dict[int, List[Dict[str, Any]]] = {}
        for rank, path in enumerate(args.events):
            evs = read_all_events(path)
            check_schema(evs)
            spans_by_rank[rank] = step_spans(evs)
            print(f"rank {rank}: {len(spans_by_rank[rank])} step spans "
                  f"({path})")
        with open(args.chrome, "w") as f:
            json.dump({"traceEvents": rank_lane_events(spans_by_rank),
                       "displayTimeUnit": "ms"}, f)
        print(f"cross-rank chrome trace: {args.chrome} "
              "(load in chrome://tracing or ui.perfetto.dev)")
        return 0
    if len(args.events) > 1:
        p.error("multiple event streams need --merge")
    # a rotated stream (--events_max_mb) is stitched back together here
    events = read_all_events(args.events[0])
    if args.json:
        payload = {"phase_breakdown": phase_breakdown(events),
                   "throughput": throughput_rows(events)}
        if args.schedule:
            payload["schedule"] = render_schedule(args.schedule).splitlines()
        if args.control:
            from tpu_compressed_dp_torch.harness.control_report import (decision_rows,
                                                                        summarize)
            decs = decision_rows(events)
            payload["control"] = {"decisions": decs,
                                  "summary": summarize(decs)}
        print(json.dumps(payload, indent=2))
    else:
        print(render_report(events))
        if args.schedule:
            print(render_schedule(args.schedule))
        if args.control:
            from tpu_compressed_dp_torch.harness.control_report import (
                render_report as render_control)
            print("")
            print(render_control(events))
    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump({"traceEvents": chrome_trace_events(events),
                       "displayTimeUnit": "ms"}, f)
        print(f"\nchrome trace: {args.chrome} "
              "(load in chrome://tracing or ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
