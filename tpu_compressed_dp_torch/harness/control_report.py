"""Offline report of the adaptive-compression control loop.

The PyTorch port's counterpart of ``tools/control_report.py``, with its
entry points, flags and output.  Reads a JSONL telemetry event stream
(harness ``--events``) from an ``--adaptive`` run and renders, from the
``control_decision`` records the controller emits at every window close
plus the ``control`` metric dict the epoch/step records carry:

  * the **rung trajectory** — which ladder rung (and knob value) the
    controller sat on at each decision, with the direction it moved;
  * the **per-window comm/compute balance** — the modeled-or-measured
    comm time each window against the hideable-compute budget the
    ``sync_overlap`` chunk schedule exposes, i.e. the signal the
    controller steers on;
  * a one-line **summary** — decisions taken, moves by direction, final
    rung, and whether the loop converged (last K windows held).

With ``--twin_records <dir>`` every decision row also carries a **twin
ms** column: the window's billed bits re-priced through the calibrated
per-fabric digital twin (``tpu_compressed_dp_torch/twin/``) next to the flat
``--adaptive_bw_mbps`` price the controller steered on — the audit of
what each rung decision WOULD have seen under the schedule-aware model.
Topology defaults come from the ``run_start`` record and can be
overridden (``--twin_world/--twin_pods/--twin_transport``).

Host-side file reading only (no card, no ``--device``)::

    python -m tpu_compressed_dp_torch.harness.control_report events.jsonl
    python -m tpu_compressed_dp_torch.harness.control_report events.jsonl --json
    python -m tpu_compressed_dp_torch.harness.control_report events.jsonl --twin_records DIR
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from tpu_compressed_dp_torch.obs.export import SCHEMA_VERSION, read_events

WINDOW_KINDS = ("epoch", "step")  # records that carry the control dict


def check_schema(events: List[Dict[str, Any]]) -> None:
    vs = {e.get("v") for e in events}
    unknown = vs - {SCHEMA_VERSION}
    if unknown:
        raise ValueError(
            f"event stream carries unknown schema version(s) {sorted(unknown)}"
            f" (this tool understands v{SCHEMA_VERSION})")


def decision_rows(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """All ``control_decision`` records, in stream order."""
    return [e for e in events if e.get("kind") == "control_decision"]


def window_rows(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """One row per epoch/step window that carries control metrics.  When
    the run billed per-fabric (``--transport hierarchical``/``--dp_pods``),
    each row also carries the DCN-billed share of the wire bits — the
    series the controller's modeled signal prices on a 2-level topology."""
    rows = []
    for e in events:
        if e.get("kind") not in WINDOW_KINDS:
            continue
        c = e.get("control") or {}
        if not c:
            continue
        comm = e.get("comm") or {}
        row = {
            "window": e.get("epoch", e.get("step", "?")),
            "kind": e["kind"],
            "rung": c.get("control/rung"),
            "value": c.get("control/value"),
            "decisions": c.get("control/decisions"),
            "comm_ms": c.get("control/comm_ms"),
            "budget_ms": c.get("control/budget_ms"),
        }
        if comm.get("comm/sent_bits_dcn") or comm.get("comm/sent_bits_ici"):
            row["dcn_bits"] = comm.get("comm/sent_bits_dcn", 0.0)
            row["ici_bits"] = comm.get("comm/sent_bits_ici", 0.0)
        rows.append(row)
    return rows


def build_pricer(events: List[Dict[str, Any]], twin_records: str,
                 world: Optional[int] = None, pods: Optional[int] = None,
                 transport: Optional[str] = None):
    """A :class:`~tpu_compressed_dp_torch.control.signals.TwinPricer` for this
    run: twin fitted from ``twin_records``, topology from the
    ``run_start`` record unless overridden."""
    from tpu_compressed_dp_torch.control.signals import TwinPricer
    from tpu_compressed_dp_torch.twin import calibration_rows, fit

    start = next((e for e in events if e.get("kind") == "run_start"), {})
    rows = calibration_rows(twin_records)
    tr = transport or str(start.get("transport") or "psum")
    if tr == "allgather":
        tr = "all_gather"
    return TwinPricer(
        model=fit(rows).model,
        world=int(world or start.get("devices") or start.get("world") or 8),
        pods=int(pods or start.get("dp_pods") or 1),
        transport=tr, calib_rows=len(rows))


def attach_twin_price(rows: List[Dict[str, Any]], pricer) -> None:
    """Add ``twin_comm_ms`` next to each row's flat-priced ``comm_ms``."""
    for r in rows:
        bits = r.get("bits")
        if isinstance(bits, (int, float)):
            r["twin_comm_ms"] = pricer.comm_ms(float(bits))


def summarize(decisions: List[Dict[str, Any]],
              hold_tail: int = 3) -> Dict[str, Any]:
    """Aggregate the decision stream: move counts, final rung/value, and
    a convergence verdict (the last ``hold_tail`` decisions all held)."""
    by_dir: Dict[str, int] = {}
    for d in decisions:
        by_dir[d.get("direction", "?")] = by_dir.get(
            d.get("direction", "?"), 0) + 1
    tail = decisions[-hold_tail:]
    converged = (len(tail) == hold_tail
                 and all(d.get("direction") == "hold" for d in tail))
    last = decisions[-1] if decisions else {}
    return {
        "decisions": len(decisions),
        "by_direction": by_dir,
        "knob": last.get("knob"),
        "final_rung": last.get("rung_to"),
        "final_value": last.get("value_to"),
        "converged": converged,
    }


def _fmt(v: Optional[float], spec: str = "9.2f") -> str:
    return format(v, spec) if isinstance(v, (int, float)) else " " * 6 + "-"


def render_report(events: List[Dict[str, Any]], pricer=None) -> str:
    check_schema(events)
    lines = []
    start = next((e for e in events if e.get("kind") == "run_start"), {})
    ctx = {k: v for k, v in start.items() if k not in ("v", "kind", "ts")}
    lines.append(f"run: {json.dumps(ctx)}")

    decs = decision_rows(events)
    if pricer is not None:
        attach_twin_price(decs, pricer)
        lines.append(f"twin: W={pricer.world} pods={pricer.pods} "
                     f"transport={pricer.transport} "
                     f"calib_rows={pricer.calib_rows}")
    lines.append("")
    lines.append("rung trajectory (one row per closed window):")
    lines.append(f"  {'#':>4}{'applied':>9}{'updates':>9}{'rung':>6}"
                 f"{'value':>9}{'comm ms':>9}"
                 + (f"{'twin ms':>9}" if pricer is not None else "")
                 + f"{'budget ms':>10}{'bits/upd':>11}  move")
    for d in decs:
        move = d.get("direction", "?")
        if move != "hold":
            move += (f" ({d.get('value_from')} -> {d.get('value_to')})")
        lines.append(
            f"  {d.get('index', '?'):>4}{d.get('applied', '?'):>9}"
            f"{d.get('updates', '?'):>9}{d.get('rung_to', '?'):>6}"
            f"{_fmt(d.get('value_to'), '9.4g')}"
            f"{_fmt(d.get('comm_ms'))}"
            + (f"{_fmt(d.get('twin_comm_ms'))}" if pricer is not None
               else "")
            + f"{_fmt(d.get('budget_ms'), '10.2f')}"
            f"{_fmt(d.get('bits'), '11.3g')}  {move}")
    if not decs:
        lines.append("  (no control_decision records — was the run "
                     "launched with --adaptive?)")

    wins = window_rows(events)
    if wins:
        fabric = any("dcn_bits" in r for r in wins)
        lines.append("")
        lines.append("per-window balance (epoch/step records):")
        lines.append(f"  {'window':>8}{'rung':>6}{'value':>9}"
                     f"{'comm ms':>9}{'budget ms':>10}{'decisions':>11}"
                     + (f"{'dcn b/upd':>11}{'ici b/upd':>11}" if fabric
                        else ""))
        for r in wins:
            lines.append(
                f"  {r['window']:>8}{_fmt(r['rung'], '6.0f')}"
                f"{_fmt(r['value'], '9.4g')}{_fmt(r['comm_ms'])}"
                f"{_fmt(r['budget_ms'], '10.2f')}"
                f"{_fmt(r['decisions'], '11.0f')}"
                + (f"{_fmt(r.get('dcn_bits'), '11.3g')}"
                   f"{_fmt(r.get('ici_bits'), '11.3g')}" if fabric else ""))

    s = summarize(decs)
    lines.append("")
    lines.append(
        f"summary: {s['decisions']} decision(s) "
        f"{json.dumps(s['by_direction'])} knob={s['knob']} "
        f"final rung={s['final_rung']} value={s['final_value']} "
        f"converged={s['converged']}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("events", help="JSONL event stream (harness --events)")
    p.add_argument("--json", action="store_true",
                   help="emit decisions/windows/summary as JSON")
    p.add_argument("--twin_records", default=None,
                   help="dir of BENCH/MULTICHIP record files; when given, "
                        "decision rows gain a twin-priced comm column")
    p.add_argument("--twin_world", type=int, default=None,
                   help="override twin topology: data-parallel world size")
    p.add_argument("--twin_pods", type=int, default=None,
                   help="override twin topology: DCN pod count")
    p.add_argument("--twin_transport", default=None,
                   help="override twin transport schedule "
                        "(psum|all_gather|sharded|hierarchical)")
    args = p.parse_args(argv)
    events = read_events(args.events)
    pricer = None
    if args.twin_records is not None:
        pricer = build_pricer(events, args.twin_records,
                              world=args.twin_world, pods=args.twin_pods,
                              transport=args.twin_transport)
    if args.json:
        check_schema(events)
        decs = decision_rows(events)
        if pricer is not None:
            attach_twin_price(decs, pricer)
        print(json.dumps({"decisions": decs,
                          "windows": window_rows(events),
                          "summary": summarize(decs)}, indent=2))
    else:
        print(render_report(events, pricer=pricer))
    return 0


if __name__ == "__main__":
    sys.exit(main())
