"""Digital-twin report: calibration, modeled-vs-measured, scale-out, gate.

The PyTorch port's counterpart of ``tools/twin_report.py``: it fits the
per-fabric alpha/beta/gamma cost model (``tpu_compressed_dp_torch/twin/``)
from the BENCH/MULTICHIP records under ``--records`` and renders:

  * the **calibration summary** — fitted alpha (ms), beta (ms/MB), gamma
    (ms/hop) per fabric with the row count that identified each, plus
    the per-context compute anchors;
  * the **modeled-vs-measured tables** — every step row and every
    ``--phase_breakdown`` comm-phase row with its residual, worst first
    flagged;
  * the **scale-out projection** — each measured config re-priced at
    W in {64, 256, 1024, 4096} chips (pods = W / pod_size), i.e. the
    digital-twin answer to "what would this run cost on a real pod
    slice", with a blank where the target fabric has no calibration;
  * the **perf gate** (``--gate --pins FILE``) — every pin in the pins
    file re-priced through the current model, exit 1 on a modeled
    regression beyond tolerance; ``--update_pins`` re-mints every pin at
    the current price.  Both read and write only the ``--pins`` path the
    caller gives; there is no default pins file.

The report is host numpy work and runs on any machine (no card, no
``--device``).  Usage::

    python -m tpu_compressed_dp_torch.harness.twin_report --records DIR
    python -m tpu_compressed_dp_torch.harness.twin_report --records DIR --json
    python -m tpu_compressed_dp_torch.harness.twin_report --gate --pins FILE
    python -m tpu_compressed_dp_torch.harness.twin_report --update_pins --pins FILE
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, List, Optional

from tpu_compressed_dp_torch.twin import (calibration_rows, check_pins, discover_record_paths,
                                          fit, load_pins, load_record_file, make_pin,
                                          save_calibration)

PROJECTION_WORLDS = (64, 256, 1024, 4096)


def projection_rows(paths: List[str], calib, *, pod_size: int = 64
                    ) -> List[Dict[str, Any]]:
    """One projection row per measured step record: the config labeled,
    its measured wall, and the twin's price at each projection world."""
    from tpu_compressed_dp_torch.bench.sweep import attach_prediction

    out: List[Dict[str, Any]] = []
    for path in paths:
        rf = load_record_file(path)
        if rf.shape == "sweep":
            recs = list(rf.raw["records"])
        elif rf.shape == "step":
            recs = [rf.raw["parsed"]]
        else:
            continue
        for i, rec in enumerate(recs):
            if "step_ms" not in rec or "transport" not in rec:
                continue
            rec = dict(rec)
            attach_prediction(rec, calib, pod_size=pod_size)
            knob = rec.get("rank") if rec.get("method") == "powersgd" \
                else rec.get("ratio")
            out.append({
                "source": f"{rf.source}[{i}]",
                "config": "{} {} {} {} W={} pods={}".format(
                    rec.get("model"), rec.get("method"),
                    rec.get("transport"), knob, rec.get("devices"),
                    rec.get("dp_pods", 1)),
                "pallas": rec.get("pallas_mode", "off"),
                "measured_ms": float(rec["step_ms"]),
                "pred_step_ms": rec.get("pred_step_ms"),
                "pred_err_frac": rec.get("pred_err_frac"),
                "pred_err_bar_ms": rec.get("pred_err_bar_ms"),
                **{f"w{w}": rec.get(f"pred_step_ms_w{w}")
                   for w in PROJECTION_WORLDS},
            })
    return out


def _f(v: Optional[float], spec: str = "10.1f") -> str:
    return format(v, spec) if isinstance(v, (int, float)) else \
        " " * (int(spec.split(".")[0]) - 1) + "-"


def _pct(v: float, width: int = 8) -> str:
    """A percentage cell that degrades gracefully: a >10x miss (e.g. a
    phase measured at ~0 ms) renders as a bounded marker, not a
    table-breaking number."""
    if abs(v) > 9.995:
        return format(">999%" if v > 0 else "<-999%", f">{width}")
    return format(v, f"{width}.1%")


def render_calibration(calib) -> List[str]:
    lines = ["calibration (alpha: ms/collective, beta: ms/MB, "
             "gamma: ms/hop):"]
    lines.append(f"  {'fabric':<8}{'alpha':>10}{'beta':>10}{'gamma':>10}"
                 f"{'rows':>6}")
    for fab in sorted(calib.fabrics):
        p = calib.fabrics[fab]
        lines.append(f"  {fab:<8}{p.alpha_ms:>10.3f}"
                     f"{p.beta_ms_per_mb:>10.3f}"
                     f"{p.gamma_ms_per_hop:>10.3f}{p.rows:>6}")
    lines.append(f"  fit: {calib.n_step_rows} step + {calib.n_phase_rows} "
                 f"phase rows over {len(calib.contexts)} contexts, "
                 f"step RMS {calib.step_rms_frac:.1%}")
    return lines


def render_residuals(calib) -> List[str]:
    lines = []
    for kind, title in (("step", "modeled vs measured (step rows)"),
                        ("phase", "modeled vs measured (comm phases)")):
        rows = [r for r in calib.residuals if r.kind == kind]
        if not rows:
            continue
        worst = max(rows, key=lambda r: abs(r.err_frac))
        lines.append("")
        lines.append(f"{title}:")
        lines.append(f"  {'row':<44}{'measured':>10}{'modeled':>10}"
                     f"{'err':>8}")
        for r in rows:
            mark = "  <-- worst" if r is worst else ""
            lines.append(f"  {r.label:<44}{r.measured_ms:>10.1f}"
                         f"{r.modeled_ms:>10.1f}{_pct(r.err_frac)}{mark}")
    return lines


def render_projection(proj: List[Dict[str, Any]]) -> List[str]:
    if not proj:
        return []
    lines = ["", "scale-out projection (modeled step ms; "
             f"pods = W / pod_size; '-' = twin refuses to extrapolate):"]
    lines.append(f"  {'config':<46}{'measured':>10}"
                 + "".join(f"{'W=' + str(w):>13}"
                           for w in PROJECTION_WORLDS))
    for row in proj:
        lines.append(f"  {row['config']:<46}{row['measured_ms']:>10.1f}"
                     + "".join(_f(row.get(f"w{w}"), "13.1f")
                               for w in PROJECTION_WORLDS))
    return lines


def render_gate(results) -> List[str]:
    lines = ["perf gate:"]
    lines.append(f"  {'pin':<36}{'pinned':>10}{'modeled':>10}"
                 f"{'change':>9}{'tol':>6}  verdict")
    for r in results:
        frac = r.frac_change
        lines.append(
            f"  {r.name:<36}{r.pinned_ms:>10.1f}{_f(r.modeled_ms)}"
            + (f"{frac:>9.1%}" if frac is not None else f"{'-':>9}")
            + f"{r.tol_frac:>6.0%}  "
            + ("ok" if r.ok else "FAIL") + f" — {r.note}")
    n_bad = sum(1 for r in results if not r.ok)
    lines.append(f"  {len(results)} pin(s), {n_bad} failing")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--records", default=".",
                   help="dir holding BENCH_r*/MULTICHIP_r* artifacts")
    p.add_argument("--pins", default=None,
                   help="perf-pins file for --gate / --update_pins (required by both)")
    p.add_argument("--pod_size", type=int, default=64,
                   help="chips per pod in the scale-out projection")
    p.add_argument("--json", action="store_true",
                   help="emit the full report as JSON")
    p.add_argument("--gate", action="store_true",
                   help="re-price the pins; exit 1 on any regression")
    p.add_argument("--update_pins", action="store_true",
                   help="re-mint every pin at the current modeled price")
    p.add_argument("--save_calibration", default=None,
                   help="also write the fitted calibration JSON here")
    args = p.parse_args(argv)
    if (args.gate or args.update_pins) and not args.pins:
        p.error("--gate and --update_pins need --pins FILE")

    paths = discover_record_paths(args.records)
    rows = calibration_rows(paths)
    if not rows:
        print(f"no calibration rows under {args.records!r} — are the "
              "BENCH_r*.json artifacts there?", file=sys.stderr)
        return 2
    calib = fit(rows)
    if args.save_calibration:
        save_calibration(calib, args.save_calibration)

    if args.update_pins:
        doc = load_pins(args.pins)
        doc["pins"] = [
            make_pin(pin["name"], pin["point"], pin["context"], calib,
                     tol_frac=float(pin.get("tol_frac",
                                            doc.get("tolerance_frac", 0.10))))
            for pin in doc["pins"]]
        with open(args.pins, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"re-minted {len(doc['pins'])} pin(s) in {args.pins}")
        return 0

    gate_results = None
    if args.gate:
        gate_results = check_pins(load_pins(args.pins), calib)

    proj = projection_rows(paths, calib, pod_size=args.pod_size)

    if args.json:
        doc = {
            "fabrics": {f: fp.to_json() for f, fp in calib.fabrics.items()},
            "contexts": dict(calib.contexts),
            "step_rms_frac": calib.step_rms_frac,
            "n_step_rows": calib.n_step_rows,
            "n_phase_rows": calib.n_phase_rows,
            "residuals": [dict(dataclasses.asdict(r),
                               err_frac=r.err_frac)
                          for r in calib.residuals],
            "projection": proj,
        }
        if gate_results is not None:
            doc["gate"] = [dict(dataclasses.asdict(r),
                                frac_change=r.frac_change)
                           for r in gate_results]
        print(json.dumps(doc, indent=1, sort_keys=True))
    elif args.gate:
        print("\n".join(render_gate(gate_results)))
    else:
        lines = render_calibration(calib)
        lines += render_residuals(calib)
        lines += render_projection(proj)
        print("\n".join(lines))

    if gate_results is not None and any(not r.ok for r in gate_results):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
