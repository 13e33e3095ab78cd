"""Projected multi-GPU time-to-accuracy: the Fig. 3/4 synthesis.

The PyTorch port's counterpart of ``tools/time_to_accuracy.py``, with its
entry points, flags, columns and TSV headers, plus ``--device``.  The
paper's headline is accuracy AND time (the reference quoted
minutes-to-93%-top-5, `IMAGENET/train.py:55-136`).  On one GPU compression
only adds work; its payoff is the W-worker regime where gradient sync rides
a link too slow to hide behind compute.  This tool combines:

  * the convergence grid (``harness/convergence_sweep.py``'s TSV): epochs to
    final accuracy per method x k;
  * measured one-GPU step times + wire payload bytes
    (``bench.sweep.run_point`` on the grid's ResNet-9 / bs 512 / 32 px
    workload, on the card unless ``--device cpu``);
  * the method-aware per-worker traffic model
    (``utils/meters.per_chip_traffic_bytes``: ring psum 2(W-1)/W vs
    all_gather (W-1)x)

into projected wall-clock to reach a target test accuracy at W workers over
the two link classes of :data:`BANDWIDTHS`, plus the crossover bandwidth
below which each method beats dense.  The model's assumptions are printed
into the TSV header (compute-bound 1/W scaling, no overlap, bandwidth-only
links; the sparsity warm-up's larger payloads through
``effective_sent_frac``).

Usage:
    python -m tpu_compressed_dp_torch.harness.time_to_accuracy \\
        --convergence build/convergence_r2.tsv --out build/time_to_accuracy_r4.tsv
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Dict, List, Optional

# (name, bytes/sec per GPU and direction), from NVIDIA's data sheets:
# an NVLink-4 class link, 900 GB/s bidirectional per H100 SXM, taken as
# 450e9 B/s a direction; and the reference's own 25 Gbit/s AWS NIC class
# (`SURVEY.md` §6; its NIC meter measured exactly this link)
BANDWIDTHS = [("nvlink4_450GBps", 450e9), ("nic_25Gbps", 25e9 / 8)]
WORLDS = [8, 32]

STEPS_PER_EPOCH_DEFAULT = 16384 // 512  # the convergence grid's protocol

#: where a run with the defaults reads and writes (never the repository
#: root or ``benchmarks/``)
DEFAULT_CONVERGENCE = "build/convergence_r2.tsv"
DEFAULT_OUT = "build/time_to_accuracy_r4.tsv"
DEFAULT_CACHE = "build/.tta_measure_cache.json"


def parse_tsv(path: str) -> List[Dict[str, str]]:
    rows = []
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines()
                 if ln.strip() and not ln.startswith("#")]
    cols = lines[0].split("\t")
    for ln in lines[1:]:
        rows.append(dict(zip(cols, ln.split("\t"))))
    return rows


def grid_args(label: str):
    """The harness args the convergence grid ran this label with."""
    from tpu_compressed_dp_torch.harness.convergence_sweep import GRID

    for lab, extra in GRID:
        if lab == label:
            return extra
    return None


def arg_val(extra, flag, default=None):
    for i, a in enumerate(extra):
        if a == flag:
            return extra[i + 1]
    return default


def effective_sent_frac(ratio: float, warmup_epochs: int, epochs: int) -> float:
    """Run-averaged sent fraction under the harness's geometric ratio
    warm-up: integrates the harness's own per-epoch schedule
    (``dawn.warmup_ratio_for_epoch``), so the projection cannot drift from
    what the convergence runs sent."""
    from tpu_compressed_dp_torch.harness.dawn import warmup_ratio_for_epoch

    if warmup_epochs <= 0 or ratio >= 1.0:
        return ratio
    total = sum(
        warmup_ratio_for_epoch(e, ratio=ratio, warmup_epochs=warmup_epochs,
                               method="topk")
        for e in range(epochs))
    return total / epochs


def cache_key(label: str, extra, steps: int, warmup: int) -> str:
    """The measure cache's key: the measurement parameters and an md5 of the
    grid point's args, so a ``--steps``/``--warmup`` change or a recipe
    change under an unchanged label re-measures."""
    args_h = hashlib.md5(json.dumps(list(extra)).encode()).hexdigest()[:10]
    return f"{label}@steps={steps},warmup={warmup},args={args_h}"


def measure_row(label: str, extra, cache: dict, steps: int, warmup: int,
                device: str = "cuda"):
    """One-GPU step time + payload split for this grid point's config, on
    the ResNet-9 bs-512 32 px workload (the convergence grid's model).

    Returns ``(record, was_cache_hit)``."""
    key = cache_key(label, extra, steps, warmup)
    if key in cache:
        return cache[key], True
    from tpu_compressed_dp_torch.bench.sweep import run_point

    method = arg_val(extra, "--method")
    rec = run_point(
        model="resnet9", image_size=32, num_classes=10, batch_size=512,
        method=method,
        granularity=arg_val(extra, "--compress", "layerwise"),
        mode=arg_val(extra, "--mode", "simulate"),
        ratio=float(arg_val(extra, "--ratio", 0.01)),
        threshold=float(arg_val(extra, "--threshold", 1e-3)),
        qstates=int(arg_val(extra, "--qstates", 255)),
        error_feedback="--error_feedback" in extra,
        steps=steps, warmup=warmup, device=device,
    )
    cache[key] = rec
    return rec, False


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--convergence", default=DEFAULT_CONVERGENCE)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--target", type=float, default=0.95)
    ap.add_argument("--dense_label", default="dense-step",
                    help="baseline row label (the step-schedule dense control)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--measure_cache", default=DEFAULT_CACHE)
    ap.add_argument("--sensitivity_out", default=None,
                    help="also write a latency x overlap sensitivity TSV: "
                         "speedups vs dense at overlap in {0, 0.5, 1} and "
                         "per-collective latency in {1, 10, 100} us")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where measure_row runs its points: cuda (default; "
                         "raises where there is none) or cpu")
    args = ap.parse_args(argv)

    conv = parse_tsv(args.convergence)
    cache = {}
    if os.path.exists(args.measure_cache):
        with open(args.measure_cache) as f:
            cache = json.load(f)

    steps_pe = STEPS_PER_EPOCH_DEFAULT

    # --- assemble per-row physics -----------------------------------------
    physics = []  # (row, rec, epochs, eff_frac, tc_total_s, bytes_fn)
    for row in conv:
        extra = grid_args(row["label"])
        if extra is None:
            print(f"## skip {row['label']}: not in GRID", file=sys.stderr)
            continue
        rec, hit = measure_row(row["label"], extra, cache, args.steps,
                               args.warmup, device=args.device)
        if not hit:
            os.makedirs(os.path.dirname(os.path.abspath(args.measure_cache)),
                        exist_ok=True)
            with open(args.measure_cache, "w") as f:
                json.dump(cache, f)
        epochs = int(row["epochs"])
        ratio = float(arg_val(extra, "--ratio", 1.0) or 1.0)
        n_w = int(arg_val(extra, "--ratio_warmup_epochs", 0) or 0)
        eff = effective_sent_frac(ratio, n_w, epochs) if ratio < 1.0 else None
        # warm-up epochs send a LARGER payload: scale total traffic by the
        # run-average ratio over the final ratio
        traffic_scale = (eff / ratio) if eff is not None else 1.0
        psum_b = rec.get("payload_mb_psum", rec.get("payload_mb_per_step", 0.0)) * 1e6
        ag_b = rec.get("payload_mb_allgather", 0.0) * 1e6
        a2a_b = rec.get("payload_mb_alltoall", 0.0) * 1e6
        if rec.get("transport") == "all_gather" and "payload_mb_psum" not in rec:
            psum_b, ag_b = 0.0, rec["payload_mb_per_step"] * 1e6
        tc_total = epochs * steps_pe * rec["step_ms"] / 1e3  # one-GPU s
        physics.append(dict(
            row=row, rec=rec, epochs=epochs, eff=eff,
            traffic_scale=traffic_scale, psum_b=psum_b, ag_b=ag_b,
            a2a_b=a2a_b,
            tc_total=tc_total))

    dense = next((p for p in physics if p["row"]["label"] == args.dense_label),
                 None)
    if dense is None:
        raise SystemExit(f"dense baseline {args.dense_label!r} not in grid")

    from tpu_compressed_dp_torch.utils.meters import per_chip_traffic_bytes

    def totals(p, w):
        """(total compute seconds at W, total per-worker traffic bytes at W)."""
        per_step = per_chip_traffic_bytes(p["psum_b"], p["ag_b"], w,
                                          p.get("a2a_b", 0.0))
        return (p["tc_total"] / w,
                p["epochs"] * steps_pe * per_step * p["traffic_scale"])

    def n_collectives(p):
        """Per-step collective count; measured where the sync engine reports
        it, else the static bucket count a dense 25 MB-bucketed sync would
        launch (dense rows carry no comm stats)."""
        nc = p["rec"].get("num_collectives")
        if nc:
            return float(nc)
        model_bytes = p["rec"].get("dense_mb_per_step", 26.0) * 1e6
        return max(1.0, -(-model_bytes // (25 * 1024 * 1024)))

    def wall_at(p, w, bw, lat_s=0.0, overlap=0.0):
        """Projected seconds-to-target with a per-collective latency term and
        an overlap fraction: comm exposed = max(0, comm - overlap * compute).
        overlap=0 is the headline's no-overlap model; overlap=1 perfect
        latency hiding."""
        comp, traffic = totals(p, w)
        comm = traffic / bw + p["epochs"] * steps_pe * n_collectives(p) * lat_s
        return comp + max(0.0, comm - overlap * comp)

    cols = ["label", "method", "ratio", "mode", "epochs", "test_acc",
            "converged", "effective_sent_frac", "step_ms_1chip",
            "payload_mb_psum", "payload_mb_allgather",
            "payload_mb_alltoall"]
    for w in WORLDS:
        for name, _ in BANDWIDTHS:
            cols += [f"wall_min_w{w}_{name}", f"speedup_w{w}_{name}"]
        cols += [f"crossover_gbps_w{w}"]

    out_rows = []
    for p in physics:
        row = p["row"]
        r = {
            "label": row["label"], "method": row["method"],
            "ratio": row["ratio"], "mode": row["mode"],
            "epochs": p["epochs"], "test_acc": row["test_acc"],
            "converged": float(row["test_acc"]) >= args.target,
            "effective_sent_frac": (round(p["eff"], 5)
                                    if p["eff"] is not None else ""),
            "step_ms_1chip": p["rec"]["step_ms"],
            "payload_mb_psum": round(p["psum_b"] / 1e6, 4),
            "payload_mb_allgather": round(p["ag_b"] / 1e6, 4),
            "payload_mb_alltoall": round(p.get("a2a_b", 0.0) / 1e6, 4),
        }
        for w in WORLDS:
            a_m, b_m = totals(p, w)
            a_d, b_d = totals(dense, w)
            for name, bw in BANDWIDTHS:
                wall = a_m + b_m / bw
                wall_d = a_d + b_d / bw
                r[f"wall_min_w{w}_{name}"] = round(wall / 60.0, 2)
                r[f"speedup_w{w}_{name}"] = round(wall_d / wall, 3)
            # crossover: the bandwidth below which this method's wall-clock
            # beats dense's.  wall_m(bw) = A_m + B_m/bw; compression pays
            # more compute (A_m > A_d) to send less (B_m < B_d) and wins
            # exactly when bw < (B_d - B_m) / (A_m - A_d)
            if p is dense:
                r[f"crossover_gbps_w{w}"] = ""
            elif a_m > a_d and b_m < b_d:
                r[f"crossover_gbps_w{w}"] = round(
                    (b_d - b_m) / (a_m - a_d) * 8 / 1e9, 3)
            elif a_m <= a_d and b_m <= b_d:
                r[f"crossover_gbps_w{w}"] = "always"
            else:
                r[f"crossover_gbps_w{w}"] = "never"
        out_rows.append(r)
        print(json.dumps(r), flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        # the reference tool's header, verbatim, so that the two tools'
        # files over one grid and one link table are byte-equal
        f.write(
            "# Projected multi-chip time-to-accuracy (tools/time_to_accuracy.py).\n"
            f"# target test acc {args.target}; rows with converged=False did NOT\n"
            "# reach it — their wall-clock is to their OWN final accuracy and is\n"
            "# not comparable.  PROJECTION assumptions: compute-bound 1/W step\n"
            "# scaling from the measured single-chip step (global batch 512\n"
            "# fixed), no compute/comm overlap, bandwidth-only link model (no\n"
            "# latency term, so layerwise's per-leaf collectives are billed\n"
            "# free of launch overhead).  traffic = method-aware per-chip bytes\n"
            "# (ring psum 2(W-1)/W, all_gather (W-1)x; utils/meters.py).\n"
            "# crossover_gbps_wW: link bandwidth (Gbit/s per chip) below which\n"
            "# the method's projected wall-clock to target beats dense's at W\n"
            "# chips.  effective_sent_frac: run-averaged sent fraction\n"
            "# including sparsity warm-up epochs (VERDICT r3 weak #3).\n")
        f.write("\t".join(cols) + "\n")
        for r in out_rows:
            f.write("\t".join(str(r[c]) for c in cols) + "\n")
    print(f"wrote {args.out} ({len(out_rows)} rows)", file=sys.stderr)

    if not args.sensitivity_out:
        return 0

    # --- latency x overlap sensitivity -------------------------------------
    # The headline projection bills layerwise's per-leaf collectives free of
    # launch overhead and assumes zero overlap, both in compression's
    # favour.  This grid stresses both axes: per-collective latency
    # 1/10/100 us and comm/compute overlap 0/0.5/1.  verdict: "faster" /
    # "slower" when the speedup vs dense stays on one side of 1.0 across all
    # nine combinations, "mixed" when it depends on the assumption.
    lats = [1e-6, 10e-6, 100e-6]
    overlaps = [0.0, 0.5, 1.0]
    scols = ["label", "w", "link", "n_collectives_per_step"]
    for ov in overlaps:
        for lat in lats:
            scols.append(f"speedup_ov{ov:g}_lat{int(lat*1e6)}us")
    scols.append("verdict")
    os.makedirs(os.path.dirname(os.path.abspath(args.sensitivity_out)), exist_ok=True)
    with open(args.sensitivity_out, "w") as f:
        f.write(
            "# Sensitivity of the time-to-accuracy projection to the two\n"
            "# assumptions the headline table fixes at zero: per-collective\n"
            "# launch latency and comm/compute overlap.  speedup = dense\n"
            "# wall-clock / method wall-clock to the same target, with BOTH\n"
            "# sides paying the same latency and enjoying the same overlap\n"
            "# fraction (exposed comm = max(0, comm - overlap*compute)).\n"
            "# verdict: faster/slower = same side of 1.0 at every combo;\n"
            "# mixed = the conclusion depends on the assumption.\n")
        f.write("\t".join(scols) + "\n")
        for p in physics:
            if p is dense:
                continue
            for w in WORLDS:
                for name, bw in BANDWIDTHS:
                    r = {"label": p["row"]["label"], "w": w, "link": name,
                         "n_collectives_per_step": n_collectives(p)}
                    sps = []
                    for ov in overlaps:
                        for lat in lats:
                            sp = (wall_at(dense, w, bw, lat, ov)
                                  / wall_at(p, w, bw, lat, ov))
                            r[f"speedup_ov{ov:g}_lat{int(lat*1e6)}us"] = round(sp, 3)
                            sps.append(sp)
                    r["verdict"] = ("faster" if min(sps) > 1.0 else
                                    "slower" if max(sps) < 1.0 else "mixed")
                    f.write("\t".join(str(r[c]) for c in scols) + "\n")
    print(f"wrote {args.sensitivity_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
