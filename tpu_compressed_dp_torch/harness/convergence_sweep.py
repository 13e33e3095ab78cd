"""Method x ratio convergence grid on the non-saturating synthetic benchmark.

The PyTorch port's counterpart of ``tools/convergence_sweep.py``, with its
grid, columns and flags, plus ``--device``.  The accuracy half of the
reference's Fig. 3/4 protocol (`CIFAR10/dawn.py` sweeps: 24 epochs, 40 for
Randomk/Thresholdv, bs 512, peak lr 0.4 at ep 5) run end-to-end through the
port's dawn harness on ``--synthetic_hard`` data, where weaker optimisation
shows as a lower final score.

Writes one TSV row per grid point: final train/test accuracy + loss, epoch
count, comm fractions, the point's wall seconds.  Runs serially, on the
card unless ``--device cpu``; keep the host otherwise idle for honest wall
times.

Usage:
    python -m tpu_compressed_dp_torch.harness.convergence_sweep
    python -m tpu_compressed_dp_torch.harness.convergence_sweep --quick   # 3-epoch smoke
    python -m tpu_compressed_dp_torch.harness.convergence_sweep --device cpu \\
        --quick --only topk-em-1% --out build/conv_cpu.tsv
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

GRID = [
    # label, harness args (beyond the common protocol)
    ("dense", []),
    ("topk-lw-0.1%", ["--compress", "layerwise", "--method", "topk",
                      "--ratio", "0.001", "--error_feedback"]),
    ("topk-lw-1%", ["--compress", "layerwise", "--method", "topk",
                    "--ratio", "0.01", "--error_feedback"]),
    ("topk-lw-10%", ["--compress", "layerwise", "--method", "topk",
                     "--ratio", "0.1", "--error_feedback"]),
    ("topk-em-1%", ["--compress", "entiremodel", "--method", "topk",
                    "--ratio", "0.01", "--error_feedback"]),
    ("topk-em-1%-wire", ["--compress", "entiremodel", "--method", "topk",
                         "--ratio", "0.01", "--error_feedback",
                         "--mode", "wire"]),
    # the diverger of plain Random-K, stabilised by local + sent clipping
    # (the 40-epoch rule)
    ("randomk-em-1%-wire-EF", ["--compress", "entiremodel", "--method",
                               "randomk", "--ratio", "0.01",
                               "--error_feedback", "--mode", "wire",
                               "--clip_norm", "1.0",
                               "--clip_sent_norm", "1.0"]),
    ("randomk-em-1%-mom0", ["--compress", "entiremodel", "--method",
                            "randomk", "--ratio", "0.01", "--error_feedback",
                            "--momentum", "0.0"]),
    ("randomk-em-10%", ["--compress", "entiremodel", "--method", "randomk",
                        "--ratio", "0.1", "--error_feedback",
                        "--clip_norm", "1.0", "--clip_sent_norm", "1.0"]),
    ("thresholdv-lw", ["--compress", "layerwise", "--method", "thresholdv",
                       "--threshold", "0.001"]),
    ("adaptive-lw", ["--compress", "layerwise", "--method",
                     "adaptive_threshold"]),
    ("qsgd-lw-8bit", ["--compress", "layerwise", "--method", "qsgd",
                      "--qstates", "255"]),
    ("terngrad-em", ["--compress", "entiremodel", "--method", "terngrad"]),
    ("terngrad-lw", ["--compress", "layerwise", "--method", "terngrad"]),
    ("blocktopk-em-1%-wire", ["--compress", "entiremodel", "--method",
                              "blocktopk", "--ratio", "0.01",
                              "--error_feedback", "--mode", "wire"]),
    # the reference's sparsified-DDP operating regime: the ImageNet step
    # schedule (train.py:60-72), momentum 0.9 (train_imagenet_nv.py:49),
    # Random-K + EF (sparsified_ddp.py:408-413), the stable peak ~10x below
    # dense's; dense-step at the same shape is the control
    ("dense-step", ["--lr_schedule", "step", "--peak_lr", "0.4"]),
    # k = 1 %: ~10x lower peak than dense, DGC sparsity warm-up over the
    # first 16 epochs, both clips, 60 epochs
    ("randomk-em-1%-wire-EF-mom9", [
        "--compress", "entiremodel", "--method", "randomk", "--ratio", "0.01",
        "--error_feedback", "--mode", "wire",
        "--lr_schedule", "step", "--peak_lr", "0.04",
        "--epochs", "60", "--ratio_warmup_epochs", "16",
        "--clip_norm", "1.0", "--clip_sent_norm", "1.0"]),
    # k = 10 % needs no warm-up (an EF delay of ~10 steps)
    ("randomk-em-10%-wire-EF-mom9", [
        "--compress", "entiremodel", "--method", "randomk", "--ratio", "0.1",
        "--error_feedback", "--mode", "wire",
        "--lr_schedule", "step", "--peak_lr", "0.04",
        "--clip_norm", "1.0", "--clip_sent_norm", "1.0"]),
    ("topk-em-1%-wire-EF-step", [
        "--compress", "entiremodel", "--method", "topk", "--ratio", "0.01",
        "--error_feedback", "--mode", "wire",
        "--lr_schedule", "step", "--peak_lr", "0.04"]),
    # the paper grid's hardest point, k = 0.1 %: an EF delay of ~1000 steps
    # a coordinate; the k = 1 % recipe with the warm-up stretched
    ("randomk-em-0.1%-wire-EF-mom9", [
        "--compress", "entiremodel", "--method", "randomk", "--ratio", "0.001",
        "--error_feedback", "--mode", "wire",
        "--lr_schedule", "step", "--peak_lr", "0.04",
        "--epochs", "60", "--ratio_warmup_epochs", "16",
        "--clip_norm", "1.0", "--clip_sent_norm", "1.0"]),
    ("topk-em-0.1%-wire-EF-mom9", [
        "--compress", "entiremodel", "--method", "topk", "--ratio", "0.001",
        "--error_feedback", "--mode", "wire",
        "--lr_schedule", "step", "--peak_lr", "0.04",
        "--epochs", "60", "--ratio_warmup_epochs", "16",
        "--clip_norm", "1.0", "--clip_sent_norm", "1.0"]),
    # k = 0.1 % Random-K with the run and the warm-up stretched
    ("randomk-em-0.1%-wire-EF-mom9-long", [
        "--compress", "entiremodel", "--method", "randomk", "--ratio", "0.001",
        "--error_feedback", "--mode", "wire",
        "--lr_schedule", "step", "--peak_lr", "0.04",
        "--epochs", "90", "--ratio_warmup_epochs", "24",
        "--clip_norm", "1.0", "--clip_sent_norm", "1.0"]),
    # the k = 0.1 % operating map's last point: 120 epochs, 32 of warm-up
    ("randomk-em-0.1%-wire-EF-mom9-120ep", [
        "--compress", "entiremodel", "--method", "randomk", "--ratio", "0.001",
        "--error_feedback", "--mode", "wire",
        "--lr_schedule", "step", "--peak_lr", "0.04",
        "--epochs", "120", "--ratio_warmup_epochs", "32",
        "--clip_norm", "1.0", "--clip_sent_norm", "1.0"]),
    # Threshold-V's V sweep: accuracy and sent fraction against V
    # (`CIFAR10/core.py:189-193`); no EF (the reference composes EF only
    # with Random-K), 40 epochs (`dawn.py:105-108`)
    ("thresholdv-lw-V3e-3", ["--compress", "layerwise", "--method",
                             "thresholdv", "--threshold", "0.003"]),
    ("thresholdv-lw-V1e-2", ["--compress", "layerwise", "--method",
                             "thresholdv", "--threshold", "0.01"]),
    ("thresholdv-lw-V3e-2", ["--compress", "layerwise", "--method",
                             "thresholdv", "--threshold", "0.03"]),
    ("thresholdv-lw-V1e-1", ["--compress", "layerwise", "--method",
                             "thresholdv", "--threshold", "0.1"]),
    # Adaptive-threshold: the 40-epoch rule alone, EF alone, both
    ("adaptive-lw-40ep", ["--compress", "layerwise", "--method",
                          "adaptive_threshold", "--epochs", "40"]),
    ("adaptive-lw-EF", ["--compress", "layerwise", "--method",
                        "adaptive_threshold", "--error_feedback"]),
    ("adaptive-lw-EF-40ep", ["--compress", "layerwise", "--method",
                             "adaptive_threshold", "--error_feedback",
                             "--epochs", "40"]),
    # small-block Block-Top-K: the granularity <-> accuracy frontier
    ("blocktopk-em-1%-wire-bs64", ["--compress", "entiremodel", "--method",
                                   "blocktopk", "--ratio", "0.01",
                                   "--block_size", "64",
                                   "--error_feedback", "--mode", "wire"]),
    ("blocktopk-em-1%-wire-bs8", ["--compress", "entiremodel", "--method",
                                  "blocktopk", "--ratio", "0.01",
                                  "--block_size", "8",
                                  "--error_feedback", "--mode", "wire"]),
    # k = 0.1 % at 8-element blocks, under the recipe that closed element
    # Top-K at k = 0.1 %
    ("blocktopk-em-0.1%-wire-bs8-mom9", [
        "--compress", "entiremodel", "--method", "blocktopk",
        "--ratio", "0.001", "--block_size", "8",
        "--error_feedback", "--mode", "wire",
        "--lr_schedule", "step", "--peak_lr", "0.04",
        "--epochs", "60", "--ratio_warmup_epochs", "16",
        "--clip_norm", "1.0", "--clip_sent_norm", "1.0"]),
    # PowerSGD's rank axis at layer-wise grouping, EF on (the factors are a
    # biased projection); wire cost ~r*(m + n/m)/n of dense
    ("powersgd-lw-r1", ["--compress", "layerwise", "--method", "powersgd",
                        "--rank", "1", "--error_feedback"]),
    ("powersgd-lw-r2", ["--compress", "layerwise", "--method", "powersgd",
                        "--rank", "2", "--error_feedback"]),
    ("powersgd-lw-r4", ["--compress", "layerwise", "--method", "powersgd",
                        "--rank", "4", "--error_feedback"]),
    # entire model: one near-square matrix for the whole gradient
    ("powersgd-em-r4", ["--compress", "entiremodel", "--method", "powersgd",
                        "--rank", "4", "--error_feedback"]),
]

COLS = ["label", "method", "ratio", "mode", "epochs", "train_acc", "test_acc",
        "train_loss", "test_loss", "sent_frac", "wire_frac", "total_s"]

#: where a run with the defaults writes (never the repository root or
#: ``benchmarks/``)
DEFAULT_OUT = "build/convergence_r2.tsv"


def point_argv(extra: List[str], *, synthetic_n: int, quick: bool, device: str) -> List[str]:
    """The dawn harness's argv for one grid point: the common protocol, the
    point's own flags, ``--epochs 3`` under ``--quick``, then ``--device``."""
    argv = ["--synthetic_hard", "--synthetic_n", str(synthetic_n),
            "--momentum", "0.9", "--log_dir", ""] + list(extra)
    if quick:
        argv += ["--epochs", "3"]
    return argv + ["--device", device]


def point_row(label: str, extra: List[str], summary: Dict, total_s: float) -> Dict:
    """One TSV row from the harness's final summary."""
    return {
        "label": label,
        "method": next((extra[i + 1] for i, a in enumerate(extra)
                        if a == "--method"), "none"),
        "ratio": next((extra[i + 1] for i, a in enumerate(extra)
                       if a == "--ratio"), ""),
        "mode": "wire" if "--mode" in extra else "simulate",
        "epochs": summary["epoch"],
        "train_acc": round(summary["train acc"], 4),
        "test_acc": round(summary["test acc"], 4),
        "train_loss": round(summary["train loss"], 4),
        "test_loss": round(summary["test loss"], 4),
        "sent_frac": round(summary.get("sent frac", 1.0), 5),
        "wire_frac": round(summary.get("wire frac", 1.0), 5),
        "total_s": round(total_s, 1),
    }


def run_grid(*, synthetic_n: int, quick: bool, only=None, device: str = "cuda") -> List[Dict]:
    """Run the grid's points (those in ``only``, when given) in order."""
    from tpu_compressed_dp_torch.harness import dawn

    rows = []
    for label, extra in GRID:
        if only and label not in only:
            continue
        argv = point_argv(extra, synthetic_n=synthetic_n, quick=quick, device=device)
        print(f"### {label}", flush=True)
        t0 = time.time()
        s = dawn.main(argv)
        row = point_row(label, extra, s, time.time() - t0)
        rows.append(row)
        print({k: row[k] for k in ("label", "test_acc", "train_acc")}, flush=True)
    return rows


def write_tsv(path: str, rows: List[Dict]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\t".join(COLS) + "\n")
        for r in rows:
            f.write("\t".join(str(r[c]) for c in COLS) + "\n")


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--quick", action="store_true", help="3-epoch smoke")
    ap.add_argument("--synthetic_n", type=int, default=16384)
    ap.add_argument("--only", type=str, default=None,
                    help="comma list of labels to run")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises where there is none) or cpu")
    args = ap.parse_args(argv)

    only = set(args.only.split(",")) if args.only else None
    rows = run_grid(synthetic_n=args.synthetic_n, quick=args.quick, only=only,
                    device=args.device)
    write_tsv(args.out, rows)
    print(f"wrote {args.out} ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()
