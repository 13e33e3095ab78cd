"""Measured-vs-analytic transport validation.

The PyTorch port's counterpart of ``tools/validate_transport.py``, with its
cases, worker/main split, idle control window and TSV columns, plus
``--device``.  The paper MEASURED network traffic at the NIC
(`IMAGENET/training/meter.py:24-47,66-86`); the sweep's transport numbers
are analytic (``utils/meters.per_fabric_traffic_bytes`` over the
``sent_bits_*`` each sync bills).  This tool closes the loop: it runs a
real W-process data-parallel sync over gloo, counts the bytes each rank
really sends around a timed window of sync steps, and compares them with the
analytic model.

The measured side is each rank's OWN count: the ``wchar`` of
``/proc/self/io`` (bytes the process handed to ``write``-family calls,
gloo's socket writes included) around the timed window and around an idle
window of the same length, with nothing else written by the process in
between; rank 0 sums the ranks' counts.  No other process's traffic can
enter it, where the reference's system-wide loopback counter takes in every
neighbour's.  Expect a ratio slightly above 1 (gloo's framing); the claims
are the slope and the order (dense > terngrad > topk-1%).

On the card the ranks' tensors live on ``cuda:0`` and gloo copies them
through host memory: the bytes are real, but no link is timed.

Usage:
    python -m tpu_compressed_dp_torch.harness.validate_transport
    python -m tpu_compressed_dp_torch.harness.validate_transport --device cpu --steps 10
(spawns its own worker processes; their store ports come from
``parallel/mesh.free_port``)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

N_PARAM = 2_000_000        # synthetic gradient size (fp32: 8 MB dense payload)

CASES = [
    # label, method, mode, ratio/extra
    ("dense", None, "simulate", {}),
    ("topk-1%-wire-EF", "topk", "wire", {"ratio": 0.01, "error_feedback": True}),
    ("blocktopk-1%-wire-EF", "blocktopk", "wire",
     {"ratio": 0.01, "error_feedback": True, "block_size": 256}),
    # owner-sharded transport: the all_to_all route stage bills at
    # (W-1)/W x payload per rank, the shard-return all_gather at (W-1) x;
    # the sent_bits_alltoall bucket closes the loop for the third collective
    ("topk-1%-wire-EF-sharded", "topk", "wire",
     {"ratio": 0.01, "error_feedback": True, "transport": "sharded"}),
    # hierarchical transport at 2 pods of one process each (no intra-pod
    # sum), so the measured bytes are exactly the inter-pod route / return
    # collectives the sent_bits_dcn bucket bills
    ("topk-1%-wire-EF-hier", "topk", "wire",
     {"ratio": 0.01, "error_feedback": True, "transport": "hierarchical",
      "dp_pods": 2}),
    ("terngrad-wire", "terngrad", "wire", {}),
]

BITS_KEYS = ("sent_bits", "sent_bits_psum", "sent_bits_allgather", "sent_bits_alltoall",
             "sent_bits_ici", "sent_bits_dcn", "sent_bits_dcn_route")

CASE_TIMEOUT_S = 600.0     # a case's ranks, start to exit

#: where a run with the defaults writes (never the repository root or
#: ``benchmarks/``)
DEFAULT_OUT = "build/transport_validation_r5.tsv"

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def written_bytes() -> int:
    """This process's bytes written so far (``wchar`` of ``/proc/self/io``:
    every thread of the process, sockets included, and the children it has
    reaped)."""
    with open("/proc/self/io") as f:
        for line in f:
            if line.startswith("wchar:"):
                return int(line.split()[1])
    raise RuntimeError("/proc/self/io has no wchar line")


def case_config(label: str):
    """The case's ``CompressionConfig`` (entire model, the case's method,
    mode, ratio, block size, transport, pods and EF)."""
    from tpu_compressed_dp_torch.parallel.dp import CompressionConfig

    _, method, mode, extra = next(c for c in CASES if c[0] == label)
    return CompressionConfig(
        method=method, granularity="entiremodel", mode=mode,
        ratio=extra.get("ratio", 0.01),
        block_size=extra.get("block_size", 256),
        transport=extra.get("transport", "allgather"),
        dp_pods=extra.get("dp_pods", 1),
        error_feedback=extra.get("error_feedback", False))


def case_gradient(rank: int, procs: int, n_param: int):
    """Rank ``rank``'s synthetic gradient: ``[1, n_param // procs]`` float32
    standard normals from ``default_rng(rank)``, as the reference draws it."""
    import numpy as np

    rng = np.random.default_rng(rank)
    return rng.standard_normal((1, n_param // procs)).astype(np.float32)


def worker(args) -> None:
    """Rank entry: a gloo process group of ``--procs`` ranks, one warm-up
    sync, then ``--steps`` timed syncs and an idle window of the same
    length, each counted by this process's own written bytes."""
    import torch

    from tpu_compressed_dp_torch.ops import kernels
    from tpu_compressed_dp_torch.parallel import mesh
    from tpu_compressed_dp_torch.parallel.dp import make_grad_sync

    dev = mesh.resolve_device(args.device)
    mesh.init_process_group(dev, backend="gloo", init_method=f"tcp://localhost:{args.port}",
                            world_size=args.procs, rank=args.rank)
    try:
        cfg = case_config(args.case)
        sync = make_grad_sync(cfg)
        g = {"g": torch.from_numpy(case_gradient(args.rank, args.procs, args.n_param)).to(dev)}
        ef = {"g": torch.zeros_like(g["g"])} if cfg.error_feedback else ()
        kernels.reset_launches()
        # warm-up; the identical seed on every rank (the shared-seed
        # contract wire Random-K and the quantizers' dither rely on)
        out, ef, stats = sync(g, ef, 7)
        stats = {k: float(v) for k, v in stats.items()}

        def done():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        done()
        # timed window, then an idle window of the same length, each read
        # around itself; nothing else is written by this process in between
        t0, b0 = time.perf_counter(), written_bytes()
        for _ in range(args.steps):
            out, ef, _ = sync(g, ef, 7)
        done()
        dt = time.perf_counter() - t0
        tx = written_bytes() - b0
        b0 = written_bytes()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < dt:
            time.sleep(0.01)
        tx_idle = written_bytes() - b0
        # rank 0 sums the ranks' counts (and their kernel launches)
        names = sorted(kernels.LAUNCHES)
        total = mesh.all_reduce_sum(torch.tensor(
            [tx, tx_idle] + [kernels.LAUNCHES[k] for k in names], dtype=torch.float64,
            device=dev)).tolist()
        if args.rank == 0:
            rec = {
                "case": args.case,
                "steps": args.steps,
                "lo_tx_per_step": (total[0] - total[1]) / args.steps,
                "lo_tx_idle_window": total[1],
                **{k: stats.get(k, 0.0) for k in BITS_KEYS},
                "launches": {k: int(v) for k, v in zip(names, total[2:])},
            }
            print("RESULT " + json.dumps(rec), flush=True)
    finally:
        mesh.destroy()


def run_case(label: str, *, n_param: int, steps: int, procs: int, device: str,
             port: Optional[int] = None) -> Optional[dict]:
    """Spawn the case's ``procs`` ranks and return rank 0's RESULT record
    (None, with rank 0's output on stderr, where a worker failed)."""
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    port = free_port() if port is None else port
    procs_ = []
    for rank in range(procs):
        cmd = [sys.executable, "-m", "tpu_compressed_dp_torch.harness.validate_transport",
               "--worker", "--rank", str(rank), "--case", label, "--steps", str(steps),
               "--procs", str(procs), "--port", str(port), "--device", device,
               "--n_param", str(n_param)]
        procs_.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True, cwd=_REPO))
    # communicate() drains the pipes while waiting: wait()-then-read
    # deadlocks once a worker logs past the pipe buffer
    try:
        outs = [p.communicate(timeout=CASE_TIMEOUT_S)[0] for p in procs_]
    finally:
        for p in procs_:
            if p.poll() is None:
                p.kill()
                p.wait()
    rc = [p.returncode for p in procs_]
    if any(rc):
        print(f"## {label}: worker failed rc={rc}\n" + outs[0][-2000:], file=sys.stderr)
        return None
    rec = None
    for o in outs:
        for ln in o.splitlines():
            if ln.startswith("RESULT "):
                rec = json.loads(ln[len("RESULT "):])
    if rec is None:
        print(f"## {label}: no RESULT line\n" + outs[0][-2000:], file=sys.stderr)
    return rec


def analytic_row(label: str, rec: dict, procs: int) -> Dict:
    """The TSV row of one case: the analytic bytes a step summed over the
    ranks, against the measured ones.  Ring all-reduce: each rank sends
    2(W-1)/W x payload; all_gather of worker-distinct payloads: its own
    payload (W-1) times; all_to_all (the sharded route stage): (W-1)/W x
    payload (each rank keeps its own bucket)."""
    from tpu_compressed_dp_torch.utils.meters import per_fabric_traffic_bytes

    extra = next(c for c in CASES if c[0] == label)[3]
    w = procs
    psum_b = rec["sent_bits_psum"] / 8.0
    ag_b = rec["sent_bits_allgather"] / 8.0
    a2a_b = rec.get("sent_bits_alltoall", 0.0) / 8.0
    ici_b = rec.get("sent_bits_ici", 0.0) / 8.0
    dcn_b = rec.get("sent_bits_dcn", 0.0) / 8.0
    rt_b = rec.get("sent_bits_dcn_route", 0.0) / 8.0
    if psum_b == ag_b == a2a_b == 0.0 and ici_b + dcn_b == 0.0:
        psum_b = rec["sent_bits"] / 8.0
    pods = extra.get("dp_pods", 1)
    # per_fabric degenerates to the flat per-worker arithmetic at pods = 1;
    # at pods > 1 the hierarchical group collectives bill with their own
    # factors
    per_rank = sum(per_fabric_traffic_bytes(
        psum_b, ag_b, w, a2a_b, ici_b, rt_b, max(dcn_b - rt_b, 0.0), pods))
    analytic = per_rank * w
    measured = rec["lo_tx_per_step"]
    return {
        "case": label,
        "analytic_bytes_per_step_all_ranks": round(analytic, 1),
        "measured_lo_tx_bytes_per_step": round(measured, 1),
        "ratio_measured_over_analytic": round(measured / analytic, 3)
        if analytic else "",
        "idle_window_bytes": rec["lo_tx_idle_window"],
        "steps": rec["steps"],
    }


def validate(*, n_param: int = N_PARAM, steps: int = 30, procs: int = 2,
             device: str = "cuda", cases: Optional[Sequence[str]] = None,
             port: Optional[int] = None) -> Tuple[List[Dict], List[Dict]]:
    """Run every case (or those named in ``cases``, in ``CASES`` order);
    returns the TSV rows and the ranks' records.  A failed case is reported
    on stderr and left out, as in the reference."""
    rows, recs = [], []
    for ci, (label, _, _, _) in enumerate(CASES):
        if cases is not None and label not in cases:
            continue
        rec = run_case(label, n_param=n_param, steps=steps, procs=procs, device=device,
                          port=None if port is None else port + ci)
        if rec is None:
            continue
        recs.append(rec)
        rows.append(analytic_row(label, rec, procs))
        print(rows[-1], flush=True)
    return rows, recs


def write_tsv(path: str, rows: List[Dict], procs: int) -> None:
    cols = list(rows[0].keys()) if rows else []
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(
            f"# Measured (per-process bytes written) vs analytic transport, {procs}-process\n"
            "# gloo data-parallel sync "
            "(tpu_compressed_dp_torch/harness/validate_transport.py).\n"
            "# measured = each rank's own /proc/self/io wchar over the timed\n"
            "# window, its idle window's subtracted, summed over the ranks\n"
            "# (column names kept from the loopback-counter reference);\n"
            "# analytic = per_fabric_traffic_bytes x ranks (the same\n"
            "# arithmetic every sweep / time-to-accuracy row bills).  Ratio > 1\n"
            "# = framing overhead; the claims are (a) the ratio stable across\n"
            "# methods, (b) the method order kept.  Reference: meter.py:24-47,66-86.\n")
        f.write("\t".join(cols) + "\n")
        for r in rows:
            f.write("\t".join(str(r[c]) for c in cols) + "\n")


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--port", type=int, default=None,
                    help="first case's store port (default: mesh.free_port() a case)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; every rank on the current card, raises where "
                         "there is none) or cpu")
    # worker-mode internals
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--case", type=str, default="dense")
    ap.add_argument("--n_param", type=int, default=N_PARAM, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)
    rows, _ = validate(n_param=N_PARAM, steps=args.steps, procs=args.procs,
                       device=args.device, port=args.port)
    write_tsv(args.out, rows, args.procs)
    print(f"wrote {args.out} ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()
