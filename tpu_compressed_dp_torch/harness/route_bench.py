"""Device time of the sharded transport's bucket route (``csrc/bucket_route.cu``)
and the byte packers (``csrc/byte_pack.cu``): this tree's against another
tree's, on the same inputs.

    python -m tpu_compressed_dp_torch.harness.route_bench --baseline DIR \\
        [--sizes resnet9|lm|all] [--out FILE]

``DIR`` is a checkout of the port.  Each tree runs in a worker process of its
own (this file with ``--worker TREE``, the tree's package first on the
path), which builds the tree's ``bucket_route.cu`` and ``byte_pack.cu`` with
its own ``nvcc`` flags into the tree's ``build/torch_kernels/`` and measures,
in turns of worker: baseline, this tree, this tree, baseline.

  * The route call, as ``sharded_combine``'s kernel path makes it: the
    tree's ``kernels.route_buckets`` where it has one (one launch), else
    ``wire_sharded._per_dest_slots`` followed by ``kernels.fused_bucket_route``
    (the elementwise passes, the starts counted twice, then the window
    copy).  CUPTI device time a call (every kernel and memset it enqueues,
    summed) and host time a call (back to back, closed by a synchronise).
  * The route kernel alone, through the tree's C entry with outputs
    allocated once (the baseline's ``tcdp_bucket_route`` with its starts
    counted beforehand): CUPTI and CUDA-event time a call.
  * The QSGD and ternary byte packers through their C entries: CUPTI and
    CUDA-event time a call.

Inputs, made from one seed in every worker: ascending distinct payload
indices and N(0, 1) values at ResNet-9's entire-model Top-K 1 % (k = 65,732
of 6,573,120) and, with ``--sizes lm``, the LM's two sync groups (k =
5,253,571 / 9,615,442), at W = 2 and 4 (caps ``make_shard_plan``'s at the
route factor 1.25); full-range int16 levels and ternary int8 levels at the
same group sizes.  Inputs are cycled past the 50 MB L2 where one copy does
not fill it (the 6.57 M payload stays in L2, as select+pack leaves it).  The
two trees' outputs (buckets, indices, ``accepted``; magnitudes, signs,
ternary bytes) must have the same digest.  Bounds: the bytes at 3.35 TB/s.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
ENTIRE_MODEL = 6_573_120
LM_GROUPS = (525_357_056, 961_544_192)
RATIO = 0.01
WORLDS = (2, 4)
_TURNS = ("base", "ours", "ours", "base")


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def device_ms(torch, run, inputs, reps: int) -> float:
    """Mean CUPTI time a call: every device activity of ``reps`` calls
    cycling through ``inputs``, summed, over ``reps``."""
    from torch.profiler import ProfilerActivity, profile

    for inp in inputs[:2]:
        run(inp)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            run(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(us) / reps / 1e3


def event_ms(torch, run, inputs, reps: int) -> float:
    """CUDA-event time a call over ``reps`` back-to-back calls (best of 3)."""
    for inp in inputs[:2]:
        run(inp)
    best = math.inf
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for i in range(reps):
            run(inputs[i % len(inputs)])
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best


def host_ms(torch, run, inputs, reps: int) -> float:
    """Host time a call over ``reps`` back-to-back calls closed by one
    synchronise (best of 3)."""
    for inp in inputs[:2]:
        run(inp)
    best = math.inf
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            run(inputs[i % len(inputs)])
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3 / reps)
    return best


def digest(torch, outs, chunk: int = 1 << 26) -> list:
    """A digest of each output's bytes: its bytes weighted by a fixed
    pseudo-random sequence of their positions, summed in int64."""
    out = []
    for o in outs:
        words, total = o.reshape(-1).view(torch.uint8), 0
        for lo in range(0, words.numel(), chunk):
            w = words[lo:lo + chunk].long()
            k = torch.arange(lo, lo + w.numel(), device=w.device, dtype=torch.int64)
            total += int(((w + 0x9E3779B1) * (k * 0x5851F42D + 0x14057B7E) % (1 << 31)).sum())
        out.append(total)
    return out


def _route_payloads(torch, gen, n: int, k: int, copies: int):
    dev = torch.device("cuda")
    out = []
    for _ in range(copies):
        idx = torch.randperm(n, generator=gen, device=dev)[:k].sort().values.to(torch.int32)
        out.append((torch.randn(k, generator=gen, device=dev), idx))
    return out


def route_rows(torch, kernels, wire_sharded, gen, n: int) -> dict:
    """The route call and the route kernel of the tree at one group size."""
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    lib = kernels._lib("bucket_route")
    one_launch = hasattr(kernels, "route_buckets")
    k = max(1, math.ceil(RATIO * n))
    big = n != ENTIRE_MODEL
    payloads = _route_payloads(torch, gen, n, k, 2 if big else 1)
    reps = 20 if big else 200
    rows = {}
    for w in WORLDS:
        plan = wire_sharded.make_shard_plan(n, k, w, 1, 1.25, 1.25)
        cap, shard_n = plan.cap_dest, plan.shard_n

        def route(p):
            if one_launch:
                return kernels.route_buckets(p[0], p[1], None, w, cap, shard_n)
            _, accepted, dest = wire_sharded._per_dest_slots(p[1], None, plan)
            return kernels.fused_bucket_route(p[0], p[1], dest, w, cap, shard_n) + (accepted,)

        bv = torch.empty(w, cap, device=dev)
        bi = torch.empty(w, cap, dtype=torch.int32, device=dev)
        acc = torch.empty(k, dtype=torch.bool, device=dev)
        if one_launch:
            def kernel(p):
                if lib.tcdp_route_buckets(p[0].data_ptr(), p[1].data_ptr(), None, None, k, w,
                                          cap, shard_n, bv.data_ptr(), bi.data_ptr(),
                                          acc.data_ptr(), stream):
                    raise RuntimeError("route_buckets launch failed")
            kernel_inputs = payloads
        else:
            # the window copy alone: its starts counted beforehand
            kernel_inputs = [p + (kernels.route_starts(
                wire_sharded._per_dest_slots(p[1], None, plan)[2], w),) for p in payloads]

            def kernel(p):
                if lib.tcdp_bucket_route(p[0].data_ptr(), p[1].data_ptr(), p[2].data_ptr(), w,
                                         cap, shard_n, bv.data_ptr(), bi.data_ptr(), stream):
                    raise RuntimeError("bucket_route launch failed")
        got = route(payloads[0])
        starts = kernels.route_starts(wire_sharded._per_dest_slots(payloads[0][1], None,
                                                                   plan)[2], w)
        taken = int(torch.clamp(starts[1:] - starts[:-1], max=cap).sum().item())
        rows[f"route n={n} W={w}"] = {
            "k": k, "W": w, "cap": cap, "digest": digest(torch, got),
            "bound_ms": (8 * taken + 8 * w * cap + k) / HBM_BYTES_PER_S * 1e3,
            "call_device_ms": device_ms(torch, route, payloads, reps),
            "call_host_ms": host_ms(torch, route, payloads, reps),
            "kernel_device_ms": device_ms(torch, kernel, kernel_inputs, reps),
            "kernel_event_ms": event_ms(torch, kernel, kernel_inputs, reps)}
        del got, bv, bi, acc, kernel_inputs
    del payloads
    torch.cuda.empty_cache()
    return rows


def byte_rows(torch, kernels, gen, n: int) -> dict:
    """The QSGD and ternary byte packers' C entries at one size."""
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    lib = kernels._lib("byte_pack")
    copies = max(1, math.ceil(120e6 / (2 * n)))
    q = [torch.randint(-32768, 32768, (n,), generator=gen, device=dev, dtype=torch.int16)
         for _ in range(copies)]
    t = [torch.randint(-1, 2, (n,), generator=gen, device=dev, dtype=torch.int8)
         for _ in range(max(1, math.ceil(120e6 / n)))]
    mags = torch.empty(n, dtype=torch.uint8, device=dev)
    signs = torch.empty(-(-n // 8), dtype=torch.uint8, device=dev)
    tern = torch.empty(-(-n // 4), dtype=torch.uint8, device=dev)

    def qsgd(lv):
        if lib.tcdp_qsgd_pack_bytes(lv.data_ptr(), n, mags.data_ptr(), signs.data_ptr(), stream):
            raise RuntimeError("qsgd_bytes launch failed")

    def ternary(lv):
        if lib.tcdp_pack_ternary_bytes(lv.data_ptr(), n, tern.data_ptr(), stream):
            raise RuntimeError("ternary_bytes launch failed")

    reps = 20 if n > ENTIRE_MODEL else 200
    rows = {}
    for name, run, inputs, outs, nbytes in (
            ("qsgd_bytes", qsgd, q, (mags, signs), 2 * n + n + -(-n // 8)),
            ("ternary_bytes", ternary, t, (tern,), n + -(-n // 4))):
        run(inputs[0])
        rows[f"{name} n={n}"] = {
            "digest": digest(torch, outs), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "kernel_device_ms": device_ms(torch, run, inputs, reps),
            "kernel_event_ms": event_ms(torch, run, inputs, reps)}
    del q, t, mags, signs, tern
    torch.cuda.empty_cache()
    return rows


def worker(tree: str, sizes) -> dict:
    sys.path.insert(0, tree)
    import torch

    from tpu_compressed_dp_torch.ops import kernels, wire_sharded

    if not kernels.__file__.startswith(os.path.join(os.path.abspath(tree), "")):
        raise RuntimeError(f"imported {kernels.__file__}, not {tree}'s package")
    # this bench's two sources only
    kernels._SOURCES = ("bucket_route", "byte_pack")
    kernels.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for n in sizes:
        rows.update(route_rows(torch, kernels, wire_sharded, gen, n))
        rows.update(byte_rows(torch, kernels, gen, n))
    return rows


def run_worker(tree: str, sizes: str) -> dict:
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                          "--sizes", sizes], cwd=tree, capture_output=True, text=True,
                         timeout=1200)
    if res.returncode:
        raise RuntimeError(f"the worker for {tree} failed:\n{res.stdout[-3000:]}"
                           f"{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", help="checkout of the baseline tree")
    parser.add_argument("--sizes", choices=("resnet9", "lm", "all"), default="all")
    parser.add_argument("--out", default=None, help="write the readings here (JSON)")
    parser.add_argument("--worker", default=None, metavar="TREE",
                        help="internal: time TREE's kernels and print the readings")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("route_bench: needs a CUDA card", file=sys.stderr)
        return 2
    sizes = ([ENTIRE_MODEL] if args.sizes in ("resnet9", "all") else []) + (
        list(LM_GROUPS) if args.sizes in ("lm", "all") else [])
    if args.worker:
        print(json.dumps(worker(os.path.abspath(args.worker), sizes)))
        return 0
    if not args.baseline:
        parser.error("--baseline is required")
    card = nvidia_smi()
    print(card, flush=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    trees = {"ours": here, "base": os.path.abspath(args.baseline)}
    rows = {}
    for key in _TURNS:
        for label, r in run_worker(trees[key], args.sizes).items():
            row = rows.setdefault(label, {"bound_ms": r["bound_ms"], "digest": {}})
            row["digest"][key] = r["digest"]
            for m in ("call_device_ms", "call_host_ms", "kernel_device_ms", "kernel_event_ms"):
                if m in r:
                    row.setdefault(f"{key}_{m}", []).append(r[m])
    differ = []
    for label, row in rows.items():
        row["equal"] = row["digest"]["ours"] == row["digest"]["base"]
        if not row["equal"]:
            differ.append(label)
        parts = []
        for m in ("call_device_ms", "call_host_ms", "kernel_device_ms", "kernel_event_ms"):
            if f"ours_{m}" in row:
                parts.append(f"{m[:-3]} us ours "
                             f"{', '.join(f'{1e3 * v:.2f}' for v in row[f'ours_{m}'])}, baseline "
                             f"{', '.join(f'{1e3 * v:.2f}' for v in row[f'base_{m}'])}")
        print(f"{label}: {'; '.join(parts)}; bound {1e3 * row['bound_ms']:.3f}; outputs "
              f"{'equal' if row['equal'] else 'DIFFER'}", flush=True)
    print(card, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    if differ:
        raise AssertionError(f"the trees' outputs differ at {differ}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
