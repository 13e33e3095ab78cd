"""Device time of the wire select+pack (``csrc/select_pack.cu``): this tree's
one-pass kernel against another tree's, on the same inputs.

    python -m tpu_compressed_dp_torch.harness.select_pack_bench --baseline DIR \\
        [--sizes resnet9|lm|all] [--out FILE]

``DIR`` is a checkout of the port.  Its
``tpu_compressed_dp_torch/csrc/select_pack.cu`` is built with the port's
``nvcc`` flags into ``build/select_pack_bench/`` and bound by what it
exports: the one-pass entry on a look-back state (from commit d61768c on;
``tcdp_select_pack_state_words`` present) or the three-launch design's
``tcdp_select_pack(x, n, t, keep, vals, idx, count, seg_counts, seg_start,
stream)`` (count, scan and scatter over 4096-element segments, up to commit
5f74006 included).  Inputs: N(0, 1) data at its Top-K 1 %
threshold (``kernels.topk_threshold``), at ResNet-9's wire leaves (the seven
a layer-wise step packs), its entire-model group, at 6.57 M also the
Threshold-V capacity (5 % of n) overflowed (t = 1.5) and underfull (t = 3.0),
and with ``--sizes lm`` the LM's two sync groups.  At each input the two
kernels' outputs must agree bitwise (and with ``fused_select_pack_plain``
below 10 M elements).  The readings: CUPTI device time a call (every kernel
and memset the call enqueues, ``torch.profiler``) and CUDA-event time a call
(the C entry back to back, outputs allocated once, the host's enqueue
included), over inputs cycled past the 50 MB L2, in turns: baseline, this
tree, this tree, baseline.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import torch

from tpu_compressed_dp_torch.ops import compressors, kernels

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
RATIO = 0.01
# ResNet-9's leaves that take the select+pack kernel at Top-K 1 % (at least
# 2^16 elements), with how many of each size: a layer-wise step's 7 launches
RESNET9_LEAVES = {73_728: 1, 147_456: 2, 294_912: 1, 1_179_648: 1, 2_359_296: 2}
ENTIRE_MODEL = 6_573_120
LM_GROUPS = (525_357_056, 961_544_192)
_OUT = os.path.join(os.path.dirname(kernels._BUILD_DIR), "select_pack_bench")


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def _compile(src: str, name: str) -> ctypes.CDLL:
    os.makedirs(_OUT, exist_ok=True)
    out = os.path.join(_OUT, f"{name}.so")
    res = subprocess.run([kernels._nvcc(), *kernels._NVCC_FLAGS, "-o", out, src],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"{name}: {line.strip()}", flush=True)
    return ctypes.CDLL(out)


def build_baseline(tree: str) -> ctypes.CDLL:
    lib = _compile(os.path.join(tree, "tpu_compressed_dp_torch", "csrc", "select_pack.cu"),
                   "baseline")
    if hasattr(lib, "tcdp_select_pack_state_words"):
        return kernels._bind("select_pack", lib)
    p = ctypes.c_void_p
    lib.tcdp_select_pack.argtypes = [p, ctypes.c_longlong, p, ctypes.c_int, p, p, p, p, p, p]
    lib.tcdp_select_pack.restype = ctypes.c_int
    return lib


def ours_launcher(lib, n: int, keep: int):
    """A one-pass C entry with outputs and state allocated once."""
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    vals = torch.empty(keep, device=dev)
    idx = torch.empty(keep, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    state = torch.zeros(lib.tcdp_select_pack_state_words(n), dtype=torch.int64, device=dev)

    def run(x, t):
        if lib.tcdp_select_pack(x.data_ptr(), n, t.data_ptr(), keep, vals.data_ptr(),
                                idx.data_ptr(), count.data_ptr(), state.data_ptr(),
                                state.numel(), stream):
            raise RuntimeError("select_pack launch failed")
        return vals, idx, count
    return run


def base_launcher(lib, n: int, keep: int):
    """The baseline's three-launch C entry with outputs allocated once."""
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    vals = torch.empty(keep, device=dev)
    idx = torch.empty(keep, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(2, -(-n // 4096), dtype=torch.int32, device=dev)

    def run(x, t):
        if lib.tcdp_select_pack(x.data_ptr(), n, t.data_ptr(), keep, vals.data_ptr(),
                                idx.data_ptr(), count.data_ptr(), scratch[0].data_ptr(),
                                scratch[1].data_ptr(), stream):
            raise RuntimeError("baseline select_pack launch failed")
        return vals, idx, count
    return run


def device_ms(run, inputs, reps: int) -> float:
    """Mean CUPTI time a call: every device activity (kernels, memsets) of
    ``reps`` calls cycling through ``inputs``, over ``reps``."""
    from torch.profiler import ProfilerActivity, profile

    for x, t in inputs[:2]:
        run(x, t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            run(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(us) / reps / 1e3


def event_ms(run, inputs, reps: int) -> float:
    """CUDA-event time a call over ``reps`` back-to-back calls (best of 3)."""
    for x, t in inputs[:2]:
        run(x, t)
    best = math.inf
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for i in range(reps):
            run(*inputs[i % len(inputs)])
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best


def _same(a, b) -> bool:
    """Equal bits, the count compared as one int32 whatever its shape."""
    return all(torch.equal(u.reshape(-1).view(torch.int32), w.reshape(-1).view(torch.int32))
               for u, w in zip(a, b))


def time_case(n: int, keep: int, inputs, base, ours) -> dict:
    bound = (4 * n + 4 + 8 * keep + 4) / HBM_BYTES_PER_S * 1e3
    x0, t0 = inputs[0]
    want = [r.clone() for r in base(x0, t0)]
    got = ours(x0, t0)
    if not _same(got, want):
        raise AssertionError(f"n={n} keep={keep}: the kernel differs from the baseline")
    if n < 10_000_000 and not _same(got, kernels.fused_select_pack_plain(x0, t0, keep)):
        raise AssertionError(f"n={n} keep={keep}: the kernel differs from the plain version")
    reps = max(20, min(400, int(2e9 / (4 * n))))
    row = {"n": n, "keep": keep, "count": int(got[2].item()), "bound_ms": bound}
    for key, run in (("baseline", base), ("ours", ours), ("ours", ours), ("baseline", base)):
        row.setdefault(f"{key}_device_ms", []).append(device_ms(run, inputs, reps))
        row.setdefault(f"{key}_event_ms", []).append(event_ms(run, inputs, reps))
    return row


def run_size(n: int, gen, base_lib, cap: bool) -> dict:
    dev = torch.device("cuda")
    keep = compressors.topk_keep_count(n, RATIO)
    copies = max(1, math.ceil(120e6 / (4 * n)))
    xs = [torch.randn(n, generator=gen, device=dev) for _ in range(copies)]
    t = kernels.topk_threshold(xs[0].abs(), keep)
    cases = {"topk 1 %": (keep, [(x, t) for x in xs])}
    if cap:
        c = int(round(0.05 * n))
        for label, v in (("thresholdv overflow", 1.5), ("thresholdv underfull", 3.0)):
            tv = torch.full((), v, device=dev)
            cases[label] = (c, [(x, tv) for x in xs])
    out = {}
    for label, (k, inputs) in cases.items():
        ours = ours_launcher(kernels._lib("select_pack"), n, k)
        base = (ours_launcher if hasattr(base_lib, "tcdp_select_pack_state_words")
                else base_launcher)(base_lib, n, k)
        r = out[label] = time_case(n, k, inputs, base, ours)
        print(f"n={n} {label} (keep {k}, count {r['count']}): device us ours "
              f"{', '.join(f'{1e3 * v:.2f}' for v in r['ours_device_ms'])}, baseline "
              f"{', '.join(f'{1e3 * v:.2f}' for v in r['baseline_device_ms'])}; events ours "
              f"{', '.join(f'{1e3 * v:.2f}' for v in r['ours_event_ms'])}, baseline "
              f"{', '.join(f'{1e3 * v:.2f}' for v in r['baseline_event_ms'])}; bound "
              f"{1e3 * r['bound_ms']:.2f}", flush=True)
    del xs, cases
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", required=True, help="checkout of the baseline design")
    parser.add_argument("--sizes", choices=("resnet9", "lm", "all"), default="all")
    parser.add_argument("--out", default=None, help="write the readings here (JSON)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("select_pack_bench: needs a CUDA card", file=sys.stderr)
        return 2
    card = nvidia_smi()
    print(card, flush=True)
    base_lib = build_baseline(args.baseline)
    kernels.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sizes = []
    if args.sizes in ("resnet9", "all"):
        sizes += sorted(RESNET9_LEAVES) + [ENTIRE_MODEL]
    if args.sizes in ("lm", "all"):
        sizes += list(LM_GROUPS)
    rows = {n: run_size(n, gen, base_lib, cap=n == ENTIRE_MODEL) for n in sizes}
    step = {}
    if args.sizes in ("resnet9", "all"):
        for key in ("ours_device_ms", "baseline_device_ms"):
            step[key] = sum(m * min(rows[n]["topk 1 %"][key]) for n, m in RESNET9_LEAVES.items())
        print(f"ResNet-9 layer-wise wire step, select_pack: device us ours "
              f"{1e3 * step['ours_device_ms']:.2f}, baseline "
              f"{1e3 * step['baseline_device_ms']:.2f}", flush=True)
    print(card, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "sizes": {str(n): r for n, r in rows.items()},
                       "resnet9_layerwise_step": step}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
