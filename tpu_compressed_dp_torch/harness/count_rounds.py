"""Per-launch device time of the Top-K threshold search's count rounds: this
tree's kernel (``csrc/count_ge_edges.cu``, one launch a round on the
device-resident state) against a baseline design on the same inputs and the
same 17 edges.

    python -m tpu_compressed_dp_torch.harness.count_rounds --baseline DIR [--out FILE]

``DIR`` is a checkout whose ``tpu_compressed_dp_torch/csrc/count_ge_edges.cu``
exports ``tcdp_count_ge_edges(x, n, edges, counts, stream)``, the flat
16-bin counter that read the whole tensor every round; it is built with the
port's ``nvcc`` flags into ``build/count_rounds/``.  At each size, Top-K 1 %
of |N(0, 1)| magnitudes: every round of this tree's search (full-range: 7
rounds; sampled: the sampled round with its compaction, then 4 refinement
rounds over the candidates) and the baseline on each round's edges over the
whole tensor, as the baseline's search ran it; at sampled sizes also a
refinement round that falls back to the whole tensor (the candidates
disallowed, as after ``b == 0`` or an overflow) and both kernels on spread
quantiles of the whole range.  Device time is CUPTI's (``torch.profiler``),
the mean over launches that cycle through permutations of one tensor (the
same counts, so one search's states serve all of them) together larger
than L2.  The ResNet-9 layer-wise step's total weighs each leaf size by the
leaves of that size.  Needs one CUDA card.
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
# ResNet-9's leaves that the histogram search takes at Top-K 1 % (at least
# 2^16 elements), with how many of each size: layer1, res1 (x2), layer2 and
# layer3 take the full-range search; res3 (x2) the sampled one
RESNET9_LEAVES = {73_728: 1, 147_456: 2, 294_912: 1, 1_179_648: 1, 2_359_296: 2}
ENTIRE_MODEL = 6_573_120
REPS = 200  # launches a reading averages


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def device_ms(fn, reps: int) -> float:
    """Mean CUPTI duration of the ``count_ge_edges_kernel`` launches of
    ``reps`` calls of ``fn``; CUPTI now and then drops a record, so a
    reading with at least 90 % of them stands, and one with fewer is taken
    again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "count_ge_edges_kernel" in e.name]
        if len(us) >= 0.9 * reps:
            return sum(us) / len(us) / 1e3
    raise RuntimeError(f"CUPTI recorded {len(us)} count launches of {reps}")


def build_baseline(tree: str) -> ctypes.CDLL:
    src = os.path.join(tree, "tpu_compressed_dp_torch", "csrc", "count_ge_edges.cu")
    out_dir = os.path.join(os.path.dirname(kernels._BUILD_DIR), "count_rounds")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "count_ge_edges_baseline.so")
    subprocess.run([kernels._nvcc(), *kernels._NVCC_FLAGS, "-o", out, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(out)
    p = ctypes.c_void_p
    lib.tcdp_count_ge_edges.argtypes = [p, ctypes.c_longlong, p, p, p]
    return lib


def equispaced(state: torch.Tensor) -> torch.Tensor:
    """A refinement round's 17 edges from the state's lo and hi, in the
    glue's float32 arithmetic (what the kernel builds on the device)."""
    sf = state.view(torch.float32)
    lo, hi = sf[kernels._ST_LO], sf[kernels._ST_HI]
    width = (hi - lo) / 16
    return torch.cat([lo + width * kernels._bin_index(state.device), hi.reshape(1)])


def time_size(n: int, base: ctypes.CDLL, gen: torch.Generator, reps: int) -> dict:
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.randn(n, generator=gen, device=dev).abs()
    keep = compressors.topk_keep_count(n, RATIO)
    keep_f = float(keep)
    copies = [x] + [x[torch.randperm(n, generator=gen, device=dev)]
                    for _ in range(max(0, math.ceil(120e6 / (4 * n)) - 1))]
    counts = torch.zeros(16, dtype=torch.int32, device=dev)
    s = torch.empty(kernels._STATE_WORDS, dtype=torch.int32, device=dev)
    i = [0]

    def nxt() -> torch.Tensor:
        i[0] += 1
        return copies[i[0] % len(copies)]

    def ours(start, edges=None, cand=None):
        def f():
            s.copy_(start)
            kernels.count_round(nxt(), s, keep_f, edges=edges, cand=cand)
        return f

    def baseline(edges):
        def f():
            v = nxt()
            if base.tcdp_count_ge_edges(v.data_ptr(), n, edges.data_ptr(), counts.data_ptr(),
                                        stream):
                raise RuntimeError("baseline count launch failed")
        return f

    # the search round by round, the state before each round kept
    state = torch.empty_like(s)
    plan = kernels._sample_plan(n, keep)
    rounds = []
    if plan is None:
        kernels.search_init(x.max(), state)
        for r in range(kernels._ROUNDS):
            rounds.append((f"full-range round {r + 1}", state.clone(), None, None, 4 * n))
            kernels.count_round(x, state, keep_f)
    else:
        sv, ranks, cap = kernels._sample_values(x, keep, plan)
        kernels.search_init(x.max(), state, sv, ranks)
        cand = torch.empty(cap, device=dev)
        edges = state.view(torch.float32)[kernels._ST_EDGES:kernels._ST_EDGES + 17].clone()
        start = state.clone()
        kernels.count_round(x, state, keep_f, edges=edges, cand=cand)
        length = int(state[kernels._ST_CAND_LEN])
        rounds.append(("sampled round + compaction", start, edges, cand, 4 * n + 4 * length))
        fallback = state.clone()
        fallback[kernels._ST_CAND_OK] = 0
        for r in range(4):
            rounds.append((f"refinement round {r + 2}, candidates", state.clone(), None, cand,
                           4 * length))
            kernels.count_round(x, state, keep_f, cand=cand)
        if int(state[kernels._ST_CAND_ROUNDS]) != 4:
            raise AssertionError(f"n={n}: the refinement rounds read the whole tensor")
    out = {"n": n, "keep": keep, "rounds": {}}
    for label, start, edges, cand, nbytes in rounds:
        e = edges if edges is not None else equispaced(start)
        out["rounds"][label] = {
            "ms": device_ms(ours(start, edges, cand), reps),
            "baseline_ms": device_ms(baseline(e), reps),
            "bound_ms": (nbytes + 4 * kernels._STATE_WORDS) / HBM_BYTES_PER_S * 1e3}
    out["search_ms"] = sum(r["ms"] for r in out["rounds"].values())
    out["baseline_search_ms"] = sum(r["baseline_ms"] for r in out["rounds"].values())
    if plan is not None:
        out["fallback round, whole tensor"] = {
            "ms": device_ms(ours(fallback, None, cand), reps),
            "baseline_ms": device_ms(baseline(equispaced(fallback)), reps),
            "bound_ms": (4 * n + 4 * kernels._STATE_WORDS) / HBM_BYTES_PER_S * 1e3}
        qs = torch.sort(x[::97]).values
        pos = torch.linspace(0, qs.numel() - 1, 15, device=dev).long()
        spread = torch.cat([torch.zeros(1, device=dev), qs[pos],
                            kernels._hi_bracket(x.max()).reshape(1)]).contiguous()
        zero = torch.zeros_like(s)
        out["spread quantiles"] = {
            "ms": device_ms(ours(zero, spread), reps),
            "baseline_ms": device_ms(baseline(spread), reps),
            "bound_ms": 4 * n / HBM_BYTES_PER_S * 1e3}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", required=True, help="checkout of the baseline design")
    parser.add_argument("--out", default=None, help="write the readings here (JSON)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("count_rounds: needs a CUDA card", file=sys.stderr)
        return 2
    card = nvidia_smi()
    base = build_baseline(args.baseline)
    kernels.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for n in sorted(set(RESNET9_LEAVES) | {ENTIRE_MODEL}):
        r = rows[n] = time_size(n, base, gen, REPS)
        for label, t in list(r["rounds"].items()) + [
                (k, v) for k, v in r.items() if isinstance(v, dict) and "ms" in v]:
            print(f"n={n} {label}: {1e3 * t['ms']:.2f} us, baseline "
                  f"{1e3 * t['baseline_ms']:.2f} us, bound {1e3 * t['bound_ms']:.2f} us",
                  flush=True)
        print(f"n={n} search: {1e3 * r['search_ms']:.2f} us, baseline "
              f"{1e3 * r['baseline_search_ms']:.2f} us", flush=True)
    step = {k: sum(m * rows[n][k] for n, m in RESNET9_LEAVES.items())
            for k in ("search_ms", "baseline_search_ms")}
    print(f"ResNet-9 layer-wise step, count kernels: {1e3 * step['search_ms']:.2f} us, "
          f"baseline {1e3 * step['baseline_search_ms']:.2f} us", flush=True)
    print(card, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "sizes": rows, "resnet9_layerwise_step": step}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
