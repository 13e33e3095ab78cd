#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``tpu_compressed_dp_torch``).

Run from the root of the repository: ``python3 chip_smoke.py [--record FILE]``.
It needs one CUDA card and the CUDA toolkit (``nvcc``), and exits non-zero,
printing no result, where either is missing or any phase fails.

  1. prints the card's name and power limit, builds the CUDA kernels from
     ``tpu_compressed_dp_torch/csrc`` with ``nvcc`` and prints the build time
     of each source and each kernel's registers and spill stores;
  2. holds every kernel against its plain PyTorch version on the card, at the
     shapes of full-width ResNet-9 (the 2,359,296-element layer3 residual
     conv and the 6,573,120-element entire model): histogram counts and
     thresholds exactly equal, fused sparsify bitwise; Philox uniforms, QSGD
     and TernGrad levels bitwise (NaN, +-Inf and a zero vector included),
     uniforms on the 2^-24 grid with mean 0.5 +- 1e-3, both quantizers
     unbiased within 3 sigma; the wire kernels bitwise: select+pack on a
     Top-K threshold, Threshold-V capacities that overflow and underfill,
     Block-Top-K scores, a Random-K mask, NaN / +-Inf and zeros; TernGrad and
     QSGD quantize+pack, whose unpacked bytes are the level kernels' levels;
     the sharded transport's one-launch bucket route (buckets, indices and
     ``accepted``; values as bits) at the full-width geometries
     (entire-model Top-K at W = 2 / 4 / 8, the hierarchical Threshold-V
     slab across 2 pods) and at the LM's payloads (k = 5,253,571 /
     9,615,442 at W = 2 and 4), with a dump-bucket tail, overflowing and
     empty buckets, -0.0, NaN and +-Inf, one kernel a route call; the threshold
     search (one launch a round on a device-resident state, the sampled
     round keeping the candidates the later rounds count) bitwise against
     the unfused glue on the plain counts and, state word for word, the CPU
     search; then times each kernel (CUDA events, after warm-up, inputs
     cycled past the 50 MB L2) beside its plain version, its bound and a
     library call, and the search's passes (its own sampled edges, the
     refinement bracket over the whole tensor and over the candidates,
     spread quantiles as the worst case) by CUPTI device time;
     Then (2b) holds the four kernels no default path dispatches, as in the
     reference, bitwise against their plain versions: the threshold pack at
     the entire-model size at Top-K 1 %, at block rows 16 and 512, ragged,
     in the overflow regimes (a threshold keeping ~99 %, one keeping twice
     keep) and on NaN / +-Inf / -0.0 data, EF on and off; the segmented pack
     and its payload likewise (a threshold overflowing every segment's
     128-slot cap); both packs at the edges of their one-pass units
     (source blocks, 65,536-element units, segments, misaligned views,
     truncation at block 0 and inside a unit, a keep cut inside a tile),
     back to back on one stream and on a second, each one launch a call; the
     ternary and QSGD byte packers on the level kernels' levels and the full
     int8 / int16 ranges, the QSGD one also on views at every element offset
     from a 16-byte boundary and every n % 32; and times each through its C
     entry (CUDA events, and CUPTI) beside its plain version, its bound and
     a yardstick; (2c) holds both packs and the QSGD byte packer at the LM's
     group sizes and times them there; (2d)
     holds the threshold
     search as above at the LM's group sizes and at n = 2^25 (counts past
     2^24), times its passes there and ``select_pack`` through its C entry;
  3. trains full-width ResNet-9 through the port's DAWNBench entry point
     (``harness.dawn.main``), 4 steps of batch 512 on a 1-rank NCCL group,
     at layerwise and at entiremodel granularity, in simulate mode with
     Top-K 1 % + EF, Random-K 1 % + EF, Threshold-V + EF,
     Adaptive-Threshold + EF, TernGrad and QSGD (s = 255), and in wire mode
     with those and Block-Top-K, at bucketed granularity (25 MB) too; every
     kernel's launch counter is zeroed just
     before each run and read just after; checks finite loss, the sent and
     wire fractions (wire mode: exactly the payload layout's, from the leaf
     sizes) and that the run's kernels ran;
  4. times steady-state steps and the gradient sync alone (dense, Top-K,
     Random-K, TernGrad and QSGD at both granularities, and wire Top-K + EF,
     TernGrad and QSGD), with a profile;
  5. runs W = 2 and then W = 4 ranks on the one card: worker processes
     (this script with ``--rank_worker``) joined by gloo, which takes CUDA
     tensors (NCCL refuses two ranks on one device).  Each world syncs
     seeded full-width ResNet-9 gradients (different per rank) with Top-K
     1 % + EF, Threshold-V + EF and Block-Top-K 1 % + EF at layerwise and
     entiremodel over the allgather, sharded and hierarchical (2 pods)
     transports: at lossless capacity factors sharded equals allgather
     bitwise and hierarchical within 1e-6 with no clips; at the default
     factors the clips show in ``shard_overflow`` and the world mean of
     ``acc - new_ef`` is the synced gradient; the measured ``sent_bits_*``
     are the analytic ones.  It times the sync alone (gloo through host
     memory on one card: not a link timing), then trains 2 full-width
     steps through ``dawn.main``: wire Top-K sharded at W = 2, wire
     Threshold-V hierarchical (2 pods) at W = 4, each with a finite loss,
     the analytic wire fraction and the bucket-route kernel launched;
  6. holds the causal flash-attention kernels (forward, dq, dk/dv; bf16 on
     the tensor cores, float32 on the CUDA cores) against
     their plain versions at llama3_8b's attention shape (1, 32, 8192, 128)
     in bf16 and float32 and at the 125M config's (8, 12, 1024, 64) in bf16
     (elementwise: float32 to 1e-4, lse to 1e-5, bf16 to one ulp of each
     element plus a share of the tensor's rms, see ``hold_close``), runs a
     GQA call (32 query, 8 KV heads) through ``ring_attention`` against the
     unfused attention, and times each kernel beside its plain version, its
     bound (causal FLOPs at the bf16 tensor-core or float32 rate) and
     ``scaled_dot_product_attention``, and the bf16 dq and dk/dv again on
     concentrated attention (q scaled 4x);
  7. trains llama3_8b at its published widths, cut to 2 layers, seq 8192,
     batch 1, bf16, through the port's LM entry point (``harness.lm.main``),
     4 steps each: dense, entire-model and layer-wise Top-K 1 % + EF, and
     entire-model wire Top-K 1 % + EF; the launch counters are zeroed just
     before each run and read just after: each flash kernel runs exactly
     twice a step (once per layer), the fused head + cross-entropy takes the
     loss every step, the Top-K kernels ran; checks finite loss and the sent
     fraction against the groups' keep counts, and prints step time, tokens/s,
     MFU and peak memory; then, with ``kernels._SEG_PACK_DISPATCH`` set (off
     by default, as in the reference), runs the gated segmented wire Top-K
     path through both entry points: dawn (entire-model wire Top-K 1 % + EF,
     4 steps of batch 512) and the LM (the wire Top-K run above): the
     segmented pack launches once a step per group and select+pack never,
     with step time and sent fraction beside the default wire path's; then
     profiles two steady Top-K steps, with the threshold search's full and
     refinement passes and the sparsify kernel per launch at each sync
     group's size; (7c) the LM's other mesh axes as gloo ranks on the card
     (run right after the build, while the card's memory is free), 3 steps
     of entire-model Top-K 1 % + EF through ``harness.lm.main`` each:
     ``--dp 1 --tp 2`` (2 layers, seq 8192: equal finite losses, each flash
     kernel twice a step on each rank at 16/4 local heads, the Top-K kernels
     on both signature groups, the replicated parameters bitwise equal
     across the ranks) and ``--dp 1 --sp 2 --remat`` (``LM_SP_LAYERS`` /
     ``LM_SP_SEQ``, which fit two whole models on the card; no flash launch:
     the unfused ring, as in JAX; first one layer's ring attention, forward
     and q/k/v gradients, held against the whole sequence's unfused
     attention) and ``--pp 2 --microbatches 2`` (the GPipe step, one layer
     a stage, batch 2: equal finite losses, each flash kernel ``M + S - 1``
     = 3 times a step on each rank, the Top-K kernels on both signature
     groups, the pipe-replicated parameters bitwise equal across the
     stages), with the Top-K kernels held against their plain versions at
     every rank's group sizes; then at phase 7's one-rank config PowerSGD r
     4 + EF entire-model and layer-wise (finite loss, the analytic sent
     fraction) and one sync at ``sync_overlap`` 4 bitwise the one at 1
     (entire-model and layer-wise), then ``--overlap 4`` steps; step ms,
     tok/s, MFU and peak GiB of each; (7d) phase 7's config with 8 experts
     (Mixtral 8x7B's count and FFN width) on every second layer at capacity
     factor 1.25, dense and layer-wise Top-K 1 % + EF (each flash kernel
     twice a step, the Top-K kernels launched), with step ms, tok/s, MFU,
     peak GiB and the share of one batch's tokens past capacity;
  8. trains full-width bf16 ResNet-50 (25,557,032 parameters, 1000 classes)
     through the port's ImageNet entry point (``harness.imagenet.main``) on
     synthetic ImageNet, the port's loaders and native crop-resize, one
     epoch in each of the reference's per-GPU phases (128 px / batch 512,
     224 px / 224, 288 px / 128 with rect val), dense and layer-wise Top-K
     1 % + EF, with zeroed and read launch counters; (8b) times steady steps
     at 224 px / batch 224 from a device-resident batch (dense; Top-K 1 % +
     EF layer-wise and entire-model; Random-K 1 % + EF layer-wise at
     ``--overlap`` 1 and 4; wire entire-model Top-K) with the sync alone,
     peak memory, idle share, launches per step and MFU; (8c) at the
     entire-model group's 25,557,032 elements holds the search (and the
     ``count >= keep`` contract), the fused sparsify and select+pack bitwise
     to their plain versions, and holds ``sync_overlap = 4`` bitwise to 1 on
     the card (one sync, then 2 steps) at W = 1, and (phase 5's W = 2
     workers) across 2 gloo ranks;
  9. prints the kernels' JSON line (18 entries), the ``nvidia-smi``
     name/power line and, last, ``{"ok": true, "device": {...}}``.

``--record FILE`` also writes the full record (every timing, the profiles)
as JSON.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
# integer issue ceiling: each SM issues at most one warp instruction per
# scheduler per clock (128 lanes), the lanes the fp32 rate counts (an FMA as
# two operations): 67e12 / 2.  Integer multiplies run on those FMA lanes.
INT_OPS_PER_S = 33.5e12
# Philox4x32-10 per element: 10 rounds of 2 32x32->64 multiplies and 4 xors
# per 4 words (the key schedule is the same for every element)
PHILOX_OPS_PER_ELEM = 15.0
FULL_LEAF = 2_359_296       # layer3 residual conv, the largest ResNet-9 leaf
FULL_MODEL = 6_573_120      # every ResNet-9 parameter, the entire-model group
RATIO = 0.01


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, inputs, *, reps: int = 15, inner: int = 10) -> float:
    """Median per-call ms of ``fn(inp)``, CUDA events around ``inner`` calls
    cycling over ``inputs`` (together larger than L2), after warm-up."""
    import torch

    for i in range(3):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(inner):
            fn(inputs[i % len(inputs)])
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / inner)
    samples.sort()
    return samples[len(samples) // 2]


def bound_ms(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _demangle(mangled: str) -> str:
    """``flash_dkv_tc_kernel<128>`` from its Itanium name: the last of the
    length-prefixed names after ``_ZN``, with an element type and an int
    template argument, a bool one, or a class of int arguments
    (``select_pack_kernel<Tiling<512, 8, 0, 3>>``), where there are (enough
    for this repo's kernels)."""
    import re

    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    args = re.match(r"I(f|13__nv_bfloat16)?Li(\d+)E", mangled[i:])
    if args:
        dtype = {"f": "float, ", "13__nv_bfloat16": "bf16, "}.get(args.group(1) or "", "")
        name += f"<{dtype}{args.group(2)}>"
    flag = re.match(r"ILb([01])E", mangled[i:])
    if flag:
        name += "<true>" if flag.group(1) == "1" else "<false>"
    # a class template argument of int arguments, as select_pack's Tiling
    cls = re.match(r"INS_\d+([A-Za-z_]+?)I((?:Li\d+E)+)E", mangled[i:])
    if cls:
        name += f"<{cls.group(1)}<{', '.join(re.findall(r'Li(\d+)E', cls.group(2)))}>>"
    return name


def ptxas_report(text: str) -> dict:
    """Registers and spill stores per kernel from ``nvcc -Xptxas -v``:
    ``{"flash_dkv_tc_kernel<128>": {"registers": 255, "spill_stores": 0}}``
    (template arguments: the element type where there is one, then D)."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = _demangle(m.group(1))
            out[name] = {"registers": None, "spill_stores": None}
        elif name and "spill stores" in line:
            out[name]["spill_stores"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def raw_launchers(kernels, torch, n: int):
    """The kernels' C entry points with outputs allocated once (timing only;
    these launches are not counted)."""
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    comp, ef = torch.empty(n, device=dev), torch.empty(n, device=dev)
    sent = torch.zeros(1, dtype=torch.int32, device=dev)
    c_round = kernels._lib("count_ge_edges").tcdp_count_round
    c_fused = kernels._lib("fused_sparsify").tcdp_fused_sparsify

    def count(x, state, keep_f, edges=None, cand=None):
        if c_round(x.data_ptr(), x.numel(), None if edges is None else edges.data_ptr(),
                   state.data_ptr(), None if cand is None else cand.data_ptr(),
                   0 if cand is None else cand.numel(), keep_f, stream):
            raise RuntimeError("count_ge_edges launch failed")

    def fused(x, t):
        if c_fused(x.data_ptr(), n, t.data_ptr(), comp.data_ptr(), ef.data_ptr(),
                   sent.data_ptr(), stream):
            raise RuntimeError("fused_sparsify launch failed")

    return count, fused


def first_round(kernels, torch, x, keep: int):
    """A sampled search's first state and candidate buffer for ``x``."""
    state = torch.empty(kernels._STATE_WORDS, dtype=torch.int32, device=x.device)
    sv, ranks, cap = kernels._sample_values(x, keep, kernels._sample_plan(x.numel(), keep))
    kernels.search_init(x.max(), state, sv, ranks)
    edges = state.view(torch.float32)[kernels._ST_EDGES:kernels._ST_EDGES + 17]
    return state, edges, torch.empty(cap, device=x.device)


def count_passes(kernels, torch, x, keep: int, count, reps: int) -> dict:
    """The threshold search's passes over ``x`` through the C entry, CUPTI
    device ms each (the state reset before a launch is a copy, not counted):
    the sampled round on the search's own edges with its compaction, a
    refinement round over the whole tensor on the bracket it narrows to, the
    same round over the candidates, and a count at spread quantiles of the
    whole range (15 of a sorted strided subsample, the worst case: nearly
    every element in the window).  Each beside its bound (the bytes this
    data makes it read and write); also the candidates and the capacity."""
    dev = x.device
    n, keep_f = x.numel(), float(keep)
    first, edges, cand = first_round(kernels, torch, x, keep)
    after = first.clone()
    count(x, after, keep_f, edges, cand)
    length = int(after[kernels._ST_CAND_LEN])
    qs = torch.sort(x[::97]).values
    pos = torch.linspace(0, qs.numel() - 1, 15, device=dev).long()
    spread = torch.cat([torch.zeros(1, device=dev), qs[pos],
                        kernels._hi_bracket(x.max()).reshape(1)]).contiguous()
    zero = torch.zeros(kernels._STATE_WORDS, dtype=torch.int32, device=dev)
    s = torch.empty_like(zero)

    def run(start, **kw):
        def f(_):
            s.copy_(start)
            count(x, s, keep_f, **kw)
        return f

    passes = {"sampled round + compaction": (run(first, edges=edges, cand=cand),
                                             4 * n + 4 * length),
              "refinement round, whole tensor": (run(after), 4 * n),
              "refinement round, candidates": (run(after, cand=cand), 4 * length),
              "spread quantiles": (run(zero, edges=spread), 4 * n)}
    out = {"n": n, "candidates": length, "capacity": cand.numel()}
    for label, (fn, nbytes) in passes.items():
        fn(None)
        ms = device_kernel_ms(torch, fn, "count_ge_edges_kernel", n=reps)
        b = bound_ms(nbytes + 4 * kernels._STATE_WORDS, 0)[0]
        out[label] = {"ms": ms, "bound_ms": b, "share": b / ms if ms else None}
    return out


def check_search(kernels, torch, mag, keep: int, label: str) -> dict:
    """The whole threshold search: auto mode (the kernels, a device-resident
    state) vs the unfused glue on the plain counts, on the card, and vs the
    CPU search in force mode (the plain rounds), whose final state must equal
    the card's word for word; the threshold keeps >= keep."""
    t_k = kernels.topk_threshold(mag, keep)
    state = kernels._hist_search(mag, keep)
    t_p = kernels._topk_threshold_hist(
        mag, keep, count_fn=kernels.count_ge_edges_plain)
    host = mag.cpu()
    kernels.set_pallas_mode("force")
    try:
        t_cpu = kernels.topk_threshold(host, keep)
        state_cpu = kernels._hist_search(host, keep)
    finally:
        kernels.set_pallas_mode("auto")
    del host
    t_s = state.view(torch.float32)[kernels._ST_LO]
    bits = {t.view(torch.int32).item() for t in (t_k, t_s, t_p, t_cpu)}
    if len(bits) != 1 or not torch.equal(state.cpu(), state_cpu):
        raise AssertionError(f"threshold differs at {label}: kernels {t_k.item()}, plain "
                             f"{t_p.item()}, cpu {t_cpu.item()}; states equal: "
                             f"{torch.equal(state.cpu(), state_cpu)}")
    cnt = int((mag >= t_k).sum().item())
    if cnt < keep:
        raise AssertionError(f"threshold keeps {cnt} < {keep} at {label}")
    out = {"t": t_k.item(), "kept": cnt, "sampled": kernels._sample_plan(mag.numel(), keep)
           is not None, "candidate_rounds": int(state[kernels._ST_CAND_ROUNDS]),
           "candidates": int(state[kernels._ST_CAND_LEN])}
    log(f"threshold {label} keep={keep}: t={out['t']:.9g} bitwise == plain glue (card) and "
        f"the CPU search (state word for word), kept {cnt} (surplus {cnt - keep}), sampled "
        f"first round: {out['sampled']}, rounds over the candidates: "
        f"{out['candidate_rounds']} ({out['candidates']} candidates)")
    if out["sampled"] and out["candidate_rounds"] != 4:
        raise AssertionError(f"the sampled search at {label} read the whole tensor in "
                             f"{5 - out['candidate_rounds']} rounds, want 1")
    return out


def log_passes(p: dict, card: str) -> None:
    for label, r in p.items():
        if isinstance(r, dict):
            log(f"time n={p['n']} count_ge_edges {label}: {r['ms']:.4f} ms device, bound "
                f"{r['bound_ms']:.4f} ms ({100 * r['share']:.1f} %) on {card}")
    log(f"time n={p['n']}: {p['candidates']} candidates, capacity {p['capacity']}")


def phase_kernels(kernels, compressors, torch, record):
    """Kernel vs plain on the card, then timings."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"count_ge": 0.0, "count_edges": 0.0, "search_init": 0.0, "fused_sparsify": 0.0}
    rows = {}
    for n in (FULL_LEAF, FULL_MODEL):
        mag = torch.randn(n, generator=gen, device=dev).abs()
        keep = compressors.topk_keep_count(n, RATIO)
        hi = mag.max() * 1.0000002 + 1e-30
        width = hi / 16
        equi = torch.cat([width * torch.arange(16, device=dev, dtype=torch.float32),
                          hi.reshape(1)])
        lo2, hi2 = equi[1], equi[3]  # a later round's narrowed range
        equi2 = torch.cat([lo2 + (hi2 - lo2) / 16 * torch.arange(16, device=dev,
                                                                 dtype=torch.float32),
                           hi2.reshape(1)])
        qs = torch.sort(mag[::97]).values
        pos = torch.linspace(0, qs.numel() - 1, 15, device=dev).long()
        quant = torch.cat([torch.zeros(1, device=dev), qs[pos], hi.reshape(1)])
        for route, edges in (("count_ge", equi), ("count_ge", equi2), ("count_edges", quant)):
            state = kernels.new_search_state(dev)
            kernels.count_round(mag, state, 0.0, edges=edges)
            got = state[kernels._ST_LAST_COUNTS:kernels._ST_LAST_COUNTS + 16]
            want = kernels.count_ge_edges_plain(mag, edges)
            d = (got.long() - want.long()).abs().max().item()
            err[route] = max(err[route], float(d))
            if d != 0:
                raise AssertionError(f"count_ge_edges ({route}) differs from plain at n={n}: "
                                     f"{got.tolist()} vs {want.tolist()}")
        # the search's first state, full-range and sampled: bitwise == plain
        sv, ranks, _ = kernels._sample_values(mag, keep, kernels._sample_plan(n, keep))
        for args in ((), (sv, ranks)):
            got = torch.empty(kernels._STATE_WORDS, dtype=torch.int32, device=dev)
            want = torch.empty_like(got)
            kernels.search_init(mag.max(), got, *args)
            kernels.search_init_plain(mag.max(), want, *args)
            d = (got.view(torch.float32) - want.view(torch.float32)).abs().nan_to_num().max()
            err["search_init"] = max(err["search_init"], d.item())
            if not torch.equal(got, want):
                raise AssertionError(f"search_init differs from plain at n={n}")
        check_search(kernels, torch, mag, keep, f"n={n}")
        # fused sparsify, bitwise, with a real threshold and with t = 0 on zeros
        acc = torch.randn(n, generator=gen, device=dev)
        acc[::1000] = 0.0
        for t in (kernels.topk_threshold(acc.abs(), keep), torch.zeros((), device=dev)):
            for want_ef in (True, False):
                c, e, s = kernels.fused_sparsify(acc, t, want_ef=want_ef)
                c2, e2, s2 = kernels.fused_sparsify_plain(acc, t, want_ef)
                ok = (torch.equal(c.view(torch.int32), c2.view(torch.int32))
                      and s.item() == s2.item()
                      and (not want_ef or torch.equal(e.view(torch.int32), e2.view(torch.int32))))
                diffs = [(c - c2).abs().max().item(), abs(s.item() - s2.item())]
                if want_ef:
                    diffs.append((e - e2).abs().max().item())
                err["fused_sparsify"] = max(err["fused_sparsify"], *diffs)
                if not ok:
                    raise AssertionError(f"fused_sparsify differs from plain at n={n}")
        log(f"fused_sparsify n={n}: comp, ef and count bitwise == plain")

        # timings at this shape; inputs cycled past L2 (50 MB).  "ms" launches
        # the kernel through its C entry with outputs allocated once, so the
        # device, not the host's per-call work, sets the pace; "wrapper_ms"
        # is the Python wrapper (checks, output allocation, launch)
        copies = max(2, math.ceil(120e6 / (4 * n)))
        mags = [torch.randn(n, generator=gen, device=dev).abs() for _ in range(copies)]
        accs = [torch.randn(n, generator=gen, device=dev) for _ in range(copies)]
        t_acc = kernels.topk_threshold(accs[0].abs(), keep)
        raw_count, raw_fused = raw_launchers(kernels, torch, n)
        lib = time_ms(lambda x: torch.topk(x, keep).values[-1], mags)
        thr = time_ms(lambda x: kernels._topk_threshold_hist(x, keep), mags)
        # the main path's two kinds of round, each on its input's own search:
        # the sampled round over the whole tensor (its compaction included)
        # and a refinement round over the candidates; "events_ms" through the
        # C entry, "wrapper_ms" through count_round, "plain_ms" the plain
        # round, each with the state reset before it
        searches = []
        for x in mags:
            first, edges, cand = first_round(kernels, torch, x, keep)
            after = first.clone()
            raw_count(x, after, float(keep), edges, cand)
            searches.append((x, first, edges, after, cand))
        scratch = torch.empty_like(searches[0][1])
        launchers = {
            "ms": raw_count,
            "wrapper_ms": lambda x, st, kf, edges=None, cand=None: kernels.count_round(
                x, st, kf, edges=edges, cand=cand),
            "plain_ms": lambda x, st, kf, edges=None, cand=None: kernels.count_round_plain(
                x, st, kf, edges=edges, cand=cand)}

        def sampled(count):
            def f(p):
                x, first, edges, _, cand = p
                scratch.copy_(first)
                count(x, scratch, float(keep), edges, cand)
            return f

        def refine(count):
            def f(p):
                x, _, _, after, cand = p
                scratch.copy_(after)
                count(x, scratch, float(keep), cand=cand)
            return f

        # "ms": CUPTI device time of the kernel alone on mags[0]'s search
        # (count_passes; the events' time would add the state reset and the
        # host's enqueue), its bound from that search's candidates
        passes = count_passes(kernels, torch, mags[0], keep, raw_count, 100)
        timed = {k: {**{f"events_{k2}" if k2 == "ms" else k2: time_ms(f(c), searches)
                        for k2, c in launchers.items()},
                     "ms": passes[label]["ms"],
                     "bound": (passes[label]["bound_ms"], "bytes"), "library_ms": lib}
                 for k, f, label in (("count_edges", sampled, "sampled round + compaction"),
                                     ("count_ge", refine, "refinement round, candidates"))}
        mx0, st0 = mags[0].max(), torch.empty_like(scratch)
        sv0, ranks0, _ = kernels._sample_values(mags[0], keep, kernels._sample_plan(n, keep))
        c_init = kernels._lib("count_ge_edges").tcdp_search_init
        stream = torch.cuda.current_stream().cuda_stream

        def init_raw(_):
            if c_init(mx0.data_ptr(), sv0.data_ptr(), ranks0.data_ptr(), st0.data_ptr(),
                      kernels._HI_MUL, kernels._HI_ADD, stream):
                raise RuntimeError("search_init launch failed")

        init_raw(None)
        row = {
            **timed,
            # reads the max, 15 ranks and sample values, writes the state
            "search_init": {
                "ms": device_kernel_ms(torch, init_raw, "search_init_kernel", n=100),
                "wrapper_ms": time_ms(lambda _: kernels.search_init(mx0, st0, sv0, ranks0),
                                      [None]),
                "plain_ms": time_ms(lambda _: kernels.search_init_plain(mx0, st0, sv0, ranks0),
                                    [None]),
                "bound": bound_ms(4 + 15 * (8 + 4) + 4 * kernels._STATE_WORDS, 0),
                "library_ms": None},
            "fused_sparsify": {
                "ms": time_ms(lambda x: raw_fused(x, t_acc), accs),
                "wrapper_ms": time_ms(lambda x: kernels.fused_sparsify(x, t_acc), accs),
                "plain_ms": time_ms(lambda x: kernels.fused_sparsify_plain(x, t_acc), accs),
                "bound": bound_ms(12 * n + 8, 4 * n), "library_ms": None},
            "threshold_ms": thr, "topk_ms": lib,
            "passes": passes,
        }
        del searches
        rows[n] = row
        log_passes(row["passes"], record["card"])
        for name in ("count_ge", "count_edges", "search_init", "fused_sparsify"):
            r = row[name]
            lib_txt = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            events = f", events {r['events_ms']:.4f} ms" if "events_ms" in r else ""
            log(f"time n={n} {name}: {r['ms']:.4f} ms{events} (wrapper {r['wrapper_ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound'][0]:.4f} ms by {r['bound'][1]}, library {lib_txt})")
        log(f"time n={n} topk_threshold (all rounds + glue): {thr:.4f} ms; "
            f"torch.topk(mag, {keep}).values[-1]: {lib:.4f} ms")
        del mags, accs
    record["kernel_errors"] = err
    record["kernel_times"] = {str(n): r for n, r in rows.items()}
    return err, rows


def raw_dither(kernels, torch, n: int, seed: int):
    """The dither kernels' C entry points with outputs allocated once
    (timing only; these launches are not counted)."""
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    lib = kernels._lib("dither")
    u = torch.empty(n, device=dev)
    q = torch.empty(n, dtype=torch.int16, device=dev)
    t = torch.empty(n, dtype=torch.int8, device=dev)

    def check(rc, name):
        if rc:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")

    return (lambda _: check(lib.tcdp_uniform(u.data_ptr(), n, seed, stream), "uniform"),
            lambda xi: check(lib.tcdp_qsgd_levels(xi[0].data_ptr(), n, xi[1].data_ptr(), seed,
                                                  255, q.data_ptr(), stream), "qsgd"),
            lambda xi: check(lib.tcdp_terngrad_levels(xi[0].data_ptr(), n, xi[1].data_ptr(),
                                                      seed, t.data_ptr(), stream), "terngrad"))


def _within_3_sigma(torch, est, g, p, scale, what):
    """Mean of ``est - g`` against 3 sigma of the dither's own variance:
    each element rounds up with probability ``p`` by one level of
    ``scale``."""
    err = (est.double() - g.double()).mean().item()
    sigma = (scale.double() ** 2 * (p * (1 - p))).sum().sqrt().item() / g.numel()
    if not abs(err) <= 3 * sigma:
        raise AssertionError(f"{what} is biased: mean error {err:.3e} vs 3 sigma {3 * sigma:.3e}")
    return err, sigma


def phase_dither(kernels, torch, record):
    """Philox uniforms and the QSGD / TernGrad kernels vs their plain
    versions on the card, their contracts, then timings."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    err = {"uniform": 0.0, "qsgd": 0.0, "terngrad": 0.0}
    rows, checks = {}, {}
    seed = 0x243F6A8885A308D3
    for n in (FULL_LEAF, FULL_MODEL):
        u = kernels.uniform(seed, n, dev)
        if not torch.equal(u, kernels.uniform(seed, n, dev)):
            raise AssertionError(f"uniform is not deterministic in its seed at n={n}")
        if torch.equal(u, kernels.uniform(seed + 1, n, dev)):
            raise AssertionError(f"uniform ignores its seed at n={n}")
        d = (u - kernels.uniform_plain(seed, n, dev)).abs().max().item()
        err["uniform"] = max(err["uniform"], d)
        if d != 0 or not torch.equal(u, kernels.uniform_plain(seed, n, dev)):
            raise AssertionError(f"uniform differs from plain at n={n}")
        scaled = u * (1 << 24)
        mean = u.double().mean().item()
        if not (torch.equal(scaled, scaled.floor()) and u.min().item() >= 0.0
                and u.max().item() < 1.0 and abs(mean - 0.5) <= 1e-3):
            raise AssertionError(f"uniform off its 24-bit grid or mean {mean} at n={n}")
        g = torch.randn(n, generator=gen, device=dev) * 1e-2
        poisoned = g.clone()
        poisoned[::997] = float("nan")
        poisoned[1::1009] = float("inf")
        poisoned[2::1013] = -float("inf")
        zeros = torch.zeros(n, device=dev)
        for what, x in (("finite", g), ("nan/inf", poisoned), ("zeros", zeros)):
            finite = torch.where(torch.isfinite(x), x, 0.0)
            invs = (kernels._safe_inv(torch.linalg.vector_norm(finite)),
                    kernels._safe_inv(finite.abs().max()),
                    torch.ones((), device=dev))
            for inv in invs:
                for route, got, want in (
                        ("qsgd", kernels.qsgd_levels_kernel(x, inv, seed, 255),
                         kernels.qsgd_levels_plain(x, inv, seed, 255)),
                        ("terngrad", kernels.terngrad_levels_kernel(x, inv, seed),
                         kernels.terngrad_levels_plain(x, inv, seed))):
                    d = (got.int() - want.int()).abs().max().item()
                    err[route] = max(err[route], float(d))
                    if d != 0:
                        raise AssertionError(f"{route} differs from plain at n={n} ({what})")
        # unbiased: scale * levels - g has mean 0 within 3 sigma
        levels, scale = kernels.qsgd_quantize(g, seed)
        v = g.double().abs() / torch.linalg.vector_norm(g).double() * 255
        q_err = _within_3_sigma(torch, scale * levels.float(), g, v - v.floor(), scale, "qsgd")
        levels, gmax = kernels.terngrad_quantize(g, seed)
        p = (g.double().abs() / gmax.double())
        t_err = _within_3_sigma(torch, gmax * levels.float(), g, p, gmax, "terngrad")
        checks[n] = {"uniform_mean": mean, "qsgd_mean_err_sigma": q_err,
                     "terngrad_mean_err_sigma": t_err}
        log(f"dither n={n}: uniform, qsgd and terngrad bitwise == plain (finite, nan/inf, "
            f"zeros); uniform mean {mean:.6f}; qsgd mean err {q_err[0]:.3e} (sigma "
            f"{q_err[1]:.3e}), terngrad {t_err[0]:.3e} (sigma {t_err[1]:.3e})")

        copies = max(2, math.ceil(120e6 / (4 * n)))
        xs = [torch.randn(n, generator=gen, device=dev) for _ in range(copies)]
        pairs = [(x, kernels._safe_inv(torch.linalg.vector_norm(x))) for x in xs]
        raw_u, raw_q, raw_t = raw_dither(kernels, torch, n, seed)
        rand_gen = torch.Generator(device=dev).manual_seed(2)
        ops = PHILOX_OPS_PER_ELEM * n
        row = {
            "uniform": {
                "ms": time_ms(raw_u, [None]),
                "wrapper_ms": time_ms(lambda _: kernels.uniform(seed, n, dev), [None]),
                "plain_ms": time_ms(lambda _: kernels.uniform_plain(seed, n, dev), [None], reps=5,
                                    inner=2),
                "bound": bound_ms(4 * n, ops, INT_OPS_PER_S),
                "library_ms": time_ms(lambda _: torch.rand(n, generator=rand_gen, device=dev),
                                      [None])},
            "qsgd": {
                "ms": time_ms(raw_q, pairs),
                "wrapper_ms": time_ms(lambda p: kernels.qsgd_levels_kernel(p[0], p[1], seed, 255),
                                      pairs),
                "plain_ms": time_ms(lambda p: kernels.qsgd_levels_plain(p[0], p[1], seed, 255),
                                    pairs, reps=5, inner=2),
                "bound": bound_ms(6 * n + 4, ops, INT_OPS_PER_S), "library_ms": None},
            "terngrad": {
                "ms": time_ms(raw_t, pairs),
                "wrapper_ms": time_ms(lambda p: kernels.terngrad_levels_kernel(p[0], p[1], seed),
                                      pairs),
                "plain_ms": time_ms(lambda p: kernels.terngrad_levels_plain(p[0], p[1], seed),
                                    pairs, reps=5, inner=2),
                "bound": bound_ms(5 * n + 4, ops, INT_OPS_PER_S), "library_ms": None},
        }
        rows[n] = row
        for name in ("uniform", "qsgd", "terngrad"):
            r = row[name]
            lib_txt = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            log(f"time n={n} {name}: {r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound'][0]:.4f} ms by {r['bound'][1]}, library {lib_txt})")
        del xs, pairs
    record["dither_errors"] = err
    record["dither_checks"] = {str(n): c for n, c in checks.items()}
    record["dither_times"] = {str(n): r for n, r in rows.items()}
    return err, rows


def raw_wire(kernels, torch, n: int, keep: int, seed: int):
    """The wire kernels' C entry points with outputs allocated once (timing
    only; these launches are not counted)."""
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sel = kernels._lib("select_pack").tcdp_select_pack
    qp = kernels._lib("quant_pack")
    vals = torch.empty(keep, device=dev)
    idx = torch.empty(keep, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    state = torch.zeros(kernels._lib("select_pack").tcdp_select_pack_state_words(n),
                        dtype=torch.int64, device=dev)
    tern = torch.empty(-(-n // 4), dtype=torch.uint8, device=dev)
    mags = torch.empty(n, dtype=torch.uint8, device=dev)
    signs = torch.empty(-(-n // 8), dtype=torch.uint8, device=dev)

    def check(rc, name):
        if rc:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")

    return (lambda xt: check(sel(xt[0].data_ptr(), n, xt[1].data_ptr(), keep, vals.data_ptr(),
                                 idx.data_ptr(), count.data_ptr(), state.data_ptr(),
                                 state.numel(), stream), "select_pack"),
            lambda xi: check(qp.tcdp_terngrad_pack(xi[0].data_ptr(), n, xi[1].data_ptr(), seed,
                                                   tern.data_ptr(), stream), "terngrad_pack"),
            lambda xi: check(qp.tcdp_qsgd_pack(xi[0].data_ptr(), n, xi[1].data_ptr(), seed, 255,
                                               mags.data_ptr(), signs.data_ptr(), stream),
                             "qsgd_pack"))


def _bits_equal(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def select_pack_edge_cases(kernels, torch, x, keep: int):
    """The one-pass select+pack's look-back cases on N(0, 1) data ``x``:
    misaligned views ``x[1:]``, ``x[3:]`` at their Top-K threshold; survivors
    only in the last tile, and only in the first; ``count == keep`` with ties
    at ``t``; ``keep > n``; ``-0.0`` survivors at ``t = 0``; ``t = NaN``."""
    n = x.numel()
    full = lambda v: torch.full((), v, device=x.device)  # noqa: E731
    cases = [(f"misaligned x[{off}:]", x[off:], kernels.topk_threshold(x[off:].abs(), keep), keep)
             for off in (1, 3)]
    small = x * 1e-2
    for where, sl in (("last", slice(n - 100, n)), ("first", slice(0, 100))):
        y = small.clone()
        y[sl] = 5.0
        cases.append((f"survivors only in the {where} tile", y, full(1.0), 64))
    ties = torch.where(x.abs() >= 1.0, x.sign(), 0.5 * x.sign())
    cases.append(("count == keep, ties at t", ties, full(1.0),
                  int((ties.abs() >= 1.0).sum().item())))
    cases.append(("keep > n", x, full(2.0), n + 7))
    signed = torch.zeros_like(x)
    signed[x < 0] = -0.0
    cases.append(("-0.0 survivors at t=0", signed, full(0.0), keep))
    cases.append(("t=NaN", x, full(float("nan")), keep))
    return cases


def lookback_size_cases(kernels, torch, gen):
    """Select+pack at the sizes that stress the tiling: one tile and one tile
    +- 1 of either tiling, on both sides of the size that picks it (every
    element surviving, zeros at ``t = 0``, a 2 % threshold, ``keep > n``),
    more than 1,000 tiles, and n > 2^24 (Top-K 1 %)."""
    dev = torch.device("cuda")
    lib = kernels._lib("select_pack")
    large_from = lib.tcdp_select_pack_large_from()
    small, large = lib.tcdp_select_pack_tile(1), lib.tcdp_select_pack_tile(large_from)
    full = lambda v: torch.full((), v, device=dev)  # noqa: E731
    cases = []
    for n in (small - 1, small, small + 1, large_from - 1, large_from,
              342 * large - 1, 342 * large, 342 * large + 1):
        x = torch.randn(n, generator=gen, device=dev)
        cases += [(f"n={n} all survive", x, full(0.0), n),
                  (f"n={n} zeros t=0", torch.zeros(n, device=dev), full(0.0), n + 1),
                  (f"n={n} 2 %", x, kernels.topk_threshold(x.abs(), n // 50), n // 50),
                  (f"n={n} keep > n", x, full(1.0), 2 * n + 5)]
    for label, n in (("1,000 tiles", 1000 * large + 123), ("n > 2^24", (1 << 24) + 4099)):
        x = torch.randn(n, generator=gen, device=dev)
        cases.append((f"{label}, 1 %", x, kernels.topk_threshold(x.abs(), n // 100), n // 100))
    return cases


def hold_select_pack(kernels, torch, cases, where: str):
    """Each case's select+pack bitwise against the plain version; returns the
    largest |kernel - plain| (0 unless it raised) and each case's
    (survivors, slots)."""
    err, counts = 0.0, {}
    for label, v, t, k in cases:
        got = kernels.fused_select_pack(v, t, k)
        want = kernels.fused_select_pack_plain(v, t, k)
        # equal slots count 0, so an Inf value matched by an Inf is no NaN
        d = max(torch.where(a == b, 0.0, (a.double() - b.double()).abs()).max().item()
                for a, b in zip(got, want))
        err = max(err, d)
        if not all(_bits_equal(torch, a, b) for a, b in zip(got, want)):
            raise AssertionError(f"select_pack differs from plain {where} ({label})")
        counts[label] = (int(got[2].item()), k)
    return err, counts


def phase_wire_kernels(kernels, compressors, wire, torch, record):
    """Select+pack and quantize+pack vs their plain versions on the card,
    their contracts, then timings."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    err = {"select_pack": 0.0, "terngrad_pack": 0.0, "qsgd_pack": 0.0}
    rows, cases = {}, {}
    seed = 0x13198A2E03707344
    size_cases = lookback_size_cases(kernels, torch, gen)
    err["select_pack"], size_counts = hold_select_pack(kernels, torch, size_cases,
                                                       "at the tiling's sizes")
    log(f"select_pack: vals, idx and count bitwise == plain in {len(size_cases)} cases at the "
        f"tiling's sizes (survivors/slots: {size_counts})")
    cases["tiling"] = size_counts
    del size_cases
    for n in (FULL_LEAF, FULL_MODEL):
        x = torch.randn(n, generator=gen, device=dev)
        keep = compressors.topk_keep_count(n, RATIO)
        cap = int(round(0.05 * n))
        kb = compressors.blocktopk_keep_blocks(n, RATIO, 256)
        scores = compressors.blocktopk_scores(x, 256)
        poisoned = x.clone()
        poisoned[::997] = float("nan")
        poisoned[1::1009] = float("inf")
        poisoned[2::1013] = -float("inf")
        finite_mag = torch.where(torch.isfinite(poisoned), poisoned.abs(), 0.0)
        zeros = torch.zeros(n, device=dev)
        mask = compressors.randomk_mask(seed, n, keep, dev).to(torch.float32)
        full = lambda v: torch.full((), v, device=dev)  # noqa: E731
        sel_cases = [
            ("topk", x, kernels.topk_threshold(x.abs(), keep), keep),
            ("thresholdv overflow", x, full(1.5), cap),
            ("thresholdv underfull", x, full(3.0), cap),
            ("blocktopk scores", scores, kernels.topk_threshold(scores, kb), kb),
            ("randomk mask", mask, full(0.5), keep),
            ("nan/inf", poisoned, kernels.topk_threshold(finite_mag, keep), keep),
            ("zeros t=0", zeros, full(0.0), keep),
            ("zeros t=1", zeros, full(1.0), keep),
            *select_pack_edge_cases(kernels, torch, x, keep),
        ]
        d, counts = hold_select_pack(kernels, torch, sel_cases, f"at n={n}")
        err["select_pack"] = max(err["select_pack"], d)
        if n == FULL_MODEL:
            # the ranks come from the scan, not from the order the tiles ran in
            label, v, t, k = sel_cases[0]
            want = kernels.fused_select_pack_plain(v, t, k)
            for _ in range(50):
                if not all(_bits_equal(torch, a, b)
                           for a, b in zip(kernels.fused_select_pack(v, t, k), want)):
                    raise AssertionError(f"select_pack differs between launches at n={n}")
        (c_over, k_over), (c_under, k_under) = (counts["thresholdv overflow"],
                                                 counts["thresholdv underfull"])
        if not (c_over > k_over and c_under < k_under and counts["randomk mask"][0] == keep):
            raise AssertionError(f"select_pack cases miss their regime at n={n}: {counts}")
        log(f"select_pack n={n}: vals, idx and count bitwise == plain in {len(sel_cases)} cases "
            f"(survivors/slots: {counts})"
            + ("; 50 back-to-back launches bitwise equal" if n == FULL_MODEL else ""))

        g = x * 1e-2
        pg = poisoned * 1e-2
        for what, v in (("finite", g), ("nan/inf", pg), ("zeros", zeros)):
            fin = torch.where(torch.isfinite(v), v, 0.0)
            for inv in (kernels._safe_inv(torch.linalg.vector_norm(fin)),
                        kernels._safe_inv(fin.abs().max()), torch.ones((), device=dev)):
                tp = kernels.terngrad_pack_kernel(v, inv, seed)
                tp2 = kernels.terngrad_pack_plain(v, inv, seed)
                err["terngrad_pack"] = max(err["terngrad_pack"],
                                           float((tp.int() - tp2.int()).abs().max().item()))
                if not torch.equal(tp, tp2):
                    raise AssertionError(f"terngrad_pack differs from plain at n={n} ({what})")
                if not torch.equal(wire.unpack_ternary(tp, n),
                                   kernels.terngrad_levels_kernel(v, inv, seed)):
                    raise AssertionError(f"terngrad_pack does not unpack to the levels ({what})")
                qp, qp2 = (kernels.qsgd_pack_kernel(v, inv, seed, 255),
                           kernels.qsgd_pack_plain(v, inv, seed, 255))
                err["qsgd_pack"] = max(err["qsgd_pack"], *(
                    float((a.int() - b.int()).abs().max().item()) for a, b in zip(qp, qp2)))
                if not all(torch.equal(a, b) for a, b in zip(qp, qp2)):
                    raise AssertionError(f"qsgd_pack differs from plain at n={n} ({what})")
                # a level fits the byte layout where |level| <= 255 (always at
                # QSGD's own scale, inv = 1 / ||g||, on finite input)
                lv = kernels.qsgd_levels_kernel(v, inv, seed, 255)
                fits = lv.int().abs() <= 255
                if not torch.equal(wire.qsgd_wire_unpack(qp, n, 255)[fits], lv[fits].float()):
                    raise AssertionError(f"qsgd_pack does not unpack to the levels ({what})")
        # the wire path's wrappers: the bytes of the quantizers' levels
        packed, gmax = kernels.terngrad_pack(g, seed)
        lv, gmax2 = kernels.terngrad_quantize(g, seed)
        mags, signs, scale = kernels.qsgd_pack(g, seed)
        lq, scale2 = kernels.qsgd_quantize(g, seed)
        if not (torch.equal(packed, wire.pack_ternary(lv)) and torch.equal(gmax, gmax2)
                and all(torch.equal(a, b) for a, b in zip((mags, signs),
                                                          wire.qsgd_wire_pack(lq, 255)))
                and torch.equal(scale, scale2)):
            raise AssertionError(f"quantize+pack differs from levels + pack at n={n}")
        log(f"terngrad_pack, qsgd_pack n={n}: bitwise == plain (finite, nan/inf, zeros, three "
            "inverse scales); unpacked == the level kernels' levels")
        cases[n] = counts

        copies = max(2, math.ceil(120e6 / (4 * n)))
        xs = [torch.randn(n, generator=gen, device=dev) for _ in range(copies)]
        t_top = kernels.topk_threshold(xs[0].abs(), keep)
        pairs = [(v, t_top) for v in xs]
        capped = [(v, full(1.5)) for v in xs]
        invs = [(v * 1e-2, kernels._safe_inv(torch.linalg.vector_norm(v * 1e-2))) for v in xs]
        raw_sel, raw_tern, raw_qsgd = raw_wire(kernels, torch, n, keep, seed)
        raw_cap = raw_wire(kernels, torch, n, cap, seed)[0]
        ops = PHILOX_OPS_PER_ELEM * n
        row = {
            "select_pack": {
                "ms": time_ms(raw_sel, pairs),
                "wrapper_ms": time_ms(lambda p: kernels.fused_select_pack(p[0], p[1], keep),
                                      pairs),
                "plain_ms": time_ms(lambda p: kernels.fused_select_pack_plain(p[0], p[1], keep),
                                    pairs, reps=5, inner=2),
                "bound": bound_ms(4 * n + 4 + 8 * keep + 4, n),
                "library_ms": time_ms(lambda p: torch.nonzero(p[0].abs() >= p[1]), pairs),
                "cap_ms": time_ms(raw_cap, capped),
                "cap_bound": bound_ms(4 * n + 4 + 8 * cap + 4, n)},
            "terngrad_pack": {
                "ms": time_ms(raw_tern, invs),
                "wrapper_ms": time_ms(lambda p: kernels.terngrad_pack_kernel(p[0], p[1], seed),
                                      invs),
                "plain_ms": time_ms(lambda p: kernels.terngrad_pack_plain(p[0], p[1], seed),
                                    invs, reps=5, inner=2),
                "bound": bound_ms(4 * n + 4 + -(-n // 4), ops, INT_OPS_PER_S), "library_ms": None},
            "qsgd_pack": {
                "ms": time_ms(raw_qsgd, invs),
                "wrapper_ms": time_ms(lambda p: kernels.qsgd_pack_kernel(p[0], p[1], seed, 255),
                                      invs),
                "plain_ms": time_ms(lambda p: kernels.qsgd_pack_plain(p[0], p[1], seed, 255),
                                    invs, reps=5, inner=2),
                "bound": bound_ms(4 * n + 4 + n + -(-n // 8), ops, INT_OPS_PER_S),
                "library_ms": None},
        }
        rows[n] = row
        for name in ("select_pack", "terngrad_pack", "qsgd_pack"):
            r = row[name]
            lib_txt = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            log(f"time n={n} {name}: {r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound'][0]:.4f} ms by {r['bound'][1]}, library {lib_txt})")
        r = row["select_pack"]
        log(f"time n={n} select_pack at the Threshold-V capacity {cap}: {r['cap_ms']:.4f} ms "
            f"(bound {r['cap_bound'][0]:.4f} ms); library = torch.nonzero(|x| >= t), which "
            "syncs the host")
        del xs, pairs, capped, invs
    record["wire_kernel_errors"] = err
    record["wire_kernel_cases"] = {str(n): c for n, c in cases.items()}
    record["wire_kernel_times"] = {str(n): r for n, r in rows.items()}
    return err, rows


def _route_payload(torch, gen, n: int, k: int, *, span: float = 1.0, nvalid=None):
    """A bucket-route input on the card: ``k`` slots of ascending distinct
    indices drawn from the first ``span`` of ``[0, n)`` (the first
    ``nvalid`` valid, the rest a zero tail bound for the dump bucket, and
    ``valid`` its mask; None where every slot is valid), values with -0.0,
    NaN and +-Inf planted."""
    dev = torch.device("cuda")
    nv = k if nvalid is None else nvalid
    pick = torch.randperm(int(n * span), generator=gen, device=dev)[:nv].sort().values
    idx = torch.cat([pick, torch.zeros(k - nv, dtype=pick.dtype, device=dev)]).to(torch.int32)
    del pick
    vals = torch.randn(k, generator=gen, device=dev)
    vals[::7] = -0.0
    vals[1::11] = float("nan")
    vals[2::13] = float("inf")
    vals[3::17] = -float("inf")
    vals[nv:] = 0.0
    valid = None if nvalid is None else torch.arange(k, device=dev) < nv
    return vals, idx, valid


def device_kernel_ms(torch, fn, name: str, n: int = 50):
    """Mean device duration (CUPTI, through torch.profiler) of the kernels
    named ``name`` over ``n`` calls of ``fn``: what a kernel takes on the
    card once the host's enqueue of back-to-back launches is out of the
    way.  A trace that comes back without the kernel (CUPTI now and then
    records no device activity for a profile) is taken again, up to three
    times; None where none of them has it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn(None)
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        if us:
            return sum(us) / len(us) / 1e3
    return None


def route_bound(kernels, torch, idx, valid, w: int, cap: int, shard_n: int):
    """(bound, taken): the route's bytes, the accepted windows read (values
    and indices), the buckets and ``accepted`` written, at 3.35 TB/s; one
    compare a bucket slot."""
    starts = kernels.route_starts(kernels.route_slots(idx, valid, w, cap, shard_n)[2], w)
    taken = int(torch.clamp(starts[1:] - starts[:-1], max=cap).sum().item())
    k = idx.numel()
    return bound_ms(8 * taken + 8 * w * cap + k, w * cap), taken


def phase_route_kernel(kernels, compressors, torch, record):
    """The one-launch bucket route (``route_buckets``: the windows found by
    the kernel's search, the buckets and ``accepted`` in one launch) and
    ``fused_bucket_route`` against their plain versions on the card,
    bitwise, at the main path's geometries and at the LM's payloads (k =
    5,253,571 / 9,615,442 at W = 2 and 4, inputs past the 50 MB L2); one
    kernel a route call, by the launch count and a CUPTI trace; then
    timings beside the bound."""
    from tpu_compressed_dp_torch.ops import wire_sharded

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    k_top = 65_732                                    # entire-model Top-K 1 %
    hp = wire_sharded.make_hier_plan(FULL_MODEL, int(round(0.05 * FULL_MODEL)), 4, 2,
                                     1.25, 1.25)
    # (label, n, k, W, cap, span, nvalid)
    cases = [(f"topk W={w}", FULL_MODEL, k_top, w,
              wire_sharded.make_shard_plan(FULL_MODEL, k_top, w, 1, 1.25, 1.25).cap_dest, 1.0,
              None) for w in (2, 4, 8)]
    # the hierarchical Threshold-V slab: the first survivors of a ~92 %
    # dense gradient, so every slot is bound for the first pod's shard
    # (an overflowing bucket and an empty one)
    cases.append(("hier thresholdv slab", FULL_MODEL, hp.slab, 2, hp.dcn.cap_dest, 0.034, None))
    cases.append(("dump-bucket tail", FULL_MODEL, hp.slab, 2, hp.dcn.cap_dest, 1.0, 150_000))
    caps = [c[4] for c in cases]
    if caps[:4] != [41_083, 20_542, 10_271, 128_381] or hp.slab != 205_410:
        raise AssertionError(f"bucket route geometry moved: caps {caps}, slab {hp.slab}")
    for n in LM_GROUPS:
        k = compressors.topk_keep_count(n, RATIO)
        cases += [(f"lm n={n} W={w}", n, k, w,
                   wire_sharded.make_shard_plan(n, k, w, 1, 1.25, 1.25).cap_dest, 1.0, None)
                  for w in (2, 4)]
    err, rows, counts, launched = 0.0, {}, {}, {}
    lib = kernels._lib("bucket_route").tcdp_route_buckets
    stream = torch.cuda.current_stream().cuda_stream
    payloads = {}
    for label, n, k, w, cap, span, nvalid in cases:
        key = (n, k, span, nvalid)
        if key not in payloads:
            payloads.clear()
            gc.collect()
            torch.cuda.empty_cache()
            payloads[key] = [_route_payload(torch, gen, n, k, span=span, nvalid=nvalid)
                             for _ in range(1 if n == FULL_MODEL else 2)]
        inputs = payloads[key]
        vals, idx, valid = inputs[0]
        shard_n = -(-n // w)
        kernels.reset_launches()
        got = kernels.route_buckets(vals, idx, valid, w, cap, shard_n)
        if kernels.LAUNCHES["bucket_route"] != 1:
            raise AssertionError(f"route_buckets launched {kernels.LAUNCHES['bucket_route']} "
                                 f"kernels ({label})")
        want = kernels.route_buckets_plain(vals, idx, valid, w, cap, shard_n)
        err = max(err, _hold(torch, got, want, "bucket_route", label))
        dest = kernels.route_slots(idx, valid, w, cap, shard_n)[2]
        err = max(err, _hold(torch, kernels.fused_bucket_route(vals, idx, dest, w, cap, shard_n),
                             want[:2], "bucket_route", f"{label}, fused_bucket_route"))
        starts = kernels.route_starts(dest, w)
        per = torch.clamp(starts[1:] - starts[:-1], max=cap)
        neg0 = int(((got[0] == 0) & torch.signbit(got[0])).sum().item())
        if neg0 == 0:
            raise AssertionError(f"bucket_route lost every -0.0 ({label})")
        counts[label] = {"k": k, "W": w, "cap": cap, "taken": per.tolist(),
                         "counts": (starts[1:] - starts[:-1]).tolist(), "neg_zero_kept": neg0,
                         "accepted": int(got[2].sum().item())}
        log(f"bucket_route {label}: k={k} W={w} cap={cap}: buckets, indices and accepted "
            f"bitwise == plain (and fused_bucket_route's buckets); window counts "
            f"{counts[label]['counts']}, taken {per.tolist()}, {neg0} -0.0 kept")
        del got, want
        if nvalid is not None:
            continue
        names = call_kernels(torch, lambda: kernels.route_buckets(vals, idx, valid, w, cap,
                                                                  shard_n))
        if not 10 < len(names) <= 20 or any("route_kernel" not in nm for nm in names):
            raise AssertionError(f"bucket_route {label}: 20 route calls enqueued "
                                 f"{sorted(set(names))} ({len(names)} activities), want one "
                                 "route_kernel a call")
        launched[label] = f"{len(names)} activities in 20 calls, all route_kernel"
        # timings: "ms" through the C entry with outputs allocated once; the
        # 6.57 M payload is a few MB, in L2 as its producer (select+pack)
        # leaves it; the LM's two payloads and buckets are past L2
        bv = torch.empty(w, cap, device=dev)
        bi = torch.empty(w, cap, dtype=torch.int32, device=dev)
        acc = torch.empty(k, dtype=torch.bool, device=dev)

        def raw(inp):
            v, i, ok = inputs[0] if inp is None else inp
            rc = lib(v.data_ptr(), i.data_ptr(), None, None if ok is None else ok.data_ptr(), k,
                     w, cap, shard_n, bv.data_ptr(), bi.data_ptr(), acc.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"bucket_route launch failed: cudaError {rc}")

        rank = torch.arange(k, dtype=torch.int32, device=dev) - starts[dest.long()]
        slot = torch.where(rank < cap, dest * cap + rank, w * cap).long()
        local = idx - dest * shard_n

        def scatter_pair(_):
            # sharded_combine's [W*cap+1] scatter build, the yardstick
            return (torch.zeros(w * cap + 1, device=dev).index_add_(0, slot, vals),
                    torch.full((w * cap + 1,), shard_n, dtype=torch.int32,
                               device=dev).scatter_(0, slot, local))

        big = n != FULL_MODEL
        reps, inner = (5, 4) if big else (15, 10)
        bound, taken = route_bound(kernels, torch, idx, valid, w, cap, shard_n)
        rows[label] = {
            "ms": time_ms(raw, inputs, reps=reps, inner=inner),
            "wrapper_ms": time_ms(lambda p: kernels.route_buckets(p[0], p[1], p[2], w, cap,
                                                                  shard_n), inputs,
                                  reps=reps, inner=inner),
            "plain_ms": time_ms(lambda p: kernels.route_buckets_plain(p[0], p[1], p[2], w, cap,
                                                                      shard_n), inputs,
                                reps=3 if big else 15, inner=2 if big else 10),
            "yardstick_ms": time_ms(scatter_pair, [None], reps=reps, inner=inner),
            "device_ms": device_kernel_ms(torch, raw, "route_kernel", n=10 if big else 50),
            "bound": bound, "taken": taken, "library_ms": None}
        del slot, local, rank, dest, bv, bi, acc
        r = rows[label]
        dev_txt = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.5f} ms"
        share = ("" if r["device_ms"] is None
                 else f", {100 * r['bound'][0] / r['device_ms']:.1f} % of the bound")
        log(f"time bucket_route {label}: {r['ms']:.4f} ms back to back (device time per "
            f"launch {dev_txt}{share}; wrapper {r['wrapper_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, [W*cap+1] scatter pair {r['yardstick_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.5f} ms by {r['bound'][1]}) on {record['card']}")
    payloads.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"bucket_route: one kernel a route call: {json.dumps(launched)}")
    record["route_cases"] = counts
    record["route_times"] = rows
    record["route_launches_a_call"] = launched
    return err, rows


def raw_pack(kernels, torch, n: int, keep: int, rows: int = 512):
    """The threshold-pack, segmented-pack and byte-pack C entry points with
    outputs and look-back state allocated once (timing only; not counted)."""
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    tp = kernels._lib("threshold_pack")
    bp = kernels._lib("byte_pack")
    P = kernels.pack_payload_slots(n, keep, rows)
    nseg = -(-n // 65536) * 16
    vals, idx = torch.empty(P, device=dev), torch.empty(P, dtype=torch.int32, device=dev)
    ef = torch.empty(n, device=dev)
    meta = torch.empty(3, dtype=torch.int32, device=dev)
    state = torch.zeros(max(tp.tcdp_threshold_pack_state_words(n, rows),
                            tp.tcdp_seg_pack_state_words(nseg)), dtype=torch.int64, device=dev)
    svals = torch.empty(nseg * 128, device=dev)
    sidx = torch.empty(nseg * 128, dtype=torch.int32, device=dev)
    seg = torch.empty(3, nseg, dtype=torch.int32, device=dev)
    tern = torch.empty(-(-n // 4), dtype=torch.uint8, device=dev)
    mags = torch.empty(n, dtype=torch.uint8, device=dev)
    signs = torch.empty(-(-n // 8), dtype=torch.uint8, device=dev)

    def check(rc, name):
        if rc:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")

    return (
        lambda xt: check(tp.tcdp_threshold_pack(
            xt[0].data_ptr(), n, xt[1].data_ptr(), rows, P // 128, vals.data_ptr(),
            idx.data_ptr(), ef.data_ptr(), meta.data_ptr(), state.data_ptr(), state.numel(),
            stream), "threshold_pack"),
        lambda xt: check(tp.tcdp_seg_pack(
            xt[0].data_ptr(), n, xt[1].data_ptr(), keep, nseg, svals.data_ptr(),
            sidx.data_ptr(), ef.data_ptr(), seg[0].data_ptr(), seg[1].data_ptr(),
            seg[2].data_ptr(), state.data_ptr(), state.numel(), stream), "seg_pack"),
        lambda lv: check(bp.tcdp_pack_ternary_bytes(lv.data_ptr(), n, tern.data_ptr(), stream),
                         "ternary_bytes"),
        lambda lv: check(bp.tcdp_qsgd_pack_bytes(lv.data_ptr(), n, mags.data_ptr(),
                                                 signs.data_ptr(), stream), "qsgd_bytes"))


def _poison(torch, x):
    """A copy of ``x`` with NaN, +-Inf and -0.0 planted."""
    x = x.clone()
    x[::997] = float("nan")
    x[1::1009] = float("inf")
    x[2::1013] = -float("inf")
    x[3::1019] = -0.0
    return x


def _hold(torch, got, want, name: str, what: str) -> float:
    """Measures two output tuples against each other (None matching None):
    the largest |kernel - plain| over the elements finite in both, and the
    number of elements whose bits differ.  Raises unless no bit differs;
    returns the largest difference."""
    d, differ = 0.0, 0
    for a, b in zip(got, want):
        if (a is None) != (b is None):
            raise AssertionError(f"{name} differs from plain ({what}): an output is missing")
        if a is None:
            continue
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name} differs from plain ({what}): {a.dtype} {a.shape} "
                                 f"against {b.dtype} {b.shape}")
        if a.numel() == 0:
            continue
        if a.is_floating_point():
            differ += int((a.view(torch.int32) != b.view(torch.int32)).sum().item())
            fin = torch.isfinite(a) & torch.isfinite(b)
            d = max(d, float(torch.where(fin, a - b, 0.0).abs().max().item()))
        else:
            differ += int((a != b).sum().item())
            d = max(d, float((a.long() - b.long()).abs().max().item()))
    if differ:
        raise AssertionError(f"{name} differs from plain ({what}): {differ} elements' bits "
                             f"differ, max |kernel - plain| {d}")
    return d


def hold_packs(kernels, torch, x, t, keep, rows, what: str, want_efs=(True, False)) -> dict:
    """The threshold pack (at block rows ``rows``; None skips it) and the
    segmented pack with its payload bitwise against their plain versions;
    returns each kernel's largest |kernel - plain|."""
    err = {"threshold_pack": 0.0, "seg_pack": 0.0}
    for want_ef in want_efs:
        if rows is not None:
            got = kernels.pack_by_threshold(x, t, keep, want_ef=want_ef, rows=rows)
            want = kernels.pack_by_threshold_plain(x, t, keep, want_ef=want_ef, rows=rows)
            err["threshold_pack"] = max(err["threshold_pack"], _hold(
                torch, got, want, "threshold_pack", f"{what}, rows {rows}, ef {want_ef}"))
        got = kernels.seg_pack_by_threshold(x, t, keep, want_ef=want_ef)
        want = kernels.seg_pack_by_threshold_plain(x, t, keep, want_ef=want_ef)
        err["seg_pack"] = max(
            err["seg_pack"], _hold(torch, got, want, "seg_pack", f"{what}, ef {want_ef}"),
            _hold(torch, kernels.seg_pack_payload(got[0], got[1], got[3], keep),
                  kernels.seg_pack_payload(want[0], want[1], want[3], keep), "seg_pack",
                  f"{what} payload"))
    return err


def pack_edge_cases(kernels, torch, x):
    """(label, x, t, keep, rows) at the edges of the one-pass packs' units,
    on N(0, 1) data ``x`` of at least 1,000,003 elements (rows None: the
    segmented pack alone): n one short of, at and one past a source block
    (rows 16 and 512), a 65,536-element unit and a 4096-element segment;
    misaligned views ``x[1:]``, ``x[3:]`` at their Top-K 1 % threshold; rows
    600, a source block longer than a unit (the count pre-pass); truncation
    at block 0 (every element survives) and inside a unit (rows 16, ~13 %
    survive); a keep cut inside a segmented tile (after 2 of its 4 segments
    and 5 survivors more); t above every |x|."""
    full = lambda v: torch.full((), v, device=x.device)  # noqa: E731
    cases = [(f"n={n}", x[:n], full(2.0), max(1, n // 100), rows)
             for n in (2047, 2048, 2049, 4095, 4097, 16383, 16385, 65535, 65536, 65537, 131073)
             for rows in (16, 512)]
    for off in (1, 3):
        v = x[off:1_000_003]
        keep = v.numel() // 100
        cases += [(f"misaligned x[{off}:]", v, kernels.topk_threshold(v.abs(), keep), keep, rows)
                  for rows in (16, 512)]
    v = x[:1_000_003]
    cases += [("rows 600", v, full(2.0), 10_000, 600),
              ("truncated at block 0", x[:200_001], full(0.0), 2000, 512),
              ("truncated inside a unit", v, full(1.5), 10_000, 16)]
    elig = kernels.seg_pack_by_threshold_plain(x[:300_001], full(2.0), 1)[3]
    cases += [("keep cut inside a tile", x[:300_001], full(2.0), int(elig[:42].sum()) + 5, None),
              ("t above every |x|", v, full(10.0), 5000, 512)]
    return cases


def call_kernels(torch, fn, calls: int = 20) -> list:
    """The names of the device activities (kernels, memsets, copies) that
    ``calls`` calls of ``fn`` enqueue, from a CUPTI trace.  CUPTI drops a
    record now and then (a single call's trace came back empty, 20 calls'
    with 19), so a trace with fewer activities than calls is taken again,
    up to three times, and the last one returned."""
    from torch.profiler import ProfilerActivity, profile

    names = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) >= calls:
            break
    return names


def phase_pack_kernels(kernels, compressors, torch, record):
    """The threshold pack, the segmented pack and the byte packers against
    their plain versions on the card, bitwise: at the entire-model size at
    Top-K 1 %, ragged multi-block sizes at block rows 16 and 512, the
    overflow regimes, data with NaN, +-Inf and -0.0, the one-pass packs' unit
    edges (``pack_edge_cases``), back-to-back calls on one stream and a call
    on a second; each pack one launch a call; then timings."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    # every check below is bitwise (_hold raises on any bit that differs);
    # err keeps the largest |kernel - plain| it measured
    err = dict.fromkeys(("threshold_pack", "seg_pack", "ternary_bytes", "qsgd_bytes"), 0.0)
    n = FULL_MODEL
    keep = compressors.topk_keep_count(n, RATIO)
    seed = 0x13198A2E03707344
    x = torch.randn(n, generator=gen, device=dev)
    full = lambda v: torch.full((), v, device=dev)  # noqa: E731
    t_top = kernels.topk_threshold(x.abs(), keep)
    cases = {}
    # (label, x, t, keep, rows)
    pack_cases = [("topk 1% rows 512", x, t_top, keep, 512),
                  ("topk 1% rows 16", x, t_top, keep, 16),
                  ("ragged 200001 rows 16", x[:200_001], full(2.0), 2000, 16),
                  ("ragged 1000003 rows 512", x[:1_000_003], full(2.5), 10_000, 512),
                  ("overflow t keeps ~99%", x, full(0.01), keep, 512),
                  ("overflow t keeps 2 keep", x, kernels.topk_threshold(x.abs(), 2 * keep), keep,
                   512),
                  ("nan/inf/-0.0 topk", _poison(torch, x), t_top, keep, 512),
                  ("nan/inf/-0.0 t=0", _poison(torch, x[:300_000]), full(0.0), 3000, 16)]
    for label, v, t, k, rows in pack_cases:
        for want_ef in (True, False):
            got = kernels.pack_by_threshold(v, t, k, want_ef=want_ef, rows=rows)
            want = kernels.pack_by_threshold_plain(v, t, k, want_ef=want_ef, rows=rows)
            err["threshold_pack"] = max(err["threshold_pack"], _hold(
                torch, got, want, "threshold_pack", f"{label}, ef {want_ef}"))
        survivors = int((v.abs() >= t).sum().item())
        cases[f"threshold_pack {label}"] = {"n": v.numel(), "keep": k, "rows": rows,
                                            "survivors": survivors,
                                            "shipped": int(got[3].item()),
                                            "slots": got[0].numel()}
    if not (cases["threshold_pack overflow t keeps ~99%"]["shipped"]
            < cases["threshold_pack overflow t keeps ~99%"]["survivors"]):
        raise AssertionError(f"threshold_pack overflow case did not truncate: {cases}")
    log(f"threshold_pack: vals, idx, EF and count bitwise == plain in {len(pack_cases)} cases x "
        f"EF on/off: {json.dumps({k: v for k, v in cases.items()})}")
    # t = 1.0 keeps ~32 %, ten times the 128 / 4096 cap: every segment overflows
    seg_cases = [("topk 1%", x, t_top, keep), ("ragged 200001", x[:200_001], full(2.0), 2000),
                 ("cap overflow t=1", x, full(1.0), keep),
                 ("nan/inf/-0.0 topk", _poison(torch, x), t_top, keep),
                 ("nan/inf/-0.0 t=0", _poison(torch, x[:300_000]), full(0.0), 3000)]
    for label, v, t, k in seg_cases:
        for want_ef in (True, False):
            got = kernels.seg_pack_by_threshold(v, t, k, want_ef=want_ef)
            want = kernels.seg_pack_by_threshold_plain(v, t, k, want_ef=want_ef)
            err["seg_pack"] = max(
                err["seg_pack"], _hold(torch, got, want, "seg_pack", f"{label}, ef {want_ef}"),
                _hold(torch, kernels.seg_pack_payload(got[0], got[1], got[3], k),
                      kernels.seg_pack_payload(want[0], want[1], want[3], k), "seg_pack",
                      f"{label} payload"))
        cases[f"seg_pack {label}"] = {"n": v.numel(), "keep": k,
                                      "survivors": int(got[4].sum().item()),
                                      "eligible": int(got[3].sum().item()),
                                      "overflowing segments": int((got[4] > 128).sum().item())}
    if cases["seg_pack cap overflow t=1"]["eligible"] >= cases["seg_pack cap overflow t=1"][
            "survivors"]:
        raise AssertionError("seg_pack cap-overflow case did not overflow")
    log(f"seg_pack: vals, idx, EF, elig, counts and the payload bitwise == plain in "
        f"{len(seg_cases)} cases x EF on/off: "
        f"{json.dumps({k: v for k, v in cases.items() if k.startswith('seg')})}")
    big = torch.randn(1_000_003, generator=gen, device=dev)
    edges = pack_edge_cases(kernels, torch, big)
    for label, v, t, k, rows in edges:
        e = hold_packs(kernels, torch, v, t, k, rows, label, want_efs=(True,))
        for name in e:
            err[name] = max(err[name], e[name])
    # the look-back state: back-to-back calls of both packs on one stream,
    # alternating sizes, then a call on a second stream
    sizes = [(big, 512), (big[:70_001], 16), (big[5:300_006], 600), (big[:131_073], 512)]
    for v, rows in sizes * 3:
        e = hold_packs(kernels, torch, v, full(2.0), v.numel() // 100, rows, "back to back",
                       want_efs=(True,))
        for name in e:
            err[name] = max(err[name], e[name])
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = (kernels.pack_by_threshold(big, full(2.0), 10_000),
               kernels.seg_pack_by_threshold(big, full(2.0), 10_000))
    torch.cuda.synchronize()
    err["threshold_pack"] = max(err["threshold_pack"], _hold(
        torch, got[0], kernels.pack_by_threshold_plain(big, full(2.0), 10_000), "threshold_pack",
        "second stream"))
    err["seg_pack"] = max(err["seg_pack"], _hold(
        torch, got[1], kernels.seg_pack_by_threshold_plain(big, full(2.0), 10_000), "seg_pack",
        "second stream"))
    launched = {"threshold_pack": call_kernels(torch, lambda: kernels.pack_by_threshold(
                    x, t_top, keep)),
                "seg_pack": call_kernels(torch, lambda: kernels.seg_pack_by_threshold(
                    x, t_top, keep))}
    # every activity is the kernel, and no more than one a call (a dropped
    # record may leave fewer)
    for name, names in launched.items():
        if not 10 < len(names) <= 20 or any(f"{name}_kernel" not in k for k in names):
            raise AssertionError(f"{name}: 20 calls launched {sorted(set(names))} "
                                 f"({len(names)} activities), want one {name}_kernel a call")
        launched[name] = f"{len(names)} activities in 20 calls, all {name}_kernel"
    log(f"threshold_pack, seg_pack: bitwise == plain in {len(edges)} unit-edge cases "
        f"({', '.join(sorted({c[0] for c in edges}))}), {3 * len(sizes)} back-to-back calls "
        f"on one stream and a call on a second; one launch a call: {launched}")
    record["pack_launches_a_call"] = launched
    del big, edges
    g = x * 1e-2
    inv = kernels._safe_inv(torch.linalg.vector_norm(g))
    tern_levels = kernels.terngrad_levels_kernel(g, kernels._safe_inv(g.abs().max()), seed)
    qsgd_levels = kernels.qsgd_levels_kernel(g, inv, seed, 255)
    wide8 = torch.randint(-128, 128, (n,), generator=gen, device=dev, dtype=torch.int8)
    wide16 = torch.randint(-32768, 32768, (n,), generator=gen, device=dev, dtype=torch.int16)
    for label, lv in (("terngrad levels", tern_levels), ("full int8 range", wide8),
                      ("ragged 12345", tern_levels[:12_345])):
        err["ternary_bytes"] = max(err["ternary_bytes"], _hold(
            torch, (kernels.pack_ternary_bytes(lv),), (kernels.pack_ternary_bytes_plain(lv),),
            "ternary_bytes", label))
    # the QSGD packer's 16-byte runs: ragged n (every n % 32 class below),
    # views at each element offset from a 16-byte boundary
    q_cases = [("qsgd levels", qsgd_levels), ("full int16 range", wide16),
               ("ragged 12347", qsgd_levels[:12_347])]
    q_cases += [(f"view at +{off}, n % 32 = {r}", wide16[off:off + 32 * 4001 + r])
                for off, r in ((1, 0), (3, 1), (5, 7), (7, 8), (8, 31), (2, 17))]
    q_cases.append(("view at +1, to the end", wide16[1:]))
    for label, lv in q_cases:
        err["qsgd_bytes"] = max(err["qsgd_bytes"], _hold(
            torch, kernels.qsgd_pack_bytes(lv), kernels.qsgd_pack_bytes_plain(lv), "qsgd_bytes",
            label))
    log("ternary_bytes, qsgd_bytes: bitwise == plain on the level kernels' levels, the full "
        "int8 / int16 ranges and ragged sizes; qsgd_bytes also on views at element offsets "
        f"1-8 and every n % 32 class ({len(q_cases)} cases)")

    copies = max(2, math.ceil(120e6 / (4 * n)))
    xs = [torch.randn(n, generator=gen, device=dev) for _ in range(copies)]
    pairs = [(v, t_top) for v in xs]
    terns = [tern_levels.roll(i) for i in range(max(2, math.ceil(120e6 / n)))]
    qsgds = [qsgd_levels.roll(i) for i in range(max(2, math.ceil(120e6 / (2 * n))))]
    raw_tp, raw_seg, raw_tern, raw_q = raw_pack(kernels, torch, n, keep)
    P = kernels.pack_payload_slots(n, keep)
    nseg = -(-n // 65536) * 16
    rows = {
        "threshold_pack": {
            "ms": time_ms(raw_tp, pairs),
            "device_ms": device_kernel_ms(torch, lambda _: raw_tp(pairs[0]),
                                          "threshold_pack_kernel"),
            "wrapper_ms": time_ms(lambda p: kernels.pack_by_threshold(p[0], p[1], keep), pairs),
            "plain_ms": time_ms(lambda p: kernels.pack_by_threshold_plain(p[0], p[1], keep),
                                pairs, reps=5, inner=2),
            "bound": bound_ms(4 * n + 4 + 4 * n + 8 * P + 12, n),
            "library_ms": time_ms(lambda p: torch.nonzero(p[0].abs() >= p[1]), pairs)},
        "seg_pack": {
            "ms": time_ms(raw_seg, pairs),
            "device_ms": device_kernel_ms(torch, lambda _: raw_seg(pairs[0]), "seg_pack_kernel"),
            "wrapper_ms": time_ms(lambda p: kernels.seg_pack_by_threshold(p[0], p[1], keep),
                                  pairs),
            "plain_ms": time_ms(lambda p: kernels.seg_pack_by_threshold_plain(p[0], p[1], keep),
                                pairs, reps=5, inner=2),
            "payload_ms": None,
            "bound": bound_ms(4 * n + 4 + 4 * n + 8 * 128 * nseg + 12 * nseg, n),
            "library_ms": None},
        "ternary_bytes": {
            "ms": time_ms(raw_tern, terns),
            "wrapper_ms": time_ms(kernels.pack_ternary_bytes, terns),
            "plain_ms": time_ms(kernels.pack_ternary_bytes_plain, terns, reps=5, inner=2),
            "device_ms": device_kernel_ms(torch, lambda _: raw_tern(terns[0]),
                                          "ternary_bytes_kernel"),
            "bound": bound_ms(n + -(-n // 4), n), "library_ms": None},
        "qsgd_bytes": {
            "ms": time_ms(raw_q, qsgds),
            "wrapper_ms": time_ms(kernels.qsgd_pack_bytes, qsgds),
            "plain_ms": time_ms(kernels.qsgd_pack_bytes_plain, qsgds, reps=5, inner=2),
            "device_ms": device_kernel_ms(torch, lambda _: raw_q(qsgds[0]), "qsgd_bytes_kernel"),
            "bound": bound_ms(2 * n + n + -(-n // 8), n), "library_ms": None},
    }
    vals, idx, _, elig, _ = kernels.seg_pack_by_threshold(xs[0], t_top, keep)
    rows["seg_pack"]["payload_ms"] = time_ms(
        lambda _: kernels.seg_pack_payload(vals, idx, elig, keep), [None])
    for name, r in rows.items():
        lib_txt = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        dev_txt = f", device time per launch {r['device_ms']}" if "device_ms" in r else ""
        log(f"time n={n} {name}: {r['ms']:.4f} ms{dev_txt} (wrapper {r['wrapper_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms by {r['bound'][1]}, "
            f"library {lib_txt}) on {record['card']}")
    log(f"time n={n} seg_pack_payload (PyTorch ops, keep {keep}): "
        f"{rows['seg_pack']['payload_ms']:.4f} ms; threshold_pack library = "
        "torch.nonzero(|x| >= t), which syncs the host")
    del xs, pairs, terns, qsgds
    record["pack_kernel_errors"] = err
    record["pack_kernel_cases"] = cases
    record["pack_kernel_times"] = rows
    return err, rows


LM_GROUPS = (525_357_056, 961_544_192)   # the LM's two sync groups at llama3_8b widths


def phase_pack_lm(kernels, compressors, torch, record):
    """The threshold pack (block rows 512) and the segmented pack at the LM's
    group sizes, where the indices reach ~2^30, bitwise against their plain
    versions with EF, the segmented payload included, on seeded data in two
    regimes: N(0, 1) data at the threshold of 2 * keep (the eligible total
    passes keep, so the keep cut decides the segmented EF, and the threshold
    pack's rows pass its payload, so it truncates), and data with one
    segment in eight scaled by 4 at the Top-K 1 % threshold (the 128-slot cap
    cuts, as on the LM's gradients); then, at the spread data's Top-K 1 %
    threshold, each kernel's time by CUDA events (its C entry) and CUPTI
    beside its bound, the wrapper's, the plain version's and (threshold
    pack) ``torch.nonzero``'s.  Runs before the trainings, while the plain
    versions' ~35 bytes an element fit."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    err = {"threshold_pack": 0.0, "seg_pack": 0.0}
    cases, times = {}, {}
    for n in LM_GROUPS:
        keep = compressors.topk_keep_count(n, RATIO)
        for label in ("spread, t of 2 keep", "concentrated, t of keep"):
            gc.collect()
            torch.cuda.empty_cache()
            x = torch.randn(n, generator=gen, device=dev)
            if label.startswith("spread"):
                t = kernels.topk_threshold(x.abs(), 2 * keep)
            else:
                span = 8 * 4096
                x[:n // span * span].view(-1, span)[:, :4096] *= 4.0
                t = kernels.topk_threshold(x.abs(), keep)
            what = f"n={n} {label}"
            for name, e in hold_packs(kernels, torch, x, t, keep, 512, what,
                                      want_efs=(True,)).items():
                err[name] = max(err[name], e)
            got = kernels.seg_pack_by_threshold(x, t, keep)
            shipped = int(kernels.pack_by_threshold(x, t, keep)[3].item())
            c = {"n": n, "keep": keep, "survivors": int(got[4].sum().item()),
                 "eligible": int(got[3].sum().item()),
                 "overflowing segments": int((got[4] > 128).sum().item()),
                 "largest index": int(got[1].max().item()), "threshold_pack shipped": shipped}
            if not (c["eligible"] > keep and shipped < c["survivors"]
                    if label.startswith("spread") else c["overflowing segments"] > 0):
                raise AssertionError(f"the packs at {what} miss their regime: {c}")
            cases[what] = c
            del x, t, got
        gc.collect()
        torch.cuda.empty_cache()
        x = torch.randn(n, generator=gen, device=dev)
        t = kernels.topk_threshold(x.abs(), keep)
        pair = [(x, t)]
        raw_tp, raw_seg = raw_pack(kernels, torch, n, keep)[:2]
        P = kernels.pack_payload_slots(n, keep)
        nseg = -(-n // 65536) * 16
        r = {"threshold_pack": {
                "ms": time_ms(raw_tp, pair, reps=5, inner=4),
                "device_ms": device_kernel_ms(torch, lambda _: raw_tp(pair[0]),
                                              "threshold_pack_kernel", n=10),
                "wrapper_ms": time_ms(lambda p: kernels.pack_by_threshold(p[0], p[1], keep),
                                      pair, reps=5, inner=2),
                "plain_ms": time_ms(lambda p: kernels.pack_by_threshold_plain(p[0], p[1], keep),
                                    pair, reps=3, inner=1),
                "bound": bound_ms(4 * n + 4 + 4 * n + 8 * P + 12, n),
                "library_ms": time_ms(lambda p: torch.nonzero(p[0].abs() >= p[1]), pair,
                                      reps=5, inner=2)},
             "seg_pack": {
                "ms": time_ms(raw_seg, pair, reps=5, inner=4),
                "device_ms": device_kernel_ms(torch, lambda _: raw_seg(pair[0]),
                                              "seg_pack_kernel", n=10),
                "wrapper_ms": time_ms(lambda p: kernels.seg_pack_by_threshold(p[0], p[1], keep),
                                      pair, reps=5, inner=2),
                "plain_ms": time_ms(
                    lambda p: kernels.seg_pack_by_threshold_plain(p[0], p[1], keep), pair,
                    reps=3, inner=1),
                "bound": bound_ms(4 * n + 4 + 4 * n + 8 * 128 * nseg + 12 * nseg, n),
                "library_ms": None}}
        for name, row in r.items():
            lib_txt = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
            log(f"time n={n} {name}: {row['ms']:.4f} ms, CUPTI {row['device_ms']} ms (wrapper "
                f"{row['wrapper_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound'][0]:.5f} ms by {row['bound'][1]}, library {lib_txt}) on "
                f"{record['card']}")
        times[str(n)] = r
        del x, t, pair, raw_tp, raw_seg
    gc.collect()
    torch.cuda.empty_cache()
    log(f"threshold_pack, seg_pack at the LM's group sizes: vals, idx, EF, meta / elig, "
        f"counts, starts and the payload bitwise == plain: {json.dumps(cases)}")
    record["pack_lm_sizes"] = {"cases": cases, "times": times}
    return err


def phase_qsgd_bytes_lm(kernels, torch, record):
    """The QSGD byte packer at the LM's group sizes (no path calls it; these
    sizes read its rate): full-range int16 levels held bitwise against the
    plain version, then its time by CUDA events (the C entry) and CUPTI
    beside the bound, the wrapper's and the plain version's."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    err, times = 0.0, {}
    bp = kernels._lib("byte_pack")
    stream = torch.cuda.current_stream().cuda_stream
    for n in LM_GROUPS:
        gc.collect()
        torch.cuda.empty_cache()
        lv = torch.randint(-32768, 32768, (n,), generator=gen, device=dev, dtype=torch.int16)
        err = max(err, _hold(torch, kernels.qsgd_pack_bytes(lv), kernels.qsgd_pack_bytes_plain(lv),
                             "qsgd_bytes", f"n={n} full int16 range"))
        gc.collect()
        torch.cuda.empty_cache()
        mags = torch.empty(n, dtype=torch.uint8, device=dev)
        signs = torch.empty(-(-n // 8), dtype=torch.uint8, device=dev)

        def raw(_):
            rc = bp.tcdp_qsgd_pack_bytes(lv.data_ptr(), n, mags.data_ptr(), signs.data_ptr(),
                                         stream)
            if rc:
                raise RuntimeError(f"qsgd_bytes launch failed: cudaError {rc}")

        r = {"ms": time_ms(raw, [None], reps=5, inner=4),
             "device_ms": device_kernel_ms(torch, raw, "qsgd_bytes_kernel", n=10),
             "wrapper_ms": time_ms(kernels.qsgd_pack_bytes, [lv], reps=5, inner=2),
             "plain_ms": time_ms(kernels.qsgd_pack_bytes_plain, [lv], reps=3, inner=1),
             "bound": bound_ms(2 * n + n + -(-n // 8), n), "library_ms": None}
        share = ("" if r["device_ms"] is None
                 else f", {100 * r['bound'][0] / r['device_ms']:.1f} % of the bound")
        log(f"time n={n} qsgd_bytes: {r['ms']:.4f} ms, CUPTI {r['device_ms']} ms{share} "
            f"(wrapper {r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.5f} ms by {r['bound'][1]}) on {record['card']}")
        times[str(n)] = r
        del lv, mags, signs
    gc.collect()
    torch.cuda.empty_cache()
    log("qsgd_bytes at the LM's group sizes: magnitudes and signs bitwise == plain")
    record["qsgd_bytes_lm_sizes"] = times
    return err


def phase_search_lm(kernels, compressors, torch, record):
    """The threshold search at the LM's two sync group sizes and at n = 2^25
    (where the counts pass 2^24 and their float32 rounds), Top-K 1 % of
    |N(0, 1)| data: bitwise against the unfused glue on the plain counts and
    the CPU search (``check_search``); at the group sizes its passes timed
    beside their bounds (``count_passes``) and ``select_pack`` timed through
    its C entry at the same threshold."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for n in LM_GROUPS + (1 << 25,):
        gc.collect()
        torch.cuda.empty_cache()
        x = torch.randn(n, generator=gen, device=dev)
        mag = x.abs()
        keep = compressors.topk_keep_count(n, RATIO)
        r = {"search": check_search(kernels, torch, mag, keep, f"n={n}")}
        if n in LM_GROUPS:
            raw_count, _ = raw_launchers(kernels, torch, 1)
            r["passes"] = count_passes(kernels, torch, mag, keep, raw_count, 20)
            log_passes(r["passes"], record["card"])
            t = kernels.topk_threshold(mag, keep)
            del mag
            full = lambda v: torch.full((), v, device=dev)  # noqa: E731
            lm_cases = [("topk 1 %", x, t, keep), ("misaligned x[1:]", x[1:], t, keep),
                        ("thresholdv underfull", x, full(4.5), keep),
                        ("all survive t=0", x, full(0.0), keep)]
            _, counts = hold_select_pack(kernels, torch, lm_cases, f"at n={n}")
            want = kernels.fused_select_pack(x, t, keep)
            for _ in range(5):
                if not all(_bits_equal(torch, a, b)
                           for a, b in zip(kernels.fused_select_pack(x, t, keep), want)):
                    raise AssertionError(f"select_pack differs between launches at n={n}")
            del want
            r["select_pack_cases"] = counts
            log(f"select_pack n={n}: bitwise == plain in {len(lm_cases)} cases (survivors/"
                f"slots: {counts}); 5 more launches bitwise equal")
            gc.collect()
            torch.cuda.empty_cache()
            raw_sel = raw_wire(kernels, torch, n, keep, 0)[0]
            ms = time_ms(raw_sel, [(x, t)], reps=5, inner=4)
            bound = bound_ms(4 * n + 4 + 8 * keep + 4, n)
            r["select_pack"] = {"ms": ms, "bound_ms": bound[0], "bound_by": bound[1]}
            log(f"time n={n} select_pack at the Top-K 1 % threshold: {ms:.4f} ms, bound "
                f"{bound[0]:.4f} ms by {bound[1]} on {record['card']}")
            del raw_sel
        out[str(n)] = r
        del x
    gc.collect()
    torch.cuda.empty_cache()
    record["search_lm"] = out
    return out


# the Top-K groups of the paper's configs 2-3 that phase 3b gives the
# kernels: VGG16's fc1 (layer-wise), VGG16 and AlexNet (module) entire-model,
# and AlexNet's fc2, exactly 2^24
CIFAR_GROUPS = (102_760_448, 134_301_514, 23_272_266, 16_777_216)


def phase_search_cifar(kernels, compressors, torch, record):
    """2e: the threshold search at the CIFAR configs' group sizes, bitwise
    against the unfused glue on the plain counts and the CPU search
    (``check_search``); the fused sparsify there bitwise against its plain
    version; and ``select_pack`` (its Large tiling) at VGG16's entire-model
    size against its plain version."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    out = {}
    for n in CIFAR_GROUPS:
        gc.collect()
        torch.cuda.empty_cache()
        x = torch.randn(n, generator=gen, device=dev) * 1e-2
        mag = x.abs()
        keep = compressors.topk_keep_count(n, RATIO)
        r = {"search": check_search(kernels, torch, mag, keep, f"n={n}")}
        t = kernels.topk_threshold(mag, keep)
        del mag
        for got, want in zip(kernels.fused_sparsify(x, t), kernels.fused_sparsify_plain(x, t)):
            if not _bits_equal(torch, got, want):
                raise AssertionError(f"fused_sparsify differs from its plain version at n={n}")
        if n == 134_301_514:
            _, counts = hold_select_pack(kernels, torch, [("topk 1 %", x, t, keep)],
                                         f"at n={n}")
            r["select_pack_cases"] = counts
        held = "search, fused_sparsify" + (", select_pack" if "select_pack_cases" in r else "")
        log(f"cifar group n={n}: {held} bitwise == plain")
        out[str(n)] = r
        del x
    gc.collect()
    torch.cuda.empty_cache()
    record["search_cifar"] = out
    return out


def phase_seg_path(kernels, compressors, dawn, torch, record, wire_em, lm_wire):
    """The gated segmented wire Top-K path (``kernels._SEG_PACK_DISPATCH``)
    through the entry points: dawn at ResNet-9's published widths and the LM
    at llama3_8b widths, wire Top-K 1 % + EF entiremodel.  ``seg_pack`` must
    launch once a step per group and ``select_pack`` never; step time and
    sent fraction beside the default wire path's (``wire_em``, ``lm_wire``)."""
    from tpu_compressed_dp_torch.harness import lm

    card = record["card"]
    runs = {}
    dawn_argv = ["--network", "resnet9", "--synthetic", "--synthetic_n", "2048", "--batch_size",
                 "512", "--epochs", "1", "--compress", "entiremodel", "--method", "topk",
                 "--ratio", str(RATIO), "--error_feedback", "--mode", "wire", "--device",
                 "cuda", "--seed", "0", "--log_dir", ""]
    lm_argv = LM_ARGV + LM_RUNS["wire topk entiremodel"]
    keep_rn = compressors.topk_keep_count(FULL_MODEL, RATIO)
    keep_lm = sum(compressors.topk_keep_count(g, RATIO) for g in LM_GROUPS)
    kernels._SEG_PACK_DISPATCH = True
    try:
        for label, run, groups, keep, dense, base in (
                ("dawn resnet9", lambda: dawn.main(dawn_argv), 1, keep_rn, FULL_MODEL, wire_em),
                ("lm llama3_8b 2 layers", lambda: lm.main(lm_argv), 2, keep_lm, LM_PARAMS,
                 lm_wire)):
            gc.collect()
            torch.cuda.empty_cache()
            kernels.reset_launches()
            t0 = time.perf_counter()
            summary = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            steps = summary["steps"] if "steps" in summary else summary["step"]
            loss = summary["train loss"] if "train loss" in summary else summary["loss"]
            sent = summary["sent frac"]
            if not math.isfinite(loss) or steps != 4:
                raise AssertionError(f"seg {label}: {steps} steps, loss {loss}")
            if launches["seg_pack"] != groups * steps or launches["select_pack"] != 0:
                raise AssertionError(f"seg {label}: seg_pack launched {launches['seg_pack']} "
                                     f"times (want {groups * steps}), select_pack "
                                     f"{launches['select_pack']} (want 0)")
            if not 0 < sent <= keep / dense:
                raise AssertionError(f"seg {label}: sent frac {sent} outside (0, {keep / dense}]")
            if "train time" in summary:
                ms = summary["train time"] * 1e3 / steps
                base_ms = base["ms_per_step"]
            else:
                ms = 8192.0 / summary["tok/s"] * 1e3
                base_ms = base["step_ms"]
            base_sent = base["summary"]["sent frac"]
            log(f"seg {label}: loss {loss:.4f}, sent frac {sent:.9f} (default wire path "
                f"{base_sent:.9f}, keep counts {keep / dense:.9f}), {ms:.2f} ms/step (default "
                f"wire path {base_ms:.2f}), wall {wall:.1f} s on {card}; launches {launches}")
            runs[label] = {"summary": summary, "launches": launches, "ms_per_step": ms,
                           "default_ms_per_step": base_ms, "default_sent": base_sent}
    finally:
        kernels._SEG_PACK_DISPATCH = False
    record["seg_path"] = runs
    return runs


# phase 3's runs: label -> (dawn flags, the kernels the run must launch)
TOPK_KERNELS = ("count_ge", "count_edges", "search_init", "fused_sparsify")
TRAIN_RUNS = {
    "topk": (["--method", "topk", "--ratio", str(RATIO), "--error_feedback"], TOPK_KERNELS),
    "randomk": (["--method", "randomk", "--ratio", str(RATIO), "--error_feedback"],
                ("uniform",)),
    "thresholdv": (["--method", "thresholdv", "--error_feedback"], ("fused_sparsify",)),
    "adaptivethreshold": (["--method", "adaptivethreshold", "--error_feedback"],
                          ("fused_sparsify",)),
    "terngrad": (["--method", "terngrad"], ("terngrad",)),
    "randomdithering": (["--method", "randomdithering", "--qstates", "255"], ("qsgd",)),
}
# wire mode: Block-Top-K's scores (<= 25,677 at full width) stay below the
# kernels' dispatch size, so its run uses none of them
WIRE_RUNS = {
    "topk": (["--method", "topk", "--ratio", str(RATIO), "--error_feedback"],
             TOPK_KERNELS[:3] + ("select_pack",)),
    "randomk": (["--method", "randomk", "--ratio", str(RATIO), "--error_feedback"],
                ("uniform", "count_ge", "search_init", "select_pack")),
    "blocktopk": (["--method", "blocktopk", "--ratio", str(RATIO), "--error_feedback"], ()),
    "thresholdv": (["--method", "thresholdv", "--error_feedback"], ("select_pack",)),
    "adaptivethreshold": (["--method", "adaptivethreshold", "--error_feedback"],
                          ("select_pack",)),
    "terngrad": (["--method", "terngrad"], ("terngrad_pack",)),
    "randomdithering": (["--method", "randomdithering", "--qstates", "255"], ("qsgd_pack",)),
}


def _group_sizes(dp, gran: str, network: str = "resnet9"):
    """A full-width network's reduction groups, as element counts (the leaf
    sizes of a module built on the CPU)."""
    import torch

    from tpu_compressed_dp_torch.harness import dawn
    from tpu_compressed_dp_torch.models.common import param_leaves

    sizes = [p.numel() for p in param_leaves(
        dawn.MODELS[network](1.0, torch.float32, 0, "cpu")).values()]
    groups = dp.make_leaf_groups([4 * s for s in sizes], gran, 25.0 * dp.BUCKET_MB)
    return [sum(sizes[i] for i in g) for g in groups]


def expected_sent(compressors, dp, gran: str) -> float:
    """Random-K's billed sent fraction: the summed per-group keep counts
    over the dense count, for full-width ResNet-9's leaves."""
    ns = _group_sizes(dp, gran)
    return sum(compressors.randomk_keep_count(n, RATIO) for n in ns) / sum(ns)


def wire_layout(compressors, dp, label: str, gran: str):
    """(sent fraction or None, wire fraction) of one wire step: the payload
    layout's bits, group by group, over a dense fp32 all-reduce's."""
    ns = _group_sizes(dp, gran)
    chunk = dp.CompressionConfig(granularity=gran).resolved_terngrad_chunk
    sent = bits = 0
    for n in ns:
        if label == "topk":
            k = compressors.topk_keep_count(n, RATIO)
            sent, bits = sent + k, bits + 64 * k
        elif label == "randomk":
            k = compressors.randomk_keep_count(n, RATIO)
            sent, bits = sent + k, bits + 32 * k
        elif label == "blocktopk":
            kb = compressors.blocktopk_keep_blocks(n, RATIO, 256)
            k = min(kb * 256, n)
            sent, bits = sent + k, bits + (32 * n if k >= n else 32 * k + 32 * kb)
        elif label in ("thresholdv", "adaptivethreshold"):
            bits += 64 * max(1, int(round(0.05 * n)))
        elif label == "terngrad":
            sent += n
            bits += 8 * -(-n // 4) + 32 * compressors.terngrad_num_chunks(n, chunk)
        else:  # randomdithering, s = 255
            sent += n
            bits += 8 * n + 8 * -(-n // 8) + 32
    dense = sum(ns)
    return (None if label in ("thresholdv", "adaptivethreshold") else sent / dense,
            bits / (32 * dense))


def phase_train(kernels, compressors, dawn, torch, record):
    """The main path: dawn at full width, every method at layerwise and
    entiremodel."""
    from tpu_compressed_dp_torch.parallel import dp

    card = record["card"]
    runs = {}
    plan = [(label, flags, must, "simulate") for label, (flags, must) in TRAIN_RUNS.items()]
    plan += [(label, flags, must, "wire") for label, (flags, must) in WIRE_RUNS.items()]
    for label, flags, must, mode in plan:
        grans = ("layerwise", "entiremodel") + (("bucketed",) if mode == "wire" else ())
        for gran in grans:
            argv = ["--network", "resnet9", "--synthetic", "--synthetic_n", "2048",
                    "--batch_size", "512", "--epochs", "1", "--compress", gran, *flags,
                    "--mode", mode, "--device", "cuda", "--seed", "0", "--log_dir", ""]
            kernels.reset_launches()
            t0 = time.perf_counter()
            summary = dawn.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            steps = summary["steps"]
            loss = summary["train loss"]
            sent, wire = summary["sent frac"], summary["wire frac"]
            name = f"{label} {gran}" if mode == "simulate" else f"wire {label} {gran}"
            if not math.isfinite(loss) or not math.isfinite(summary["test loss"]):
                raise AssertionError(f"{name}: non-finite loss {loss}")
            if label == "topk" and abs(sent - RATIO) > 0.1 * RATIO:
                raise AssertionError(f"{name}: sent frac {sent} is not ~{RATIO}")
            if mode == "wire":
                # the measured bits of the payload tensors are the layout's
                want_sent, want_wire = wire_layout(compressors, dp, label, gran)
                if want_sent is None:
                    want_sent = sent if 0 < sent <= want_wire / 2 else math.nan
                if sent != want_sent or abs(wire - want_wire) > 1e-12 * want_wire:
                    raise AssertionError(f"{name}: sent frac {sent} / wire frac {wire} are not "
                                         f"the layout's {want_sent} / {want_wire}")
            else:
                want_sent = expected_sent(compressors, dp, gran) if label == "randomk" else sent
                if sent != want_sent:
                    raise AssertionError(f"{name}: sent frac {sent} is not the billed keep "
                                         f"count {want_sent}")
                want_wire = {"terngrad": 2 / 32, "randomdithering": 9 / 32}.get(label)
                if want_wire is not None and abs(wire - want_wire) > 1e-6 * want_wire:
                    raise AssertionError(f"{name}: wire frac {wire} is not {want_wire}")
            if must and min(launches[k] for k in must) <= 0:
                raise AssertionError(f"{name}: a kernel of the run never launched: {launches}")
            ms = summary["train time"] * 1e3 / steps
            log(f"train {name}: {steps} steps, loss {loss:.4f}, sent frac {sent:.6f}, wire frac "
                f"{wire:.6f}, {ms:.2f} ms/step (first epoch, warm-up included) on {card}, run "
                f"wall {wall:.2f} s, launches {launches}")
            runs[name] = {"summary": summary, "launches": launches, "ms_per_step": ms}
    em = runs["topk entiremodel"]
    if em["launches"]["count_edges"] < em["summary"]["steps"]:
        raise AssertionError("entiremodel did not take the sampled first round every step")
    # entire-model TernGrad quantises 4 chunks of 2^21 through the prescaled
    # call: one launch per step
    if (compressors.terngrad_num_chunks(FULL_MODEL, 1 << 21) != 4
            or runs["terngrad entiremodel"]["launches"]["terngrad"]
            != runs["terngrad entiremodel"]["summary"]["steps"]):
        raise AssertionError("entiremodel TernGrad did not take the chunked, prescaled call")
    record["train"] = runs
    return runs


# phase 3b's runs, the paper's CIFAR configs 2-3 (BASELINE.json) and the
# other nets: label -> (network, dawn flags, the kernels the run must launch)
_TOPK = ["--method", "topk", "--ratio", str(RATIO), "--error_feedback"]
ALEXNET_TOPK = ("count_ge", "search_init", "fused_sparsify")
CIFAR_RUNS = {
    "config 2 vgg16 topk layerwise": ("vgg16", ["--compress", "layerwise", *_TOPK],
                                      TOPK_KERNELS),
    "config 2 vgg16 wire topk entiremodel": (
        "vgg16", ["--mode", "wire", "--compress", "entiremodel", *_TOPK], ("select_pack",)),
    "config 3a alexnet_module topk entiremodel": (
        "alexnet_module", ["--compress", "entiremodel", *_TOPK], TOPK_KERNELS),
    "config 3b alexnet_module randomk entiremodel": (
        "alexnet_module", ["--compress", "entiremodel", "--method", "randomk", "--ratio",
                           str(RATIO), "--error_feedback"], ("uniform",)),
    # the graph AlexNet's leaves (<= 884,736) are below the sampled round's
    # size: its searches run full-range rounds only
    **{f"{net} topk layerwise": (net, ["--compress", "layerwise", *_TOPK], must)
       for net, must in (("alexnet", ALEXNET_TOPK), ("resnet9_graph", TOPK_KERNELS),
                         ("alexnet_graph", ALEXNET_TOPK))},
    **{f"{net} bf16 topk layerwise": (net, ["--compress", "layerwise", "--dtype", "bfloat16",
                                            *_TOPK], must)
       for net, must in (("resnet9", TOPK_KERNELS), ("alexnet", ALEXNET_TOPK))},
    **{f"resnet9 powersgd {gran}": ("resnet9", ["--compress", gran, "--method", "powersgd",
                                                "--rank", "4", "--error_feedback"], ())
       for gran in ("layerwise", "entiremodel")},
}


def phase_cifar(kernels, compressors, dawn, torch, record):
    """3b: the paper's CIFAR configs 2 and 3 and the graph-family nets at
    full width through ``dawn.main``, 4 steps of batch 512 each."""
    import numpy as np

    from tpu_compressed_dp_torch.ops import lowrank
    from tpu_compressed_dp_torch.parallel import dp

    def billed(elems: float, dense: float) -> float:
        # the step's stats are float32 tensors: past 2^24 (VGG16's 134 M)
        # the counts are held rounded to float32, and so is the fraction
        return float(np.float32(elems)) / float(np.float32(dense))

    card = record["card"]
    t_phase = time.perf_counter()
    runs = {}
    for label, (network, flags, must) in CIFAR_RUNS.items():
        argv = ["--network", network, "--synthetic", "--synthetic_n", "2048", "--batch_size",
                "512", "--epochs", "1", *flags, "--device", "cuda", "--seed", "0",
                "--log_dir", ""]
        gran = flags[flags.index("--compress") + 1]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        summary = dawn.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        steps, loss = summary["steps"], summary["train loss"]
        sent, wire = summary["sent frac"], summary["wire frac"]
        if steps != 4 or not (math.isfinite(loss) and math.isfinite(summary["test loss"])):
            raise AssertionError(f"{label}: {steps} steps, loss {loss}")
        ns = _group_sizes(dp, gran, network)
        dense = sum(ns)
        if "wire" in label:
            # the measured bits of the (value, index) payloads are the layout's
            keep = sum(compressors.topk_keep_count(n, RATIO) for n in ns)
            want_sent, want_wire = billed(keep, dense), billed(64 * keep, dense) / 32
            if sent != want_sent or abs(wire - want_wire) > 1e-12 * want_wire:
                raise AssertionError(f"{label}: sent {sent} / wire {wire} are not the "
                                     f"layout's {want_sent} / {want_wire}")
        elif "randomk" in label:
            # the billed keep counts, at a (value, index) pair each
            keep = sum(compressors.randomk_keep_count(n, RATIO) for n in ns)
            want_sent, want_wire = billed(keep, dense), billed(64 * keep, dense) / 32
            if sent != want_sent or abs(wire - want_wire) > 1e-12 * want_wire:
                raise AssertionError(f"{label}: sent {sent} / wire {wire} are not the keep "
                                     f"count's {want_sent} / {want_wire}")
        elif "powersgd" in label:
            bits = sum(lowrank.powersgd_group_bits(n, 4) for n in ns)
            want = billed(bits, dense) / 32
            if abs(wire - want) > 1e-12 * want or abs(sent - want) > 1e-12 * want:
                raise AssertionError(f"{label}: sent {sent} / wire {wire} are not the factor "
                                     f"bits' {want}")
        elif abs(sent - RATIO) > 0.1 * RATIO:
            raise AssertionError(f"{label}: sent frac {sent} is not ~{RATIO}")
        if must and min(launches[k] for k in must) <= 0:
            raise AssertionError(f"{label}: a kernel of the run never launched: {launches}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = summary["train time"] * 1e3 / steps
        log(f"cifar {label}: {steps} steps, loss {loss:.4f}, sent frac {sent:.6f}, wire frac "
            f"{wire:.6f}, {ms:.2f} ms/step (first epoch, warm-up included), peak "
            f"{peak:.2f} GiB, run wall {wall:.2f} s on {card}, launches {launches}")
        runs[label] = {"summary": summary, "launches": launches, "ms_per_step": ms,
                       "peak_gib": peak, "groups": len(ns)}
    vgg = runs["config 2 vgg16 topk layerwise"]
    if vgg["launches"]["count_edges"] < vgg["summary"]["steps"]:
        raise AssertionError("VGG16's fc1 did not take the sampled first round every step")
    wall = time.perf_counter() - t_phase
    log(f"phase 3b (CIFAR configs 2-3, graph nets, bf16, PowerSGD) wall {wall:.1f} s on {card}")
    record["cifar"] = {"runs": runs, "wall_s": wall}
    return runs


def _category(name: str) -> str:
    low = name.lower()
    if "flash_" in name:
        return "flash attention (port CUDA kernels)"
    if any(k in name for k in ("count_ge_edges_kernel", "search_init_kernel",
                                "fused_sparsify_kernel",
                                "uniform_kernel", "qsgd_kernel", "terngrad_kernel",
                                "count_kernel", "scan_kernel", "scatter_kernel",
                                "terngrad_pack_kernel", "qsgd_pack_kernel",
                                "route_kernel", "pack_kernel", "bytes_kernel")):
        return "port CUDA kernels"
    if "sort" in low or "topk" in low or "radix" in low:
        return "torch.topk (exact threshold, small leaves)"
    if any(k in low for k in ("conv", "xmma", "cudnn", "gemm", "wgrad", "dgrad", "sm90",
                              "nvjet", "cutlass")):
        return "convolution / matmul"
    if "nccl" in low:
        return "nccl"
    if "reduce" in low:
        return "reductions"
    return "elementwise and other"


def device_profile(run, torch, n_steps: int = 3, port_launches: bool = False) -> dict:
    """torch.profiler over ``run(n_steps)``: device busy time per step (the
    union of kernel intervals), idle share of the wall time, and device time
    by kernel category and by the top kernels; with ``port_launches``, also
    the port's kernels launch by launch (name, device µs) in time order."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n_steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return {"device": "not measured"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    by_name, by_cat = {}, {}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        by_cat[_category(e.name)] = by_cat.get(_category(e.name), 0.0) + us
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    top = ranked[:8]
    # each category's three largest kernels
    cat_top = {}
    for k, v in ranked:
        row = cat_top.setdefault(_category(k), [])
        if len(row) < 3:
            row.append((k[:80], v / 1e3 / n_steps))
    out = {"wall_ms_per_step": wall_us / 1e3 / n_steps,
           "device_busy_ms_per_step": busy / 1e3 / n_steps,
           "idle_share": 1.0 - busy / wall_us,
           "launches_per_step": len(kern) / n_steps,
           "by_category_ms_per_step": {k: v / 1e3 / n_steps for k, v in
                                       sorted(by_cat.items(), key=lambda kv: -kv[1])},
           "top_kernels_ms_per_step": [(k[:80], v / 1e3 / n_steps) for k, v in top],
           "top_kernels_by_category_ms_per_step": cat_top}
    if port_launches:
        port = sorted((e.time_range.start, e.name, e.time_range.end - e.time_range.start)
                      for e in kern if _category(e.name) == "port CUDA kernels")
        out["port_launches_us"] = [
            (name.replace("void ", "").replace("(anonymous namespace)::", "")[:48], us)
            for _, name, us in port]
    return out


def phase_steady(torch, record):
    """Steady-state step time and sync-only time per granularity."""
    import numpy as np

    from tpu_compressed_dp_torch.data import cifar10 as data
    from tpu_compressed_dp_torch.models.common import make_normalizing_apply_fn
    from tpu_compressed_dp_torch.models.resnet9 import ResNet9, param_leaves
    from tpu_compressed_dp_torch.parallel.dp import (CompressionConfig, init_ef_state,
                                                     make_grad_sync)
    from tpu_compressed_dp_torch.train.optim import SGD
    from tpu_compressed_dp_torch.train.state import TrainState
    from tpu_compressed_dp_torch.train.step import make_train_step

    dev = torch.device("cuda")
    ds = data.synthetic_cifar10(n_train=512, n_test=8)
    x = torch.from_numpy(ds["train"]["data"]).to(dev)
    y = torch.from_numpy(ds["train"]["labels"]).to(dev)
    apply_fn = make_normalizing_apply_fn(np.asarray(data.CIFAR10_MEAN) * 255.0,
                                         np.asarray(data.CIFAR10_STD) * 255.0)
    out = {}
    rows = [("dense", None, "layerwise", "simulate")]
    for method in ("topk", "randomk", "terngrad", "qsgd"):
        rows += [(f"{method} {gran}", method, gran, "simulate")
                 for gran in ("layerwise", "entiremodel")]
    for method in ("topk", "terngrad", "qsgd"):
        rows += [(f"wire {method} {gran}", method, gran, "wire")
                 for gran in ("layerwise", "entiremodel")]
    for label, method, gran, mode in rows:
        cfg = CompressionConfig(method=method, granularity=gran, ratio=RATIO, mode=mode,
                                error_feedback=method in ("topk", "randomk"))
        model = ResNet9(seed=0, device=dev)
        params = param_leaves(model)
        opt = SGD(lr=1e-4, momentum=0.9, nesterov=True, weight_decay=0.256)
        state = TrainState.create(model, opt.init(params), init_ef_state(params, cfg))
        step = make_train_step(apply_fn, opt, cfg, grad_scale=512.0)
        batch = {"input": x, "target": y}
        for _ in range(3):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        n_steps = 10
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        holder = {"state": state}

        def run(k):
            for _ in range(k):
                holder["state"], _ = step(holder["state"], batch)

        prof = device_profile(run, torch)
        state = holder["state"]
        grads = {k: torch.randn(p.shape, device=dev) * 1e-2 for k, p in params.items()}
        sync = make_grad_sync(cfg)
        ef = init_ef_state(params, cfg)
        sync_ms = time_ms(lambda g: sync(g, ef, 0), [grads], reps=10, inner=5)
        out[label] = {"step_ms": step_ms, "img_s": 512 / step_ms * 1e3, "sync_ms": sync_ms,
                      "profile": prof}
        log(f"steady {label}: {step_ms:.3f} ms/step ({512 / step_ms * 1e3:.0f} img/s), "
            f"gradient sync alone {sync_ms:.3f} ms, on {record['card']}")
        log(f"profile {label}: {json.dumps(prof)}")
        del state, model, params, grads
    record["steady"] = out


# phase 4b's rows: label -> (network, dtype, method, granularity)
CIFAR_STEADY = {
    "vgg16 dense": ("vgg16", "float32", None, "layerwise"),
    "vgg16 topk layerwise": ("vgg16", "float32", "topk", "layerwise"),
    "alexnet_module dense": ("alexnet_module", "float32", None, "layerwise"),
    "alexnet_module topk entiremodel": ("alexnet_module", "float32", "topk", "entiremodel"),
    "alexnet_module randomk entiremodel": ("alexnet_module", "float32", "randomk",
                                           "entiremodel"),
    "resnet9 dense fp32": ("resnet9", "float32", None, "layerwise"),
    "resnet9 dense bf16": ("resnet9", "bfloat16", None, "layerwise"),
    "resnet9 powersgd layerwise": ("resnet9", "float32", "powersgd", "layerwise"),
    "resnet9 powersgd entiremodel": ("resnet9", "float32", "powersgd", "entiremodel"),
}


def phase_steady_cifar(torch, record):
    """4b: steady-state steps (batch 512) and the sync alone of the rows
    above, with peak memory and the profile's idle share."""
    import numpy as np

    from tpu_compressed_dp_torch.data import cifar10 as data
    from tpu_compressed_dp_torch.harness import dawn
    from tpu_compressed_dp_torch.models.common import make_normalizing_apply_fn, param_leaves
    from tpu_compressed_dp_torch.parallel.dp import (CompressionConfig, init_comp_state,
                                                     init_ef_state, make_stateful_grad_sync)
    from tpu_compressed_dp_torch.train.optim import SGD
    from tpu_compressed_dp_torch.train.state import TrainState
    from tpu_compressed_dp_torch.train.step import make_train_step

    card = record["card"]
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ds = data.synthetic_cifar10(n_train=512, n_test=8)
    batch = {"input": torch.from_numpy(ds["train"]["data"]).to(dev),
             "target": torch.from_numpy(ds["train"]["labels"]).to(dev)}
    apply_fn = make_normalizing_apply_fn(np.asarray(data.CIFAR10_MEAN) * 255.0,
                                         np.asarray(data.CIFAR10_STD) * 255.0)
    out = {}
    for label, (network, dtype, method, gran) in CIFAR_STEADY.items():
        cfg = CompressionConfig(method=method, granularity=gran, ratio=RATIO, rank=4,
                                error_feedback=method is not None)
        model = dawn.MODELS[network](1.0, dawn.DTYPES[dtype], 0, dev)
        params = param_leaves(model)
        opt = SGD(lr=1e-4, momentum=0.9, nesterov=True, weight_decay=0.256)
        state = TrainState.create(model, opt.init(params), init_ef_state(params, cfg),
                                  comp=init_comp_state(params, cfg))
        step = make_train_step(apply_fn, opt, cfg, grad_scale=512.0)
        for _ in range(3):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n_steps = 6
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        holder = {"state": state}

        def run(k):
            for _ in range(k):
                holder["state"], _ = step(holder["state"], batch)

        prof = device_profile(run, torch, n_steps=2)
        state = holder["state"]
        grads = {k: torch.randn(p.shape, device=dev) * 1e-2 for k, p in params.items()}
        sync = make_stateful_grad_sync(cfg)
        ef, comp = init_ef_state(params, cfg), init_comp_state(params, cfg)
        sync_ms = time_ms(lambda g: sync(g, ef, comp, 0), [grads], reps=5, inner=3)
        if not math.isfinite(float(m["loss"])):
            raise AssertionError(f"steady {label}: non-finite loss")
        out[label] = {"step_ms": step_ms, "img_s": 512 / step_ms * 1e3, "sync_ms": sync_ms,
                      "peak_gib": peak, "profile": prof}
        log(f"steady {label}: {step_ms:.3f} ms/step ({512 / step_ms * 1e3:.0f} img/s), "
            f"gradient sync alone {sync_ms:.3f} ms, peak {peak:.2f} GiB, idle share "
            f"{prof.get('idle_share', 'not measured')}, on {card}")
        log(f"profile {label}: {json.dumps(prof)}")
        del state, model, params, grads, ef, comp, holder, step, sync
        gc.collect()
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"phase 4b wall {wall:.1f} s on {card}")
    record["steady_cifar"] = out


# the multi-rank phase's dawn runs: world -> (label, method, transport, dp_pods)
RANK_RUNS = {2: ("wire topk entiremodel sharded", "topk", "sharded", 1),
             4: ("wire thresholdv entiremodel hierarchical 2 pods", "thresholdv",
                 "hierarchical", 2)}
LOSSLESS = 1e6  # capacity factors at which every cap clamps to its lossless bound
FACTOR_KEYS = ("shard_route_factor", "shard_return_factor", "hier_route_factor_ici",
               "hier_route_factor_dcn")
BITS_KEYS = ("sent_bits", "sent_bits_psum", "sent_bits_allgather", "sent_bits_alltoall",
             "sent_bits_ici", "sent_bits_dcn", "sent_bits_dcn_route")


def analytic_bits(dp, cfg, name: str, sizes, world: int) -> dict:
    """The ``sent_bits_*`` a wire sync of these leaf sizes bills: each
    group's sharded route/return or hierarchical ICI/DCN bits, or the dense
    all-reduce of a keep-all Block-Top-K group."""
    out = dict.fromkeys(BITS_KEYS, 0.0)
    for g in dp.make_leaf_groups([4 * n for n in sizes], cfg.granularity,
                                 cfg.bucket_mb * dp.BUCKET_MB):
        n = sum(sizes[i] for i in g)
        transport = dp.wire_transport(name, n, cfg)
        if transport == "sharded":
            route, ret = dp._sharded_group_bits(name, n, world, cfg)
            out["sent_bits_alltoall"] += route
            out["sent_bits_allgather"] += ret
            out["sent_bits"] += route + ret
        elif transport == "hierarchical":
            ici, rt, ret = dp._hier_group_bits(name, n, world, cfg)
            out["sent_bits_ici"] += ici
            out["sent_bits_dcn"] += rt + ret
            out["sent_bits_dcn_route"] += rt
            out["sent_bits"] += ici + rt + ret
        elif transport == "psum":
            out["sent_bits_psum"] += 32.0 * n
            out["sent_bits"] += 32.0 * n
        else:
            raise AssertionError(f"{name}: a group on the {transport} transport")
    return out


def _rank_sync_checks(torch, world: int, rank: int, card: str) -> dict:
    """One rank's share of the sync-alone checks and timings (every rank runs
    the same collectives in the same order)."""
    import numpy as np

    from tpu_compressed_dp_torch.models.resnet9 import ResNet9, param_leaves
    from tpu_compressed_dp_torch.parallel import dp, mesh

    dev = torch.device("cuda", 0)
    params = param_leaves(ResNet9(seed=0, device=dev))
    names = list(params)
    sizes = [params[k].numel() for k in names]
    gen = torch.Generator(device=dev).manual_seed(1000 + rank)
    grads = {k: torch.randn(params[k].shape, generator=gen, device=dev) * 1e-2 for k in names}
    ef0 = {k: torch.randn(params[k].shape, generator=gen, device=dev) * 1e-3 for k in names}
    flat = lambda t: torch.cat([t[k].reshape(-1) for k in names])  # noqa: E731
    acc = flat(grads) + flat(ef0)
    methods = {"topk": dict(method="topk", ratio=RATIO),
               "thresholdv": dict(method="thresholdv"),
               "blocktopk": dict(method="blocktopk", ratio=RATIO)}
    checks = []
    for label, mkw in methods.items():
        for gran in ("layerwise", "entiremodel"):
            base = dict(mode="wire", granularity=gran, error_feedback=True, **mkw)
            ag_out, ag_ef, ag_stats = dp.make_grad_sync(dp.CompressionConfig(**base))(
                grads, ef0, 11)
            for transport in ("sharded", "hierarchical"):
                for factors in ("lossless", "default"):
                    kw = dict(base, transport=transport,
                              dp_pods=2 if transport == "hierarchical" else 1)
                    if factors == "lossless":
                        kw.update(dict.fromkeys(FACTOR_KEYS, LOSSLESS))
                    cfg = dp.CompressionConfig(**kw)
                    out, ef, stats = dp.make_grad_sync(cfg)(grads, ef0, 11)
                    name = f"{label} {gran} {transport} {factors}"
                    ovf = stats["shard_overflow"].item()
                    row = {"name": name, "shard_overflow": ovf}
                    if factors == "lossless":
                        if transport == "sharded":
                            same = all(torch.equal(out[k].view(torch.int32),
                                                   ag_out[k].view(torch.int32))
                                       and torch.equal(ef[k].view(torch.int32),
                                                       ag_ef[k].view(torch.int32))
                                       for k in names)
                            if not same:
                                raise AssertionError(f"{name}: not bitwise == allgather")
                            row["max_diff"] = 0.0
                        else:
                            d = max(max((out[k] - ag_out[k]).abs().max().item(),
                                        (ef[k] - ag_ef[k]).abs().max().item()) for k in names)
                            if not d <= 1e-6:
                                raise AssertionError(f"{name}: {d} from allgather")
                            row["max_diff"] = d
                        if ovf != 0:
                            raise AssertionError(f"{name}: clipped {ovf} at lossless factors")
                    else:
                        # what the workers kept out of EF is what the synced
                        # gradient holds: mean over the world of acc - new_ef
                        kept = mesh.all_reduce_sum(acc - flat(ef)) / world
                        d = (kept - flat(out)).abs().max().item()
                        worst = mesh.all_reduce_sum(torch.tensor([ovf], device=dev)).item()
                        if not (d <= 1e-6 and worst > 0):
                            raise AssertionError(f"{name}: EF identity off by {d}, world "
                                                 f"overflow {worst}")
                        row["ef_identity_diff"] = d
                    want = analytic_bits(dp, cfg, cfg.method, sizes, world)
                    got = {k: stats[k].item() for k in BITS_KEYS}
                    if got != {k: float(np.float32(v)) for k, v in want.items()}:
                        raise AssertionError(f"{name}: bits {got} are not the analytic {want}")
                    row["sent_bits"] = got
                    checks.append(row)
    # sync alone, Top-K 1 % + EF, default factors; gloo through host memory
    # on one card, so a time of the host and of gloo, not of a link
    sync_ms = {}
    for gran in ("layerwise", "entiremodel"):
        for transport in ("allgather", "sharded", "hierarchical"):
            cfg = dp.CompressionConfig(method="topk", ratio=RATIO, mode="wire", granularity=gran,
                                       error_feedback=True, transport=transport,
                                       dp_pods=2 if transport == "hierarchical" else 1)
            sync = dp.make_grad_sync(cfg)
            for _ in range(2):
                sync(grads, ef0, 11)
            torch.cuda.synchronize()
            samples = []
            for _ in range(5):
                t0 = time.perf_counter()
                sync(grads, ef0, 11)
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t0) * 1e3)
            sync_ms[f"topk {gran} {transport}"] = sorted(samples)[2]
    if world == 2:
        checks += _rank_powersgd_checks(torch, dp, mesh, params, grads, ef0, world)
    if rank == 0:
        log(f"ranks W={world}: {len(checks)} sync checks passed on {card}; sync alone (gloo "
            f"through host memory on one card, not a link timing), median ms: {sync_ms}")
    return {"checks": checks, "sync_ms": sync_ms}


def _rank_powersgd_checks(torch, dp, mesh, params, grads, ef0, world: int) -> list:
    """PowerSGD rank 4 + EF over the ranks' different full-width ResNet-9
    gradients: the result equals the W = 1 sync of the ranks' mean gradient
    and EF within 1e-5 of each leaf's largest entry (every nonlinear step
    follows a mean), and ``sync_agree`` reads 1."""
    checks = []
    for gran in ("layerwise", "entiremodel"):
        cfg = dp.CompressionConfig(method="powersgd", rank=4, granularity=gran,
                                   error_feedback=True, check_sync=True)
        comp = dp.init_comp_state(params, cfg)
        sync = dp.make_stateful_grad_sync(cfg)
        out, _, q, stats = sync(grads, ef0, comp, 11)
        mean_g = {k: mesh.all_reduce_sum(v) / world for k, v in grads.items()}
        mean_e = {k: mesh.all_reduce_sum(v) / world for k, v in ef0.items()}
        # the same engine at W = 1: the default group's size read as 1 skips
        # its all-reduces
        group_world = mesh.world
        mesh.world = lambda: 1
        try:
            ref, _, q_ref, _ = sync(mean_g, mean_e, comp, 11)
        finally:
            mesh.world = group_world
        d = max(((out[k] - ref[k]).abs().max() / ref[k].abs().max()).item() for k in out)
        dq = max(((q[k] - q_ref[k]).abs().max() / q_ref[k].abs().max()).item() for k in q)
        agree = stats["sync_agree"].item()
        if not (d <= 1e-5 and dq <= 1e-5 and agree == 1.0):
            raise AssertionError(f"powersgd {gran}: W={world} vs W=1 on the mean {d}, Q {dq}, "
                                 f"sync_agree {agree}")
        checks.append({"name": f"powersgd {gran} W={world} vs W=1 on the mean",
                       "max_rel_diff": d, "q_max_rel_diff": dq, "sync_agree": agree})
    return checks


def rank_worker(world: int, rank: int, port: int, out_path: str) -> int:
    """One rank of the multi-rank phase (``--rank_worker``)."""
    import torch

    from tpu_compressed_dp_torch.harness import dawn
    from tpu_compressed_dp_torch.ops import kernels
    from tpu_compressed_dp_torch.parallel import dp, mesh

    dev = torch.device("cuda", 0)
    mesh.init_process_group(dev, backend="gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        kernels.build()      # the parent built them: this loads the libraries
        card = nvidia_smi() if rank == 0 else ""
        result = _rank_sync_checks(torch, world, rank, card)
        if world == 2:
            # the chunked sync's async all-reduces across ranks: each rank's
            # own data, full-width ResNet-50, sync_overlap 4 against 1
            batch = _image_batch(torch, dev, 16, 128, 40 + rank)
            result["overlap"] = {m: _overlap_pair(torch, dev, m, batch)
                                 for m in ("randomk", "topk")}
        label, method, transport, pods = RANK_RUNS[world]
        argv = ["--network", "resnet9", "--synthetic", "--synthetic_n", "1024",
                "--batch_size", "512", "--epochs", "1", "--method", method, "--ratio",
                str(RATIO), "--error_feedback", "--compress", "entiremodel", "--mode", "wire",
                "--transport", transport, "--dp_pods", str(pods), "--device", "cuda",
                "--seed", "0", "--log_dir", ""]
        kernels.reset_launches()
        t0 = time.perf_counter()
        summary = dawn.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        cfg = dp.CompressionConfig(method=method, ratio=RATIO, mode="wire",
                                   granularity="entiremodel", error_feedback=True,
                                   transport=transport, dp_pods=pods)
        want_wire = (analytic_bits(dp, cfg, cfg.method, [FULL_MODEL], world)["sent_bits"]
                     / (32.0 * FULL_MODEL))
        loss, wire = summary["train loss"], summary["wire frac"]
        if summary["steps"] != 2 or not (math.isfinite(loss)
                                          and math.isfinite(summary["test loss"])):
            raise AssertionError(f"{label}: {summary['steps']} steps, loss {loss}")
        if abs(wire - want_wire) > 1e-6 * want_wire:
            raise AssertionError(f"{label}: wire frac {wire} is not the analytic {want_wire}")
        if launches["bucket_route"] < 1 or launches["select_pack"] < 1:
            raise AssertionError(f"{label}: the route kernels never launched: {launches}")
        result["train"] = {"label": label, "summary": summary, "launches": launches,
                           "wall_s": wall, "want_wire": want_wire}
        with open(out_path, "w") as f:
            json.dump(result, f, default=str)
    finally:
        mesh.destroy()
    return 0


def phase_multirank(torch, record):
    """W = 2, then W = 4 worker processes on the card, joined by gloo."""
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    out_dir = os.path.join(HERE, "build", "chip_smoke_ranks")
    os.makedirs(out_dir, exist_ok=True)
    worlds = {}
    for world in (2, 4):
        port = free_port()
        paths = [os.path.join(out_dir, f"w{world}_rank{r}.json") for r in range(world)]
        for path in paths:
            if os.path.exists(path):
                os.remove(path)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank_worker",
                                   str(world), str(r), str(port), paths[r]],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, logs)):
            if rank_log := text.strip():
                for line in rank_log.splitlines()[-40:]:
                    log(f"[W={world} rank {r}] {line}")
            if p.returncode != 0:
                raise AssertionError(f"W={world} rank {r} exited {p.returncode}")
        results = []
        for path in paths:
            with open(path) as f:
                results.append(json.load(f))
        for r, res in enumerate(results):
            if "overlap" in res and not all(res["overlap"].values()):
                raise AssertionError(f"W={world} rank {r}: sync_overlap 4 differs from 1: "
                                     f"{res['overlap']}")
            if "overlap" in res:
                log(f"[W={world} rank {r}] resnet50 layerwise 1 % + EF, sync_overlap 4 bitwise "
                    f"== 1 (one sync, 2 steps): {res['overlap']}")
        launches = {k: sum(res["train"]["launches"][k] for res in results)
                    for k in results[0]["train"]["launches"]}
        tr = results[0]["train"]
        log(f"ranks W={world} train {tr['label']}: {tr['summary']['steps']} steps, loss "
            f"{tr['summary']['train loss']:.4f}, wire frac {tr['summary']['wire frac']:.6f} "
            f"(analytic {tr['want_wire']:.6f}), sent frac {tr['summary']['sent frac']:.6f}, "
            f"launches summed over ranks {launches}, world wall {wall:.1f} s")
        worlds[world] = {"ranks": results, "launches": launches, "wall_s": wall}
    record["multirank"] = worlds
    return worlds


# ---------------------------------------------------------------------------
# The ImageNet slice: ResNet-50 at full width
# ---------------------------------------------------------------------------

RESNET50_PARAMS = 25_557_032   # every ResNet-50 parameter, the entire-model group
# the reference's per-GPU phases (one_machine_phases' global batches over 8
# GPUs), one epoch each: 1,024 synthetic images give 2, 4 and 8 steps
IMAGENET_PHASES = json.dumps([
    {"ep": 0, "sz": 128, "bs": 512}, {"ep": [0, 3], "lr": [0.1, 0.1]},
    {"ep": 1, "sz": 224, "bs": 224},
    {"ep": 2, "sz": 288, "bs": 128, "min_scale": 0.5, "rect_val": True}])
IMAGENET_RUNS = {"resnet50 dense": ([], ()),
                 "resnet50 topk layerwise": (["--compress", "layerwise", *_TOPK],
                                             ("count_ge", "search_init", "fused_sparsify"))}


def phase_imagenet(kernels, imagenet, torch, record):
    """8: full-width bf16 ResNet-50 through the port's ImageNet entry point
    (``harness.imagenet.main``) on synthetic ImageNet, the port's loaders
    and native crop-resize, progressive resizing over the reference's
    per-GPU phases (rect val in the last), dense and layer-wise Top-K 1 %
    + EF."""
    card = record["card"]
    t_phase = time.perf_counter()
    runs = {}
    for label, (flags, must) in IMAGENET_RUNS.items():
        argv = ["--synthetic", "--synthetic_n", "1024", "--phases", IMAGENET_PHASES,
                "--seed", "0", "--device", "cuda", *flags]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        summary = imagenet.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        loss = summary["train loss"]
        if summary["epoch"] != 2 or summary["steps"] != 8 or not (
                math.isfinite(loss) and math.isfinite(summary["test loss"])):
            raise AssertionError(f"imagenet {label}: epoch {summary['epoch']}, "
                                 f"{summary['steps']} steps, loss {loss}")
        if must:
            if abs(summary["sent frac"] - RATIO) > 0.1 * RATIO:
                raise AssertionError(f"imagenet {label}: sent frac {summary['sent frac']}")
            if min(launches[k] for k in must) <= 0:
                raise AssertionError(f"imagenet {label}: a kernel never launched: {launches}")
        log(f"imagenet {label}: last phase (288 px, bs 128, rect val) {summary['steps']} steps, "
            f"loss {loss:.4f}, {summary['img/s']} img/s (first epoch of the phase, warm-up "
            f"included), MFU {summary.get('mfu')}, sent frac {summary.get('sent frac')}, "
            f"peak {peak:.2f} GiB, run wall {wall:.1f} s on {card}, launches {launches}")
        runs[label] = {"summary": summary, "launches": launches, "peak_gib": peak,
                       "wall_s": wall}
    wall = time.perf_counter() - t_phase
    log(f"phase 8 (ImageNet ResNet-50 harness) wall {wall:.1f} s on {card}")
    record["imagenet"] = {"runs": runs, "wall_s": wall}
    return runs


# phase 8b's rows: label -> (method, granularity, mode, sync_overlap)
IMAGENET_STEADY = {
    "dense": (None, "layerwise", "simulate", 1),
    "topk layerwise": ("topk", "layerwise", "simulate", 1),
    "topk entiremodel": ("topk", "entiremodel", "simulate", 1),
    "randomk layerwise overlap 1": ("randomk", "layerwise", "simulate", 1),
    "randomk layerwise overlap 4": ("randomk", "layerwise", "simulate", 4),
    "wire topk entiremodel": ("topk", "entiremodel", "wire", 1),
}


def _resnet50_step(torch, cfg, dev, lr: float = 0.1):
    """A full-width bf16 ResNet-50 (seed 0), its SGD, state and train step."""
    from tpu_compressed_dp_torch.data.imagenet import IMAGENET_MEAN, IMAGENET_STD
    from tpu_compressed_dp_torch.models import resnet
    from tpu_compressed_dp_torch.models.common import make_normalizing_apply_fn, param_leaves
    from tpu_compressed_dp_torch.parallel.dp import init_comp_state, init_ef_state
    from tpu_compressed_dp_torch.train.optim import SGD
    from tpu_compressed_dp_torch.train.state import TrainState
    from tpu_compressed_dp_torch.train.step import make_train_step

    model = resnet.resnet50(dtype=torch.bfloat16, seed=0, device=dev)
    params = param_leaves(model)
    opt = SGD(lr=lr, momentum=0.9, weight_decay=1e-4)
    state = TrainState.create(model, opt.init(params), init_ef_state(params, cfg), seed=1,
                              comp=init_comp_state(params, cfg))
    apply_fn = make_normalizing_apply_fn(IMAGENET_MEAN, IMAGENET_STD)
    return model, params, state, make_train_step(apply_fn, opt, cfg)


def _image_batch(torch, dev, n: int, hw: int, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"input": torch.randint(0, 256, (n, hw, hw, 3), generator=g, device=dev,
                                   dtype=torch.uint8),
            "target": torch.randint(0, 1000, (n,), generator=g, device=dev)}


def phase_steady_imagenet(kernels, torch, record):
    """8b: steady-state steps of full-width bf16 ResNet-50 at 224 px / batch
    224 (the reference's per-GPU batch of that phase) from a device-resident
    batch, and the sync alone, with peak memory, the profile's idle share,
    launches per step (the port's kernels and all kernels) and MFU."""
    from tpu_compressed_dp_torch.parallel.dp import (CompressionConfig, init_comp_state,
                                                     init_ef_state, make_stateful_grad_sync)
    from tpu_compressed_dp_torch.parallel.overlap import make_chunked_grad_sync
    from tpu_compressed_dp_torch.utils import flops

    card = record["card"]
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    bs, hw = 224, 224
    batch = _image_batch(torch, dev, bs, hw, 5)
    out = {}
    fwd = None
    for label, (method, gran, mode, k) in IMAGENET_STEADY.items():
        cfg = CompressionConfig(method=method, granularity=gran, mode=mode, ratio=RATIO,
                                error_feedback=method is not None, sync_overlap=k)
        model, params, state, step = _resnet50_step(torch, cfg, dev)
        if fwd is None:
            fwd = flops.cnn_fwd_flops(model, (bs, hw, hw, 3), dev)
        for _ in range(3):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        n_steps = 6
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        port_launches = {r: v / n_steps for r, v in kernels.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        holder = {"state": state}

        def run(n):
            for _ in range(n):
                holder["state"], _ = step(holder["state"], batch)

        prof = device_profile(run, torch, n_steps=2)
        state = holder["state"]
        if not math.isfinite(float(m["loss"])):
            raise AssertionError(f"steady imagenet {label}: non-finite loss")
        grads = {key: torch.randn(p.shape, device=dev) * 1e-2 for key, p in params.items()}
        sync = make_stateful_grad_sync(cfg) if k == 1 else make_chunked_grad_sync(cfg)
        ef, comp = init_ef_state(params, cfg), init_comp_state(params, cfg)
        sync_ms = time_ms(lambda g: sync(g, ef, comp, 0), [grads], reps=5, inner=3)
        mfu = 3.0 * fwd / (step_ms * 1e-3) / BF16_OPS_PER_S
        out[label] = {"step_ms": step_ms, "img_s": bs / step_ms * 1e3, "sync_ms": sync_ms,
                      "peak_gib": peak, "mfu": mfu, "port_launches_per_step": port_launches,
                      "profile": prof}
        log(f"steady imagenet resnet50 {label}: {step_ms:.3f} ms/step "
            f"({bs / step_ms * 1e3:.1f} img/s), gradient sync alone {sync_ms:.3f} ms, peak "
            f"{peak:.2f} GiB, idle share {prof.get('idle_share', 'not measured')}, launches "
            f"per step {prof.get('launches_per_step', 'not measured')} (port kernels "
            f"{port_launches}), MFU {mfu:.4f} (bf16 peak), on {card}")
        log(f"profile imagenet {label}: {json.dumps(prof)}")
        del state, model, params, grads, ef, comp, holder, step, sync
        gc.collect()
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"phase 8b wall {wall:.1f} s on {card}; forward {fwd / 1e9:.3f} GFLOP per batch of "
        f"{bs} at {hw} px")
    record["steady_imagenet"] = {"rows": out, "fwd_flops": fwd, "wall_s": wall}


def _overlap_pair(torch, dev, method: str, batch, n_steps: int = 2):
    """Two train steps of full-width bf16 ResNet-50 at ``sync_overlap`` 1 and
    4 (layer-wise, 1 % + EF) from the same init and batch, and the synced
    gradients, EF of one sync of the first step's gradients at both: True
    where every parameter, momentum, EF entry and BatchNorm statistic and
    every synced entry agree bitwise.  cuDNN runs its deterministic
    algorithms (its default weight-gradient kernels may add in another
    order from run to run)."""
    from tpu_compressed_dp_torch.models.common import param_leaves
    from tpu_compressed_dp_torch.parallel.dp import CompressionConfig, make_stateful_grad_sync
    from tpu_compressed_dp_torch.parallel.overlap import make_chunked_grad_sync

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ends, syncs = [], []
        for k in (1, 4):
            cfg = CompressionConfig(method=method, granularity="layerwise", ratio=RATIO,
                                    error_feedback=True, sync_overlap=k)
            model, params, state, step = _resnet50_step(torch, cfg, dev)
            g = torch.Generator(device=dev).manual_seed(99)
            grads = {key: torch.randn(p.shape, generator=g, device=dev) * 1e-2
                     for key, p in params.items()}
            sync = make_stateful_grad_sync(cfg) if k == 1 else make_chunked_grad_sync(cfg)
            synced, new_ef, _, _ = sync(grads, state.ef, state.comp, 123)
            syncs.append((synced, new_ef))
            for _ in range(n_steps):
                state, m = step(state, batch)
            ends.append((param_leaves(state.model), dict(state.model.named_buffers()),
                         state.opt_state["momentum"], state.ef))
            del model, params, state, step, grads
        same = all(list(a) == list(b) and all(_bits_equal(torch, a[key], b[key]) for key in a)
                   for a, b in zip(*ends))
        same_sync = all(all(_bits_equal(torch, a[key], b[key]) for key in a)
                        for a, b in zip(*syncs))
        return same and same_sync
    finally:
        torch.backends.cudnn.deterministic = deterministic
        gc.collect()
        torch.cuda.empty_cache()


def phase_resnet50_holds(kernels, compressors, torch, record):
    """8c: at the entire-model group's 25,557,032 elements, the threshold
    search bitwise against the unfused glue and the CPU search with
    ``count(|g| >= t) >= keep`` (``check_search``), ``fused_sparsify`` and
    ``select_pack`` bitwise against their plain versions; and on the card at
    W = 1, ``sync_overlap = 4`` bitwise ``sync_overlap = 1`` (Random-K and
    Top-K, layer-wise 1 % + EF: the synced gradients and EF of one sync, and
    parameters, momentum, EF and BatchNorm statistics after 2 steps of batch
    32 at 128 px)."""
    card = record["card"]
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    n = RESNET50_PARAMS
    x = torch.randn(n, generator=gen, device=dev) * 1e-2
    mag = x.abs()
    keep = compressors.topk_keep_count(n, RATIO)
    out = {"search": check_search(kernels, torch, mag, keep, f"n={n}")}
    t = kernels.topk_threshold(mag, keep)
    del mag
    for got, want in zip(kernels.fused_sparsify(x, t), kernels.fused_sparsify_plain(x, t)):
        if not _bits_equal(torch, got, want):
            raise AssertionError(f"fused_sparsify differs from its plain version at n={n}")
    _, out["select_pack_cases"] = hold_select_pack(kernels, torch, [("topk 1 %", x, t, keep)],
                                                   f"at n={n}")
    del x
    log(f"resnet50 entire model n={n}: search, fused_sparsify, select_pack bitwise == plain")
    batch = _image_batch(torch, dev, 32, 128, 8)
    for method in ("randomk", "topk"):
        if not _overlap_pair(torch, dev, method, batch):
            raise AssertionError(f"resnet50 {method} layerwise: sync_overlap 4 differs from 1")
        out[f"overlap {method} W=1"] = True
        log(f"resnet50 {method} layerwise 1 % + EF: sync_overlap 4 bitwise == 1 (one sync, "
            f"2 steps) at W=1 on {card}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 8c wall {out['wall_s']:.1f} s on {card}")
    record["resnet50_holds"] = out
    return out


# ---------------------------------------------------------------------------
# The LM slice: causal flash attention and llama3_8b-width training
# ---------------------------------------------------------------------------

FLASH_SHAPES = [("llama3_8b bf16", (1, 32, 8192, 128), "bfloat16"),
                ("llama3_8b f32", (1, 32, 8192, 128), "float32"),
                ("125M bf16", (8, 12, 1024, 64), "bfloat16")]
FLASH_ROUTES = ("flash_fwd", "flash_dq", "flash_dkv")


# Kernel vs plain, elementwise: |a - w| <= rel |w| + share * rms(w).  bf16
# outputs: both sides round float32 sums to bf16 at the same points, so an
# element may land one ulp (<= 2^-7 |w|) apart; the float32 sums before the
# rounding differ by summation order and, for o, by the running max that
# each block's p is rounded against (64-row tiles against the plain
# version's 256-row blocks), which a small share of the tensor's rms covers.
# float32: summation order only, 1e-4 absolute at inputs of scale 0.5; lse
# (float32 in both) to 1e-5.  The shares sit 2-4x above what the correct
# kernels read at these inputs on an H100: the CUDA-core kernels o 0.030,
# dq 0.0018, dk 0.0020, dv 4e-6 of the rms; the bf16 tensor-core kernels o
# 0.030, dq 0.0020 (0.0015 at the 125M shape), dk 0.0021, dv 6.0e-5 (mma's
# float32 sums of 512 products each lose more than an FMA chain's; the GQA
# call against the unfused chain, whose p stays float32, 0.034).  And far
# below a broken kernel: on the CUDA-core kernels, skipping the diagonal
# tile past row 1024 read o 0.95, the last q tile skipped for the late k
# tiles dk 0.20, dv 0.15; on the tensor-core kernels the same two mutants
# read o 0.947 (and lse 0.066 absolute) and dk 0.199, dv 0.150, and dropping
# the lo half of dv's p (one bf16 p, as a plain tensor-core port would take
# it) dv 0.120; the tensor-core dq skipping its diagonal tile's mask past row
# 1024 read 1.196, dropping the last k tile of the q tiles past row 1024
# 1.237, and without seq_dots 0.0215.  dq and dk hold 2^-7 on the tensor
# cores because large ds round as the plain version's (see seq_dots in
# csrc/flash_attention.cu): with s and dp summed by the tensor cores alone,
# dk read 0.0133 and dq 0.0215 at (1, 32, 8192, 128), and a plain version
# with exact score products read 0.0216 against the CUDA-core dq kernel:
# bf16(ds) flips with the order of the float32 sums.
BF16_REL = 2.0 ** -7
FLASH_BF16_RMS_SHARE = {"o": 2.0 ** -4, "dq": 2.0 ** -7, "dk": 2.0 ** -7, "dv": 2.0 ** -10}
GQA_RMS_SHARE = 2.0 ** -3


def hold_close(a, w, rel: float, atol: float) -> dict:
    """Elementwise ``|a - w| <= rel |w| + atol`` of float32 views: the
    largest error, the largest excess over ``rel |w|`` against ``atol``, and
    w's rms (the scale the bf16 shares are of)."""
    d = (a - w).abs()
    excess = (d - rel * w.abs()).max().item()
    return {"ok": excess <= atol, "max_abs_err": d.max().item(), "excess": excess,
            "atol": atol, "rms": w.square().mean().sqrt().item()}


def raw_flash(kernels, torch, q, k, v, do, lse, delta, scale: float):
    """The flash kernels' C entry points with outputs allocated once (timing
    only; these launches are not counted)."""
    lib = kernels._lib("flash_attention")
    stream = torch.cuda.current_stream().cuda_stream
    b, h, t, d = q.shape
    bf16 = int(q.dtype == torch.bfloat16)
    o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    lse_out = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    c_scale = ctypes.c_float(scale)

    def check(rc, name):
        if rc:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")

    return (lambda _: check(lib.tcdp_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                               o.data_ptr(), lse_out.data_ptr(), b * h, t, d,
                                               bf16, c_scale, stream), "flash_fwd"),
            lambda _: check(lib.tcdp_flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                              do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                              dq.data_ptr(), b * h, t, d, bf16, c_scale, stream),
                            "flash_dq"),
            lambda _: check(lib.tcdp_flash_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                               do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                               dk.data_ptr(), dv.data_ptr(), b * h, t, d, bf16,
                                               c_scale, stream), "flash_dkv"))


def phase_flash(kernels, torch, record):
    """The flash kernels vs their plain versions at the LM shapes, a GQA call
    through ring_attention, then timings."""
    from tpu_compressed_dp_torch.ops import flash_attention as fa
    from tpu_compressed_dp_torch.ops import ring_attention as ra

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    err = dict.fromkeys(FLASH_ROUTES, 0.0)
    rows, checks = {}, {}
    for label, shape, dtname in FLASH_SHAPES:
        dt = getattr(torch, dtname)
        b, h, t, d = shape
        q, k, v, do = ((0.5 * torch.randn(shape, generator=gen, device=dev)).to(dt)
                       for _ in range(4))
        s = 1.0 / math.sqrt(d)
        o, lse = fa.flash_fwd(q, k, v, s)
        delta = (do.float() * o.float()).sum(-1)
        got = {"o": o, "lse": lse, "dq": fa.flash_dq(q, k, v, do, lse, delta, s)}
        got["dk"], got["dv"] = fa.flash_dkv(q, k, v, do, lse, delta, s)
        o2, lse2 = fa.flash_fwd_plain(q, k, v, s)
        want = {"o": o2, "lse": lse2, "dq": fa.flash_dq_plain(q, k, v, do, lse, delta, s)}
        want["dk"], want["dv"] = fa.flash_dkv_plain(q, k, v, do, lse, delta, s)
        torch.cuda.synchronize()
        checks[label] = {}
        for name, route in (("o", "flash_fwd"), ("lse", "flash_fwd"), ("dq", "flash_dq"),
                            ("dk", "flash_dkv"), ("dv", "flash_dkv")):
            a, w = got[name].float(), want[name].float()
            if not torch.isfinite(a).all():
                raise AssertionError(f"flash {label}: {name} is not finite")
            rel, atol = 0.0, 1e-4
            if name == "lse":
                atol = 1e-5
            elif dt == torch.bfloat16:
                rel = BF16_REL
                atol = FLASH_BF16_RMS_SHARE[name] * w.square().mean().sqrt().item()
            c = hold_close(a, w, rel, atol)
            err[route] = max(err[route], c["max_abs_err"])
            checks[label][name] = c
            log(f"flash {label} {shape} {name}: max |kernel - plain| {c['max_abs_err']:.4g}, "
                f"excess over {rel:g} |plain| {c['excess']:.4g} = "
                f"{c['excess'] / c['rms']:.4g} rms (allowed {c['atol']:.4g}; rms {c['rms']:.4g})")
        bad = [n for n, c in checks[label].items() if not c["ok"]]
        if bad:
            raise AssertionError(f"flash {label}: {bad} differ from the plain versions beyond "
                                 "the elementwise tolerance")

        # timings: "ms" through the C entries with outputs allocated once
        # (CUDA events), "wrapper_ms" the Python wrappers, "plain_ms" the
        # block loops; the yardstick is scaled_dot_product_attention
        raw_fwd, raw_dq, raw_dkv = raw_flash(kernels, torch, q, k, v, do, lse, delta, s)
        causal = 2.0 * t * t * d * b * h          # causal half of QK^T and PV
        peak = BF16_OPS_PER_S if dt == torch.bfloat16 else FP32_OPS_PER_S
        nbytes = q.numel() * q.element_size()
        stat_bytes = 4 * b * h * t
        few = dict(reps=3, inner=2)
        lib_fwd = time_ms(lambda _: sdpa(q, k, v, is_causal=True), [None], **few)
        qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

        def sdpa_fwd_bwd(_):
            out = sdpa(qg, kg, vg, is_causal=True)
            return torch.autograd.grad(out, (qg, kg, vg), do)

        lib_fwd_bwd = time_ms(sdpa_fwd_bwd, [None], **few)
        plain = dict(reps=1, inner=1)
        rows[label] = {
            "flash_fwd": {
                "ms": time_ms(raw_fwd, [None], **few),
                "wrapper_ms": time_ms(lambda _: fa.flash_fwd(q, k, v, s), [None], **few),
                "plain_ms": time_ms(lambda _: fa.flash_fwd_plain(q, k, v, s), [None], **plain),
                "bound": bound_ms(4 * nbytes + stat_bytes, causal, peak),
                "library_ms": lib_fwd},
            "flash_dq": {
                "ms": time_ms(raw_dq, [None], **few),
                "wrapper_ms": time_ms(lambda _: fa.flash_dq(q, k, v, do, lse, delta, s),
                                      [None], **few),
                "plain_ms": time_ms(lambda _: fa.flash_dq_plain(q, k, v, do, lse, delta, s),
                                    [None], **plain),
                "bound": bound_ms(5 * nbytes + 2 * stat_bytes, 1.5 * causal, peak),
                "library_ms": None},
            "flash_dkv": {
                "ms": time_ms(raw_dkv, [None], **few),
                "wrapper_ms": time_ms(lambda _: fa.flash_dkv(q, k, v, do, lse, delta, s),
                                      [None], **few),
                "plain_ms": time_ms(lambda _: fa.flash_dkv_plain(q, k, v, do, lse, delta, s),
                                    [None], **plain),
                "bound": bound_ms(6 * nbytes + 2 * stat_bytes, 2.0 * causal, peak),
                "library_ms": None},
            # no one PyTorch call computes dq or dk/dv alone: the yardstick is
            # SDPA's backward (all three), timed as forward + backward less forward
            "sdpa_fwd_ms": lib_fwd, "sdpa_fwd_bwd_ms": lib_fwd_bwd,
        }
        r = rows[label]
        for name in FLASH_ROUTES:
            x = r[name]
            lib_txt = "none" if x["library_ms"] is None else f"{x['library_ms']:.4f} ms"
            log(f"time flash {label} {name}: {x['ms']:.4f} ms (wrapper {x['wrapper_ms']:.4f} ms, "
                f"plain {x['plain_ms']:.4f} ms, bound {x['bound'][0]:.4f} ms by "
                f"{x['bound'][1]}, library {lib_txt})")
        log(f"time flash {label} sdpa forward {lib_fwd:.4f} ms, forward + backward "
            f"{lib_fwd_bwd:.4f} ms (backward ~{lib_fwd_bwd - lib_fwd:.4f} ms) vs the kernels' "
            f"{r['flash_dq']['ms'] + r['flash_dkv']['ms']:.4f} ms backward")
        if dt == torch.bfloat16:
            # the backward on concentrated attention (q scaled 4x): more
            # entries take seq_dots, the kernels' one data-dependent cost
            q4 = 4 * q
            o4, lse4 = fa.flash_fwd(q4, k, v, s)
            delta4 = (do.float() * o4.float()).sum(-1)
            _, raw_dq4, raw_dkv4 = raw_flash(kernels, torch, q4, k, v, do, lse4, delta4, s)
            r["flash_dq"]["q4_ms"] = time_ms(raw_dq4, [None], **few)
            r["flash_dkv"]["q4_ms"] = time_ms(raw_dkv4, [None], **few)
            log(f"time flash {label} with q scaled 4x: flash_dq {r['flash_dq']['q4_ms']:.4f} ms, "
                f"flash_dkv {r['flash_dkv']['q4_ms']:.4f} ms")
        del q, k, v, do, o, lse, delta, got, want, qg, kg, vg
        if dt == torch.bfloat16:
            del q4, o4, lse4, delta4, raw_dq4, raw_dkv4

    # GQA through ring_attention: llama3_8b's 32 query and 8 KV heads
    t = 2048
    q = (0.5 * torch.randn((1, 32, t, 128), generator=gen, device=dev)).to(torch.bfloat16)
    k, v = ((0.5 * torch.randn((1, 8, t, 128), generator=gen, device=dev)).to(torch.bfloat16)
            for _ in range(2))
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    kernels.reset_launches()
    o = ra.ring_attention(qg, kg, vg)
    o.float().square().sum().backward()
    torch.cuda.synchronize()
    launched = {r_: kernels.LAUNCHES[r_] for r_ in FLASH_ROUTES}
    w = ra.dense_causal_attention(q, k, v).float()
    # the unfused chain keeps p in float32 where the kernel rounds it to bf16
    # before P.V (the Pallas rounding point): a larger share of the rms
    c = hold_close(o.float(), w, BF16_REL, GQA_RMS_SHARE * w.square().mean().sqrt().item())
    if (launched != dict.fromkeys(FLASH_ROUTES, 1) or not c["ok"]
            or kg.grad.shape != k.shape
            or not all(torch.isfinite(x.grad.float()).all() for x in (qg, kg, vg))):
        raise AssertionError(f"GQA ring_attention: launches {launched}, |o - unfused| {c}, "
                             f"dk shape {tuple(kg.grad.shape)}")
    checks["gqa"] = {**c, "launches": launched}
    log(f"flash GQA ring_attention (1, 32/8, {t}, 128) bf16: max |o - unfused| "
        f"{c['max_abs_err']:.4g}, excess over {BF16_REL:g} |unfused| {c['excess']:.4g} = "
        f"{c['excess'] / c['rms']:.4g} rms (allowed {c['atol']:.4g}), one launch of each "
        "kernel, finite grads on the 8 KV heads")
    record["flash_checks"] = checks
    record["flash_times"] = rows
    return err, rows


LM_ARGV = ["--preset", "llama3_8b", "--layers", "2", "--seq_len", "8192", "--global_batch",
           "1", "--warmup_steps", "1", "--steps", "4", "--log_every", "4", "--device", "cuda",
           "--seed", "0"]
LM_TOPK = ["--method", "topk", "--ratio", str(RATIO), "--error_feedback"]
ALEXNET_TOPK = ("count_ge", "search_init", "fused_sparsify")
LM_RUNS = {"dense": [],
           "topk entiremodel": ["--compress", "entiremodel", *LM_TOPK],
           "topk layerwise": ["--compress", "layerwise", *LM_TOPK],
           "wire topk entiremodel": ["--compress", "entiremodel", "--mode", "wire", *LM_TOPK]}
LM_PARAMS = 1_486_901_248   # llama3_8b widths at 2 layers


def lm_leaf_shapes(layers: int = 2) -> dict:
    """The shape of every llama3_8b leaf at ``layers`` layers, keyed and
    ordered as the port's ``param_leaves``, from the config alone."""
    from tpu_compressed_dp_torch.models import transformer as tf

    cfg = dataclasses.replace(tf.llama3_8b(), n_layers=layers)
    d, hd, f, v = cfg.dim, cfg.head_dim, cfg.ffn, cfg.vocab_size
    per_layer = {"attn_norm": (d,), "mlp_norm": (d,), "w_down": (f, d), "w_gate": (d, f),
                 "w_up": (d, f), "wk": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
                 "wq": (d, cfg.n_heads * hd), "wv": (d, cfg.n_kv_heads * hd)}
    return {"embed": (v, d), "final_norm": (d,),
            **{f"layers.{i}.{k}": sh for i in range(cfg.n_layers) for k, sh in per_layer.items()},
            "lm_head": (d, v)}


def lm_leaf_sizes(layers: int = 2):
    """(element count, tensor-sharded?) of every llama3_8b leaf at ``layers``
    layers, in the port's leaf order."""
    from tpu_compressed_dp_torch.models import transformer as tf

    cfg = dataclasses.replace(tf.llama3_8b(), n_layers=layers)
    return list(zip([math.prod(sh) for sh in lm_leaf_shapes(layers).values()],
                    tf.is_sharded(cfg)))


def phase_lm(kernels, compressors, torch, record):
    """The LM slice's main path: harness.lm at llama3_8b widths, 2 layers."""
    from tpu_compressed_dp_torch.harness import lm
    from tpu_compressed_dp_torch.models import transformer as tf
    from tpu_compressed_dp_torch.train import lm_step

    leaves = lm_leaf_sizes()
    n = sum(s for s, _ in leaves)
    groups = [sum(s for s, sh in leaves if not sh), sum(s for s, sh in leaves if sh)]
    if n != LM_PARAMS or groups != list(LM_GROUPS):
        raise AssertionError(f"llama3_8b at 2 layers: {n} parameters, groups {groups}")
    keep_em = sum(compressors.topk_keep_count(g, RATIO) for g in groups)
    keep_lw = sum(compressors.topk_keep_count(s, RATIO) for s, _ in leaves)
    keep_sharded = {"entiremodel": compressors.topk_keep_count(groups[1], RATIO),
                    "layerwise": sum(compressors.topk_keep_count(s, RATIO)
                                     for s, sh in leaves if sh)}
    if not tf.use_fused_head_xent(8192, 128256, 2):
        raise AssertionError("the fused head + cross-entropy gate is off at 8192 x 128256 bf16")
    calls = [0]
    fused = lm_step.fused_head_xent

    def counted(*a, **kw):
        calls[0] += 1
        return fused(*a, **kw)

    card = record["card"]
    runs = {}
    lm_step.fused_head_xent = counted
    try:
        for label, flags in LM_RUNS.items():
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            calls[0] = 0
            t0 = time.perf_counter()
            summary = lm.main(LM_ARGV + flags)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            steps, loss = summary["step"], summary["loss"]
            if steps != 4 or not math.isfinite(loss):
                raise AssertionError(f"lm {label}: {steps} steps, loss {loss}")
            bad = {r: launches[r] for r in FLASH_ROUTES if launches[r] != 2 * steps}
            if bad:
                raise AssertionError(f"lm {label}: flash launches {bad}, want 2 a step")
            if calls[0] != steps:
                raise AssertionError(f"lm {label}: the fused head + xent ran {calls[0]} times")
            sent = summary["sent frac"]
            if label == "dense":
                if sent != 1.0:
                    raise AssertionError(f"lm dense: sent frac {sent}")
                want = "1.0"
            elif label.startswith("wire"):
                # the wire payload carries exactly each group's keep count
                if sent != keep_em / n or launches["select_pack"] < 1:
                    raise AssertionError(f"lm {label}: sent frac {sent} is not the keep "
                                         f"counts' {keep_em / n}, launches {launches}")
                want = f"{keep_em / n:.9f} (exact)"
            else:
                # simulate bills the kept nonzeros: every sharded-group
                # coordinate is nonzero, but the embedding gradient is zero
                # outside the batch's tokens' rows, so its group keeps fewer
                gran = label.split()[1]
                keep = keep_em if gran == "entiremodel" else keep_lw
                lo = keep_sharded[gran] / n
                if not (lo <= sent <= 1.001 * keep / n):
                    raise AssertionError(f"lm {label}: sent frac {sent} outside "
                                         f"[{lo}, {1.001 * keep / n}]")
                must = ("count_ge", "search_init", "fused_sparsify") + (
                    ("count_edges",) if gran == "entiremodel" else ())
                if min(launches[k] for k in must) <= 0:
                    raise AssertionError(f"lm {label}: a Top-K kernel never launched: "
                                         f"{launches}")
                want = f"[{lo:.6f}, {keep / n:.6f}]"
            tok_s = summary["tok/s"]
            step_ms = 8192.0 / tok_s * 1e3
            log(f"lm {label}: loss {loss:.4f}, sent frac {sent:.9f} (want {want}), "
                f"{step_ms:.1f} ms/step, {tok_s:.0f} tok/s, MFU {summary.get('mfu')}, peak "
                f"{peak_gb:.2f} GB, wall {wall:.1f} s on {card}; launches {launches}")
            runs[label] = {"summary": summary, "launches": launches, "step_ms": step_ms,
                           "peak_gb": peak_gb, "wall_s": wall, "fused_xent_calls": calls[0]}
    finally:
        lm_step.fused_head_xent = fused
    record["lm"] = runs
    return runs


# phase 7's profiles: label -> (sync mode, segmented pack dispatched?)
LM_PROFILES = {"topk entiremodel": ("simulate", False),
               "wire topk entiremodel": ("wire", False),
               "wire topk entiremodel, segmented": ("wire", True)}


def lm_group_launches(launches, n_steps: int) -> dict:
    """Per-launch device ms of the threshold search's passes and of
    ``fused_sparsify`` at each of the LM's sync group sizes, from an
    entire-model Top-K profile's ``port_launches_us``: the groups sync one
    after the other, and each group's launches end with its
    ``fused_sparsify``.  ``count_ge_edges_kernel<true>`` is the sampled round
    (the whole tensor, candidates kept), ``<false>`` a refinement round (the
    candidates, or the whole tensor where they may not serve); bounds as
    phase 2 counts them, the whole tensor's bytes for the full pass (its
    candidate writes left out)."""
    keys = ("count_ge_edges_kernel<true>", "count_ge_edges_kernel<false>", "fused_sparsify")
    groups, cur = [], {k: [] for k in keys}
    for name, us in launches:
        key = next((k for k in keys if k in name), None)
        if key:
            cur[key].append(us / 1e3)
        if key == "fused_sparsify":
            groups.append(cur)
            cur = {k: [] for k in keys}
    out = {}
    for gi, n in enumerate(LM_GROUPS):
        mine = groups[gi::len(LM_GROUPS)]
        for key, label, bound in (
                (keys[0], "count_ge_edges full pass", bound_ms(4 * n, 0)),
                (keys[1], "count_ge_edges refinement", (None, None)),
                (keys[2], "fused_sparsify", bound_ms(12 * n + 8, 4 * n))):
            ms = [x for g in mine for x in g[key]]
            out[f"{label} n={n}"] = {"launches": len(ms), "ms_min": min(ms), "ms_max": max(ms),
                                     "bound_ms": bound[0], "bound_by": bound[1]}
    count_ms = sum(us for name, us in launches if "count_ge_edges" in name) / 1e3
    out["count_ge_edges ms per step"] = count_ms / n_steps
    return out


def phase_lm_profile(kernels, torch, record):
    """torch.profiler over two steady entire-model Top-K 1 % + EF steps at
    the LM slice's shape, in simulate mode, on the default wire path and on
    the gated segmented wire path: device busy and idle share, time by
    kernel category and the top kernels."""
    import numpy as np

    from tpu_compressed_dp_torch.data import lm as lm_data
    from tpu_compressed_dp_torch.models import transformer as tf
    from tpu_compressed_dp_torch.parallel.dp import CompressionConfig
    from tpu_compressed_dp_torch.train.lm_step import init_lm_ef_state, make_lm_train_step
    from tpu_compressed_dp_torch.train.optim import SGD
    from tpu_compressed_dp_torch.train.state import TrainState

    dev = torch.device("cuda")
    cfg = dataclasses.replace(tf.llama3_8b(), n_layers=2)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in
             lm_data.SyntheticTokens(cfg.vocab_size, 8192, 1, seed=0).batch(0).items()}
    profs = {}
    for label, (mode, seg) in LM_PROFILES.items():
        gc.collect()
        torch.cuda.empty_cache()
        model = tf.Llama(cfg, seed=0, device=dev)
        params = tf.param_leaves(model)
        comp = CompressionConfig(method="topk", ratio=RATIO, granularity="entiremodel",
                                 error_feedback=True, mode=mode)
        opt = SGD(lr=1e-4, momentum=0.9)
        state = TrainState.create(model, opt.init(params), init_lm_ef_state(cfg, params, comp))
        step = make_lm_train_step(cfg, opt, comp)
        holder = {"state": state}

        def run(k):
            for _ in range(k):
                holder["state"], _ = step(holder["state"], batch)

        kernels._SEG_PACK_DISPATCH = seg
        try:
            run(2)
            prof = device_profile(run, torch, n_steps=2, port_launches=True)
        finally:
            kernels._SEG_PACK_DISPATCH = False
        launches = prof.pop("port_launches_us", [])
        prof["select_pack_ms_per_step"] = sum(
            us for name, us in launches if "select_pack_kernel" in name) / 1e3 / 2
        log(f"profile lm {label} (llama3_8b widths, 2 layers, seq 8192): {json.dumps(prof)}")
        if mode == "simulate":
            prof["group_launches"] = lm_group_launches(launches, 2)
            for key, r in prof["group_launches"].items():
                if not isinstance(r, dict):
                    log(f"profile lm {label} {key}: {r:.4f}")
                    continue
                bound = ("" if r["bound_ms"] is None else
                         f", bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
                log(f"profile lm {label} {key}: {r['launches']} launches, {r['ms_min']:.4f}-"
                    f"{r['ms_max']:.4f} ms each{bound}")
        profs[label] = prof
        del holder, state, model, params, step
    gc.collect()
    torch.cuda.empty_cache()
    record["lm_profile"] = profs
    return profs


# ---------------------------------------------------------------------------
# Phase 7c: the LM's sequence and tensor axes, PowerSGD and --overlap
# ---------------------------------------------------------------------------

LM_AXES_STEPS = 3
# label -> (dp, sp, tp), layers, seq, extra flags: ranks are worker processes
# on the one card, joined by gloo.  sp2: every rank holds the whole model; two
# ranks at 2 layers ran out of the H100's 80 GB (one asked 3.58 GiB with 78.2
# GiB of the card in use), at 1 layer and seq 8192 each peaks at ~32 GiB
# (PERF.md section 5)
LM_SP_LAYERS, LM_SP_SEQ = 1, 8192
# pp2: two GPipe stages of one layer each (llama3_8b widths, 2 layers), 2
# microbatches of one sequence, ~1.27 G parameters a rank; "pp" is the pipe
# axis, "batch" the global batch
LM_PP_SEQ = 8192
LM_AXES_RUNS = {"tp2": {"mesh": (1, 1, 2), "layers": 2, "seq": 8192, "flags": []},
                "sp2": {"mesh": (1, 2, 1), "layers": LM_SP_LAYERS, "seq": LM_SP_SEQ,
                        "flags": ["--remat"]},
                "pp2": {"mesh": (1, 1, 1), "pp": 2, "batch": 2, "layers": 2, "seq": LM_PP_SEQ,
                        "flags": ["--microbatches", "2"]}}
LM_AXES_TOPK = ("count_ge", "search_init", "fused_sparsify")
RING_REL = 1e-4   # ring vs float64 whole-sequence attention: max |diff| over the rms


def lm_axes_argv(run: dict, layers: int, seq: int) -> list:
    dpn, spn, tpn = run["mesh"]
    return ["--preset", "llama3_8b", "--layers", str(layers), "--seq_len", str(seq),
            "--global_batch", str(run.get("batch", 1)), "--warmup_steps", "1", "--steps",
            str(LM_AXES_STEPS), "--log_every", str(LM_AXES_STEPS), "--device", "cuda", "--seed",
            "0", "--dp", str(dpn), "--sp", str(spn), "--tp", str(tpn), "--pp",
            str(run.get("pp", 1)), "--compress", "entiremodel", *LM_TOPK, *run["flags"]]


def lm_axes_world(run: dict) -> int:
    return math.prod(run["mesh"]) * run.get("pp", 1)


def _causal64(torch, q, k, v, scale: float):
    """Causal softmax attention in float64 (full scores), the reference of
    the ring hold."""
    t = q.shape[2]
    s = (q @ k.transpose(-1, -2)) * scale
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return torch.softmax(s.masked_fill(~keep, float("-inf")), -1) @ v


def ring_hold(torch, group, seq: int, heads: int = 32, kv_heads: int = 8, d: int = 128) -> dict:
    """One layer's attention at llama3_8b's heads through the sp ring (this
    rank's query block), forward and q/k/v gradients, float32, against the
    whole sequence's attention on this card: the unfused float32 chain and,
    as the exact reference, float64, one KV head's group of query heads at a
    time.  The ring passes where its largest error from float64 is at most
    RING_REL of the output's rms, or at most twice the whole-sequence
    float32 chain's own (both sum the same terms in float32, in another
    order: dk and dv add the two halves' partial sums)."""
    from tpu_compressed_dp_torch.ops import ring_attention as ra
    from tpu_compressed_dp_torch.parallel import mesh

    dev = torch.device("cuda", 0)
    ring, my = mesh.size(group), mesh.group_rank(group)
    tl = seq // ring
    sl = slice(my * tl, (my + 1) * tl)
    scale = 1.0 / math.sqrt(d)
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(1, heads, seq, d, generator=gen, device=dev)
    k = torch.randn(1, kv_heads, seq, d, generator=gen, device=dev)
    v = torch.randn(1, kv_heads, seq, d, generator=gen, device=dev)
    do = torch.randn(1, heads, seq, d, generator=gen, device=dev)
    ql, kl, vl = (a[:, :, sl].contiguous().requires_grad_(True) for a in (q, k, v))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = ra.ring_attention(ql, kl, vl, group=group)
    got = [o, *torch.autograd.grad((o * do[:, :, sl]).sum(), (ql, kl, vl))]
    torch.cuda.synchronize()
    ring_ms = (time.perf_counter() - t0) * 1e3
    rep = heads // kv_heads
    err, err32, sq, cnt = [0.0] * 4, [0.0] * 4, [0.0] * 4, [0] * 4
    for g in range(kv_heads):
        hs = slice(g * rep, (g + 1) * rep)
        outs = []
        for dt in (torch.float32, torch.float64):
            qh = q[:, hs].to(dt).requires_grad_(True)
            kh, vh = (a[:, g:g + 1].to(dt).requires_grad_(True) for a in (k, v))
            oh = (ra.dense_causal_attention(qh, kh, vh) if dt == torch.float32 else
                  _causal64(torch, qh, kh.expand_as(qh), vh.expand_as(qh), scale))
            outs.append([oh, *torch.autograd.grad((oh * do[:, hs].to(dt)).sum(), (qh, kh, vh))])
            del qh, kh, vh, oh
        for i, (a, w32, w) in enumerate(zip(got, *outs)):
            a = a[:, hs] if i < 2 else a[:, g:g + 1]
            w, w32 = w[:, :, sl], w32[:, :, sl]
            err[i] = max(err[i], (a.double() - w).abs().max().item())
            err32[i] = max(err32[i], (w32.double() - w).abs().max().item())
            sq[i] += (w ** 2).sum().item()
            cnt[i] += w.numel()
        del outs
    out = {"ring_ms": ring_ms, "seq": seq, "ring": ring}
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        rms = math.sqrt(sq[i] / cnt[i])
        out[name] = {"max_abs": err[i], "whole_fp32_max_abs": err32[i], "rms": rms,
                     "rel": err[i] / rms}
        if not err[i] <= max(RING_REL * rms, 2.0 * err32[i]):
            raise AssertionError(f"ring attention {name}: max |diff| from float64 {err[i]} > "
                                 f"{RING_REL} x rms {rms} and > 2 x the whole-sequence float32 "
                                 f"chain's {err32[i]}")
    return out


def lm_axes_worker(label: str, rank: int, port: int, out_path: str, layers: int,
                   seq: int) -> int:
    """One rank of phase 7c (``--lm_axes_worker``): LM_AXES_RUNS[label]
    through ``harness.lm.main`` at llama3_8b widths, ``layers`` deep."""
    import hashlib

    import torch

    from tpu_compressed_dp_torch.harness import lm
    from tpu_compressed_dp_torch.models import transformer as tf
    from tpu_compressed_dp_torch.ops import kernels
    from tpu_compressed_dp_torch.parallel import mesh
    from tpu_compressed_dp_torch.train import pp_step

    run = LM_AXES_RUNS[label]
    dpn, spn, tpn = run["mesh"]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh.init_process_group(dev, backend="gloo", init_method=f"tcp://localhost:{port}",
                            world_size=lm_axes_world(run), rank=rank)
    try:
        kernels.build()      # the parent built them: this loads the libraries
        result = {"label": label, "layers": layers, "seq": seq}
        if spn > 1:
            groups = mesh.lm_groups(dpn, spn, tpn)
            result["ring_hold"] = ring_hold(torch, groups.seq, seq)
            gc.collect()
            torch.cuda.empty_cache()
        holder, heads = {}, set()
        make_step, attend = lm.make_lm_train_step, tf.ring_attention
        make_pp = pp_step.make_pp_train_step

        def capture(*a, make=make_step, **kw):
            step = make(*a, **kw)

            def wrapped(state, batch):
                holder["state"], m = step(state, batch)
                return holder["state"], m

            return wrapped

        def seen(q, k, v, **kw):
            heads.add((q.shape[1], k.shape[1]))
            return attend(q, k, v, **kw)

        lm.make_lm_train_step, tf.ring_attention = capture, seen
        pp_step.make_pp_train_step = lambda *a, **kw: capture(*a, make=make_pp, **kw)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            summary = lm.main(lm_axes_argv(run, layers, seq))
        finally:
            lm.make_lm_train_step, tf.ring_attention = make_step, attend
            pp_step.make_pp_train_step = make_pp
        torch.cuda.synchronize()
        result.update(summary=summary, launches=dict(kernels.LAUNCHES),
                      wall_s=time.perf_counter() - t0, heads=sorted(heads),
                      peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        model = holder["state"].model
        cfg = model.cfg
        if run.get("pp", 1) > 1:
            # the two signature groups: the pipe-replicated leaves, then the
            # stage's layer stacks
            leaves = pp_step.stage_leaves(model)
            sharded = [bool(ax) for ax in pp_step.stage_leaf_axes(cfg, tpn)]
        else:
            leaves, sharded = tf.param_leaves(model), tf.is_sharded(cfg)
        digest = hashlib.sha256()
        groups = [0, 0]
        for (name, p), sh in zip(leaves.items(), sharded):
            groups[sh] += p.numel()
            if not sh:
                digest.update(name.encode())
                digest.update(p.detach().cpu().numpy().tobytes())
        result["replicated_sha256"] = digest.hexdigest()
        result["groups"] = groups
        with open(out_path, "w") as f:
            json.dump(result, f, default=str)
    finally:
        mesh.destroy()
    return 0


def lm_axes_groups(label: str) -> list:
    """The element counts of a rank's two entire-model sync groups in the
    run ``label`` of LM_AXES_RUNS (replicated leaves, then this tensor
    rank's shards; with pipe stages the pipe-replicated embedding, final
    norm and head, then this stage's layers), from the config alone."""
    run = LM_AXES_RUNS[label]
    tpn, ppn = run["mesh"][2], run.get("pp", 1)
    if ppn > 1:
        shapes = lm_leaf_shapes(run["layers"])
        whole = sum(math.prod(shapes[k]) for k in ("embed", "final_norm", "lm_head"))
        return [whole, (sum(math.prod(sh) for sh in shapes.values()) - whole) // ppn]
    leaves = lm_leaf_sizes(run["layers"])
    return [sum(n for n, sh in leaves if not sh), sum(n for n, sh in leaves if sh) // tpn]


def hold_lm_axes_groups(kernels, compressors, torch, sizes, label: str = "7c group") -> dict:
    """At each of the sync group sizes ``sizes`` (7c's ranks', 7d's layer-wise
    leaves), Top-K 1 % of seeded N(0, 1) x 1e-2 data: the threshold search
    bitwise against the unfused glue on the plain counts and the CPU search
    (``check_search``), and ``fused_sparsify`` (compressed, EF, count)
    bitwise against its plain version."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for n in sizes:
        gc.collect()
        torch.cuda.empty_cache()
        x = torch.randn(n, generator=gen, device=dev) * 1e-2
        mag = x.abs()
        keep = compressors.topk_keep_count(n, RATIO)
        r = {"search": check_search(kernels, torch, mag, keep, f"{label} n={n}")}
        t = kernels.topk_threshold(mag, keep)
        del mag
        for got, want in zip(kernels.fused_sparsify(x, t), kernels.fused_sparsify_plain(x, t)):
            if not _bits_equal(torch, got, want):
                raise AssertionError(f"fused_sparsify differs from its plain version at "
                                     f"{label} n={n}")
        log(f"{label} n={n}: search, fused_sparsify bitwise == plain")
        out[str(n)] = r
        del x, t
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_lm_axes_world(label: str, layers: int, seq: int) -> list:
    """Phase 7c's ranks of ``label`` as worker processes on the card."""
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    world = lm_axes_world(LM_AXES_RUNS[label])
    out_dir = os.path.join(HERE, "build", "chip_smoke_ranks")
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    paths = [os.path.join(out_dir, f"lm_{label}_rank{r}.json") for r in range(world)]
    for path in paths:
        if os.path.exists(path):
            os.remove(path)
    # two ranks share the card: growable segments keep each rank's cache
    # from holding freed blocks the other rank needs
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--lm_axes_worker",
                               label, str(r), str(port), paths[r], str(layers), str(seq)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, text in enumerate(logs):
        for line in text.strip().splitlines()[-30:]:
            log(f"[7c {label} rank {r}] {line}")
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"7c {label}: the ranks exited {codes}")
    results = []
    for path in paths:
        with open(path) as f:
            results.append(json.load(f))
    return results


def _lm_row(label: str, summary: dict, peak, card: str, tokens: int) -> dict:
    tok_s = summary["tok/s"]
    step_ms = tokens / tok_s * 1e3
    log(f"lm {label}: loss {summary['loss']:.4f}, sent frac {summary.get('sent frac')}, "
        f"{step_ms:.1f} ms/step, {tok_s:.0f} tok/s, MFU {summary.get('mfu')}, peak {peak} GiB "
        f"on {card}")
    return {"summary": summary, "step_ms": step_ms, "peak_gib": peak}


def powersgd_sent(dp, lowrank, leaves, gran: str, rank: int) -> float:
    """PowerSGD's analytic sent fraction of the LM's grouped sync: per
    signature group and reduction group, ``r (m + n2)`` factor elements, or
    the whole group where the factors would cost as much."""
    sent = total = 0
    for sig in (False, True):
        sizes = [n for n, sh in leaves if sh == sig]
        groups = dp.make_leaf_groups([4 * n for n in sizes], gran, 25.0 * dp.BUCKET_MB)
        for idxs in groups:
            n = sum(sizes[i] for i in idxs)
            dims = lowrank.powersgd_dims(n, rank)
            sent += n if dims is None else dims[2] * (dims[0] + dims[1])
            total += n
    return sent / total


def overlap_sync_hold(torch, gran: str) -> bool:
    """One LM sync (Top-K 1 % + EF) at llama3_8b widths, 2 layers, of seeded
    gradients and EF at ``sync_overlap`` 4 and 1: True where every synced
    entry, EF entry and stat agree bitwise."""
    from tpu_compressed_dp_torch.parallel import dp

    dev = torch.device("cuda", 0)
    leaf_axes = [("tensor",) if sh else () for _, sh in lm_leaf_sizes()]
    shapes = lm_leaf_shapes()
    gen = torch.Generator(device=dev).manual_seed(21)
    grads = {k: torch.randn(sh, generator=gen, device=dev) * 1e-2 for k, sh in shapes.items()}
    ef = {k: torch.randn(sh, generator=gen, device=dev) * 1e-3 for k, sh in shapes.items()}
    outs = []
    for k in (1, 4):
        c = dp.CompressionConfig(method="topk", ratio=RATIO, granularity=gran,
                                 error_feedback=True, sync_overlap=k)
        synced, new_ef, _, stats = dp.PartitionedSync(c, leaf_axes)(grads, ef, (), 77)
        outs.append((synced, new_ef, stats))
    same = all(all(_bits_equal(torch, a[key], b[key]) for key in a)
               for a, b in zip(outs[0], outs[1]))
    del grads, ef, outs
    gc.collect()
    torch.cuda.empty_cache()
    return same


LM_ONE_RUNS = {"powersgd r4 entiremodel": ["--compress", "entiremodel", "--method", "powersgd",
                                           "--rank", "4", "--error_feedback"],
               "powersgd r4 layerwise": ["--compress", "layerwise", "--method", "powersgd",
                                         "--rank", "4", "--error_feedback"],
               "topk entiremodel --overlap 4": ["--compress", "entiremodel", *LM_TOPK,
                                                "--overlap", "4"],
               # several chunks a signature group: the hooks pipeline them
               "topk layerwise --overlap 4": ["--compress", "layerwise", *LM_TOPK,
                                              "--overlap", "4"]}


def phase_lm_axes_ranks(kernels, compressors, torch, record):
    """7c (a) tp = 2, (b) sp = 2 + remat and (d) pp = 2 (GPipe, 2
    microbatches) as gloo ranks on the card, then the Top-K kernels held
    against their plain versions at the ranks' sync group sizes.  It runs
    before the phases that train in this process: the ranks need the card's
    memory to themselves (two whole models at sp = 2)."""
    card = record["card"]
    t_phase = time.perf_counter()
    free, total = torch.cuda.mem_get_info()
    log(f"7c: {free / 2 ** 30:.1f} of {total / 2 ** 30:.1f} GiB free on the card before the "
        "ranks start")
    runs = {}
    for label, run in LM_AXES_RUNS.items():
        layers, seq = run["layers"], run["seq"]
        t0 = time.perf_counter()
        results = run_lm_axes_world(label, layers, seq)
        wall = time.perf_counter() - t0
        losses = [r["summary"]["loss"] for r in results]
        if not all(math.isfinite(x) for x in losses) or len(set(losses)) != 1:
            raise AssertionError(f"7c {label}: losses {losses} (finite and equal wanted)")
        for r, res in enumerate(results):
            la = res["launches"]
            if res["summary"]["step"] != LM_AXES_STEPS:
                raise AssertionError(f"7c {label} rank {r}: {res['summary']['step']} steps")
            if res["groups"] != lm_axes_groups(label):
                raise AssertionError(f"7c {label} rank {r}: sync groups {res['groups']}, want "
                                     f"{lm_axes_groups(label)}")
            # two signature groups a step, each one entire-model Top-K group
            if la["fused_sparsify"] != 2 * LM_AXES_STEPS or min(la[k] for k in LM_AXES_TOPK) < 1:
                raise AssertionError(f"7c {label} rank {r}: Top-K launches {la}")
            if label == "tp2":
                bad = {k: la[k] for k in FLASH_ROUTES if la[k] != layers * LM_AXES_STEPS}
                if bad or res["heads"] != [[16, 4]]:
                    raise AssertionError(f"7c tp2 rank {r}: flash launches {bad}, local heads "
                                         f"{res['heads']} (16/4 wanted)")
            elif "pp" in run:
                # M + S - 1 ticks a step, each through the stage's layers
                ticks = int(run["flags"][1]) + run["pp"] - 1
                want = ticks * layers // run["pp"] * LM_AXES_STEPS
                bad = {k: la[k] for k in FLASH_ROUTES if la[k] != want}
                if bad or res["heads"] != [[32, 8]]:
                    raise AssertionError(f"7c {label} rank {r}: flash launches {bad} ({want} "
                                         f"wanted), heads {res['heads']}")
            elif any(la[k] for k in FLASH_ROUTES):
                raise AssertionError(f"7c {label} rank {r}: a flash kernel ran on the ring: {la}")
            if "ring_hold" in res:
                h = res["ring_hold"]
                log(f"7c {label} rank {r}: ring attention (1, 32/8 heads, {h['seq']}, 128) "
                    f"fp32, sp={h['ring']}, max |diff| from the whole sequence in float64 "
                    "(the whole sequence's float32 chain's; the rms): "
                    + ", ".join(f"{n} {h[n]['max_abs']:.3e} ({h[n]['whole_fp32_max_abs']:.3e}; "
                                f"{h[n]['rms']:.4f})" for n in ("o", "dq", "dk", "dv"))
                    + f"; ring fwd + bwd {h['ring_ms']:.1f} ms")
        axis = {"tp2": "tensor", "pp2": "pipe"}.get(label)
        if axis and len({r["replicated_sha256"] for r in results}) != 1:
            raise AssertionError(f"7c {label}: the replicated parameters differ across {axis} "
                                 "ranks")
        tokens = seq * run.get("batch", 1)
        rows = [_lm_row(f"7c {label} rank {r} ({layers} layers, seq {seq})", res["summary"],
                        round(res["peak_gib"], 2), card, tokens)
                for r, res in enumerate(results)]
        launches = {k: sum(res["launches"][k] for res in results)
                    for k in results[0]["launches"]}
        log(f"7c {label}: world wall {wall:.1f} s, launches summed over ranks {launches}"
            + (f"; replicated parameters bitwise equal across the {axis} ranks" if axis else "")
            + ("; host-bound: every pipe sum and hand-off goes through host memory over gloo"
               if "pp" in run else ""))
        runs[label] = {"ranks": results, "rows": rows, "launches": launches, "wall_s": wall}
    t0 = time.perf_counter()
    sizes = sorted({n for label in LM_AXES_RUNS for n in lm_axes_groups(label)})
    holds = hold_lm_axes_groups(kernels, compressors, torch, sizes)
    log(f"7c Top-K holds at the ranks' group sizes {sizes}: {time.perf_counter() - t0:.1f} s")
    wall = time.perf_counter() - t_phase
    log(f"7c (a)-(b) wall {wall:.1f} s")
    record["lm_axes_ranks"] = {"runs": runs, "holds": holds, "wall_s": wall}
    return runs


def phase_lm_axes_one(kernels, torch, record, lm_runs):
    """7c (c): PowerSGD and --overlap 4 at phase 7's one-rank config; each
    --overlap run launches ``fused_sparsify`` as often as phase 7's run at
    its granularity (``lm_runs``) does, whose step time it prints beside its
    own."""
    from tpu_compressed_dp_torch.harness import lm
    from tpu_compressed_dp_torch.ops import lowrank
    from tpu_compressed_dp_torch.parallel import dp

    card = record["card"]
    t_phase = time.perf_counter()
    runs = {}
    leaves = lm_leaf_sizes()
    holds = {gran: overlap_sync_hold(torch, gran) for gran in ("entiremodel", "layerwise")}
    if not all(holds.values()):
        raise AssertionError(f"7c: sync_overlap 4 differs from 1: {holds}")
    log(f"7c one LM sync (Top-K 1 % + EF, llama3_8b widths, 2 layers) at sync_overlap 4 bitwise "
        f"== 1: {holds}")
    for label, flags in LM_ONE_RUNS.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        summary = lm.main(LM_ARGV + flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if summary["step"] != 4 or not math.isfinite(summary["loss"]):
            raise AssertionError(f"7c {label}: {summary}")
        if any(launches[k] != 2 * summary["step"] for k in FLASH_ROUTES):
            raise AssertionError(f"7c {label}: flash launches {launches}")
        if label.startswith("powersgd"):
            want = powersgd_sent(dp, lowrank, leaves, label.split()[2], 4)
            if abs(summary["sent frac"] - want) > 1e-6 * want:
                raise AssertionError(f"7c {label}: sent frac {summary['sent frac']}, analytic "
                                     f"{want}")
        else:
            base = lm_runs[label.split(" --")[0]]
            # one fused_sparsify a sync group a step; the search's rounds
            # depend on the data
            if (launches["fused_sparsify"] != base["launches"]["fused_sparsify"]
                    or min(launches[k] for k in LM_AXES_TOPK) < 1):
                raise AssertionError(f"7c {label}: Top-K launches {launches}, phase 7's "
                                     f"{base['launches']}")
            log(f"7c {label}: phase 7's {label.split(' --')[0]} run {base['step_ms']:.1f} "
                f"ms/step on {card}")
        row = _lm_row(f"7c {label} (phase 7's config)", summary,
                      round(torch.cuda.max_memory_allocated() / 2 ** 30, 2), card, 8192)
        runs[label] = {**row, "launches": launches, "wall_s": wall}
    wall = time.perf_counter() - t_phase
    log(f"7c (c) wall {wall:.1f} s")
    record["lm_axes_one"] = {"runs": runs, "overlap_holds": holds, "wall_s": wall}
    return runs


# phase 7d: phase 7's config with Mixtral 8x7B's expert count and FFN width
# (8 experts of llama3_8b's ffn 14336) on every second layer, top-1 routing
# at capacity factor 1.25 as in the JAX package (cap 1,280 of 8,192 tokens)
LM_MOE = ["--experts", "8", "--moe_every", "2", "--capacity_factor", "1.25"]
LM_MOE_PARAMS = 2_720_059_392
LM_MOE_RUNS = {"moe dense": [],
               "moe topk layerwise": ["--compress", "layerwise", *LM_TOPK]}


def moe_ffn_times(torch, cfg) -> dict:
    """One MoE FFN at 7d's shapes (8,192 tokens, 8 experts of llama3_8b's
    widths, cap 1,280, bf16) on random inputs, CUDA events: the whole
    ``_moe_ffn`` forward and forward + backward, and alone the one-hot
    dispatch and combine products and the three expert products (forward),
    against their bf16 tensor-core bound."""
    from tpu_compressed_dp_torch.models import transformer as tf

    dev, dt = torch.device("cuda", 0), cfg.dtype
    n, d, f, e = 8192, cfg.dim, cfg.ffn, cfg.n_experts
    cap = max(int(math.ceil(n / e * cfg.capacity_factor)), 1)
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(1, n, d, generator=gen, device=dev).to(dt).requires_grad_(True)
    lp = {"router": torch.randn(d, e, generator=gen, device=dev) / 64,
          "w_gate": torch.randn(e, d, f, generator=gen, device=dev) / 64,
          "w_up": torch.randn(e, d, f, generator=gen, device=dev) / 64,
          "w_down": torch.randn(e, f, d, generator=gen, device=dev) / 120}
    for v in lp.values():
        v.requires_grad_(True)
    ct = torch.randn(1, n, d, generator=gen, device=dev).to(dt)

    def fwd_bwd(_):
        out, aux = tf._moe_ffn(cfg, lp, x)
        torch.autograd.grad((out * ct).sum() + aux, [x, *lp.values()])

    out = {"ffn_fwd_bwd_ms": time_ms(fwd_bwd, [0], reps=5, inner=2)}
    with torch.no_grad():
        # a one-hot [N, E, cap] dispatch of every slot, as _moe_ffn builds
        slot = torch.arange(n, device=dev)
        disp = torch.zeros(n, e, cap, dtype=dt, device=dev)
        disp[slot, slot % e, (slot // e) % cap] = 1
        xf = x.detach().reshape(n, d)
        xe = torch.randn(e, cap, d, generator=gen, device=dev).to(dt)
        wg, wu, wd = (lp[k].detach().to(dt) for k in ("w_gate", "w_up", "w_down"))

        def experts(_):
            gate = torch.einsum("ecd,edf->ecf", xe, wg)
            return torch.einsum("ecf,efd->ecd", gate * torch.einsum("ecd,edf->ecf", xe, wu), wd)

        out.update(
            ffn_fwd_ms=time_ms(lambda _: tf._moe_ffn(cfg, lp, x), [0], reps=5, inner=2),
            dispatch_ms=time_ms(lambda _: torch.einsum("nec,nd->ecd", disp, xf), [0], reps=5,
                                inner=5),
            combine_ms=time_ms(lambda _: torch.einsum("ecd,nec->nd", xe, disp), [0], reps=5,
                               inner=5),
            experts_ms=time_ms(experts, [0], reps=5, inner=5))
    out["one_hot_bound_ms"] = 2.0 * e * cap * n * d / BF16_OPS_PER_S * 1e3
    out["experts_bound_ms"] = 3 * 2.0 * e * cap * d * f / BF16_OPS_PER_S * 1e3
    del x, lp, ct, disp, xf, xe, wg, wu, wd
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_moe_leaf_shapes(cfg) -> dict:
    """The shape of every leaf of 7d's model ``cfg`` (llama3_8b widths at 2
    layers with experts), from the config alone."""
    shapes = lm_leaf_shapes(cfg.n_layers)
    for i in range(cfg.n_layers):
        if cfg.is_moe_layer(i):
            for k in ("w_gate", "w_up", "w_down"):
                shapes[f"layers.{i}.{k}"] = (cfg.n_experts, *shapes[f"layers.{i}.{k}"])
            shapes[f"layers.{i}.router"] = (cfg.dim, cfg.n_experts)
    return shapes


def phase_lm_moe(kernels, compressors, torch, record):
    """7d: the LM's mixture-of-experts layers at one rank through
    ``harness.lm.main`` (phase 7's widths, depth and batch, bf16), dense and
    layer-wise Top-K 1 % + EF; the drop share of one batch's routing (the
    tokens past their expert's capacity) from the first MoE layer of the
    first step; the Top-K kernels held against their plain versions at the
    layer-wise groups' sizes the run gave ``fused_sparsify``, the expert
    stacks' included.  MFU is printed twice: the harness's ``6N``, whose N
    counts every expert, and by the active parameters (one expert a token,
    as top-1 routing runs).  Entire-model Top-K is not run: its one group
    of 2.72 G elements is past the kernels' 2^31 - 1 dispatch limit."""
    from tpu_compressed_dp_torch.harness import lm
    from tpu_compressed_dp_torch.models import transformer as tf

    card = record["card"]
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(tf.llama3_8b(), n_layers=2, n_experts=8, moe_every=2)
    sizes = [math.prod(sh) for sh in lm_moe_leaf_shapes(cfg).values()]
    n = sum(sizes)
    if n != LM_MOE_PARAMS:
        raise AssertionError(f"llama3_8b at 2 layers with 8 experts: {n} parameters")
    # top-1 routing runs one of each MoE layer's experts a token
    n_active = n - sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers)) * (
        (cfg.n_experts - 1) * 3 * cfg.dim * cfg.ffn)
    attn = 12.0 * cfg.n_layers * cfg.dim * 8192
    active_share = (6.0 * n_active + attn) / (6.0 * n + attn)
    kernel_sizes = sorted({m for m in sizes if kernels.use_fused_sparsify(m, "cuda")})
    routed, seen = {}, set()
    moe_ffn, fused = tf._moe_ffn, kernels.fused_sparsify

    def sized(acc, t, **kw):
        seen.add(acc.numel())
        return fused(acc, t, **kw)

    def counted(c, lp, x, tensor_group=None):
        if not routed:
            with torch.no_grad():
                xf = x.reshape(-1, x.shape[-1])
                top = torch.argmax(torch.softmax((xf @ lp["router"].to(c.dtype)).float(), -1), -1)
                per = torch.bincount(top, minlength=c.n_experts)
                cap = max(int(math.ceil(xf.shape[0] / c.n_experts * c.capacity_factor)), 1)
                routed.update(tokens=xf.shape[0], cap=cap, per_expert=per.tolist(),
                              dropped=int((per - cap).clamp(min=0).sum()))
        return moe_ffn(c, lp, x, tensor_group)

    runs = {}
    tf._moe_ffn, kernels.fused_sparsify = counted, sized
    try:
        for label, flags in LM_MOE_RUNS.items():
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            routed.clear()
            seen.clear()
            t0 = time.perf_counter()
            summary = lm.main(LM_ARGV + LM_MOE + flags)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            steps = summary["step"]
            if steps != 4 or not math.isfinite(summary["loss"]):
                raise AssertionError(f"7d {label}: {summary}")
            if any(launches[k] != 2 * steps for k in FLASH_ROUTES):
                raise AssertionError(f"7d {label}: flash launches {launches}, want 2 a step")
            if "topk" in label:
                if (launches["fused_sparsify"] < steps
                        or min(launches[k] for k in ("count_ge", "search_init")) < 1):
                    raise AssertionError(f"7d {label}: Top-K launches {launches}")
                if not 0.0 < summary["sent frac"] <= 0.0101:
                    raise AssertionError(f"7d {label}: sent frac {summary['sent frac']}")
                if sorted(seen) != kernel_sizes:
                    raise AssertionError(f"7d {label}: fused_sparsify saw groups of "
                                         f"{sorted(seen)} elements, want {kernel_sizes}")
            elif summary["sent frac"] != 1.0:
                raise AssertionError(f"7d {label}: sent frac {summary['sent frac']}")
            row = _lm_row(f"7d {label} (llama3_8b widths, 2 layers, 8 experts)", summary,
                          round(torch.cuda.max_memory_allocated() / 2 ** 30, 2), card, 8192)
            drop = routed["dropped"] / routed["tokens"]
            mfu_active = summary["mfu"] * active_share
            log(f"7d {label}: MFU {summary['mfu']} by 6N over all {n:,} parameters, "
                f"{mfu_active:.4f} by the {n_active:,} active ones (one expert a token)")
            log(f"7d {label}: {n:,} parameters; routing of step 1's batch at the MoE layer: "
                f"{routed['per_expert']} tokens an expert, cap {routed['cap']}, drop share "
                f"{drop:.4f}; wall {wall:.1f} s; launches {launches}")
            runs[label] = {**row, "launches": launches, "wall_s": wall, "routing": dict(routed),
                           "drop_share": drop, "mfu_active": mfu_active}
    finally:
        tf._moe_ffn, kernels.fused_sparsify = moe_ffn, fused
    t0 = time.perf_counter()
    holds = hold_lm_axes_groups(kernels, compressors, torch, kernel_sizes, "7d layer-wise group")
    log(f"7d Top-K holds at the layer-wise groups' sizes {kernel_sizes}: "
        f"{time.perf_counter() - t0:.1f} s")
    times = moe_ffn_times(torch, dataclasses.replace(cfg, dtype=torch.bfloat16))
    log("7d one MoE FFN (8,192 tokens, 8 experts, cap 1,280, bf16, events): forward "
        f"{times['ffn_fwd_ms']:.3f} ms, forward + backward {times['ffn_fwd_bwd_ms']:.3f}; "
        f"alone: the one-hot dispatch {times['dispatch_ms']:.3f} and combine "
        f"{times['combine_ms']:.3f} (bound {times['one_hot_bound_ms']:.3f} each), the three "
        f"expert products {times['experts_ms']:.3f} (bound {times['experts_bound_ms']:.3f}) "
        f"on {card}")
    wall = time.perf_counter() - t_phase
    log(f"7d wall {wall:.1f} s")
    record["lm_moe"] = {"runs": runs, "params": n, "active_params": n_active,
                        "ffn_times": times, "holds": holds, "wall_s": wall}
    return runs


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="On-card smoke test of the PyTorch port.")
    parser.add_argument("--record", default=None, help="write the full record here (JSON)")
    parser.add_argument("--rank_worker", nargs=4, default=None,
                        metavar=("WORLD", "RANK", "PORT", "OUT"),
                        help="internal: run one rank of the multi-rank phase")
    parser.add_argument("--lm_axes_worker", nargs=6, default=None,
                        metavar=("LABEL", "RANK", "PORT", "OUT", "LAYERS", "SEQ"),
                        help="internal: run one rank of phase 7c")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "tpu_compressed_dp_torch")):
        print("chip_smoke: run from the repository root (tpu_compressed_dp_torch/ "
              "not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.rank_worker:
        world, rank, port, out = args.rank_worker
        return rank_worker(int(world), int(rank), int(port), out)
    if args.lm_axes_worker:
        label, rank, port, out, layers, seq = args.lm_axes_worker
        return lm_axes_worker(label, int(rank), int(port), out, int(layers), int(seq))
    from tpu_compressed_dp_torch.harness import dawn, imagenet
    from tpu_compressed_dp_torch.ops import compressors, kernels, wire

    record = {}
    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    record["card"] = smi
    build_s = kernels.build()
    record["nvcc"] = {}
    for name, text in kernels.BUILD_LOG.items():
        report = ptxas_report(text)
        record["nvcc"][name] = {"seconds": kernels.BUILD_SECONDS.get(name), "kernels": report}
        for kname, r in report.items():
            log(f"nvcc {name}: {kname}: {r['registers']} registers, {r['spill_stores']} bytes "
                "spill stores")
        log(f"nvcc {name}.cu built in {kernels.BUILD_SECONDS.get(name, 0.0):.2f} s")
    log(f"kernels built in {build_s:.2f} s")
    record["build_s"] = build_s
    axes_runs = phase_lm_axes_ranks(kernels, compressors, torch, record)

    err, rows = phase_kernels(kernels, compressors, torch, record)
    d_err, d_rows = phase_dither(kernels, torch, record)
    err.update(d_err)
    for n, row in d_rows.items():
        rows[n].update(row)
    w_err, w_rows = phase_wire_kernels(kernels, compressors, wire, torch, record)
    err.update(w_err)
    for n, row in w_rows.items():
        rows[n].update(row)
    err["bucket_route"], route_rows = phase_route_kernel(kernels, compressors, torch, record)
    rows[FULL_MODEL]["bucket_route"] = route_rows["topk W=2"]
    f_err, f_rows = phase_flash(kernels, torch, record)
    err.update(f_err)
    rows[FULL_MODEL].update(f_rows["llama3_8b bf16"])
    p_err, p_rows = phase_pack_kernels(kernels, compressors, torch, record)
    err.update(p_err)
    for name, e in phase_pack_lm(kernels, compressors, torch, record).items():
        err[name] = max(err[name], e)
    err["qsgd_bytes"] = max(err["qsgd_bytes"], phase_qsgd_bytes_lm(kernels, torch, record))
    phase_search_lm(kernels, compressors, torch, record)
    phase_search_cifar(kernels, compressors, torch, record)
    rows[FULL_MODEL].update(p_rows)
    runs = phase_train(kernels, compressors, dawn, torch, record)
    cifar_runs = phase_cifar(kernels, compressors, dawn, torch, record)
    lm_runs = phase_lm(kernels, compressors, torch, record)
    seg_runs = phase_seg_path(kernels, compressors, dawn, torch, record,
                              runs["wire topk entiremodel"], lm_runs["wire topk entiremodel"])
    phase_lm_profile(kernels, torch, record)
    axes_runs.update(phase_lm_axes_one(kernels, torch, record, lm_runs))
    axes_runs.update(phase_lm_moe(kernels, compressors, torch, record))
    phase_steady(torch, record)
    phase_steady_cifar(torch, record)
    imagenet_runs = phase_imagenet(kernels, imagenet, torch, record)
    phase_steady_imagenet(kernels, torch, record)
    phase_resnet50_holds(kernels, compressors, torch, record)
    worlds = phase_multirank(torch, record)

    replaces = {"count_ge": "tpu_compressed_dp/ops/kernels.py:173",
                "count_edges": "tpu_compressed_dp/ops/kernels.py:206",
                # the set-up glue of _topk_threshold_pallas (max, quantile edges)
                "search_init": "tpu_compressed_dp/ops/kernels.py:235",
                "fused_sparsify": "tpu_compressed_dp/ops/kernels.py:487",
                "uniform": "tpu_compressed_dp/ops/kernels.py:1555",
                "qsgd": "tpu_compressed_dp/ops/kernels.py:1241",
                "terngrad": "tpu_compressed_dp/ops/kernels.py:1249",
                "select_pack": "tpu_compressed_dp/ops/kernels.py:1073",
                "terngrad_pack": "tpu_compressed_dp/ops/kernels.py:1439",
                "qsgd_pack": "tpu_compressed_dp/ops/kernels.py:1448",
                "bucket_route": "tpu_compressed_dp/ops/kernels.py:1613",
                "flash_fwd": "tpu_compressed_dp/ops/flash_attention.py:73",
                "flash_dq": "tpu_compressed_dp/ops/flash_attention.py:113",
                "flash_dkv": "tpu_compressed_dp/ops/flash_attention.py:177",
                "threshold_pack": "tpu_compressed_dp/ops/kernels.py:596",
                "seg_pack": "tpu_compressed_dp/ops/kernels.py:874",
                "ternary_bytes": "tpu_compressed_dp/ops/kernels.py:1380",
                "qsgd_bytes": "tpu_compressed_dp/ops/kernels.py:1385"}
    source = {"count_ge": "tpu_compressed_dp_torch/csrc/count_ge_edges.cu",
              "count_edges": "tpu_compressed_dp_torch/csrc/count_ge_edges.cu",
              "search_init": "tpu_compressed_dp_torch/csrc/count_ge_edges.cu",
              "fused_sparsify": "tpu_compressed_dp_torch/csrc/fused_sparsify.cu",
              "uniform": "tpu_compressed_dp_torch/csrc/dither.cu",
              "qsgd": "tpu_compressed_dp_torch/csrc/dither.cu",
              "terngrad": "tpu_compressed_dp_torch/csrc/dither.cu",
              "select_pack": "tpu_compressed_dp_torch/csrc/select_pack.cu",
              "terngrad_pack": "tpu_compressed_dp_torch/csrc/quant_pack.cu",
              "qsgd_pack": "tpu_compressed_dp_torch/csrc/quant_pack.cu",
              "bucket_route": "tpu_compressed_dp_torch/csrc/bucket_route.cu",
              **dict.fromkeys(FLASH_ROUTES, "tpu_compressed_dp_torch/csrc/flash_attention.cu"),
              **dict.fromkeys(("threshold_pack", "seg_pack"),
                              "tpu_compressed_dp_torch/csrc/threshold_pack.cu"),
              **dict.fromkeys(("ternary_bytes", "qsgd_bytes"),
                              "tpu_compressed_dp_torch/csrc/byte_pack.cu")}
    line = {"kernels": []}
    for name in replaces:
        r = rows[FULL_MODEL][name]
        # the main paths' launches: phase 3's and 3b's dawn runs, the LM runs
        # of phases 7, 7c (7c's ranks summed) and 7d, the segmented-path runs,
        # phase 8's ImageNet runs and the multi-rank dawn runs
        launches = (sum(run["launches"][name] for run in runs.values())
                    + sum(run["launches"][name] for run in cifar_runs.values())
                    + sum(run["launches"][name] for run in imagenet_runs.values())
                    + sum(run["launches"][name] for run in lm_runs.values())
                    + sum(run["launches"][name] for run in seg_runs.values())
                    + sum(w["launches"].get(name, 0) for w in worlds.values())
                    + sum(run["launches"].get(name, 0) for run in axes_runs.values()))
        entry = {
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": launches,
            "max_abs_err": err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"]}
        if "yardstick_ms" in r:
            # no one PyTorch call builds the buckets: the [W*cap+1] scatter pair
            entry["yardstick_ms"] = r["yardstick_ms"]
        if name == "flash_dkv":
            # one CUDA kernel serves the resident and the streamed TPU dkv kernels
            entry["also_replaces"] = "tpu_compressed_dp/ops/flash_attention.py:200"
        if name in ("flash_dq", "flash_dkv"):
            # no one PyTorch call computes dq or dk/dv alone: SDPA's backward
            # (all three) as forward + backward less forward
            f = rows[FULL_MODEL]
            entry["yardstick_ms"] = f["sdpa_fwd_bwd_ms"] - f["sdpa_fwd_ms"]
        line["kernels"].append(entry)
    by_name = {e["name"]: e for e in line["kernels"]}
    if not by_name["bucket_route"]["launches"]:
        raise AssertionError("the multi-rank runs never launched bucket_route")
    lm_all = (list(lm_runs.values()) + [seg_runs["lm llama3_8b 2 layers"]]
              + list(axes_runs.values()))
    if any(by_name[r]["launches"] != sum(run["launches"][r] for run in lm_all)
           for r in FLASH_ROUTES):
        raise AssertionError("a flash kernel launched off the LM runs")
    # the threshold pack and the byte packers serve no path, as in the
    # reference (phase 2b holds them); the segmented pack only the gated runs
    if any(by_name[r]["launches"] for r in ("threshold_pack", "ternary_bytes", "qsgd_bytes")):
        raise AssertionError("a path launched a kernel the reference never dispatches")
    if by_name["seg_pack"]["launches"] != sum(run["launches"]["seg_pack"]
                                              for run in seg_runs.values()):
        raise AssertionError("seg_pack launched off the gated segmented-path runs")
    if len(line["kernels"]) != 18:
        raise AssertionError(f"the kernels line has {len(line['kernels'])} entries, want 18")
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
        with open(args.record, "w") as f:
            json.dump({**record, "kernels_line": line}, f, indent=1, default=str)
    print(json.dumps(line))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
