#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``tpu_compressed_dp_torch``).

Run from the root of the repository: ``python3 chip_smoke.py [--record FILE]``.
It needs one CUDA card and the CUDA toolkit (``nvcc``), and exits non-zero,
printing no result, where either is missing or any phase fails.

  1. prints the card's name and power limit, builds the CUDA kernels from
     ``tpu_compressed_dp_torch/csrc`` with ``nvcc`` and prints the build time;
  2. holds every kernel against its plain PyTorch version on the card, at the
     shapes of full-width ResNet-9 (the 2,359,296-element layer3 residual
     conv and the 6,573,120-element entire model): histogram counts and
     thresholds exactly equal, fused sparsify bitwise; then times each kernel
     (CUDA events, after warm-up, inputs cycled past the 50 MB L2) beside its
     plain version, its memory bound and a library call;
  3. trains full-width ResNet-9 through the port's DAWNBench entry point
     (``harness.dawn.main``), 4 steps of batch 512 with Top-K 1 % + EF at
     layerwise and at entiremodel granularity on a 1-rank NCCL group, with
     every kernel's launch counter zeroed just before each run and read just
     after; checks finite loss, the kept fraction and that every kernel ran;
  4. times steady-state steps and the gradient sync alone (dense,
     layerwise, entiremodel);
  5. prints the kernels' JSON line, the ``nvidia-smi`` name/power line and,
     last, ``{"ok": true, "device": {...}}``.

``--record FILE`` also writes the full record (every timing, the profiles)
as JSON.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 rate outside the tensor cores
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


def bound_ms(bytes_moved: float, ops: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def raw_launchers(kernels, torch, n: int):
    """The kernels' C entry points with outputs allocated once (timing only;
    these launches are not counted)."""
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    counts = torch.zeros(16, dtype=torch.int32, device=dev)
    comp, ef = torch.empty(n, device=dev), torch.empty(n, device=dev)
    sent = torch.zeros(1, dtype=torch.int32, device=dev)
    c_count = kernels._lib("count_ge_edges").tcdp_count_ge_edges
    c_fused = kernels._lib("fused_sparsify").tcdp_fused_sparsify

    def count(x, edges):
        if c_count(x.data_ptr(), n, edges.data_ptr(), counts.data_ptr(), stream):
            raise RuntimeError("count_ge_edges launch failed")

    def fused(x, t):
        if c_fused(x.data_ptr(), n, t.data_ptr(), comp.data_ptr(), ef.data_ptr(),
                   sent.data_ptr(), stream):
            raise RuntimeError("fused_sparsify launch failed")

    return count, fused


def phase_kernels(kernels, compressors, torch, record):
    """Kernel vs plain on the card, then timings."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"count_ge": 0.0, "count_edges": 0.0, "fused_sparsify": 0.0}
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
            got = kernels.count_ge_edges(mag, edges, route=route)
            want = kernels.count_ge_edges_plain(mag, edges)
            d = (got.long() - want.long()).abs().max().item()
            err[route] = max(err[route], float(d))
            if d != 0:
                raise AssertionError(f"count_ge_edges ({route}) differs from plain at n={n}: "
                                     f"{got.tolist()} vs {want.tolist()}")
        # the whole threshold search: auto mode (the kernels) vs the same glue
        # on the plain counts, on the card and on the CPU (force mode)
        t_k = kernels.topk_threshold(mag, keep)
        t_p = kernels._topk_threshold_hist(
            mag, keep, count_fn=lambda x, e, route: kernels.count_ge_edges_plain(x, e))
        kernels.set_pallas_mode("force")
        try:
            t_cpu = kernels.topk_threshold(mag.cpu(), keep)
        finally:
            kernels.set_pallas_mode("auto")
        bits = {t.view(torch.int32).item() for t in (t_k, t_p, t_cpu)}
        if len(bits) != 1:
            raise AssertionError(f"threshold differs at n={n}: kernels {t_k.item()}, plain "
                                 f"{t_p.item()}, cpu {t_cpu.item()}")
        cnt = int((mag >= t_k).sum().item())
        if cnt < keep:
            raise AssertionError(f"threshold keeps {cnt} < {keep} at n={n}")
        sampled = kernels._sample_plan(n, keep) is not None
        log(f"threshold n={n} keep={keep}: t={t_k.item():.9g} bitwise == plain (card, CPU), "
            f"kept {cnt} (surplus {cnt - keep}), sampled first round: {sampled}")
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
        count_bound = bound_ms(4 * n + 17 * 4 + 16 * 4, 17 * n)
        row = {
            "count_ge": {
                "ms": time_ms(lambda x: raw_count(x, equi2), mags),
                "wrapper_ms": time_ms(lambda x: kernels.count_ge_edges(x, equi2), mags),
                "plain_ms": time_ms(lambda x: kernels.count_ge_edges_plain(x, equi2), mags),
                "bound": count_bound, "library_ms": lib},
            "count_edges": {
                "ms": time_ms(lambda x: raw_count(x, quant), mags),
                "wrapper_ms": time_ms(lambda x: kernels.count_ge_edges(
                    x, quant, route="count_edges"), mags),
                "plain_ms": time_ms(lambda x: kernels.count_ge_edges_plain(x, quant), mags),
                "bound": count_bound, "library_ms": lib},
            "fused_sparsify": {
                "ms": time_ms(lambda x: raw_fused(x, t_acc), accs),
                "wrapper_ms": time_ms(lambda x: kernels.fused_sparsify(x, t_acc), accs),
                "plain_ms": time_ms(lambda x: kernels.fused_sparsify_plain(x, t_acc), accs),
                "bound": bound_ms(12 * n + 8, 4 * n), "library_ms": None},
            "threshold_ms": thr,
            "topk_ms": lib,
        }
        rows[n] = row
        for name in ("count_ge", "count_edges", "fused_sparsify"):
            r = row[name]
            lib_txt = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            log(f"time n={n} {name}: {r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound'][0]:.4f} ms by {r['bound'][1]}, library {lib_txt})")
        log(f"time n={n} topk_threshold (all rounds + glue): {thr:.4f} ms; "
            f"torch.topk(mag, {keep}).values[-1]: {lib:.4f} ms")
        del mags, accs
    record["kernel_errors"] = err
    record["kernel_times"] = {str(n): r for n, r in rows.items()}
    return err, rows


def phase_train(kernels, dawn, torch, record):
    """The main path: dawn at full width, layerwise and entiremodel."""
    card = record["card"]
    runs = {}
    for gran in ("layerwise", "entiremodel"):
        argv = ["--network", "resnet9", "--synthetic", "--synthetic_n", "2048",
                "--batch_size", "512", "--epochs", "1", "--compress", gran,
                "--method", "topk", "--ratio", str(RATIO), "--error_feedback",
                "--mode", "simulate", "--device", "cuda", "--seed", "0", "--log_dir", ""]
        kernels.reset_launches()
        t0 = time.perf_counter()
        summary = dawn.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        steps = summary["steps"]
        loss = summary["train loss"]
        sent = summary["sent frac"]
        if not math.isfinite(loss) or not math.isfinite(summary["test loss"]):
            raise AssertionError(f"{gran}: non-finite loss {loss}")
        if abs(sent - RATIO) > 0.1 * RATIO:
            raise AssertionError(f"{gran}: sent frac {sent} is not ~{RATIO}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"{gran}: a kernel never launched: {launches}")
        ms = summary["train time"] * 1e3 / steps
        log(f"train {gran}: {steps} steps, loss {loss:.4f}, sent frac {sent:.5f}, "
            f"{ms:.2f} ms/step, {summary['img/s']} img/s (first epoch, warm-up included) "
            f"on {card}, run wall {wall:.2f} s, launches {launches}")
        runs[gran] = {"summary": summary, "launches": launches, "ms_per_step": ms}
    if runs["entiremodel"]["launches"]["count_edges"] < runs["entiremodel"]["summary"]["steps"]:
        raise AssertionError("entiremodel did not take the sampled first round every step")
    record["train"] = runs
    return runs


def _category(name: str) -> str:
    low = name.lower()
    if "count_ge_edges_kernel" in name or "fused_sparsify_kernel" in name:
        return "port CUDA kernels"
    if "sort" in low or "topk" in low or "radix" in low:
        return "torch.topk (exact threshold, small leaves)"
    if any(k in low for k in ("conv", "xmma", "cudnn", "gemm", "wgrad", "dgrad", "sm90")):
        return "convolution / matmul"
    if "nccl" in low:
        return "nccl"
    if "reduce" in low:
        return "reductions"
    return "elementwise and other"


def device_profile(run, torch, n_steps: int = 3) -> dict:
    """torch.profiler over ``run(n_steps)``: device busy time per step (the
    union of kernel intervals), idle share of the wall time, and device time
    by kernel category and by the top kernels."""
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms_per_step": wall_us / 1e3 / n_steps,
            "device_busy_ms_per_step": busy / 1e3 / n_steps,
            "idle_share": 1.0 - busy / wall_us,
            "launches_per_step": len(kern) / n_steps,
            "by_category_ms_per_step": {k: v / 1e3 / n_steps for k, v in
                                        sorted(by_cat.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms_per_step": [(k[:80], v / 1e3 / n_steps) for k, v in top]}


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
    for label, method, gran in (("dense", None, "layerwise"), ("layerwise", "topk", "layerwise"),
                                ("entiremodel", "topk", "entiremodel")):
        cfg = CompressionConfig(method=method, granularity=gran, ratio=RATIO,
                                error_feedback=method is not None)
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
        sync_ms = time_ms(lambda g: sync(g, ef), [grads], reps=10, inner=5)
        out[label] = {"step_ms": step_ms, "img_s": 512 / step_ms * 1e3, "sync_ms": sync_ms,
                      "profile": prof}
        log(f"steady {label}: {step_ms:.3f} ms/step ({512 / step_ms * 1e3:.0f} img/s), "
            f"gradient sync alone {sync_ms:.3f} ms, on {record['card']}")
        log(f"profile {label}: {json.dumps(prof)}")
        del state, model, params, grads
    record["steady"] = out


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="On-card smoke test of the PyTorch port.")
    parser.add_argument("--record", default=None, help="write the full record here (JSON)")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "tpu_compressed_dp_torch")):
        print("chip_smoke: run from the repository root (tpu_compressed_dp_torch/ "
              "not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from tpu_compressed_dp_torch.harness import dawn
    from tpu_compressed_dp_torch.ops import compressors, kernels

    record = {}
    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    record["card"] = smi
    build_s = kernels.build()
    for name, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"nvcc {name}: {line.strip()}")
    log(f"kernels built in {build_s:.2f} s")
    record["build_s"] = build_s

    err, rows = phase_kernels(kernels, compressors, torch, record)
    runs = phase_train(kernels, dawn, torch, record)
    phase_steady(torch, record)

    replaces = {"count_ge": "tpu_compressed_dp/ops/kernels.py:173",
                "count_edges": "tpu_compressed_dp/ops/kernels.py:206",
                "fused_sparsify": "tpu_compressed_dp/ops/kernels.py:487"}
    source = {"count_ge": "tpu_compressed_dp_torch/csrc/count_ge_edges.cu",
              "count_edges": "tpu_compressed_dp_torch/csrc/count_ge_edges.cu",
              "fused_sparsify": "tpu_compressed_dp_torch/csrc/fused_sparsify.cu"}
    line = {"kernels": []}
    for name in ("count_ge", "count_edges", "fused_sparsify"):
        r = rows[FULL_MODEL][name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name],
            "launches": sum(run["launches"][name] for run in runs.values()),
            "max_abs_err": err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"]})
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
