"""Where the step guard's time and memory go on the card.

    python -m tpu_compressed_dp_torch.harness.guard_trace [--out FILE]

Needs one CUDA card.  Two readings, each of a guarded step against the
unguarded one on the same state:

* **Time**, full-width ResNet-9, batch 512, fp32, Top-K 1 % + EF, layer-wise
  and entire-model.  Blocks of six steps in turns: unguarded,
  guarded, guarded with the vote as one multi-tensor launch
  (``torch._amp_foreach_non_finite_check_and_unscale_`` at an inverse scale
  of 1.0, in place of the per-leaf ``aminmax``), that again, guarded,
  unguarded.  Each block runs twice: once timed (the step's wall ms with a
  device sync after each step, the host's ms until ``step`` returns, and
  the host's ms blocked in the vote's read), once under ``torch.profiler``
  (per step the device's busy ms, the union of its kernels' and memory
  operations' intervals, and the kernels launched).  Wall minus busy is the
  device's idle time a step.
* **Memory**, phase 7's LM of ``chip_smoke.py`` (llama3_8b widths, 2 layers,
  seq 8192, bf16, entire-model Top-K 1 % + EF) in phase 9e's order of
  blocks, an Inf on the loss vetoing one guarded step: the peak allocated
  bytes of each part of every step, the forward and backward pass, the
  guard's vote and unscale, the sync, SGD and the metrics, read by
  resetting the peak between the parts.

The ResNet-9 steps have no fault: every verdict is good.  The last line of
standard output is one JSON object with every reading.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import time

import numpy as np
import torch

from tpu_compressed_dp_torch.ops import kernels
from tpu_compressed_dp_torch.train import guard as guard_mod

CIFAR_MEAN = [125.307, 122.961, 113.8575]
CIFAR_STD = [62.9932, 62.0887, 66.7048]
BATCH, RATIO = 512, 0.01
STEPS = 6            # steps a ResNet-9 block
LM_STEPS = 3         # steps an LM block, as phase 9e
LM_BAD_STEP = 5      # the vetoed LM step (an Inf on the loss), as phase 9e


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def foreach_all_finite(*trees) -> torch.Tensor:
    """``guard.tree_all_finite`` as one multi-tensor pass per dtype: the
    floating leaves multiplied in place by 1.0 (their bits stay) while the
    pass flags any nonfinite element."""
    leaves = []
    for tree in trees:
        leaves += (list(tree.values()) if isinstance(tree, dict)
                   else [tree] if isinstance(tree, torch.Tensor) else list(tree))
    leaves = [t.detach().reshape(-1) for t in leaves if t.is_floating_point()]
    found = torch.zeros(1, dtype=torch.float32, device=leaves[0].device)
    one = torch.ones(1, dtype=torch.float32, device=found.device)
    for dt in {t.dtype for t in leaves}:
        torch._amp_foreach_non_finite_check_and_unscale_(
            [t for t in leaves if t.dtype == dt], found, one)
    return found[0] == 0


class _Patch:
    """Replace module attributes for a ``with`` block."""

    def __init__(self, *triples):
        self.triples, self.saved = triples, []

    def __enter__(self):
        for obj, name, value in self.triples:
            self.saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, value)

    def __exit__(self, *exc):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)


def _timed_vote(blocked: list):
    inner = guard_mod.finite_vote

    def vote(local_ok, group=None):
        t0 = time.perf_counter()
        out = inner(local_ok, group)
        blocked.append((time.perf_counter() - t0) * 1e3)
        return out

    return vote


def _device_busy_ms(prof) -> tuple:
    """The union of the device's kernel and memory-operation intervals (ms)
    and the number of kernels, from a finished profile."""
    spans, n_kernels = [], 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        n_kernels += not ev.name.startswith("Memcpy") and not ev.name.startswith("Memset")
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, n_kernels


def _resnet_setup(dev, gran: str, guard_cfg):
    from tpu_compressed_dp_torch.models.common import make_normalizing_apply_fn, param_leaves
    from tpu_compressed_dp_torch.models.resnet9 import ResNet9
    from tpu_compressed_dp_torch.parallel.dp import CompressionConfig, init_ef_state
    from tpu_compressed_dp_torch.train.optim import SGD
    from tpu_compressed_dp_torch.train.state import TrainState
    from tpu_compressed_dp_torch.train.step import make_train_step

    model = ResNet9(seed=0, device=dev)
    params = param_leaves(model)
    comp = CompressionConfig(method="topk", ratio=RATIO, error_feedback=True, granularity=gran)
    bs = np.float32(BATCH)
    opt = SGD(lr=lambda s: np.float32(0.4) * np.float32(min(s, 5)) / np.float32(5) / bs,
              momentum=0.9, nesterov=True, weight_decay=5e-4 * BATCH)
    state = TrainState.create(model, opt.init(params), init_ef_state(params, comp), seed=1,
                              guard=guard_mod.init_guard_state(guard_cfg))
    apply_fn = make_normalizing_apply_fn(CIFAR_MEAN, CIFAR_STD)

    def step(cfg):
        return make_train_step(apply_fn, opt, comp, grad_scale=float(BATCH), guard_cfg=cfg)

    return state, step


def resnet_time(dev, gran: str) -> dict:
    """The timed and the profiled blocks of one granularity (module
    docstring)."""
    gcfg = guard_mod.GuardConfig.for_dtype(torch.float32)
    state, make = _resnet_setup(dev, gran, gcfg)
    steps_of = {"unguarded": make(None), "guarded": make(gcfg), "foreach": make(gcfg)}
    g = torch.Generator(device=dev).manual_seed(0)
    batches = [{"input": torch.randint(0, 256, (BATCH, 32, 32, 3), dtype=torch.uint8,
                                       device=dev, generator=g),
                "target": torch.randint(0, 10, (BATCH,), device=dev, generator=g)}
               for _ in range(2)]
    box = [state]
    del state

    def run(label, profiled):
        blocked = []
        patches = [(guard_mod, "finite_vote", _timed_vote(blocked))]
        if label == "foreach":
            patches.append((guard_mod, "tree_all_finite", foreach_all_finite))
        walls, hosts = [], []
        with _Patch(*patches):
            torch.cuda.synchronize()
            if profiled:
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    for i in range(STEPS):
                        box[0], _ = steps_of[label](box[0], batches[i % 2])
                    torch.cuda.synchronize()
                busy, n = _device_busy_ms(prof)
                return {"busy_ms_a_step": busy / STEPS, "kernels_a_step": n / STEPS}
            for i in range(STEPS):
                t0 = time.perf_counter()
                box[0], _ = steps_of[label](box[0], batches[i % 2])
                hosts.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        return {"wall_ms": walls, "host_ms": hosts, "vote_blocked_ms": blocked}

    # warm-up: the allocator, cuDNN's plans and the kernels' first launches
    for label in steps_of:
        run(label, False)
    blocks = []
    for label in ("unguarded", "guarded", "foreach", "foreach", "guarded", "unguarded"):
        row = {"label": label, **run(label, False), **run(label, True)}
        rest = sorted(row["wall_ms"][1:])
        row["median_wall_ms"] = rest[len(rest) // 2]
        row["median_host_ms"] = sorted(row["host_ms"][1:])[len(rest) // 2]
        row["idle_ms_a_step"] = row["median_wall_ms"] - row["busy_ms_a_step"]
        blocks.append(row)
    del box
    gc.collect()
    torch.cuda.empty_cache()
    return {"granularity": gran, "blocks": blocks}


def lm_memory(dev) -> dict:
    """The peak allocated GB of each part of an unguarded and a guarded LM
    step (module docstring), in the order of ``chip_smoke.py``'s phase 9e:
    one unguarded warm-up step, then blocks of ``LM_STEPS`` unguarded,
    guarded, guarded and unguarded steps, the guarded step injecting an Inf
    into the loss at step ``LM_BAD_STEP`` (the first guarded block's second
    step: a vetoed step)."""
    from tpu_compressed_dp_torch.data import lm as lm_data
    from tpu_compressed_dp_torch.harness.loop import to_device
    from tpu_compressed_dp_torch.models import transformer as tf
    from tpu_compressed_dp_torch.parallel import dp
    from tpu_compressed_dp_torch.train import lm_step
    from tpu_compressed_dp_torch.train.optim import SGD
    from tpu_compressed_dp_torch.train.schedules import piecewise_linear
    from tpu_compressed_dp_torch.train.state import TrainState
    from tpu_compressed_dp_torch.utils.chaos import ChaosConfig

    cfg = dataclasses.replace(tf.llama3_8b(), n_layers=2)
    model = tf.Llama(cfg, seed=0, device=dev)
    params = tf.param_leaves(model)
    comp = dp.CompressionConfig(method="topk", ratio=RATIO, error_feedback=True,
                                granularity="entiremodel")
    opt = SGD(lr=piecewise_linear([0, 1, 12], [0.0, 3e-3, 3e-4]), momentum=0.9)
    gcfg = guard_mod.GuardConfig.for_dtype(torch.bfloat16)
    box = [TrainState.create(model, opt.init(params), lm_step.init_lm_ef_state(cfg, params, comp),
                             seed=1, guard=guard_mod.init_guard_state(gcfg))]
    del model, params
    steps_of = {"unguarded": lm_step.make_lm_train_step(cfg, opt, comp),
                "guarded": lm_step.make_lm_train_step(
                    cfg, opt, comp, guard_cfg=gcfg,
                    chaos=ChaosConfig(kind="inf", target="loss", steps=(LM_BAD_STEP,)))}
    ds = lm_data.SyntheticTokens(cfg.vocab_size, 8192, 1, seed=0)
    batches = [to_device(ds.batch(i), dev) for i in range(3)]
    parts: list = []

    def mark(name):
        parts.append((name, torch.cuda.max_memory_allocated() / 1e9,
                      torch.cuda.memory_allocated() / 1e9))
        torch.cuda.reset_peak_memory_stats()

    vet, sync_call, apply = guard_mod.vet, dp.PartitionedSync.__call__, SGD.apply

    def vet_marked(*a, **k):
        mark("forward and backward")
        out = vet(*a, **k)
        mark("vote and unscale")
        return out

    def sync_marked(self, *a, **k):
        out = sync_call(self, *a, **k)
        mark("sync")
        return out

    def apply_marked(self, *a, **k):
        out = apply(self, *a, **k)
        mark("SGD")
        return out

    rows = []
    with _Patch((guard_mod, "vet", vet_marked), (dp.PartitionedSync, "__call__", sync_marked),
                (SGD, "apply", apply_marked)):
        blocks = ("unguarded", "guarded", "guarded", "unguarded")
        for label in ("unguarded",) + tuple(b for b in blocks for _ in range(LM_STEPS)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            parts.clear()
            step = box[0].step
            box[0], m = steps_of[label](box[0], batches[step % len(batches)])
            torch.cuda.synchronize()
            mark("metrics")
            rows.append({"label": label, "step": step,
                         "nonfinite": float(m.get("guard/nonfinite", 0.0)), "parts": [
                             {"part": n, "peak_gb": p, "after_gb": a} for n, p, a in parts]})
    del box
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("guard_trace needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    card = nvidia_smi()
    out = {"card": card,
           "resnet9": [resnet_time(dev, g) for g in ("layerwise", "entiremodel")],
           "lm": lm_memory(dev)}
    for r in out["resnet9"]:
        for b in r["blocks"]:
            print(f"resnet9 {r['granularity']} {b['label']}: wall {b['median_wall_ms']:.2f} ms, "
                  f"host {b['median_host_ms']:.2f} ms, device busy {b['busy_ms_a_step']:.2f} "
                  f"ms, idle {b['idle_ms_a_step']:.2f} ms, {b['kernels_a_step']:.0f} kernels, "
                  f"vote blocked {np.median(b['vote_blocked_ms'] or [0.0]):.2f} ms a step "
                  f"on {card}")
    for r in out["lm"]["steps"]:
        print(f"lm {r['label']} step {r['step']} (nonfinite {r['nonfinite']:g}): " + ", ".join(
            f"{p['part']} peak {p['peak_gb']:.2f} GB (then {p['after_gb']:.2f})"
            for p in r["parts"]) + f" on {card}")
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
