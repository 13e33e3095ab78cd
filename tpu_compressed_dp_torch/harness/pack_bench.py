"""Device time of the threshold pack and the segmented pack
(``csrc/threshold_pack.cu``): this tree's kernels against another tree's, on
the same inputs, and the gated segmented wire Top-K path's steps of both
trees.

    python -m tpu_compressed_dp_torch.harness.pack_bench --baseline DIR \\
        [--sizes resnet9|lm|all] [--seg_path] [--out FILE]

``DIR`` is a checkout of the port.  Each tree's ``csrc/threshold_pack.cu``
is built with the port's ``nvcc`` flags into ``build/pack_bench/`` and bound
by what it exports: the one-pass entries (``tcdp_threshold_pack_state_words``
present: a look-back state instead of scratch) or the three-launch ones of
the port up to commit 497000e (count, scan and place, with per-block
scratch).  Each tree runs in a process of its own (a worker: this module
with ``--worker TREE``), one library of the kernels a process.  Inputs,
made from one seed in every worker: N(0, 1) data at its Top-K 1 % threshold
(``kernels.topk_threshold``), block rows 512, at ResNet-9's entire-model
size (6,573,120) and with ``--sizes lm`` the LM's two sync groups at
llama3_8b widths.  At 6.57 M each worker holds its tree's kernels bitwise
to this tree's plain versions; at every size the two trees' outputs must
have the same digest (payload, EF, meta / counts, elig, starts).  The
readings: CUPTI device time a call (every kernel the call launches,
``torch.profiler``) and CUDA-event time a call (the C entry back to back,
outputs allocated once), over inputs cycled past the 50 MB L2, in turns of
worker: baseline, this tree, this tree, baseline; beside each kernel's bound
(the bytes at 3.35 TB/s).  ``--seg_path`` then runs each tree's
``chip_smoke.phase_seg_path`` (dawn ResNet-9 and the LM at llama3_8b widths
cut to 2 layers, entire-model wire Top-K 1 % + EF through the segmented
pack, 4 steps each) in its own process, in the same turns, and reads the ms
a step of each.  Needs one CUDA card.
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

from tpu_compressed_dp_torch.harness.select_pack_bench import (ENTIRE_MODEL, HBM_BYTES_PER_S,
                                                               LM_GROUPS, RATIO, device_ms,
                                                               event_ms, nvidia_smi)
from tpu_compressed_dp_torch.ops import compressors, kernels

ROWS = 512
_OUT = os.path.join(os.path.dirname(kernels._BUILD_DIR), "pack_bench")
_TURNS = ("base", "ours", "ours", "base")


def build_tree(tree: str) -> ctypes.CDLL:
    """``tree``'s threshold_pack.cu, built and bound."""
    os.makedirs(_OUT, exist_ok=True)
    src = os.path.join(tree, "tpu_compressed_dp_torch", "csrc", "threshold_pack.cu")
    out = os.path.join(_OUT, f"threshold_pack-{os.getpid()}.so")
    res = subprocess.run([kernels._nvcc(), *kernels._NVCC_FLAGS, "-o", out, src],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(out)
    p, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if hasattr(lib, "tcdp_threshold_pack_state_words"):
        kernels._bind("threshold_pack", lib)
    else:
        lib.tcdp_threshold_pack.argtypes = [p, ll, p, i32, i32, p, p, p, p, p, p, p]
        lib.tcdp_seg_pack.argtypes = [p, ll, p, i32, i32, p, p, p, p, p, p, p]
        lib.tcdp_threshold_pack.restype = lib.tcdp_seg_pack.restype = i32
    return lib


def launchers(lib, n: int, keep: int):
    """(threshold pack, segmented pack) through ``lib``'s C entries, outputs
    and state or scratch allocated once; each returns its outputs."""
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    P = kernels.pack_payload_slots(n, keep, ROWS)
    nb = -(-n // (ROWS * 128))
    nseg = -(-n // 65536) * 16
    one_pass = hasattr(lib, "tcdp_threshold_pack_state_words")
    vals, idx = torch.empty(P, device=dev), torch.empty(P, dtype=torch.int32, device=dev)
    ef, sef = torch.empty(n, device=dev), torch.empty(n, device=dev)
    meta = torch.empty(3, dtype=torch.int32, device=dev)
    svals = torch.empty(nseg * 128, device=dev)
    sidx = torch.empty(nseg * 128, dtype=torch.int32, device=dev)
    seg = torch.empty(3, nseg, dtype=torch.int32, device=dev)
    # the state (or scratch) lives as long as the launchers, which hold it
    if one_pass:
        state = torch.zeros(max(lib.tcdp_threshold_pack_state_words(n, ROWS),
                                lib.tcdp_seg_pack_state_words(nseg)), dtype=torch.int64,
                            device=dev)
        tail = lambda: (state.data_ptr(), state.numel())  # noqa: E731
        seg_tail = tail
    else:
        scratch = torch.empty(2, nb, dtype=torch.int32, device=dev)
        tail = lambda: (scratch[0].data_ptr(), scratch[1].data_ptr())  # noqa: E731
        seg_tail = lambda: ()  # noqa: E731

    def check(rc, name):
        if rc:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")

    def pack(x, t):
        check(lib.tcdp_threshold_pack(x.data_ptr(), n, t.data_ptr(), ROWS, P // 128,
                                      vals.data_ptr(), idx.data_ptr(), ef.data_ptr(),
                                      meta.data_ptr(), *tail(), stream), "threshold_pack")
        return vals, idx, ef, meta

    def seg_pack(x, t):
        check(lib.tcdp_seg_pack(x.data_ptr(), n, t.data_ptr(), keep, nseg, svals.data_ptr(),
                                sidx.data_ptr(), sef.data_ptr(), seg[0].data_ptr(),
                                seg[1].data_ptr(), seg[2].data_ptr(), *seg_tail(), stream),
              "seg_pack")
        return svals, sidx, sef, seg
    return pack, seg_pack


def digest(outs, chunk: int = 1 << 26) -> list:
    """A digest of each output's bits: its int32 words weighted by a fixed
    pseudo-random sequence of their positions, summed (in int64, a chunk at
    a time)."""
    out = []
    for o in outs:
        words, total = o.reshape(-1).view(torch.int32), 0
        for lo in range(0, words.numel(), chunk):
            w = words[lo:lo + chunk].long()
            k = torch.arange(lo, lo + w.numel(), device=w.device, dtype=torch.int64)
            total += int(((w + 0x9E3779B1) * (k * 0x5851F42D + 0x14057B7E) % (1 << 31)).sum())
        out.append(total)
    return out


def _same(a, b) -> bool:
    return all(torch.equal(u.reshape(-1).view(torch.int32), w.reshape(-1).view(torch.int32))
               for u, w in zip(a, b))


def run_size(n: int, gen, lib) -> dict:
    """One tree's kernels at n: digests, plain holds at 6.57 M, timings."""
    dev = torch.device("cuda")
    keep = compressors.topk_keep_count(n, RATIO)
    copies = max(1, math.ceil(120e6 / (4 * n)))
    xs = [torch.randn(n, generator=gen, device=dev) for _ in range(copies)]
    t = kernels.topk_threshold(xs[0].abs(), keep)
    inputs = [(x, t) for x in xs]
    P = kernels.pack_payload_slots(n, keep, ROWS)
    nseg = -(-n // 65536) * 16
    bounds = {"threshold_pack": (4 * n + 4 + 4 * n + 8 * P + 12) / HBM_BYTES_PER_S * 1e3,
              "seg_pack": (4 * n + 4 + 4 * n + 8 * 128 * nseg + 12 * nseg) / HBM_BYTES_PER_S
              * 1e3}
    runs = dict(zip(bounds, launchers(lib, n, keep)))
    plain = {"threshold_pack": lambda x, t: kernels.pack_by_threshold_plain(x, t, keep),
             "seg_pack": lambda x, t: kernels.seg_pack_by_threshold_plain(x, t, keep)}
    reps = max(5, min(200, int(2e9 / (4 * n))))
    out = {}
    for name, run in runs.items():
        got = run(*inputs[0])
        row = {"n": n, "keep": keep, "bound_ms": bounds[name], "digest": digest(got)}
        if n < 10_000_000:
            want = plain[name](*inputs[0])
            if name == "seg_pack":   # vals, idx, EF, then (counts, elig, starts)
                want = (want[0], want[1], want[2], torch.stack([want[4], want[3], torch.cumsum(
                    want[3], 0, dtype=torch.int32) - want[3]]))
            if not _same(got[:3], want[:3]) or not _same(got[3].reshape(-1)[:1 if name ==
                                                         "threshold_pack" else None],
                                                         want[3].reshape(-1)):
                raise AssertionError(f"n={n}: {name} differs from its plain version")
        row["device_ms"] = device_ms(run, inputs, reps)
        row["event_ms"] = event_ms(run, inputs, reps)
        out[name] = row
    del xs, inputs, runs
    torch.cuda.empty_cache()
    return out


def worker(tree: str, sizes) -> dict:
    # the tree's library stands in for this tree's, so that the process
    # loads one copy of the kernels (kernels.build() loads the others)
    lib = kernels._LIBS["threshold_pack"] = build_tree(tree)
    kernels.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    return {str(n): run_size(n, gen, lib) for n in sizes}


# runs one tree's gated segmented path in its own process (from the tree's
# root) and prints {label: ms a step} as its last line
_SEG_PATH = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as c
from tpu_compressed_dp_torch.harness import dawn
from tpu_compressed_dp_torch.ops import compressors, kernels
kernels.build()
base = {"ms_per_step": 0.0, "step_ms": 0.0, "summary": {"sent frac": 0.0}}
runs = c.phase_seg_path(kernels, compressors, dawn, torch, {"card": c.nvidia_smi()}, base, base)
print(json.dumps({k: v["ms_per_step"] for k, v in runs.items()}))
"""


def seg_path_ms(tree: str) -> dict:
    res = subprocess.run([sys.executable, "-c", _SEG_PATH], cwd=tree, capture_output=True,
                         text=True, timeout=1200)
    if res.returncode:
        raise RuntimeError(f"the gated path failed in {tree}:\n{res.stdout[-3000:]}"
                           f"{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def run_worker(tree: str, sizes: str) -> dict:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    res = subprocess.run([sys.executable, "-m", "tpu_compressed_dp_torch.harness.pack_bench",
                          "--worker", tree, "--sizes", sizes], cwd=here, capture_output=True,
                         text=True, timeout=1200)
    if res.returncode:
        raise RuntimeError(f"the worker for {tree} failed:\n{res.stdout[-3000:]}"
                           f"{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", help="checkout of the baseline tree")
    parser.add_argument("--sizes", choices=("resnet9", "lm", "all"), default="all")
    parser.add_argument("--seg_path", action="store_true",
                        help="also time both trees' gated segmented wire Top-K steps")
    parser.add_argument("--out", default=None, help="write the readings here (JSON)")
    parser.add_argument("--worker", default=None, metavar="TREE",
                        help="internal: time TREE's kernels and print the readings")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("pack_bench: needs a CUDA card", file=sys.stderr)
        return 2
    sizes = ([ENTIRE_MODEL] if args.sizes in ("resnet9", "all") else []) + (
        list(LM_GROUPS) if args.sizes in ("lm", "all") else [])
    if args.worker:
        print(json.dumps(worker(args.worker, sizes)))
        return 0
    if not args.baseline:
        parser.error("--baseline is required")
    card = nvidia_smi()
    print(card, flush=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    trees = {"ours": here, "base": os.path.abspath(args.baseline)}
    rows = {}
    for key in _TURNS:
        for n, by_name in run_worker(trees[key], args.sizes).items():
            for name, r in by_name.items():
                row = rows.setdefault(n, {}).setdefault(name, {
                    "n": r["n"], "keep": r["keep"], "bound_ms": r["bound_ms"], "digest": {}})
                row["digest"][key] = r["digest"]
                row.setdefault(f"{key}_device_ms", []).append(r["device_ms"])
                row.setdefault(f"{key}_event_ms", []).append(r["event_ms"])
    differ = []
    for n, by_name in rows.items():
        for name, row in by_name.items():
            row["equal"] = row["digest"]["ours"] == row["digest"]["base"]
            if not row["equal"]:
                differ.append(f"n={n} {name}")
            print(f"n={n} {name}: device us ours "
                  f"{', '.join(f'{1e3 * v:.2f}' for v in row['ours_device_ms'])}, baseline "
                  f"{', '.join(f'{1e3 * v:.2f}' for v in row['base_device_ms'])}; events ours "
                  f"{', '.join(f'{1e3 * v:.2f}' for v in row['ours_event_ms'])}, baseline "
                  f"{', '.join(f'{1e3 * v:.2f}' for v in row['base_event_ms'])}; bound "
                  f"{1e3 * row['bound_ms']:.2f}; outputs "
                  f"{'equal' if row['equal'] else 'DIFFER'}", flush=True)
    steps = {}
    if args.seg_path:
        for key in _TURNS:
            ms = seg_path_ms(trees[key])
            for label, v in ms.items():
                steps.setdefault(label, {}).setdefault(key, []).append(v)
            print(f"gated path ({key}): {json.dumps(ms)}", flush=True)
    print(card, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "sizes": rows, "seg_path_ms": steps}, f, indent=1)
    if differ:
        raise AssertionError(f"the trees' outputs differ at {differ}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
