"""Hand-written CUDA kernels for the Top-K compression hot path, and their glue.

PyTorch/H100 counterpart of the Top-K part of
:mod:`tpu_compressed_dp.ops.kernels`.  Three Pallas TPU kernels there have a
CUDA C++ kernel here (sources in ``tpu_compressed_dp_torch/csrc``, built for
``sm_90a`` by ``nvcc`` on first use into ``build/torch_kernels/`` and loaded
with ``ctypes``):

  * ``count_ge_edges`` (``csrc/count_ge_edges.cu``) serves both
    ``_count_ge_kernel`` (an equispaced refinement round of the histogram
    threshold search) and ``_count_edges_kernel`` (its sampled-quantile first
    round): cumulative int32 counts at 17 edges read from device memory;
  * ``fused_sparsify`` (``csrc/fused_sparsify.cu``) replaces
    ``_fused_sparsify_kernel``: threshold, EF residual and nonzero-survivor
    count in one pass.

Every kernel has a plain PyTorch version beside it (``*_plain``).  A wrapper
runs the plain version only because the tensor it was given lies on the CPU;
on a CUDA tensor it launches the kernel or raises.  Each launch adds one to
``LAUNCHES[<route>]`` so a run can show that it went through the kernels.

Dispatch follows the JAX package (``pallas_mode``): ``auto`` (default) takes
the histogram/fused path for CUDA tensors of at least ``MIN_PALLAS_ELEMS``
elements and the exact path (``torch.topk`` threshold, unfused
where/subtract) otherwise; ``force`` takes the histogram/fused path at every
size and on every device (on the CPU through the plain versions, the
counterpart of the Pallas interpreter); ``off`` takes the exact path
everywhere.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional, Tuple

import torch

__all__ = [
    "set_pallas_mode",
    "pallas_mode",
    "topk_threshold",
    "fused_sparsify",
    "fused_sparsify_plain",
    "use_fused_sparsify",
    "count_ge_edges",
    "count_ge_edges_plain",
    "build",
    "LAUNCHES",
    "MIN_PALLAS_ELEMS",
]

_MODE = "auto"  # auto | off | force
MIN_PALLAS_ELEMS = 1 << 16
_HIST_BINS = 16
_ROUNDS = 7  # 16 bins x 7 rounds resolve the threshold to max|g| / 2^28
_INT32_MAX = (1 << 31) - 1
_FP32_MAX = torch.finfo(torch.float32).max

#: kernel launches per route since the last reset; only a CUDA launch counts
LAUNCHES: Dict[str, int] = {"count_ge": 0, "count_edges": 0, "fused_sparsify": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def set_pallas_mode(mode: str) -> None:
    global _MODE
    if mode not in ("auto", "off", "force"):
        raise ValueError(f"pallas mode must be auto|off|force, got {mode!r}")
    _MODE = mode


def pallas_mode() -> str:
    return _MODE


def _dispatch_to_kernel(n: int, device: torch.device) -> bool:
    if _MODE == "off" or n > _INT32_MAX:
        return False
    if _MODE == "force":
        return True
    return torch.device(device).type == "cuda" and n >= MIN_PALLAS_ELEMS


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_kernels")
_SOURCES = ("count_ge_edges", "fused_sparsify")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_LIBS: Dict[str, ctypes.CDLL] = {}
#: nvcc's -Xptxas -v report per source from the last build (registers, smem)
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    path = os.environ.get("NVCC") or shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked for {path}); the CUDA kernels "
                           "need the CUDA toolkit to build")
    return path


def _lib_path(name: str) -> str:
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(_BUILD_DIR, f"{name}-{digest[:12]}.so")


def build() -> float:
    """Compile every missing kernel library (one ``nvcc`` per source, all
    started together) and load them; returns the seconds spent."""
    t0 = time.perf_counter()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    procs = {}
    for name in _SOURCES:
        out = _lib_path(name)
        if name in _LIBS or os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
    for name in _SOURCES:
        if name not in _LIBS:
            _LIBS[name] = _bind(name, ctypes.CDLL(_lib_path(name)))
    return time.perf_counter() - t0


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    if name == "count_ge_edges":
        lib.tcdp_count_ge_edges.argtypes = [p, ll, p, p, p]
        lib.tcdp_count_ge_edges.restype = ctypes.c_int
    else:
        lib.tcdp_fused_sparsify.argtypes = [p, ll, p, p, p, p, p]
        lib.tcdp_fused_sparsify.restype = ctypes.c_int
    return lib


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build()
    return _LIBS[name]


def _check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def _check_f32_vector(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-D float32 tensor, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if x.numel() > _INT32_MAX:
        raise ValueError(f"{what} has {x.numel()} elements; int32 counts cap "
                         "the kernels at 2^31 - 1")


# ---------------------------------------------------------------------------
# count_ge_edges: the histogram rounds of the threshold search
# ---------------------------------------------------------------------------


def count_ge_edges_plain(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``counts[b] = #{x : edges[b] <= x < edges[16]}`` as int32[16]."""
    valid = x < edges[_HIST_BINS]
    return torch.stack([((x >= edges[b]) & valid).sum()
                        for b in range(_HIST_BINS)]).to(torch.int32)


def count_ge_edges(x: torch.Tensor, edges: torch.Tensor, *,
                   route: str = "count_ge") -> torch.Tensor:
    """Cumulative counts at 17 ascending edges (int32[16]).

    Replaces ``_count_ge_kernel`` (``route='count_ge'``, equispaced edges) and
    ``_count_edges_kernel`` (``route='count_edges'``, sample quantiles) of
    ``tpu_compressed_dp/ops/kernels.py``; ``route`` picks the launch counter.
    Bound: 4n bytes read per round (the 17 compares per element are far below
    the card's fp32 rate); see ``csrc/count_ge_edges.cu`` for the design."""
    if x.device.type == "cpu":
        return count_ge_edges_plain(x, edges)
    if x.device.type != "cuda":
        raise ValueError(f"count_ge_edges runs on CUDA or CPU tensors, got {x.device}")
    _check_f32_vector(x, "x")
    if (edges.dtype != torch.float32 or edges.shape != (_HIST_BINS + 1,)
            or not edges.is_contiguous() or edges.device != x.device):
        raise ValueError("edges must be a contiguous float32[17] tensor on x's device")
    counts = torch.zeros(_HIST_BINS, dtype=torch.int32, device=x.device)
    rc = _lib("count_ge_edges").tcdp_count_ge_edges(
        x.data_ptr(), x.numel(), edges.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(rc, "count_ge_edges")
    LAUNCHES[route] += 1
    return counts


# ---------------------------------------------------------------------------
# Top-K threshold select
# ---------------------------------------------------------------------------

_ARANGE: Dict[torch.device, torch.Tensor] = {}


def _bin_index(device: torch.device) -> torch.Tensor:
    if device not in _ARANGE:
        _ARANGE[device] = torch.arange(_HIST_BINS, dtype=torch.float32, device=device)
    return _ARANGE[device]


_RANKS: Dict[tuple, torch.Tensor] = {}


def _rank_index(ranks: tuple, device: torch.device) -> torch.Tensor:
    """Device copy of the quantile ranks, cached: a host-to-device copy per
    call would sync the host every step."""
    key = (ranks, device)
    if key not in _RANKS:
        _RANKS[key] = torch.tensor(ranks, dtype=torch.long, device=device)
    return _RANKS[key]


def _pick(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``v[i]`` for a 0-d index tensor, on the device (indexing with a 0-d
    tensor would fetch it to the host)."""
    return v.index_select(0, i.reshape(1)).reshape(())


def _narrow(lo, hi, above, counts, keep_f: float):
    """One refinement step (``narrow`` in ``_topk_threshold_pallas``): pick
    the bin holding the keep-th magnitude, in fp32 with the same op order so
    the new bounds are bitwise the edges the next round counts at."""
    total_ge = above + counts  # monotone nonincreasing over bins
    b = ((total_ge >= keep_f).sum() - 1).clamp(0, _HIST_BINS - 1)
    width = (hi - lo) / _HIST_BINS
    new_lo = lo + width * b.to(torch.float32)
    new_hi = torch.where(b == _HIST_BINS - 1, hi,
                         lo + width * (b + 1).to(torch.float32))
    counts_next = torch.cat([counts, counts.new_zeros(1)])
    new_above = above + torch.where(
        b == _HIST_BINS - 1, 0.0, _pick(counts_next, (b + 1).clamp(0, _HIST_BINS)))
    return new_lo, new_hi, new_above


def _count_round(mag, lo, hi, above, keep_f: float, count_fn):
    width = (hi - lo) / _HIST_BINS
    edges = torch.cat([lo + width * _bin_index(mag.device), hi.reshape(1)])
    counts = count_fn(mag, edges, route="count_ge").to(torch.float32)
    return _narrow(lo, hi, above, counts, keep_f)


def _sample_plan(n: int, keep: int) -> Optional[Tuple[int, int, int]]:
    """``(C, nb, m)`` of the sampled first round, or None where the search
    takes the full-range rounds (``kernels.py:309-341``): the first 128
    elements of every C-element block, m samples in all."""
    if keep < 1 or n < (1 << 18):
        return None
    m_target = int(min(max(1024 * n / keep, 1 << 16), 1 << 21))
    C = 128
    while C < (1 << 17) and n * 128 // (C * 2) >= m_target and C * 2 <= n:
        C *= 2
    nb = n // C
    m = nb * 128
    if m > n // 16:
        return None
    return C, nb, m


def _topk_threshold_hist(mag: torch.Tensor, keep: int, *, count_fn=None) -> torch.Tensor:
    """Port of ``_topk_threshold_pallas``: 16-bin histogram refinement, with
    a sampled-quantile first round for large tensors.  ``lo``, ``hi`` and
    ``above`` stay 0-d device tensors across rounds (no host sync).
    ``count_fn`` (default :func:`count_ge_edges`) lets a check run the same
    glue on the plain counts."""
    count_fn = count_fn or count_ge_edges
    n = mag.shape[0]
    keep = min(keep, n)
    mag = mag.to(torch.float32).contiguous()
    keep_f = float(min(keep, n))

    # max|g| strictly below hi so the top element lands in a bin; a
    # non-finite max is clamped so NaN/Inf cannot poison the bin edges
    hi_raw = mag.max() * 1.0000002 + 1e-30
    zero = torch.zeros((), dtype=torch.float32, device=mag.device)
    hi0 = torch.where(torch.isfinite(hi_raw), hi_raw, _FP32_MAX)
    plan = _sample_plan(n, keep)
    if plan is None:
        lo, hi, above = zero, hi0, zero
        for _ in range(_ROUNDS):
            lo, hi, above = _count_round(mag, lo, hi, above, keep_f, count_fn)
        return lo

    C, nb, m = plan
    sample = mag[: nb * C].reshape(nb, C)[:, :128].reshape(-1)
    r = keep * m / n
    delta = 4.0 * float(r) ** 0.5 + 8.0
    hi_rank = int(min(m - 1, r + delta))
    lo_rank = int(max(0, r - delta))
    sv = torch.topk(sample, hi_rank + 1).values
    # 15 interior quantile edges, ascending; a non-finite edge is clamped to
    # the top bracket (an empty top bin, like a duplicate edge)
    qranks = [int(round(lo_rank + (hi_rank - lo_rank) * i / 14.0)) for i in range(15)]
    interior = sv.index_select(0, _rank_index(tuple(reversed(qranks)), mag.device))
    interior = torch.where(torch.isfinite(interior), torch.minimum(interior, hi0), hi0)
    edges = torch.cat([zero.reshape(1), interior, hi0.reshape(1)])
    counts = count_fn(mag, edges, route="count_edges").to(torch.float32)
    b = ((counts >= keep_f).sum() - 1).clamp(0, _HIST_BINS - 1)
    lo = _pick(edges, b)
    hi = _pick(edges, b + 1)
    counts_ext = torch.cat([counts, counts.new_zeros(1)])
    above = _pick(counts_ext, (b + 1).clamp(0, _HIST_BINS))
    for _ in range(4):
        lo, hi, above = _count_round(mag, lo, hi, above, keep_f, count_fn)
    return lo


def _topk_threshold_scatter(mag: torch.Tensor, keep: int) -> torch.Tensor:
    """Port of ``_topk_threshold_jnp``: the histogram search as one
    bucketize + scatter-add pass per round, for tensors beyond the kernels'
    int32 counts.  fp32 counts, with the same conservative ``keep`` margin."""
    n = mag.shape[0]
    mag = mag.to(torch.float32)
    margin = 8.0 * n / float(1 << 23) if n > (1 << 23) else 0.0
    keep_f = float(torch.tensor(min(keep + margin, n), dtype=torch.float32))
    lo = torch.zeros((), dtype=torch.float32, device=mag.device)
    hi_raw = mag.max() * 1.0000002 + 1e-30
    hi = torch.where(torch.isfinite(hi_raw), hi_raw, _FP32_MAX)
    above = torch.zeros((), dtype=torch.float32, device=mag.device)
    for _ in range(_ROUNDS):
        width = (hi - lo) / _HIST_BINS
        idx = ((mag - lo) / width).to(torch.int32).clamp(0, _HIST_BINS - 1)
        valid = (mag >= lo) & (mag < hi)
        hist = torch.zeros(_HIST_BINS, dtype=torch.float32, device=mag.device).index_add_(
            0, torch.where(valid, idx, 0).long(), valid.to(torch.float32))
        counts = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
        lo, hi, above = _narrow(lo, hi, above, counts, keep_f)
    return lo


def topk_threshold(mag: torch.Tensor, keep: int) -> torch.Tensor:
    """Magnitude threshold keeping ``>= keep`` elements (ties included), as a
    0-d float32 tensor on ``mag``'s device.

    Exact (``torch.topk``) below the dispatch cutoff, on the CPU in ``auto``
    mode and everywhere in ``off`` mode; the histogram search on the CUDA
    kernel above it (or on its plain version under ``force`` on the CPU);
    the scatter-add search beyond int32 sizes.  Either way
    ``count(mag >= t) >= keep``, with surplus only from ties at the returned
    threshold's resolution."""
    n = mag.shape[0]
    if keep >= n:
        return torch.zeros((), dtype=torch.float32, device=mag.device)
    if _dispatch_to_kernel(n, mag.device):
        return _topk_threshold_hist(mag, keep)
    if n > _INT32_MAX:
        return _topk_threshold_scatter(mag, keep)
    # NaN sorts as largest under topk: demote it below every magnitude so
    # the threshold ranks the finite values (NaN still never travels)
    m32 = mag.to(torch.float32)
    m32 = torch.where(torch.isnan(m32), -1.0, m32)
    return torch.topk(m32, keep).values[-1]


# ---------------------------------------------------------------------------
# Fused sparsify (simulate-mode Top-K epilogue)
# ---------------------------------------------------------------------------


def fused_sparsify_plain(acc: torch.Tensor, t: torch.Tensor, want_ef: bool = True):
    """``(comp, new_ef | None, count)`` by separate where/subtract/count ops."""
    keep = acc.abs() >= t
    comp = torch.where(keep, acc, 0.0)
    new_ef = acc - comp if want_ef else None
    count = (keep & (acc != 0)).sum().to(torch.int32)
    return comp, new_ef, count.to(torch.float32)


def fused_sparsify(acc: torch.Tensor, t: torch.Tensor, *, want_ef: bool = True):
    """``(comp, new_ef | None, count)`` keeping coordinates ``|acc| >= t``
    in one pass; ``count`` (float32, 0-d) is the number of kept nonzeros.

    Replaces ``_fused_sparsify_kernel`` of ``tpu_compressed_dp/ops/kernels.py``.
    Bound: 12n bytes with EF, 8n without; see ``csrc/fused_sparsify.cu``."""
    if acc.device.type == "cpu":
        return fused_sparsify_plain(acc, t, want_ef)
    if acc.device.type != "cuda":
        raise ValueError(f"fused_sparsify runs on CUDA or CPU tensors, got {acc.device}")
    _check_f32_vector(acc, "acc")
    t = t.to(torch.float32).reshape(()).contiguous()
    if t.device != acc.device:
        raise ValueError("the threshold must lie on acc's device")
    comp = torch.empty_like(acc)
    new_ef = torch.empty_like(acc) if want_ef else None
    count = torch.zeros(1, dtype=torch.int32, device=acc.device)
    rc = _lib("fused_sparsify").tcdp_fused_sparsify(
        acc.data_ptr(), acc.numel(), t.data_ptr(), comp.data_ptr(),
        new_ef.data_ptr() if want_ef else None, count.data_ptr(),
        torch.cuda.current_stream(acc.device).cuda_stream)
    _check_launch(rc, "fused_sparsify")
    LAUNCHES["fused_sparsify"] += 1
    return comp, new_ef, count.reshape(()).to(torch.float32)


def use_fused_sparsify(n: int, device) -> bool:
    """Whether the fused epilogue serves an ``n``-element tensor on ``device``
    (int32 positions and counts cap it at 2^31 - 1 elements)."""
    return _dispatch_to_kernel(n, torch.device(device))
