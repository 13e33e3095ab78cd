"""Hand-written CUDA kernels for the compression hot path, and their glue.

PyTorch/H100 counterpart of the simulate-mode and wire-mode part of
:mod:`tpu_compressed_dp.ops.kernels`.  Every Pallas TPU kernel there has
a CUDA C++ kernel here (sources in ``tpu_compressed_dp_torch/csrc``, built
for ``sm_90a`` by ``nvcc`` on first use into ``build/torch_kernels/`` and
loaded with ``ctypes``):

  * ``count_ge_edges`` (``csrc/count_ge_edges.cu``) serves both
    ``_count_ge_kernel`` (an equispaced refinement round of the histogram
    threshold search) and ``_count_edges_kernel`` (its sampled-quantile first
    round): cumulative int32 counts at 17 edges read from device memory;
  * ``fused_sparsify`` (``csrc/fused_sparsify.cu``) replaces
    ``_fused_sparsify_kernel``: threshold, EF residual and nonzero-survivor
    count in one pass;
  * ``dither`` (``csrc/dither.cu``) replaces ``_uniform_kernel``
    (:func:`uniform`), ``_qsgd_kernel`` (:func:`qsgd_levels_kernel`) and
    ``_terngrad_kernel`` (:func:`terngrad_levels_kernel`).  The TPU's
    hardware PRNG becomes Philox4x32-10 keyed by a 64-bit seed, with element
    ``i`` taking word ``i % 4`` at counter ``i // 4``: the stream depends on
    ``(seed, i)`` only, and :func:`philox4x32_plain` gives the same bits;
  * ``select_pack`` (``csrc/select_pack.cu``) replaces
    ``_select_pack_kernel`` and its epilogue (:func:`fused_select_pack`):
    the wire payload of the index-carrying sparsifiers, the coordinates with
    ``|x| >= t`` in ascending order in exactly ``keep`` slots;
  * ``quant_pack`` (``csrc/quant_pack.cu``) replaces
    ``_terngrad_pack_kernel`` and ``_qsgd_pack_kernel``
    (:func:`terngrad_pack`, :func:`terngrad_pack_prescaled`,
    :func:`qsgd_pack`): the dither kernels' levels, bit-packed to the wire
    bytes in the same pass;
  * ``bucket_route`` (``csrc/bucket_route.cu``) replaces
    ``_bucket_route_kernel`` (:func:`fused_bucket_route`): the sharded
    transport's per-destination buckets as windowed copies of the ascending
    payload;
  * ``threshold_pack`` (``csrc/threshold_pack.cu``) replaces
    ``_pack_kernel`` (:func:`pack_by_threshold`, the block-granular payload)
    and ``_seg_pack_kernel`` (:func:`seg_pack_by_threshold`, the per-segment
    capped payload of the gated segmented wire Top-K path);
  * ``byte_pack`` (``csrc/byte_pack.cu``) replaces ``_pack2b_kernel`` and
    ``_qsgd_pack_levels_kernel`` (:func:`pack_ternary_bytes`,
    :func:`qsgd_pack_bytes`): given levels to the wire bytes.

The causal flash-attention kernels (``csrc/flash_attention.cu``) are built
and loaded here with the others; their wrappers live in
:mod:`tpu_compressed_dp_torch.ops.flash_attention`.

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
    "uniform",
    "uniform_plain",
    "philox4x32_plain",
    "qsgd_levels_kernel",
    "qsgd_levels_plain",
    "terngrad_levels_kernel",
    "terngrad_levels_plain",
    "qsgd_quantize",
    "terngrad_quantize",
    "terngrad_quantize_prescaled",
    "use_quant_kernels",
    "fused_select_pack",
    "fused_select_pack_plain",
    "first_set_indices",
    "use_select_pack",
    "terngrad_pack",
    "terngrad_pack_prescaled",
    "terngrad_pack_kernel",
    "terngrad_pack_plain",
    "qsgd_pack",
    "qsgd_pack_kernel",
    "qsgd_pack_plain",
    "use_quant_pack",
    "fused_bucket_route",
    "fused_bucket_route_plain",
    "route_starts",
    "use_bucket_route",
    "pack_payload_slots",
    "pack_by_threshold",
    "pack_by_threshold_plain",
    "seg_pack_slots",
    "seg_pack_by_threshold",
    "seg_pack_by_threshold_plain",
    "seg_pack_payload",
    "use_seg_pack",
    "pack_ternary_bytes",
    "pack_ternary_bytes_plain",
    "qsgd_pack_bytes",
    "qsgd_pack_bytes_plain",
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
LAUNCHES: Dict[str, int] = {"count_ge": 0, "count_edges": 0, "fused_sparsify": 0,
                            "uniform": 0, "qsgd": 0, "terngrad": 0, "select_pack": 0,
                            "terngrad_pack": 0, "qsgd_pack": 0, "bucket_route": 0,
                            "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                            "threshold_pack": 0, "seg_pack": 0, "ternary_bytes": 0,
                            "qsgd_bytes": 0}


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
_SOURCES = ("count_ge_edges", "fused_sparsify", "dither", "select_pack", "quant_pack",
            "bucket_route", "flash_attention", "threshold_pack", "byte_pack")
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
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    # the source and every shared header it may include
    for fname in [f"{name}.cu"] + sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh")):
        with open(os.path.join(_CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


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
    p, ll, u64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_int
    f32 = ctypes.c_float
    argtypes = {
        "count_ge_edges": {"tcdp_count_ge_edges": [p, ll, p, p, p]},
        "fused_sparsify": {"tcdp_fused_sparsify": [p, ll, p, p, p, p, p]},
        "dither": {"tcdp_uniform": [p, ll, u64, p],
                   "tcdp_qsgd_levels": [p, ll, p, u64, i32, p, p],
                   "tcdp_terngrad_levels": [p, ll, p, u64, p, p]},
        "select_pack": {"tcdp_select_pack": [p, ll, p, i32, p, p, p, p, p, p]},
        "quant_pack": {"tcdp_terngrad_pack": [p, ll, p, u64, p, p],
                       "tcdp_qsgd_pack": [p, ll, p, u64, i32, p, p, p]},
        "bucket_route": {"tcdp_bucket_route": [p, p, p, i32, i32, i32, p, p, p]},
        "flash_attention": {
            "tcdp_flash_fwd": [p, p, p, p, p, i32, i32, i32, i32, f32, p],
            "tcdp_flash_dq": [p, p, p, p, p, p, p, i32, i32, i32, i32, f32, p],
            "tcdp_flash_dkv": [p, p, p, p, p, p, p, p, i32, i32, i32, i32, f32, p]},
        "threshold_pack": {"tcdp_threshold_pack": [p, ll, p, i32, i32, p, p, p, p, p, p, p],
                           "tcdp_seg_pack": [p, ll, p, i32, i32, p, p, p, p, p, p, p]},
        "byte_pack": {"tcdp_pack_ternary_bytes": [p, ll, p, p],
                      "tcdp_qsgd_pack_bytes": [p, ll, p, p, p]},
    }[name]
    for fn, types in argtypes.items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = ctypes.c_int
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


# ---------------------------------------------------------------------------
# Philox uniforms and the dither quantizers
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _seed64(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed < (1 << 64):
        raise ValueError(f"seed must be an unsigned 64-bit integer, got {seed}")
    return seed


def _mulhilo(a: torch.Tensor, m: int):
    """``(hi, lo)`` 32-bit halves of ``a * m`` for uint32 values held in int64
    ``a``, multiplied in 16-bit pieces so that no partial product leaves
    int64 (``m * 2^32`` alone would)."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll, lh, hl = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = a_hi * m_hi + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_plain(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 (Random123's ``philox4x32``) on int64 tensors holding
    uint32 counter words, keyed by the 64-bit ``seed``; returns the four
    output words, as ``csrc/philox.cuh`` computes them."""
    seed = _seed64(seed)
    k0, k1 = seed & _M32, seed >> 32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_plain(seed: int, n: int, device="cpu") -> torch.Tensor:
    """The uniform kernel's draws by PyTorch ops: element ``i`` is word
    ``i % 4`` of Philox at counter ``i // 4``, its 24 high bits times 2^-24."""
    j = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(j)
    words = torch.stack(philox4x32_plain(j & _M32, j >> 32, zero, zero, seed), dim=1)
    return (words.reshape(-1)[:n] >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform(seed: int, n: int, device) -> torch.Tensor:
    """``n`` float32 uniforms in [0, 1) at 24-bit resolution, a function of
    ``(seed, index)`` only: every rank given the same seed draws the same
    values (the shared-mask premise of Random-K).

    Replaces ``_uniform_kernel``/``_uniform_pallas`` of
    ``tpu_compressed_dp/ops/kernels.py``, whose TPU stream (reseeded per
    block with ``seed + program_id``) cannot be reproduced here.  On a CUDA
    device the kernel serves every size.  Bound: 4n bytes written (the 15
    integer operations per element of Philox take less at the card's issue
    rate); see ``csrc/dither.cu``."""
    device = torch.device(device)
    seed = _seed64(seed)
    if device.type == "cpu":
        return uniform_plain(seed, n, device)
    if device.type != "cuda":
        raise ValueError(f"uniform runs on CUDA or CPU devices, got {device}")
    out = torch.empty(n, dtype=torch.float32, device=device)
    if n == 0:
        return out
    rc = _lib("dither").tcdp_uniform(out.data_ptr(), n, seed,
                                     torch.cuda.current_stream(device).cuda_stream)
    _check_launch(rc, "uniform")
    LAUNCHES["uniform"] += 1
    return out


def _select_sign(x: torch.Tensor) -> torch.Tensor:
    """``(x > 0) - (x < 0)`` in float32: the TPU kernels' ``_sign``; NaN -> 0."""
    return (x > 0).to(torch.float32) - (x < 0).to(torch.float32)


def _to_int(f: torch.Tensor, dtype) -> torch.Tensor:
    """Float to ``dtype`` as XLA converts: saturating, NaN -> 0."""
    info = torch.iinfo(dtype)
    return torch.where(torch.isnan(f), 0.0, f).clamp(info.min, info.max).to(dtype)


def qsgd_levels_plain(x: torch.Tensor, inv: torch.Tensor, seed: int, qstates: int,
                      u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int16 ``sign(x) * floor((|x| * inv) * s + u)`` by separate PyTorch ops;
    ``u`` defaults to :func:`uniform_plain` of ``seed`` (a test may inject
    its own draws)."""
    if u is None:
        u = uniform_plain(seed, x.shape[0], x.device)
    m = torch.floor(x.abs() * inv * float(qstates) + u)
    return _to_int(_select_sign(x) * m, torch.int16)


def terngrad_levels_plain(x: torch.Tensor, inv: torch.Tensor, seed: int,
                          u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 ``sign(x) * (u < |x| * inv)`` by separate PyTorch ops."""
    if u is None:
        u = uniform_plain(seed, x.shape[0], x.device)
    keep = (u < x.abs() * inv).to(torch.float32)
    return _to_int(_select_sign(x) * keep, torch.int8)


def _launch_quant(route: str, x: torch.Tensor, inv: torch.Tensor, seed: int, dtype,
                  *extra) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the {route} kernel runs on CUDA or CPU tensors, got {x.device}")
    _check_f32_vector(x, "x")
    inv = inv.to(torch.float32).reshape(()).contiguous()
    if inv.device != x.device:
        raise ValueError("inv must lie on x's device")
    out = torch.empty(x.shape[0], dtype=dtype, device=x.device)
    if x.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _lib("dither")
    if route == "qsgd":
        rc = lib.tcdp_qsgd_levels(x.data_ptr(), x.numel(), inv.data_ptr(), _seed64(seed),
                                  *extra, out.data_ptr(), stream)
    else:
        rc = lib.tcdp_terngrad_levels(x.data_ptr(), x.numel(), inv.data_ptr(),
                                      _seed64(seed), out.data_ptr(), stream)
    _check_launch(rc, route)
    LAUNCHES[route] += 1
    return out


def qsgd_levels_kernel(x: torch.Tensor, inv: torch.Tensor, seed: int,
                       qstates: int) -> torch.Tensor:
    """int16 QSGD levels ``sign(x) * floor((|x| * inv) * s + u)`` with the
    dither ``u`` drawn inside the kernel from the Philox stream of ``seed``.

    Replaces ``_qsgd_kernel`` of ``tpu_compressed_dp/ops/kernels.py``.
    Bound: 6n bytes (read 4n, write 2n) and the Philox integer work."""
    if not 0 < qstates < (1 << 24):
        raise ValueError(f"qstates must be in [1, 2^24), got {qstates}")
    if x.device.type == "cpu":
        return qsgd_levels_plain(x, inv, seed, qstates)
    return _launch_quant("qsgd", x, inv, seed, torch.int16, qstates)


def terngrad_levels_kernel(x: torch.Tensor, inv: torch.Tensor, seed: int) -> torch.Tensor:
    """int8 TernGrad levels ``sign(x) * (u < |x| * inv)``, dither drawn in
    the kernel.  Replaces ``_terngrad_kernel``.  Bound: 5n bytes and the
    Philox integer work."""
    if x.device.type == "cpu":
        return terngrad_levels_plain(x, inv, seed)
    return _launch_quant("terngrad", x, inv, seed, torch.int8)


def _safe_inv(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > 0, 1.0 / torch.where(v > 0, v, 1.0), 0.0)


def qsgd_quantize(flat: torch.Tensor, seed: int, *, qstates: int = 255):
    """``(int16 levels in [-s, s], float32 scale)`` with ``scale =
    ||g|| / s`` (0 for a zero vector), as ``qsgd_quantize`` of the JAX
    package; the norm is a plain reduction outside the kernel."""
    flat = flat.to(torch.float32).contiguous()
    norm = torch.linalg.vector_norm(flat)
    levels = qsgd_levels_kernel(flat, _safe_inv(norm), seed, qstates)
    return levels, torch.where(norm > 0, norm, 0.0) / qstates


def terngrad_quantize(flat: torch.Tensor, seed: int):
    """``(int8 levels in {-1, 0, 1}, float32 scale = max|g|)``."""
    flat = flat.to(torch.float32).contiguous()
    gmax = flat.abs().max()
    return terngrad_levels_kernel(flat, _safe_inv(gmax), seed), gmax


def terngrad_quantize_prescaled(scaled: torch.Tensor, seed: int) -> torch.Tensor:
    """TernGrad levels of an already chunk-normalised input (unit scale)."""
    scaled = scaled.to(torch.float32).contiguous()
    one = torch.ones((), dtype=torch.float32, device=scaled.device)
    return terngrad_levels_kernel(scaled, one, seed)


def use_quant_kernels(n: int, device) -> bool:
    """Whether the dither kernels serve an ``n``-element tensor on ``device``
    (the JAX package's ``use_quant_kernels``)."""
    return _dispatch_to_kernel(n, torch.device(device))


# ---------------------------------------------------------------------------
# Fused select+pack (the wire payload of the index-carrying sparsifiers)
# ---------------------------------------------------------------------------

_SEG = 4096  # elements per segment of csrc/select_pack.cu


def first_set_indices(mask: torch.Tensor, keep: int) -> torch.Tensor:
    """int32 ascending indices of the first ``keep`` set positions of
    ``mask``, ranks past its count 0: rank ``r`` lands at the first position
    whose inclusive count reaches ``r`` (one cumsum and one
    ``searchsorted``, on the device)."""
    pos = torch.cumsum(mask, 0, dtype=torch.int64)
    ranks = torch.arange(1, keep + 1, dtype=torch.int64, device=mask.device)
    idx = torch.searchsorted(pos, ranks)
    return torch.where(idx < mask.shape[0], idx, 0).to(torch.int32)


def fused_select_pack_plain(flat: torch.Tensor, t: torch.Tensor, keep: int):
    """``(vals [keep], idx [keep] int32, count int32)`` by PyTorch ops: the
    coordinates with ``|flat| >= t`` (fp32 compare) in ascending order,
    slots past the survivor count padded with value 0 / index 0."""
    mask = flat.abs().to(torch.float32) >= t
    count = mask.sum(dtype=torch.int32)
    idx = first_set_indices(mask, keep)
    valid = torch.arange(keep, device=flat.device) < count
    vals = torch.where(valid, flat[idx.long()], torch.zeros((), dtype=flat.dtype,
                                                            device=flat.device))
    return vals, idx, count


def fused_select_pack(flat: torch.Tensor, t: torch.Tensor, keep: int):
    """``(vals [keep], idx [keep] int32, count int32 0-d)``: the coordinates
    with ``|flat| >= t`` by ascending index, their values, and the total
    survivor count; an underfull mask pads value 0 / index 0.

    Replaces ``_select_pack_kernel`` + ``_select_pack_payload``
    (``fused_select_pack``) of ``tpu_compressed_dp/ops/kernels.py``.  Bitwise
    equal to ``mask -> packed_indices_from_mask -> gather`` whenever
    ``count >= keep``.  Bound: 4n bytes read, 8 keep written; see
    ``csrc/select_pack.cu``."""
    keep = int(keep)
    if keep < 1:
        raise ValueError(f"fused_select_pack needs keep >= 1, got {keep}")
    if flat.device.type == "cpu":
        return fused_select_pack_plain(flat, t, keep)
    if flat.device.type != "cuda":
        raise ValueError(f"fused_select_pack runs on CUDA or CPU tensors, got {flat.device}")
    _check_f32_vector(flat, "flat")
    t = t.to(torch.float32).reshape(()).contiguous()
    if t.device != flat.device:
        raise ValueError("the threshold must lie on flat's device")
    n = flat.numel()
    dev = flat.device
    vals = torch.empty(keep, dtype=torch.float32, device=dev)
    idx = torch.empty(keep, dtype=torch.int32, device=dev)
    if n == 0:
        return vals.zero_(), idx.zero_(), torch.zeros((), dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(2, -(-n // _SEG), dtype=torch.int32, device=dev)
    rc = _lib("select_pack").tcdp_select_pack(
        flat.data_ptr(), n, t.data_ptr(), keep, vals.data_ptr(), idx.data_ptr(),
        count.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(rc, "select_pack")
    LAUNCHES["select_pack"] += 1
    return vals, idx, count.reshape(())


def use_select_pack(n: int, keep: int, device) -> bool:
    """Whether the fused select+pack serves an ``n``-element tensor on
    ``device`` (the JAX package's ``use_select_pack``)."""
    return _dispatch_to_kernel(n, torch.device(device)) and keep >= 1


# ---------------------------------------------------------------------------
# Threshold pack (block-granular payload) and segmented pack
# ---------------------------------------------------------------------------

_LANES = 128
_PACK_ROWS = 512          # rows of 128 per block of the threshold pack
_SEG_CAP = _LANES         # payload slots per segment of the segmented pack
_SEG_BLOCK = 16 * _SEG    # the segmented layout pads n to whole 16-segment blocks
_SEG_PACK_DISPATCH = False


def _check_threshold(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    t = t.to(torch.float32).reshape(()).contiguous()
    if t.device != x.device:
        raise ValueError("the threshold must lie on acc's device")
    return t


def _padded_mask(acc: torch.Tensor, t: torch.Tensor, size: int) -> torch.Tensor:
    """``|acc| >= t`` (fp32 compare; NaN never survives), padded with False
    to ``size``."""
    m = acc.abs() >= t
    return torch.cat([m, m.new_zeros(size - m.shape[0])])


def pack_payload_slots(n: int, keep: int, rows: Optional[int] = None) -> int:
    """Slots ``P`` of :func:`pack_by_threshold`'s payload: ``keep`` rounded
    up to whole rows of 128, plus one row per block of ``rows x 128``
    elements (each block's base is row-aligned)."""
    rows = _PACK_ROWS if rows is None else int(rows)
    blocks = -(-max(n, 1) // (rows * _LANES))
    return -(-keep // _LANES) * _LANES + blocks * _LANES


def pack_by_threshold_plain(acc: torch.Tensor, t: torch.Tensor, keep: int, *,
                            want_ef: bool = True, rows: Optional[int] = None):
    """The threshold pack's layout by PyTorch ops (see :func:`pack_by_threshold`)."""
    rows = _PACK_ROWS if rows is None else int(rows)
    n, dev = acc.shape[0], acc.device
    blk = rows * _LANES
    nb = -(-max(n, 1) // blk)
    cap_rows = pack_payload_slots(n, keep, rows) // _LANES
    mask = _padded_mask(acc, t, nb * blk).reshape(nb, blk)
    blk_count = mask.sum(1)
    rows_used = (blk_count + _LANES - 1) // _LANES
    base = torch.cumsum(rows_used, 0) - rows_used
    shipped = base + rows_used <= cap_rows
    sel = (mask & shipped[:, None]).reshape(-1)[:n]
    # a survivor's slot: its block's base row, then its rank in the block
    slot = (base[:, None] * _LANES + torch.cumsum(mask, 1) - 1).reshape(-1)[:n]
    dest = torch.where(sel, slot, cap_rows * _LANES)     # the last slot is a dump
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    P = cap_rows * _LANES
    vals = torch.zeros(P + 1, dtype=torch.float32, device=dev).index_copy_(0, dest, acc)
    idx = torch.zeros(P + 1, dtype=torch.int32, device=dev).index_copy_(0, dest, pos)
    count = torch.where(shipped, blk_count, 0).sum().to(torch.int32)
    new_ef = torch.where(sel, 0.0, acc) if want_ef else None
    return vals[:P].clone(), idx[:P].clone(), new_ef, count


def pack_by_threshold(acc: torch.Tensor, t: torch.Tensor, keep: int, *, want_ef: bool = True,
                      rows: Optional[int] = None):
    """``(vals [P], idx [P] int32, new_ef [n] | None, count int32 0-d)`` with
    ``P = pack_payload_slots(n, keep, rows)``: the coordinates with ``|acc| >=
    t`` in ascending order inside each block of ``rows x 128`` elements, each
    block's survivors from its base row on, the bases advancing by the rows
    each block uses; a block ships only if it fits whole below ``P``, and
    from the first that does not, none does.  Unshipped survivors stay in
    the EF residual (shipped ones read ``+0.0`` there), ``count`` is the
    number shipped, and every other slot holds 0 / index 0.

    Replaces ``_pack_kernel`` / ``pack_by_threshold`` of
    ``tpu_compressed_dp/ops/kernels.py`` (``rows`` is its ``_PACK_ROWS``,
    512).  The Pallas kernel assembles the payload with one-hot sums and
    matmuls, so on NaN / Inf data and ``-0.0`` survivors its values differ
    from a copy; this kernel and its plain version copy the bits.  Not
    dispatched by any wire path, as in the reference.  Bound: 4n read, 4n EF
    and 8P written; see ``csrc/threshold_pack.cu``."""
    rows = _PACK_ROWS if rows is None else int(rows)
    if keep < 1 or rows < 1:
        raise ValueError(f"pack_by_threshold needs keep >= 1 and rows >= 1, got {keep}, {rows}")
    if acc.device.type == "cpu":
        return pack_by_threshold_plain(acc, t, keep, want_ef=want_ef, rows=rows)
    if acc.device.type != "cuda":
        raise ValueError(f"pack_by_threshold runs on CUDA or CPU tensors, got {acc.device}")
    _check_f32_vector(acc, "acc")
    t = _check_threshold(t, acc)
    n, dev = acc.numel(), acc.device
    P = pack_payload_slots(n, keep, rows)
    nb = -(-max(n, 1) // (rows * _LANES))
    vals = torch.empty(P, dtype=torch.float32, device=dev)
    idx = torch.empty(P, dtype=torch.int32, device=dev)
    new_ef = torch.empty_like(acc) if want_ef else None
    meta = torch.empty(3, dtype=torch.int32, device=dev)
    scratch = torch.empty(2, nb, dtype=torch.int32, device=dev)
    rc = _lib("threshold_pack").tcdp_threshold_pack(
        acc.data_ptr(), n, t.data_ptr(), rows, P // _LANES, vals.data_ptr(), idx.data_ptr(),
        new_ef.data_ptr() if want_ef else None, meta.data_ptr(), scratch[0].data_ptr(),
        scratch[1].data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(rc, "threshold_pack")
    LAUNCHES["threshold_pack"] += 1
    return vals, idx, new_ef, meta[0]


def seg_pack_slots(n: int) -> int:
    """Payload capacity of the segmented layout: 128 slots per segment."""
    return -(-n // _SEG) * _SEG_CAP


def seg_pack_by_threshold_plain(acc: torch.Tensor, t: torch.Tensor, keep: int, *,
                                want_ef: bool = True):
    """The segmented pack by PyTorch ops (see :func:`seg_pack_by_threshold`)."""
    n, dev = acc.shape[0], acc.device
    nseg = -(-n // _SEG_BLOCK) * (_SEG_BLOCK // _SEG)
    mask = _padded_mask(acc, t, nseg * _SEG).reshape(nseg, _SEG)
    counts = mask.sum(1, dtype=torch.int32)
    elig = torch.clamp(counts, max=_SEG_CAP)
    starts = torch.cumsum(elig, 0, dtype=torch.int32) - elig
    rank = torch.cumsum(mask, 1, dtype=torch.int32)          # 1-based at survivors
    eligible = mask & (rank <= _SEG_CAP)
    seg = torch.arange(nseg, dtype=torch.int64, device=dev)[:, None]
    dump = nseg * _SEG_CAP
    dest = torch.where(eligible, seg * _SEG_CAP + rank - 1, dump).reshape(-1)[:n]
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    vals = torch.zeros(dump + 1, dtype=torch.float32, device=dev).index_copy_(0, dest, acc)
    idx = torch.zeros(dump + 1, dtype=torch.int32, device=dev).index_copy_(0, dest, pos)
    new_ef = None
    if want_ef:
        sent = (eligible & (starts[:, None] + rank <= keep)).reshape(-1)[:n]
        new_ef = torch.where(sent, 0.0, acc)
    return (vals[:dump].reshape(nseg, _SEG_CAP), idx[:dump].reshape(nseg, _SEG_CAP), new_ef,
            elig, counts)


def seg_pack_by_threshold(acc: torch.Tensor, t: torch.Tensor, keep: int, *,
                          want_ef: bool = True):
    """``(vals [nseg, 128], idx [nseg, 128] int32, new_ef [n] | None, elig
    [nseg] int32, counts [nseg] int32)``: per 4096-element segment, the first
    ``<= 128`` coordinates with ``|acc| >= t`` left-compacted with their
    global indices (live slots past the segment's count hold 0 / 0);
    ``counts`` the segment's survivors, ``elig = min(counts, 128)``.  The EF
    residual zeroes (``+0.0``) exactly the survivors that travel: ranked
    within the cap, and within ``keep`` counting the segments before.
    ``nseg`` is padded to whole 65,536-element blocks, as in the reference.

    Replaces ``_seg_pack_kernel`` / ``seg_pack_by_threshold`` of
    ``tpu_compressed_dp/ops/kernels.py``; the counts, the eligible prefix
    and the pack are three launches of ``csrc/threshold_pack.cu``.  Bound:
    4n read, 4n EF and 8 * 128 * nseg written."""
    if acc.device.type == "cpu":
        return seg_pack_by_threshold_plain(acc, t, keep, want_ef=want_ef)
    if acc.device.type != "cuda":
        raise ValueError(f"seg_pack_by_threshold runs on CUDA or CPU tensors, got {acc.device}")
    _check_f32_vector(acc, "acc")
    t = _check_threshold(t, acc)
    n, dev = acc.numel(), acc.device
    nseg = -(-n // _SEG_BLOCK) * (_SEG_BLOCK // _SEG)
    vals = torch.empty(nseg, _SEG_CAP, dtype=torch.float32, device=dev)
    idx = torch.empty(nseg, _SEG_CAP, dtype=torch.int32, device=dev)
    new_ef = torch.empty_like(acc) if want_ef else None
    seg = torch.empty(3, nseg, dtype=torch.int32, device=dev)   # counts, elig, starts
    if nseg:
        rc = _lib("threshold_pack").tcdp_seg_pack(
            acc.data_ptr(), n, t.data_ptr(), int(min(keep, _INT32_MAX)), nseg, vals.data_ptr(),
            idx.data_ptr(), new_ef.data_ptr() if want_ef else None, seg[0].data_ptr(),
            seg[1].data_ptr(), seg[2].data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _check_launch(rc, "seg_pack")
        LAUNCHES["seg_pack"] += 1
    return vals, idx, new_ef, seg[1], seg[0]


def seg_pack_payload(vals: torch.Tensor, idx: torch.Tensor, elig: torch.Tensor, keep: int):
    """The exact ``keep``-slot wire payload from the segmented pack: slot
    ``j`` holds eligible survivor ``j + 1`` in ascending global order (each
    rank's segment found by a histogram of the segment ends and a cumsum, as
    ``seg_pack_payload`` of the JAX package does); slots past the eligible
    total hold 0 / 0.  PyTorch ops on the device, no host sync."""
    nseg, dev = vals.shape[0], vals.device
    ends = torch.cumsum(elig, 0, dtype=torch.int32)                  # inclusive
    ranks = torch.arange(1, keep + 1, dtype=torch.int32, device=dev)
    hist = torch.zeros(keep + 1, dtype=torch.int32, device=dev).index_add_(
        0, torch.clamp(ends, max=keep).long(), torch.ones_like(ends))
    seg_of = torch.cumsum(hist, 0, dtype=torch.int32)[:keep]
    valid = seg_of < nseg
    seg_of = torch.where(valid, seg_of, 0).long()
    within = ranks - (ends.index_select(0, seg_of) - elig.index_select(0, seg_of)) - 1
    flat_pos = torch.where(valid, seg_of * _SEG_CAP + within, 0)
    pvals = torch.where(valid, vals.reshape(-1).index_select(0, flat_pos), 0.0)
    pidx = torch.where(valid, idx.reshape(-1).index_select(0, flat_pos), 0)
    return pvals, pidx


def use_seg_pack(n: int, keep: int, device) -> bool:
    """Whether wire Top-K takes the segmented pack (the JAX package's
    ``use_seg_pack``): off unless ``_SEG_PACK_DISPATCH`` is set, as there
    (its round-4 result was a tie with the unfused chain, and a segment's
    128-slot cap cuts the sent fraction on concentrated gradients); then a
    kernel-dispatched size, int32-indexable, and ``keep`` at most half the
    cap's density (128 / 4096)."""
    return (_SEG_PACK_DISPATCH and _dispatch_to_kernel(n, torch.device(device))
            and n <= _INT32_MAX and keep * 2 * _SEG <= n * _SEG_CAP)


# ---------------------------------------------------------------------------
# Byte layouts of the wire (TernGrad 2-bit codes, QSGD magnitudes + sign
# bitmap), by PyTorch ops: the plain versions of the packing kernels
# ---------------------------------------------------------------------------


def _pack_codes(codes: torch.Tensor, per: int) -> torch.Tensor:
    """uint8 bytes of small int32 ``codes``, ``per`` to a byte, element ``i``
    at bits ``(8 // per) * (i % per)``."""
    shifts = torch.arange(0, 8, 8 // per, dtype=torch.int32, device=codes.device)
    return (codes.reshape(-1, per) << shifts).sum(dim=1).to(torch.uint8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """A boolean vector eight to a byte, little-endian within the byte."""
    n = bits.shape[0]
    return _pack_codes(torch.nn.functional.pad(bits.to(torch.int32), (0, (-n) % 8)), 8)


def pack_ternary_bytes_plain(levels: torch.Tensor) -> torch.Tensor:
    """Ternary levels (int8 in {-1, 0, 1}) as 2-bit codes ``level + 1``, four
    to a byte, element ``i`` at bits ``2 * (i % 4)``: ``uint8[ceil(n/4)]``; a
    padded tail packs as code 1 (level 0)."""
    n = levels.shape[0]
    return _pack_codes(torch.nn.functional.pad(levels.to(torch.int32), (0, (-n) % 4)) + 1, 4)


def qsgd_pack_bytes_plain(levels: torch.Tensor):
    """``(uint8 |level| [n], uint8 sign bitmap [ceil(n/8)])`` of int16 levels,
    ``|level|`` taken in int32 and cut to 8 bits."""
    return levels.to(torch.int32).abs().to(torch.uint8), pack_bits(levels < 0)


# ---------------------------------------------------------------------------
# Fused quantize+pack (TernGrad 2-bit codes, QSGD magnitudes + sign bitmap)
# ---------------------------------------------------------------------------


def terngrad_pack_plain(x: torch.Tensor, inv: torch.Tensor, seed: int,
                        u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 ``[ceil(n/4)]``: :func:`terngrad_levels_plain` through
    :func:`pack_ternary_bytes_plain` (codes ``level + 1``, four to a byte)."""
    return pack_ternary_bytes_plain(terngrad_levels_plain(x, inv, seed, u))


def qsgd_pack_plain(x: torch.Tensor, inv: torch.Tensor, seed: int, qstates: int,
                    u: Optional[torch.Tensor] = None):
    """``(uint8 mags [n], uint8 signs [ceil(n/8)])``: :func:`qsgd_levels_plain`
    through :func:`qsgd_pack_bytes_plain`, the wire's ``qstates <= 255``
    layout."""
    return qsgd_pack_bytes_plain(qsgd_levels_plain(x, inv, seed, qstates, u))


def _launch_pack(route: str, x: torch.Tensor, inv: torch.Tensor, seed: int, *outs, qstates=None):
    if x.device.type != "cuda":
        raise ValueError(f"the {route} kernel runs on CUDA or CPU tensors, got {x.device}")
    _check_f32_vector(x, "x")
    inv = inv.to(torch.float32).reshape(()).contiguous()
    if inv.device != x.device:
        raise ValueError("inv must lie on x's device")
    if x.numel() == 0:
        return
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _lib("quant_pack")
    ptrs = [o.data_ptr() for o in outs]
    if route == "qsgd_pack":
        rc = lib.tcdp_qsgd_pack(x.data_ptr(), x.numel(), inv.data_ptr(), _seed64(seed),
                                qstates, *ptrs, stream)
    else:
        rc = lib.tcdp_terngrad_pack(x.data_ptr(), x.numel(), inv.data_ptr(), _seed64(seed),
                                    *ptrs, stream)
    _check_launch(rc, route)
    LAUNCHES[route] += 1


def terngrad_pack_kernel(x: torch.Tensor, inv: torch.Tensor, seed: int) -> torch.Tensor:
    """uint8 ``[ceil(n/4)]``: the TernGrad levels ``sign(x) * (u < |x| *
    inv)`` of :func:`terngrad_levels_kernel`, packed to 2-bit codes in the
    same pass.  Replaces ``_terngrad_pack_kernel``.  Bound: 4.25n bytes."""
    if x.device.type == "cpu":
        return terngrad_pack_plain(x, inv, seed)
    out = torch.empty(-(-x.shape[0] // 4), dtype=torch.uint8, device=x.device)
    _launch_pack("terngrad_pack", x, inv, seed, out)
    return out


def qsgd_pack_kernel(x: torch.Tensor, inv: torch.Tensor, seed: int, qstates: int):
    """``(uint8 mags [n], uint8 signs [ceil(n/8)])``: the QSGD levels of
    :func:`qsgd_levels_kernel` in the ``qstates <= 255`` wire layout, packed
    in the same pass.  Replaces ``_qsgd_pack_kernel``.  Bound: 5.125n
    bytes."""
    if not 0 < qstates <= 255:
        raise ValueError(f"qsgd_pack packs uint8 magnitudes; qstates={qstates}")
    if x.device.type == "cpu":
        return qsgd_pack_plain(x, inv, seed, qstates)
    mags = torch.empty(x.shape[0], dtype=torch.uint8, device=x.device)
    signs = torch.empty(-(-x.shape[0] // 8), dtype=torch.uint8, device=x.device)
    _launch_pack("qsgd_pack", x, inv, seed, mags, signs, qstates=qstates)
    return mags, signs


def terngrad_pack(flat: torch.Tensor, seed: int):
    """``(uint8 wire bytes [ceil(n/4)], float32 scale = max|g|)``: the
    JAX package's ``terngrad_pack``, dither drawn from ``seed``."""
    flat = flat.to(torch.float32).contiguous()
    gmax = flat.abs().max()
    return terngrad_pack_kernel(flat, _safe_inv(gmax), seed), gmax


def terngrad_pack_prescaled(scaled: torch.Tensor, seed: int) -> torch.Tensor:
    """Quantize+pack of an already chunk-normalised input (unit scale)."""
    scaled = scaled.to(torch.float32).contiguous()
    one = torch.ones((), dtype=torch.float32, device=scaled.device)
    return terngrad_pack_kernel(scaled, one, seed)


def qsgd_pack(flat: torch.Tensor, seed: int, *, qstates: int = 255):
    """``(uint8 mags [n], uint8 signs [ceil(n/8)], float32 scale = ||g|| /
    s)`` for ``0 < qstates <= 255``, as the JAX package's ``qsgd_pack``."""
    flat = flat.to(torch.float32).contiguous()
    norm = torch.linalg.vector_norm(flat)
    mags, signs = qsgd_pack_kernel(flat, _safe_inv(norm), seed, qstates)
    return mags, signs, torch.where(norm > 0, norm, 0.0) / qstates


def use_quant_pack(n: int, device) -> bool:
    """Whether the quantize+pack kernels serve an ``n``-element tensor on
    ``device`` (the JAX package's ``use_quant_pack``)."""
    return _dispatch_to_kernel(n, torch.device(device))


# ---------------------------------------------------------------------------
# Byte packers of given levels
# ---------------------------------------------------------------------------


def _check_levels(levels: torch.Tensor, dtype, what: str) -> None:
    if levels.dtype != dtype or levels.dim() != 1 or not levels.is_contiguous():
        raise ValueError(f"{what} packs a contiguous 1-D {dtype} tensor, got {levels.dtype} "
                         f"of shape {tuple(levels.shape)}")


def pack_ternary_bytes(levels: torch.Tensor) -> torch.Tensor:
    """``uint8[ceil(n/4)]`` of int8 levels: byte ``j`` holds the codes
    ``level + 1`` of elements ``4j .. 4j+3``, element ``i`` at bits ``2 * (i %
    4)``, their sum taken in int32 and cut to 8 bits; the padded tail packs
    as code 1 (level 0).

    Replaces ``_pack2b_kernel`` (``pack_ternary_pallas``, through
    ``_pack_bytes_call``) of ``tpu_compressed_dp/ops/kernels.py``; not on any
    wire path, as in the reference.  Bound: 1.25n bytes; see
    ``csrc/byte_pack.cu``."""
    if levels.device.type == "cpu":
        return pack_ternary_bytes_plain(levels)
    if levels.device.type != "cuda":
        raise ValueError(f"pack_ternary_bytes runs on CUDA or CPU tensors, got {levels.device}")
    _check_levels(levels, torch.int8, "pack_ternary_bytes")
    n = levels.numel()
    out = torch.empty(-(-n // 4), dtype=torch.uint8, device=levels.device)
    if n:
        rc = _lib("byte_pack").tcdp_pack_ternary_bytes(
            levels.data_ptr(), n, out.data_ptr(),
            torch.cuda.current_stream(levels.device).cuda_stream)
        _check_launch(rc, "pack_ternary_bytes")
        LAUNCHES["ternary_bytes"] += 1
    return out


def qsgd_pack_bytes(levels: torch.Tensor):
    """``(uint8 |level| [n], uint8 sign bitmap [ceil(n/8)])`` of int16
    levels: the magnitude taken in int32 and cut to 8 bits, bit ``i % 8`` of
    byte ``i // 8`` set iff ``level_i < 0``.

    Replaces ``_qsgd_pack_levels_kernel`` (``qsgd_pack_pallas``, through
    ``_pack_bytes_call``) of ``tpu_compressed_dp/ops/kernels.py``; not on
    any wire path, as in the reference.  Bound: 3.125n bytes; see
    ``csrc/byte_pack.cu``."""
    if levels.device.type == "cpu":
        return qsgd_pack_bytes_plain(levels)
    if levels.device.type != "cuda":
        raise ValueError(f"qsgd_pack_bytes runs on CUDA or CPU tensors, got {levels.device}")
    _check_levels(levels, torch.int16, "qsgd_pack_bytes")
    n = levels.numel()
    mags = torch.empty(n, dtype=torch.uint8, device=levels.device)
    signs = torch.empty(-(-n // 8), dtype=torch.uint8, device=levels.device)
    if n:
        rc = _lib("byte_pack").tcdp_qsgd_pack_bytes(
            levels.data_ptr(), n, mags.data_ptr(), signs.data_ptr(),
            torch.cuda.current_stream(levels.device).cuda_stream)
        _check_launch(rc, "qsgd_pack_bytes")
        LAUNCHES["qsgd_bytes"] += 1
    return mags, signs


# ---------------------------------------------------------------------------
# Bucket route (the sharded transport's per-destination buckets)
# ---------------------------------------------------------------------------


def route_starts(dest: torch.Tensor, world: int) -> torch.Tensor:
    """int32 ``[W + 1]`` exclusive prefix of the per-destination counts of
    ``dest`` over ``W + 1`` buckets (the last the dump bucket of invalid
    slots): destination ``w``'s slots start at ``starts[w]``, and there are
    ``starts[w + 1] - starts[w]`` of them.  A scatter-add into ``W + 1``
    zeros and a cumsum, on the device (no ``bincount``, which reads its
    maximum back to the host)."""
    counts = torch.zeros(world + 1, dtype=torch.int32, device=dest.device).scatter_add_(
        0, dest.long(), torch.ones_like(dest, dtype=torch.int32))
    return (torch.cumsum(counts, 0, dtype=torch.int32) - counts).contiguous()


def fused_bucket_route_plain(vals: torch.Tensor, idx: torch.Tensor, dest: torch.Tensor,
                             world: int, cap: int, shard_n: int):
    """The kernel's contract by PyTorch ops: row ``w`` of ``(bvals [W, cap],
    bidx [W, cap] int32)`` holds the payload window ``[starts[w], starts[w] +
    min(count_w, cap))`` with local indices ``idx - w * shard_n``; the rest
    of the row is value 0 / index ``shard_n``.  Values are selected, never
    added, so their bits (a ``-0.0``, a NaN's payload) are kept."""
    dev = vals.device
    starts = route_starts(dest, world).long()
    r = torch.arange(cap, dtype=torch.int64, device=dev)
    cnt = torch.clamp(starts[1:] - starts[:-1], max=cap)           # [W]
    take = r[None, :] < cnt[:, None]                                # [W, cap]
    pos = torch.where(take, starts[:-1, None] + r[None, :], 0).reshape(-1)
    v = vals.index_select(0, pos).reshape(world, cap)
    i = idx.index_select(0, pos).reshape(world, cap)
    w_off = torch.arange(world, dtype=torch.int32, device=dev)[:, None] * shard_n
    bvals = torch.where(take, v, torch.zeros((), dtype=vals.dtype, device=dev))
    bidx = torch.where(take, i - w_off, shard_n).to(torch.int32)
    return bvals, bidx


def fused_bucket_route(vals: torch.Tensor, idx: torch.Tensor, dest: torch.Tensor,
                       world: int, cap: int, shard_n: int):
    """``(bvals [W, cap] float32, bidx [W, cap] int32)``: the sharded
    transport's per-destination buckets as ``W`` windowed copies of the
    ascending payload, instead of a ``[W*cap+1]`` scatter pair.  ``dest`` is
    each slot's destination, ``W`` for the invalid tail (the dump bucket,
    in no window), ascending with ``idx``.

    Replaces ``_bucket_route_kernel`` / ``fused_bucket_route`` of
    ``tpu_compressed_dp/ops/kernels.py``.  Bound: the accepted windows read
    and the buckets written, ``8 * (sum_w min(count_w, cap) + W * cap)``
    bytes; see ``csrc/bucket_route.cu``."""
    world, cap, shard_n = int(world), int(cap), int(shard_n)
    if world < 1 or cap < 1:
        raise ValueError(f"fused_bucket_route needs world >= 1 and cap >= 1, got "
                         f"{world}, {cap}")
    if vals.device.type == "cpu":
        return fused_bucket_route_plain(vals, idx, dest, world, cap, shard_n)
    if vals.device.type != "cuda":
        raise ValueError(f"fused_bucket_route runs on CUDA or CPU tensors, got {vals.device}")
    _check_f32_vector(vals, "vals")
    k = vals.shape[0]
    for t, what in ((idx, "idx"), (dest, "dest")):
        if (t.dtype != torch.int32 or t.shape != (k,) or not t.is_contiguous()
                or t.device != vals.device):
            raise ValueError(f"{what} must be a contiguous int32[{k}] tensor on vals' device")
    if world > 65535 or (world - 1) * shard_n > _INT32_MAX:
        raise ValueError(f"bucket route geometry W={world}, cap={cap}, shard_n={shard_n} "
                         "exceeds the kernel's int32 offsets")
    dev = vals.device
    starts = route_starts(dest, world)
    bvals = torch.empty(world, cap, dtype=torch.float32, device=dev)
    bidx = torch.empty(world, cap, dtype=torch.int32, device=dev)
    rc = _lib("bucket_route").tcdp_bucket_route(
        vals.data_ptr(), idx.data_ptr(), starts.data_ptr(), world, cap, shard_n,
        bvals.data_ptr(), bidx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(rc, "bucket_route")
    LAUNCHES["bucket_route"] += 1
    return bvals, bidx


def use_bucket_route(k: int, world: int, cap: int, device) -> bool:
    """Whether the sharded route takes the bucket-route kernel for a
    ``k``-slot element-granular payload (Block-Top-K's block rows keep the
    scatter build).  The JAX gate's ``cap_p <= 2^15`` bound fits two scratch
    windows in TPU VMEM; a CUDA window copy has no such limit, so it is
    dropped here (full-width entire-model Top-K at W = 2, ``cap`` 41,083,
    takes the kernel).  ``cap`` stays in the signature for the JAX one's
    sake."""
    return _dispatch_to_kernel(k, torch.device(device)) and k <= _INT32_MAX and world >= 2
