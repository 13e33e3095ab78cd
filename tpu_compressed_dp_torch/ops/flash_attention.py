"""Tiled causal flash attention, forward and backward, on hand-written CUDA kernels.

PyTorch/H100 counterpart of :mod:`tpu_compressed_dp.ops.flash_attention`.  The
single-block attention of every LM layer (``ops/ring_attention.py`` at ring
size 1) streams K/V through on-chip memory with the online-softmax
recurrence instead of materialising the ``[T, T]`` probabilities: forward
saves ``(q, k, v, o, lse)``; backward computes ``delta = rowsum(do * o)``,
then one kernel accumulates dq over K/V blocks and a second dk/dv over Q
blocks, each recomputing its scores.

Kernels (``csrc/flash_attention.cu``, built for ``sm_90a`` with the other
sources of :mod:`tpu_compressed_dp_torch.ops.kernels`):

  * ``flash_fwd`` replaces ``_fwd_kernel``;
  * ``flash_dq`` replaces ``_dq_kernel``;
  * ``flash_dkv`` replaces ``_dkv_kernel`` and ``_dkv_kernel_streamed`` (one
    CUDA kernel: on the card every q/do block streams through shared memory).

Each C entry picks its kernel by dtype alone.  bfloat16 ``flash_fwd``,
``flash_dq`` and ``flash_dkv`` run on the tensor cores (``mma.sync`` with
``ldmatrix`` and a ``cp.async`` ring, 64-row tiles, a warp per 16 rows): a
product of two bf16 values is exact in float32, so they compute the
reference's products.  dv's ``p`` is float32 in the reference; it reaches
the tensor cores as ``hi + lo`` (:func:`split_bf16`), two bf16 products into
one float32 sum, since one bf16 rounding of ``p`` lands ~20x past the dv
share of ``chip_smoke.py``'s rule (:func:`flash_dv_bf16_parts_plain`
emulates both).  Where ``p >= 2^-8`` the dq and dk/dv kernels recompute
``s`` and ``dp`` as the float32 FMA chain in index order, so that
``bf16(ds)`` rounds from the plain version's sums
(:func:`flash_dq_exact_dots_plain` emulates dq's design).  float32 operands
stay on the CUDA cores: TF32 tensor cores would not compute the reference's
float32 products.

Layout ``[B, H, T, D]``, causal only, bfloat16 or float32, ``T`` a multiple
of 64 (the dispatch gate asks 128) and ``D`` 64 or 128.  ``lse`` and
``delta`` are plain float32 ``[B, H, T]`` tensors (the TPU kernels pack them
into spare lanes).

Each kernel has a plain PyTorch version beside it (``*_plain``): a loop over
the JAX kernels' blocks with their casts (products of the input type
accumulated in float32, ``p`` rounded to v's type before P.V, ``ds`` to the
input type before ``ds . k`` and ``ds^T . q``).  A wrapper runs the plain
version only because its tensors lie on the CPU; on CUDA tensors it launches
the kernel or raises.  Each launch adds one to
``kernels.LAUNCHES['flash_fwd' | 'flash_dq' | 'flash_dkv']``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpu_compressed_dp_torch.ops import kernels

__all__ = ["flash_causal_attention", "flash_fwd", "flash_dq", "flash_dkv",
           "flash_fwd_plain", "flash_dq_plain", "flash_dkv_plain", "pick_blocks",
           "check_kernel_shape", "split_bf16", "flash_dv_bf16_parts_plain",
           "flash_dq_exact_dots_plain"]

_NEG_INF = -1e30
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def pick_blocks(t: int) -> Tuple[int, int]:
    """The JAX kernels' ``(block_q, block_k)`` (``_pick_blocks``), which the
    plain versions loop over: 256 at ``T >= 8192``, else ``min(512, T)``,
    halved until it divides ``T``."""
    bq = min(256 if t >= 8192 else 512, t)
    while t % bq:
        bq //= 2
    return bq, bq


def _causal(qi: int, kj: int, bq: int, bk: int, device) -> torch.Tensor:
    q_pos = qi * bq + torch.arange(bq, device=device)
    k_pos = kj * bk + torch.arange(bk, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched float32 product of float32-widened operands (a product of two
    bf16 values is exact in float32, so this is the MXU's bf16-operand,
    float32-accumulate contraction)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of causal attention by the forward kernel's blocks and
    casts; ``q/k/v`` ``[..., T, D]``, ``o`` in q's type, ``lse`` float32."""
    t = q.shape[-2]
    bq, bk = pick_blocks(t)
    n_k = t // bk
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    for qi in range(t // bq):
        qb = q[..., qi * bq:(qi + 1) * bq, :]
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        m = torch.full(qb.shape[:-1], _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        for kj in range(min(((qi + 1) * bq + bk - 1) // bk, n_k)):
            kb = k[..., kj * bk:(kj + 1) * bk, :]
            vb = v[..., kj * bk:(kj + 1) * bk, :]
            s = _mm(qb, kb.transpose(-1, -2)) * scale
            s = torch.where(_causal(qi, kj, bq, bk, q.device), s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _mm(p.to(v.dtype), vb)
            m = m_new
        o[..., qi * bq:(qi + 1) * bq, :] = (acc / l[..., None]).to(q.dtype)
        lse[..., qi * bq:(qi + 1) * bq] = m + torch.log(l)
    return o, lse


def _p_ds(qb, kb, vb, do_f, lse_b, delta_b, qi, kj, bq, bk, scale):
    s = _mm(qb, kb.transpose(-1, -2)) * scale
    p = torch.where(_causal(qi, kj, bq, bk, qb.device), torch.exp(s - lse_b[..., None]), 0.0)
    dp = _mm(do_f, vb.transpose(-1, -2))
    return p, p * (dp - delta_b[..., None]) * scale


def flash_dq_plain(q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """dq by the dq kernel's blocks and casts (``do`` widened to float32,
    ``ds`` rounded to k's type before ``ds . k``); dq in q's type."""
    t = q.shape[-2]
    bq, bk = pick_blocks(t)
    n_k = t // bk
    dq = torch.empty_like(q)
    for qi in range(t // bq):
        rows = slice(qi * bq, (qi + 1) * bq)
        qb, do_f = q[..., rows, :], do[..., rows, :].to(torch.float32)
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        for kj in range(min(((qi + 1) * bq + bk - 1) // bk, n_k)):
            kb = k[..., kj * bk:(kj + 1) * bk, :]
            vb = v[..., kj * bk:(kj + 1) * bk, :]
            _, ds = _p_ds(qb, kb, vb, do_f, lse[..., rows], delta[..., rows], qi, kj, bq, bk,
                          scale)
            acc = acc + _mm(ds.to(k.dtype), kb)
        dq[..., rows, :] = acc.to(q.dtype)
    return dq


def flash_dkv_plain(q, k, v, do, lse, delta, scale: float):
    """``(dk, dv)`` by the dkv kernels' blocks and casts (``dv += p^T do`` in
    float32, ``ds`` rounded to q's type before ``ds^T . q``); in q's type."""
    t = q.shape[-2]
    bq, bk = pick_blocks(t)
    n_q = t // bq
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    for kj in range(t // bk):
        cols = slice(kj * bk, (kj + 1) * bk)
        kb, vb = k[..., cols, :], v[..., cols, :]
        dk_acc = torch.zeros(kb.shape, dtype=torch.float32, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for qi in range(kj * bk // bq, n_q):
            rows = slice(qi * bq, (qi + 1) * bq)
            qb, do_f = q[..., rows, :], do[..., rows, :].to(torch.float32)
            p, ds = _p_ds(qb, kb, vb, do_f, lse[..., rows], delta[..., rows], qi, kj, bq, bk,
                          scale)
            dv_acc = dv_acc + _mm(p.transpose(-1, -2), do_f)
            dk_acc = dk_acc + _mm(ds.to(q.dtype).transpose(-1, -2), qb)
        dk[..., cols, :] = dk_acc.to(q.dtype)
        dv[..., cols, :] = dv_acc.to(q.dtype)
    return dk, dv


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` as ``hi + lo``, two bfloat16 values held in float32: ``hi =
    bf16(x)``, ``lo = bf16(x - hi)`` (``x - hi`` is exact), so ``hi + lo``
    is ``x`` to ~2^-17 of it.  The tensor-core dk/dv kernel feeds dv's
    float32 ``p`` to the bf16 tensor cores this way."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def flash_dv_bf16_parts_plain(q, k, v, do, lse, delta, scale: float,
                              parts: int = 2) -> torch.Tensor:
    """dv by the dkv kernels' blocks with ``p`` (float32 in the reference)
    in ``parts`` bfloat16 terms, each product with ``do`` summed in float32:
    ``parts=2`` is :func:`split_bf16`'s ``hi + lo``, the tensor-core kernel's
    design; ``parts=1`` rounds ``p`` once.  No path calls it: the CPU tests
    hold the design against :func:`flash_dkv_plain`; float32 dv."""
    if parts not in (1, 2):
        raise ValueError(f"parts must be 1 or 2, got {parts}")
    t = q.shape[-2]
    bq, bk = pick_blocks(t)
    n_q = t // bq
    dv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for kj in range(t // bk):
        cols = slice(kj * bk, (kj + 1) * bk)
        kb, vb = k[..., cols, :], v[..., cols, :]
        acc = torch.zeros(kb.shape, dtype=torch.float32, device=q.device)
        for qi in range(kj * bk // bq, n_q):
            rows = slice(qi * bq, (qi + 1) * bq)
            qb, do_f = q[..., rows, :], do[..., rows, :].to(torch.float32)
            p, _ = _p_ds(qb, kb, vb, do_f, lse[..., rows], delta[..., rows], qi, kj, bq, bk,
                         scale)
            hi, lo = split_bf16(p)
            acc = acc + _mm(hi.transpose(-1, -2), do_f)
            if parts == 2:
                acc = acc + _mm(lo.transpose(-1, -2), do_f)
        dv[..., cols, :] = acc
    return dv


def _exact_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a b^T`` of bf16-valued operands, each sum rounded once to float32
    (the products are exact in float64, their float64 sum errs far below a
    float32 ulp): the order-free model of the tensor cores' float32 sums."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64).transpose(-1, -2)).to(
        torch.float32)


def _chain_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a b^T`` as the float32 chain ``x = fma(a_d, b_d, x)`` over d in index
    order: a product of two bf16 values is exact in float32, so ``x + a_d
    b_d`` rounds once per step, as ``fmaf`` does."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    x = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float32, device=a.device)
    for d in range(a.shape[-1]):
        x = x + a[..., :, d, None] * b[..., None, :, d]
    return x


def flash_dq_exact_dots_plain(q, k, v, do, lse, delta, scale: float,
                              seq_p: float = 2.0 ** -8) -> torch.Tensor:
    """dq by the dq kernel's blocks with the tensor-core kernel's ``s`` and
    ``dp``: exactly rounded float32 sums (:func:`_exact_dots`, a model of the
    tensor cores' own order), and where ``p >= seq_p`` the index-order float32
    FMA chain instead (:func:`_chain_dots`), which is what the kernel's
    ``seq_dots`` computes; ``seq_p=math.inf`` keeps the exact sums everywhere.
    ``ds`` is rounded to k's type before ``ds . k``; dq in q's type.  No path
    calls it: the CPU tests hold the design against :func:`flash_dq_plain`.

    The chain is there for the T = 8192 rows on the card, where a large
    ``ds`` within an ulp of a bf16 midpoint rounds by the order of the float32
    sums: there the tensor-core dq without it read 0.0216 of the rms against
    the plain version, past ``chip_smoke.py``'s 2^-7 dq share.  At the CPU
    tests' sizes the exact-sum variant without the chain passes the share
    too, so the CPU test checks the design's rounding points, not that
    failure; phase 6 of ``chip_smoke.py`` remains the check of it."""
    t = q.shape[-2]
    bq, bk = pick_blocks(t)
    n_k = t // bk
    dq = torch.empty_like(q)
    for qi in range(t // bq):
        rows = slice(qi * bq, (qi + 1) * bq)
        qb, dob = q[..., rows, :], do[..., rows, :]
        lse_b, delta_b = lse[..., rows, None], delta[..., rows, None]
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        for kj in range(min(((qi + 1) * bq + bk - 1) // bk, n_k)):
            kb = k[..., kj * bk:(kj + 1) * bk, :]
            vb = v[..., kj * bk:(kj + 1) * bk, :]
            live = _causal(qi, kj, bq, bk, q.device)
            s, dp = _exact_dots(qb, kb), _exact_dots(dob, vb)
            p = torch.where(live, torch.exp(s * scale - lse_b), 0.0)
            chain = p >= seq_p   # masked entries are 0
            s = torch.where(chain, _chain_dots(qb, kb), s)
            dp = torch.where(chain, _chain_dots(dob, vb), dp)
            p = torch.where(chain, torch.exp(s * scale - lse_b), p)
            ds = p * (dp - delta_b) * scale
            acc = acc + _mm(ds.to(k.dtype), kb)
        dq[..., rows, :] = acc.to(q.dtype)
    return dq


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------


def check_kernel_shape(shape, dtype) -> Optional[str]:
    """Why the kernels cannot take ``[B, H, T, D]`` operands of this shape
    and dtype, or None."""
    if dtype not in _KERNEL_DTYPES:
        return f"dtype {dtype} (the kernels take bfloat16 and float32)"
    if len(shape) != 4:
        return f"shape {tuple(shape)} (need [B, H, T, D])"
    b, h, t, d = shape
    if t <= 0 or t % 64 or d not in (64, 128) or not 0 < b * h <= 65535:
        return f"shape {tuple(shape)} (need T % 64 == 0, D in (64, 128), B*H <= 65535)"
    return None


def _check(name: str, *tensors: torch.Tensor) -> None:
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {q.device}")
    why = check_kernel_shape(q.shape, q.dtype)
    if why:
        raise ValueError(f"{name}: the kernel does not take {why}")
    for x in tensors:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name}: operands must share q's shape {tuple(q.shape)}, "
                             f"dtype and device")
        if not x.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _check_stats(q: torch.Tensor, *stats: torch.Tensor) -> None:
    for x in stats:
        if (x.dtype != torch.float32 or x.shape != q.shape[:-1] or not x.is_contiguous()
                or x.device != q.device):
            raise ValueError(f"lse/delta must be contiguous float32 {tuple(q.shape[:-1])} "
                             "tensors on q's device")


def _geometry(q: torch.Tensor):
    b, h, t, d = q.shape
    return (b * h, t, d, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: causal attention of ``[B, H, T, D]`` operands, ``o`` in
    q's type, ``lse`` float32 ``[B, H, T]``.  Bound: operations, ``2 T^2 D
    B H`` (causal half); see ``csrc/flash_attention.cu``."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale)
    _check("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    bh, t, d, bf16, stream = _geometry(q)
    rc = kernels._lib("flash_attention").tcdp_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, t, d, bf16,
        ctypes.c_float(scale), stream)
    kernels._check_launch(rc, "flash_fwd")
    kernels.LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_dq(q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """dq in q's type.  Bound: operations, ``3 T^2 D B H`` (causal half of
    three products)."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, scale)
    _check("flash_dq", q, k, v, do)
    _check_stats(q, lse, delta)
    dq = torch.empty_like(q)
    bh, t, d, bf16, stream = _geometry(q)
    rc = kernels._lib("flash_attention").tcdp_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), bh, t, d, bf16, ctypes.c_float(scale), stream)
    kernels._check_launch(rc, "flash_dq")
    kernels.LAUNCHES["flash_dq"] += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, scale: float):
    """``(dk, dv)`` in q's type.  Bound: operations, ``4 T^2 D B H`` (causal
    half of four products)."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, scale)
    _check("flash_dkv", q, k, v, do)
    _check_stats(q, lse, delta)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    bh, t, d, bf16, stream = _geometry(q)
    rc = kernels._lib("flash_attention").tcdp_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, t, d, bf16, ctypes.c_float(scale),
        stream)
    kernels._check_launch(rc, "flash_dkv")
    kernels.LAUNCHES["flash_dkv"] += 1
    return dk, dv


class _FlashCausal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        # outside the kernels, as _fa_bwd computes it
        delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)
        dq = flash_dq(q, k, v, do, lse, delta, ctx.scale)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Exact causal attention, flash-tiled, differentiable; ``[B, H, T, D]``
    with equal q and kv heads (the GQA repeat is the caller's,
    ``ring_attention``)."""
    d = q.shape[-1]
    s = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    return _FlashCausal.apply(q, k, v, s)
