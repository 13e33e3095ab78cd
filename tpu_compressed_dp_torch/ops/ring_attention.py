"""Causal attention of the LM layers: the fused flash kernels, the unfused
chain, or a ring of blocks over a sequence-parallel process group.

PyTorch counterpart of :mod:`tpu_compressed_dp.ops.ring_attention`.  At ring
size 1 (no sequence-parallel axis) a layer's attention runs whole on one
worker: :func:`use_fused_attention` sends CUDA tensors the kernels take to
:func:`tpu_compressed_dp_torch.ops.flash_attention.flash_causal_attention`;
everything else, the CPU by default included (as JAX off the TPU), takes the
unfused online-softmax step ``_block_attend`` over the one block, with q and
k upcast to float32 before the score product as the JAX code does.

Over a ``seq`` group of ``ring`` ranks (``parallel/mesh.lm_groups``) each
rank holds a block of ``T_local`` positions, rank ``i`` the positions
``[i * T_local, (i + 1) * T_local)``.  The K/V blocks rotate ``i -> i + 1``
(:func:`~tpu_compressed_dp_torch.parallel.mesh.ppermute`, whose backward
sends the cotangents back around the ring) while each rank accumulates its
queries' ``(o, m, l)`` over the blocks with the unfused step, as the JAX
ring does: no kernel serves a ring block, since the flash kernels export no
``(o, m, l)`` (ROADMAP item 15).  Every rank attends every block, the ones
its causal mask hides whole too, so every rank builds the same graph and
issues the same collectives in the same order, forward and backward.

Layout ``[B, H, T, D]``.  GQA: K/V may have fewer heads than Q when
``H_q % H_kv == 0``; each KV head is repeated for its group of query heads
(``jnp.repeat(k, rep, axis=1)``, i.e. ``repeat_interleave``).  The ring
rotates the unrepeated K/V and repeats each block where it is used: the
same values, ``H_kv / H_q`` of the bytes.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_compressed_dp_torch.ops import kernels
from tpu_compressed_dp_torch.ops.flash_attention import (check_kernel_shape,
                                                         flash_causal_attention)
from tpu_compressed_dp_torch.parallel import mesh

__all__ = ["ring_attention", "dense_causal_attention", "use_fused_attention"]

_NEG_INF = -1e30


def use_fused_attention(q_shape, k_shape, dtype, device) -> bool:
    """Whether the flash kernels serve this attention call: the dispatch mode
    of :mod:`~tpu_compressed_dp_torch.ops.kernels` (``off`` never,
    ``force`` on every device through the plain versions on the CPU,
    ``auto`` on CUDA tensors), ``T == T_kv``, the JAX gate's ``T % 128 ==
    0``, and operands the kernels take (:func:`check_kernel_shape`).  The JAX
    gate's 4 MB bound on K + V (TPU VMEM residency) does not apply: the CUDA
    kernels stream K/V through shared memory at any ``T``."""
    mode = kernels.pallas_mode()
    if mode == "off" or (mode == "auto" and torch.device(device).type != "cuda"):
        return False
    t = q_shape[2]
    return (t == k_shape[2] and t % 128 == 0
            and check_kernel_shape(q_shape, dtype) is None)


def _block_attend(q, k, v, q_pos, k_pos, scale, o, m, l):
    """One online-softmax accumulation step against a K/V block (the JAX
    ``_block_attend``); q and k already float32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    causal = q_pos[:, None] >= k_pos[None, :]
    s = torch.where(causal, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    # fully-masked rows keep the -1e30 sentinel; exp(-inf - -inf) guarded to 0
    corr = torch.where(m > _NEG_INF / 2, torch.exp(m - m_new), 0.0)
    p = torch.exp(s - m_new[..., None])
    p = torch.where(causal, p, 0.0)
    l_new = l * corr + p.sum(-1)
    pv = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return o * corr[..., None] + pv, m_new, l_new


def _repeat_kv(q, k, v):
    if q.shape[1] != k.shape[1]:
        if q.shape[1] % k.shape[1]:
            raise ValueError(f"H_q={q.shape[1]} not a multiple of H_kv={k.shape[1]}")
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return k, v


def _unfused_causal(q, k, v, scale: float) -> torch.Tensor:
    t = q.shape[2]
    pos = torch.arange(t, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:3], _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    o, m, l = _block_attend(q.to(torch.float32), k.to(torch.float32), v, pos, pos, scale,
                            o, m, l)
    # every causal query row attends to itself, so l > 0
    return (o / l[..., None]).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group=None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention of this rank's query block, ``q/k/v`` ``[B, H,
    T_local, D]``.  ``group`` is the sequence-parallel ring (``None``: no
    sequence axis, one block); the full sequence is ``ring * T_local``
    long."""
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    ring = mesh.axis_size(group)
    if ring == 1:
        k, v = _repeat_kv(q, k, v)
        if use_fused_attention(q.shape, k.shape, q.dtype, q.device):
            return flash_causal_attention(q, k, v, scale)
        return _unfused_causal(q, k, v, scale)
    my = mesh.group_rank(group)
    t = q.shape[2]
    local = torch.arange(t, device=q.device)
    q_pos = my * t + local
    qf = q.to(torch.float32)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:3], _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    perm = mesh.ring_perm(ring)
    for s in range(ring):
        # after s rotations this rank holds block (my - s) mod ring
        src = (my - s) % ring
        kb, vb = _repeat_kv(q, kv[0], kv[1])
        o, m, l = _block_attend(qf, kb.to(torch.float32), vb, q_pos, src * t + local,
                                scale, o, m, l)
        if s < ring - 1:
            kv = mesh.ppermute(kv, perm, group)
    # every causal query row attends to itself, so l > 0
    return (o / l[..., None]).to(q.dtype)


def dense_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Reference implementation (full ``[T, T]`` scores, never the kernels)
    for tests."""
    k, v = _repeat_kv(q, k, v)
    return _unfused_causal(q, k, v, scale if scale is not None else 1.0 / (q.shape[3] ** 0.5))
