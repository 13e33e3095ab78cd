"""Wire-mode gradient sync: payloads whose bytes really shrink.

PyTorch counterpart of the allgather transport of
:mod:`tpu_compressed_dp.ops.wire` (``mode='wire'`` of
:class:`~tpu_compressed_dp_torch.parallel.dp.CompressionConfig`), the
generalisation of the reference's ``RandomKSparsifiedDDP``
(`IMAGENET/training/sparsified_ddp.py:412,460-462`):

  * **Random-K**: every worker derives the same coordinates from the shared
    seed, so only the ``[k]`` values travel, ``all_reduce``-summed and
    divided by the world size;
  * **Top-K**, **Threshold-V / Adaptive-Threshold** and **Block-Top-K**:
    worker-local index sets differ, so fixed-size ``([k] values, [k] int32
    indices)`` pairs (whole ``[kb, block_size]`` value rows with block
    indices for Block-Top-K) are ``all_gather``-ed and scatter-added, one
    rank row after another in rank order, then divided by the world size.
    The threshold methods ship a fixed ``cap = round(wire_cap_ratio * n)``
    buffer; survivors past it stay in the EF residual (or are dropped, and
    counted in ``threshold_overflow``);
  * **TernGrad**: 2-bit codes four to a byte plus the fp32 scale(s);
  * **QSGD**: int8 levels for ``qstates <= 127``, uint8 magnitudes plus a
    sign bitmap for ``qstates <= 255``, int16 beyond; plus the fp32 scale;
    both ``all_gather``-ed and decoded on every worker.

``sent_bits`` is measured from the byte sizes of the tensors handed to the
collectives.  The select+pack and the quantize+pack steps run on the CUDA
kernels of :mod:`~tpu_compressed_dp_torch.ops.kernels` where they are
dispatched; every count, threshold and overflow stays a device tensor, so a
sync never waits for the host.  The sharded and hierarchical transports are
not ported yet (ROADMAP.md queue 1, item 8).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from tpu_compressed_dp_torch.ops import compressors, kernels
from tpu_compressed_dp_torch.parallel import mesh

__all__ = ["make_wire_grad_sync", "WIRE_METHODS", "pack_ternary", "unpack_ternary",
           "pack_bits", "unpack_bits", "qsgd_wire_pack", "qsgd_wire_unpack",
           "packed_indices_from_mask", "packed_indices_monotone", "select_pack_topk"]

WIRE_METHODS = ("randomk", "topk", "blocktopk", "terngrad", "qsgd",
                "thresholdv", "adaptive_threshold")

Tree = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Byte layouts
# ---------------------------------------------------------------------------


def _pack_codes(codes: torch.Tensor, per: int) -> torch.Tensor:
    """uint8 bytes of small int32 ``codes``, ``per`` to a byte, element ``i``
    at bits ``(8 // per) * (i % per)``."""
    shifts = torch.arange(0, 8, 8 // per, dtype=torch.int32, device=codes.device)
    return (codes.reshape(-1, per) << shifts).sum(dim=1).to(torch.uint8)


def pack_ternary(levels: torch.Tensor) -> torch.Tensor:
    """Ternary levels (int8 in {-1, 0, 1}) as 2-bit codes ``level + 1``, four
    to a byte, element ``i`` at bits ``2 * (i % 4)``: ``uint8[ceil(n/4)]``; a
    padded tail packs as code 1 (level 0)."""
    n = levels.shape[0]
    return _pack_codes(torch.nn.functional.pad(levels.to(torch.int32), (0, (-n) % 4)) + 1, 4)


def unpack_ternary(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_ternary`: ``uint8[..., ceil(n/4)] -> int8[..., n]``."""
    p = packed.to(torch.int32)
    codes = torch.stack([(p >> s) & 3 for s in (0, 2, 4, 6)], dim=-1)
    return (codes.reshape(*packed.shape[:-1], -1)[..., :n] - 1).to(torch.int8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """A boolean vector eight to a byte, little-endian within the byte."""
    n = bits.shape[0]
    return _pack_codes(torch.nn.functional.pad(bits.to(torch.int32), (0, (-n) % 8)), 8)


def unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``uint8[..., ceil(n/8)] -> bool[..., n]``."""
    p = packed.to(torch.int32)
    bits = torch.stack([(p >> i) & 1 for i in range(8)], dim=-1)
    return bits.reshape(*packed.shape[:-1], -1)[..., :n].to(torch.bool)


def qsgd_wire_pack(levels: torch.Tensor, qstates: int) -> Tuple[torch.Tensor, ...]:
    """The narrowest layout of QSGD's int16 ``sign * level``: int8 for
    ``qstates <= 127``; uint8 magnitudes and a sign bitmap for ``qstates <=
    255`` (9 bits an element); the int16 levels beyond."""
    if qstates <= 127:
        return (levels.to(torch.int8),)
    if qstates <= 255:
        return levels.to(torch.int32).abs().to(torch.uint8), pack_bits(levels < 0)
    return (levels,)


def qsgd_wire_unpack(payload: Tuple[torch.Tensor, ...], n: int, qstates: int,
                     dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`qsgd_wire_pack`, ``sign * level`` in ``dtype``;
    takes a leading gather axis."""
    if qstates <= 127 or qstates > 255:
        return payload[0].to(dtype)
    mags, signs = payload
    m = mags.to(dtype)
    return torch.where(unpack_bits(signs, n), -m, m)


# ---------------------------------------------------------------------------
# Select + pack
# ---------------------------------------------------------------------------


def packed_indices_from_mask(mask: torch.Tensor, keep: int) -> torch.Tensor:
    """int32 ascending indices of the first ``keep`` set positions of
    ``mask``; ranks past the count are 0 (``kernels.first_set_indices``).
    Where the select+pack kernel is dispatched it computes the same indices,
    from the mask as 0/1 magnitudes at threshold 0.5."""
    if kernels.use_select_pack(mask.shape[0], keep, mask.device):
        half = torch.full((), 0.5, dtype=torch.float32, device=mask.device)
        return kernels.fused_select_pack(mask.to(torch.float32), half, keep)[1]
    return kernels.first_set_indices(mask, keep)


def packed_indices_monotone(idx: torch.Tensor) -> torch.Tensor:
    """True iff ``idx`` is strictly ascending, which holds exactly when the
    source mask had at least ``keep`` set bits (a debug predicate)."""
    if idx.shape[0] <= 1:
        return torch.ones((), dtype=torch.bool, device=idx.device)
    return (idx[1:] > idx[:-1]).all()


def _select_pack(flat: torch.Tensor, mag: torch.Tensor, t: torch.Tensor, keep: int):
    """``(payload [keep], idx [keep] int32, survivor count int32)``: the
    coordinates with ``mag >= t`` by ascending index.  The fused kernel
    where dispatched; otherwise mask -> :func:`packed_indices_from_mask` ->
    gather (whose underfull ranks repeat ``flat[0]`` where the kernel pads
    0, as in the JAX package)."""
    if kernels.use_select_pack(flat.shape[0], keep, flat.device):
        return kernels.fused_select_pack(flat.contiguous(), t, keep)
    mask = mag >= t
    idx = packed_indices_from_mask(mask, keep)
    return flat[idx.long()], idx, mask.sum(dtype=torch.int32)


def select_pack_topk(flat: torch.Tensor, keep: int):
    """Top-``keep``-by-magnitude select+pack of a flat vector: ``(payload
    [keep], idx [keep] ascending, survivor count)``."""
    mag = flat.abs().to(torch.float32)
    t = kernels.topk_threshold(mag, keep)
    return _select_pack(flat, mag, t, keep)


# ---------------------------------------------------------------------------
# Leaf syncs (allgather transport)
# ---------------------------------------------------------------------------


def _payload_bits(*tensors: torch.Tensor) -> float:
    """Measured transport: the bits of the tensors one worker hands to the
    collective."""
    return float(sum(t.numel() * t.element_size() * 8 for t in tensors))


def _scatter_combine(rows: int, row_shape, dtype, g_idx: torch.Tensor, g_vals: torch.Tensor,
                     world: int) -> torch.Tensor:
    """Gathered ``[W, k]`` indices and ``[W, k, *row_shape]`` values -> the
    dense ``[rows, *row_shape]`` sum over workers / world: one
    ``index_add_`` per rank row, in rank order, as the JAX package's
    per-row scatters add them."""
    dense = torch.zeros((rows,) + tuple(row_shape), dtype=dtype, device=g_vals.device)
    for w in range(g_idx.shape[0]):
        dense.index_add_(0, g_idx[w].long(), g_vals[w])
    return dense / world


def _leaf_sync_randomk(flat: torch.Tensor, seed: int, keep: int, world: int,
                       check: bool = False):
    n = flat.shape[0]
    idx = packed_indices_from_mask(compressors.randomk_mask(seed, n, keep, flat.device), keep)
    payload = flat[idx.long()]                            # [k]: all that travels
    bits = _payload_bits(payload)
    if world > 1:
        dist.all_reduce(payload)
    dense = torch.zeros_like(flat).index_copy_(0, idx.long(), payload / world)
    agree = None
    if check:
        # every worker must have picked the same coordinates, or the summed
        # payload mixes them: the spread of one hash of the indices is 0
        w = 1.0 + torch.arange(keep, device=flat.device) % 7
        h = (idx.to(torch.float32) * w).sum().reshape(1)
        hmax, hmin = h.clone(), h.clone()
        if world > 1:
            dist.all_reduce(hmax, op=dist.ReduceOp.MAX)
            dist.all_reduce(hmin, op=dist.ReduceOp.MIN)
        agree = (hmax == hmin).to(torch.float32).reshape(())
    return dense, idx, agree, bits


def _leaf_sync_topk(flat: torch.Tensor, keep: int, world: int, want_surplus: bool = False):
    mag = flat.abs().to(torch.float32)
    t = kernels.topk_threshold(mag, keep)
    payload, idx, count = _select_pack(flat, mag, t, keep)
    bits = _payload_bits(payload, idx)
    dense = _scatter_combine(flat.shape[0], (), flat.dtype, mesh.all_gather(idx),
                             mesh.all_gather(payload), world)
    # above-threshold survivors past `keep` (ties at the threshold's
    # resolution) are cut by ascending index: with EF off they are dropped
    surplus = torch.clamp(count - keep, min=0) if want_surplus else None
    return dense, idx, surplus, bits


def _leaf_sync_blocktopk(flat: torch.Tensor, keep_blocks: int, block_size: int, world: int,
                         want_ef: bool):
    """Whole ``[block_size]`` rows of the blocks with the largest L2 norms
    travel with their block indices.  The JAX package gathers sub-128-lane
    blocks through covering 128-lane rows (``_blocktopk_small_bs``), a TPU
    layout device; rows of any width gather and scatter directly here, with
    the same sums and the same EF residual."""
    n = flat.shape[0]
    scores = compressors.blocktopk_scores(flat, block_size)
    t = kernels.topk_threshold(scores, keep_blocks)
    # scores are non-negative: they serve as their own magnitudes
    bidx = _select_pack(scores, scores, t, keep_blocks)[1].long()
    g2 = compressors.blocktopk_blocks(flat, block_size)   # [nb, bs]
    payload = g2.index_select(0, bidx)                    # [kb, bs]
    bits = _payload_bits(payload, bidx.to(torch.int32))
    dense = _scatter_combine(g2.shape[0], (block_size,), flat.dtype,
                             mesh.all_gather(bidx.to(torch.int32)), mesh.all_gather(payload),
                             world).reshape(-1)[:n]
    new_ef = g2.index_fill(0, bidx, 0.0).reshape(-1)[:n] if want_ef else None
    return dense, new_ef, bits


def _leaf_sync_threshold(flat: torch.Tensor, v: torch.Tensor, cap: int, world: int,
                         want_ef: bool):
    """The first ``cap`` survivors of ``|flat| >= v`` by ascending index in a
    fixed buffer, zero-padded; ``(dense, new_ef, sent_count, overflow,
    bits)`` with ``sent_count`` and ``overflow`` as 0-d device tensors."""
    vals, idx, count = _select_pack(flat, flat.abs(), v, cap)
    sent_count = torch.clamp(count, max=cap)
    valid = torch.arange(1, cap + 1, dtype=torch.int32, device=flat.device) <= sent_count
    vals = torch.where(valid, vals, 0.0)
    idx = torch.where(valid, idx, 0)
    bits = _payload_bits(vals, idx)                      # the whole cap-sized buffer
    dense = _scatter_combine(flat.shape[0], (), flat.dtype, mesh.all_gather(idx),
                             mesh.all_gather(vals), world)
    new_ef = None
    if want_ef:
        # zero exactly the sent coordinates: padded slots multiply
        # coordinate 0 by 1
        new_ef = flat.clone().scatter_reduce_(0, idx.long(), torch.where(valid, 0.0, 1.0),
                                              reduce="prod")
    overflow = torch.clamp(count - cap, min=0)
    return dense, new_ef, sent_count, overflow, bits


def _leaf_sync_terngrad(flat: torch.Tensor, seed: int, chunk: int, world: int):
    n = flat.shape[0]
    if kernels.use_quant_pack(n, flat.device):
        # dither and 2-bit codes in one kernel pass
        if compressors.terngrad_num_chunks(n, chunk) == 1:
            packed, scale = kernels.terngrad_pack(flat, seed)
        else:
            scaled, scale = compressors.terngrad_prescale(flat, chunk)
            packed = kernels.terngrad_pack_prescaled(scaled, seed)
    else:
        levels, scale = compressors.terngrad_levels(flat, seed, chunk=chunk)
        packed = pack_ternary(levels)                     # uint8[ceil(n/4)]
    bits = _payload_bits(packed, scale)
    g_levels = unpack_ternary(mesh.all_gather(packed), n).to(flat.dtype)   # [W, n]
    g_scale = mesh.all_gather(scale)                      # [W] or [W, nc]
    if scale.dim() == 0:
        return (g_scale[:, None] * g_levels).sum(0) / world, bits
    # chunked scales: each worker's [nc] scales over its chunks
    nc = scale.shape[0]
    lv = torch.nn.functional.pad(g_levels, (0, nc * chunk - n)).reshape(-1, nc, chunk)
    return (g_scale[:, :, None] * lv).sum(0).reshape(-1)[:n] / world, bits


def _leaf_sync_qsgd(flat: torch.Tensor, seed: int, qstates: int, world: int):
    n = flat.shape[0]
    if 127 < qstates <= 255 and kernels.use_quant_pack(n, flat.device):
        # the byte-magnitude + sign-bitmap layout, straight from the kernel
        mags, signs, scale = kernels.qsgd_pack(flat, seed, qstates=qstates)
        payload = (mags, signs)
    else:
        levels, scale = compressors.qsgd_levels(flat, seed, qstates=qstates)
        payload = qsgd_wire_pack(levels, qstates)
    bits = _payload_bits(*payload, scale)
    g_levels = qsgd_wire_unpack(tuple(mesh.all_gather(p) for p in payload), n, qstates,
                                dtype=flat.dtype)
    g_scale = mesh.all_gather(scale)                      # [W]
    return (g_scale[:, None] * g_levels).sum(0) / world, bits


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def make_wire_grad_sync(cfg):
    """Build ``sync(grads, ef, seed) -> (synced, new_ef, stats)`` over the
    default process group, with the contract of the simulate sync in
    :func:`tpu_compressed_dp_torch.parallel.dp.make_grad_sync` (which
    dispatches here for ``mode='wire'``).  The stat keys are the JAX wire
    engine's for the same method: the ``sent_bits*`` split, ``sent_elems``,
    ``dense_elems``, ``num_collectives``, plus ``sync_agree`` (Random-K with
    ``check_sync``), ``threshold_overflow`` (the threshold methods) and
    ``topk_surplus_dropped`` (Top-K without EF)."""
    from tpu_compressed_dp_torch.parallel.dp import (BUCKET_MB, group_concat, group_split,
                                                     make_leaf_groups, wire_transport)

    if cfg.transport != "allgather":
        raise NotImplementedError(f"not ported yet: transport={cfg.transport!r} "
                                  "(ROADMAP.md queue 1, item 8)")
    comp = compressors.get_compressor(
        cfg.method, ratio=cfg.ratio, threshold=cfg.threshold, qstates=cfg.qstates,
        block_size=cfg.block_size, terngrad_chunk=cfg.resolved_terngrad_chunk)
    if comp.name not in WIRE_METHODS:
        raise NotImplementedError(f"mode='wire' supports {WIRE_METHODS}, got {comp.name!r}")
    if comp.name == "randomk" and not cfg.resolved_shared_mask:
        raise ValueError("wire randomk needs shared_mask=True so worker index sets line up "
                         "(the shared-seed trick, sparsified_ddp.py:164)")
    if cfg.error_feedback and comp.name in ("terngrad", "qsgd"):
        raise ValueError("error feedback composes with sparsifiers (topk/randomk); "
                         "terngrad/qsgd are unbiased quantizers with no dropped coordinates")
    # quantizer dither differs across workers only with shared_mask=False;
    # Random-K needs the shared seed (checked above), Top-K draws nothing
    per_worker_rng = not cfg.resolved_shared_mask and comp.needs_rng
    threshold32 = compressors.float32_value(cfg.threshold)

    def leaf_keep(n: int) -> int:
        if comp.name == "topk":
            return compressors.topk_keep_count(n, cfg.ratio)
        if comp.name == "randomk":
            return compressors.randomk_keep_count(n, cfg.ratio)
        if comp.name in ("thresholdv", "adaptive_threshold"):
            # the fixed transport capacity for a data-dependent count
            return max(1, int(round(cfg.wire_cap_ratio * n)))
        if comp.name == "blocktopk":
            # whole blocks travel, padding included, capped at n (a
            # keep-all group all-reduces dense)
            kb = compressors.blocktopk_keep_blocks(n, cfg.ratio, cfg.block_size)
            return min(kb * cfg.block_size, n)
        return n  # quantizers send every coordinate, narrower

    def sync_flat(flat: torch.Tensor, ef_flat: Optional[torch.Tensor], seed: int, world: int):
        """``(dense, new_ef, sent, bits, agree, overflows)``: ``sent`` is a
        Python float, or a 0-d tensor for the threshold methods; ``bits`` is
        measured from the payload tensors."""
        acc = flat + ef_flat if ef_flat is not None else flat
        n = flat.shape[0]
        want_ef = ef_flat is not None
        if n > (1 << 31) - 1 and comp.name not in ("terngrad", "qsgd"):
            raise ValueError(f"wire-mode {comp.name} group of {n} elements exceeds the int32 "
                             "index range; use granularity='bucketed' or 'layerwise'")
        keep = leaf_keep(n)
        if comp.name in ("thresholdv", "adaptive_threshold"):
            v = (torch.full((), threshold32, device=acc.device) if comp.name == "thresholdv"
                 else acc.abs().max() * 0.5)
            dense, new_ef, sent, overflow, bits = _leaf_sync_threshold(acc, v, keep, world,
                                                                       want_ef)
            return (dense, new_ef, sent.to(torch.float32), bits, None,
                    {"threshold_overflow": overflow})
        agree, idx = None, None
        if comp.name == "randomk":
            dense, idx, agree, bits = _leaf_sync_randomk(acc, seed, keep, world, cfg.check_sync)
        elif comp.name == "topk":
            dense, idx, surplus, bits = _leaf_sync_topk(acc, keep, world,
                                                        want_surplus=not want_ef)
            if surplus is not None:
                return dense, None, float(keep), bits, None, {"topk_surplus_dropped": surplus}
        elif comp.name == "blocktopk":
            if keep >= n:
                # every block kept: the dense all-reduce, never more bytes
                # than the dense tensor
                dense = acc.clone()
                bits = _payload_bits(acc)
                if world > 1:
                    dist.all_reduce(dense)
                dense = dense / world
                new_ef = torch.zeros_like(acc) if want_ef else None
            else:
                dense, new_ef, bits = _leaf_sync_blocktopk(
                    acc, keep // cfg.block_size, cfg.block_size, world, want_ef)
            return dense, new_ef, float(keep), bits, None, {}
        elif comp.name == "terngrad":
            dense, bits = _leaf_sync_terngrad(acc, seed, cfg.resolved_terngrad_chunk, world)
        else:  # qsgd
            dense, bits = _leaf_sync_qsgd(acc, seed, cfg.qstates, world)
        # the EF residual is the coordinates that did not travel (EF is
        # refused with the quantizers, so idx is a sparsifier's)
        new_ef = acc.index_fill(0, idx.long(), 0.0) if want_ef else None
        return dense, new_ef, float(keep), bits, agree, {}

    def sync(grads: Tree, ef: Any, seed: int) -> Tuple[Tree, Any, Dict[str, torch.Tensor]]:
        world = mesh.world()
        rank = mesh.rank() if per_worker_rng else None
        names = list(grads)
        leaves = [grads[k] for k in names]
        use_ef = cfg.error_feedback
        if use_ef and not isinstance(ef, dict):
            raise ValueError("error_feedback=True needs an EF state; build it "
                             "with init_ef_state(grads_like, cfg)")
        ef_leaves = [ef[k] for k in names] if use_ef else [None] * len(leaves)
        device = leaves[0].device
        groups = make_leaf_groups([g.numel() * g.element_size() for g in leaves],
                                  cfg.granularity, cfg.bucket_mb * BUCKET_MB)
        out_leaves = [None] * len(leaves)
        new_ef_leaves = [None] * len(leaves)
        agrees, overflows = [], {}
        sent: Any = 0.0
        bits = bits_psum = bits_ag = dense_total = 0.0
        for gi, idxs in enumerate(groups):
            flat = group_concat(leaves, idxs)
            ef_flat = group_concat(ef_leaves, idxs) if use_ef else None
            dense, new_ef_flat, sent_leaf, bits_leaf, agree, leaf_overflows = sync_flat(
                flat, ef_flat, compressors.leaf_seed(seed, gi, rank), world)
            if wire_transport(comp.name, flat.shape[0], cfg) == "psum":
                bits_psum += bits_leaf
            else:
                bits_ag += bits_leaf
            group_split(dense, leaves, idxs, out_leaves)
            if use_ef:
                group_split(new_ef_flat, leaves, idxs, new_ef_leaves, dtype=torch.float32)
            if agree is not None:
                agrees.append(agree)
            for k, v in leaf_overflows.items():
                overflows.setdefault(k, []).append(v)
            sent = sent + sent_leaf          # a device tensor for the threshold methods
            bits += bits_leaf
            dense_total += float(flat.shape[0])

        def f32(v) -> torch.Tensor:
            if isinstance(v, torch.Tensor):
                return v.to(torch.float32)
            return torch.full((), float(v), dtype=torch.float32, device=device)

        zero = f32(0.0)
        stats = {
            "sent_elems": f32(sent),
            "sent_bits": f32(bits),
            "sent_bits_psum": f32(bits_psum),
            "sent_bits_allgather": f32(bits_ag),
            "sent_bits_alltoall": zero,
            "sent_bits_ici": zero,
            "sent_bits_dcn": zero,
            "sent_bits_dcn_route": zero,
            "dense_elems": f32(dense_total),
            "num_collectives": f32(len(groups)),
        }
        if agrees:
            stats["sync_agree"] = torch.stack(agrees).min()
        for k, vs in overflows.items():
            # threshold_overflow: survivors clipped by the capacity;
            # topk_surplus_dropped: survivors past keep, dropped with EF off
            stats[k] = torch.stack(vs).sum().to(torch.float32)
        out = dict(zip(names, out_leaves))
        new_ef = dict(zip(names, new_ef_leaves)) if use_ef else ()
        return out, new_ef, stats

    return sync
