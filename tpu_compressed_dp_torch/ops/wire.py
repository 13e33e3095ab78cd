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

``transport='sharded'`` moves the index-carrying sparsifiers' pairs
through the owner-sharded route -> reduce -> return of
:mod:`~tpu_compressed_dp_torch.ops.wire_sharded` instead (``O(k + n/W)`` per
worker); ``transport='hierarchical'`` sums each pod's contributions densely
(ICI), recompresses the pod union and runs that exchange across pods only
(DCN).  Both degrade to the allgather combine at world 1.  Their capacity
clips go back to the EF residual (or are dropped, with EF off) and are
counted in ``shard_overflow``.

With ``kernels._SEG_PACK_DISPATCH`` set (off by default, as in the JAX
package), allgather Top-K takes the segmented pack instead of select+pack:
at most 128 survivors per 4096-element segment travel, the rest stay in the
EF residual (or are dropped and counted in ``topk_surplus_dropped``).

``sent_bits`` is measured from the byte sizes of the tensors handed to the
collectives.  The select+pack, segmented-pack, quantize+pack and
bucket-route steps run on the CUDA kernels of
:mod:`~tpu_compressed_dp_torch.ops.kernels` where they are dispatched;
every count, threshold and overflow stays a device tensor, so a sync never
waits for the host.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from tpu_compressed_dp_torch.obs import trace as obs_trace
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


# the packing layouts live beside their kernels; the JAX package's wire
# module names them so
pack_ternary = kernels.pack_ternary_bytes_plain
pack_bits = kernels.pack_bits


def unpack_ternary(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_ternary`: ``uint8[..., ceil(n/4)] -> int8[..., n]``."""
    p = packed.to(torch.int32)
    codes = torch.stack([(p >> s) & 3 for s in (0, 2, 4, 6)], dim=-1)
    return (codes.reshape(*packed.shape[:-1], -1)[..., :n] - 1).to(torch.int8)


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
        return kernels.qsgd_pack_bytes_plain(levels)
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
                       check: bool = False, group=None):
    n = flat.shape[0]
    idx = packed_indices_from_mask(compressors.randomk_mask(seed, n, keep, flat.device), keep)
    payload = flat[idx.long()]                            # [k]: all that travels
    bits = _payload_bits(payload)
    if world > 1:
        dist.all_reduce(payload, group=group)
    dense = torch.zeros_like(flat).index_copy_(0, idx.long(), payload / world)
    agree = None
    if check:
        # every worker must have picked the same coordinates, or the summed
        # payload mixes them: the spread of one hash of the indices is 0
        w = 1.0 + torch.arange(keep, device=flat.device) % 7
        h = (idx.to(torch.float32) * w).sum().reshape(1)
        hmax, hmin = h.clone(), h.clone()
        if world > 1:
            dist.all_reduce(hmax, op=dist.ReduceOp.MAX, group=group)
            dist.all_reduce(hmin, op=dist.ReduceOp.MIN, group=group)
        agree = (hmax == hmin).to(torch.float32).reshape(())
    return dense, idx, agree, bits


def _leaf_sync_topk(flat: torch.Tensor, keep: int, world: int, want_surplus: bool = False,
                    group=None):
    mag = flat.abs().to(torch.float32)
    t = kernels.topk_threshold(mag, keep)
    payload, idx, count = _select_pack(flat, mag, t, keep)
    bits = _payload_bits(payload, idx)
    dense = _scatter_combine(flat.shape[0], (), flat.dtype, mesh.all_gather(idx, group),
                             mesh.all_gather(payload, group), world)
    # above-threshold survivors past `keep` (ties at the threshold's
    # resolution) are cut by ascending index: with EF off they are dropped
    surplus = torch.clamp(count - keep, min=0) if want_surplus else None
    return dense, idx, surplus, bits


def _leaf_sync_topk_seg(flat: torch.Tensor, keep: int, world: int, want_ef: bool,
                        group=None):
    """Element Top-K through the segmented pack (``kernels.use_seg_pack``):
    the kernel writes each 4096-element segment's first <= 128 survivors and
    the EF residual in one pass, and :func:`kernels.seg_pack_payload` joins
    the segments' prefixes into ``keep`` slots.  The selection differs from
    :func:`_leaf_sync_topk` only where a segment holds more than 128
    survivors: the overflow stays in the residual and later survivors take
    the freed slots.  ``(dense, new_ef, sent_count, bits, dropped)``:
    ``sent_count = min(sum elig, keep)`` and ``dropped`` (survivors that did
    not travel) are 0-d device tensors; the dense combine adds the gathered
    ``[W * keep]`` payload in one ``index_add_``, as the JAX path's one
    scatter does."""
    mag = flat.abs().to(torch.float32)
    t = kernels.topk_threshold(mag, keep)
    vals, idx, new_ef, elig, counts = kernels.seg_pack_by_threshold(
        flat.to(torch.float32).contiguous(), t, keep, want_ef=want_ef)
    pvals, pidx = kernels.seg_pack_payload(vals, idx, elig, keep)
    pvals = pvals.to(flat.dtype)
    bits = _payload_bits(pvals, pidx)
    g_vals, g_idx = mesh.all_gather(pvals, group), mesh.all_gather(pidx, group)
    dense = torch.zeros_like(flat).index_add_(0, g_idx.reshape(-1).long(),
                                              g_vals.reshape(-1)) / world
    sent_count = torch.clamp(elig.sum(dtype=torch.int32), max=keep)
    dropped = counts.sum(dtype=torch.int32) - sent_count
    return dense, new_ef, sent_count, bits, dropped


def _leaf_sync_blocktopk(flat: torch.Tensor, keep_blocks: int, block_size: int, world: int,
                         want_ef: bool, group=None):
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
                             mesh.all_gather(bidx.to(torch.int32), group),
                             mesh.all_gather(payload, group), world).reshape(-1)[:n]
    new_ef = g2.index_fill(0, bidx, 0.0).reshape(-1)[:n] if want_ef else None
    return dense, new_ef, bits


def _leaf_sync_threshold(flat: torch.Tensor, v: torch.Tensor, cap: int, world: int,
                         want_ef: bool, group=None):
    """The first ``cap`` survivors of ``|flat| >= v`` by ascending index in a
    fixed buffer, zero-padded; ``(dense, new_ef, sent_count, overflow,
    bits)`` with ``sent_count`` and ``overflow`` as 0-d device tensors."""
    vals, idx, count = _select_pack(flat, flat.abs(), v, cap)
    sent_count = torch.clamp(count, max=cap)
    valid = torch.arange(1, cap + 1, dtype=torch.int32, device=flat.device) <= sent_count
    vals = torch.where(valid, vals, 0.0)
    idx = torch.where(valid, idx, 0)
    bits = _payload_bits(vals, idx)                      # the whole cap-sized buffer
    dense = _scatter_combine(flat.shape[0], (), flat.dtype, mesh.all_gather(idx, group),
                             mesh.all_gather(vals, group), world)
    new_ef = None
    if want_ef:
        # zero exactly the sent coordinates: padded slots multiply
        # coordinate 0 by 1
        new_ef = flat.clone().scatter_reduce_(0, idx.long(), torch.where(valid, 0.0, 1.0),
                                              reduce="prod")
    overflow = torch.clamp(count - cap, min=0)
    return dense, new_ef, sent_count, overflow, bits


def _shard_plan(cfg, n_units: int, keep: int, world: int, unit_size: int):
    from tpu_compressed_dp_torch.ops import wire_sharded

    return wire_sharded.make_shard_plan(n_units, keep, world, unit_size,
                                        cfg.shard_route_factor, cfg.shard_return_factor)


def _hier_combine(contrib: torch.Tensor, keep: int, world: int, cfg, group=None):
    """Two-level (ICI x DCN) exchange of one group's compressed-dense
    contribution ``contrib`` (this worker's selection scattered into zeros)
    over the ``dp_pods x chips`` view of ``group``'s workers:

      1. one dense sum of ``contrib`` over this rank's pod (ICI);
      2. recompress: the pod sum's nonzero union, ascending, in a
         ``cap_union`` buffer; chip ``c`` of every pod carries slab ``c``;
      3. the slabs ride :func:`~tpu_compressed_dp_torch.ops.wire_sharded.
         sharded_combine` over this rank's DCN column (``pods`` senders);
      4. a second dense pod sum adds the chips' disjoint-slab partials.

    Returns ``(total, ef_extra, bits_ici, bits_dcn_route, bits_dcn_ret,
    overflow)``: ``total`` is the sum over ALL workers of what they
    transmitted (the caller divides by the world); ``ef_extra`` this
    worker's refund of what was clipped after its pod sum (a union clip
    refunds ``pod_sum / chips`` on every chip of the pod, a DCN clip the
    full pod value on the one chip whose slab carried it); ``overflow`` the
    union clips (chip-rank 0 only, so each pod counts once) plus the DCN
    exchange's clips."""
    from tpu_compressed_dp_torch.ops import wire_sharded

    n = contrib.shape[0]
    dev = contrib.device
    plan = wire_sharded.make_hier_plan(n, keep, world, cfg.dp_pods,
                                       cfg.hier_route_factor_ici, cfg.hier_route_factor_dcn)
    P, C = plan.pods, plan.chips
    ici_group, dcn_group = mesh.hier_groups(world, P, group)
    zero_ovf = torch.zeros((), dtype=torch.int32, device=dev)
    with obs_trace.phase("ici_reduce"):
        if C > 1:
            pod_sum = mesh.all_reduce_sum(contrib, ici_group)
            bits_ici = _payload_bits(contrib)
        else:
            pod_sum, bits_ici = contrib, 0.0
    if P == 1:
        # one pod: the ICI sum above already reduced the whole world
        return pod_sum, torch.zeros_like(contrib), bits_ici, 0.0, 0.0, zero_ovf

    c_rank = mesh.group_rank(group) % C
    with obs_trace.phase("recompress"):
        s_vals, s_idx, s_valid, union_clip, nnz = hier_recompress(pod_sum, plan, c_rank)

    dense_u, sent, route_bits, ret_bits, dcn_overflow = wire_sharded.sharded_combine(
        s_vals, s_idx, plan.dcn, valid=s_valid, group=dcn_group)
    partial = dense_u[:n]
    with obs_trace.phase("ici_reduce"):
        if C > 1:
            total = mesh.all_reduce_sum(partial, ici_group)
            bits_ici += _payload_bits(partial)
        else:
            total = partial
    # DCN clips: only this chip's slab carried these units for its pod
    slice_refund = torch.zeros(n, dtype=contrib.dtype, device=dev).index_add_(
        0, s_idx.long(), torch.where(s_valid & ~sent, s_vals, 0.0))
    ef_extra = union_clip + slice_refund
    union_clipped = torch.clamp(nnz - plan.cap_union, min=0) if c_rank == 0 else zero_ovf
    return total, ef_extra, bits_ici, route_bits, ret_bits, dcn_overflow + union_clipped


def hier_recompress(pod_sum: torch.Tensor, plan, c_rank: int):
    """The hierarchical transport's recompress: the pod sum's nonzero union,
    ascending, in a ``cap_union`` buffer, and chip ``c_rank``'s slab of it.
    Returns ``(s_vals, s_idx, s_valid, union_clip, nnz)``: the slab, this
    chip's refund of the union coordinates past ``cap_union`` (the clip is
    the same on every chip of the pod, so each refunds 1/C of the pod
    value) and the union's size."""
    n, dev = pod_sum.shape[0], pod_sum.device
    cap = plan.cap_union
    mask = pod_sum != 0
    nnz = mask.sum(dtype=torch.int32)
    uidx = packed_indices_from_mask(mask, cap)
    uvalid = (torch.arange(1, cap + 1, dtype=torch.int32, device=dev)
              <= torch.clamp(nnz, max=cap))
    uvals = torch.where(uvalid, pod_sum.index_select(0, uidx.long()), 0.0)
    uidx = torch.where(uvalid, uidx, 0)
    taken = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, uidx.long(), uvalid.to(torch.int32)) > 0
    union_clip = torch.where(mask & ~taken, pod_sum, 0.0) / plan.chips
    sl = slice(c_rank * plan.slab, (c_rank + 1) * plan.slab)
    return uvals[sl], uidx[sl], uvalid[sl], union_clip, nnz


def _leaf_sync_topk_sharded(flat: torch.Tensor, keep: int, world: int, cfg, want_ef: bool,
                            group=None):
    """Top-K over the owner-sharded transport: the allgather path's
    selection, with the pairs routed to their shard owners.  Route and
    return clips stay in the EF residual (or are dropped, EF off)."""
    from tpu_compressed_dp_torch.ops import wire_sharded

    n = flat.shape[0]
    mag = flat.abs().to(torch.float32)
    t = kernels.topk_threshold(mag, keep)
    vals, idx, count = _select_pack(flat, mag, t, keep)
    plan = _shard_plan(cfg, n, keep, world, 1)
    dense_u, sent, route_bits, ret_bits, overflow = wire_sharded.sharded_combine(
        vals, idx, plan, group=group)
    dense = (dense_u[:n] / world).to(flat.dtype)
    new_ef = None
    if want_ef:
        # zero exactly the coordinates the synced gradient holds; a clipped
        # survivor keeps its value (set, not multiply: inf * 0 is NaN)
        new_ef = flat.index_copy(0, idx.long(), torch.where(sent, 0.0, vals))
    # EF off: survivors past keep (threshold ties) are a selection drop,
    # reported apart from the transport's clips
    surplus = None if want_ef else torch.clamp(count - keep, min=0)
    # sent_elems: the coordinates the synced gradient holds
    sent_count = sent.sum(dtype=torch.int32)
    return dense, new_ef, sent_count, route_bits + ret_bits, route_bits, overflow, surplus


def _leaf_sync_blocktopk_sharded(flat: torch.Tensor, keep_blocks: int, block_size: int,
                                 world: int, cfg, want_ef: bool, group=None):
    """Block-Top-K over the owner-sharded transport: whole ``[block_size]``
    rows route to the owners of their block-index shard (the scatter build;
    the bucket-route kernel is element-granular)."""
    from tpu_compressed_dp_torch.ops import wire_sharded

    n = flat.shape[0]
    scores = compressors.blocktopk_scores(flat, block_size)
    t = kernels.topk_threshold(scores, keep_blocks)
    # scores are non-negative: they serve as their own magnitudes
    bidx = _select_pack(scores, scores, t, keep_blocks)[1]
    g2 = compressors.blocktopk_blocks(flat, block_size)   # [nb, bs]
    payload = g2.index_select(0, bidx.long())             # [kb, bs]
    plan = _shard_plan(cfg, g2.shape[0], keep_blocks, world, block_size)
    dense_u, sent, route_bits, ret_bits, overflow = wire_sharded.sharded_combine(
        payload, bidx, plan, group=group)
    dense = (dense_u / world).to(flat.dtype).reshape(-1)[:n]
    new_ef = None
    if want_ef:
        new_ef = g2.index_copy(0, bidx.long(),
                               torch.where(sent[:, None], 0.0, payload)).reshape(-1)[:n]
    # blocks that reached the synced gradient, in elements (whole rows)
    sent_count = sent.sum(dtype=torch.int32) * block_size
    return dense, new_ef, sent_count, route_bits + ret_bits, route_bits, overflow


def _leaf_sync_threshold_sharded(flat: torch.Tensor, v: torch.Tensor, cap: int, world: int,
                                 cfg, want_ef: bool, group=None):
    """Threshold-V's fixed-capacity buffer over the owner-sharded transport:
    the zero-padded tail routes to the dump destination.  The capacity
    overflow and the transport's clips are returned apart: they size
    different knobs."""
    from tpu_compressed_dp_torch.ops import wire_sharded

    vals, idx, count = _select_pack(flat, flat.abs(), v, cap)
    sent_count = torch.clamp(count, max=cap)
    valid = torch.arange(1, cap + 1, dtype=torch.int32, device=flat.device) <= sent_count
    vals = torch.where(valid, vals, 0.0)
    plan = _shard_plan(cfg, flat.shape[0], cap, world, 1)
    dense_u, sent, route_bits, ret_bits, overflow = wire_sharded.sharded_combine(
        vals, idx, plan, valid=valid, group=group)
    dense = (dense_u[:flat.shape[0]] / world).to(flat.dtype)
    new_ef = None
    if want_ef:
        # multiply: the padded tail slots (index 0, factor 1) are identities
        new_ef = flat.clone().scatter_reduce_(0, idx.long(), torch.where(sent, 0.0, 1.0),
                                              reduce="prod")
    cap_overflow = torch.clamp(count - cap, min=0)
    return (dense, new_ef, sent.sum(dtype=torch.int32), route_bits + ret_bits, route_bits,
            cap_overflow, overflow)


def _leaf_sync_topk_hier(flat: torch.Tensor, keep: int, world: int, cfg, want_ef: bool,
                         group=None):
    """Top-K over the hierarchical transport: the flat transports' selection,
    scattered dense into :func:`_hier_combine`.  EF is everything unselected
    plus the combine's clip refunds."""
    mag = flat.abs().to(torch.float32)
    t = kernels.topk_threshold(mag, keep)
    vals, idx, count = _select_pack(flat, mag, t, keep)
    contrib = torch.zeros_like(flat).index_copy_(0, idx.long(), vals)
    total, ef_extra, b_ici, b_rt, b_ret, overflow = _hier_combine(contrib, keep, world, cfg,
                                                                  group)
    dense = (total / world).to(flat.dtype)
    new_ef = (flat - contrib + ef_extra) if want_ef else None
    surplus = None if want_ef else torch.clamp(count - keep, min=0)
    return dense, new_ef, (b_ici, b_rt, b_ret), overflow, surplus


def _leaf_sync_blocktopk_hier(flat: torch.Tensor, keep_blocks: int, block_size: int,
                              world: int, cfg, want_ef: bool, group=None):
    """Block-Top-K over the hierarchical transport: the selected blocks
    scatter dense, and the pod sum recompresses element by element."""
    n = flat.shape[0]
    scores = compressors.blocktopk_scores(flat, block_size)
    t = kernels.topk_threshold(scores, keep_blocks)
    bidx = _select_pack(scores, scores, t, keep_blocks)[1].long()
    g2 = compressors.blocktopk_blocks(flat, block_size)   # [nb, bs]
    payload = g2.index_select(0, bidx)                    # [kb, bs]
    contrib = torch.zeros_like(g2).index_copy_(0, bidx, payload).reshape(-1)[:n]
    total, ef_extra, b_ici, b_rt, b_ret, overflow = _hier_combine(
        contrib, min(keep_blocks * block_size, n), world, cfg, group)
    dense = (total / world).to(flat.dtype)
    new_ef = (flat - contrib + ef_extra) if want_ef else None
    return dense, new_ef, (b_ici, b_rt, b_ret), overflow


def _leaf_sync_threshold_hier(flat: torch.Tensor, v: torch.Tensor, cap: int, world: int,
                              cfg, want_ef: bool, group=None):
    """Threshold-V's fixed-capacity buffer over the hierarchical transport:
    the capacity clip never enters ``contrib`` (it stays in the base
    residual); the transport's clips refund through :func:`_hier_combine`."""
    vals, idx, count = _select_pack(flat, flat.abs(), v, cap)
    sent_count = torch.clamp(count, max=cap)
    valid = torch.arange(1, cap + 1, dtype=torch.int32, device=flat.device) <= sent_count
    vals = torch.where(valid, vals, 0.0)
    idx = torch.where(valid, idx, 0)
    # add, not copy: the padded tail slots all alias coordinate 0
    contrib = torch.zeros_like(flat).index_add_(0, idx.long(), vals)
    total, ef_extra, b_ici, b_rt, b_ret, overflow = _hier_combine(contrib, cap, world, cfg,
                                                                  group)
    dense = (total / world).to(flat.dtype)
    new_ef = (flat - contrib + ef_extra) if want_ef else None
    cap_overflow = torch.clamp(count - cap, min=0)
    return dense, new_ef, sent_count, (b_ici, b_rt, b_ret), cap_overflow, overflow


def _leaf_sync_terngrad(flat: torch.Tensor, seed: int, chunk: int, world: int, group=None):
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
    g_levels = unpack_ternary(mesh.all_gather(packed, group), n).to(flat.dtype)   # [W, n]
    g_scale = mesh.all_gather(scale, group)               # [W] or [W, nc]
    if scale.dim() == 0:
        return (g_scale[:, None] * g_levels).sum(0) / world, bits
    # chunked scales: each worker's [nc] scales over its chunks
    nc = scale.shape[0]
    lv = torch.nn.functional.pad(g_levels, (0, nc * chunk - n)).reshape(-1, nc, chunk)
    return (g_scale[:, :, None] * lv).sum(0).reshape(-1)[:n] / world, bits


def _leaf_sync_qsgd(flat: torch.Tensor, seed: int, qstates: int, world: int, group=None):
    n = flat.shape[0]
    if 127 < qstates <= 255 and kernels.use_quant_pack(n, flat.device):
        # the byte-magnitude + sign-bitmap layout, straight from the kernel
        mags, signs, scale = kernels.qsgd_pack(flat, seed, qstates=qstates)
        payload = (mags, signs)
    else:
        levels, scale = compressors.qsgd_levels(flat, seed, qstates=qstates)
        payload = qsgd_wire_pack(levels, qstates)
    bits = _payload_bits(*payload, scale)
    g_levels = qsgd_wire_unpack(tuple(mesh.all_gather(p, group) for p in payload), n, qstates,
                                dtype=flat.dtype)
    g_scale = mesh.all_gather(scale, group)               # [W]
    return (g_scale[:, None] * g_levels).sum(0) / world, bits


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def make_wire_grad_sync(cfg, group_offset: int = 0, group=None):
    """Build ``sync(grads, ef, seed) -> (synced, new_ef, stats)`` over the
    workers of ``group`` (``None``: the default process group), with the
    contract of the simulate sync in
    :func:`tpu_compressed_dp_torch.parallel.dp.make_grad_sync` (which
    dispatches here for ``mode='wire'``), ``group_offset`` and ``group``
    included.  The stat keys are the JAX wire
    engine's for the same method and transport: the ``sent_bits*`` split,
    ``sent_elems``, ``dense_elems``, ``num_collectives``, plus
    ``sync_agree`` (Random-K with ``check_sync``), ``threshold_overflow``
    (the threshold methods), ``topk_surplus_dropped`` (Top-K without EF) and
    ``shard_overflow`` (the sharded and hierarchical transports)."""
    from tpu_compressed_dp_torch.parallel.dp import (BUCKET_MB, group_concat, group_split,
                                                     make_leaf_groups, wire_transport)

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
        """``(dense, new_ef, sent, bits, bits_route, agree, overflows,
        fabric)``: ``sent`` is a Python float, or a 0-d tensor where it
        depends on the data; ``bits`` is measured from the payload tensors,
        ``bits_route`` its all_to_all share (sharded groups, else 0);
        ``fabric`` is None but for hierarchical groups, whose bits split
        ``(ici, dcn_route, dcn_return)``."""
        acc = flat + ef_flat if ef_flat is not None else flat
        n = flat.shape[0]
        want_ef = ef_flat is not None
        if n > (1 << 31) - 1 and comp.name not in ("terngrad", "qsgd"):
            raise ValueError(f"wire-mode {comp.name} group of {n} elements exceeds the int32 "
                             "index range; use granularity='bucketed' or 'layerwise'")
        keep = leaf_keep(n)
        # at world 1 there is nothing to owner-reduce: both transports
        # degrade to the allgather combine, the same arithmetic
        transport = wire_transport(comp.name, n, cfg)
        sharded = transport == "sharded" and world > 1
        hier = transport == "hierarchical" and world > 1
        if comp.name in ("thresholdv", "adaptive_threshold"):
            v = (torch.full((), threshold32, device=acc.device) if comp.name == "thresholdv"
                 else acc.abs().max() * 0.5)
            if hier:
                dense, new_ef, sent, fabric, cap_ovf, shard_ovf = _leaf_sync_threshold_hier(
                    acc, v, keep, world, cfg, want_ef, group)
                return (dense, new_ef, sent.to(torch.float32), sum(fabric), 0.0, None,
                        {"threshold_overflow": cap_ovf, "shard_overflow": shard_ovf}, fabric)
            if sharded:
                (dense, new_ef, sent, bits, bits_route, cap_ovf,
                 shard_ovf) = _leaf_sync_threshold_sharded(acc, v, keep, world, cfg, want_ef,
                                                              group)
                return (dense, new_ef, sent.to(torch.float32), bits, bits_route, None,
                        {"threshold_overflow": cap_ovf, "shard_overflow": shard_ovf}, None)
            dense, new_ef, sent, overflow, bits = _leaf_sync_threshold(acc, v, keep, world,
                                                                       want_ef, group)
            return (dense, new_ef, sent.to(torch.float32), bits, 0.0, None,
                    {"threshold_overflow": overflow}, None)
        agree, idx = None, None
        if comp.name == "randomk":
            dense, idx, agree, bits = _leaf_sync_randomk(acc, seed, keep, world, cfg.check_sync,
                                                       group)
        elif comp.name == "topk":
            if hier:
                dense, new_ef, fabric, overflow, surplus = _leaf_sync_topk_hier(
                    acc, keep, world, cfg, want_ef, group)
                ovf = {"shard_overflow": overflow}
                if surplus is not None:
                    ovf["topk_surplus_dropped"] = surplus
                return dense, new_ef, float(keep), sum(fabric), 0.0, None, ovf, fabric
            if sharded:
                (dense, new_ef, sent, bits, bits_route, overflow,
                 surplus) = _leaf_sync_topk_sharded(acc, keep, world, cfg, want_ef, group)
                ovf = {"shard_overflow": overflow}
                if surplus is not None:
                    ovf["topk_surplus_dropped"] = surplus
                return dense, new_ef, sent.to(torch.float32), bits, bits_route, None, ovf, None
            if kernels.use_seg_pack(n, keep, acc.device):
                # the segmented pack's fused EF assumes every packed slot
                # travels: an allgather contract, so the transports above
                # keep their own packs
                dense, new_ef, sent, bits, dropped = _leaf_sync_topk_seg(acc, keep, world,
                                                                         want_ef, group)
                return (dense, new_ef, sent.to(torch.float32), bits, 0.0, None,
                        {} if want_ef else {"topk_surplus_dropped": dropped}, None)
            dense, idx, surplus, bits = _leaf_sync_topk(acc, keep, world,
                                                        want_surplus=not want_ef, group=group)
            if surplus is not None:
                return (dense, None, float(keep), bits, 0.0, None,
                        {"topk_surplus_dropped": surplus}, None)
        elif comp.name == "blocktopk":
            bs = cfg.block_size
            if keep >= n:
                # every block kept: the dense all-reduce, never more bytes
                # than the dense tensor
                dense = acc.clone()
                bits = _payload_bits(acc)
                if world > 1:
                    dist.all_reduce(dense, group=group)
                dense = dense / world
                new_ef = torch.zeros_like(acc) if want_ef else None
            elif hier:
                dense, new_ef, fabric, overflow = _leaf_sync_blocktopk_hier(
                    acc, keep // bs, bs, world, cfg, want_ef, group)
                return (dense, new_ef, float(keep), sum(fabric), 0.0, None,
                        {"shard_overflow": overflow}, fabric)
            elif sharded:
                dense, new_ef, sent, bits, bits_route, overflow = _leaf_sync_blocktopk_sharded(
                    acc, keep // bs, bs, world, cfg, want_ef, group)
                return (dense, new_ef, sent.to(torch.float32), bits, bits_route, None,
                        {"shard_overflow": overflow}, None)
            else:
                dense, new_ef, bits = _leaf_sync_blocktopk(acc, keep // bs, bs, world, want_ef,
                                                           group)
            return dense, new_ef, float(keep), bits, 0.0, None, {}, None
        elif comp.name == "terngrad":
            dense, bits = _leaf_sync_terngrad(acc, seed, cfg.resolved_terngrad_chunk, world,
                                              group)
        else:  # qsgd
            dense, bits = _leaf_sync_qsgd(acc, seed, cfg.qstates, world, group)
        # the EF residual is the coordinates that did not travel (EF is
        # refused with the quantizers, so idx is a sparsifier's)
        new_ef = acc.index_fill(0, idx.long(), 0.0) if want_ef else None
        return dense, new_ef, float(keep), bits, 0.0, agree, {}, None

    def sync(grads: Tree, ef: Any, seed: int) -> Tuple[Tree, Any, Dict[str, torch.Tensor]]:
        world = mesh.size(group)
        rank = mesh.group_rank(group) if per_worker_rng else None
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
        bits = bits_psum = bits_ag = bits_a2a = 0.0
        bits_ici = bits_dcn = bits_dcn_route = dense_total = 0.0
        for gi, idxs in enumerate(groups):
            flat = group_concat(names, leaves, idxs)
            with obs_trace.phase("ef"):
                ef_flat = group_concat(names, ef_leaves, idxs) if use_ef else None
            # one range over the whole wire group sync (select + pack +
            # combine): the sharded transport's route/reduce/return ranges
            # nest inside it
            with obs_trace.phase("compress"):
                (dense, new_ef_flat, sent_leaf, bits_leaf, bits_route, agree,
                 leaf_overflows, fabric) = sync_flat(
                    flat, ef_flat, compressors.leaf_seed(seed, group_offset + gi, rank),
                    world)
            # the collectives this group's payload rode: a sharded group's
            # route on the all_to_all and its return on an all_gather; a
            # hierarchical group's bits per fabric only
            transport = wire_transport(comp.name, flat.shape[0], cfg)
            if fabric is not None:
                f_ici, f_rt, f_ret = fabric
                bits_ici += f_ici
                bits_dcn += f_rt + f_ret
                bits_dcn_route += f_rt
            elif transport == "psum":
                bits_psum += bits_leaf
            elif transport == "sharded" and world > 1:
                bits_a2a += bits_route
                bits_ag += bits_leaf - bits_route
            else:
                bits_ag += bits_leaf
            with obs_trace.phase("return"):
                group_split(dense, names, leaves, idxs, out_leaves)
                if use_ef:
                    group_split(new_ef_flat, names, leaves, idxs, new_ef_leaves,
                                dtype=torch.float32)
            if agree is not None:
                agrees.append(agree)
            for k, v in leaf_overflows.items():
                overflows.setdefault(k, []).append(v)
            sent = sent + sent_leaf          # a device tensor where it depends on the data
            bits += bits_leaf
            dense_total += float(flat.shape[0])

        def f32(v) -> torch.Tensor:
            if isinstance(v, torch.Tensor):
                return v.to(torch.float32)
            return torch.full((), float(v), dtype=torch.float32, device=device)

        stats = {
            "sent_elems": f32(sent),
            "sent_bits": f32(bits),
            "sent_bits_psum": f32(bits_psum),
            "sent_bits_allgather": f32(bits_ag),
            "sent_bits_alltoall": f32(bits_a2a),
            "sent_bits_ici": f32(bits_ici),
            "sent_bits_dcn": f32(bits_dcn),
            "sent_bits_dcn_route": f32(bits_dcn_route),
            "dense_elems": f32(dense_total),
            "num_collectives": f32(len(groups)),
        }
        if agrees:
            stats["sync_agree"] = torch.stack(agrees).min()
        for k, vs in overflows.items():
            # threshold_overflow: survivors clipped by the capacity;
            # topk_surplus_dropped: survivors past keep, dropped with EF off;
            # shard_overflow: the sharded/hierarchical transport's clips
            stats[k] = torch.stack(vs).sum().to(torch.float32)
        out = dict(zip(names, out_leaves))
        new_ef = dict(zip(names, new_ef_leaves)) if use_ef else ()
        return out, new_ef, stats

    return sync
