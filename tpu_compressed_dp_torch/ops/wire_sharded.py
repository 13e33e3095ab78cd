"""Owner-sharded sparse-allreduce transport for index-carrying wire payloads.

PyTorch counterpart of :mod:`tpu_compressed_dp.ops.wire_sharded`.  The flat
``all_gather`` combine (``ops/wire.py``) ships every worker's ``(value,
index)`` pairs to every worker: ``O(W*k)`` per worker.  ``transport='sharded'``
replaces it with a sparse reduce-scatter-then-allgather (the OKTopk regime):

  1. **route**: the group's flat unit space (elements, or whole blocks for
     Block-Top-K) is cut into ``W`` contiguous owner shards of ``ceil(n/W)``
     units; each worker drops its pairs into fixed-capacity per-destination
     buckets (``cap_dest`` slots, value 0 / index ``shard_n`` padding) and one
     ``all_to_all`` delivers bucket ``j`` to owner ``j``.  Pairs past a
     bucket's capacity are clipped: they stay in the EF residual (EF on) or
     are dropped and counted in ``shard_overflow``;
  2. **reduce**: the owner adds the ``W*cap_dest`` received pairs into its
     dense shard, one rank row after another in rank order;
  3. **return**: the reduced shard travels back through one ``all_gather``,
     dense (``n*32/W`` bits, lossless) or as the compacted sparse union in a
     ``cap_ret`` buffer, whichever is no bigger.  Units the return clips are
     refunded to every contributor's EF residual.

``transport='hierarchical'`` views the world as ``pods x chips`` and runs
this exchange across pods only (:class:`HierPlan`, ``ops/wire.py``'s
``_hier_combine``).  The geometry below is a plain copy of the JAX
module's; the capacities are static, so the billed bits are too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from tpu_compressed_dp_torch.obs import trace as obs_trace
from tpu_compressed_dp_torch.ops import kernels, wire
from tpu_compressed_dp_torch.parallel import mesh

__all__ = ["ShardPlan", "make_shard_plan", "sharded_payload_bits",
           "sharded_combine", "owner_of_unit", "owner_bounds",
           "SHARDED_METHODS", "HierPlan", "make_hier_plan",
           "hier_axis_groups", "hier_payload_bits"]

# The wire methods whose payloads carry explicit indices and so have a
# sharded form; quantizers and the psum riders keep their transports.
SHARDED_METHODS = ("topk", "blocktopk", "thresholdv", "adaptive_threshold")


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Static geometry of one group's sharded combine.  ``n_units``/``keep``
    count units: elements, or whole blocks for Block-Top-K
    (``unit_size > 1``)."""

    n_units: int       # units in the group's flat space
    keep: int          # payload slots per worker (k, kb, or the cap)
    world: int         # W
    unit_size: int     # elements per unit (1, or block_size)
    shard_n: int       # units per owner shard (ceil(n_units / W))
    cap_dest: int      # route: slots per destination bucket
    cap_ret: int       # return: sparse-union buffer capacity per owner
    dense_return: bool # return the dense shard instead of the sparse union


def make_shard_plan(n_units: int, keep: int, world: int, unit_size: int,
                    route_factor: float, return_factor: float) -> ShardPlan:
    """Size one group's fixed-capacity buffers: ``cap_dest = route_factor *
    keep / W``, ``cap_ret = return_factor * keep / W``, each clamped to its
    lossless bound; the dense shard returns whenever it bills no more than
    the sparse union (``wire_sharded.py:90-115`` of the JAX package)."""
    shard_n = -(-n_units // world)
    cap_dest = max(1, -(-int(round(route_factor * keep)) // world))
    cap_dest = min(cap_dest, shard_n, max(keep, 1))
    cap_ret = max(1, -(-int(round(return_factor * keep)) // world))
    cap_ret = min(cap_ret, world * cap_dest, shard_n)
    # sparse unit = unit_size values + 1 index word; dense unit = unit_size
    # values; dense wins a tie (it is lossless)
    sparse_bits = cap_ret * 32 * (unit_size + 1)
    dense_bits = shard_n * 32 * unit_size
    return ShardPlan(n_units, keep, world, unit_size, shard_n, cap_dest,
                     cap_ret, dense_bits <= sparse_bits)


def owner_of_unit(unit: int, plan: ShardPlan) -> int:
    """The worker that owns flat unit ``unit``: ``min(u // shard_n, W - 1)``,
    the routing rule of :func:`sharded_combine`."""
    if not 0 <= unit < plan.n_units:
        raise ValueError(f"unit {unit} outside [0, {plan.n_units})")
    return min(unit // plan.shard_n, plan.world - 1)


def owner_bounds(plan: ShardPlan) -> Tuple[Tuple[int, int], ...]:
    """Per-owner half-open ``(lo, hi)`` unit ranges in owner order; they tile
    ``[0, n_units)`` exactly at every world size (the last owners may hold
    short or empty shards)."""
    bounds = []
    for w in range(plan.world):
        lo = min(w * plan.shard_n, plan.n_units)
        hi = plan.n_units if w == plan.world - 1 else min(
            (w + 1) * plan.shard_n, plan.n_units)
        bounds.append((lo, hi))
    return tuple(bounds)


def sharded_payload_bits(n_units: int, keep: int, world: int, unit_size: int,
                         route_factor: float, return_factor: float
                         ) -> Tuple[float, float]:
    """Analytic ``(route_bits, return_bits)`` per worker for one group: the
    bits of the fp32/int32 buffers :func:`sharded_combine` hands to its
    ``all_to_all`` and ``all_gather``."""
    p = make_shard_plan(n_units, keep, world, unit_size, route_factor,
                        return_factor)
    route = float(p.world * p.cap_dest * 32 * (unit_size + 1))
    if p.dense_return:
        ret = float(p.shard_n * 32 * unit_size)
    else:
        ret = float(p.cap_ret * 32 * (unit_size + 1))
    return route, ret


@dataclasses.dataclass(frozen=True)
class HierPlan:
    """Static geometry of one group's two-level combine: a ``pods x chips``
    view of the world, dense psums inside each pod (ICI) and the sharded
    exchange across pods (DCN)."""

    n: int          # elements in the group's flat space
    keep: int       # per-worker selection size (elements)
    world: int      # W = pods * chips
    pods: int       # P
    chips: int      # C
    cap_union: int  # recompress: pod-union buffer capacity (multiple of C)
    slab: int       # cap_union // chips: one chip's slice of the union
    dcn: ShardPlan  # the inter-pod exchange (world=pods, keep=slab)


def hier_axis_groups(world: int, pods: int):
    """The ICI groups (one per pod, ``chips`` contiguous ranks: rank ``g`` in
    pod ``g // chips`` at chip-rank ``g % chips``) and the DCN groups (one per
    chip-rank, the rank-``c`` column across pods), as rank lists."""
    if world % pods:
        raise ValueError(
            f"dp_pods={pods} must divide the dp world size {world} "
            "(the virtual mesh is pods x chips with no ragged pod)")
    chips = world // pods
    ici = [[p * chips + c for c in range(chips)] for p in range(pods)]
    dcn = [[p * chips + c for p in range(pods)] for c in range(chips)]
    return ici, dcn


def make_hier_plan(n: int, keep: int, world: int, pods: int,
                   route_factor_ici: float, route_factor_dcn: float
                   ) -> HierPlan:
    """Size one group's hierarchical buffers: the pod-union capacity
    ``route_factor_ici * keep``, rounded up to a multiple of ``chips`` and
    clamped to the chip-rounded group size, and an ordinary
    :class:`ShardPlan` over ``pods`` senders of one ``slab`` each."""
    if world % pods:
        raise ValueError(
            f"dp_pods={pods} must divide the dp world size {world}")
    chips = world // pods
    cap = max(chips, int(round(route_factor_ici * max(keep, 1))))
    cap = -(-cap // chips) * chips
    cap = min(cap, -(-n // chips) * chips)
    slab = cap // chips
    dcn = make_shard_plan(n, slab, pods, 1, route_factor_dcn,
                          route_factor_dcn)
    return HierPlan(n, keep, world, pods, chips, cap, slab, dcn)


def hier_payload_bits(n: int, keep: int, world: int, pods: int,
                      route_factor_ici: float, route_factor_dcn: float
                      ) -> Tuple[float, float, float]:
    """Analytic ``(ici_bits, dcn_route_bits, dcn_return_bits)`` per worker
    for one hierarchical group: two dense pod psums on ICI (none when each
    pod is one chip, one when there is one pod), and the slab's sharded
    route and return on DCN."""
    p = make_hier_plan(n, keep, world, pods, route_factor_ici,
                       route_factor_dcn)
    if p.pods == 1:
        return (float(n * 32) if p.chips > 1 else 0.0), 0.0, 0.0
    ici = float(2 * n * 32) if p.chips > 1 else 0.0
    route = float(p.dcn.world * p.dcn.cap_dest * 32 * 2)
    if p.dcn.dense_return:
        ret = float(p.dcn.shard_n * 32)
    else:
        ret = float(p.dcn.cap_ret * 32 * 2)
    return ici, route, ret


def _per_dest_slots(idx: torch.Tensor, valid: Optional[torch.Tensor], plan: ShardPlan):
    """``(slot, accepted, dest)``: each payload slot's position in the flat
    ``[W*cap_dest]`` bucket buffer (clipped and invalid slots at the dump
    slot ``W*cap_dest``), whether it was accepted, and its destination
    (:func:`~tpu_compressed_dp_torch.ops.kernels.route_slots`; invalid slots,
    a zero-padded tail, go to the dump destination ``W``)."""
    return kernels.route_slots(idx, valid, plan.world, plan.cap_dest, plan.shard_n)


def sharded_combine(vals: torch.Tensor, idx: torch.Tensor, plan: ShardPlan,
                    valid: Optional[torch.Tensor] = None, group=None):
    """Route -> owner-reduce -> return one group's ``(values, indices)``
    payload over ``group`` (the default group, or a DCN column of the
    hierarchical transport, whose size is ``plan.world``).

    ``vals``: ``[keep]`` (element units) or ``[keep, unit_size]`` (block
    units); ``idx``: ``[keep]`` ascending int32 unit indices; ``valid``: an
    optional ``[keep]`` bool prefix marking real slots.

    Returns ``(dense_units, sent, route_bits, return_bits, overflow)``: the
    sum over the group's workers on the padded unit space ``[W*shard_n(,
    unit_size)]``; ``[keep]`` bool, the slots routed AND returned (the rest
    belong in the EF residual); the measured bits handed to the
    ``all_to_all`` and the ``all_gather``; and this worker's route clips
    plus this owner's return clips (int32, 0-d).  The three stages are
    :func:`route_stage`, :func:`reduce_stage` and :func:`return_stage`
    (``bench/phases.py`` times them one by one)."""
    with obs_trace.phase("route"):
        rvals, ridx, accepted, route_bits = route_stage(vals, idx, plan, valid, group)
    with obs_trace.phase("reduce"):
        shard, occ = reduce_stage(rvals, ridx, plan)
    n_valid = (valid.sum(dtype=torch.int32) if valid is not None
               else torch.full((), idx.shape[0], dtype=torch.int32, device=vals.device))
    route_overflow = n_valid - accepted.sum(dtype=torch.int32)
    with obs_trace.phase("return"):
        dense, sent, return_bits, return_clips = return_stage(shard, occ, accepted, idx, plan,
                                                              group)
    overflow = route_overflow if return_clips is None else route_overflow + return_clips
    return dense, sent, route_bits, return_bits, overflow


def route_stage(vals: torch.Tensor, idx: torch.Tensor, plan: ShardPlan,
                valid: Optional[torch.Tensor] = None, group=None):
    """The route: fixed ``[W, cap_dest]`` buckets, one ``all_to_all`` each
    for values and indices.  Empty slots carry value 0 and the guard index
    ``shard_n`` (one past the owner's range), so padding never touches a
    real unit or the occupancy counts.  Returns ``(rvals, ridx, accepted,
    route_bits)``: the buckets this owner received, whether each payload
    slot was accepted, and the bits handed to the collective."""
    W, cap, shard_n = plan.world, plan.cap_dest, plan.shard_n
    row = tuple(vals.shape[1:])
    dev = vals.device
    if not row and kernels.use_bucket_route(idx.shape[0], W, cap, dev):
        # each destination's accepted slots are a window of the ascending
        # payload: the windows found, copied and marked in one kernel
        bvals, bidx, accepted = kernels.route_buckets(vals, idx, valid, W, cap, shard_n)
    else:
        slot, accepted, dest = _per_dest_slots(idx, valid, plan)
        local = (idx - dest * shard_n).to(torch.int32)
        slot = slot.long()
        bvals = torch.zeros((W * cap + 1,) + row, dtype=vals.dtype,
                            device=dev).index_add_(0, slot, vals)[:-1].reshape((W, cap) + row)
        bidx = torch.full((W * cap + 1,), shard_n, dtype=torch.int32, device=dev).scatter_(
            0, slot, local)[:-1].reshape(W, cap)
    route_bits = wire._payload_bits(bvals, bidx)
    rvals = mesh.all_to_all(bvals, group)             # [W, cap(, bs)]
    ridx = mesh.all_to_all(bidx, group)
    return rvals, ridx, accepted, route_bits


def reduce_stage(rvals: torch.Tensor, ridx: torch.Tensor, plan: ShardPlan):
    """The owner reduce of the received buckets: ``(shard, occ)``, the
    owner's ``[shard_n(, unit_size)]`` sums and occupancy counts.
    ``shard_n + 1`` rows, the last the guard row, sliced off; one rank row
    after another, in rank order."""
    W, cap, shard_n = plan.world, plan.cap_dest, plan.shard_n
    row = tuple(rvals.shape[2:])
    dev = rvals.device
    shard = torch.zeros((shard_n + 1,) + row, dtype=rvals.dtype, device=dev)
    occ = torch.zeros(shard_n + 1, dtype=torch.int32, device=dev)
    ones = torch.ones(cap, dtype=torch.int32, device=dev)
    for w in range(W):
        r = ridx[w].long()
        shard.index_add_(0, r, rvals[w])
        occ.index_add_(0, r, ones)
    return shard[:shard_n], occ[:shard_n]


def return_stage(shard: torch.Tensor, occ: torch.Tensor, accepted: torch.Tensor,
                 idx: torch.Tensor, plan: ShardPlan, group=None):
    """The return of every owner's shard to every worker: ``(dense, sent,
    return_bits, return_clips)``, the sum on the padded unit space, which
    of this worker's slots came back, the bits handed to the
    ``all_gather``, and this owner's return clips (None for a dense
    return, which clips nothing)."""
    W, shard_n = plan.world, plan.shard_n
    row = tuple(shard.shape[1:])
    dev = shard.device
    if plan.dense_return:
        dense = mesh.all_gather(shard, group).reshape((W * shard_n,) + row)
        return dense, accepted, wire._payload_bits(shard), None
    cap_ret = plan.cap_ret
    mask = occ > 0
    nnz = mask.sum(dtype=torch.int32)
    rix = wire.packed_indices_from_mask(mask, cap_ret)
    rvalid = torch.arange(1, cap_ret + 1, dtype=torch.int32, device=dev) <= torch.clamp(
        nnz, max=cap_ret)
    sel = shard.index_select(0, rix.long())
    sel = torch.where(rvalid.reshape((-1,) + (1,) * len(row)), sel, 0.0)
    rix = torch.where(rvalid, rix, 0)
    return_bits = wire._payload_bits(sel, rix)
    g_vals = mesh.all_gather(sel, group)              # [W, cap_ret(, bs)]
    g_rix = mesh.all_gather(rix, group)               # [W, cap_ret]
    offs = torch.arange(W, dtype=torch.int32, device=dev)[:, None] * shard_n
    # an underfull union pads trailing ranks with index 0: no monotone
    # indices to rely on here
    gidx = (g_rix + offs).reshape(-1).long()
    dense = torch.zeros((W * shard_n,) + row, dtype=shard.dtype, device=dev).index_add_(
        0, gidx, g_vals.reshape((-1,) + row))
    # which of MY accepted units came back: an owner's return clips go
    # back to every contributor's EF residual
    returned = torch.zeros(W * shard_n, dtype=torch.uint8, device=dev).index_fill_(0, gidx, 1)
    sent = accepted & (returned.index_select(0, idx.long()) > 0)
    return dense, sent, return_bits, torch.clamp(nnz - cap_ret, min=0)
