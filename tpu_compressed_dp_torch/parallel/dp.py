"""Compressed data-parallel gradient synchronisation.

PyTorch counterpart of :mod:`tpu_compressed_dp.parallel.dp`: per reduction
group (one parameter tensor for ``layerwise``, the whole flattened gradient
for ``entiremodel``, contiguous leaves packed into ``bucket_mb`` buckets for
``bucketed``) the local gradient plus the EF residual is compressed and
averaged over the workers.  In ``mode='simulate'`` (the paper's protocol) the
compressed gradient stays dense with zeros at dropped coordinates and is
averaged with ``dist.all_reduce(comp) / world`` (the JAX engine's
``lax.psum(comp) / world``); bytes on the wire are accounted analytically.
In ``mode='wire'`` :func:`make_grad_sync` hands a compressing method to
:func:`tpu_compressed_dp_torch.ops.wire.make_wire_grad_sync`, whose payloads
really shrink and whose bits are measured; dense falls through to the
simulate path, whose all-reduce is its wire form.  ``transport='sharded'``
and ``'hierarchical'`` bill, in simulate mode, the buffers their wire form
would move (the counterfactual of the JAX engine).  The stat keys are the
JAX engine's.

Gradients, EF residuals and outputs are ordered dicts of tensors keyed by
parameter path, in the JAX package's leaf order (see
``models/resnet9.param_leaves``), so entire-model concatenation and EF rows
line up with the JAX run.  The EF residual is this rank's own (no leading
device axis: one process per worker).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from tpu_compressed_dp_torch.ops import compressors, kernels
from tpu_compressed_dp_torch.parallel import mesh

__all__ = ["CompressionConfig", "make_grad_sync", "make_leaf_groups",
           "group_concat", "group_split", "init_ef_state", "wire_transport",
           "make_partitioned_grad_sync", "make_grouped_grad_sync", "make_partitioned_clip",
           "make_sharded_clip", "merge_stat_dicts"]

Tree = Dict[str, torch.Tensor]

# the reference DDP's bucket unit is MiB (`ddp.py:182,188`)
BUCKET_MB = 1024.0 * 1024.0


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """The JAX package's ``CompressionConfig`` fields and defaults
    (``tpu_compressed_dp/parallel/dp.py``).  The port runs every method but
    ``powersgd``, every granularity, both modes, all three transports and
    ``sync_overlap=1``; :func:`make_grad_sync` raises
    ``NotImplementedError`` for the rest, naming the ROADMAP item.  The
    hierarchical transport's ``dp_pods`` must divide the world size, which
    the first sync checks."""

    method: Optional[str] = None
    granularity: str = "layerwise"
    mode: str = "simulate"
    sync_overlap: int = 1
    transport: str = "allgather"
    ratio: float = 0.5
    threshold: float = 1e-3
    qstates: int = 255
    rank: int = 4
    error_feedback: bool = False
    shared_mask: Optional[bool] = None
    check_sync: bool = False
    block_size: int = 256
    bucket_mb: float = 25.0
    wire_cap_ratio: float = 0.05
    shard_route_factor: float = 1.25
    shard_return_factor: float = 1.25
    dp_pods: int = 1
    hier_route_factor_ici: float = 1.25
    hier_route_factor_dcn: float = 1.25
    terngrad_chunk: int = -1

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if self.sync_overlap < 1:
            raise ValueError(f"sync_overlap must be >= 1, got {self.sync_overlap}")
        if self.granularity not in ("layerwise", "entiremodel", "bucketed"):
            raise ValueError(
                f"granularity must be layerwise|entiremodel|bucketed, got {self.granularity!r}")
        if self.bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be positive, got {self.bucket_mb}")
        if self.mode not in ("simulate", "wire"):
            raise ValueError(f"mode must be simulate|wire, got {self.mode!r}")
        if self.transport not in ("allgather", "sharded", "hierarchical"):
            raise ValueError("transport must be allgather|sharded|hierarchical, "
                             f"got {self.transport!r}")
        if self.dp_pods < 1:
            raise ValueError(f"dp_pods must be >= 1, got {self.dp_pods}")
        if self.hier_route_factor_ici <= 0 or self.hier_route_factor_dcn <= 0:
            raise ValueError("hier_route_factor_ici/hier_route_factor_dcn must be positive")
        if self.shard_route_factor <= 0 or self.shard_return_factor <= 0:
            raise ValueError("shard_route_factor/shard_return_factor must be positive")
        if not (0.0 < self.wire_cap_ratio <= 1.0):
            raise ValueError(f"wire_cap_ratio must be in (0, 1], got {self.wire_cap_ratio}")

    @property
    def resolved_shared_mask(self) -> bool:
        if self.shared_mask is not None:
            return self.shared_mask
        return self.mode == "wire"

    @property
    def resolved_terngrad_chunk(self) -> int:
        if self.terngrad_chunk >= 0:
            return self.terngrad_chunk
        return 0 if self.granularity == "layerwise" else 1 << 21


def _check_ported(cfg: CompressionConfig) -> None:
    """Refuse the parts of the config this slice does not carry."""
    if cfg.sync_overlap != 1:
        raise NotImplementedError("not ported yet: sync_overlap > 1 "
                                  "(ROADMAP.md queue 1, item 9)")


def wire_transport(name: str, n: int, cfg: CompressionConfig) -> str:
    """Which collective the method's wire form rides for an ``n``-element
    group: ``'psum'`` | ``'allgather'`` | ``'sharded'`` | ``'hierarchical'``,
    the billing split of both engines.  Dense, shared-seed Random-K and
    keep-all Block-Top-K psum-reduce a buffer; every other payload is
    worker-distinct (indices or quantizer scales) and rides an all_gather,
    unless ``cfg.transport`` moves an index-carrying sparsifier
    (``wire_sharded.SHARDED_METHODS``) onto the owner-sharded or
    hierarchical exchange."""
    if name == "none" or (name == "randomk" and cfg.resolved_shared_mask):
        return "psum"
    if name == "blocktopk":
        kb = compressors.blocktopk_keep_blocks(n, cfg.ratio, cfg.block_size)
        if kb * cfg.block_size >= n:
            return "psum"
    if cfg.transport in ("sharded", "hierarchical"):
        from tpu_compressed_dp_torch.ops.wire_sharded import SHARDED_METHODS

        if name in SHARDED_METHODS:
            return cfg.transport
    return "allgather"


def _sharded_group_bits(name: str, n: int, world: int, cfg: CompressionConfig):
    """Analytic ``(route_bits, return_bits)`` of the sharded wire form of an
    ``n``-element group (``wire_sharded.sharded_payload_bits`` over the
    method's units), equal to the wire engine's measured buffer bits."""
    from tpu_compressed_dp_torch.ops import wire_sharded

    if name == "blocktopk":
        kb = compressors.blocktopk_keep_blocks(n, cfg.ratio, cfg.block_size)
        nb = -(-n // cfg.block_size)
        return wire_sharded.sharded_payload_bits(
            nb, kb, world, cfg.block_size, cfg.shard_route_factor, cfg.shard_return_factor)
    if name in ("thresholdv", "adaptive_threshold"):
        keep = max(1, int(round(cfg.wire_cap_ratio * n)))
    else:
        keep = compressors.topk_keep_count(n, cfg.ratio)
    return wire_sharded.sharded_payload_bits(
        n, keep, world, 1, cfg.shard_route_factor, cfg.shard_return_factor)


def _hier_group_bits(name: str, n: int, world: int, cfg: CompressionConfig):
    """Analytic ``(ici_bits, dcn_route_bits, dcn_return_bits)`` of the
    hierarchical wire form of an ``n``-element group
    (``wire_sharded.hier_payload_bits``); ``keep`` counts elements even for
    Block-Top-K, whose pod union is packed element by element."""
    from tpu_compressed_dp_torch.ops import wire_sharded

    if name == "blocktopk":
        kb = compressors.blocktopk_keep_blocks(n, cfg.ratio, cfg.block_size)
        keep = min(kb * cfg.block_size, n)
    elif name in ("thresholdv", "adaptive_threshold"):
        keep = max(1, int(round(cfg.wire_cap_ratio * n)))
    else:
        keep = compressors.topk_keep_count(n, cfg.ratio)
    return wire_sharded.hier_payload_bits(
        n, keep, world, cfg.dp_pods, cfg.hier_route_factor_ici, cfg.hier_route_factor_dcn)


def init_ef_state(grads_like: Tree, cfg: CompressionConfig) -> Any:
    """Zero fp32 error-feedback residual per leaf (``()`` when EF is off)."""
    if not cfg.error_feedback:
        return ()
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_like.items()}


def make_leaf_groups(byte_sizes, granularity: str, bucket_bytes: float):
    """Partition leaf indices into reduction groups: one leaf per group
    (layerwise), every leaf in one group (entiremodel), or contiguous leaves
    greedily packed into <= ``bucket_bytes`` groups (bucketed)."""
    n = len(byte_sizes)
    if granularity == "layerwise":
        return [[i] for i in range(n)]
    if granularity == "entiremodel":
        return [list(range(n))] if n else []
    groups, cur, cur_bytes = [], [], 0.0
    for i, b in enumerate(byte_sizes):
        if cur and cur_bytes + b > bucket_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0.0
        cur.append(i)
        cur_bytes += b
    if cur:
        groups.append(cur)
    return groups


def group_concat(leaves, idxs) -> torch.Tensor:
    """Flatten-and-concatenate a group's leaves (single-leaf groups skip the
    copy and return a view)."""
    flats = [leaves[i].reshape(-1) for i in idxs]
    return flats[0] if len(flats) == 1 else torch.cat(flats)


def group_split(flat, leaves, idxs, out, dtype=None) -> None:
    """Slice a group's flat result back into per-leaf shapes (views of
    ``flat``), written into ``out`` at the leaves' positions."""
    off = 0
    for i in idxs:
        n = leaves[i].numel()
        out[i] = flat[off:off + n].reshape(leaves[i].shape).to(dtype or leaves[i].dtype)
        off += n


def make_grad_sync(cfg: CompressionConfig):
    """Build ``sync(grads, ef, seed) -> (synced, new_ef, stats)`` over the
    default process group.

    ``grads`` are this rank's gradients at the scale the reference compresses
    (see ``train/step.py``); ``synced`` is the world mean.  ``seed`` is the
    step's 64-bit compression seed (the JAX ``key``); group ``gi`` draws from
    ``leaf_seed(seed, gi)``, with the rank folded in where the workers' draws
    must differ.  ``stats`` are 0-d float32 tensors on the gradients'
    device, keyed as in the JAX engine (``sent_elems``, ``sent_bits`` and its
    per-collective split, ``dense_elems``, ``num_collectives``)."""
    _check_ported(cfg)
    comp = compressors.get_compressor(
        cfg.method, ratio=cfg.ratio, threshold=cfg.threshold, qstates=cfg.qstates,
        block_size=cfg.block_size, terngrad_chunk=cfg.resolved_terngrad_chunk, rank=cfg.rank)
    if cfg.mode == "wire" and comp.name != "none":
        from tpu_compressed_dp_torch.ops import wire

        return wire.make_wire_grad_sync(cfg)
    per_worker_rng = not cfg.resolved_shared_mask
    bits_per_elem = compressors.payload_bits_per_elem(
        comp.name, qstates=cfg.qstates, shared_mask=cfg.resolved_shared_mask,
        block_size=cfg.block_size)
    threshold32 = compressors.float32_value(cfg.threshold)

    def sent_count(n: int, comp_flat: torch.Tensor) -> torch.Tensor:
        # sparsifiers transmit the surviving coordinates; quantizers and
        # identity every element, at the width bits_per_elem accounts
        if comp.name == "randomk":
            # the wire form carries exactly `keep` value slots, a selected
            # zero included
            sent = compressors.randomk_keep_count(n, cfg.ratio)
        elif comp.name == "blocktopk":
            # whole blocks travel, capped at n
            sent = min(compressors.blocktopk_keep_blocks(n, cfg.ratio, cfg.block_size)
                       * cfg.block_size, n)
        elif not comp.is_sparsifier:
            sent = n
        else:
            return torch.count_nonzero(comp_flat).to(torch.float32)
        return torch.full((), float(sent), dtype=torch.float32, device=comp_flat.device)

    def bits_width(n: int) -> float:
        # keep-all Block-Top-K groups psum dense: no block indices travel
        if comp.name == "blocktopk" and wire_transport(comp.name, n, cfg) == "psum":
            return 32.0
        return bits_per_elem

    def fused_threshold(acc: torch.Tensor) -> Optional[torch.Tensor]:
        """The ``|acc| >= t`` threshold where the fused epilogue serves this
        group: Top-K's histogram threshold, Threshold-V's V, Adaptive's
        max/2 (``2|g| >= max`` is ``|g| >= max/2`` exactly in binary fp)."""
        n = acc.shape[0]
        if acc.dtype != torch.float32 or not kernels.use_fused_sparsify(n, acc.device):
            return None
        if comp.name == "topk":
            return kernels.topk_threshold(acc.abs(), compressors.topk_keep_count(n, cfg.ratio))
        if comp.name == "thresholdv":
            return torch.full((), threshold32, dtype=torch.float32, device=acc.device)
        if comp.name == "adaptive_threshold":
            return 0.5 * acc.abs().max()
        return None

    def sync(grads: Tree, ef: Any, seed: int) -> Tuple[Tree, Any, Dict[str, torch.Tensor]]:
        world = mesh.world()
        rank = mesh.rank() if per_worker_rng and comp.needs_rng else None
        names = list(grads)
        leaves = [grads[k] for k in names]
        use_ef = cfg.error_feedback
        if use_ef and not isinstance(ef, dict):
            raise ValueError("error_feedback=True needs an EF state; build it "
                             "with init_ef_state(grads_like, cfg)")
        ef_leaves = [ef[k] for k in names] if use_ef else [None] * len(leaves)
        device = leaves[0].device
        groups = make_leaf_groups(
            [g.numel() * g.element_size() for g in leaves],
            cfg.granularity, cfg.bucket_mb * BUCKET_MB)
        out_leaves = [None] * len(leaves)
        new_ef_leaves = [None] * len(leaves)
        zero = torch.zeros((), dtype=torch.float32, device=device)
        sent_total, bits_total, bits_psum, bits_ag = zero, zero, zero, zero
        bits_a2a, bits_ici, bits_dcn, bits_dcn_route = zero, zero, zero, zero
        dense_total = 0.0
        for gi, idxs in enumerate(groups):
            flat = group_concat(leaves, idxs)
            acc = flat + group_concat(ef_leaves, idxs) if use_ef else flat
            n_g = flat.shape[0]
            fuse_t = fused_threshold(acc)
            if fuse_t is not None:
                comp_flat, new_ef_flat, group_sent = kernels.fused_sparsify(
                    acc.contiguous(), fuse_t, want_ef=use_ef)
            else:
                comp_flat = comp.fn(acc, compressors.leaf_seed(seed, gi, rank))
                new_ef_flat = acc - comp_flat if use_ef else None
                group_sent = sent_count(n_g, comp_flat)
                if comp.name == "none":
                    # all_reduce works in place and the dense payload may
                    # alias the caller's gradient
                    comp_flat = comp_flat.clone()
            group_bits = group_sent * bits_width(n_g)
            if world > 1:
                dist.all_reduce(comp_flat)
            reduced = comp_flat / world
            group_split(reduced, leaves, idxs, out_leaves)
            if use_ef:
                group_split(new_ef_flat, leaves, idxs, new_ef_leaves, dtype=torch.float32)
            transport = wire_transport(comp.name, n_g, cfg)
            if transport == "sharded" and world > 1:
                # the counterfactual: the fixed-capacity route and return
                # buffers the sharded wire form would move (at world 1 the
                # wire engine degrades to the allgather combine, and so
                # does this bill)
                route_b, ret_b = _sharded_group_bits(comp.name, n_g, world, cfg)
                group_bits = torch.full((), route_b + ret_b, dtype=torch.float32, device=device)
                bits_a2a = bits_a2a + route_b
                bits_ag = bits_ag + ret_b
            elif transport == "hierarchical" and world > 1:
                # per fabric only: the flat collective-kind buckets stay
                # whole-world
                ici_b, rt_b, ret_b = _hier_group_bits(comp.name, n_g, world, cfg)
                group_bits = torch.full((), ici_b + rt_b + ret_b, dtype=torch.float32,
                                        device=device)
                bits_ici = bits_ici + ici_b
                bits_dcn = bits_dcn + rt_b + ret_b
                bits_dcn_route = bits_dcn_route + rt_b
            elif transport == "psum":
                bits_psum = bits_psum + group_bits
            else:
                bits_ag = bits_ag + group_bits
            sent_total = sent_total + group_sent
            bits_total = bits_total + group_bits
            dense_total += float(n_g)

        out = dict(zip(names, out_leaves))
        new_ef = dict(zip(names, new_ef_leaves)) if use_ef else ()
        stats = {
            "sent_elems": sent_total,
            "sent_bits": bits_total,
            "sent_bits_psum": bits_psum,
            "sent_bits_allgather": bits_ag,
            "sent_bits_alltoall": bits_a2a,
            "sent_bits_ici": bits_ici,
            "sent_bits_dcn": bits_dcn,
            "sent_bits_dcn_route": bits_dcn_route,
            "dense_elems": torch.full((), dense_total, dtype=torch.float32, device=device),
            "num_collectives": torch.full((), float(len(groups)), dtype=torch.float32,
                                          device=device),
        }
        return out, new_ef, stats

    return sync


# ---------------------------------------------------------------------------
# Partitioned sync: one reduction per replication signature
# ---------------------------------------------------------------------------

# 0/1 diagnostics, combined across signature groups by their min reduction
# instead of summed (the JAX engine's _DIAG_STATS; its guard/nonfinite comes
# with the step guard, ROADMAP item 12)
_DIAG_COMBINE = {"sync_agree": torch.minimum}


def merge_stat_dicts(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Combine the stats of two disjoint slices of one sync: additive volumes
    sum; the diagnostic ``sync_agree`` combines by min, and survives when
    either side reports it.  Keys keep ``a``'s
    order, then ``b``'s new ones: every rank must list the stats in one order
    (the step all-reduces them stacked), which set order would not give."""
    keys = list(a) + [k for k in b if k not in a]
    merged = {k: a.get(k, 0.0) + b.get(k, 0.0) for k in keys if k not in _DIAG_COMBINE}
    for k, combine in _DIAG_COMBINE.items():
        vals = [c[k] for c in (a, b) if k in c]
        if vals:
            merged[k] = vals[0] if len(vals) == 1 else combine(*vals)
    return merged


def make_partitioned_grad_sync(cfg: CompressionConfig, leaf_axes):
    """Compressed sync for gradients whose leaves are sharded over different
    model axes (the JAX ``make_partitioned_grad_sync``): leaves sync in one
    group per replication signature, in sorted-signature order, so a
    data-dependent mask never spans leaves that ranks share differently.
    ``leaf_axes`` gives, per leaf in the gradients' order, the tuple of model
    axes it is sharded over (``()`` replicated).

    The port's model axes all have size 1, so a group's stats need no
    reduction over its signature's axes (the JAX psum over a size-1 axis)
    and pass through; the groups' stats merge with :func:`merge_stat_dicts`.
    Signature group ``gi`` compresses with the seed ``fold_in(seed, gi)``
    (the JAX engine splits its key per signature).  Returns ``sync(grads,
    ef, seed) -> (synced, new_ef, stats)`` as :func:`make_grad_sync`."""
    base_sync = make_grad_sync(cfg)
    leaf_axes = [tuple(a) for a in leaf_axes]
    sigs = sorted(set(leaf_axes))
    group_of = [sigs.index(a) for a in leaf_axes]

    def sync(grads: Tree, ef: Any, seed: int):
        names = list(grads)
        if len(names) != len(group_of):
            raise ValueError(f"{len(names)} gradient leaves, {len(group_of)} leaf signatures")
        use_ef = cfg.error_feedback
        synced, new_ef, comm = {}, {}, None
        for gi in range(len(sigs)):
            keys = [k for k, g in zip(names, group_of) if g == gi]
            s_g, s_e, s_comm = base_sync({k: grads[k] for k in keys},
                                         {k: ef[k] for k in keys} if use_ef else (),
                                         compressors.fold_in(seed, gi))
            synced.update(s_g)
            if use_ef:
                new_ef.update(s_e)
            comm = s_comm if comm is None else merge_stat_dicts(comm, s_comm)
        return ({k: synced[k] for k in names},
                {k: new_ef[k] for k in names} if use_ef else (), comm)

    return sync


def make_grouped_grad_sync(cfg: CompressionConfig, is_sharded, shard_axis="tensor"):
    """:func:`make_partitioned_grad_sync` for leaves that are either
    replicated or sharded over ``shard_axis`` (a name or a tuple of names)."""
    axes = (shard_axis,) if isinstance(shard_axis, str) else tuple(shard_axis)
    return make_partitioned_grad_sync(cfg, [axes if s else () for s in is_sharded])


def make_partitioned_clip(leaf_axes):
    """``clip_tree(tree, limit)``: scale every leaf by ``min(1, limit /
    ||tree||)``, the full-model L2 norm summed per signature (the JAX
    ``make_partitioned_clip``; at model axes of size 1 no psum is needed)."""
    leaf_axes = [tuple(a) for a in leaf_axes]
    sigs = sorted(set(leaf_axes))

    def global_norm(tree: Tree) -> torch.Tensor:
        leaves = list(tree.values())
        total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for sig in sigs:
            total = total + sum((g.to(torch.float32) ** 2).sum()
                                for g, a in zip(leaves, leaf_axes) if a == sig)
        return torch.sqrt(total)

    def clip_tree(tree: Tree, limit: float) -> Tree:
        factor = torch.clamp(limit / torch.clamp(global_norm(tree), min=1e-20), max=1.0)
        return {k: g * factor for k, g in tree.items()}

    return clip_tree


def make_sharded_clip(is_sharded, shard_axis="tensor"):
    """:func:`make_partitioned_clip` for replicated-or-sharded leaves."""
    axes = (shard_axis,) if isinstance(shard_axis, str) else tuple(shard_axis)
    return make_partitioned_clip([axes if s else () for s in is_sharded])
