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

PowerSGD (``method='powersgd'``, :mod:`tpu_compressed_dp_torch.ops.lowrank`)
carries a warm start across steps: :func:`make_stateful_grad_sync` builds
the JAX engine's ``sync(grads, ef, comp, seed) -> (synced, new_ef,
new_comp, stats)``, whose compressor state ``comp`` comes from
:func:`init_comp_state` (stateless methods pass it through unchanged);
:func:`make_grad_sync` is the stateless ``sync(grads, ef, seed)`` of every
other method.  :func:`make_issue_grad_sync` splits the stateful sync in two
for the chunk-pipelined sync (``parallel/overlap.py``):
``issue(grads, ef, comp, seed)`` compresses and starts the collectives, and
the ``finish()`` it returns waits for them and yields the result.  Every
constructor takes a ``group_offset``: group ``gi`` of the tree it is handed
draws ``leaf_seed(seed, group_offset + gi)`` and keeps PowerSGD's warm start
under ``q<group_offset + gi>``, so a chunk of the tree synced alone is
bitwise the same groups of the whole tree.  Every constructor also takes a
``group``: the process group the workers form (``None``, the default group;
the LM's ``workers`` group of ``parallel/mesh.lm_groups``).  Every
collective, the world size and each rank's seed (its rank within the
group, the JAX ``axis_index`` over the sync axes) come from it.

Gradients, EF residuals and outputs are ordered dicts of tensors keyed by
parameter path, in the JAX package's leaf order (see
``models/common.param_leaves``), so entire-model concatenation and EF rows
line up with the JAX run.  The EF residual is this rank's own (no leading
device axis: one process per worker).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from tpu_compressed_dp_torch.models.common import to_flax_layout, to_torch_layout
from tpu_compressed_dp_torch.ops import compressors, kernels
from tpu_compressed_dp_torch.parallel import mesh

__all__ = ["CompressionConfig", "make_grad_sync", "make_stateful_grad_sync", "make_leaf_groups",
           "group_concat", "group_split", "init_ef_state", "init_comp_state", "wire_transport",
           "make_partitioned_grad_sync", "make_grouped_grad_sync", "make_partitioned_clip",
           "make_sharded_clip", "merge_stat_dicts", "make_issue_grad_sync", "PartitionedSync",
           "init_comp_state_partitioned", "init_comp_state_grouped"]

Tree = Dict[str, torch.Tensor]

# the reference DDP's bucket unit is MiB (`ddp.py:182,188`)
BUCKET_MB = 1024.0 * 1024.0


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """The JAX package's ``CompressionConfig`` fields and defaults
    (``tpu_compressed_dp/parallel/dp.py``).  The port runs every method,
    every granularity, both modes and all three transports; ``sync_overlap >
    1`` is the train step's chunk-pipelined sync (``parallel/overlap.py``),
    which the sync constructors here do not read.  The hierarchical
    transport's ``dp_pods`` must divide the world size, which the first sync
    checks."""

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


def init_comp_state(grads_like: Tree, cfg: CompressionConfig, seed: int = 0) -> Any:
    """Persistent compressor state (``()`` for stateless methods).  PowerSGD:
    one fp32 warm start ``Q`` ``[n2, r]`` per compressed group, keyed
    ``'q<gi>'``, drawn from ``fold_in(seed, gi)`` so that every rank holds
    the same one; dense-fallback groups carry none."""
    if compressors.canonical_name(cfg.method) != "powersgd":
        return ()
    from tpu_compressed_dp_torch.ops import lowrank

    leaves = list(grads_like.values())
    groups = make_leaf_groups([g.numel() * g.element_size() for g in leaves],
                              cfg.granularity, cfg.bucket_mb * BUCKET_MB)
    state = {}
    for gi, idxs in enumerate(groups):
        n = sum(leaves[i].numel() for i in idxs)
        q = lowrank.init_group_state(n, cfg.rank, compressors.fold_in(seed, gi),
                                     leaves[0].device)
        if q is not None:
            state[f"q{gi}"] = q
    return state if state else ()


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


def make_grad_sync(cfg: CompressionConfig, group_offset: int = 0, group=None):
    """Build ``sync(grads, ef, seed) -> (synced, new_ef, stats)`` over the
    workers of ``group`` (``None``: the default process group), for every
    stateless method (PowerSGD's sync is :func:`make_stateful_grad_sync`'s).

    ``grads`` are this rank's gradients at the scale the reference compresses
    (see ``train/step.py``); ``synced`` is the world mean.  ``seed`` is the
    step's 64-bit compression seed (the JAX ``key``); group ``gi`` draws from
    ``leaf_seed(seed, group_offset + gi)``, with the rank folded in where the
    workers' draws must differ.  ``stats`` are 0-d float32 tensors on the
    gradients' device, keyed as in the JAX engine (``sent_elems``,
    ``sent_bits`` and its per-collective split, ``dense_elems``,
    ``num_collectives``)."""
    issue = _make_stateless_issue(cfg, group_offset, group)

    def sync(grads: Tree, ef: Any, seed: int) -> Tuple[Tree, Any, Dict[str, torch.Tensor]]:
        return issue(grads, ef, seed)()

    return sync


def _make_stateless_issue(cfg: CompressionConfig, group_offset: int, group=None):
    """``issue(grads, ef, seed) -> finish``, ``finish() -> (synced, new_ef,
    stats)``, for the stateless methods.  The simulate engine starts each
    group's all-reduce with ``async_op=True`` and ``finish`` waits for them;
    the wire engine's collectives feed its combine, so it runs whole in
    ``issue``."""
    comp = compressors.get_compressor(
        cfg.method, ratio=cfg.ratio, threshold=cfg.threshold, qstates=cfg.qstates,
        block_size=cfg.block_size, terngrad_chunk=cfg.resolved_terngrad_chunk, rank=cfg.rank)
    if comp.is_stateful:
        raise ValueError(f"{comp.name} carries a warm start across steps: build its sync "
                         "with make_stateful_grad_sync")
    if cfg.mode == "wire" and comp.name != "none":
        from tpu_compressed_dp_torch.ops import wire

        return _done(wire.make_wire_grad_sync(cfg, group_offset, group))
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

    def issue(grads: Tree, ef: Any, seed: int) -> Callable[[], Tuple[Tree, Any, Dict]]:
        world = mesh.size(group)
        rank = mesh.group_rank(group) if per_worker_rng and comp.needs_rng else None
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
        in_flight = []   # (work or None, payload, idxs) per group
        for gi, idxs in enumerate(groups):
            flat = group_concat(leaves, idxs)
            if use_ef:
                # a group of several leaves is a fresh concatenation: add the
                # residual into it (the same bits; one group-sized buffer
                # fewer at the LM's ~1 G-element groups)
                ef_flat = group_concat(ef_leaves, idxs)
                acc = flat.add_(ef_flat) if len(idxs) > 1 else flat + ef_flat
                del ef_flat
            else:
                acc = flat
            n_g = flat.shape[0]
            fuse_t = fused_threshold(acc)
            if fuse_t is not None:
                comp_flat, new_ef_flat, group_sent = kernels.fused_sparsify(
                    acc.contiguous(), fuse_t, want_ef=use_ef)
            else:
                comp_flat = comp.fn(acc, compressors.leaf_seed(seed, group_offset + gi, rank))
                new_ef_flat = acc - comp_flat if use_ef else None
                group_sent = sent_count(n_g, comp_flat)
                if comp.name == "none":
                    # all_reduce works in place and the dense payload may
                    # alias the caller's gradient
                    comp_flat = comp_flat.clone()
            group_bits = group_sent * bits_width(n_g)
            work = (dist.all_reduce(comp_flat, group=group, async_op=True) if world > 1
                    else None)
            in_flight.append((work, comp_flat, idxs))
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

        def finish():
            for work, comp_flat, idxs in in_flight:
                if work is not None:
                    work.wait()
                # the payload is this sync's own buffer: divide it in place
                group_split(comp_flat.div_(world) if world > 1 else comp_flat, leaves, idxs,
                            out_leaves)
            return dict(zip(names, out_leaves)), new_ef, stats

        return finish

    return issue


def _done(sync):
    """A synchronous engine ``sync(*args) -> result`` as ``issue(*args) ->
    finish``, its result ready at issue."""

    def issue(*args):
        result = sync(*args)
        return lambda: result

    return issue


def make_issue_grad_sync(cfg: CompressionConfig, group_offset: int = 0, group=None):
    """Build ``issue(grads, ef, comp, seed) -> finish`` with ``finish() ->
    (synced, new_ef, new_comp, stats)``, the stateful sync of
    :func:`make_stateful_grad_sync` in two halves: ``issue`` compresses and
    starts the collectives, ``finish`` waits for them.  The simulate
    engine's all-reduces are asynchronous (``async_op=True``); the wire and
    PowerSGD engines feed each collective's result to the next step, so they
    finish inside ``issue``."""
    if compressors.canonical_name(cfg.method) == "powersgd":
        return _done(_make_powersgd_sync(cfg, group_offset, group))
    base = _make_stateless_issue(cfg, group_offset, group)

    def issue(grads: Tree, ef: Any, comp: Any, seed: int):
        fin = base(grads, ef, seed)

        def finish():
            out, new_ef, stats = fin()
            return out, new_ef, comp, stats

        return finish

    return issue


def make_stateful_grad_sync(cfg: CompressionConfig, group_offset: int = 0, group=None):
    """Build ``sync(grads, ef, comp, seed) -> (synced, new_ef, new_comp,
    stats)``, the JAX engine's signature: ``comp`` is the compressor state of
    :func:`init_comp_state`.  PowerSGD runs its warm-started engine (the
    factors are its wire form, so both modes share it); every other method
    runs :func:`make_grad_sync`'s sync and returns ``comp`` unchanged."""
    issue = make_issue_grad_sync(cfg, group_offset, group)

    def sync(grads: Tree, ef: Any, comp: Any, seed: int):
        return issue(grads, ef, comp, seed)()

    return sync


def _flax_order(path: str, g: torch.Tensor) -> torch.Tensor:
    """A leaf's elements, flat, in the flax layout's order (the port keeps
    conv kernels OIHW and Dense kernels ``(out, in)``; models/common.py)."""
    return to_flax_layout(path, g).reshape(-1)


def _from_flax_order(path: str, flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_flax_order`: a view of ``flat`` in ``like``'s
    shape."""
    return to_torch_layout(path, flat.reshape(to_flax_layout(path, like).shape))


def _make_powersgd_sync(cfg: CompressionConfig, group_offset: int = 0, group=None):
    """The stateful PowerSGD engine (the JAX ``_make_powersgd_sync``).

    Per group: one warm-started power iteration against ``comp['q<gi>']``,
    two all-reduces (``P`` then ``Q``), the rank-r approximation of the
    world-mean gradient, and ``acc - recon`` into the EF residual.  Groups
    whose factors would cost at least the dense vector are all-reduced
    dense (exact; no state).  Every payload rides the all-reduce:
    ``sent_bits_allgather`` is 0.  Each group is flattened leaf by leaf in
    the flax layout's element order (:func:`_flax_order`), since the
    approximation, unlike Top-K, depends on how the group is laid out in
    ``[m, n2]``; results go back to the port's layout.  ``check_sync``
    reports ``sync_agree``: 1 where every rank's warm start is the same
    (max == min across ranks)."""
    from tpu_compressed_dp_torch.ops import lowrank

    if not cfg.error_feedback:
        warnings.warn("method='powersgd' without error_feedback=True discards the low-rank "
                      "residual every step; enable EF (Vogels et al. always do)", stacklevel=2)

    def sync(grads: Tree, ef: Any, comp_state: Any, seed: int):
        world = mesh.size(group)
        names = list(grads)
        leaves = [grads[k] for k in names]
        use_ef = cfg.error_feedback
        if use_ef and not isinstance(ef, dict):
            raise ValueError("error_feedback=True needs an EF state; build it "
                             "with init_ef_state(grads_like, cfg)")
        ef_leaves = [ef[k] for k in names] if use_ef else None
        device = leaves[0].device
        groups = make_leaf_groups([g.numel() * g.element_size() for g in leaves],
                                  cfg.granularity, cfg.bucket_mb * BUCKET_MB)
        out_leaves = [None] * len(leaves)
        new_ef_leaves = [None] * len(leaves)
        new_comp = {}
        sent_total = bits_total = dense_total = 0.0
        n_coll = 0
        agrees = []
        for gi, idxs in enumerate(groups):
            flat = torch.cat([_flax_order(names[i], leaves[i]) for i in idxs])
            acc = (flat + torch.cat([_flax_order(names[i], ef_leaves[i]) for i in idxs])
                   if use_ef else flat)
            acc = acc.to(torch.float32)
            n_g = acc.shape[0]
            if lowrank.powersgd_dims(n_g, cfg.rank) is None:
                # factors would cost >= the dense vector: all-reduce dense
                # (torch.cat made acc a copy, so in place is safe)
                if world > 1:
                    dist.all_reduce(acc, group=group)
                recon = acc / world
                new_ef_flat = torch.zeros_like(acc) if use_ef else None
                group_sent, group_bits = float(n_g), 32.0 * n_g
                n_coll += 1
            else:
                qk = f"q{group_offset + gi}"
                if not isinstance(comp_state, dict) or qk not in comp_state:
                    raise ValueError(f"powersgd sync needs warm-start state {qk!r}; build "
                                     "TrainState.comp with init_comp_state(grads_like, cfg)")
                q_in = comp_state[qk]
                if cfg.check_sync:
                    hi, lo = q_in.clone(), q_in.clone()
                    if world > 1:
                        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
                        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
                    agrees.append(((hi - lo).abs().max() == 0.0).to(torch.float32))
                recon, q_new, group_sent, group_bits = lowrank.powersgd_group_sync(
                    acc, q_in, cfg.rank, world, group)
                new_comp[qk] = q_new
                new_ef_flat = acc - recon if use_ef else None
                n_coll += 2  # the P and the Q all-reduce
            off = 0
            for i in idxs:
                n = leaves[i].numel()
                out_leaves[i] = _from_flax_order(names[i], recon[off:off + n],
                                                 leaves[i]).to(leaves[i].dtype)
                if use_ef:
                    new_ef_leaves[i] = _from_flax_order(names[i], new_ef_flat[off:off + n],
                                                        leaves[i])
                off += n
            sent_total += group_sent
            bits_total += group_bits
            dense_total += float(n_g)

        def full(v: float) -> torch.Tensor:
            return torch.full((), v, dtype=torch.float32, device=device)

        stats = {
            "sent_elems": full(sent_total),
            "sent_bits": full(bits_total),
            "sent_bits_psum": full(bits_total),
            "sent_bits_allgather": full(0.0),
            "sent_bits_alltoall": full(0.0),
            "sent_bits_ici": full(0.0),
            "sent_bits_dcn": full(0.0),
            "sent_bits_dcn_route": full(0.0),
            "dense_elems": full(dense_total),
            "num_collectives": full(float(n_coll)),
        }
        if agrees:
            stats["sync_agree"] = torch.stack(agrees).min()
        return (dict(zip(names, out_leaves)),
                dict(zip(names, new_ef_leaves)) if use_ef else (),
                new_comp if new_comp else (), stats)

    return sync


# ---------------------------------------------------------------------------
# Partitioned sync: one reduction per replication signature
# ---------------------------------------------------------------------------

# 0/1 diagnostics, combined across signature groups by their min reduction
# instead of summed (the JAX engine's _DIAG_STATS; its guard/nonfinite comes
# with the step guard, ROADMAP item 12): key -> (collective, combine)
_DIAG_COMBINE = {"sync_agree": (dist.ReduceOp.MIN, torch.minimum)}


def merge_stat_dicts(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Combine the stats of two disjoint slices of one sync: additive volumes
    sum; the diagnostic ``sync_agree`` combines by min, and survives when
    either side reports it.  Keys keep ``a``'s
    order, then ``b``'s new ones: every rank must list the stats in one order
    (the step all-reduces them stacked), which set order would not give."""
    keys = list(a) + [k for k in b if k not in a]
    merged = {k: a.get(k, 0.0) + b.get(k, 0.0) for k in keys if k not in _DIAG_COMBINE}
    for k, (_, combine) in _DIAG_COMBINE.items():
        vals = [c[k] for c in (a, b) if k in c]
        if vals:
            merged[k] = vals[0] if len(vals) == 1 else combine(*vals)
    return merged


def _reduce_stats(stats: Dict[str, torch.Tensor], groups) -> Dict[str, torch.Tensor]:
    """A signature group's per-rank stats as model-wide totals: volumes
    summed over the signature's axis groups, diagnostics by their own
    reduction (the JAX ``psum`` / ``pmin`` over the signature's axes)."""
    groups = [g for g in groups if mesh.axis_size(g) > 1]
    if not groups:
        return stats
    keys = [k for k in stats if k not in _DIAG_COMBINE]
    vals = torch.stack([stats[k].to(torch.float32) for k in keys])
    out = {}
    for g in groups:
        vals = mesh.all_reduce_sum(vals, g)
    out.update(zip(keys, vals.unbind(0)))
    for k, (op, _) in _DIAG_COMBINE.items():
        if k in stats:
            v = stats[k].clone()
            for g in groups:
                dist.all_reduce(v, op=op, group=g)
            out[k] = v
    return {k: out[k] for k in stats}


def _signatures(leaf_axes):
    leaf_axes = [tuple(a) for a in leaf_axes]
    sigs = sorted(set(leaf_axes))
    return leaf_axes, sigs, [sigs.index(a) for a in leaf_axes]


def _axis_groups(sig, axis_groups) -> list:
    return [(axis_groups or {}).get(ax) for ax in sig]


class PartitionedSync:
    """Compressed sync for gradients whose leaves are sharded over different
    model axes (the JAX ``make_partitioned_grad_sync``): leaves sync in one
    group per replication signature, in sorted-signature order, so a
    data-dependent mask never spans leaves that ranks share differently.
    ``leaf_axes`` gives, per leaf in the gradients' order, the tuple of model
    axes it is sharded over (``()`` replicated).

    Every signature group syncs over the workers of ``group`` (the JAX sync
    axes) with the seed ``fold_in(seed, gi)`` (the JAX engine splits its
    key per signature), through the chunk engines of
    ``parallel/overlap.py`` (``cfg.sync_overlap`` chunks a group; one chunk
    is the single sync); its stats are then summed over the process groups
    ``axis_groups`` names for its signature's axes (``{"tensor":
    tensor_group}``; an absent axis has size 1), ``sync_agree`` by min, and
    the groups' stats merge with :func:`merge_stat_dicts`.  The compressor
    state is one :func:`init_comp_state` sub-dict per signature, keyed
    ``'sig<gi>'`` (:func:`init_comp_state_partitioned`).

    ``sync(grads, ef, comp, seed) -> (synced, new_ef, new_comp, stats)``;
    ``begin(params, ef, comp, seed)`` opens a round whose ``land(i, g)``
    takes leaf ``i``'s gradient as the backward pass produces it (a group's
    chunk goes out when its last gradient lands) and whose ``collect()``
    returns the same four values."""

    def __init__(self, cfg: CompressionConfig, leaf_axes, *, group=None, axis_groups=None):
        from tpu_compressed_dp_torch.parallel.overlap import ChunkedSync

        self.cfg = cfg
        self.leaf_axes, self.sigs, self.group_of = _signatures(leaf_axes)
        self.axis_groups = axis_groups
        self.chunked = [ChunkedSync(cfg, group) for _ in self.sigs]

    def begin(self, grads_like: Tree, ef: Any, comp: Any, seed: int) -> "_PartitionedRound":
        if len(grads_like) != len(self.group_of):
            raise ValueError(f"{len(grads_like)} gradient leaves, {len(self.group_of)} leaf "
                             "signatures")
        return _PartitionedRound(self, list(grads_like), grads_like, ef, comp, seed)

    def __call__(self, grads: Tree, ef: Any, comp: Any, seed: int):
        rnd = self.begin(grads, ef, comp, seed)
        rnd.land_all(grads)
        return rnd.collect()


class _PartitionedRound:
    def __init__(self, ps: PartitionedSync, names, grads_like: Tree, ef: Any, comp: Any,
                 seed: int):
        self.ps, self.names = ps, names
        use_ef = ps.cfg.error_feedback
        self.keys = [[k for k, g in zip(names, ps.group_of) if g == gi]
                     for gi in range(len(ps.sigs))]
        self.where = {k: (gi, j) for gi, keys in enumerate(self.keys) for j, k in enumerate(keys)}
        self.rounds = [
            ps.chunked[gi].begin({k: grads_like[k] for k in keys},
                                 {k: ef[k] for k in keys} if use_ef else (),
                                 comp.get(f"sig{gi}", ()) if isinstance(comp, dict) else (),
                                 compressors.fold_in(seed, gi))
            for gi, keys in enumerate(self.keys)]

    def land(self, i: int, g: torch.Tensor) -> None:
        gi, j = self.where[self.names[i]]
        self.rounds[gi].land(j, g)

    def land_all(self, grads: Tree) -> None:
        for rnd, keys in zip(self.rounds, self.keys):
            rnd.land_all({k: grads[k] for k in keys})

    def collect(self):
        use_ef = self.ps.cfg.error_feedback
        synced, new_ef, new_comp, comm = {}, {}, {}, None
        for gi, (sig, rnd) in enumerate(zip(self.ps.sigs, self.rounds)):
            s_g, s_e, s_c, s_comm = rnd.collect()
            synced.update(s_g)
            if use_ef:
                new_ef.update(s_e)
            if isinstance(s_c, dict):
                new_comp[f"sig{gi}"] = s_c
            s_comm = _reduce_stats(s_comm, _axis_groups(sig, self.ps.axis_groups))
            comm = s_comm if comm is None else merge_stat_dicts(comm, s_comm)
        return ({k: synced[k] for k in self.names},
                {k: new_ef[k] for k in self.names} if use_ef else (),
                new_comp if new_comp else (), comm)


def make_partitioned_grad_sync(cfg: CompressionConfig, leaf_axes, *, group=None,
                               axis_groups=None):
    """:class:`PartitionedSync` for the stateless methods: ``sync(grads, ef,
    seed) -> (synced, new_ef, stats)``, as :func:`make_grad_sync`."""
    if compressors.canonical_name(cfg.method) == "powersgd":
        raise ValueError("powersgd carries a warm start across steps: build its sync with "
                         "PartitionedSync")
    full = PartitionedSync(cfg, leaf_axes, group=group, axis_groups=axis_groups)

    def sync(grads: Tree, ef: Any, seed: int):
        synced, new_ef, _, comm = full(grads, ef, (), seed)
        return synced, new_ef, comm

    return sync


def _binary_axes(is_sharded, shard_axis):
    axes = (shard_axis,) if isinstance(shard_axis, str) else tuple(shard_axis)
    return [axes if s else () for s in is_sharded]


def make_grouped_grad_sync(cfg: CompressionConfig, is_sharded, shard_axis="tensor", *,
                           group=None, axis_groups=None):
    """:func:`make_partitioned_grad_sync` for leaves that are either
    replicated or sharded over ``shard_axis`` (a name or a tuple of names)."""
    return make_partitioned_grad_sync(cfg, _binary_axes(is_sharded, shard_axis), group=group,
                                      axis_groups=axis_groups)


def init_comp_state_partitioned(grads_like: Tree, cfg: CompressionConfig, leaf_axes,
                                seed: int = 0) -> Any:
    """The compressor state of :class:`PartitionedSync`:
    one :func:`init_comp_state` sub-dict per replication signature, keyed
    ``'sig<gi>'`` in sorted-signature order and drawn from ``seed + gi``
    (the JAX ``init_comp_state_partitioned``); ``()`` when every signature
    is stateless."""
    if compressors.canonical_name(cfg.method) != "powersgd":
        return ()
    leaf_axes, sigs, _ = _signatures(leaf_axes)
    state = {}
    for gi, sig in enumerate(sigs):
        sub = init_comp_state({k: g for (k, g), a in zip(grads_like.items(), leaf_axes)
                               if a == sig}, cfg, seed + gi)
        if sub != ():
            state[f"sig{gi}"] = sub
    return state if state else ()


def init_comp_state_grouped(grads_like: Tree, cfg: CompressionConfig, is_sharded,
                            shard_axis="tensor", seed: int = 0) -> Any:
    """:func:`init_comp_state_partitioned` for replicated-or-sharded leaves."""
    return init_comp_state_partitioned(grads_like, cfg, _binary_axes(is_sharded, shard_axis),
                                       seed)


def make_partitioned_clip(leaf_axes, axis_groups=None):
    """``clip_tree(tree, limit)``: scale every leaf by ``min(1, limit /
    ||tree||)``, the full-model L2 norm: squared norms accumulate per
    signature and are summed over the process groups of the signature's
    axes (the JAX ``make_partitioned_clip``'s psum; an absent axis has size
    1), replicated leaves counting once."""
    leaf_axes, sigs, _ = _signatures(leaf_axes)

    def global_norm(tree: Tree) -> torch.Tensor:
        leaves = list(tree.values())
        total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for sig in sigs:
            sq = sum((g.to(torch.float32) ** 2).sum()
                     for g, a in zip(leaves, leaf_axes) if a == sig)
            for g in _axis_groups(sig, axis_groups):
                if mesh.axis_size(g) > 1:
                    sq = mesh.all_reduce_sum(sq, g)
            total = total + sq
        return torch.sqrt(total)

    def clip_tree(tree: Tree, limit: float) -> Tree:
        factor = torch.clamp(limit / torch.clamp(global_norm(tree), min=1e-20), max=1.0)
        return {k: g * factor for k, g in tree.items()}

    return clip_tree


def make_sharded_clip(is_sharded, shard_axis="tensor", axis_groups=None):
    """:func:`make_partitioned_clip` for replicated-or-sharded leaves."""
    return make_partitioned_clip(_binary_axes(is_sharded, shard_axis), axis_groups)
