"""Compressed data-parallel gradient synchronisation (simulate mode).

PyTorch counterpart of :mod:`tpu_compressed_dp.parallel.dp` for the Top-K
slice: per reduction group (one parameter tensor for ``layerwise``, the whole
flattened gradient for ``entiremodel``) the local gradient plus the EF
residual is compressed, kept dense with zeros at dropped coordinates, and
averaged over the workers with ``dist.all_reduce(comp) / world`` (the JAX
engine's ``lax.psum(comp) / world``).  Bytes on the wire are accounted
analytically in the same stat keys as the JAX engine.

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
           "group_concat", "group_split", "init_ef_state", "wire_transport"]

Tree = Dict[str, torch.Tensor]

# the reference DDP's bucket unit is MiB (`ddp.py:182,188`)
BUCKET_MB = 1024.0 * 1024.0


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """The JAX package's ``CompressionConfig`` fields and defaults
    (``tpu_compressed_dp/parallel/dp.py``).  This slice runs ``method`` none
    or topk, ``granularity`` layerwise or entiremodel, ``mode='simulate'``,
    ``transport='allgather'`` and ``sync_overlap=1``; :func:`make_grad_sync`
    raises ``NotImplementedError`` for the rest, naming the ROADMAP item."""

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


def _check_ported(cfg: CompressionConfig) -> None:
    """Refuse the parts of the config this slice does not carry."""
    later = []
    if cfg.mode != "simulate":
        later.append("mode='wire' (ROADMAP.md queue 1, item 7)")
    if cfg.transport != "allgather":
        later.append(f"transport={cfg.transport!r} (ROADMAP.md queue 1, item 8)")
    if cfg.granularity == "bucketed":
        later.append("granularity='bucketed' (ROADMAP.md queue 1, item 6)")
    if cfg.sync_overlap != 1:
        later.append("sync_overlap > 1 (ROADMAP.md queue 1, item 9)")
    if later:
        raise NotImplementedError("not ported yet: " + "; ".join(later))


def wire_transport(name: str) -> str:
    """Which collective the method's wire form rides (the psum/allgather
    billing split): dense psum-reduces; Top-K's worker-distinct (value,
    index) pairs ride an all_gather."""
    return "psum" if name == "none" else "allgather"


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
    """Build ``sync(grads, ef) -> (synced, new_ef, stats)`` over the default
    process group.

    ``grads`` are this rank's gradients at the scale the reference compresses
    (see ``train/step.py``); ``synced`` is the world mean.  ``stats`` are 0-d
    float32 tensors on the gradients' device, keyed as in the JAX engine
    (``sent_elems``, ``sent_bits`` and its per-collective split,
    ``dense_elems``, ``num_collectives``)."""
    _check_ported(cfg)
    comp = compressors.get_compressor(cfg.method, ratio=cfg.ratio)
    bits_per_elem = compressors.payload_bits_per_elem(comp.name)

    def sync(grads: Tree, ef: Any) -> Tuple[Tree, Any, Dict[str, torch.Tensor]]:
        world = mesh.world()
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
        dense_total = 0.0
        for idxs in groups:
            flat = group_concat(leaves, idxs)
            acc = flat + group_concat(ef_leaves, idxs) if use_ef else flat
            n_g = flat.shape[0]
            fuse_t = None
            if (acc.dtype == torch.float32 and comp.name == "topk"
                    and kernels.use_fused_sparsify(n_g, acc.device)):
                keep = compressors.topk_keep_count(n_g, cfg.ratio)
                fuse_t = kernels.topk_threshold(acc.abs(), keep)
            if fuse_t is not None:
                comp_flat, new_ef_flat, group_sent = kernels.fused_sparsify(
                    acc.contiguous(), fuse_t, want_ef=use_ef)
            else:
                comp_flat = comp.fn(acc)
                new_ef_flat = acc - comp_flat if use_ef else None
                if comp.is_sparsifier:
                    group_sent = torch.count_nonzero(comp_flat).to(torch.float32)
                else:
                    group_sent = torch.full((), float(n_g), dtype=torch.float32,
                                            device=device)
                    # all_reduce works in place and the dense payload may
                    # alias the caller's gradient
                    comp_flat = comp_flat.clone()
            group_bits = group_sent * bits_per_elem
            if world > 1:
                dist.all_reduce(comp_flat)
            reduced = comp_flat / world
            group_split(reduced, leaves, idxs, out_leaves)
            if use_ef:
                group_split(new_ef_flat, leaves, idxs, new_ef_leaves, dtype=torch.float32)
            if wire_transport(comp.name) == "psum":
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
            "sent_bits_alltoall": zero,
            "sent_bits_ici": zero,
            "sent_bits_dcn": zero,
            "sent_bits_dcn_route": zero,
            "dense_elems": torch.full((), dense_total, dtype=torch.float32, device=device),
            "num_collectives": torch.full((), float(len(groups)), dtype=torch.float32,
                                          device=device),
        }
        return out, new_ef, stats

    return sync
