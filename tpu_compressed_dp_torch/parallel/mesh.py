"""Process-group set-up: the data-parallel world and its subgroups.

PyTorch counterpart of :mod:`tpu_compressed_dp.parallel.mesh`: where the JAX
package builds a ``('data',)`` mesh and lets ``shard_map`` collectives run
over it, the port runs one process per worker in a ``torch.distributed``
process group (NCCL for CUDA devices, gloo for the CPU).  Run without
``torchrun`` (no ``RANK``/``WORLD_SIZE`` in the environment) it makes a
1-rank group on a free localhost port.

The collectives take an optional ``group``: the hierarchical transport's
pod (ICI) and chip-rank column (DCN) subgroups of
:func:`hier_groups`, the counterpart of the JAX ``axis_index_groups``.  A
group's ranks are in ascending global order, as the JAX groups list them, so
the outputs are in group-rank order.

The LM's ``(data, seq, tensor)`` mesh (the JAX ``make_lm_mesh``) is one
process per mesh position, numbered row-major as the JAX mesh lays out its
devices: rank ``(d * sp + s) * tp + t``; with pipeline stages it is the JAX
``make_pp_mesh``'s ``(data, seq, pipe, tensor)``, rank ``((d * sp + s) * pp +
p) * tp + t``.  :func:`lm_groups` gives a rank its ``workers`` group (the ``dp
* sp`` ranks of its pipe and tensor index, over which the gradient sync
runs), its ``seq`` ring, its ``tensor`` group and its ``pipe`` ring.  Inside the
model the axes' collectives carry hand-placed gradients, as ``shard_map``'s
AD places them in JAX: :func:`ppermute` (the ring's block rotation, whose
backward is the reverse rotation), :func:`copy_to_group` (Megatron's *f*:
identity forward, sum backward, on the replicated input of a
column-parallel product) and :func:`reduce_from_group` (*g*: sum forward,
identity backward, the JAX ``psum`` of a row-parallel output).  These take
``group=None`` as "no such axis" (size 1), as JAX takes ``axis_name=None``.
"""

from __future__ import annotations

import os
import socket
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["resolve_device", "init_process_group", "world", "rank", "free_port",
           "all_gather", "all_reduce_sum", "all_reduce_max", "all_to_all", "hier_groups",
           "destroy", "size", "group_rank", "group_ranks", "axis_size", "LmGroups",
           "lm_groups", "ppermute", "ring_perm", "copy_to_group", "reduce_from_group",
           "sum_over_group"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; asking for CUDA where there is none
    raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(device, *, backend: Optional[str] = None,
                       init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None) -> None:
    """Join (or create) the default process group for ``device``.

    ``backend`` defaults to NCCL for a CUDA device and gloo for the CPU.
    ``backend='gloo'`` on a CUDA device puts several ranks on one card (NCCL
    refuses two ranks on one device); it is only ever asked for explicitly.
    Explicit ``init_method``/``world_size``/``rank`` win; otherwise the
    ``torchrun`` environment; otherwise a 1-rank group.  No-op when a group
    already exists."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if init_method is None and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
        world_size, rank = 1, 0
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def size(group=None) -> int:
    """The ranks of ``group`` (``None``: the default group)."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This process's rank within ``group`` (``None``: the default group)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def group_ranks(group=None) -> List[int]:
    """The global ranks of ``group``, in group-rank order."""
    if group is None or not dist.is_initialized():
        return list(range(world()))
    return list(dist.get_process_group_ranks(group))


def axis_size(group) -> int:
    """The size of a model axis' group, where ``None`` is no axis (1)."""
    return 1 if group is None else size(group)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every group rank's ``t`` stacked in group-rank order, ``[size,
    *t.shape]``: the JAX package's ``all_gather`` over the data axis (or its
    ``axis_index_groups``), as one ``all_gather_into_tensor``.  Without a
    group of more than one rank it is ``t[None]``."""
    w = size(group)
    if w == 1:
        return t.unsqueeze(0)
    out = torch.empty(w * t.numel(), dtype=t.dtype, device=t.device)
    # all_gather_single is the newer name of all_gather_into_tensor
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t.reshape(-1).contiguous(), group=group)
    return out.reshape((w,) + tuple(t.shape))


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks, in a new tensor (``lax.psum``
    with ``axis_index_groups``)."""
    out = t.clone()
    if size(group) > 1:
        dist.all_reduce(out, group=group)
    return out


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of ``t`` over the group's ranks (``lax.pmax``)."""
    out = t.clone()
    if size(group) > 1:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def _sum_exact(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in a new tensor; 16-bit floats are summed
    in float32 and rounded once (for two addends that is the correctly
    rounded 16-bit sum, as the JAX ``psum`` gives; gloo's reduction of
    16-bit types is not relied on)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        out = t.to(torch.float32)
        dist.all_reduce(out, group=group)
        return out.to(t.dtype)
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_to_all(t, axis, 0, 0)`` over a leading ``[size, ...]`` axis:
    slice ``j`` goes to group rank ``j``, and row ``i`` of the result came
    from group rank ``i``."""
    w = size(group)
    if t.shape[0] != w:
        raise ValueError(f"all_to_all needs a leading axis of the group size {w}, "
                         f"got {tuple(t.shape)}")
    if w == 1:
        return t.clone()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


_GROUPS: Dict[Tuple[int, ...], object] = {}
# a workers group's ranks -> the ranks of every workers group of its mesh
_FAMILY: Dict[Tuple[int, ...], List[Tuple[int, ...]]] = {}


def _group_of(ranks: Sequence[int]):
    """The process group of ``ranks`` (ascending global ranks): the default
    group's object where they are the whole world, else a ``dist.new_group``
    made once and cached.  ``new_group`` is collective, so every rank calls
    this for every rank list in one order; ``None`` without a process
    group."""
    ranks = tuple(ranks)
    if not dist.is_initialized():
        return None
    if ranks == tuple(range(world())):
        return dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(ranks=list(ranks))
    return _GROUPS[ranks]


_HIER: Dict[Tuple[Tuple[int, ...], int], Tuple[object, object]] = {}


def hier_groups(world_size: int, pods: int, group=None):
    """This rank's ``(ici_group, dcn_group)`` of the ``pods x chips`` view of
    ``group``'s ranks (the default group, or an LM ``workers`` group;
    ``ops/wire_sharded.hier_axis_groups`` over group ranks).

    ``dist.new_group`` is collective: every rank creates every ICI group
    and then every DCN group of every workers group of its mesh, in the
    lists' order, once per ``(group, pods)`` (cached), so the first
    hierarchical sync must run on every rank."""
    from tpu_compressed_dp_torch.ops.wire_sharded import hier_axis_groups

    members = tuple(group_ranks(group))
    if len(members) != world_size:
        raise ValueError(f"hier_groups: {world_size} workers, the group has {len(members)}")
    key = (members, pods)
    if key not in _HIER:
        ici, dcn = hier_axis_groups(world_size, pods)
        me = rank()
        mine = [None, None]
        for slot, lists in enumerate((ici, dcn)):
            for family in _FAMILY.get(members, [members]):
                for idx in lists:
                    ranks = [family[i] for i in idx]
                    g = _group_of(ranks)
                    if me in ranks:
                        mine[slot] = g
        _HIER[key] = (mine[0], mine[1])
    return _HIER[key]


# ---------------------------------------------------------------------------
# The LM's (data, seq, tensor) mesh
# ---------------------------------------------------------------------------


class LmGroups(NamedTuple):
    """A rank's place on the ``(dp, sp, [pp,] tp)`` mesh and its groups:
    ``workers`` (the ``dp * sp`` compression workers of its pipe and tensor
    index, in ``(data, seq)`` row-major order, the JAX ``("data", "seq")``
    axes), ``seq`` (its ring, in seq order), ``tensor`` (in tensor order)
    and ``pipe`` (its stages, in pipe order).  ``seq``, ``tensor`` and
    ``pipe`` are ``None`` where the axis has size 1; ``workers`` is ``None``
    only without a process group (one process)."""

    dp: int
    sp: int
    tp: int
    data_index: int
    seq_index: int
    tensor_index: int
    workers: object
    seq: object
    tensor: object
    pp: int = 1
    pipe_index: int = 0
    pipe: object = None


_LM: Dict[Tuple[int, int, int, int], LmGroups] = {}


def lm_groups(dp: int, sp: int = 1, tp: int = 1, pp: int = 1) -> LmGroups:
    """This rank's :class:`LmGroups` on the ``(dp, sp, pp, tp)`` mesh, whose
    size must be the world's.  Collective on first use: every rank creates
    every workers group, then every seq group, then every tensor group, then
    every pipe group (cached, as :func:`hier_groups`)."""
    if dp * sp * pp * tp != world():
        raise ValueError(f"mesh dp{dp} x sp{sp} x pp{pp} x tp{tp} has {dp * sp * pp * tp} "
                         f"positions, the world {world()} ranks")
    key = (dp, sp, tp, pp)
    if key not in _LM:
        def at(d, s, p, t):
            return ((d * sp + s) * pp + p) * tp + t

        workers = [[at(d, s, p, t) for d in range(dp) for s in range(sp)]
                   for p in range(pp) for t in range(tp)]
        seqs = [[at(d, s, p, t) for s in range(sp)]
                for d in range(dp) for p in range(pp) for t in range(tp)]
        tensors = [[at(d, s, p, t) for t in range(tp)]
                   for d in range(dp) for s in range(sp) for p in range(pp)]
        pipes = [[at(d, s, p, t) for p in range(pp)]
                 for d in range(dp) for s in range(sp) for t in range(tp)]
        me = rank()
        mine = []
        # a seq, tensor or pipe axis of size 1 is no axis (None); the workers
        # always form a group, the sync's
        for lists in (workers, seqs if sp > 1 else [], tensors if tp > 1 else [],
                      pipes if pp > 1 else []):
            pick = None
            for ranks in lists:
                g = _group_of(ranks)
                if me in ranks:
                    pick = g
            mine.append(pick)
        family = [tuple(r) for r in workers]
        for ranks in family:
            _FAMILY[ranks] = family
        _LM[key] = LmGroups(dp, sp, tp, me // (sp * pp * tp), (me // (pp * tp)) % sp, me % tp,
                            *mine[:3], pp, (me // tp) % pp, mine[3])
    return _LM[key]


def ring_perm(n: int) -> List[Tuple[int, int]]:
    """The ring rotation ``i -> i + 1`` (mod ``n``) as ``(src, dst)`` pairs."""
    return [(i, (i + 1) % n) for i in range(n)]


def _permute(t: torch.Tensor, perm, group) -> torch.Tensor:
    """``lax.ppermute``: this rank's ``t`` goes to the group rank its pair
    names; a rank no pair sends to gets zeros.  One ``all_to_all_single``
    with zero-length splits but the destination's (gloo takes CUDA tensors
    there, not in ``send``/``recv``)."""
    w, me = size(group), group_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    n = t.numel()
    flat = t.reshape(-1).contiguous()
    if w == 1:
        return (flat.clone() if dst else torch.zeros_like(flat)).reshape(t.shape)
    out = torch.empty(n * len(src), dtype=t.dtype, device=t.device)
    dist.all_to_all_single(out, flat, [n if j in src else 0 for j in range(w)],
                           [n if j in dst else 0 for j in range(w)], group=group)
    return (out if src else torch.zeros_like(flat)).reshape(t.shape)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(t, perm, group)

    @staticmethod
    def backward(ctx, g):
        # the transpose of a permutation is its inverse
        return _permute(g, [(d, s) for s, d in ctx.perm], ctx.group), None, None


def ppermute(t: torch.Tensor, perm, group) -> torch.Tensor:
    """``lax.ppermute(t, axis, perm)`` over ``group`` (``perm`` in group
    ranks), differentiable: the backward sends each cotangent back along the
    inverse permutation, which every rank of the group runs together."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    return _PPermute.apply(t, perm, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_exact(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_exact(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: ``x`` unchanged, its cotangent summed over ``group``.
    It marks a tensor that every rank of the group holds whole (the
    replicated activation) where it feeds a rank's shard of a product, which
    is where the JAX ``shard_map`` AD psums the cotangent of the implicit
    ``pvary``.  The identity without an axis."""
    return x if axis_size(group) == 1 else _CopyToGroup.apply(x, group)


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_exact(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum_exact(g, ctx.group), None


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, and its cotangent summed over ``group``
    too: the JAX ``psum`` of a value that each rank then uses in a term of
    its own (a pipeline stage's share of the head), where ``shard_map``'s AD
    psums the cotangents of those uses.  The identity without an axis."""
    return x if axis_size(group) == 1 else _SumOverGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*: ``x`` summed over ``group`` (the JAX ``psum`` of a
    row-parallel product or a vocab shard's statistic), its cotangent
    passed through unchanged.  The identity without an axis."""
    return x if axis_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def destroy() -> None:
    _HIER.clear()
    _GROUPS.clear()
    _FAMILY.clear()
    _LM.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
