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
"""

from __future__ import annotations

import os
import socket
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["resolve_device", "init_process_group", "world", "rank", "free_port",
           "all_gather", "all_reduce_sum", "all_to_all", "hier_groups", "destroy"]


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


def _size(group) -> int:
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every group rank's ``t`` stacked in group-rank order, ``[size,
    *t.shape]``: the JAX package's ``all_gather`` over the data axis (or its
    ``axis_index_groups``), as one ``all_gather_into_tensor``.  Without a
    group of more than one rank it is ``t[None]``."""
    w = _size(group)
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
    if _size(group) > 1:
        dist.all_reduce(out, group=group)
    return out


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_to_all(t, axis, 0, 0)`` over a leading ``[size, ...]`` axis:
    slice ``j`` goes to group rank ``j``, and row ``i`` of the result came
    from group rank ``i``."""
    w = _size(group)
    if t.shape[0] != w:
        raise ValueError(f"all_to_all needs a leading axis of the group size {w}, "
                         f"got {tuple(t.shape)}")
    if w == 1:
        return t.clone()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


_HIER: Dict[Tuple[int, int], Tuple[object, object]] = {}


def hier_groups(world_size: int, pods: int):
    """This rank's ``(ici_group, dcn_group)`` of the ``pods x chips`` view of
    the world (``ops/wire_sharded.hier_axis_groups``).

    ``dist.new_group`` is collective: every rank creates every ICI group and
    then every DCN group, in the lists' order, once per ``(world, pods)``
    (cached), so the first hierarchical sync must run on every rank."""
    from tpu_compressed_dp_torch.ops.wire_sharded import hier_axis_groups

    key = (world_size, pods)
    if key not in _HIER:
        ici, dcn = hier_axis_groups(world_size, pods)
        me = rank()
        mine = [None, None]
        for slot, lists in enumerate((ici, dcn)):
            for ranks in lists:
                g = dist.new_group(ranks=ranks)
                if me in ranks:
                    mine[slot] = g
        _HIER[key] = (mine[0], mine[1])
    return _HIER[key]


def destroy() -> None:
    _HIER.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
