"""Process-group set-up: the data-parallel world.

PyTorch counterpart of :mod:`tpu_compressed_dp.parallel.mesh`: where the JAX
package builds a ``('data',)`` mesh and lets ``shard_map`` collectives run
over it, the port runs one process per worker in a ``torch.distributed``
process group (NCCL for CUDA devices, gloo for the CPU).  Run without
``torchrun`` (no ``RANK``/``WORLD_SIZE`` in the environment) it makes a
1-rank group on a free localhost port.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["resolve_device", "init_process_group", "world", "rank", "free_port",
           "destroy"]


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


def init_process_group(device, *, init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None) -> None:
    """Join (or create) the default process group for ``device``.

    Explicit ``init_method``/``world_size``/``rank`` win; otherwise the
    ``torchrun`` environment; otherwise a 1-rank group.  No-op when a group
    already exists."""
    if dist.is_initialized():
        return
    device = torch.device(device)
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


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
