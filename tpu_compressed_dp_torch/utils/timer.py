"""Wall-clock split timer with device synchronisation.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.utils.timer` (the
reference ``Timer`` of `CIFAR10/core.py:14-27`, which it ran with
``torch.cuda.synchronize``, `dawn.py:129`).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

__all__ = ["Timer", "device_sync"]


def device_sync(device=None) -> None:
    """Block until the device's queued work is done (no-op off CUDA)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Each call returns the seconds since the previous call and (optionally)
    adds them to ``total_time``."""

    def __init__(self, synch: Optional[Callable[[], None]] = None):
        self.synch = synch or (lambda: None)
        self.synch()
        self.last_time = time.perf_counter()
        self.total_time = 0.0

    def __call__(self, include_in_total: bool = True) -> float:
        self.synch()
        now = time.perf_counter()
        delta_t = now - self.last_time
        self.last_time = now
        if include_in_total:
            self.total_time += delta_t
        return delta_t
