"""Model adapter glue: a module -> the train step's ``apply_fn`` protocol.

PyTorch counterpart of :mod:`tpu_compressed_dp.models.common`.  In the port
the module holds its parameters and BatchNorm buffers, so
``apply_fn(model, x, train) -> logits`` (BatchNorm running statistics update
in place during a training forward).
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["make_normalizing_apply_fn"]


def make_normalizing_apply_fn(mean, std):
    """``apply_fn`` with on-device input normalisation: loaders ship raw
    uint8 NHWC and the step computes ``(x - mean) / std`` in fp32 (``mean``
    and ``std`` on the 0-255 scale), so 1 byte per pixel crosses to the
    device instead of 4."""
    mean_cpu = torch.as_tensor(mean, dtype=torch.float32)
    std_cpu = torch.as_tensor(std, dtype=torch.float32)
    cache: Dict[torch.device, tuple] = {}

    def apply_fn(model, x: torch.Tensor, train: bool) -> torch.Tensor:
        if x.device not in cache:
            cache[x.device] = (mean_cpu.to(x.device), std_cpu.to(x.device))
        m, s = cache[x.device]
        return model((x.to(torch.float32) - m) / s, train=train)

    return apply_fn
