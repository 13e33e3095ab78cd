"""VGG for CIFAR-10.

PyTorch counterpart of :mod:`tpu_compressed_dp.models.vgg`: configs A/B/D/E
with optional BatchNorm, torch ``AdaptiveAvgPool2d`` to 7x7 (which tiles a
1x1 map up to 7x7 at CIFAR sizes), three Dense layers with flax's dropout
after the first two, and the JAX module's init: convs truncated-normal with
variance 2 / fan_out, linears N(0, 0.01), biases zero, every draw from a
``torch.Generator`` seeded with ``seed``.  ``vgg16()`` is config D without
BN (134,301,514 parameters).

Parameter names are flax's auto-names (``Conv_0`` .. ``Conv_12``,
``BatchNorm_<i>``, ``fc1`` .. ``fc3``), so
:func:`~tpu_compressed_dp_torch.models.common.param_leaves` orders them as
``jax.tree.flatten`` does (``Conv_0, Conv_1, Conv_10, ...``).  The input is
NHWC; convolutions run NCHW, and the pooled map is flattened in NHWC order
so that ``fc1``'s weight is the flax kernel transposed, row for row.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_compressed_dp_torch.models.common import (BatchNorm, Dense, Dropout, flax_dropout,
                                                   flatten_nhwc, trunc_normal_)

__all__ = ["VGG", "vgg16", "CFGS", "adaptive_avg_pool"]

CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
          512, 512, 512, 512, "M"],
}
POOL_HW = 7
FC_STD = 0.01


def adaptive_avg_pool(x: torch.Tensor, out_hw: int) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` on NHWC: output bin ``i`` averages input
    rows ``floor(i*H/O) .. ceil((i+1)*H/O)-1``; tiles when H < O."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)


class VGG(nn.Module):
    def __init__(self, cfg: Union[str, Sequence] = "D", batch_norm: bool = False,
                 num_classes: int = 10, dropout_rate: float = 0.5, *, seed: int = 0,
                 device="cpu"):
        super().__init__()
        self.cfg = list(CFGS[cfg] if isinstance(cfg, str) else cfg)
        self.batch_norm = batch_norm
        self.dropout_rate = dropout_rate
        g = torch.Generator(device=torch.device(device)).manual_seed(seed)
        c_in, i = 3, 0
        for v in self.cfg:
            if v == "M":
                continue
            conv = nn.Module()
            conv.weight = nn.Parameter(torch.empty(v, c_in, 3, 3, device=device))
            conv.bias = nn.Parameter(torch.zeros(v, device=device))
            # variance_scaling(2.0, "fan_out", "truncated_normal"): fan_out = 9 * v
            trunc_normal_(conv.weight.data, math.sqrt(2.0 / (9 * v)), g)
            self.add_module(f"Conv_{i}", conv)
            if batch_norm:
                self.add_module(f"BatchNorm_{i}", BatchNorm(v, device=device))
            c_in, i = v, i + 1
        self.fc1 = self._fc(c_in * POOL_HW * POOL_HW, 4096, g, device)
        self.fc2 = self._fc(4096, 4096, g, device)
        self.fc3 = self._fc(4096, num_classes, g, device)

    @staticmethod
    def _fc(c_in: int, c_out: int, g: torch.Generator, device) -> Dense:
        fc = Dense(c_in, c_out, device=device)
        nn.init.normal_(fc.weight.data, 0.0, FC_STD, generator=g)
        return fc

    def forward(self, x: torch.Tensor, train: bool = False, dropout: Dropout = None):
        x = x.permute(0, 3, 1, 2)
        i = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2)
                continue
            conv = getattr(self, f"Conv_{i}")
            x = F.conv2d(x, conv.weight, conv.bias, padding=1)
            if self.batch_norm:
                x = getattr(self, f"BatchNorm_{i}")(x, train)
            x = F.relu(x)
            i += 1
        x = flatten_nhwc(F.adaptive_avg_pool2d(x, POOL_HW))
        x = F.relu(self.fc1(x))
        if train:
            x = flax_dropout(x, self.dropout_rate, dropout, 0)
        x = F.relu(self.fc2(x))
        if train:
            x = flax_dropout(x, self.dropout_rate, dropout, 1)
        return self.fc3(x)



def vgg16(num_classes: int = 10, batch_norm: bool = False, *, seed: int = 0,
          device="cpu") -> VGG:
    return VGG(cfg="D", batch_norm=batch_norm, num_classes=num_classes, seed=seed,
               device=device)
