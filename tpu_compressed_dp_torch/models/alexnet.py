"""CIFAR-sized AlexNet, module flavour (``--network alexnet_module``).

PyTorch counterpart of :mod:`tpu_compressed_dp.models.alexnet`: five convs
with bias (the first with stride 2) and three max-pools take 32x32 to
2x2x256; then dropout, fc1 (4096), dropout, fc2 (4096), fc3, with ReLUs.
Init is flax's default: lecun-normal kernels, zero biases, drawn from a
``torch.Generator`` seeded with ``seed`` (23,272,266 parameters).  Dropout
is flax's (``models/common.py``).  The 2x2x256 map is flattened in NHWC
order, so ``fc1``'s weight is the flax kernel transposed, row for row.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_compressed_dp_torch.models.common import (Dense, Dropout, flax_dropout, flatten_nhwc,
                                                   lecun_normal_)

__all__ = ["AlexNet"]

# (name, c_out, stride) of the features
_CONVS = (("conv1", 64, 2), ("conv2", 192, 1), ("conv3", 384, 1), ("conv4", 256, 1),
          ("conv5", 256, 1))
# max-pool after these convs
_POOL_AFTER = ("conv1", "conv2", "conv5")


class AlexNet(nn.Module):
    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5, *, seed: int = 0,
                 device="cpu"):
        super().__init__()
        self.dropout_rate = dropout_rate
        g = torch.Generator(device=torch.device(device)).manual_seed(seed)
        c_in = 3
        for name, c_out, _ in _CONVS:
            conv = nn.Module()
            conv.weight = nn.Parameter(torch.empty(c_out, c_in, 3, 3, device=device))
            conv.bias = nn.Parameter(torch.zeros(c_out, device=device))
            lecun_normal_(conv.weight.data, 9 * c_in, g)
            self.add_module(name, conv)
            c_in = c_out
        for name, (a, b) in (("fc1", (256 * 2 * 2, 4096)), ("fc2", (4096, 4096)),
                             ("fc3", (4096, num_classes))):
            fc = Dense(a, b, device=device)
            lecun_normal_(fc.weight.data, a, g)
            self.add_module(name, fc)

    def forward(self, x: torch.Tensor, train: bool = False, dropout: Dropout = None):
        x = x.permute(0, 3, 1, 2)
        for name, _, stride in _CONVS:
            conv = getattr(self, name)
            x = F.relu(F.conv2d(x, conv.weight, conv.bias, stride=stride, padding=1))
            if name in _POOL_AFTER:
                x = F.max_pool2d(x, 2)
        x = flatten_nhwc(x)
        if train:
            x = flax_dropout(x, self.dropout_rate, dropout, 0)
        x = F.relu(self.fc1(x))
        if train:
            x = flax_dropout(x, self.dropout_rate, dropout, 1)
        x = F.relu(self.fc2(x))
        return self.fc3(x)

