"""ImageNet ResNet-18/34/50/101/152 as ``nn.Module``s.

PyTorch counterpart of :mod:`tpu_compressed_dp.models.resnet`: BasicBlock,
Bottleneck and the torchvision-era ResNet with the JAX module's layers and
semantics:

  * convolutions without bias, symmetric padding ``kernel // 2``, weights
    truncated-normal with variance ``2 / fan_out`` (flax's
    ``variance_scaling(2.0, "fan_out", "truncated_normal")``);
  * flax BatchNorm (``models/common.BatchNorm``: decay 0.9, eps 1e-5, the
    biased batch variance, statistics in fp32 whatever the input);
  * the stem's 3x3 / stride-2 max pool padding with -inf (``F.max_pool2d``
    pads so), a global mean pool, and ``fc`` lecun-normal, or N(0, 0.01)
    under ``bn0``, whose blocks start with their last BatchNorm's scale at 0
    (``--init_bn0``);
  * ``dtype=torch.bfloat16`` casts as flax's ``dtype`` does: the input to
    bf16 before the stem, bf16 convolutions and BatchNorm outputs, the mean
    pool and ``fc`` in bf16, fp32 logits; parameters stay fp32 masters.

Every draw comes from a ``torch.Generator`` seeded with ``seed``.  Module
and parameter names follow the flax tree (``conv1``, ``bn1``,
``layer<s>_<b>/{conv1,bn1,...,ds_conv,ds_bn}``, ``fc``), so
:func:`~tpu_compressed_dp_torch.models.common.param_leaves` yields the
leaves in ``jax.tree.flatten`` order (``layer3_10`` before ``layer3_2``) and
``load_flax_params`` carries a flax ResNet's ``params`` and ``batch_stats``
across.  The public input is NHWC, permuted to NCHW inside.
"""

from __future__ import annotations

import math
from typing import Sequence, Type

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_compressed_dp_torch.models.common import BatchNorm, Dense, conv2d, lecun_normal_, \
    trunc_normal_

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152"]

FC_BN0_STD = 0.01


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), stride, padding=k // 2, use_bias=False)``
    with the ResNet's fan-out init; ``weight`` is OIHW."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, *,
                 generator: torch.Generator, dtype: torch.dtype, device):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, kernel // 2, dtype
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel, kernel, device=device))
        trunc_normal_(self.weight.data, math.sqrt(2.0 / (kernel * kernel * c_out)), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, None, stride=self.stride, padding=self.padding,
                      dtype=self.dtype)


def _bn(features: int, device, zero_init: bool = False) -> BatchNorm:
    bn = BatchNorm(features, device=device)
    if zero_init:
        bn.scale.data.zero_()
    return bn


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, features: int, stride: int = 1, downsample: bool = False,
                 bn0: bool = False, *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.conv1 = Conv(c_in, features, 3, stride, **kw)
        self.bn1 = _bn(features, device)
        self.conv2 = Conv(features, features, 3, 1, **kw)
        self.bn2 = _bn(features, device, zero_init=bn0)
        if downsample:
            self.ds_conv = Conv(c_in, features, 1, stride, **kw)
            self.ds_bn = _bn(features, device)
        self.downsample = downsample

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        identity = self.ds_bn(self.ds_conv(x), train) if self.downsample else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, features: int, stride: int = 1, downsample: bool = False,
                 bn0: bool = False, *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.conv1 = Conv(c_in, features, 1, 1, **kw)
        self.bn1 = _bn(features, device)
        self.conv2 = Conv(features, features, 3, stride, **kw)
        self.bn2 = _bn(features, device)
        self.conv3 = Conv(features, features * 4, 1, 1, **kw)
        self.bn3 = _bn(features * 4, device, zero_init=bn0)
        if downsample:
            self.ds_conv = Conv(c_in, features * 4, 1, stride, **kw)
            self.ds_bn = _bn(features * 4, device)
        self.downsample = downsample

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        identity = self.ds_bn(self.ds_conv(x), train) if self.downsample else x
        return F.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, block: Type[nn.Module], layers: Sequence[int], num_classes: int = 1000,
                 bn0: bool = False, dtype: torch.dtype = torch.float32, width: int = 64, *,
                 seed: int = 0, device="cpu"):
        super().__init__()
        self.dtype = dtype
        g = torch.Generator(device=torch.device(device)).manual_seed(seed)
        kw = dict(generator=g, dtype=dtype, device=device)
        self.conv1 = Conv(3, width, 7, 2, **kw)
        self.bn1 = _bn(width, device)
        self.blocks = []
        features = in_features = width
        for stage, blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            for b in range(blocks):
                downsample = b == 0 and (stride != 1
                                         or in_features != features * block.expansion)
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block(in_features, features, stride if b == 0 else 1,
                                            downsample, bn0, **kw))
                self.blocks.append(name)
                in_features = features * block.expansion
            features *= 2
        self.fc = Dense(in_features, num_classes, dtype=dtype, device=device)
        if bn0:
            nn.init.normal_(self.fc.weight.data, 0.0, FC_BN0_STD, generator=g)
        else:
            lecun_normal_(self.fc.weight.data, in_features, g)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = x.mean(dim=(2, 3))  # the global average pool, in the compute dtype
        return self.fc(x).to(torch.float32)


def resnet18(num_classes=1000, bn0=False, dtype=torch.float32, width=64, *, seed=0,
             device="cpu"):
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, bn0, dtype, width, seed=seed,
                  device=device)


def resnet34(num_classes=1000, bn0=False, dtype=torch.float32, width=64, *, seed=0,
             device="cpu"):
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes, bn0, dtype, width, seed=seed,
                  device=device)


def resnet50(num_classes=1000, bn0=False, dtype=torch.float32, width=64, *, seed=0,
             device="cpu"):
    """The ImageNet harness's flagship model: 25,557,032 parameters in 161
    leaves at width 64 and 1000 classes."""
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, bn0, dtype, width, seed=seed,
                  device=device)


def resnet101(num_classes=1000, bn0=False, dtype=torch.float32, width=64, *, seed=0,
              device="cpu"):
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes, bn0, dtype, width, seed=seed,
                  device=device)


def resnet152(num_classes=1000, bn0=False, dtype=torch.float32, width=64, *, seed=0,
              device="cpu"):
    return ResNet(Bottleneck, (3, 8, 36, 3), num_classes, bn0, dtype, width, seed=seed,
                  device=device)
