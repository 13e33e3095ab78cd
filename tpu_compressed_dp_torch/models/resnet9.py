"""The DAWNBench CIFAR-10 nets of the graph family as ``nn.Module``s.

PyTorch counterpart of :mod:`tpu_compressed_dp.models.resnet9`:

  * ``ResNet9``: prep conv_bn(64); layer1 conv_bn(128) + pool + residual;
    layer2 conv_bn(256) + pool; layer3 conv_bn(512) + pool + residual;
    maxpool 4; linear(10, no bias); logits x 0.125, returned in fp32;
  * ``AlexNetGraph`` (``--network alexnet``): conv_bn(64, stride 2) + pool;
    conv_bn(192) + pool; conv_bn(384), conv_bn(256), conv_bn(256); two
    pools; linear(10, no bias); logits x 0.125.

The public input is NHWC, as in the JAX package; it is permuted to NCHW
inside.  BatchNorm keeps flax's semantics (``models/common.py``).  Module
and parameter names follow the flax tree, so :func:`param_leaves` yields the
parameters in ``jax.tree.flatten`` order.  ``dtype=torch.bfloat16`` is the
JAX modules' ``dtype``: bf16 compute (every conv and the classifier cast
their input and parameters to bf16; BatchNorm's statistics and
normalisation run in fp32 and round to bf16), fp32 master parameters, fp32
logits.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_compressed_dp_torch.models.common import (BatchNorm, Dense, conv2d, flax_to_leaves,
                                                   flatten_nhwc, leaves_to_flax, lecun_normal_,
                                                   load_flax_params, param_leaves)

__all__ = ["ConvBN", "Residual", "ResNet9", "AlexNetGraph", "BatchNorm", "param_leaves",
           "load_flax_params", "flax_to_leaves", "leaves_to_flax", "scaled_channels",
           "alexnet_channels"]

NUM_CLASSES = 10
CLASSIFIER_WEIGHT = 0.125  # the reference's Mul(weight) on the logits
_CHANNELS = {"prep": 64, "layer1": 128, "layer2": 256, "layer3": 512}
_ALEXNET_CHANNELS = {"prep": 64, "layer1": 192, "layer2": 384, "layer3": 256, "layer4": 256}


def _scaled(ch: Dict[str, int], scale: float) -> Dict[str, int]:
    return {k: max(8, int(v * scale)) for k, v in ch.items()}


def scaled_channels(scale: float = 1.0) -> Dict[str, int]:
    """ResNet-9's widths under the JAX harness's ``channels_scale``."""
    return _scaled(_CHANNELS, scale)


def alexnet_channels(scale: float = 1.0) -> Dict[str, int]:
    """The graph AlexNet's widths under ``channels_scale``."""
    return _scaled(_ALEXNET_CHANNELS, scale)


class ConvBN(nn.Module):
    """conv3x3 (no bias, ``stride``) + BatchNorm + ReLU."""

    def __init__(self, c_in: int, c_out: int, *, generator: torch.Generator, stride: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(torch.empty(c_out, c_in, 3, 3, device=device))
        lecun_normal_(self.conv.weight.data, c_in * 9, generator)
        self.bn = BatchNorm(c_out, device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = conv2d(x, self.conv.weight, None, stride=self.stride, dtype=self.dtype)
        return F.relu(self.bn(x, train))


class Residual(nn.Module):
    """x + conv_bn(conv_bn(x))."""

    def __init__(self, c: int, *, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.res1 = ConvBN(c, c, generator=generator, dtype=dtype, device=device)
        self.res2 = ConvBN(c, c, generator=generator, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return x + self.res2(self.res1(x, train), train)


def classifier(c_in: int, num_classes: int = NUM_CLASSES, *, generator: torch.Generator,
               dtype: torch.dtype, device) -> Dense:
    """The graph nets' ``Dense(num_classes, use_bias=False)``, lecun-normal."""
    linear = Dense(c_in, num_classes, use_bias=False, dtype=dtype, device=device)
    lecun_normal_(linear.weight.data, c_in, generator)
    return linear


class ResNet9(nn.Module):
    """The 94%-in-79s DAWNBench net, weights drawn from ``seed``."""

    def __init__(self, channels: Optional[Dict[str, int]] = None, *, seed: int = 0,
                 device="cpu", dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = channels or dict(_CHANNELS)
        self.dtype = dtype
        g = torch.Generator(device=torch.device(device)).manual_seed(seed)
        kw = dict(generator=g, dtype=dtype, device=device)
        self.prep = ConvBN(3, ch["prep"], **kw)
        self.layer1 = ConvBN(ch["prep"], ch["layer1"], **kw)
        self.layer1_residual = Residual(ch["layer1"], **kw)
        self.layer2 = ConvBN(ch["layer1"], ch["layer2"], **kw)
        self.layer3 = ConvBN(ch["layer2"], ch["layer3"], **kw)
        self.layer3_residual = Residual(ch["layer3"], **kw)
        self.linear = classifier(ch["layer3"], **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW
        x = self.prep(x, train)
        x = F.max_pool2d(self.layer1(x, train), 2)
        x = self.layer1_residual(x, train)
        x = F.max_pool2d(self.layer2(x, train), 2)
        x = F.max_pool2d(self.layer3(x, train), 2)
        x = self.layer3_residual(x, train)
        x = flatten_nhwc(F.max_pool2d(x, 4))
        return (self.linear(x) * CLASSIFIER_WEIGHT).to(torch.float32)


class AlexNetGraph(nn.Module):
    """The graph-spec AlexNet variant, weights drawn from ``seed``."""

    def __init__(self, channels: Optional[Dict[str, int]] = None, *, seed: int = 0,
                 device="cpu", dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = channels or dict(_ALEXNET_CHANNELS)
        self.dtype = dtype
        g = torch.Generator(device=torch.device(device)).manual_seed(seed)
        kw = dict(generator=g, dtype=dtype, device=device)
        self.prep = ConvBN(3, ch["prep"], stride=2, **kw)
        self.layer1 = ConvBN(ch["prep"], ch["layer1"], **kw)
        self.layer2 = ConvBN(ch["layer1"], ch["layer2"], **kw)
        self.layer3 = ConvBN(ch["layer2"], ch["layer3"], **kw)
        self.layer4 = ConvBN(ch["layer3"], ch["layer4"], **kw)
        self.linear = classifier(ch["layer4"], **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.max_pool2d(self.prep(x, train), 2)
        x = F.max_pool2d(self.layer1(x, train), 2)
        x = self.layer4(self.layer3(self.layer2(x, train), train), train)
        x = flatten_nhwc(F.max_pool2d(F.max_pool2d(x, 2), 2))
        return (self.linear(x) * CLASSIFIER_WEIGHT).to(torch.float32)
