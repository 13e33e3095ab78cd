"""The DAWNBench CIFAR-10 ResNet-9 as ``nn.Module``s.

PyTorch counterpart of :mod:`tpu_compressed_dp.models.resnet9` (``ConvBN``,
``Residual``, ``ResNet9``): prep conv_bn(64); layer1 conv_bn(128) + pool +
residual; layer2 conv_bn(256) + pool; layer3 conv_bn(512) + pool + residual;
maxpool 4; linear(10, no bias); logits x 0.125, returned in fp32.

The public input is NHWC, as in the JAX package; it is permuted to NCHW
inside.  BatchNorm keeps flax's semantics rather than ``nn.BatchNorm2d``'s:
running averages decay by 0.9, eps 1e-5, the batch variance is the biased
``E[x^2] - E[x]^2`` (clipped at 0) and the running variance is updated with
it.  Module and parameter names follow the flax tree, so
:func:`param_leaves` yields the parameters in ``jax.tree.flatten`` order.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["ConvBN", "Residual", "ResNet9", "BatchNorm", "param_leaves",
           "load_flax_params", "flax_to_leaves", "leaves_to_flax", "scaled_channels"]

BN_MOMENTUM = 0.9  # flax's EMA decay (torch's BatchNorm momentum would be 0.1)
BN_EPS = 1e-5
NUM_CLASSES = 10
CLASSIFIER_WEIGHT = 0.125  # the reference's Mul(weight) on the logits
_CHANNELS = {"prep": 64, "layer1": 128, "layer2": 256, "layer3": 512}


def scaled_channels(scale: float = 1.0) -> Dict[str, int]:
    """The width ablation of the JAX harness (``channels_scale``)."""
    return {k: max(8, int(v * scale)) for k, v in _CHANNELS.items()}


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # flax's default kernel init: truncated normal, variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis of NCHW input."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            dims = (0, 2, 3)
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        shape = (1, -1, 1, 1)
        y = x - mean.reshape(shape)
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        return y * mul.reshape(shape) + self.bias.reshape(shape)


class ConvBN(nn.Module):
    """conv3x3 (no bias) + BatchNorm + ReLU."""

    def __init__(self, c_in: int, c_out: int, *, generator: torch.Generator, device=None):
        super().__init__()
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(torch.empty(c_out, c_in, 3, 3, device=device))
        _lecun_normal_(self.conv.weight.data, c_in * 9, generator)
        self.bn = BatchNorm(c_out, device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = F.conv2d(x, self.conv.weight, padding=1)
        return F.relu(self.bn(x, train))


class Residual(nn.Module):
    """x + conv_bn(conv_bn(x))."""

    def __init__(self, c: int, *, generator: torch.Generator, device=None):
        super().__init__()
        self.res1 = ConvBN(c, c, generator=generator, device=device)
        self.res2 = ConvBN(c, c, generator=generator, device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return x + self.res2(self.res1(x, train), train)


class ResNet9(nn.Module):
    """The 94%-in-79s DAWNBench net, weights drawn from ``seed``."""

    def __init__(self, channels: Optional[Dict[str, int]] = None, *, seed: int = 0,
                 device="cpu"):
        super().__init__()
        ch = channels or dict(_CHANNELS)
        g = torch.Generator(device=torch.device(device)).manual_seed(seed)
        self.prep = ConvBN(3, ch["prep"], generator=g, device=device)
        self.layer1 = ConvBN(ch["prep"], ch["layer1"], generator=g, device=device)
        self.layer1_residual = Residual(ch["layer1"], generator=g, device=device)
        self.layer2 = ConvBN(ch["layer1"], ch["layer2"], generator=g, device=device)
        self.layer3 = ConvBN(ch["layer2"], ch["layer3"], generator=g, device=device)
        self.layer3_residual = Residual(ch["layer3"], generator=g, device=device)
        self.linear = nn.Module()
        self.linear.weight = nn.Parameter(torch.empty(NUM_CLASSES, ch["layer3"], device=device))
        _lecun_normal_(self.linear.weight.data, ch["layer3"], g)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = self.prep(x, train)
        x = F.max_pool2d(self.layer1(x, train), 2)
        x = self.layer1_residual(x, train)
        x = F.max_pool2d(self.layer2(x, train), 2)
        x = F.max_pool2d(self.layer3(x, train), 2)
        x = self.layer3_residual(x, train)
        x = F.max_pool2d(x, 4).reshape(x.shape[0], -1)
        x = F.linear(x, self.linear.weight)
        return (x * CLASSIFIER_WEIGHT).to(torch.float32)


# ---------------------------------------------------------------------------
# The flax tree <-> the module's parameters
# ---------------------------------------------------------------------------


def _flax_path(torch_name: str) -> str:
    """``layer1_residual.res1.conv.weight`` -> ``layer1_residual/res1/conv/kernel``."""
    parts = torch_name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def param_leaves(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The parameters keyed by flax path, in ``jax.tree.flatten`` order
    (sorted keys at every level).  Gradient groups, EF and momentum follow
    this order, so entire-model concatenation lines up with the JAX run."""
    named = {_flax_path(k): p for k, p in model.named_parameters()}
    return {k: named[k] for k in sorted(named, key=lambda p: tuple(p.split("/")))}


def _to_torch_layout(path: str, a: np.ndarray) -> np.ndarray:
    if path.endswith("conv/kernel"):
        return np.transpose(a, (3, 2, 0, 1))  # HWIO -> OIHW
    if path.endswith("kernel"):
        return np.transpose(a, (1, 0))  # Dense (in, out) -> (out, in)
    return a


def _to_flax_layout(path: str, a: np.ndarray) -> np.ndarray:
    if path.endswith("conv/kernel"):
        return np.transpose(a, (2, 3, 1, 0))  # OIHW -> HWIO
    if path.endswith("kernel"):
        return np.transpose(a, (1, 0))
    return a


def _walk(tree: Mapping, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def flax_to_leaves(model: nn.Module, tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax-shaped tree of numpy arrays (params, or EF / momentum trees of
    the same structure) as torch-layout fp32 tensors on the model's device,
    keyed and ordered like :func:`param_leaves`."""
    params = param_leaves(model)
    flat = dict(_walk(tree))
    if set(flat) != set(params):
        raise ValueError(f"tree keys differ from the model's: {sorted(set(flat) ^ set(params))}")
    return {k: torch.from_numpy(np.array(_to_torch_layout(k, np.asarray(flat[k])), np.float32))
            .to(p.device) for k, p in params.items()}


def leaves_to_flax(leaves: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`flax_to_leaves`: a nested dict of numpy arrays."""
    out: Dict = {}
    for path, t in leaves.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_flax_layout(path, t.detach().cpu().numpy())
    return out


def load_flax_params(model: nn.Module, params: Mapping, batch_stats: Mapping) -> None:
    """Copy flax ``params`` and ``batch_stats`` (nested dicts of numpy arrays)
    into the module: conv HWIO -> OIHW, Dense (in, out) -> (out, in), BN
    scale/bias/mean/var as they are."""
    leaves = flax_to_leaves(model, params)
    with torch.no_grad():
        for k, p in param_leaves(model).items():
            p.copy_(leaves[k])
        buffers = dict(model.named_buffers())
        for path, v in _walk(batch_stats):
            buffers[path.replace("/", ".")].copy_(torch.from_numpy(np.asarray(v)))
