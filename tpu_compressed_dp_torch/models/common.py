"""Model glue shared by the port's CNNs (the CIFAR nets and the ImageNet ResNets).

PyTorch counterpart of :mod:`tpu_compressed_dp.models.common`.  In the port
the module holds its parameters and BatchNorm buffers, so
``apply_fn(model, x, train, dropout=None) -> logits`` (BatchNorm running
statistics update in place during a training forward).

Also here, for every model:

  * the layers with flax's semantics (:class:`BatchNorm`, :class:`Dense`,
    the conv and init helpers) and their compute dtype: ``bfloat16`` casts
    the parameters and the input to bf16 for the product, as flax's
    ``dtype`` does, while the parameters stay fp32 masters;
  * dropout as flax's ``nn.Dropout`` (``where(keep, x / keep_prob, 0)``),
    its keep masks drawn from a ``torch.Generator`` or handed in;
  * the flax tree <-> module bridge: :func:`param_leaves` keys the
    parameters by flax path in ``jax.tree.flatten`` order, and
    :func:`flax_to_leaves` / :func:`leaves_to_flax` / :func:`load_flax_params`
    carry trees across, deciding each kernel's layout by its rank (4-D:
    conv HWIO <-> OIHW; 2-D: Dense ``(in, out)`` <-> ``(out, in)``).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["make_normalizing_apply_fn", "BatchNorm", "Dense", "conv2d", "trunc_normal_",
           "lecun_normal_", "flax_dropout", "Dropout", "flatten_nhwc", "param_leaves",
           "flax_path", "to_torch_layout", "to_flax_layout", "flax_to_leaves",
           "leaves_to_flax", "load_flax_params"]

BN_MOMENTUM = 0.9  # flax's EMA decay (torch's BatchNorm momentum would be 0.1)
BN_EPS = 1e-5
# flax's truncated-normal initializers divide the std by the std of a unit
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978

#: a training forward's dropout: a generator to draw the keep masks from, or
#: the masks themselves (booleans, one per dropout layer in forward order)
Dropout = Union[torch.Generator, Sequence[torch.Tensor], None]


def make_normalizing_apply_fn(mean, std):
    """``apply_fn`` with on-device input normalisation: loaders ship raw
    uint8 NHWC and the step computes ``(x - mean) / std`` in fp32 (``mean``
    and ``std`` on the 0-255 scale), so 1 byte per pixel crosses to the
    device instead of 4.  ``dropout`` goes to the model only when given."""
    mean_cpu = torch.as_tensor(mean, dtype=torch.float32)
    std_cpu = torch.as_tensor(std, dtype=torch.float32)
    cache: Dict[torch.device, tuple] = {}

    def apply_fn(model, x: torch.Tensor, train: bool, dropout: Dropout = None) -> torch.Tensor:
        if x.device not in cache:
            cache[x.device] = (mean_cpu.to(x.device), std_cpu.to(x.device))
        m, s = cache[x.device]
        kw = {} if dropout is None else {"dropout": dropout}
        return model((x.to(torch.float32) - m) / s, train=train, **kw)

    return apply_fn


# ---------------------------------------------------------------------------
# Layers with flax's semantics
# ---------------------------------------------------------------------------


def trunc_normal_(w: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """flax's truncated-normal draw: ``std`` is the target standard deviation,
    the samples a unit normal truncated to [-2, 2] scaled to it."""
    s = std / _TRUNC_STD
    nn.init.trunc_normal_(w, std=s, a=-2.0 * s, b=2.0 * s, generator=generator)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    trunc_normal_(w, math.sqrt(1.0 / fan_in), generator)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis of NCHW input.

    Running averages decay by 0.9, eps 1e-5, the batch variance is the
    biased ``E[x^2] - E[x]^2`` (clipped at 0) and updates the running
    variance.  Statistics and the normalisation run in fp32, or the input's
    dtype where that is wider (flax's ``promote_types(dtype, float32)``); the
    output has the input's dtype (flax's ``dtype``)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            dims = (0, 2, 3)
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        shape = (1, -1, 1, 1)
        y = xf - mean.reshape(shape)
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        return (y * mul.reshape(shape) + self.bias.reshape(shape)).to(x.dtype)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], *,
           stride: int = 1, padding: int = 1,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax ``nn.Conv`` (symmetric integer ``padding``) at compute ``dtype``:
    input, kernel and bias cast to it, the result in it."""
    return F.conv2d(x.to(dtype), weight.to(dtype), None if bias is None else bias.to(dtype),
                    stride=stride, padding=padding)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` is ``[out, in]`` (the flax kernel
    transposed); input, kernel and bias are cast to ``dtype``."""

    def __init__(self, c_in: int, c_out: int, *, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(c_out, c_in, device=device))
        self.bias = nn.Parameter(torch.zeros(c_out, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten NCHW activations in NHWC order, the order of the flax nets'
    ``reshape`` and so of the rows of the flax Dense kernel that follows."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def flax_dropout(x: torch.Tensor, rate: float, source: Dropout, index: int) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: ``where(keep, x / keep_prob, 0)``.
    ``source`` is a generator on ``x``'s device, which draws the keep mask
    (``U[0, 1) < keep_prob``), or the masks themselves, of which this layer
    takes the ``index``-th.  Rate 0 is the identity."""
    if rate == 0.0:
        return x
    if source is None:
        raise ValueError("a training forward with dropout needs dropout=<generator or masks>")
    keep_prob = 1.0 - rate
    if isinstance(source, torch.Generator):
        keep = torch.rand(x.shape, generator=source, device=x.device) < keep_prob
    else:
        keep = source[index].to(device=x.device, dtype=torch.bool)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# The flax tree <-> the module's parameters
# ---------------------------------------------------------------------------


def flax_path(torch_name: str) -> str:
    """``layer1_residual.res1.conv.weight`` -> ``layer1_residual/res1/conv/kernel``."""
    parts = torch_name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def param_leaves(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The parameters keyed by flax path, in ``jax.tree.flatten`` order
    (sorted keys at every level, as strings: ``Conv_10`` before ``Conv_2``).
    Gradient groups, EF and momentum follow this order, so entire-model
    concatenation lines up with the JAX run."""
    named = {flax_path(k): p for k, p in model.named_parameters()}
    return {k: named[k] for k in sorted(named, key=lambda p: tuple(p.split("/")))}


def _permuted(path: str, a, conv_axes):
    if not path.endswith("kernel") or a.ndim not in (2, 4):
        return a
    axes = conv_axes if a.ndim == 4 else (1, 0)
    return a.permute(*axes) if isinstance(a, torch.Tensor) else a.transpose(axes)


def to_torch_layout(path: str, a):
    """A flax leaf in the port's layout: a 4-D kernel HWIO -> OIHW, a 2-D
    kernel ``(in, out)`` -> ``(out, in)``; anything else as it is.  Numpy
    arrays are transposed, tensors permuted (a view)."""
    return _permuted(path, a, (3, 2, 0, 1))


def to_flax_layout(path: str, a):
    """The inverse of :func:`to_torch_layout`: OIHW -> HWIO, ``(out, in)`` ->
    ``(in, out)``."""
    return _permuted(path, a, (2, 3, 1, 0))


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
    out = {}
    for k, p in params.items():
        a = np.array(to_torch_layout(k, np.asarray(flat[k])), np.float32)
        if a.shape != tuple(p.shape):
            raise ValueError(f"{k}: flax shape {np.shape(flat[k])} does not fit {tuple(p.shape)}")
        out[k] = torch.from_numpy(a).to(p.device)
    return out


def leaves_to_flax(leaves: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`flax_to_leaves`: a nested dict of numpy arrays."""
    out: Dict = {}
    for path, t in leaves.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = to_flax_layout(path, t.detach().float().cpu().numpy())
    return out


def load_flax_params(model: nn.Module, params: Mapping, batch_stats: Mapping) -> None:
    """Copy flax ``params`` and ``batch_stats`` (nested dicts of numpy arrays)
    into the module: kernels by :func:`to_torch_layout`, BatchNorm
    scale/bias/mean/var as they are."""
    leaves = flax_to_leaves(model, params)
    with torch.no_grad():
        for k, p in param_leaves(model).items():
            p.copy_(leaves[k])
        buffers = dict(model.named_buffers())
        flat = dict(_walk(batch_stats))
        names = {path.replace("/", ".") for path in flat}
        if names != set(buffers):
            raise ValueError(f"batch_stats keys differ from the model's buffers: "
                             f"{sorted(names ^ set(buffers))}")
        for path, v in flat.items():
            buffers[path.replace("/", ".")].copy_(torch.from_numpy(np.array(v)))
