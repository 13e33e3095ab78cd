"""Graph-spec networks: a nested-dict DAG compiled to one ``nn.Module``.

PyTorch counterpart of :mod:`tpu_compressed_dp.models.graph`.  A spec is a
nested dict: ``path_iter`` flattens it to '/'-joined paths, ``build_graph``
wires each node to the previous one unless explicit inputs are given (with
``./`` and ``../`` resolved against the node's own directory), and
``GraphNet`` registers every module node under its path with '/' replaced
by '_' (the flax names, so :func:`~tpu_compressed_dp_torch.models.common.param_leaves`
sorts them as ``jax.tree.flatten`` does) and runs the nodes in order,
caching each output.

Node values: an ``nn.Module`` whose ``forward`` takes ``(x, train)`` or
``(x)``; any other callable on tensors; a tuple ``(node, [input paths])``
for explicit edges; or a nested dict.  Unlike flax modules, a PyTorch layer
knows its input width when it is built, so the spec functions here take
the generator and the device that draw the weights.

Activations are NCHW between nodes (the graph input is NHWC, as in the JAX
package, and ``GraphNet`` permutes it on entry); :class:`Flatten` flattens
in NHWC order and :class:`Concat` joins channels, so both agree with the
JAX nodes.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_compressed_dp_torch.models.common import flatten_nhwc
from tpu_compressed_dp_torch.models.resnet9 import (CLASSIFIER_WEIGHT, NUM_CLASSES, ConvBN,
                                                    alexnet_channels, classifier,
                                                    scaled_channels)

__all__ = ["GraphNet", "build_graph", "path_iter", "Identity", "Mul", "Flatten", "Add",
           "Concat", "MaxPool", "Cast", "resnet9_spec", "alexnet_spec"]


# ---------------------------------------------------------------------------
# node vocabulary
# ---------------------------------------------------------------------------


class Identity:
    def __call__(self, x):
        return x


@dataclasses.dataclass
class Mul:
    weight: float

    def __call__(self, x):
        return x * self.weight


class Flatten:
    """Flatten to ``[N, H * W * C]`` in NHWC order (the JAX node's)."""

    def __call__(self, x):
        return flatten_nhwc(x) if x.ndim == 4 else x.reshape(x.shape[0], -1)


class Add:
    def __call__(self, x, y):
        return x + y


class Concat:
    """Join along the channels (the JAX node's last axis)."""

    def __call__(self, *xs):
        return torch.cat(xs, dim=1 if xs[0].ndim == 4 else -1)


@dataclasses.dataclass
class Cast:
    """Dtype boundary node: the spec functions enter bf16 compute at the
    input and leave it for fp32 logits."""

    dtype: torch.dtype

    def __call__(self, x):
        return x.to(self.dtype)


@dataclasses.dataclass
class MaxPool:
    window: int

    def __call__(self, x):
        return F.max_pool2d(x, self.window)


# ---------------------------------------------------------------------------
# spec flattening and wiring
# ---------------------------------------------------------------------------


def path_iter(nested, pfx: Tuple[str, ...] = ()):
    """Yield ``(path_tuple, value)`` leaves of a nested mapping."""
    from collections.abc import Mapping

    for name, val in nested.items():
        if isinstance(val, Mapping):
            yield from path_iter(val, pfx + (str(name),))
        else:
            yield pfx + (str(name),), val


def _resolve(path: str, at: Tuple[str, ...]) -> str:
    """Resolve relative input paths against the node's directory: ``./x`` is
    a sibling, each ``../`` climbs one level; anything else is absolute."""
    if not (path.startswith("./") or path.startswith("../")):
        return path
    parts = list(at[:-1])
    while True:
        if path.startswith("./"):
            path = path[2:]
        elif path.startswith("../"):
            parts = parts[:-1]
            path = path[3:]
        else:
            break
    return "/".join(parts + ([path] if path else []))


def build_graph(spec: Dict) -> Dict[str, Tuple[Any, Tuple[str, ...]]]:
    """Flatten a nested spec to ``{path: (node, input_paths)}`` in insertion
    order, wiring each node to its predecessor unless explicit inputs are
    given.  The first node's input is the graph input (the empty tuple)."""
    graph: Dict[str, Tuple[Any, Tuple[str, ...]]] = {}
    prev: Optional[str] = None
    for path_t, val in path_iter(spec):
        path = "/".join(path_t)
        if isinstance(val, tuple):
            node, inputs = val
            inputs = tuple(_resolve(p, path_t) for p in inputs)
            for p in inputs:
                if p not in graph:
                    raise ValueError(f"node {path!r}: unknown input {p!r} "
                                     f"(known: {list(graph)})")
        else:
            node = val
            inputs = (prev,) if prev is not None else ()
        graph[path] = (node, inputs)
        prev = path
    if not graph:
        raise ValueError("empty graph spec")
    return graph


class GraphNet(nn.Module):
    """An executable DAG.  ``outputs=None`` returns the last node's value; a
    tuple of paths returns ``{path: value}``.  Input is NHWC."""

    def __init__(self, spec: Dict, outputs: Optional[Tuple[str, ...]] = None):
        super().__init__()
        self.graph = build_graph(spec)
        self.outputs = outputs
        self._takes_train = {}
        for path, (node, _) in self.graph.items():
            if isinstance(node, nn.Module):
                self.add_module(path.replace("/", "_"), node)
                self._takes_train[path] = "train" in inspect.signature(node.forward).parameters

    def forward(self, x: torch.Tensor, train: bool = False):
        x = x.permute(0, 3, 1, 2)
        cache: Dict[str, Any] = {}
        for path, (node, inputs) in self.graph.items():
            args = [x] if not inputs else [cache[p] for p in inputs]
            if self._takes_train.get(path):
                out = node(*args, train=train)
            else:
                out = node(*args)
            cache[path] = out
        if self.outputs is None:
            return cache[path]
        return {p: cache[p] for p in self.outputs}


# ---------------------------------------------------------------------------
# the reference's spec-built nets
# ---------------------------------------------------------------------------


def resnet9_spec(num_classes: int = NUM_CLASSES, channels: Optional[Dict[str, int]] = None,
                 classifier_weight: float = CLASSIFIER_WEIGHT,
                 dtype: torch.dtype = torch.float32, *, seed: int = 0, device="cpu") -> Dict:
    """ResNet-9 as a spec: residuals are explicit Add edges; ``dtype``
    wraps the graph in Cast nodes (bf16 compute, fp32 parameters and
    logits).  Weights come from ``seed`` in the order :class:`ResNet9`
    draws them."""
    ch = channels or scaled_channels()
    g = torch.Generator(device=torch.device(device)).manual_seed(seed)
    kw = dict(generator=g, dtype=dtype, device=device)

    def res_block(c):
        return {"in": Identity(), "res1": ConvBN(c, c, **kw), "res2": ConvBN(c, c, **kw),
                "add": (Add(), ["./in", "./res2"])}

    return {
        "cast_in": Cast(dtype),
        "prep": ConvBN(3, ch["prep"], **kw),
        "layer1": {"conv": ConvBN(ch["prep"], ch["layer1"], **kw), "pool": MaxPool(2),
                   "residual": res_block(ch["layer1"])},
        "layer2": {"conv": ConvBN(ch["layer1"], ch["layer2"], **kw), "pool": MaxPool(2)},
        "layer3": {"conv": ConvBN(ch["layer2"], ch["layer3"], **kw), "pool": MaxPool(2),
                   "residual": res_block(ch["layer3"])},
        "pool": MaxPool(4),
        "flatten": Flatten(),
        "linear": classifier(ch["layer3"], num_classes, **kw),
        "logits": Mul(classifier_weight),
        "cast_out": Cast(torch.float32),
    }


def alexnet_spec(num_classes: int = NUM_CLASSES, channels: Optional[Dict[str, int]] = None,
                 classifier_weight: float = CLASSIFIER_WEIGHT,
                 dtype: torch.dtype = torch.float32, *, seed: int = 0, device="cpu") -> Dict:
    """The graph AlexNet as a spec."""
    ch = channels or alexnet_channels()
    g = torch.Generator(device=torch.device(device)).manual_seed(seed)
    kw = dict(generator=g, dtype=dtype, device=device)
    return {
        "cast_in": Cast(dtype),
        "prep": ConvBN(3, ch["prep"], stride=2, **kw),
        "pool0": MaxPool(2),
        "layer1": ConvBN(ch["prep"], ch["layer1"], **kw),
        "pool1": MaxPool(2),
        "layer2": ConvBN(ch["layer1"], ch["layer2"], **kw),
        "layer3": ConvBN(ch["layer2"], ch["layer3"], **kw),
        "layer4": ConvBN(ch["layer3"], ch["layer4"], **kw),
        "pool4": MaxPool(2),
        "pool5": MaxPool(2),
        "flatten": Flatten(),
        "linear": classifier(ch["layer4"], num_classes, **kw),
        "logits": Mul(classifier_weight),
        "cast_out": Cast(torch.float32),
    }

