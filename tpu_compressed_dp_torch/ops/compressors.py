"""Gradient compression operators on flat tensors (the Top-K slice).

PyTorch counterpart of :mod:`tpu_compressed_dp.ops.compressors` for the
methods this slice of the port carries: ``none`` (identity) and ``topk``.
Each operator maps a flat gradient to a same-shaped dense tensor with zeros
at the dropped coordinates (the paper's "simulate" representation).  The
other methods of the JAX package raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

__all__ = [
    "identity",
    "top_k",
    "topk_keep_count",
    "get_compressor",
    "canonical_name",
    "payload_bits_per_elem",
    "REGISTRY",
]

CompressorFn = Callable[[torch.Tensor], torch.Tensor]

# the JAX package's method spellings (canonical plus the reference CLI's)
_ALIASES = {
    "topk": "topk", "blocktopk": "blocktopk", "block_topk": "blocktopk",
    "blocktop_k": "blocktopk", "randomk": "randomk", "thresholdv": "thresholdv",
    "adaptivethreshold": "adaptive_threshold",
    "adaptive_threshold": "adaptive_threshold", "terngrad": "terngrad",
    "randomdithering": "qsgd", "random_dithering": "qsgd", "qsgd": "qsgd",
    "powersgd": "powersgd", "power_sgd": "powersgd", "lowrank": "powersgd",
    "none": "none", "dense": "none",
}

REGISTRY = ("none", "topk", "blocktopk", "randomk", "thresholdv",
            "adaptive_threshold", "terngrad", "qsgd", "powersgd")

#: methods of the JAX package this port does not carry yet
LATER = "ROADMAP.md queue 1, item 6 (the other compressors)"


def _flat(g: torch.Tensor) -> torch.Tensor:
    if g.dim() != 1:
        raise ValueError(f"compressors operate on flat vectors, got shape {tuple(g.shape)}")
    return g


def topk_keep_count(n: int, ratio: float) -> int:
    """Elements Top-K keeps: ``n - ceil(n*(1-ratio)) + 1`` (the reference's
    ``kthvalue`` threshold, everything ``>=`` it kept)."""
    m = max(1, math.ceil(n * (1.0 - ratio)))
    return max(1, n - m + 1)


def identity(g: torch.Tensor) -> torch.Tensor:
    """No compression."""
    return _flat(g)


def top_k(g: torch.Tensor, *, ratio: float) -> torch.Tensor:
    """Keep the ``~ratio*n`` largest-magnitude coordinates; ties at the
    threshold are all kept."""
    from tpu_compressed_dp_torch.ops import kernels

    g = _flat(g)
    keep = topk_keep_count(g.shape[0], ratio)
    mag = g.abs().to(torch.float32)  # threshold compare in fp32 always
    thresh = kernels.topk_threshold(mag, keep)
    return torch.where(mag >= thresh, g, 0.0)


@dataclasses.dataclass(frozen=True)
class _Bound:
    """A compressor with its hyper-parameters bound, keyed by canonical name."""

    name: str
    fn: CompressorFn

    @property
    def is_sparsifier(self) -> bool:
        return self.name in ("topk", "randomk", "thresholdv",
                             "adaptive_threshold", "blocktopk")


def canonical_name(method: Optional[str]) -> str:
    """Resolve a method spelling to its canonical name (raises on unknown)."""
    if method is None:
        return "none"
    canon = _ALIASES.get(method.lower().replace("-", "_"))
    if canon is None:
        raise ValueError(f"unknown compression method {method!r}; known: {REGISTRY}")
    return canon


def payload_bits_per_elem(name: str) -> float:
    """Wire width of one transmitted element: dense fp32, or a Top-K
    (value, index) pair."""
    if name == "none":
        return 32.0
    if name == "topk":
        return 64.0
    if name in REGISTRY:
        raise NotImplementedError(f"{name!r} is not ported yet: {LATER}")
    raise ValueError(f"unknown compressor {name!r}")


def get_compressor(method: Optional[str], *, ratio: float = 0.5) -> _Bound:
    """Resolve a method name to a bound operator (``none`` or ``topk``)."""
    canon = canonical_name(method)
    if canon == "none":
        return _Bound("none", identity)
    if canon == "topk":
        return _Bound("topk", lambda g: top_k(g, ratio=ratio))
    raise NotImplementedError(f"compression method {canon!r} is not ported yet: {LATER}")
