"""Delta codec: Top-K of parameter drift on the wire select+pack, with
set-semantics payloads so reconstruction is *bitwise*.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.stream.delta`.  Deltas
select coordinates by drift magnitude ``|params - last_streamed|`` through
:func:`tpu_compressed_dp_torch.ops.wire.select_pack_topk` (on a CUDA tensor
the threshold search's count kernels and the fused select+pack of
``csrc/count_ge_edges.cu`` and ``csrc/select_pack.cu``), but transmit the
CURRENT VALUES at those coordinates and apply by assignment, never
addition.  Setting a float is exact, so ``last_streamed[idx] = params[idx]``
holds bitwise, the residual ``params - last_streamed`` is exactly zero at
every transmitted coordinate, and a window-closing flush (every coordinate
whose BITS differ) makes ``keyframe + sum(deltas) == params`` exact in fp32.

The flat vector is the JAX package's, element for element: the leaves in
``jax.tree.flatten`` order (``models/common.param_leaves``, or
``models/transformer.param_leaves`` for the LM), each in flax layout
(``models/common.to_flax_layout``: HWIO convolution kernels, ``(in, out)``
dense kernels), and each spec entry's ``path`` is the string
``jax.tree_util.keystr`` writes for the flax leaf (``['layer1']['conv']
['kernel']``, ``['layers'][0]['wq']``), so either package's
:func:`unflatten_like` accepts the other's stream.  ``params`` is a model
(an ``nn.Module``) or a nested dict / list of arrays or tensors, taken as
it is.

The vector, ``last_streamed`` and the drift stay on the parameters' device;
:func:`topk_delta` and :func:`flush_delta` return ``(idx, vals)`` there and
the writer copies only those to the host.  Pure functions: no I/O, no
clocks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from tpu_compressed_dp_torch.models import common, transformer
from tpu_compressed_dp_torch.models.common import to_flax_layout, to_torch_layout
from tpu_compressed_dp_torch.ops import wire

__all__ = [
    "flatten_params", "unflatten_like", "unflatten_dict", "keep_for_ratio",
    "topk_delta", "flush_delta", "apply_delta", "residual_of",
]

_INT32_MAX = int(np.iinfo(np.int32).max)
#: elements a ``nonzero`` pass covers at once (bounds its int64 output)
_CHUNK = 1 << 28


def _keystr(parts) -> str:
    """``jax.tree_util.keystr`` of a dict / sequence key path."""
    return "".join(f"[{p!r}]" for p in parts)


def _lm_parts(key: str) -> Tuple:
    """``layers.3.wq`` -> ``('layers', 3, 'wq')``: the JAX LM tree holds
    its layers in a list."""
    return tuple(int(p) if p.isdigit() else p for p in key.split("."))


def _module_leaves(model) -> List[Tuple[Tuple, str, torch.Tensor]]:
    """``(flax key path, the port's key, parameter)`` in JAX order."""
    if isinstance(model, transformer.Llama):
        return [(_lm_parts(k), k, p) for k, p in transformer.param_leaves(model).items()]
    return [(tuple(k.split("/")), k, p) for k, p in common.param_leaves(model).items()]


def param_dict(model) -> Dict[str, torch.Tensor]:
    """``{the port's key: parameter}`` of a model, in the stream's order
    (what :func:`unflatten_like` returns for a model template)."""
    return {k: p for _, k, p in _module_leaves(model)}


def _tree_leaves(tree, prefix=()) -> List[Tuple[Tuple, Any]]:
    """A nested dict / list's leaves in ``jax.tree.flatten`` order (dict
    keys sorted), each with its key path."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _tree_leaves(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _tree_leaves(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def _dtype_name(a) -> str:
    return str(a.dtype).replace("torch.", "")


def _flax_leaves(params) -> List[Tuple[str, Any]]:
    """``(keystr path, leaf in flax layout)`` of a model or a tree."""
    if isinstance(params, torch.nn.Module):
        return [(_keystr(parts), to_flax_layout(k, p.detach()))
                for parts, k, p in _module_leaves(params)]
    return [(_keystr(parts), leaf) for parts, leaf in _tree_leaves(params)]


def flatten_params(params) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """One fp32 vector (a fresh tensor on the parameters' device) plus its
    spec (per-leaf path / shape / dtype, in traversal order).  fp32 and
    narrower float leaves round-trip bitwise through the fp32 cast."""
    spec, chunks = [], []
    for path, leaf in _flax_leaves(params):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.asarray(leaf))
        spec.append({"path": path, "shape": list(t.shape), "dtype": _dtype_name(t)})
        chunks.append(t.to(torch.float32).reshape(-1))
    if not chunks:
        return torch.zeros((0,), dtype=torch.float32), spec
    return torch.cat(chunks), spec


def _np_dtype(name: str):
    try:
        return np.dtype(name)
    except TypeError:
        return np.dtype(np.float32)  # bfloat16: numpy has no such type


def _check_spec(path: str, shape, ent: Dict[str, Any]) -> None:
    if path != ent["path"] or list(shape) != list(ent["shape"]):
        raise ValueError(f"stream spec mismatch at {path}: stream has {ent['path']} "
                         f"{ent['shape']}, template {list(shape)}")


def unflatten_like(template, vec, spec: List[Dict[str, Any]]):
    """The TEMPLATE's leaves from a flat vector, checking the stream's spec
    against the template leaf for leaf (path and shape): a stream from a
    different model fails loudly rather than scatter into the wrong
    coordinates.  A model template gives ``{param_leaves key: CPU tensor}``
    in the port's layout (``to_torch_layout``) and the parameter's dtype;
    a tree template gives the same tree of numpy arrays."""
    vec = vec.cpu().numpy() if isinstance(vec, torch.Tensor) else np.asarray(vec)
    module = isinstance(template, torch.nn.Module)
    leaves = _module_leaves(template) if module else _tree_leaves(template)
    if len(leaves) != len(spec):
        raise ValueError(f"stream spec has {len(spec)} leaves, template has {len(leaves)}")
    out: Dict = {}
    off = 0
    for leaf, ent in zip(leaves, spec):
        if module:
            parts, key, p = leaf
            shape = tuple(to_flax_layout(key, p.detach()).shape)
        else:
            parts, a = leaf
            shape = tuple(a.shape) if hasattr(a, "shape") else ()
        _check_spec(_keystr(parts), shape, ent)
        n = int(np.prod(shape)) if shape else 1
        arr = vec[off:off + n].reshape(shape)
        off += n
        if module:
            out[key] = torch.from_numpy(np.ascontiguousarray(
                to_torch_layout(key, arr))).to(p.dtype)
        else:
            out[parts] = arr.astype(_np_dtype(_dtype_name(a)) if isinstance(a, torch.Tensor)
                                    else np.asarray(a).dtype)
    if off != vec.shape[0]:
        raise ValueError(f"flat vector has {vec.shape[0]} elements, template consumes {off}")
    return out if module else _rebuild(template, out)


def _rebuild(tree, leaves: Dict[Tuple, np.ndarray], prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves, prefix + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, prefix + (i,)) for i, v in enumerate(tree))
    return leaves[prefix]


def unflatten_dict(vec: np.ndarray, spec: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Template-free view for serving consumers: ``{leaf path: array}`` in
    the stream's own dtypes (``harness/stream_serve.py`` snapshots)."""
    out, off = {}, 0
    for ent in spec:
        n = int(np.prod(ent["shape"])) if ent["shape"] else 1
        out[ent["path"]] = (vec[off:off + n].astype(_np_dtype(ent["dtype"]))
                            .reshape(ent["shape"]))
        off += n
    return out


def keep_for_ratio(n: int, ratio: float) -> int:
    """Coordinates per Top-K delta for an ``n``-element model."""
    return max(1, min(int(n), int(round(float(ratio) * int(n)))))


def _idx_dtype(n: int) -> torch.dtype:
    """int32 indices halve a delta's payload (8 B a coordinate with fp32
    values instead of 12); int64 only past 2**31 coordinates."""
    return torch.int32 if n <= _INT32_MAX else torch.int64


def _changed_mask(vec: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Where the BITS differ: value equality would miss -0.0 vs 0.0 and
    treat NaN as always changed; the lossless invariant is bitwise."""
    return vec.view(torch.int32) != last.view(torch.int32)


def _changed(vec: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """The ascending indices whose bits differ, in ``_idx_dtype``, by
    ``nonzero`` over bounded chunks (its int64 output never spans the
    whole vector)."""
    n = vec.shape[0]
    dt = _idx_dtype(n)
    parts = [(torch.nonzero(_changed_mask(vec[lo:lo + _CHUNK], last[lo:lo + _CHUNK]))
              .flatten() + lo).to(dt) for lo in range(0, n, _CHUNK)]
    if not parts:
        return torch.zeros((0,), dtype=dt, device=vec.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def topk_delta(vec: torch.Tensor, last: torch.Tensor, keep: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``keep``-drift coordinates of ``vec`` vs ``last`` as an ``(idx
    ascending, current vals fp32)`` set-semantics pair on ``vec``'s device,
    idx in the narrowest dtype that addresses the vector.

    Selection runs on the wire compress chain (threshold + select+pack);
    when the bitwise-changed set already fits in ``keep`` the delta is exact
    and the window converges early."""
    if int(_changed_mask(vec, last).sum()) <= keep:
        idx = _changed(vec, last)
        return idx, vec.index_select(0, idx)
    _, idx, count = wire.select_pack_topk(vec - last, keep)
    k = min(int(count), keep)
    idx = idx[:k].to(_idx_dtype(vec.shape[0]))
    return idx, vec.index_select(0, idx)


def flush_delta(vec: torch.Tensor, last: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The window-closing delta: EVERY bitwise-changed coordinate, so
    applying it drives the consumer's reconstruction (and the writer's
    ``last_streamed``) to ``vec`` exactly."""
    idx = _changed(vec, last)
    return idx, vec.index_select(0, idx)


def apply_delta(recon, idx, vals):
    """In-place set-semantics apply (numpy arrays or tensors); returns
    ``recon``."""
    recon[idx] = vals
    return recon


def residual_of(vec, last):
    """The EF-style residual: drift not yet transmitted.  Exactly zero at
    every transmitted coordinate (set semantics), and bitwise equal to the
    cumulative drift at untransmitted ones."""
    return vec - last
