"""Rank-r PowerSGD low-rank gradient compression (Vogels et al.).

PyTorch counterpart of :mod:`tpu_compressed_dp.ops.lowrank`.  Per reduction
group the flat accumulated gradient (gradient + EF residual) is reshaped,
zero-padded, to the near-square ``[m, n2]`` matrix ``M``; one power
iteration against the persistent warm start ``Q`` gives ``P = M Q``, its
world mean, Gram-Schmidt ``P^``, then ``Q' = M^T P^`` and its world mean;
``P^ Q'^T`` is the rank-r approximation of the world-mean gradient, the
same on every rank, and ``M - P^ Q'^T`` goes back into the EF residual.
Both reductions are ``dist.all_reduce(...) / world``, so the whole sync is
linear in the ranks' inputs: it equals the same compression of the mean
gradient.  Groups whose factors would cost at least the dense vector
(``r (m + n2) >= n``) are all-reduced dense instead.

The products are plain fp32 ``torch.matmul`` calls with TF32 off (the JAX
package computes them with ``Precision.HIGHEST`` outside any Pallas
kernel).  Every rank must hold the same warm start: :func:`init_group_state`
draws it from a generator seeded identically on every rank.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["powersgd_dims", "gram_schmidt", "powersgd_approx", "init_group_state",
           "powersgd_group_sync", "powersgd_group_bits"]


def powersgd_dims(n: int, rank: int) -> Optional[Tuple[int, int, int]]:
    """``(m, n2, r_eff)`` for compressing a flat ``n``-vector, or ``None``
    when the factors would cost at least the dense vector (send dense).
    ``m = round(sqrt(n))``, ``n2 = ceil(n / m)``, ``r_eff = min(rank, m, n2)``."""
    if n <= 0:
        return None
    m = max(1, int(round(math.sqrt(n))))
    n2 = -(-n // m)
    r = max(1, min(rank, m, n2))
    if r * (m + n2) >= n:
        return None
    return m, n2, r


def powersgd_group_bits(n: int, rank: int) -> float:
    """Wire bits of one ``n``-element group: both fp32 factors, or 32 a
    element for a dense-fallback group."""
    dims = powersgd_dims(n, rank)
    if dims is None:
        return 32.0 * n
    m, n2, r = dims
    return 32.0 * r * (m + n2)


def gram_schmidt(p: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Orthonormalise the columns of ``p`` ([..., m, r]) by modified
    Gram-Schmidt; a near-zero column normalises against ``eps`` and comes
    back ~0 instead of NaN."""
    cols = []
    for i in range(p.shape[-1]):
        v = p[..., i]
        for u in cols:
            v = v - torch.sum(u * v, dim=-1, keepdim=True) * u
        norm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        cols.append(v / torch.clamp(norm, min=eps))
    return torch.stack(cols, dim=-1)


@contextlib.contextmanager
def _fp32_matmul():
    """TF32 off for the factor products (they are the payload)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _as_matrix(flat: torch.Tensor, m: int, n2: int) -> torch.Tensor:
    flat = flat.to(torch.float32)
    pad = m * n2 - flat.shape[0]
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(m, n2)


def _normal(shape, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32)


def powersgd_approx(flat: torch.Tensor, seed: int, *, rank: int) -> torch.Tensor:
    """Stateless single-shot rank-``r`` approximation of a flat vector: one
    power iteration from ``Q0 ~ N(0, 1)`` drawn from ``seed`` (the
    registry's form; training syncs go through :func:`powersgd_group_sync`)."""
    n = flat.shape[0]
    dims = powersgd_dims(n, rank)
    if dims is None:
        return flat
    m, n2, r = dims
    mat = _as_matrix(flat, m, n2)
    q0 = _normal((n2, r), seed, flat.device)
    with _fp32_matmul():
        p_hat = gram_schmidt(mat @ q0)
        q = mat.T @ p_hat
        return (p_hat @ q.T).reshape(-1)[:n].to(flat.dtype)


def init_group_state(n: int, rank: int, seed: int, device) -> Optional[torch.Tensor]:
    """Warm start ``Q0 ~ N(0, 1)`` ([n2, r] fp32) of an ``n``-element group,
    drawn from ``seed`` (the same on every rank), or ``None`` for a
    dense-fallback group.  ``powersgd_approx(flat, seed)`` starts from the
    same ``Q0``."""
    dims = powersgd_dims(n, rank)
    if dims is None:
        return None
    _, n2, r = dims
    return _normal((n2, r), seed, device)


def _world_mean(t: torch.Tensor, world: int, group=None) -> torch.Tensor:
    if world > 1:
        dist.all_reduce(t, group=group)
    return t / world


def powersgd_group_sync(acc: torch.Tensor, q: torch.Tensor, rank: int, world: int,
                        group=None) -> Tuple[torch.Tensor, torch.Tensor, float, float]:
    """One warm-started PowerSGD sync of a group's accumulated gradient over
    the ``world`` workers of ``group`` (``None``: the default process
    group).  Returns ``(recon, q_new, sent_elems,
    sent_bits)``: ``recon`` approximates the world-mean gradient, and the
    caller folds ``acc - recon`` into the EF residual."""
    n = acc.shape[0]
    dims = powersgd_dims(n, rank)
    if dims is None:
        raise ValueError(f"a {n}-element group at rank {rank} is sent dense, not compressed")
    m, n2, r = dims
    if tuple(q.shape) != (n2, r):
        raise ValueError(f"warm-start Q shape {tuple(q.shape)} does not match the group's "
                         f"({n2}, {r}); build the state with init_comp_state for this config "
                         "and gradient tree")
    mat = _as_matrix(acc, m, n2)
    with _fp32_matmul():
        p_hat = gram_schmidt(_world_mean(mat @ q, world, group))
        q_new = _world_mean(mat.T @ p_hat, world, group)
        recon = (p_hat @ q_new.T).reshape(-1)[:n]
    sent = float(r * (m + n2))
    return recon, q_new, sent, 32.0 * sent
