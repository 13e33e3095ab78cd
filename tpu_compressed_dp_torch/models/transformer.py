"""Llama-family decoder-only transformer as an ``nn.Module``.

PyTorch counterpart of :mod:`tpu_compressed_dp.models.transformer` at tensor
and sequence axes of size 1: RMSNorm pre-norm, rotary position embeddings
(interleaved pairs), grouped-query attention, SwiGLU MLP, untied LM head.

Parameters keep the JAX layout so that entire-model flattening lays every
leaf out as the JAX run does (the Top-K sampled first round and the wire
packers read that layout): projection weights are ``[in, out]`` and are used
as ``x @ w.to(dtype)``; parameters are float32 masters cast to ``cfg.dtype``
at use.  :func:`param_leaves` yields them in ``jax.tree.leaves`` order
(``embed, final_norm, layers[i]{attn_norm, mlp_norm, w_down, w_gate, w_up,
wk, wo, wq, wv}, lm_head``) and :func:`load_jax_params` carries a JAX
parameter tree across.

The LM loss is :func:`vocab_parallel_xent` of the logits, or
:func:`fused_head_xent` straight from the final hidden states (the head
matmul and the softmax cross-entropy fused through a running logsumexp over
vocab chunks, so the ``[N, V]`` logits never materialise); the train step
takes the fused form where the logits would exceed 1 GiB
(:func:`use_fused_head_xent`).  Both are plain ``torch`` matrix work, as the
JAX package leaves them to XLA.

Not ported yet (ROADMAP.md queue 1, item 11): mixture-of-experts layers,
rematerialisation, and the tensor and sequence axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_compressed_dp_torch.ops.ring_attention import ring_attention

__all__ = ["LlamaConfig", "llama3_8b", "tiny_llama", "Llama", "param_leaves", "is_sharded",
           "load_jax_params", "vocab_parallel_xent", "fused_head_xent",
           "use_fused_head_xent"]

_ITEM = "ROADMAP.md queue 1, item 11"
_LAYER_KEYS = ("attn_norm", "mlp_norm", "w_down", "w_gate", "w_up", "wk", "wo", "wq", "wv")
_NORMS = ("attn_norm", "mlp_norm")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The JAX ``LlamaConfig`` fields and defaults; ``dtype`` is a torch
    dtype."""

    vocab_size: int = 32000
    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    ffn_hidden: Optional[int] = None  # default: SwiGLU 8/3 * dim rounded to 256
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    n_experts: int = 0
    moe_every: int = 2
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def ffn(self) -> int:
        if self.ffn_hidden is not None:
            return self.ffn_hidden
        h = int(8 * self.dim / 3)
        return ((h + 255) // 256) * 256


def llama3_8b() -> LlamaConfig:
    """Llama-3-8B's widths: dim 4096, 32 heads, 8 KV heads, ffn 14336, vocab
    128256."""
    return LlamaConfig(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                       n_kv_heads=8, ffn_hidden=14336, rope_theta=500000.0)


def tiny_llama(vocab: int = 256, dim: int = 64, layers: int = 2) -> LlamaConfig:
    """Smoke/test scale."""
    return LlamaConfig(vocab_size=vocab, dim=dim, n_layers=layers, n_heads=4,
                       n_kv_heads=2, ffn_hidden=128)


def _check_ported(cfg: LlamaConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError(f"mixture-of-experts layers are not ported yet: {_ITEM}")
    if cfg.remat:
        raise NotImplementedError(f"rematerialisation (remat) is not ported yet: {_ITEM}")


def _dense(gen: torch.Generator, fan_in: int, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)


class LlamaLayer(nn.Module):
    """One decoder layer's parameters (the JAX layer dict)."""

    def __init__(self, cfg: LlamaConfig, gen: torch.Generator, device=None):
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        self.attn_norm = nn.Parameter(torch.ones(d, device=device))
        self.wq = nn.Parameter(_dense(gen, d, (d, cfg.n_heads * hd), device))
        self.wk = nn.Parameter(_dense(gen, d, (d, cfg.n_kv_heads * hd), device))
        self.wv = nn.Parameter(_dense(gen, d, (d, cfg.n_kv_heads * hd), device))
        self.wo = nn.Parameter(_dense(gen, cfg.n_heads * hd, (cfg.n_heads * hd, d), device))
        self.mlp_norm = nn.Parameter(torch.ones(d, device=device))
        self.w_gate = nn.Parameter(_dense(gen, d, (d, cfg.ffn), device))
        self.w_up = nn.Parameter(_dense(gen, d, (d, cfg.ffn), device))
        self.w_down = nn.Parameter(_dense(gen, cfg.ffn, (cfg.ffn, d), device))


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale * w).to(x.dtype)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` ``[B, H, T, D]`` at positions ``pos``
    ``[T]``: the pairs ``(x[0::2], x[1::2])`` rotated, stacked and reshaped
    back to interleaved order."""
    d = x.shape[-1]
    freqs = torch.tensor(theta, dtype=torch.float32) ** (
        -torch.arange(0, d, 2, dtype=torch.float32) / d)
    ang = pos[:, None].to(torch.float32) * freqs.to(x.device)[None, :]  # [T, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2].to(torch.float32), x[..., 1::2].to(torch.float32)
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class Llama(nn.Module):
    """The decoder; ``forward(tokens)`` gives logits ``[B, T, V]`` in
    ``cfg.dtype``, ``forward(tokens, return_hidden=True)`` the final-normed
    hidden states (the input of :func:`fused_head_xent`)."""

    def __init__(self, cfg: LlamaConfig, *, seed: int = 0, device=None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        gen = torch.Generator(device=device if device is not None else "cpu").manual_seed(seed)
        self.layers = nn.ModuleList(LlamaLayer(cfg, gen, device) for _ in range(cfg.n_layers))
        self.embed = nn.Parameter(
            torch.randn((cfg.vocab_size, cfg.dim), generator=gen, device=device) * 0.02)
        self.final_norm = nn.Parameter(torch.ones(cfg.dim, device=device))
        self.lm_head = nn.Parameter(_dense(gen, cfg.dim, (cfg.dim, cfg.vocab_size), device))

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False) -> torch.Tensor:
        cfg = self.cfg
        dt, hd = cfg.dtype, cfg.head_dim
        b, t = tokens.shape
        pos = torch.arange(t, device=tokens.device)
        # gather, then cast: the same values as the JAX embed.astype(dt)[tokens]
        # without a cast copy of the whole table
        h = F.embedding(tokens.long(), self.embed).to(dt)
        for lp in self.layers:
            x = _rms_norm(h, lp.attn_norm, cfg.norm_eps)
            q = (x @ lp.wq.to(dt)).reshape(b, t, -1, hd).transpose(1, 2)
            k = (x @ lp.wk.to(dt)).reshape(b, t, -1, hd).transpose(1, 2)
            v = (x @ lp.wv.to(dt)).reshape(b, t, -1, hd).transpose(1, 2)
            q = _rope(q, pos, cfg.rope_theta)
            k = _rope(k, pos, cfg.rope_theta)
            o = ring_attention(q, k, v)
            o = o.transpose(1, 2).reshape(b, t, -1)
            h = h + o @ lp.wo.to(dt)
            x = _rms_norm(h, lp.mlp_norm, cfg.norm_eps)
            gate = F.silu(x @ lp.w_gate.to(dt))
            h = h + (gate * (x @ lp.w_up.to(dt))) @ lp.w_down.to(dt)
        h = _rms_norm(h, self.final_norm, cfg.norm_eps)
        return h if return_hidden else h @ self.lm_head.to(dt)


def param_leaves(model: Llama) -> Dict[str, nn.Parameter]:
    """The parameters in ``jax.tree.leaves`` order of the JAX tree (dict keys
    sorted): ``embed``, ``final_norm``, ``layers.<i>.<key>``, ``lm_head``."""
    out = {"embed": model.embed, "final_norm": model.final_norm}
    for i, lp in enumerate(model.layers):
        for key in _LAYER_KEYS:
            out[f"layers.{i}.{key}"] = getattr(lp, key)
    out["lm_head"] = model.lm_head
    return out


def is_sharded(cfg: LlamaConfig):
    """Per leaf of :func:`param_leaves`, whether the JAX ``param_specs``
    shard it over the tensor axis (``lm_step._lm_is_sharded``): the
    projections and the LM head; the embedding and the norms are
    replicated."""
    _check_ported(cfg)
    per_layer = [key not in _NORMS for key in _LAYER_KEYS]
    return [False, False] + per_layer * cfg.n_layers + [True]


def load_jax_params(cfg: LlamaConfig, tree: Mapping, device="cpu") -> Llama:
    """A :class:`Llama` holding the JAX parameter tree ``tree`` (``init_llama``'s
    nested dict, leaves as numpy arrays), in the same layout."""
    model = Llama(cfg, device=device)
    leaves = param_leaves(model)
    want = {"embed": tree["embed"], "final_norm": tree["final_norm"], "lm_head": tree["lm_head"]}
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, cfg {cfg.n_layers}")
    for i, layer in enumerate(tree["layers"]):
        if set(layer) != set(_LAYER_KEYS):
            raise ValueError(f"layer {i} keys {sorted(layer)} are not {list(_LAYER_KEYS)}")
        want.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    with torch.no_grad():
        for name, p in leaves.items():
            a = np.array(want[name], dtype=np.float32)
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape}, expected {tuple(p.shape)}")
            p.copy_(torch.from_numpy(a))
    return model


# ---------------------------------------------------------------------------
# The LM loss
# ---------------------------------------------------------------------------


def vocab_parallel_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of ``logits`` ``[B, T, V]`` against
    ``targets`` ``[B, T]`` (the JAX function at ``tensor_axis=None``); the
    stabilising max carries no gradient."""
    z = logits.to(torch.float32)
    zmax = z.detach().amax(-1)
    sumexp = torch.exp(z - zmax[..., None]).sum(-1)
    zt = torch.gather(z, -1, targets.long()[..., None])[..., 0]
    return (torch.log(sumexp) + zmax - zt).mean()


def _fhx_chunks(v: int, chunk: int):
    c = min(chunk, v)
    return c, -(-v // c)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in float32 from operands in their
    own type (``preferred_element_type=float32``)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


class _FusedHeadXent(torch.autograd.Function):
    """The JAX ``fused_head_xent`` custom VJP.  Chunks are the true vocab
    columns (the JAX scan pads the last chunk with zero columns that it
    masks to -inf, which changes no valid column's result)."""

    @staticmethod
    def forward(ctx, h, w, targets, chunk):
        d, v = h.shape[-1], w.shape[-1]
        h2, t1 = h.reshape(-1, d), targets.reshape(-1).long()
        n = h2.shape[0]
        c, nc = _fhx_chunks(v, chunk)
        m = torch.full((n,), -math.inf, dtype=torch.float32, device=h.device)
        l = torch.zeros(n, dtype=torch.float32, device=h.device)
        zt = torch.zeros(n, dtype=torch.float32, device=h.device)
        for ci in range(nc):
            z = _mm_f32(h2, w[:, ci * c:(ci + 1) * c])
            m_new = torch.maximum(m, z.amax(-1))
            l = l * torch.exp(m - m_new) + torch.exp(z - m_new[:, None]).sum(-1)
            lt = t1 - ci * c
            in_chunk = (lt >= 0) & (lt < z.shape[1]) & (t1 < v)
            zc = torch.gather(z, 1, lt.clamp(0, z.shape[1] - 1)[:, None])[:, 0]
            zt = zt + torch.where(in_chunk, zc, 0.0)
            m = m_new
        lse = m + torch.log(l)
        ctx.save_for_backward(h, w, targets, lse)
        ctx.chunk = chunk
        return (lse - zt).mean()

    @staticmethod
    def backward(ctx, g):
        h, w, targets, lse = ctx.saved_tensors
        d, v = h.shape[-1], w.shape[-1]
        h2, t1 = h.reshape(-1, d), targets.reshape(-1).long()
        n = h2.shape[0]
        c, nc = _fhx_chunks(v, ctx.chunk)
        dnll = (g / n).to(torch.float32)
        dh = torch.zeros((n, d), dtype=torch.float32, device=h.device)
        dw = torch.empty((d, v), dtype=torch.float32, device=h.device)
        for ci in range(nc):
            w_c = w[:, ci * c:(ci + 1) * c]
            p = torch.exp(_mm_f32(h2, w_c) - lse[:, None])
            lt = torch.where(t1 < v, t1 - ci * c, -1)
            onehot = torch.arange(w_c.shape[1], device=h.device)[None, :] == lt[:, None]
            dz = ((p - onehot.to(torch.float32)) * dnll).to(w.dtype)
            dh = dh + _mm_f32(dz, w_c.t())
            dw[:, ci * c:(ci + 1) * c] = _mm_f32(h2.t(), dz)
        return dh.reshape(h.shape).to(h.dtype), dw.to(w.dtype), None, None


def fused_head_xent(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                    chunk: int = 2048) -> torch.Tensor:
    """Mean next-token cross-entropy straight from hidden states ``h``
    ``[..., D]`` and head ``w`` ``[D, V]``, through a running logsumexp over
    ``chunk``-wide vocab slices; the backward recomputes each chunk's logits
    instead of saving them.  Equal to ``vocab_parallel_xent(h @ w, targets)``
    up to rounding (float32 logits inside the chunks)."""
    return _FusedHeadXent.apply(h, w, targets, chunk)


_FUSED_XENT_AUTO_BYTES = 1 << 30


def use_fused_head_xent(n_tokens: int = 0, vocab: int = 0, itemsize: int = 2) -> bool:
    """Whether the LM loss takes :func:`fused_head_xent`: where the
    per-worker logits (``n_tokens x vocab`` at ``itemsize`` bytes) would
    exceed 1 GiB, the JAX package's automatic rule."""
    return n_tokens * vocab * itemsize > _FUSED_XENT_AUTO_BYTES
