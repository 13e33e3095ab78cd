"""Llama-family decoder-only transformer as an ``nn.Module``.

PyTorch counterpart of :mod:`tpu_compressed_dp.models.transformer`: RMSNorm
pre-norm, rotary position embeddings (interleaved pairs), grouped-query
attention, SwiGLU MLP, untied LM head.

A :class:`Llama` is one rank's shard of the model on the ``(data, seq,
tensor)`` mesh (``parallel/mesh.lm_groups``), written Megatron-style as the
JAX ``apply_llama`` is under ``shard_map``: ``Llama(cfg, tensor_rank=t,
tensor_size=tp)`` holds the JAX ``param_specs`` slices, ``wq/wk/wv``,
``w_gate/w_up`` and ``lm_head`` by columns (``H/tp`` query and ``H_kv/tp``
KV heads, ``ffn/tp`` hidden units, ``vocab/tp`` logits), ``wo`` and
``w_down`` by rows, the embedding and the norms whole.  ``forward(tokens,
tensor_group=..., seq_group=...)`` sums each row-parallel product over the
tensor group (``mesh.reduce_from_group``, the JAX ``psum``) and marks the
replicated input of each column-parallel product with
``mesh.copy_to_group``, whose backward sums the cotangent over the group
(the psum JAX's AD puts at the implicit ``pvary``), so the replicated
parameters get the same whole gradient on every tensor rank.  The tokens
are this rank's sequence block: rope positions are offset by its seq index
and attention is the ring over the seq group (``ops/ring_attention.py``).
``cfg.remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, the JAX ``jax.checkpoint``).

Parameters keep the JAX layout so that entire-model flattening lays every
leaf out as the JAX run does (the Top-K sampled first round and the wire
packers read that layout): projection weights are ``[in, out]`` and are used
as ``x @ w.to(dtype)``; parameters are float32 masters cast to ``cfg.dtype``
at use.  :func:`param_leaves` yields them in ``jax.tree.leaves`` order
(``embed, final_norm, layers[i]{attn_norm, mlp_norm, [router,] w_down,
w_gate, w_up, wk, wo, wq, wv}, lm_head``) and :func:`load_jax_params` carries
a JAX parameter tree across.

With ``n_experts > 0`` every ``moe_every``-th layer's FFN is the JAX
Switch-style top-1 mixture of experts (``_moe_ffn``): a replicated
``router`` ``[D, E]`` and expert stacks ``w_gate``/``w_up`` ``[E, D, F]``,
``w_down`` ``[E, F, D]`` split on their leading expert axis over the tensor
group.  Every tensor rank routes all tokens into fixed-capacity slots of its
local experts through one-hot products and one ``reduce_from_group``
combines; ``forward(..., with_aux=True)`` also returns the load-balance aux
loss averaged over the MoE layers.

The LM loss is :func:`vocab_parallel_xent` of the (vocab-sharded) logits,
or :func:`fused_head_xent` straight from the final hidden states (the head
matmul and the softmax cross-entropy fused through a running logsumexp over
vocab chunks, so the ``[N, V]`` logits never materialise); the train step
takes the fused form where the logits would exceed 1 GiB
(:func:`use_fused_head_xent`).  Both reduce their max, sum-exp and target
logit over the tensor group, and are plain ``torch`` matrix work, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from tpu_compressed_dp_torch.ops.ring_attention import ring_attention
from tpu_compressed_dp_torch.parallel import mesh

__all__ = ["LlamaConfig", "llama3_8b", "tiny_llama", "Llama", "param_leaves", "is_sharded",
           "load_jax_params", "vocab_parallel_xent", "fused_head_xent",
           "use_fused_head_xent", "decoder_layer", "run_layer", "layer_keys", "shard_axis"]

_LAYER_KEYS = ("attn_norm", "mlp_norm", "w_down", "w_gate", "w_up", "wk", "wo", "wq", "wv")
# an MoE layer's keys, sorted as the JAX tree sorts them
_MOE_KEYS = ("attn_norm", "mlp_norm", "router", "w_down", "w_gate", "w_up", "wk", "wo", "wq",
             "wv")
# the axis each sharded leaf splits over the tensor axis (param_specs): the
# output columns of the column-parallel products, the input rows of wo and
# w_down; an MoE layer's expert stacks split on their leading expert axis
_SHARD_AXIS = {"wq": 1, "wk": 1, "wv": 1, "w_gate": 1, "w_up": 1, "wo": 0, "w_down": 0,
               "lm_head": 1}
_EXPERTS = ("w_gate", "w_up", "w_down")


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

    def validate_mesh(self, tensor_size: int) -> None:
        """The JAX check: heads, KV heads, ffn and vocab divide by the tensor
        axis."""
        if self.n_kv_heads % tensor_size or self.n_heads % tensor_size:
            raise ValueError(f"heads ({self.n_heads}/{self.n_kv_heads}) must divide by "
                             f"tensor axis size {tensor_size}")
        if self.ffn % tensor_size or self.vocab_size % tensor_size:
            raise ValueError(f"ffn ({self.ffn}) and vocab ({self.vocab_size}) must divide "
                             f"by tensor axis size {tensor_size}")
        if self.n_experts and self.n_experts % tensor_size:
            raise ValueError(f"n_experts ({self.n_experts}) must divide by tensor axis "
                             f"size {tensor_size}")

    def is_moe_layer(self, i: int) -> bool:
        """Whether layer ``i``'s FFN is the mixture of experts: every
        ``moe_every``-th layer, the last of each run."""
        every = max(self.moe_every, 1)
        return bool(self.n_experts) and i % every == every - 1


def llama3_8b() -> LlamaConfig:
    """Llama-3-8B's widths: dim 4096, 32 heads, 8 KV heads, ffn 14336, vocab
    128256."""
    return LlamaConfig(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                       n_kv_heads=8, ffn_hidden=14336, rope_theta=500000.0)


def tiny_llama(vocab: int = 256, dim: int = 64, layers: int = 2) -> LlamaConfig:
    """Smoke/test scale."""
    return LlamaConfig(vocab_size=vocab, dim=dim, n_layers=layers, n_heads=4,
                       n_kv_heads=2, ffn_hidden=128)


def _dense(gen: torch.Generator, fan_in: int, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)


def shard_axis(key: str, moe: bool = False) -> Optional[int]:
    """The axis along which ``param_specs`` splits the leaf ``key`` (a layer
    key or a :func:`param_leaves` name) over the tensor axis, ``None`` where
    it is replicated; ``moe`` for a leaf of an MoE layer, whose expert stacks
    split on the expert axis."""
    key = key.rsplit(".", 1)[-1]
    if moe and key in _EXPERTS:
        return 0
    return _SHARD_AXIS.get(key)


def _shard(a, key: str, tensor_rank: int, tensor_size: int, moe: bool = False):
    """Tensor rank ``tensor_rank``'s slice of the whole leaf ``a`` (a tensor
    or a numpy array) named ``key``, as ``param_specs`` shards it; the leaf
    itself where it is replicated or the axis has size 1."""
    axis = shard_axis(key, moe)
    if axis is None or tensor_size == 1:
        return a
    n = a.shape[axis] // tensor_size
    index = [slice(None)] * a.ndim
    index[axis] = slice(tensor_rank * n, (tensor_rank + 1) * n)
    part = a[tuple(index)]
    return part.clone() if isinstance(part, torch.Tensor) else part


class LlamaLayer(nn.Module):
    """One decoder layer's parameters (the JAX layer dict), tensor rank
    ``tensor_rank``'s shard: every leaf is drawn whole, in the order of the
    unsharded model, and sliced, so the shards of one seed make up the
    unsharded model of that seed.  ``moe``: the FFN is the mixture of
    experts (``router`` and the expert stacks)."""

    def __init__(self, cfg: LlamaConfig, gen: torch.Generator, device=None,
                 tensor_rank: int = 0, tensor_size: int = 1, moe: bool = False):
        super().__init__()
        d, hd, f = cfg.dim, cfg.head_dim, cfg.ffn
        self.moe = moe

        def leaf(key, fan_in, shape):
            return nn.Parameter(_shard(_dense(gen, fan_in, shape, device), key, tensor_rank,
                                       tensor_size, moe))

        self.attn_norm = nn.Parameter(torch.ones(d, device=device))
        self.wq = leaf("wq", d, (d, cfg.n_heads * hd))
        self.wk = leaf("wk", d, (d, cfg.n_kv_heads * hd))
        self.wv = leaf("wv", d, (d, cfg.n_kv_heads * hd))
        self.wo = leaf("wo", cfg.n_heads * hd, (cfg.n_heads * hd, d))
        self.mlp_norm = nn.Parameter(torch.ones(d, device=device))
        e = (cfg.n_experts,) if moe else ()
        self.w_gate = leaf("w_gate", d, e + (d, f))
        self.w_up = leaf("w_up", d, e + (d, f))
        self.w_down = leaf("w_down", f, e + (f, d))
        if moe:
            self.router = leaf("router", d, (d, cfg.n_experts))

    def leaves(self) -> Dict[str, nn.Parameter]:
        """The layer's leaves in the JAX tree's (sorted) key order."""
        return {k: getattr(self, k) for k in (_MOE_KEYS if self.moe else _LAYER_KEYS)}


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


def _moe_ffn(cfg: LlamaConfig, lp: Mapping[str, torch.Tensor], x: torch.Tensor,
             tensor_group=None):
    """The JAX Switch-style top-1 MoE FFN of the normed input ``x`` ``[B, T,
    D]``, experts split over ``tensor_group``: ``(out, aux)``.

    Every tensor rank routes all its tokens with the replicated router (a
    float32 softmax; the first maximum wins, as ``jnp.argmax``), fills the
    ``cap = max(ceil(n / E * cf), 1)`` slots of each expert in token order
    (the 1-based queue rank by a cumulative sum; tokens past capacity fall
    through to the residual), dispatches into and combines out of its local
    experts with one-hot products, runs SwiGLU per expert and sums over the
    group.  ``aux`` is the Switch load-balance loss ``E * sum_e f_e P_e``.
    The cotangents of the tokens and their gate that enter the local experts
    are summed over the group (Megatron's *f*, the psum JAX's AD puts at the
    implicit ``pvary`` of the local slices); the router's aux path is not, as
    every rank computes the same aux."""
    dt = cfg.dtype
    b, t, d = x.shape
    n, e = b * t, cfg.n_experts
    xf = x.reshape(n, d)
    probs = torch.softmax((xf @ lp["router"].to(dt)).to(torch.float32), dim=-1)  # [N, E]
    top = torch.argmax(probs, dim=-1)
    top_p = probs.amax(dim=-1)
    onehot = F.one_hot(top, e).to(torch.float32)
    aux = e * (onehot.mean(0) * probs.mean(0)).sum()

    cap = max(int(math.ceil(n / e * cfg.capacity_factor)), 1)
    pos = torch.cumsum(onehot, dim=0) * onehot                      # 1-based queue rank
    within = (pos > 0) & (pos <= cap)
    slots = 1.0 + torch.arange(cap, dtype=torch.float32, device=x.device)
    disp = within[..., None] & (pos[..., None] == slots[None, None, :])   # [N, E, cap]
    e_local = lp["w_gate"].shape[0]
    if e_local != e:
        off = mesh.group_rank(tensor_group) * e_local
        disp = disp[:, off:off + e_local]
    disp = disp.to(dt)
    combine = disp * mesh.copy_to_group(top_p, tensor_group)[:, None, None].to(dt)
    xe = torch.einsum("nec,nd->ecd", disp, mesh.copy_to_group(xf, tensor_group))
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, lp["w_gate"].to(dt)))
    h = h * torch.einsum("ecd,edf->ecf", xe, lp["w_up"].to(dt))
    ye = torch.einsum("ecf,efd->ecd", h, lp["w_down"].to(dt))
    out = mesh.reduce_from_group(torch.einsum("ecd,nec->nd", ye, combine), tensor_group)
    return out.reshape(b, t, d), aux


def decoder_layer(cfg: LlamaConfig, lp: Mapping[str, torch.Tensor], h: torch.Tensor,
                  pos: torch.Tensor, tensor_group=None, seq_group=None, moe: bool = False):
    """One pre-norm decoder layer of this rank's shard ``lp`` (a layer's
    leaves by key) on ``h`` ``[B, T, D]`` at rope positions ``pos``:
    ``(h, aux)``, ``aux`` ``None`` for the dense FFN."""
    dt, hd = cfg.dtype, cfg.head_dim
    b, t = h.shape[:2]
    x = mesh.copy_to_group(_rms_norm(h, lp["attn_norm"], cfg.norm_eps), tensor_group)
    q = (x @ lp["wq"].to(dt)).reshape(b, t, -1, hd).transpose(1, 2)
    k = (x @ lp["wk"].to(dt)).reshape(b, t, -1, hd).transpose(1, 2)
    v = (x @ lp["wv"].to(dt)).reshape(b, t, -1, hd).transpose(1, 2)
    q = _rope(q, pos, cfg.rope_theta)
    k = _rope(k, pos, cfg.rope_theta)
    o = ring_attention(q, k, v, group=seq_group)
    o = o.transpose(1, 2).reshape(b, t, -1)
    h = h + mesh.reduce_from_group(o @ lp["wo"].to(dt), tensor_group)
    x = _rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    if moe:
        # the router sees the replicated x: only the expert paths sum
        # their cotangents over the group
        out, aux = _moe_ffn(cfg, lp, x, tensor_group)
        return h + out, aux
    x = mesh.copy_to_group(x, tensor_group)
    gate = F.silu(x @ lp["w_gate"].to(dt))
    return h + mesh.reduce_from_group((gate * (x @ lp["w_up"].to(dt))) @ lp["w_down"].to(dt),
                                      tensor_group), None


def run_layer(cfg: LlamaConfig, lp: Mapping[str, torch.Tensor], h: torch.Tensor,
              pos: torch.Tensor, tensor_group=None, seq_group=None, moe: bool = False):
    """:func:`decoder_layer`, recomputed in the backward pass where
    ``cfg.remat``: the whole layer, never stopped early, since a recompute
    must run every collective of the layer's forward on every rank of its
    groups."""
    if not cfg.remat:
        return decoder_layer(cfg, lp, h, pos, tensor_group, seq_group, moe)
    with set_checkpoint_early_stop(False):
        return checkpoint(decoder_layer, cfg, lp, h, pos, tensor_group, seq_group, moe,
                          use_reentrant=False)


class Llama(nn.Module):
    """The decoder, tensor rank ``tensor_rank`` of ``tensor_size``'s shard;
    ``forward(tokens)`` gives this rank's logits ``[B, T, V / tp]`` in
    ``cfg.dtype``, ``forward(tokens, return_hidden=True)`` the final-normed
    hidden states (the input of :func:`fused_head_xent`); ``with_aux=True``
    returns ``(out, aux)``, the MoE load-balance loss averaged over the MoE
    layers (0 for the dense FFN).  ``tensor_group``
    (of ``tensor_size`` ranks) and ``seq_group`` are the process groups of
    the model axes, ``None`` where an axis has size 1.  ``layers`` (default
    all): the indices of the layers to hold.  Every layer is drawn in the
    seed's order and the others are dropped as soon as they are drawn, so
    the held leaves are those of the seed's whole model while the process
    holds at most one layer more; such a part is a pipeline stage's store
    (``train/pp_step.PipelineStage.build``) and has no forward."""

    def __init__(self, cfg: LlamaConfig, *, seed: int = 0, device=None, tensor_rank: int = 0,
                 tensor_size: int = 1, layers=None):
        super().__init__()
        cfg.validate_mesh(tensor_size)
        self.cfg = cfg
        self.tensor_rank, self.tensor_size = tensor_rank, tensor_size
        self.layer_ids = tuple(range(cfg.n_layers) if layers is None else layers)
        gen = torch.Generator(device=device if device is not None else "cpu").manual_seed(seed)
        held = []
        for i in range(cfg.n_layers):
            lp = LlamaLayer(cfg, gen, device, tensor_rank, tensor_size, cfg.is_moe_layer(i))
            if i in self.layer_ids:
                held.append(lp)
            del lp
        self.layers = nn.ModuleList(held)
        self.embed = nn.Parameter(
            torch.randn((cfg.vocab_size, cfg.dim), generator=gen, device=device) * 0.02)
        self.final_norm = nn.Parameter(torch.ones(cfg.dim, device=device))
        self.lm_head = nn.Parameter(_shard(_dense(gen, cfg.dim, (cfg.dim, cfg.vocab_size),
                                                  device), "lm_head", tensor_rank, tensor_size))

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False, *, tensor_group=None,
                seq_group=None, with_aux: bool = False):
        cfg = self.cfg
        if len(self.layers) != cfg.n_layers:
            raise ValueError(f"this Llama holds layers {list(self.layer_ids)} of "
                             f"{cfg.n_layers}: a pipeline stage's store has no forward")
        if mesh.axis_size(tensor_group) != self.tensor_size:
            raise ValueError(f"a tensor shard of {self.tensor_size} needs a tensor group of that "
                             f"size, got {mesh.axis_size(tensor_group)}")
        t = tokens.shape[1]
        pos = torch.arange(t, device=tokens.device)
        if seq_group is not None:
            pos = mesh.group_rank(seq_group) * t + pos
        # gather, then cast: the same values as the JAX embed.astype(dt)[tokens]
        # without a cast copy of the whole table
        h = F.embedding(tokens.long(), self.embed).to(cfg.dtype)
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
        n_moe = 0
        for lp in self.layers:
            h, aux = run_layer(cfg, lp.leaves(), h, pos, tensor_group, seq_group, lp.moe)
            if aux is not None:
                aux_total = aux_total + aux
                n_moe += 1
        h = _rms_norm(h, self.final_norm, cfg.norm_eps)
        out = h if return_hidden else (
            mesh.copy_to_group(h, tensor_group) @ self.lm_head.to(cfg.dtype))
        return (out, aux_total / max(n_moe, 1)) if with_aux else out


def param_leaves(model: Llama) -> Dict[str, nn.Parameter]:
    """The parameters in ``jax.tree.leaves`` order of the JAX tree (dict keys
    sorted): ``embed``, ``final_norm``, ``layers.<i>.<key>``, ``lm_head``."""
    out = {"embed": model.embed, "final_norm": model.final_norm}
    for i, lp in zip(model.layer_ids, model.layers):
        for key, p in lp.leaves().items():
            out[f"layers.{i}.{key}"] = p
    out["lm_head"] = model.lm_head
    return out


def layer_keys(cfg: LlamaConfig, i: int):
    """Layer ``i``'s keys in the JAX tree's (sorted) order."""
    return _MOE_KEYS if cfg.is_moe_layer(i) else _LAYER_KEYS


def is_sharded(cfg: LlamaConfig):
    """Per leaf of :func:`param_leaves`, whether the JAX ``param_specs``
    shard it over the tensor axis (``lm_step._lm_is_sharded``): the
    projections, the expert stacks and the LM head; the embedding, the norms
    and the router are replicated."""
    per_layer = [shard_axis(key, cfg.is_moe_layer(i)) is not None for i in range(cfg.n_layers)
                 for key in layer_keys(cfg, i)]
    return [False, False] + per_layer + [True]


def load_jax_params(cfg: LlamaConfig, tree: Mapping, tensor_rank: int = 0,
                    tensor_size: int = 1, device="cpu") -> Llama:
    """A :class:`Llama` holding tensor rank ``tensor_rank``'s shard of the
    JAX parameter tree ``tree`` (``init_llama``'s nested dict of whole
    leaves as numpy arrays), in the same layout."""
    model = Llama(cfg, device=device, tensor_rank=tensor_rank, tensor_size=tensor_size)
    leaves = param_leaves(model)
    want = {"embed": tree["embed"], "final_norm": tree["final_norm"], "lm_head": tree["lm_head"]}
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, cfg {cfg.n_layers}")
    for i, layer in enumerate(tree["layers"]):
        keys = layer_keys(cfg, i)
        if set(layer) != set(keys):
            raise ValueError(f"layer {i} keys {sorted(layer)} are not {list(keys)}")
        want.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    with torch.no_grad():
        for name, p in leaves.items():
            moe = name.startswith("layers.") and cfg.is_moe_layer(int(name.split(".")[1]))
            a = np.array(_shard(np.asarray(want[name]), name, tensor_rank, tensor_size, moe),
                         dtype=np.float32)
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape}, expected {tuple(p.shape)}")
            p.copy_(torch.from_numpy(a))
    return model


# ---------------------------------------------------------------------------
# The LM loss
# ---------------------------------------------------------------------------


def _vocab_offset(v_local: int, tensor_group) -> int:
    """The first vocab id of this tensor rank's logits shard."""
    return 0 if tensor_group is None else mesh.group_rank(tensor_group) * v_local


def vocab_parallel_xent(logits: torch.Tensor, targets: torch.Tensor,
                        tensor_group=None) -> torch.Tensor:
    """Mean next-token cross-entropy of this tensor rank's vocab shard of
    the logits ``[B, T, V / tp]`` against global ``targets`` ``[B, T]``
    (the JAX function): the max, the sum-exp and the target logit reduce
    over ``tensor_group`` (the max with no gradient, as the stabiliser
    cancels out of it)."""
    z = logits.to(torch.float32)
    v_local = z.shape[-1]
    off = _vocab_offset(v_local, tensor_group)
    zmax = z.detach().amax(-1)
    if mesh.axis_size(tensor_group) > 1:
        zmax = mesh.all_reduce_max(zmax, tensor_group)
    sumexp = torch.exp(z - zmax[..., None]).sum(-1)
    local_t = targets.long() - off
    in_shard = (local_t >= 0) & (local_t < v_local)
    zt = torch.gather(z, -1, local_t.clamp(0, v_local - 1)[..., None])[..., 0]
    zt = torch.where(in_shard, zt, 0.0)
    sumexp = mesh.reduce_from_group(sumexp, tensor_group)
    zt = mesh.reduce_from_group(zt, tensor_group)
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
    masks to -inf, which changes no valid column's result).  Over a tensor
    group the forward takes the max of the shards' running maxima and sums
    their rescaled sum-exps and target logits; the backward sums ``dh`` over
    the group (the replicated ``h``'s cotangent is the sum of the shards'
    partials, the JAX ``match_vma``), while each shard's ``dw`` is its
    own."""

    @staticmethod
    def forward(ctx, h, w, targets, chunk, group):
        d, v = h.shape[-1], w.shape[-1]
        h2, t1 = h.reshape(-1, d), targets.reshape(-1).long()
        t1 = t1 - _vocab_offset(v, group)
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
            # a target of another shard can alias into this shard's range
            # only through a negative or past-the-end id
            in_chunk = (lt >= 0) & (lt < z.shape[1]) & (t1 < v)
            zc = torch.gather(z, 1, lt.clamp(0, z.shape[1] - 1)[:, None])[:, 0]
            zt = zt + torch.where(in_chunk, zc, 0.0)
            m = m_new
        if mesh.axis_size(group) > 1:
            m_g = mesh.all_reduce_max(m, group)
            l = mesh.all_reduce_sum(l * torch.exp(m - m_g), group)
            zt = mesh.all_reduce_sum(zt, group)
            m = m_g
        lse = m + torch.log(l)
        ctx.save_for_backward(h, w, targets, lse)
        ctx.chunk, ctx.group = chunk, group
        return (lse - zt).mean()

    @staticmethod
    def backward(ctx, g):
        h, w, targets, lse = ctx.saved_tensors
        d, v = h.shape[-1], w.shape[-1]
        h2, t1 = h.reshape(-1, d), targets.reshape(-1).long()
        t1 = t1 - _vocab_offset(v, ctx.group)
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
        if mesh.axis_size(ctx.group) > 1:
            dh = mesh.all_reduce_sum(dh, ctx.group)
        return dh.reshape(h.shape).to(h.dtype), dw.to(w.dtype), None, None, None


def fused_head_xent(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                    chunk: int = 2048, tensor_group=None) -> torch.Tensor:
    """Mean next-token cross-entropy straight from hidden states ``h``
    ``[..., D]`` and this tensor rank's head shard ``w`` ``[D, V / tp]``,
    through a running logsumexp over ``chunk``-wide vocab slices; the
    backward recomputes each chunk's logits instead of saving them.  Equal
    to ``vocab_parallel_xent(h @ w, targets, tensor_group)`` up to rounding
    (float32 logits inside the chunks)."""
    return _FusedHeadXent.apply(h, w, targets, chunk, tensor_group)


_FUSED_XENT_AUTO_BYTES = 1 << 30


def use_fused_head_xent(n_tokens: int = 0, vocab: int = 0, itemsize: int = 2) -> bool:
    """Whether the LM loss takes :func:`fused_head_xent`: where the
    per-worker logits (``n_tokens x vocab`` at ``itemsize`` bytes) would
    exceed 1 GiB, the JAX package's automatic rule."""
    return n_tokens * vocab * itemsize > _FUSED_XENT_AUTO_BYTES
