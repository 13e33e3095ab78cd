"""The GPipe pipeline-parallel LM step over the ``(data[, seq], pipe[, tensor])`` mesh.

PyTorch counterpart of :mod:`tpu_compressed_dp.train.pp_step`.  Each process
is one mesh position of ``parallel/mesh.lm_groups(dp, sp, tp, pp)`` (rank
``((d * sp + s) * pp + p) * tp + t``, the JAX ``make_pp_mesh`` order) and
holds a :class:`PipelineStage`: the embedding, the final norm and the LM head
(this tensor rank's shard), and its ``L / pp`` decoder layers stacked per key,
``{key: [L / pp, ...]}`` in the JAX tree's sorted key order, as the JAX
``stack_layer_params`` stacks them and shards the stack over ``pipe``.  A
stacked key is one leaf: layer-wise compression syncs it as one group and
entire-model compression concatenates the leaves in that order.

The schedule is the JAX one, run as a Python loop of ``M + S - 1`` ticks
(``M`` microbatches, ``S`` stages): at tick ``t`` stage 0 injects the
embedding of microbatch ``t``, every stage runs its layers on what it holds,
and hands the result to its right neighbour with one differentiable
``mesh.ppermute``; ramp ticks compute on zeros.  Every rank builds the same
graph (the injection and the last stage's drain are masked selects, not
branches), so the backward pass issues every collective in one order on
every rank of a group.  The final norm, head and loss are deferred past the
loop: the last stage's drained activations are summed over ``pipe``
(``mesh.sum_over_group``, whose backward sums the stages' cotangents), and
each stage heads ``M / S`` microbatches at ``scale = 1 / S`` (every stage all
``M`` where ``M % S != 0``).  The loss is the sum of the stages' shares over
``pipe``.  As in JAX the MoE load-balance loss is dropped: the pipelined step
trains without it.

After the backward pass the gradients of the pipe-replicated leaves
(``embed``, ``final_norm``, ``lm_head``) are summed over ``pipe``, as
``shard_map``'s AD sums a pipe-invariant leaf's, before the data-axis sync.
The tensor axis keeps the model's Megatron pair.  The sync is
``dp.PartitionedSync`` over the ``(data, seq)`` workers, one group per
replication signature over ``(pipe[, tensor])``, its stats summed over the
model axes; EF is per worker, and ``clip_norm`` / ``clip_sent_norm`` and the
``sync_overlap`` hooks behave as in ``train/lm_step.py``.  PowerSGD is
refused, as JAX refuses it.  ``guard_cfg`` / ``chaos`` arm the step guard
and the fault injection as in ``train/lm_step.py``: the loss the vote and
the metrics read is the pipe-summed one, and every rank of the mesh (every
stage included) votes, so a NaN in one stage's layers vetoes the update on
all of them.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from tpu_compressed_dp_torch.models.transformer import (
    Llama,
    LlamaConfig,
    _rms_norm,
    fused_head_xent,
    layer_keys,
    run_layer,
    shard_axis,
    use_fused_head_xent,
    vocab_parallel_xent,
)
from tpu_compressed_dp_torch.obs import trace as obs_trace
from tpu_compressed_dp_torch.ops.compressors import canonical_name, fold_in
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.parallel.dp import (
    CompressionConfig,
    PartitionedSync,
    make_partitioned_clip,
)
from tpu_compressed_dp_torch.train import guard as guard_mod
from tpu_compressed_dp_torch.train.optim import SGD, _value
from tpu_compressed_dp_torch.train.state import TrainState

__all__ = ["PipelineStage", "stage_leaves", "stage_leaf_axes", "pp_loss", "make_pp_train_step"]

_POWERSGD_PP = ("powersgd is not yet supported with pipeline parallelism; run it on a "
                "(data[, seq]) mesh")
_HOMOGENEOUS = ("pipeline stages need homogeneous layers: MoE configs require moe_every=1")
# the leaves every stage holds whole over the pipe axis
_PIPE_REPLICATED = ("embed", "final_norm", "lm_head")


def check_stages(cfg: LlamaConfig, stages: int) -> None:
    """The JAX step's checks: the layers split evenly over the stages, and
    every layer has the same keys (dense, or MoE with ``moe_every=1``)."""
    if cfg.n_layers % stages:
        raise ValueError(f"n_layers ({cfg.n_layers}) must divide by pipe size {stages}")
    if cfg.n_experts and cfg.moe_every != 1:
        raise ValueError(_HOMOGENEOUS)


class PipelineStage(nn.Module):
    """Pipe rank ``pipe_rank`` of ``pipe_size``'s stage of ``model`` (a
    :class:`Llama`, whole or a tensor shard): its embedding, final norm and
    LM head, and its ``L / pipe_size`` layers stacked per key
    (``self.layers[key]`` ``[L / pipe_size, ...]``, keys in sorted order);
    ``model`` holds every layer or just this stage's.
    ``PipelineStage.build(cfg, ...)`` draws every layer of a seed in order and
    keeps only this stage's (``Llama(..., layers=...)``), so the stages of one
    seed make up that seed's :class:`Llama` while a rank never holds the
    whole model."""

    def __init__(self, model: Llama, pipe_rank: int = 0, pipe_size: int = 1):
        super().__init__()
        cfg = model.cfg
        check_stages(cfg, pipe_size)
        self.cfg = cfg
        self.pipe_rank, self.pipe_size = pipe_rank, pipe_size
        self.tensor_rank, self.tensor_size = model.tensor_rank, model.tensor_size
        per = cfg.n_layers // pipe_size
        held = dict(zip(model.layer_ids, model.layers))
        ids = range(pipe_rank * per, (pipe_rank + 1) * per)
        if any(i not in held for i in ids):
            raise ValueError(f"stage {pipe_rank} of {pipe_size} needs layers {list(ids)}; the "
                             f"model holds {list(held)}")
        mine = [held[i] for i in ids]
        self.moe = bool(cfg.n_experts)
        self.layers = nn.ParameterDict(
            {k: nn.Parameter(torch.stack([getattr(lp, k).detach() for lp in mine]))
             for k in layer_keys(cfg, 0)})
        self.embed, self.final_norm, self.lm_head = model.embed, model.final_norm, model.lm_head

    @classmethod
    def build(cls, cfg: LlamaConfig, *, seed: int = 0, device=None, pipe_rank: int = 0,
              pipe_size: int = 1, tensor_rank: int = 0, tensor_size: int = 1):
        check_stages(cfg, pipe_size)
        per = cfg.n_layers // pipe_size
        return cls(Llama(cfg, seed=seed, device=device, tensor_rank=tensor_rank,
                         tensor_size=tensor_size,
                         layers=range(pipe_rank * per, (pipe_rank + 1) * per)),
                   pipe_rank, pipe_size)

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i`` of the stage, its leaves by key (views into the
        stacks, so their gradients land in the stacks')."""
        return {k: v[i] for k, v in self.layers.items()}


def stage_leaves(stage: PipelineStage) -> Dict[str, nn.Parameter]:
    """The stage's parameters in ``jax.tree.leaves`` order of the JAX
    stacked tree: ``embed``, ``final_norm``, ``layers.<key>`` (sorted),
    ``lm_head``."""
    out = {"embed": stage.embed, "final_norm": stage.final_norm}
    out.update({f"layers.{k}": v for k, v in stage.layers.items()})
    out["lm_head"] = stage.lm_head
    return out


def stage_leaf_axes(cfg: LlamaConfig, tp: int = 1):
    """Per leaf of :func:`stage_leaves`, the model axes the JAX
    ``pp_state_specs`` shard it over: layer stacks over ``pipe`` (and their
    weights over ``tensor`` where ``tp > 1``), the head over ``tensor``
    where ``tp > 1``, the embedding and final norm over neither."""
    t = ("tensor",) if tp > 1 else ()
    moe = cfg.is_moe_layer(0)
    return ([(), ()] + [("pipe",) + (() if shard_axis(k, moe) is None else t)
                        for k in layer_keys(cfg, 0)] + [t])


def pp_loss(cfg: LlamaConfig, stage: PipelineStage, x: torch.Tensor, y: torch.Tensor,
            groups: mesh.LmGroups, microbatches: int) -> torch.Tensor:
    """This stage's share of the pipelined loss, ``nll * (1 / S)`` of the
    microbatches it heads; summed over ``pipe`` it is the local mean
    next-token loss.  ``x``, ``y``: this rank's ``(data, seq)`` block."""
    g, m_total = groups, microbatches
    stages, p = g.pp, g.pipe_index
    dt = cfg.dtype
    b_local, t_len = x.shape
    if b_local % m_total:
        raise ValueError(f"local batch {b_local} must divide by microbatches={m_total}")
    mb = b_local // m_total
    xs, ys = x.reshape(m_total, mb, t_len), y.reshape(m_total, mb, t_len)
    pos = torch.arange(t_len, device=x.device)
    if g.seq is not None:
        pos = g.seq_index * t_len + pos
    per = cfg.n_layers // stages
    perm = mesh.ring_perm(stages)
    dev = x.device
    h_cur = torch.zeros((mb, t_len, cfg.dim), dtype=dt, device=dev)
    ticks = []
    for t in range(m_total + stages - 1):
        # stage 0 injects microbatch t (clamped, masked past M): a select on
        # every rank, so every rank's graph has the same nodes
        emb = F.embedding(xs[min(t, m_total - 1)].long(), stage.embed).to(dt)
        inject = torch.tensor(p == 0 and t < m_total, device=dev)
        h = torch.where(inject, emb, h_cur)
        for i in range(per):
            h, _ = run_layer(cfg, stage.layer(i), h, pos, g.tensor, g.seq, stage.moe)
        ticks.append(h)
        # the last tick's hand-off would reach no one
        if t < m_total + stages - 2:
            h_cur = mesh.ppermute(h, perm, g.pipe) if stages > 1 else h
    # the last stage emits microbatch j at tick S - 1 + j
    emitted = torch.stack(ticks[stages - 1:stages - 1 + m_total])      # [M, mb, T, D]
    last = torch.tensor(p == stages - 1, device=dev)
    emitted = mesh.sum_over_group(torch.where(last, emitted, torch.zeros_like(emitted)), g.pipe)
    if m_total % stages == 0:
        m_s = m_total // stages
        my_h, my_y = emitted[p * m_s:(p + 1) * m_s], ys[p * m_s:(p + 1) * m_s]
    else:   # uneven split: every stage heads the whole drained batch
        m_s, my_h, my_y = m_total, emitted, ys
    hn = _rms_norm(my_h.reshape(m_s * mb, t_len, cfg.dim), stage.final_norm, cfg.norm_eps)
    my_y = my_y.reshape(m_s * mb, t_len)
    tg = g.tensor
    itemsize = torch.empty((), dtype=dt).element_size()
    if use_fused_head_xent(m_s * mb * t_len, cfg.vocab_size // mesh.axis_size(tg), itemsize):
        nll = fused_head_xent(hn, stage.lm_head.to(dt), my_y, tensor_group=tg)
    else:
        nll = vocab_parallel_xent(mesh.copy_to_group(hn, tg) @ stage.lm_head.to(dt), my_y, tg)
    return nll * (1.0 / stages)


def make_pp_train_step(cfg: LlamaConfig, optimizer: SGD, comp_cfg: CompressionConfig, *,
                       groups: mesh.LmGroups, microbatches: int, clip_norm: float = 0.0,
                       clip_sent_norm: float = 0.0, guard_cfg=None, chaos=None):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``state.model`` is this rank's :class:`PipelineStage`; ``batch`` is this
    rank's ``(data, seq)`` block ``{'input', 'target'}`` (``lm_step.
    local_block``), its rows divisible by ``microbatches``.  Metrics as
    ``lm_step.make_lm_train_step``'s: ``loss`` (the workers' mean of the
    pipe-summed loss), ``tokens``, ``lr`` and ``comm/*`` (model-wide totals,
    the workers' means)."""
    if canonical_name(comp_cfg.method) == "powersgd":
        # the stacked layers shard over pipe, so warm starts would need
        # per-stage shapes no init builds (the JAX refusal)
        raise NotImplementedError(_POWERSGD_PP)
    g = groups
    stages = g.pp
    cfg.validate_mesh(g.tp)
    check_stages(cfg, stages)
    if microbatches % stages:
        warnings.warn(
            f"microbatches ({microbatches}) not divisible by pipe size ({stages}): the deferred "
            "LM head falls back to every stage heading the full drained batch — correct, but "
            "S x the logits memory and head FLOPs of the even-split fast path", stacklevel=2)
    leaf_axes = stage_leaf_axes(cfg, g.tp)
    axis_groups = {"pipe": g.pipe, "tensor": g.tensor}
    grad_sync = PartitionedSync(comp_cfg, leaf_axes, group=g.workers, axis_groups=axis_groups)
    clip_tree = make_partitioned_clip(leaf_axes, axis_groups)
    guard_mod.check_chaos_worker(chaos, g.dp * g.sp, "(data x seq) workers")
    hooked = (comp_cfg.sync_overlap > 1 and clip_norm == 0.0
              and not guard_mod.needs_whole_backward(guard_cfg, chaos))

    def pipe_sum(k: str, gr: torch.Tensor) -> torch.Tensor:
        # a pipe-replicated leaf's gradient is the sum of the stages' parts
        gr = gr.to(torch.float32)
        if k in _PIPE_REPLICATED and stages > 1:
            gr = mesh.all_reduce_sum(gr, g.pipe)
        return gr

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if comp_cfg.error_feedback and not isinstance(state.ef, dict):
            raise ValueError("error_feedback=True but state.ef is empty; build it with "
                             "dp.init_ef_state(stage_leaves(stage), comp)")
        guard_mod.check_state(guard_cfg, state.guard)
        params = stage_leaves(state.model)
        x, y = batch["input"], batch["target"]
        with obs_trace.phase("grad"):
            share = pp_loss(cfg, state.model, x, y, g, microbatches)
        objective = guard_mod.scale_objective(guard_cfg, state.guard, share)
        with torch.no_grad():
            # the pipe-summed loss (the JAX step's psum over pipe): what the
            # vote and the metrics read
            loss = share.detach().to(torch.float32)
            if stages > 1:
                loss = mesh.all_reduce_sum(loss, g.pipe)
        seed = fold_in(state.seed, state.step)
        ok = None
        if hooked:
            # each chunk's sync goes out as its last gradient lands
            rnd = grad_sync.begin(params, state.ef, state.comp, seed)
            hooks = [p.register_hook(lambda gr, i=i, k=k: rnd.land(i, pipe_sum(k, gr)))
                     for i, (k, p) in enumerate(params.items())]
            try:
                with obs_trace.phase("grad"):
                    torch.autograd.grad(objective, list(params.values()))
            finally:
                for h in hooks:
                    h.remove()
            synced, new_ef, new_comp, comm = rnd.collect()
        else:
            with obs_trace.phase("grad"):
                grads = torch.autograd.grad(objective, list(params.values()))
            grads = {k: pipe_sum(k, gr) for k, gr in zip(params, grads)}
            # every stage and tensor shard votes
            ok, loss, grads = guard_mod.vet(guard_cfg, chaos, state, loss, grads, g.workers)
            if clip_norm > 0.0:
                grads = clip_tree(grads, clip_norm)
            synced, new_ef, new_comp, comm = grad_sync(grads, state.ef, state.comp, seed, ok)
            del grads
        new_step = state.step + 1
        sched_step = guard_mod.schedule_step(guard_cfg, state.guard, new_step)
        if ok is not False:
            if clip_sent_norm > 0.0:
                synced = clip_tree(synced, clip_sent_norm)
            with obs_trace.phase("update"):
                optimizer.apply(params, synced, state.opt_state, sched_step)
        del synced

        workers = mesh.size(g.workers)
        with torch.no_grad():
            vals = torch.stack([loss, torch.full((), float(x.numel()), device=loss.device),
                                *comm.values()])
            if workers > 1:
                dist.all_reduce(vals, group=g.workers)
            means = vals / workers
        metrics = {"loss": means[0], "tokens": vals[1], "lr": _value(optimizer.lr, sched_step)}
        new_guard = guard_mod.finish(guard_cfg, state.guard, ok, new_step, metrics, comm,
                                     means[2:])
        return dataclasses.replace(state, step=new_step, ef=new_ef, comp=new_comp,
                                   guard=new_guard), metrics

    return train_step

