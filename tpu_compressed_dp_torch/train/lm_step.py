"""The LM pretrain step: forward, backward, clip, partitioned compressed sync, SGD.

PyTorch counterpart of :mod:`tpu_compressed_dp.train.lm_step` on the
``(data, seq, tensor)`` mesh of ``parallel/mesh.lm_groups``: each process is
one mesh position.  It holds its tensor shard of the model
(``models/transformer.Llama``) and its ``(data, seq)`` block of the global
batch (``P("data", "seq")``): the rows of its data index and the positions
of its seq index.  A ``(data, seq)`` pair is one compression worker.

Each rank takes the gradient of its local objective ``xent + moe_aux_weight
* aux`` (aux is the MoE load-balance loss, 0 for the dense FFN) and logs
``xent``.  The ring's backward sends the K/V
cotangents back around the seq group, so each worker's gradient is that of
the sum of the ring's losses, as JAX's AD gives it inside ``shard_map``;
the tensor group's collectives make the replicated leaves' gradients whole
and equal on every tensor rank.  The gradient is clipped by the full-model
norm where asked and synced over the workers group in two groups, the
tensor-replicated leaves (embedding, norms, routers) and the tensor-sharded
ones (every projection, expert stack and the head), in that sorted-signature
order, as the JAX
step does even at tensor size 1; entire-model granularity therefore makes
two compress calls.  The EF residual is this worker's, per shard on the
sharded leaves.  SGD then applies the workers' mean gradient at the step's
schedule value.

PowerSGD keeps its warm starts per signature (:func:`init_lm_comp_state`)
and, as in JAX, only at tensor size 1.  ``sync_overlap > 1`` chunk-pipelines
each signature group's sync (``parallel/overlap.py``): tensor hooks land the
gradients as the backward pass produces them and a chunk's collectives go
out when its last gradient lands; the update runs on the whole tree after
the sync, as the JAX LM step does.

``guard_cfg`` arms the step guard (``train/guard.py``) and ``chaos``
(``utils/chaos.py``) the fault injection, in the JAX step's order: the
objective is backpropagated at the loss scale (dynamic on bf16, the
identity on fp32), the chosen worker's (``guard.worker_index`` over the
workers group, the JAX ``(data, seq)`` axes) gradients or loss are
poisoned, every rank of the mesh (data, seq and tensor) votes, and the
gradients are unscaled in place.  A guarded step runs the whole backward
pass before the sync and reads the verdict on the host; on a veto the sync
runs on zeroed gradients, hands back the EF and compressor state, and SGD
does not run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from tpu_compressed_dp_torch.models.transformer import (
    LlamaConfig,
    fused_head_xent,
    is_sharded,
    param_leaves,
    use_fused_head_xent,
    vocab_parallel_xent,
)
from tpu_compressed_dp_torch.obs import trace as obs_trace
from tpu_compressed_dp_torch.ops.compressors import canonical_name, fold_in
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.parallel.dp import (
    CompressionConfig,
    PartitionedSync,
    init_comp_state_grouped,
    init_ef_state,
    make_partitioned_clip,
)
from tpu_compressed_dp_torch.train import guard as guard_mod
from tpu_compressed_dp_torch.train.optim import SGD, _value
from tpu_compressed_dp_torch.train.state import TrainState

__all__ = ["make_lm_train_step", "make_lm_eval_step", "init_lm_ef_state", "init_lm_comp_state",
           "lm_loss", "local_rows", "local_block"]

_POWERSGD_TP = ("powersgd over tensor-sharded params needs shard-local warm starts; run it on "
                "a (data[, seq]) mesh (tensor=1)")


def _groups(groups: Optional[mesh.LmGroups]) -> mesh.LmGroups:
    """The given mesh groups, or the data-parallel mesh of the world."""
    return groups if groups is not None else mesh.lm_groups(mesh.world())


def init_lm_ef_state(cfg: LlamaConfig, params: Dict[str, torch.Tensor],
                     comp: CompressionConfig) -> Any:
    """This worker's zero float32 EF residual per (local) parameter (``()``
    when EF is off); the JAX state's leading worker axis is the process
    here, and a sharded leaf's residual is this shard's."""
    return init_ef_state(params, comp)


def init_lm_comp_state(cfg: LlamaConfig, params: Dict[str, torch.Tensor],
                       comp: CompressionConfig, groups: Optional[mesh.LmGroups] = None) -> Any:
    """The compressor state of the LM step's grouped sync (PowerSGD's warm
    starts, ``{'sig<i>': {'q<gi>': Q}}``; ``()`` for stateless methods), the
    same on every worker.  PowerSGD needs tensor size 1, as in JAX."""
    if canonical_name(comp.method) != "powersgd":
        return ()
    if _groups(groups).tp > 1:
        raise NotImplementedError(_POWERSGD_TP)
    return init_comp_state_grouped(params, comp, is_sharded(cfg), "tensor")


def local_rows(batch_size: int, world: int, rank: int) -> slice:
    """This worker's contiguous block of rows of the global batch."""
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} must divide by the world size {world}")
    per = batch_size // world
    return slice(rank * per, (rank + 1) * per)


def local_block(batch_size: int, seq_len: int, groups: mesh.LmGroups):
    """This rank's ``(rows, positions)`` slices of a ``[batch_size,
    seq_len]`` global batch: ``P("data", "seq")``."""
    if seq_len % groups.sp:
        raise ValueError(f"seq_len {seq_len} must divide by sp={groups.sp}")
    return (local_rows(batch_size, groups.dp, groups.data_index),
            local_rows(seq_len, groups.sp, groups.seq_index))


def lm_loss(cfg: LlamaConfig, model, x: torch.Tensor, y: torch.Tensor,
            groups: Optional[mesh.LmGroups] = None):
    """``(objective, xent)``: the local mean next-token loss ``xent`` and the
    objective the step backpropagates, ``xent + moe_aux_weight * aux`` (aux
    the MoE load-balance loss, 0 for the dense FFN).  The loss goes through
    the fused head + xent where the logits would exceed 1 GiB (per worker
    tokens x the vocab shard at the config's width), else through the
    logits."""
    tg, sg = (groups.tensor, groups.seq) if groups is not None else (None, None)
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    if use_fused_head_xent(x.shape[0] * x.shape[1], cfg.vocab_size // mesh.axis_size(tg),
                           itemsize):
        h, aux = model(x, return_hidden=True, tensor_group=tg, seq_group=sg, with_aux=True)
        xent = fused_head_xent(h, model.lm_head.to(cfg.dtype), y, tensor_group=tg)
    else:
        logits, aux = model(x, tensor_group=tg, seq_group=sg, with_aux=True)
        xent = vocab_parallel_xent(logits, y, tg)
    return xent + cfg.moe_aux_weight * aux, xent


def make_lm_train_step(cfg: LlamaConfig, optimizer: SGD, comp_cfg: CompressionConfig, *,
                       groups: Optional[mesh.LmGroups] = None, clip_norm: float = 0.0,
                       clip_sent_norm: float = 0.0, guard_cfg=None, chaos=None):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``groups`` is this rank's ``mesh.lm_groups`` (default: the world as the
    data axis); ``state.model`` is this rank's tensor shard.  ``batch`` is
    this rank's ``{'input': [B_local, T_local], 'target': [B_local,
    T_local]}`` (int tokens on the model's device, :func:`local_block`).
    ``clip_norm`` / ``clip_sent_norm`` clip the local / the synced gradient
    by the full-model L2 norm (0 = off).  Metrics are 0-d tensors: ``loss``
    (workers' mean), ``tokens`` (workers' sum), ``lr`` and ``comm/*``
    (workers' means of model-wide totals), and with ``guard_cfg`` the
    ``guard/*`` scalars."""
    g = _groups(groups)
    cfg.validate_mesh(g.tp)
    if canonical_name(comp_cfg.method) == "powersgd" and g.tp > 1:
        raise NotImplementedError(_POWERSGD_TP)
    leaf_axes = [("tensor",) if s else () for s in is_sharded(cfg)]
    axis_groups = {"tensor": g.tensor}
    grad_sync = PartitionedSync(comp_cfg, leaf_axes, group=g.workers, axis_groups=axis_groups)
    clip_tree = make_partitioned_clip(leaf_axes, axis_groups)
    guard_mod.check_chaos_worker(chaos, g.dp * g.sp, "(data x seq) workers")
    hooked = (comp_cfg.sync_overlap > 1 and clip_norm == 0.0
              and not guard_mod.needs_whole_backward(guard_cfg, chaos))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if comp_cfg.error_feedback and not isinstance(state.ef, dict):
            raise ValueError("error_feedback=True but state.ef is empty; build it with "
                             "init_lm_ef_state(cfg, params, comp)")
        guard_mod.check_state(guard_cfg, state.guard)
        model = state.model
        params = param_leaves(model)
        x, y = batch["input"], batch["target"]
        # backpropagate the objective, log the cross-entropy (as JAX)
        with obs_trace.phase("grad"):
            objective, loss = lm_loss(cfg, model, x, y, g)
        objective = guard_mod.scale_objective(guard_cfg, state.guard, objective)
        # the step's compression seed: fold_in(state.rng, step) of the JAX step
        seed = fold_in(state.seed, state.step)
        ok = None
        if hooked:
            # each chunk's sync goes out as its last gradient lands
            rnd = grad_sync.begin(params, state.ef, state.comp, seed)
            hooks = [p.register_hook(lambda gr, i=i: rnd.land(i, gr.to(torch.float32)))
                     for i, p in enumerate(params.values())]
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
            grads = {k: gr.to(torch.float32) for k, gr in zip(params, grads)}
            # every rank of the mesh votes: the tensor shards' gradients
            # differ, and every replica must branch alike
            ok, loss, grads = guard_mod.vet(guard_cfg, chaos, state, loss, grads, g.workers)
            if clip_norm > 0.0:
                grads = clip_tree(grads, clip_norm)
            synced, new_ef, new_comp, comm = grad_sync(grads, state.ef, state.comp, seed, ok)
            del grads   # the update's peak memory holds no raw gradient
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
            # loss and comm stats are the workers' means, tokens their sum
            # (one all_reduce)
            vals = torch.stack([loss.detach().to(torch.float32),
                                torch.full((), float(x.numel()), device=loss.device),
                                *comm.values()])
            if workers > 1:
                dist.all_reduce(vals, group=g.workers)
            means = vals / workers
        metrics = {"loss": means[0], "tokens": vals[1],
                   "lr": _value(optimizer.lr, sched_step)}
        new_guard = guard_mod.finish(guard_cfg, state.guard, ok, new_step, metrics, comm,
                                     means[2:])
        return dataclasses.replace(state, step=new_step, ef=new_ef, comp=new_comp,
                                   guard=new_guard), metrics

    return train_step


def make_lm_eval_step(cfg: LlamaConfig, groups: Optional[mesh.LmGroups] = None):
    """``eval_step(state, batch) -> {'loss': the workers' mean nll, 'tokens':
    their count}`` through the logits (as the JAX eval step)."""
    g = _groups(groups)
    cfg.validate_mesh(g.tp)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        x, y = batch["input"], batch["target"]
        logits = state.model(x, tensor_group=g.tensor, seq_group=g.seq)
        loss = vocab_parallel_xent(logits, y, g.tensor)
        vals = torch.stack([loss.to(torch.float32),
                            torch.full((), float(x.numel()), device=loss.device)])
        workers = mesh.size(g.workers)
        if workers > 1:
            dist.all_reduce(vals, group=g.workers)
        return {"loss": vals[0] / workers, "tokens": vals[1]}

    return eval_step
