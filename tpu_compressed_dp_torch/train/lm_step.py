"""The LM pretrain step: forward, backward, clip, partitioned compressed sync, SGD.

PyTorch counterpart of :mod:`tpu_compressed_dp.train.lm_step` on a
``(data, 1, 1)`` mesh: each process is one data-parallel worker holding the
whole model and its contiguous block of rows of the global batch (as
``P("data", "seq")`` shards them).  It takes the gradient of its local mean
loss ``xent + moe_aux_weight * aux`` (aux is 0 for the dense FFN), clips it
by the full-model norm where asked, and syncs it in two groups, the
tensor-replicated leaves (embedding and norms) and the tensor-sharded ones
(every projection and the head), in that sorted-signature order, as the JAX
step does even at tensor size 1; entire-model granularity therefore makes
two compress calls.  SGD then applies the world-mean gradient at the step's
schedule value.

Not ported yet: the step guard (ROADMAP.md queue 1, item 12), in-graph chaos
injection (item 12), ``sync_overlap > 1`` and PowerSGD (item 9), and the
sequence and tensor axes (item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

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
from tpu_compressed_dp_torch.ops.compressors import canonical_name, fold_in
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.parallel.dp import (
    CompressionConfig,
    init_ef_state,
    make_grouped_grad_sync,
    make_sharded_clip,
)
from tpu_compressed_dp_torch.train.optim import SGD, _value
from tpu_compressed_dp_torch.train.state import TrainState

__all__ = ["make_lm_train_step", "make_lm_eval_step", "init_lm_ef_state", "lm_loss",
           "local_rows"]


def _item(n: int) -> str:
    return f"ROADMAP.md queue 1, item {n}"


def init_lm_ef_state(cfg: LlamaConfig, params: Dict[str, torch.Tensor],
                     comp: CompressionConfig) -> Any:
    """This worker's zero float32 EF residual per parameter (``()`` when EF is
    off); the JAX state's leading worker axis is the process here."""
    return init_ef_state(params, comp)


def local_rows(batch_size: int, world: int, rank: int) -> slice:
    """This worker's contiguous block of rows of the global batch."""
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} must divide by the world size {world}")
    per = batch_size // world
    return slice(rank * per, (rank + 1) * per)


def lm_loss(cfg: LlamaConfig, model, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The local mean next-token loss, through the fused head + xent where
    the logits would exceed 1 GiB (per worker tokens x vocab at the config's
    width), else through the logits."""
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    if use_fused_head_xent(x.shape[0] * x.shape[1], cfg.vocab_size, itemsize):
        h = model(x, return_hidden=True)
        return fused_head_xent(h, model.lm_head.to(cfg.dtype), y)
    return vocab_parallel_xent(model(x), y)


def make_lm_train_step(cfg: LlamaConfig, optimizer: SGD, comp_cfg: CompressionConfig, *,
                       clip_norm: float = 0.0, clip_sent_norm: float = 0.0,
                       guard_cfg=None, chaos=None):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` is this worker's ``{'input': [B_local, T], 'target': [B_local,
    T]}`` (int tokens on the model's device).  ``clip_norm`` /
    ``clip_sent_norm`` clip the local / the synced gradient by the
    full-model L2 norm (0 = off).  Metrics are 0-d tensors: ``loss`` (world
    mean), ``tokens`` (world sum), ``lr`` and ``comm/*`` (world means)."""
    if guard_cfg is not None:
        raise NotImplementedError(f"the step guard is not ported yet: {_item(12)}")
    if chaos is not None:
        raise NotImplementedError(f"chaos injection is not ported yet: {_item(12)}")
    if comp_cfg.sync_overlap != 1:
        raise NotImplementedError(f"sync_overlap > 1 is not ported yet: {_item(9)}")
    if canonical_name(comp_cfg.method) == "powersgd":
        raise NotImplementedError(f"powersgd is not ported yet: {_item(9)}")
    sharded = is_sharded(cfg)
    grad_sync = make_grouped_grad_sync(comp_cfg, sharded, "tensor")
    clip_tree = make_sharded_clip(sharded, "tensor")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if comp_cfg.error_feedback and not isinstance(state.ef, dict):
            raise ValueError("error_feedback=True but state.ef is empty; build it with "
                             "init_lm_ef_state(cfg, params, comp)")
        model = state.model
        params = param_leaves(model)
        x, y = batch["input"], batch["target"]
        loss = lm_loss(cfg, model, x, y)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = {k: g.to(torch.float32) for k, g in zip(params, grads)}
        if clip_norm > 0.0:
            grads = clip_tree(grads, clip_norm)
        # the step's compression seed: fold_in(state.rng, step) of the JAX step
        synced, new_ef, comm = grad_sync(grads, state.ef, fold_in(state.seed, state.step))
        if clip_sent_norm > 0.0:
            synced = clip_tree(synced, clip_sent_norm)
        new_step = state.step + 1
        optimizer.apply(params, synced, state.opt_state, new_step)

        world = mesh.world()
        with torch.no_grad():
            # loss and comm stats are world means, tokens a world sum (one
            # all_reduce)
            vals = torch.stack([loss.detach().to(torch.float32),
                                torch.full((), float(x.numel()), device=loss.device),
                                *comm.values()])
            if world > 1:
                dist.all_reduce(vals)
            means = vals / world
        metrics = {"loss": means[0], "tokens": vals[1],
                   "lr": _value(optimizer.lr, new_step)}
        for i, k in enumerate(comm):
            metrics[f"comm/{k}"] = means[2 + i]
        return dataclasses.replace(state, step=new_step, ef=new_ef), metrics

    return train_step


def make_lm_eval_step(cfg: LlamaConfig):
    """``eval_step(state, batch) -> {'loss': world-mean nll, 'tokens': world
    count}`` through the logits (as the JAX eval step)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        x, y = batch["input"], batch["target"]
        loss = vocab_parallel_xent(state.model(x), y)
        vals = torch.stack([loss.to(torch.float32),
                            torch.full((), float(x.numel()), device=loss.device)])
        if mesh.world() > 1:
            dist.all_reduce(vals)
        return {"loss": vals[0] / mesh.world(), "tokens": vals[1]}

    return eval_step
