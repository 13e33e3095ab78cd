"""The train and eval steps: forward, backward, compress, all-reduce, update.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.train.step`.  Each
process is one data-parallel worker: it computes the gradient of its local
mean loss, scales it by ``grad_scale`` (the harness passes the batch size,
so the compressor sees the reference's summed-loss gradient), optionally
clips it, and hands it to the compressed sync with the step's compression
seed (derived on the host from the run's seed and the step), whose
world-mean result drives SGD.  BatchNorm running statistics come from the
local batch and are averaged over the workers after the step, like the JAX
step's ``pmean``.

Metrics stay on the device (0-d tensors) so a step never waits for the
host; ``harness/loop.py`` fetches them once per epoch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
import torch.distributed as dist

from tpu_compressed_dp_torch.models.resnet9 import param_leaves
from tpu_compressed_dp_torch.ops.compressors import fold_in
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.parallel.dp import CompressionConfig, make_grad_sync
from tpu_compressed_dp_torch.train.optim import SGD, _value
from tpu_compressed_dp_torch.train.state import TrainState

__all__ = ["make_train_step", "make_eval_step", "cross_entropy_per_example",
           "cross_entropy_sum"]

# apply_fn(model, x, train) -> logits  (models/common.py)
ApplyFn = Callable[[torch.nn.Module, torch.Tensor, bool], torch.Tensor]


def cross_entropy_per_example(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy; out-of-range labels (eval padding)
    contribute 0."""
    logz = torch.log_softmax(logits.to(torch.float32), dim=-1)
    n_cls = logits.shape[-1]
    safe = labels.clamp(0, n_cls - 1).long()
    ll = torch.gather(logz, 1, safe[:, None])[:, 0]
    return torch.where((labels >= 0) & (labels < n_cls), -ll, 0.0)


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return cross_entropy_per_example(logits, labels).sum()


def make_train_step(apply_fn: ApplyFn, optimizer: SGD, comp_cfg: CompressionConfig, *,
                    grad_scale: float = 1.0, clip_norm: float = 0.0):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` is ``{'input': [B, 32, 32, 3], 'target': [B]}`` on the model's
    device (this rank's shard of the global batch).  ``clip_norm`` (mean-loss
    units; 0 = off) clips the local gradient by L2 norm before EF
    accumulation.  Metrics are world-reduced 0-d tensors: ``loss`` (mean),
    ``correct`` and ``count`` (sums), ``comm/*`` (means), plus ``lr``."""
    grad_sync = make_grad_sync(comp_cfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if comp_cfg.error_feedback and not isinstance(state.ef, dict):
            raise ValueError("error_feedback=True but state.ef is empty; build it "
                             "with init_ef_state(params, cfg)")
        model = state.model
        params = param_leaves(model)
        x, y = batch["input"], batch["target"]
        model.train()
        logits = apply_fn(model, x, True)
        loss = cross_entropy_sum(logits, y) / x.shape[0]  # local mean
        grads = torch.autograd.grad(loss, list(params.values()))
        scaled = {k: g.to(torch.float32) * grad_scale for k, g in zip(params, grads)}
        if clip_norm > 0.0:
            gnorm = torch.sqrt(sum((g * g).sum() for g in scaled.values()))
            factor = torch.clamp(clip_norm * grad_scale / torch.clamp(gnorm, min=1e-20),
                                 max=1.0)
            scaled = {k: g * factor for k, g in scaled.items()}
        # the step's compression seed: fold_in(state.rng, step) of the JAX step
        synced, new_ef, comm = grad_sync(scaled, state.ef, fold_in(state.seed, state.step))
        new_step = state.step + 1
        optimizer.apply(params, synced, state.opt_state, new_step)

        world = mesh.world()
        local_bs = float(x.shape[0])
        with torch.no_grad():
            correct = (logits.argmax(dim=1) == y).sum().to(torch.float32)
            totals = torch.stack([loss.detach() * local_bs, correct,
                                  torch.full_like(correct, local_bs)])
            comm_vals = torch.stack(list(comm.values()))
            if world > 1:
                # BN running stats and comm stats are world means; loss,
                # correct and count world sums (one all_reduce each)
                for buf in model.buffers():
                    dist.all_reduce(buf)
                    buf.div_(world)
                dist.all_reduce(totals)
                dist.all_reduce(comm_vals)
                comm_vals = comm_vals / world
        metrics = {
            "loss": totals[0] / totals[2],
            "correct": totals[1],
            "count": totals[2],
            "lr": _value(optimizer.lr, new_step),
        }
        for k, v in zip(comm, comm_vals):
            metrics[f"comm/{k}"] = v
        return dataclasses.replace(state, step=new_step, ef=new_ef), metrics

    return train_step


def make_eval_step(apply_fn: ApplyFn):
    """Build ``eval_step(state, batch) -> {loss_sum, correct, correct5, count}``
    (world sums, 0-d tensors); ``batch['mask']`` (1 = real example, 0 =
    padding) keeps padded rows out of every metric."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        model.eval()
        x, y = batch["input"], batch["target"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(y.shape[0], dtype=torch.float32, device=y.device)
        logits = apply_fn(model, x, False)
        loss = (cross_entropy_per_example(logits, y) * mask).sum()
        correct1 = ((logits.argmax(dim=1) == y) * mask).sum()
        top5 = torch.topk(logits, min(5, logits.shape[-1]), dim=1).indices
        correct5 = ((top5 == y[:, None]).any(dim=1) * mask).sum()
        out = torch.stack([loss, correct1, correct5, mask.sum()])
        if mesh.world() > 1:
            dist.all_reduce(out)
        return dict(zip(("loss_sum", "correct", "correct5", "count"), out))

    return eval_step
