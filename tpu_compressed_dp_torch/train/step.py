"""The train and eval steps: forward, backward, compress, all-reduce, update.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.train.step`.  Each
process is one data-parallel worker: it computes the gradient of its local
mean loss, scales it by ``grad_scale`` (the harness passes the batch size,
so the compressor sees the reference's summed-loss gradient), optionally
clips it, and hands it to the compressed sync with the step's compression
seed (derived on the host from the run's seed and the step), whose
world-mean result drives SGD.  The compressor state (``state.comp``,
PowerSGD's warm starts) threads through the sync.  A model with dropout
(a ``dropout_rate`` attribute above 0) draws its keep masks from a
generator seeded with :func:`dropout_seed` ``(seed, step, rank)``, as the
JAX step folds the worker index into its dropout key.  BatchNorm running
statistics come from the local batch and are averaged over the workers
after the step, like the JAX step's ``pmean``.

``comp_cfg.sync_overlap > 1`` pipelines the sync (``parallel/overlap.py``):
a tensor hook on each parameter lands its scaled gradient as the backward
pass produces it, each chunk's sync starts when its last gradient lands,
and each chunk's slice of SGD runs once its collectives are waited on.  The
numerics are the single sync's, bit for bit.

``guard_cfg`` arms the step guard (``train/guard.py``): the loss is
backpropagated at the guard's loss scale, ``chaos`` (``utils/chaos.py``)
poisons the chosen worker's gradients or loss, the workers vote on the
finiteness of the loss and the gradients, and the gradients are unscaled,
in the JAX step's order.  A guarded step runs the whole backward pass
before the sync (the vote needs every gradient) and reads the verdict on
the host once; on a vetoed step the sync runs on zeroed gradients and hands
back the EF and compressor state unchanged, SGD does not run, and the
BatchNorm running statistics go back to their snapshot from before the
forward pass, so every tensor of the state keeps its bits.  Schedules read
``guard.schedule_step`` (the applied updates).

Metrics stay on the device (0-d tensors) so an unguarded step never waits
for the host; ``harness/loop.py`` fetches them once per epoch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
import torch.distributed as dist

from tpu_compressed_dp_torch.models.common import param_leaves
from tpu_compressed_dp_torch.obs import trace as obs_trace
from tpu_compressed_dp_torch.ops.compressors import fold_in
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.parallel.dp import CompressionConfig, make_stateful_grad_sync
from tpu_compressed_dp_torch.parallel.overlap import ChunkedSync
from tpu_compressed_dp_torch.train import guard as guard_mod
from tpu_compressed_dp_torch.train.optim import SGD, _value
from tpu_compressed_dp_torch.train.state import TrainState

__all__ = ["make_train_step", "make_eval_step", "cross_entropy_per_example",
           "cross_entropy_sum", "dropout_seed"]

# apply_fn(model, x, train[, dropout]) -> logits  (models/common.py)
ApplyFn = Callable[..., torch.Tensor]

# the dropout stream of a step's seed, apart from its per-group compression
# seeds (leaf_seed folds in group indices, far below this)
_DROPOUT_STREAM = 0x64726F706F7574


def dropout_seed(seed: int, step: int, rank: int) -> int:
    """The dropout generator's seed of ``rank`` at ``step``."""
    return fold_in(fold_in(fold_in(seed, step), _DROPOUT_STREAM), rank)


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
                    grad_scale: float = 1.0, clip_norm: float = 0.0,
                    clip_sent_norm: float = 0.0, guard_cfg=None, chaos=None):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` is ``{'input': [B, 32, 32, 3], 'target': [B]}`` on the model's
    device (this rank's shard of the global batch).  ``clip_norm`` (mean-loss
    units; 0 = off) clips the local gradient by L2 norm before EF
    accumulation; ``clip_sent_norm`` (the same units) clips the synced
    gradient by its global L2 norm before the optimizer, which bounds the
    residual's release itself.  ``guard_cfg`` / ``chaos``: the step guard and
    fault injection (module docstring); ``state.guard`` comes from
    ``guard.init_guard_state``.  Metrics are world-reduced 0-d tensors:
    ``loss`` (mean), ``correct`` and ``count`` (sums), ``comm/*`` (means),
    plus ``lr`` and the guard's ``guard/*``."""
    grad_sync = make_stateful_grad_sync(comp_cfg)
    chunked = ChunkedSync(comp_cfg) if comp_cfg.sync_overlap > 1 else None
    # the clip, the vote and the injection need every gradient before any
    # chunk compresses
    whole = clip_norm > 0.0 or guard_mod.needs_whole_backward(guard_cfg, chaos)

    def sync_and_apply(state: TrainState, params, loss, seed: int, new_step: int):
        """Backward, vote, sync and the optimizer: ``(new_ef, new_comp, comm,
        ok, loss)``, ``ok`` the guard's verdict (None unguarded) and ``loss``
        the local loss after any injection (0 on a veto)."""
        sched_step = guard_mod.schedule_step(guard_cfg, state.guard, new_step)
        ok = None
        objective = guard_mod.scale_objective(guard_cfg, state.guard, loss)
        if chunked is None or whole:
            with obs_trace.phase("grad"):
                grads = torch.autograd.grad(objective, list(params.values()))
            scaled = {k: g.to(torch.float32) * grad_scale for k, g in zip(params, grads)}
            del grads
            ok, loss, scaled = guard_mod.vet(guard_cfg, chaos, state, loss, scaled)
            if clip_norm > 0.0:
                gnorm = torch.sqrt(sum((g * g).sum() for g in scaled.values()))
                factor = torch.clamp(clip_norm * grad_scale / torch.clamp(gnorm, min=1e-20),
                                     max=1.0)
                scaled = {k: g * factor for k, g in scaled.items()}
        if chunked is None:
            synced, new_ef, new_comp, comm = grad_sync(scaled, state.ef, state.comp, seed, ok=ok)
        else:
            rnd = chunked.begin(params, state.ef, state.comp, seed, ok)
            if whole:
                rnd.land_all(scaled)
            else:
                def land(i):
                    return lambda g: rnd.land(i, g.to(torch.float32) * grad_scale)

                hooks = [p.register_hook(land(i)) for i, p in enumerate(params.values())]
                try:
                    # the chunks' ranges nest inside the backward's
                    with obs_trace.phase("grad"):
                        torch.autograd.grad(objective, list(params.values()))
                finally:
                    for h in hooks:
                        h.remove()
            if clip_sent_norm == 0.0 and ok is not False:
                new_ef, new_comp, comm = rnd.apply(params, optimizer, state.opt_state,
                                                   sched_step)
                return new_ef, new_comp, comm, ok, loss
            synced, new_ef, new_comp, comm = rnd.collect()
        if ok is False:
            return new_ef, new_comp, comm, ok, loss   # a vetoed step updates nothing
        if clip_sent_norm > 0.0:
            snorm = torch.sqrt(sum((g * g).sum() for g in synced.values()))
            sfactor = torch.clamp(clip_sent_norm * grad_scale / torch.clamp(snorm, min=1e-20),
                                  max=1.0)
            synced = {k: g * sfactor for k, g in synced.items()}
        with obs_trace.phase("update"):
            optimizer.apply(params, synced, state.opt_state, sched_step)
        return new_ef, new_comp, comm, ok, loss

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if comp_cfg.error_feedback and not isinstance(state.ef, dict):
            raise ValueError("error_feedback=True but state.ef is empty; build it "
                             "with init_ef_state(params, cfg)")
        guard_mod.check_state(guard_cfg, state.guard)
        world = mesh.world()
        guard_mod.check_chaos_worker(chaos, world, "data-parallel workers")
        model = state.model
        params = param_leaves(model)
        x, y = batch["input"], batch["target"]
        model.train()
        # the forward pass updates the BatchNorm running statistics in place:
        # a vetoed step puts them back
        bn_snapshot = ([b.detach().clone() for b in model.buffers()]
                       if guard_cfg is not None else None)
        with obs_trace.phase("grad"):
            if getattr(model, "dropout_rate", 0.0) > 0.0:
                gen = torch.Generator(device=x.device).manual_seed(
                    dropout_seed(state.seed, state.step, mesh.rank()))
                logits = apply_fn(model, x, True, gen)
            else:
                logits = apply_fn(model, x, True)
            loss = cross_entropy_sum(logits, y) / x.shape[0]  # local mean
        new_step = state.step + 1
        # the step's compression seed: fold_in(state.rng, step) of the JAX step
        new_ef, new_comp, comm, ok, loss = sync_and_apply(
            state, params, loss, fold_in(state.seed, state.step), new_step)

        local_bs = float(x.shape[0])
        with torch.no_grad():
            if ok is False:
                for buf, old in zip(model.buffers(), bn_snapshot):
                    buf.copy_(old)
            correct = (logits.argmax(dim=1) == y).sum().to(torch.float32)
            totals = torch.stack([loss.detach() * local_bs, correct,
                                  torch.full_like(correct, local_bs)])
            comm_vals = torch.stack(list(comm.values()))
            if world > 1:
                # BN running stats and comm stats are world means; loss,
                # correct and count world sums (one all_reduce each)
                if ok is not False:
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
            "lr": _value(optimizer.lr, guard_mod.schedule_step(guard_cfg, state.guard,
                                                                new_step)),
        }
        new_guard = guard_mod.finish(guard_cfg, state.guard, ok, new_step, metrics, comm,
                                     comm_vals)
        return dataclasses.replace(state, step=new_step, ef=new_ef, comp=new_comp,
                                   guard=new_guard), metrics

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
