"""Epoch loops shared by the harnesses.

PyTorch-port counterpart of ``run_train_epoch``, ``run_eval``,
``train_epoch``, ``comm_summary`` and ``pad_batch`` of
:mod:`tpu_compressed_dp.harness.loop`, plus :func:`run_local_eval` for
loaders that hand each process its own (possibly empty) batches and
:func:`local_device` for the entry points.  Train metrics stay on the device
until the epoch ends and come back in one copy, so the host never waits on a
step.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.utils.loggers import MetricAccumulator
from tpu_compressed_dp_torch.utils.timer import Timer

__all__ = ["run_train_epoch", "run_eval", "run_local_eval", "train_epoch", "comm_summary",
           "pad_batch", "to_device", "local_device"]


def local_device(name: str) -> torch.device:
    """The entry points' ``--device``: ``cuda`` is this process's card
    (``LOCAL_RANK`` under ``torchrun``) and raises where CUDA is missing."""
    if name == "cuda" and "LOCAL_RANK" in os.environ:
        name = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return mesh.resolve_device(name)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def pad_batch(batch: Dict[str, np.ndarray], size: int) -> Dict[str, np.ndarray]:
    """Pad a short final batch to ``size`` rows with a 0/1 mask."""
    n = len(batch["target"])
    if n == size and "mask" in batch:
        return batch
    mask = np.zeros((size,), np.float32)
    mask[:n] = 1.0
    if n == size:
        return {**batch, "mask": mask}
    pad_n = size - n
    x = np.concatenate([batch["input"],
                        np.zeros((pad_n,) + batch["input"].shape[1:], batch["input"].dtype)])
    y = np.concatenate([batch["target"], np.full((pad_n,), -1, batch["target"].dtype)])
    return {"input": x, "target": y, "mask": mask}


def run_train_epoch(train_step, state: TrainState, batches: Iterable[Dict], device
                    ) -> Tuple[TrainState, MetricAccumulator]:
    step_metrics = []
    for batch in batches:
        state, metrics = train_step(state, to_device(batch, device))
        step_metrics.append(metrics)
    acc = MetricAccumulator()
    if step_metrics:
        keys = [k for k, v in step_metrics[0].items() if isinstance(v, torch.Tensor)]
        fetched = torch.stack([torch.stack([m[k] for k in keys])
                               for m in step_metrics]).cpu().numpy()
        for row, m in zip(fetched, step_metrics):
            host = dict(zip(keys, row.tolist()))
            host.update({k: v for k, v in m.items() if not isinstance(v, torch.Tensor)})
            acc.update(host)
    return state, acc


def _shard(batch: Dict[str, np.ndarray], rank: int, world: int) -> Dict[str, np.ndarray]:
    per = len(batch["target"]) // world
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def run_eval(eval_step, state: TrainState, batches: Iterable[Dict], batch_size: int,
             device, rank: int = 0, world: int = 1) -> Dict[str, float]:
    """Every batch is padded to ``batch_size`` rows; each rank evaluates its
    ``batch_size / world`` share and the eval step sums over the world."""
    return _eval_sums(eval_step, state, (_shard(pad_batch(b, batch_size), rank, world)
                                         for b in batches), device)


def run_local_eval(eval_step, state: TrainState, batches: Iterable[Dict], batch_size: int,
                   device) -> Dict[str, float]:
    """Each process evaluates its own batches, each padded (an empty one
    wholly) to ``batch_size`` rows with a 0/1 mask; every process must run
    the same number of batches (``ValLoader``'s contract), since the eval
    step sums over the world.  Loss and accuracies (top-1 ``acc``, top-5
    ``acc5``) are over the real examples."""
    return _eval_sums(eval_step, state, (pad_batch(b, batch_size) for b in batches), device)


def _eval_sums(eval_step, state: TrainState, batches: Iterable[Dict], device
               ) -> Dict[str, float]:
    sums = torch.zeros(4, dtype=torch.float64)
    keys = ("loss_sum", "correct", "correct5", "count")
    outs = [eval_step(state, to_device(b, device)) for b in batches]
    if outs:
        sums = torch.stack([torch.stack([o[k] for k in keys]) for o in outs]).cpu().double()
        sums = sums.sum(0)
    loss_sum, correct, correct5, count = sums.tolist()
    n = max(count, 1.0)
    return {"loss": loss_sum / n, "acc": correct / n, "acc5": correct5 / n, "count": count}


def comm_summary(acc: MetricAccumulator) -> Dict[str, float]:
    """'sent frac' = elements that travel; 'wire frac' = bits that travel
    vs a dense fp32 all-reduce."""
    if "comm/sent_elems" not in acc.sums:
        return {}
    dense = max(acc.mean("comm/dense_elems"), 1.0)
    return {
        "sent frac": acc.mean("comm/sent_elems") / dense,
        "wire frac": acc.mean("comm/sent_bits") / (32.0 * dense),
    }


def train_epoch(train_step, eval_step, state: TrainState, train_batches, test_batches,
                timer: Timer, batch_size: int, device, rank: int = 0, world: int = 1
                ) -> Tuple[TrainState, Dict[str, float], MetricAccumulator]:
    """One train + eval pass with the reference's epoch-summary shape
    (`core.py:324-331`)."""
    state, train_acc = run_train_epoch(train_step, state, train_batches, device)
    train_time = timer()
    test_stats = run_eval(eval_step, state, test_batches, batch_size, device, rank, world)
    test_time = timer(False)  # eval time stays out of the DAWNBench total
    summary = {
        "train time": train_time,
        "train loss": train_acc.mean("loss"),
        "train acc": train_acc.mean("correct"),
        "test time": test_time,
        "test loss": test_stats["loss"],
        "test acc": test_stats["acc"],
        "total time": timer.total_time,
    }
    summary.update(comm_summary(train_acc))
    return state, summary, train_acc
