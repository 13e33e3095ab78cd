"""Epoch loops and the robustness surface shared by the harnesses.

PyTorch-port counterpart of ``run_train_epoch``, ``run_eval``,
``train_epoch``, ``comm_summary``, ``guard_summary``, ``pad_batch`` and the
robustness helpers (``add_robustness_args``, ``add_checkpoint_args``,
``build_robustness``, ``make_heartbeat``, ``make_preemption``,
``preempt_exit``) of :mod:`tpu_compressed_dp.harness.loop`, plus
:func:`run_local_eval` for loaders that hand each process its own (possibly
empty) batches and :func:`local_device` for the entry points.  Train metrics
stay on the device until the epoch ends and come back in one copy.  Before
each dispatch :func:`run_train_epoch` runs the chaos crash check, then the
preemption check (a ``crash=preempt`` self-SIGTERM is seen in the same
iteration); an exception leaving the epoch carries the live state as
``err.train_state`` for the emergency save.
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
           "guard_summary", "pad_batch", "to_device", "local_device", "add_robustness_args",
           "add_checkpoint_args", "build_robustness", "make_heartbeat", "make_preemption",
           "preempt_exit"]


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


def add_robustness_args(p, *, check_note: str) -> None:
    """The ``--guard*`` / ``--chaos`` / ``--heartbeat*`` flags (the JAX
    surface without the elastic runtime's flags); ``check_note`` names the
    harness's wedge-check cadence."""
    p.add_argument("--guard", action="store_true",
                   help="arm the step guard: a cross-worker finiteness vote skips nonfinite "
                        "steps and holds params/momentum/BN/EF/comp bitwise, with dynamic loss "
                        "scaling on 16-bit dtypes (train/guard.py)")
    p.add_argument("--guard_init_scale", type=float, default=2.0 ** 15)
    p.add_argument("--guard_backoff", type=float, default=0.5)
    p.add_argument("--guard_growth_interval", type=int, default=200)
    p.add_argument("--guard_max_skips", type=int, default=25,
                   help=f"raise GuardExceeded past this many CONSECUTIVE skipped steps "
                        f"({check_note})")
    p.add_argument("--chaos", type=str, default=None,
                   help="deterministic fault injection, e.g. 'nan,target=grads,steps=3+7,"
                        "worker=1', 'crash=120' or 'crash=preempt,crash_at_step=12' "
                        "(utils/chaos.py; in-step injection arms --guard)")
    p.add_argument("--heartbeat", type=str, default=None,
                   help="liveness JSON path (utils/resilience.Heartbeat); the payload "
                        "carries step and last_good_step")
    p.add_argument("--heartbeat_interval", type=float, default=10.0)


def add_checkpoint_args(p, *, cadence_help: str) -> None:
    """The ``--checkpoint_dir`` / ``--resume`` / ``--ckpt_every`` flags."""
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="checkpoint directory (async saves, checksummed manifests, "
                        "preemption emergency saves; utils/checkpoint.py)")
    p.add_argument("--resume", type=str, default=None,
                   help="restore the newest verifiable checkpoint from this directory "
                        "before training")
    p.add_argument("--ckpt_every", type=int, default=1, help=cadence_help)


def build_robustness(args, dtype):
    """``(guard_cfg, chaos, crash_injector)`` from the flags.  In-step chaos
    injection arms the guard; loss scaling follows ``dtype``
    (``GuardConfig.for_dtype``).  The elastic runtime's chaos modes raise."""
    from tpu_compressed_dp_torch.train.guard import GuardConfig
    from tpu_compressed_dp_torch.utils.chaos import ChaosConfig, maybe_crash_injector

    chaos = ChaosConfig.parse(args.chaos) if args.chaos else None
    if chaos is not None:
        chaos.check_ported()
    want_guard = args.guard or (chaos is not None and chaos.injects_in_graph)
    if want_guard and not args.guard and mesh.rank() == 0:
        print("chaos: in-step injection requested — arming the step guard")
    guard_cfg = GuardConfig.for_dtype(
        dtype, init_scale=args.guard_init_scale, backoff=args.guard_backoff,
        growth_interval=args.guard_growth_interval,
        max_consecutive_skips=args.guard_max_skips) if want_guard else None
    return guard_cfg, chaos, maybe_crash_injector(chaos)


def make_heartbeat(args):
    """A started :class:`~tpu_compressed_dp_torch.utils.resilience.Heartbeat`
    for ``--heartbeat`` (its payload names the rank), or None.  Each rank of
    a multi-process run writes ``<path>.rank<r>``."""
    if not args.heartbeat:
        return None
    from tpu_compressed_dp_torch.utils.resilience import Heartbeat

    path = args.heartbeat if mesh.world() == 1 else f"{args.heartbeat}.rank{mesh.rank()}"
    return Heartbeat(path, interval_s=args.heartbeat_interval, payload={"rank": mesh.rank()})


def make_preemption(log=print):
    """The installed SIGTERM/SIGINT flag; pair with ``uninstall()`` in a
    finally."""
    from tpu_compressed_dp_torch.utils.resilience import PreemptionHandler

    return PreemptionHandler(log=log).install()


def preempt_exit(err, *, ckpt=None, state=None, meta=None, log=print):
    """The preemption epilogue: drain any write in flight (its failure is
    superseded), cut a synchronous emergency checkpoint, and return the
    ``SystemExit`` of :data:`~tpu_compressed_dp_torch.utils.resilience.
    PREEMPT_EXIT` for the caller to raise."""
    from tpu_compressed_dp_torch.utils.resilience import PREEMPT_EXIT

    saved = None
    if ckpt is not None and state is not None:
        try:
            ckpt.drain(raise_error=False)
            saved = ckpt.save(state, {**(meta or {}), "emergency": True})
        except Exception as save_err:
            log(f"preempt: emergency checkpoint FAILED: {save_err!r}")
    log("preempt: "
        + (f"emergency checkpoint committed at step {saved}" if saved is not None
           else "no checkpoint directory — progress since the last save is lost")
        + f"; exiting {PREEMPT_EXIT} for immediate relaunch")
    return SystemExit(PREEMPT_EXIT)


def guard_summary(acc: MetricAccumulator) -> Dict[str, float]:
    """The epoch's guard columns: 'skipped' (the cumulative count at the
    epoch's end) and 'loss scale'.  Empty when the guard is off."""
    if "guard/nonfinite" not in acc.sums:
        return {}
    return {"skipped": acc.last.get("guard/skipped", 0.0),
            "loss scale": acc.last.get("guard/loss_scale", 1.0)}


def run_train_epoch(train_step, state: TrainState, batches: Iterable[Dict], device, *,
                    crash=None, step_offset: int = 0, guard_cfg=None, preempt=None
                    ) -> Tuple[TrainState, MetricAccumulator]:
    """One epoch's steps.  ``crash`` (``utils/chaos.CrashInjector``) and
    ``preempt`` (``utils/resilience.PreemptionHandler``) are checked before
    each dispatch at the attempted step ``step_offset + i``; ``guard_cfg``
    runs the wedge check on the epoch's last metrics."""
    step_metrics = []
    try:
        for i, batch in enumerate(batches):
            if crash is not None:
                crash.check(step_offset + i)
            if preempt is not None:
                preempt.check(step_offset + i)
            state, metrics = train_step(state, to_device(batch, device))
            step_metrics.append(metrics)
    except Exception as err:
        # the steps so far replaced the caller's state: ride the live one out
        # for the emergency save
        err.train_state = state
        raise
    acc = MetricAccumulator()
    if step_metrics:
        keys = [k for k, v in step_metrics[0].items() if isinstance(v, torch.Tensor)]
        fetched = torch.stack([torch.stack([m[k] for k in keys])
                               for m in step_metrics]).cpu().numpy()
        for row, m in zip(fetched, step_metrics):
            host = dict(zip(keys, row.tolist()))
            host.update({k: v for k, v in m.items() if not isinstance(v, torch.Tensor)})
            acc.update(host)
    if guard_cfg is not None and step_metrics:
        from tpu_compressed_dp_torch.train.guard import check_guard_metrics

        check_guard_metrics(acc.last, guard_cfg)
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
                timer: Timer, batch_size: int, device, rank: int = 0, world: int = 1, *,
                crash=None, step_offset: int = 0, guard_cfg=None, preempt=None
                ) -> Tuple[TrainState, Dict[str, float], MetricAccumulator]:
    """One train + eval pass with the reference's epoch-summary shape
    (`core.py:324-331`); ``crash`` / ``step_offset`` / ``guard_cfg`` /
    ``preempt`` pass through to :func:`run_train_epoch`."""
    state, train_acc = run_train_epoch(train_step, state, train_batches, device, crash=crash,
                                       step_offset=step_offset, guard_cfg=guard_cfg,
                                       preempt=preempt)
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
    summary.update(guard_summary(train_acc))
    return state, summary, train_acc
