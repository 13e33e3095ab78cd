"""Epoch loops and the robustness surface shared by the harnesses.

PyTorch-port counterpart of ``run_train_epoch``, ``run_eval``,
``train_epoch``, ``comm_summary``, ``guard_summary``, ``pad_batch`` and the
robustness helpers (``add_robustness_args``, ``add_checkpoint_args``,
``build_robustness``, ``build_elastic``, ``elastic_distributed_init``,
``make_heartbeat``, ``make_preemption``, ``preempt_exit``) of
:mod:`tpu_compressed_dp.harness.loop`, plus :func:`run_local_eval` for
loaders that hand each process its own (possibly empty) batches,
:func:`local_device` for the entry points and :func:`add_process_args` for
the process flags.  Train metrics stay on the device until the epoch ends
and come back in one copy (under ``--elastic`` with the peer-timeout
deadline).  Before each dispatch :func:`run_train_epoch` runs the chaos
crash check, then the preemption check (a ``crash=preempt`` self-SIGTERM
is seen in the same iteration), then the elastic gossip poll; right after
the dispatch, the ``mid_collective`` crash check.  An exception leaving the
epoch carries the live state as ``err.train_state`` for the emergency save
and the elastic remesh.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.utils.loggers import MetricAccumulator
from tpu_compressed_dp_torch.utils.timer import Timer

__all__ = ["run_train_epoch", "run_eval", "run_local_eval", "train_epoch", "comm_summary",
           "guard_summary", "pad_batch", "to_device", "local_device", "add_robustness_args",
           "add_checkpoint_args", "add_process_args", "build_robustness", "build_elastic",
           "elastic_distributed_init", "Launch", "launch_rank_world", "make_heartbeat",
           "make_preemption", "preempt_exit"]


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
    """The ``--guard*`` / ``--chaos`` / ``--heartbeat*`` / ``--elastic*``
    flags (the JAX surface); ``check_note`` names the harness's wedge-check
    cadence."""
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
                        "worker=1', 'crash=120', 'crash=preempt,crash_at_step=12' or "
                        "'crash=mid_collective,crash_at_step=3,worker=1' (utils/chaos.py; "
                        "in-step injection arms --guard)")
    p.add_argument("--heartbeat", type=str, default=None,
                   help="liveness JSON path (utils/resilience.Heartbeat); the payload "
                        "carries step and last_good_step")
    p.add_argument("--heartbeat_interval", type=float, default=10.0)
    p.add_argument("--elastic", action="store_true",
                   help="survive a dead worker without a whole-job restart: detect (heartbeat "
                        "gossip, collective errors, bounded fetches), agree a W-1 world "
                        "through --elastic_dir, re-initialise the process group over it and "
                        "replay the epoch; readmit relaunched workers at epoch boundaries "
                        "(train/elastic.py)")
    p.add_argument("--elastic_dir", type=str, default=None,
                   help="shared directory of the per-rank heartbeat gossip and the "
                        "rendezvous records (needed with more than one process)")
    p.add_argument("--peer_timeout", type=float, default=60.0,
                   help="seconds without a fresh peer heartbeat (or a blocked collective or "
                        "metrics fetch) before declaring the peer dead; --chaos "
                        "peer_timeout=<s> overrides")
    p.add_argument("--elastic_ef", type=str, default="drop", choices=("fold", "drop"),
                   help="the departing worker's EF residual: a dead process's EF is lost "
                        "with it, so every remesh drops it; fold is refused")
    p.add_argument("--elastic_min_world", type=int, default=2,
                   help="refuse to remesh below this many workers")


def add_process_args(p) -> None:
    """The process flags: the JAX ``--devices --coordinator --num_processes
    --process_id`` (here ``init_process_group``'s ``init_method``,
    ``world_size`` and ``rank``) and the port's ``--dist_backend``."""
    p.add_argument("--devices", type=int, default=None,
                   help="the world's workers; the port's workers are processes with one "
                        "device each, so this must equal the process group's size")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of the process group's rendezvous (rank 0 listens)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", type=str, default=None, choices=("nccl", "gloo"),
                   help="torch.distributed backend (default: NCCL on CUDA, gloo on the CPU; "
                        "gloo puts several ranks on one card)")


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
    (``GuardConfig.for_dtype``)."""
    from tpu_compressed_dp_torch.train.guard import GuardConfig
    from tpu_compressed_dp_torch.utils.chaos import ChaosConfig, maybe_crash_injector

    chaos = ChaosConfig.parse(args.chaos) if args.chaos else None
    want_guard = args.guard or (chaos is not None and chaos.injects_in_graph)
    if want_guard and not args.guard and mesh.rank() == 0:
        print("chaos: in-step injection requested — arming the step guard")
    guard_cfg = GuardConfig.for_dtype(
        dtype, init_scale=args.guard_init_scale, backoff=args.guard_backoff,
        growth_interval=args.guard_growth_interval,
        max_consecutive_skips=args.guard_max_skips) if want_guard else None
    return guard_cfg, chaos, maybe_crash_injector(chaos)


@dataclasses.dataclass(frozen=True)
class Launch:
    """How this process entered its world: ``rank`` its ORIGINAL launch rank
    (the gossip's and the rendezvous' key), ``base_port`` the port the
    rendezvous counts epochs up from, ``decision`` the rendezvous epoch it
    joined (a watchdog-relaunched worker) or None, ``made_group`` whether
    this call made the process group."""

    rank: int
    base_port: Optional[int]
    decision: object = None
    made_group: bool = False


def peer_timeout(args, chaos=None) -> float:
    """``--peer_timeout``, or ``--chaos peer_timeout=<s>`` where set."""
    if chaos is not None and chaos.peer_timeout > 0:
        return float(chaos.peer_timeout)
    return float(getattr(args, "peer_timeout", 60.0))


def elastic_distributed_init(args, device) -> Launch:
    """Make this process's group, replacing the bare ``init_process_group``.

    A worker relaunched by ``harness/watchdog.py --relaunch --elastic_dir``
    carries the running world's epoch in its environment
    (``TCDP_RENDEZVOUS_EPOCH``): under ``--elastic`` it parks in the
    rendezvous join barrier until the survivors commit an epoch that
    readmits it, then joins that world (the harness hands
    :attr:`Launch.decision` to ``ElasticRuntime.join_world``).  Otherwise
    ``--coordinator/--num_processes/--process_id`` (``tcp://`` init), the
    ``torchrun`` environment, or a 1-rank group.  Under ``--elastic`` the
    group's collective timeout is the peer timeout.  ``--devices`` must
    equal the world.  A blown join deadline raises: the process exits
    nonzero and the watchdog's backoff is the park-and-retry loop."""
    import torch.distributed as dist

    from tpu_compressed_dp_torch.utils.chaos import ChaosConfig

    elastic = getattr(args, "elastic", False)
    chaos = ChaosConfig.parse(args.chaos) if getattr(args, "chaos", None) else None
    timeout = peer_timeout(args, chaos) if elastic else None
    rank, _ = launch_rank_world(args)
    backend = getattr(args, "dist_backend", None)
    made = not dist.is_initialized()
    decision = None
    base_port = None
    if elastic:
        from tpu_compressed_dp_torch.train.rendezvous import maybe_rejoin_from_env

        decision = maybe_rejoin_from_env(args.elastic_dir, rank, deadline_s=4 * timeout)
    if decision is not None:
        base_port = int(decision.address.rsplit(":", 1)[1]) - int(decision.epoch)
        mesh.destroy()
        mesh.init_process_group(device, backend=backend,
                                init_method=f"tcp://{decision.address}",
                                world_size=decision.num_processes, rank=decision.process_id,
                                timeout_s=timeout)
        made = True
    else:
        init = f"tcp://{args.coordinator}" if getattr(args, "coordinator", None) else None
        mesh.init_process_group(device, backend=backend, init_method=init,
                                world_size=getattr(args, "num_processes", None),
                                rank=getattr(args, "process_id", None) if init else None,
                                timeout_s=timeout)
        base_port = mesh.port_of(init)
        rank = mesh.rank()
    devices = getattr(args, "devices", None)
    if devices is not None and int(devices) != mesh.world():
        raise ValueError(f"--devices {devices}: the port's workers are processes with one "
                         f"device each (launch them with torchrun --nproc_per_node, or "
                         f"--coordinator/--num_processes/--process_id), and this world has "
                         f"{mesh.world()}")
    return Launch(rank=rank, base_port=base_port, decision=decision, made_group=made)


def build_elastic(args, launch: Launch, *, chaos=None, crash=None, device=None, ckpt=None,
                  ckpt_layout=None, log=print):
    """The ``--elastic*`` flags as a started
    :class:`~tpu_compressed_dp_torch.train.elastic.ElasticRuntime` (or None
    without ``--elastic``).  ``--elastic_dir`` arms the gossip and the
    rendezvous (needed with more than one process: every remesh goes
    through a committed epoch); the chaos-conversion and bounded-fetch
    planes are always on; ``crash`` lets the runtime probe the
    ``during_remesh`` phase.  ``--elastic_ef fold`` raises: a dead
    process's EF cannot be folded.  A relaunched worker's runtime starts in the
    world it joined (``launch.decision``)."""
    if not getattr(args, "elastic", False):
        return None
    from tpu_compressed_dp_torch.train.elastic import ElasticConfig, ElasticRuntime, PeerGossip
    from tpu_compressed_dp_torch.train.rendezvous import DEFAULT_BASE_PORT, Rendezvous

    world = mesh.world()
    if world > 1 and not args.elastic_dir:
        raise ValueError("--elastic over several processes needs --elastic_dir: the "
                         "survivors agree their new world through its rendezvous files")
    if args.elastic_ef != "drop":
        raise ValueError("--elastic_ef fold: a dead worker's EF residual lived only in its "
                         "process and is lost with it, so every remesh drops it (the JAX "
                         "runtime's multi-process rule); use --elastic_ef drop")
    cfg = ElasticConfig(gossip_dir=args.elastic_dir, rank=launch.rank,
                        peer_timeout_s=peer_timeout(args, chaos),
                        min_world=args.elastic_min_world)
    ranks = (tuple(launch.decision.ranks) if launch.decision is not None
             else tuple(range(world)))
    if launch.decision is None and launch.rank != mesh.rank():
        raise ValueError(f"--process_id {launch.rank} is not this process's rank "
                         f"{mesh.rank()} in its group")
    gossip = rendezvous = None
    if cfg.gossip_dir:
        gossip = PeerGossip(cfg.gossip_dir, cfg.rank, max(max(ranks) + 1, world),
                            peer_timeout_s=cfg.peer_timeout_s)
        rendezvous = Rendezvous(cfg.gossip_dir, cfg.rank,
                                base_port=launch.base_port or DEFAULT_BASE_PORT)
    return ElasticRuntime(cfg, gossip=gossip, crash=crash, rendezvous=rendezvous,
                          ranks=ranks, device=device, ckpt=ckpt, ckpt_layout=ckpt_layout,
                          log=log)


def launch_rank_world(args) -> Tuple[int, int]:
    """This process's launch rank and world from the process group, else the
    flags (``--process_id`` / ``--num_processes``), else the ``torchrun``
    environment: known before the group is made."""
    import torch.distributed as dist

    if dist.is_initialized():
        return mesh.rank(), mesh.world()
    rank = getattr(args, "process_id", None)
    world = getattr(args, "num_processes", None)
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world = int(os.environ.get("WORLD_SIZE", 1)) if world is None else int(world)
    return rank, world


def make_heartbeat(args):
    """A started :class:`~tpu_compressed_dp_torch.utils.resilience.Heartbeat`
    for ``--heartbeat`` (its payload names the rank), or None.  Each rank of
    a multi-process or ``--elastic`` run writes ``<path>.rank<r>``, ``r``
    its launch rank, which a remesh never renumbers.  The entry points start
    it before they make the process group, so a relaunched worker parked in
    the elastic join barrier reads as alive to the watchdog."""
    if not args.heartbeat:
        return None
    from tpu_compressed_dp_torch.utils.resilience import Heartbeat

    rank, world = launch_rank_world(args)
    multi = world > 1 or getattr(args, "elastic", False)
    path = f"{args.heartbeat}.rank{rank}" if multi else args.heartbeat
    return Heartbeat(path, interval_s=args.heartbeat_interval, payload={"rank": rank})


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
                    crash=None, step_offset: int = 0, guard_cfg=None, preempt=None,
                    elastic=None) -> Tuple[TrainState, MetricAccumulator]:
    """One epoch's steps.  ``crash`` (``utils/chaos.CrashInjector``) and
    ``preempt`` (``utils/resilience.PreemptionHandler``) are checked before
    each dispatch at the attempted step ``step_offset + i``, and ``crash``
    again right after it (phase ``mid_collective``); ``elastic``
    (``train/elastic.ElasticRuntime``) polls the gossip before each
    dispatch and bounds the epoch-end metrics fetch by the peer timeout;
    ``guard_cfg`` runs the wedge check on the epoch's last metrics."""
    step_metrics = []
    try:
        for i, batch in enumerate(batches):
            if crash is not None:
                crash.check(step_offset + i)
            if preempt is not None:
                preempt.check(step_offset + i)
            if elastic is not None:
                elastic.poll(step_offset + i)
            state, metrics = train_step(state, to_device(batch, device))
            if crash is not None:
                crash.check(step_offset + i, phase="mid_collective")
            step_metrics.append(metrics)
    except Exception as err:
        # the steps so far replaced the caller's state: ride the live one out
        # for the emergency save and the elastic remesh
        err.train_state = state
        raise
    acc = MetricAccumulator()
    if step_metrics:
        keys = [k for k, v in step_metrics[0].items() if isinstance(v, torch.Tensor)]

        def fetch():
            return torch.stack([torch.stack([m[k] for k in keys])
                                for m in step_metrics]).cpu().numpy()

        try:
            fetched = (fetch() if elastic is None else
                       elastic.bounded_get(fetch, step=step_offset + len(step_metrics)))
        except Exception as err:
            err.train_state = state
            raise
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
                crash=None, step_offset: int = 0, guard_cfg=None, preempt=None, elastic=None
                ) -> Tuple[TrainState, Dict[str, float], MetricAccumulator]:
    """One train + eval pass with the reference's epoch-summary shape
    (`core.py:324-331`); ``crash`` / ``step_offset`` / ``guard_cfg`` /
    ``preempt`` / ``elastic`` pass through to :func:`run_train_epoch`.  A
    failure in the eval carries the trained state as ``err.train_state``."""
    state, train_acc = run_train_epoch(train_step, state, train_batches, device, crash=crash,
                                       step_offset=step_offset, guard_cfg=guard_cfg,
                                       preempt=preempt, elastic=elastic)
    train_time = timer()
    try:
        test_stats = run_eval(eval_step, state, test_batches, batch_size, device, rank, world)
    except Exception as err:
        err.train_state = state
        raise
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
