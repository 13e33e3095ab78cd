"""ImageNet ResNet harness on PyTorch: the paper's ImageNet experiment with
compressed DP SGD.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.harness.imagenet` (the
reference's ``IMAGENET/training/train_imagenet_nv.py``):

  * the phase-schedule mini-DSL mixing data phases (``ep/sz/bs/min_scale/
    rect_val/keep_dl``) and LR phases (``ep/lr``, a value or a ramp), with
    the LR evaluated per batch; the default schedule is the reference's
    one-machine recipe (``bs`` global, over 8 GPUs there);
  * progressive resizing: the loaders are rebuilt at each data phase's
    first epoch (``PhaseData``), rect val included;
  * bf16 compute with fp32 master parameters (``--fp32`` turns it off),
    ``--init_bn0``, ``--no_bn_wd``;
  * the whole compression surface of the port (every method, granularity,
    mode and transport, EF, ``--overlap``), gradients at mean-loss scale
    (``grad_scale = 1``, as the reference backpropagates the mean loss);
  * validation every epoch with world top-1 / top-5 sums, every process
    running the same number of (possibly empty, padded) batches;
  * ``--short_epoch`` (10 batches) and ``--evaluate`` (validation only);
  * the robustness flags, ``--elastic*`` included (``train/elastic.py``):
    on a dead worker the survivors re-form the world, re-divide the loaders
    (``bs // world`` each) and replay the epoch; relaunched workers are
    readmitted at epoch boundaries;
  * the telemetry flags (``--events``, ``--prom``, ``--job_id``,
    ``--flight_dir``, ``--tensorboard``, ``--profile_epoch``) and the
    compression controller (``--adaptive*``, ticking once an epoch on the
    applied updates, before the epoch's best-checkpoint save, and pricing
    the DCN-billed bits at ``--dp_pods > 1``);
  * the delta stream (``--stream_dir --stream_every --stream_keyframe_every
    --stream_ratio --stream_rejoin``, ``stream/``): rank 0 appends a segment
    after each ``--stream_every`` epochs, after the epoch's readmission
    barrier; a worker relaunched with ``--stream_rejoin`` adopts the
    parameters from the stream when the survivors commit a warm
    readmission.

One process is one worker (``torchrun`` for several, or ``--coordinator
--num_processes --process_id``); batches are split by process (``bs //
world`` each).  Runs on CUDA unless ``--device cpu``.  Every flag of the
JAX harness is carried (``--adaptive_model twin`` fits the digital twin
from ``--twin_records``).

Run: ``python -m tpu_compressed_dp_torch.harness.imagenet --synthetic``
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import torch

from tpu_compressed_dp_torch.data import imagenet as data
from tpu_compressed_dp_torch.control import (Controller, comp_for_rung, init_control_state,
                                             migrate_comp_state)
from tpu_compressed_dp_torch.control.signals import billed_signal_bits
from tpu_compressed_dp_torch.harness.loop import (Telemetry, add_adaptive_args,
                                                  add_process_args, add_robustness_args,
                                                  add_stream_args, add_telemetry_args,
                                                  build_control, build_elastic,
                                                  build_robustness, build_twin_pricer,
                                                  comm_summary,
                                                  control_summary, control_tick,
                                                  elastic_distributed_init, fabric_gauges,
                                                  guard_summary, hideable_fraction,
                                                  local_device, make_heartbeat,
                                                  make_preemption, make_stream, preempt_exit,
                                                  profile_trace, run_local_eval,
                                                  run_train_epoch, stream_rejoin_params)
from tpu_compressed_dp_torch.models import resnet as resnet_mod
from tpu_compressed_dp_torch.models.common import make_normalizing_apply_fn, param_leaves
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.parallel.dp import (CompressionConfig, init_comp_state,
                                                 init_ef_state)
from tpu_compressed_dp_torch.train.guard import init_guard_state
from tpu_compressed_dp_torch.train.optim import SGD, bn_wd_mask
from tpu_compressed_dp_torch.train.schedules import phase_lr_schedule_variable_bs
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.train.step import make_eval_step, make_train_step
from tpu_compressed_dp_torch.utils import flops as flops_mod
from tpu_compressed_dp_torch.utils import resilience
from tpu_compressed_dp_torch.utils.checkpoint import Checkpointer
from tpu_compressed_dp_torch.utils.loggers import FileLogger, TableLogger, TSVLogger
from tpu_compressed_dp_torch.utils.meters import per_chip_comm_bytes
from tpu_compressed_dp_torch.utils.timer import Timer, device_sync

__all__ = ["ARCHS", "one_machine_phases", "smoke_phases", "data_phases", "total_epochs",
           "PhaseData", "build_parser", "parse_args", "run", "main"]

ARCHS = {
    "resnet18": resnet_mod.resnet18,
    "resnet34": resnet_mod.resnet34,
    "resnet50": resnet_mod.resnet50,
    "resnet101": resnet_mod.resnet101,
    "resnet152": resnet_mod.resnet152,
}

def one_machine_phases() -> List[dict]:
    """The reference's single-machine schedule (93.00 top-5 in 109 min on 8
    V100s): 128 px / bs 512 -> 224 px / bs 224 -> 288 px / bs 128 per GPU,
    with warm-up and step decays.  ``bs`` here is the global batch (the
    reference's per-GPU batch x 8)."""
    lr = 1.0
    scale_224 = 224 / 512
    scale_288 = 128 / 512
    return [
        {"ep": 0, "sz": 128, "bs": 512 * 8},
        {"ep": (0, 5), "lr": (lr, lr * 2)},
        {"ep": 5, "lr": lr},
        {"ep": 14, "sz": 224, "bs": 224 * 8, "lr": lr * scale_224},
        {"ep": 16, "lr": lr / 10 * scale_224},
        {"ep": 27, "lr": lr / 100 * scale_224},
        {"ep": 32, "sz": 288, "bs": 128 * 8, "min_scale": 0.5, "rect_val": True,
         "lr": lr / 100 * scale_288},
        {"ep": (33, 35), "lr": lr / 1000 * scale_288},
    ]


def smoke_phases(bs: int = 64) -> List[dict]:
    """Tiny 3-epoch progressive-resize schedule for tests and CPU smoke."""
    return [
        {"ep": 0, "sz": 64, "bs": bs},
        {"ep": (0, 1), "lr": (0.1, 0.2)},
        {"ep": 1, "lr": 0.1},
        {"ep": 2, "sz": 96, "bs": bs // 2, "rect_val": True},
        {"ep": (2, 3), "lr": (0.01, 0.001)},
    ]


def data_phases(phases: List[dict]) -> List[dict]:
    return [p for p in phases if "sz" in p or p.get("keep_dl")]


def total_epochs(phases: List[dict]) -> int:
    """The largest epoch edge of the schedule (at least 1)."""
    out = 0
    for p in phases:
        ep = p["ep"]
        out = max(out, int(max(ep) if isinstance(ep, (tuple, list)) else ep))
    return out if out > 0 else 1


class PhaseData:
    """Owns the current train/val loaders and swaps them at the first epoch
    of each data phase; a ``keep_dl`` phase inherits its predecessor's
    settings."""

    def __init__(self, dataset_train, dataset_val, phases: List[dict], *, workers: int = 8,
                 seed: int = 0, min_scale_default: float = 0.08, ar_buckets: int = 8,
                 process_index: int = 0, process_count: int = 1):
        raw = data_phases(phases)
        if not raw or raw[0]["ep"] != 0:
            raise ValueError("first data phase must start at ep 0")
        self.phases: List[dict] = []
        for p in raw:
            merged = {**self.phases[-1], **p} if p.get("keep_dl") and self.phases else dict(p)
            self.phases.append(merged)
        self.ds_train, self.ds_val = dataset_train, dataset_val
        self.workers, self.seed = workers, seed
        self.min_scale_default = min_scale_default
        self.ar_buckets = ar_buckets
        self.pi, self.pc = process_index, process_count
        self.cur: Optional[dict] = None
        self.train_loader = None
        self.val_loader = None
        self.val_bs = None

    def phase_at(self, epoch: int) -> dict:
        """The phase governing ``epoch`` (the last one starting at or before it)."""
        out = self.phases[0]
        for p in self.phases:
            if p["ep"] <= epoch:
                out = p
        return out

    def set_epoch(self, epoch: int) -> bool:
        """Build the loaders of the phase governing ``epoch`` if it is not the
        current one; returns True on a swap."""
        phase = self.phase_at(epoch)
        swapped = False
        if phase is not self.cur:
            sz, bs = int(phase["sz"]), int(phase["bs"])
            self.train_loader = data.TrainLoader(
                self.ds_train, bs // self.pc, sz,
                min_scale=float(phase.get("min_scale", self.min_scale_default)),
                seed=self.seed, workers=self.workers, process_index=self.pi,
                process_count=self.pc)
            self.val_bs = data.val_batch_size(sz, bs)
            # as in the JAX harness, rect val runs single-process only
            rect = bool(phase.get("rect_val", False)) and self.pc == 1
            self.val_loader = data.ValLoader(
                self.ds_val, self.val_bs // self.pc, sz, rect_val=rect,
                ar_buckets=self.ar_buckets, workers=self.workers, process_index=self.pi,
                process_count=self.pc)
            self.cur = phase
            swapped = True
        self.train_loader.set_epoch(epoch)
        return swapped

    def epoch_batches(self, epochs: int) -> List[int]:
        """Steps per epoch, for the step -> epoch LR map."""
        out = []
        for e in range(epochs):
            bs = int(self.phase_at(e)["bs"]) // self.pc
            out.append(max((len(self.ds_train) // self.pc) // bs, 1))
        return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ImageNet compressed-DP harness (PyTorch)")
    p.add_argument("data", nargs="?", default=None,
                   help="ImageFolder root with train/ and validation/")
    p.add_argument("--arch", "-a", default="resnet50", choices=sorted(ARCHS))
    p.add_argument("--width", type=int, default=64, help="stem width (64 = standard)")
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--phases", type=str, default=None,
                   help="JSON phase list; default = the reference's one-machine schedule")
    p.add_argument("--lr_scale", type=float, default=1.0,
                   help="multiply every phase LR (batch-size scaling)")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", "--wd", type=float, default=1e-4)
    p.add_argument("--no_bn_wd", action="store_true", help="exclude BN params from wd")
    p.add_argument("--init_bn0", action="store_true", help="zero-init last-BN gammas")
    p.add_argument("--fp32", action="store_true", help="disable bf16 compute")
    p.add_argument("--compress", "-c", default="none",
                   choices=["none", "layerwise", "entiremodel", "bucketed"])
    p.add_argument("--method", default="none")
    p.add_argument("--ratio", "-K", type=float, default=0.5)
    p.add_argument("--threshold", "-V", type=float, default=0.001)
    p.add_argument("--qstates", "-Q", type=int, default=255)
    p.add_argument("--rank", type=int, default=4, help="r for powersgd")
    p.add_argument("--block_size", type=int, default=256,
                   help="blocktopk: elements per contiguous block")
    p.add_argument("--bucket_mb", type=float, default=25.0,
                   help="bucketed granularity: capacity per bucket")
    p.add_argument("--mode", default="simulate", choices=["simulate", "wire"])
    p.add_argument("--transport", default="allgather",
                   choices=["allgather", "sharded", "hierarchical"],
                   help="wire combine for index-carrying sparsifiers: flat all_gather, "
                        "owner-sharded reduce, or the two-level hierarchical reduce over "
                        "--dp_pods")
    p.add_argument("--dp_pods", type=int, default=1,
                   help="hierarchical transport: pod count (must divide the world size)")
    p.add_argument("--hier_route_factor_ici", type=float, default=1.25)
    p.add_argument("--hier_route_factor_dcn", type=float, default=1.25)
    p.add_argument("--error_feedback", action="store_true")
    p.add_argument("--overlap", type=int, default=1,
                   help="chunk-pipelined sync (parallel/overlap.py): up to K chunk syncs "
                        "started during the backward pass; numerics unchanged")
    p.add_argument("--wire_cap_ratio", type=float, default=0.05,
                   help="wire thresholdv/adaptive_threshold transport capacity")
    p.add_argument("--clip_norm", type=float, default=0.0,
                   help="local-gradient L2 clip (0 = off)")
    p.add_argument("--clip_sent_norm", type=float, default=0.0,
                   help="post-aggregation L2 clip of the synced gradient (0 = off)")
    p.add_argument("--workers", type=int, default=8, help="decode threads per loader")
    p.add_argument("--seed", type=int, default=2147483647)
    p.add_argument("--short_epoch", action="store_true", help="10-batch epochs")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_n", type=int, default=512)
    p.add_argument("--logdir", type=str, default=None)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--best_floor", type=float, default=0.0,
                   help="save_if_best floor on top-5 (the reference gated at 93)")
    add_adaptive_args(p)
    add_telemetry_args(p)
    p.add_argument("--tensorboard", action="store_true",
                   help="write tensorboard scalars under <logdir>/tb (needs the tensorboard "
                        "package)")
    p.add_argument("--profile_epoch", type=int, default=None,
                   help="torch.profiler-trace this epoch to <logdir>/profile/trace.json")
    add_robustness_args(p, check_note="checked at epoch end")
    add_stream_args(p, cadence_help="epochs between delta-stream appends (requires "
                                    "--stream_dir; 0 disables streaming)")
    add_process_args(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises where CUDA is missing) or cpu")
    return p


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def _truncate(it, n: Optional[int]):
    for i, b in enumerate(it):
        if n is not None and i >= n:
            break
        yield b


def comp_config(args) -> CompressionConfig:
    return CompressionConfig(
        method=None if args.compress == "none" or args.method.lower() == "none" else args.method,
        granularity=args.compress if args.compress != "none" else "layerwise",
        mode=args.mode, ratio=args.ratio, threshold=args.threshold, qstates=args.qstates,
        block_size=args.block_size, bucket_mb=args.bucket_mb,
        wire_cap_ratio=args.wire_cap_ratio, transport=args.transport, dp_pods=args.dp_pods,
        hier_route_factor_ici=args.hier_route_factor_ici,
        hier_route_factor_dcn=args.hier_route_factor_dcn, rank=args.rank,
        error_feedback=args.error_feedback, sync_overlap=args.overlap)


def run(args) -> Dict[str, float]:
    if args.method.lower() != "none" and args.compress == "none":
        raise ValueError(f"--method {args.method} requires --compress "
                         "layerwise|entiremodel|bucketed")
    device = local_device(args.device)
    # fp32 stays fp32, as in the JAX reference: no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    comp = comp_config(args)
    hb = make_heartbeat(args)
    try:
        launch = elastic_distributed_init(args, device)
        try:
            return _run(args, device, comp, launch, hb)
        finally:
            if launch.made_group:
                mesh.destroy()
    finally:
        if hb is not None:
            hb.stop()


def _run(args, device: torch.device, comp: CompressionConfig, launch, hb) -> Dict[str, float]:
    world, rank = mesh.world(), mesh.rank()
    if args.synthetic:
        ds_train = data.SyntheticImages(args.synthetic_n, args.num_classes, seed=0)
        ds_val = data.SyntheticImages(max(args.synthetic_n // 4, 64), args.num_classes, seed=7)
    else:
        if not args.data:
            raise ValueError("pass an ImageFolder root or --synthetic")
        ds_train = data.ImageFolder(f"{args.data}/train")
        ds_val = data.ImageFolder(f"{args.data}/validation")

    phases = json.loads(args.phases) if args.phases else (
        smoke_phases() if args.synthetic else one_machine_phases())
    if args.lr_scale != 1.0:
        for p in phases:
            if "lr" in p:
                lr = p["lr"]
                p["lr"] = (tuple(v * args.lr_scale for v in lr) if isinstance(lr, (tuple, list))
                           else lr * args.lr_scale)
    epochs = total_epochs(phases)
    pd = PhaseData(ds_train, ds_val, phases, workers=args.workers, seed=args.seed,
                   process_index=rank, process_count=world)
    epoch_batches = pd.epoch_batches(epochs)
    if args.short_epoch:
        epoch_batches = [min(n, 10) for n in epoch_batches]
    lr_sched = phase_lr_schedule_variable_bs(phases, epoch_batches)

    dtype = torch.float32 if args.fp32 else torch.bfloat16
    model = ARCHS[args.arch](num_classes=args.num_classes, bn0=args.init_bn0, dtype=dtype,
                             width=args.width, seed=args.seed % (2 ** 31), device=device)
    params = param_leaves(model)
    apply_fn = make_normalizing_apply_fn(data.IMAGENET_MEAN, data.IMAGENET_STD)
    opt = SGD(lr=lr_sched, momentum=args.momentum, nesterov=False,
              weight_decay=args.weight_decay,
              wd_mask=bn_wd_mask(params) if args.no_bn_wd else None)
    guard_cfg, chaos, crash = build_robustness(args, dtype)
    ctrl_cfg = build_control(args, comp)
    state = TrainState.create(model, opt.init(params), init_ef_state(params, comp),
                              seed=(args.seed + 1) % (2 ** 31),
                              comp=init_comp_state(params, comp),
                              guard=init_guard_state(guard_cfg),
                              control=init_control_state(ctrl_cfg))
    step_cache: dict = {}

    def train_step_for(state: TrainState):
        # the controller's checkpointed rung picks the sync (one built step
        # per visited rung), the static config otherwise
        comp_cfg = (comp_for_rung(comp, ctrl_cfg, int(state.control.rung))
                    if ctrl_cfg is not None else comp)
        key = (comp_cfg.ratio, comp_cfg.rank)
        if key not in step_cache:
            step_cache[key] = make_train_step(apply_fn, opt, comp_cfg, grad_scale=1.0,
                                              clip_norm=args.clip_norm,
                                              clip_sent_norm=args.clip_sent_norm,
                                              guard_cfg=guard_cfg, chaos=chaos)
        return step_cache[key]

    # a joining worker takes the survivors' checkpoint sequence when it joins
    ckpt = (Checkpointer(args.checkpoint_dir, token="joining" if launch.decision else None)
            if args.checkpoint_dir else None)
    start_epoch = 0
    if args.resume:
        restorer = Checkpointer(args.resume)
        try:
            state, meta = restorer.restore(state)
        finally:
            restorer.close()
        start_epoch = int(meta.get("epoch", 0)) + 1
        if ckpt is not None and restorer.best_metric is not None:
            # carry best-so-far forward, so a worse epoch cannot evict the
            # true best (`train_imagenet_nv.py:195-197`)
            ckpt.best_metric = restorer.best_metric
        if rank == 0:
            print(f"resumed step {state.step} (epoch {start_epoch})")
    eval_step = make_eval_step(apply_fn)
    tel = Telemetry(args, harness="imagenet", log_dir=args.logdir, chaos=chaos, crash=crash,
                    ckpt=ckpt,
                    meta=dict(arch=args.arch, method=args.method, compress=args.compress,
                              mode=args.mode, transport=args.transport, devices=world,
                              epochs=epochs),
                    flight_meta=dict(arch=args.arch, method=args.method,
                                     compress=args.compress, devices=world))
    stream = make_stream(args, flight=tel.flight, events=tel.events)
    if ckpt is not None:
        # committed checkpoints re-anchor the delta stream's window
        ckpt.stream = stream
    el = build_elastic(args, launch, chaos=chaos, crash=crash, device=device, ckpt=ckpt,
                       events=tel.events, flight=tel.flight, stream=stream)
    cur = {"rank": rank, "world": world}

    def follow_world() -> None:
        """Re-divide the loaders (``PhaseData`` rebuilds them for the new
        world at the next ``set_epoch``) and rebuild the steps."""
        nonlocal eval_step
        cur.update(rank=el.rank, world=el.world)
        pd.pi, pd.pc, pd.cur = el.rank, el.world, None
        fwd_cache.clear()
        step_cache.clear()
        eval_step = make_eval_step(apply_fn)

    fwd_cache: Dict[tuple, float] = {}
    if el is not None and launch.decision is not None:
        # a watchdog-relaunched worker: the running world's replicated state
        # from its coordinator (EF starts at zero) and its next epoch; under
        # --stream_rejoin and a warm commit the parameters come off the stream
        adopted, adopted_info = stream_rejoin_params(args, state, launch.decision,
                                                     flight=tel.flight)
        state = el.join_world(state, launch.decision, adopted_params=adopted,
                              adopted_info=adopted_info)
        start_epoch = int(el.shared.get("next_epoch", start_epoch))
        follow_world()
    if rank == 0:
        n_params = sum(p.numel() for p in params.values())
        print(f"world: {world} x {device}; arch={args.arch} width={args.width} "
              f"params={n_params} dtype={dtype} compress={args.compress} "
              f"method={args.method} overlap={args.overlap} epochs={epochs}")

    def validate(state) -> Dict[str, float]:
        batches = _truncate(pd.val_loader, 10 if args.short_epoch else None)
        return run_local_eval(eval_step, state, batches, pd.val_loader.batch_size, device)

    controller, hide_frac = None, 1.0
    if ctrl_cfg is not None:
        controller = Controller(ctrl_cfg, events=tel.events,
                                pricer=build_twin_pricer(args, comp, world=cur["world"]))
        hide_frac = hideable_fraction(params, comp)
        if rank == 0:
            print(f"adaptive: method={ctrl_cfg.method} knob={controller.knob} "
                  f"rungs={ctrl_cfg.rungs} window={ctrl_cfg.window} "
                  f"signal={ctrl_cfg.signal} hideable_frac={hide_frac:.3f}")

    def fwd_flops(phase) -> Optional[float]:
        """The forward FLOPs of one local batch of the phase, where the card's
        peak is known (MFU needs it) or an exporter can use them."""
        if (flops_mod.device_peak_flops(device, dtype) is None and tel.events is None
                and not args.prom):
            return None
        key = (int(phase["sz"]), int(phase["bs"]) // cur["world"])
        if key not in fwd_cache:
            fwd_cache[key] = flops_mod.cnn_fwd_flops(model, (key[1], key[0], key[0], 3), device)
        return fwd_cache[key]

    table, tsv = TableLogger(), TSVLogger()
    timer = Timer(lambda: device_sync(device))
    t0 = time.time()
    flog = FileLogger(args.logdir if rank == 0 else None, rank=rank, is_master=rank == 0)
    summary: Dict[str, float] = {}
    if args.evaluate:
        pd.set_epoch(min(start_epoch, epochs - 1))
        val = validate(state)
        if rank == 0:
            print(f"top1 {val['acc'] * 100:.2f} top5 {val['acc5'] * 100:.2f}")
        if stream is not None:
            stream.close()
        tel.close()
        return val
    preempt = make_preemption()
    epoch = start_epoch
    el_replay = False
    try:
        while epoch < epochs:
            # a SIGTERM between epochs cuts the emergency save here
            preempt.check(state.step)
            swapped = pd.set_epoch(epoch)
            if swapped and ckpt is not None and epoch > 0 and not el_replay:
                # phase-boundary save (`train_imagenet_nv.py:251-253`)
                ckpt.save_async(state, {"epoch": epoch - 1, "phase_boundary": True})
            batches = _truncate(pd.train_loader, 10 if args.short_epoch else None)
            try:
                profiling = args.profile_epoch == epoch and args.logdir
                with profile_trace(os.path.join(args.logdir, "profile") if profiling
                                   else None):
                    state, acc = run_train_epoch(train_step_for(state), state, batches, device,
                                                 crash=crash, step_offset=state.step,
                                                 guard_cfg=guard_cfg, preempt=preempt,
                                                 elastic=el, timeline=tel.timeline,
                                                 flight=tel.flight)
                train_time = timer()
                val = validate(state)
            except Exception as err:
                failure = el.failure_from(err) if el is not None else None
                if failure is None or isinstance(err, resilience.Preempted):
                    tel.observe(err, getattr(err, "train_state", state).step)
                    raise
                # coordinated abort: the survivors move to the new world from
                # the last live state, re-divide the loaders and replay the
                # epoch from its first batch
                state = el.handle_failure(getattr(err, "train_state", state), failure)
                follow_world()
                el_replay = True
                continue
            el_replay = False
            timer(False)  # eval time stays out of the training total
            comm_means = {k: acc.mean(k) for k in acc.sums if k.startswith("comm/")}
            if controller is not None:
                # the tick lands before this epoch's best-checkpoint save and
                # the next phase-boundary save; at dp_pods > 1 the modeled
                # signal prices the DCN-billed share
                old_rung = int(state.control.rung)
                state = control_tick(controller, state, guard_cfg=guard_cfg,
                                     mean_bits=billed_signal_bits(comm_means, args.dp_pods),
                                     wall_ms=train_time * 1e3 / max(acc.steps, 1),
                                     hide_frac=hide_frac, flight=tel.flight,
                                     note={"epoch": epoch})
                new_rung = int(state.control.rung)
                if new_rung != old_rung and controller.knob == "rank":
                    state = dataclasses.replace(state, comp=migrate_comp_state(
                        state.comp, params, comp_for_rung(comp, ctrl_cfg, old_rung),
                        comp_for_rung(comp, ctrl_cfg, new_rung)))
            examples = int(acc.sums.get("count", 0.0))
            img_s = examples / train_time if train_time > 0 else 0.0
            thr = flops_mod.throughput_record(fwd_flops(pd.cur),
                                              acc.steps / max(train_time, 1e-9),
                                              examples_per_sec=img_s, device=device,
                                              dtype=dtype)
            top1, top5 = val["acc"] * 100, val["acc5"] * 100
            hours = (time.time() - t0) / 3600
            # `~~epoch\thours\ttop1\ttop5` event line (`train_imagenet_nv.py:232,243`)
            flog.event(f"~~{epoch}\t{hours:.5f}\t\t{top1:.3f}\t\t{top5:.3f}\n")
            summary = {
                "epoch": epoch, "train time": train_time, "train loss": acc.mean("loss"),
                "test loss": val["loss"], "top1": top1, "top5": top5,
                "test acc": val["acc"], "total time": timer.total_time,
                "img/s": round(img_s, 1), "steps": acc.steps,
            }
            if "throughput/mfu" in thr:
                summary["mfu"] = round(thr["throughput/mfu"], 4)
            summary.update(comm_summary(acc))
            summary.update(guard_summary(acc))
            summary.update(control_summary(controller, state.control))
            per_chip_b = per_chip_comm_bytes(comm_means, world, args.dp_pods)
            if per_chip_b is not None and train_time > 0:
                summary["comm MB/s"] = per_chip_b * acc.steps / train_time / 1e6
            if el is not None:
                summary["world"] = el.world
            if cur["rank"] == 0:
                table.append(summary)
                tsv.append(summary)
            fabric_g = fabric_gauges(comm_means, cur["world"], args.dp_pods, acc.steps,
                                     train_time)
            tel.window(
                "epoch", {"epoch": epoch, "step": state.step}, summary=summary,
                loss=summary["train loss"], thr=thr, comm=comm_means,
                guard={k: v for k, v in acc.last.items() if k.startswith("guard/")},
                control=controller.metrics(state.control) if controller is not None else {},
                prom_extra={**fabric_g, **(ckpt.metrics() if ckpt is not None else {}),
                            **(stream.metrics() if stream is not None else {}),
                            **(el.metrics() if el is not None else {})},
                hb=hb, hb_fields=dict(
                    step=state.step, epoch=epoch,
                    last_good_step=(int(state.guard.last_good_step)
                                    if guard_cfg is not None else state.step),
                    **(ckpt.heartbeat_fields() if ckpt is not None else {}),
                    **(stream.heartbeat_fields() if stream is not None else {}),
                    **({"elastic": el.metrics()} if el is not None else {}),
                    **(controller.heartbeat_fields(state.control)
                       if controller is not None else {})))
            if cur["rank"] == 0:
                # x-axis = cumulative examples (`logger.py:24-34`)
                tel.tb.update_examples_count(examples)
                tel.tb.log_scalar("losses/train_loss", acc.mean("loss"))
                tel.tb.log_scalar("losses/test_loss", val["loss"])
                tel.tb.log_scalar("losses/top1", top1)
                tel.tb.log_scalar("losses/top5", top5)
                tel.tb.log_scalar("times/epoch_seconds", train_time)
                for k, v in fabric_g.items():
                    tel.tb.log_scalar(k, v)
            if el is not None:
                # epoch-boundary readmission of relaunched workers parked in
                # the rendezvous join barrier; a joiner starts at the next epoch
                el.shared.update(next_epoch=epoch + 1)
                state, grew = el.rejoin_barrier(state)
                if grew:
                    follow_world()
            if (stream is not None and args.stream_every > 0
                    and (epoch + 1) % args.stream_every == 0):
                # delta segment: codec here, commit in the background
                stream.append_async(state.model, step=state.step)
            if ckpt is not None:
                ckpt.save_if_best(state, top5, floor=args.best_floor,
                                  meta={"epoch": epoch, "top1": top1, "top5": top5})
            epoch += 1
        if args.logdir and cur["rank"] == 0:
            tsv.save(args.logdir)
    except resilience.Preempted as err:
        # drain the write in flight, cut the emergency save, exit 75
        raise preempt_exit(err, ckpt=ckpt, state=getattr(err, "train_state", state),
                           meta={"epoch": epoch - 1}, events=tel.events,
                           flight=tel.flight) from None
    finally:
        preempt.uninstall()
        if el is not None:
            el.close()
        if ckpt is not None:
            ckpt.close()   # drains the background writer before the events close
        if stream is not None:
            stream.close()  # drains the in-flight segment commit
        tel.close()
    return summary


def main(argv: Optional[list] = None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
