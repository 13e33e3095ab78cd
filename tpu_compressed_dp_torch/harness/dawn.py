"""CIFAR-10 DAWNBench harness on PyTorch: the CIFAR nets with compressed DP SGD.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.harness.dawn`, cut to the
flags of the ported compressors: ``--network {resnet9,alexnet,alexnet_module,
vgg16,resnet9_graph,alexnet_graph} --channels_scale --dtype
{float32,bfloat16} --compress {layerwise,entiremodel,bucketed} --method
--ratio --threshold --qstates --rank --block_size --bucket_mb
--error_feedback --overlap --mode {simulate,wire}
--wire_cap_ratio --transport {allgather,sharded,hierarchical} --dp_pods
--hier_route_factor_ici --hier_route_factor_dcn --epochs --batch_size
--peak_lr --lr_schedule {dawn,step} --momentum --clip_norm --clip_sent_norm
--ratio_warmup_epochs --synthetic --synthetic_hard --synthetic_n --seed``,
the robustness flags ``--guard --guard_init_scale --guard_backoff
--guard_growth_interval --guard_max_skips --chaos --heartbeat
--heartbeat_interval --checkpoint_dir --resume --ckpt_every``, the elastic
flags ``--elastic --elastic_dir --elastic_ef --elastic_min_world
--peer_timeout``, the process flags ``--devices --coordinator
--num_processes --process_id`` (plus the port's ``--dist_backend``), the
telemetry flags ``--events --events_max_mb --prom --job_id --flight_dir
--flight_capacity --tensorboard --profile_epoch``, the controller's
``--adaptive --adaptive_window --adaptive_deadband --adaptive_rungs
--adaptive_budget_ms --adaptive_bw_mbps --adaptive_signal``, the delta
stream's ``--stream_dir --stream_every --stream_keyframe_every
--stream_ratio --stream_rejoin``, and ``--device``.  With ``--checkpoint_dir`` the epochs run under
``utils/resilience.run_with_recovery`` (a failure restores the newest
checkpoint and replays), each ``--ckpt_every`` epochs end in an
asynchronous save, and a SIGTERM/SIGINT cuts an emergency save and exits
75; ``--resume DIR`` starts from the epoch after the checkpoint's.  As in
the JAX harness the data stream restarts with the process, so a resume is
bitwise the uninterrupted run only where the data is the same.  With
``--elastic`` a dead worker (``train/elastic.py``) is answered in place:
the survivors agree a new world through ``--elastic_dir``, re-initialise the
process group over it, re-shard the data (each global batch trimmed to
``(bs // W) * W`` rows) and replay the epoch from its first batch; at each
epoch boundary, workers relaunched by ``harness/watchdog.py --relaunch
--elastic_dir`` are readmitted.  With ``--adaptive`` the controller
(``control/``) ticks once an epoch on the applied updates, before the
epoch's checkpoint, and a rung switch rebuilds the sync at the new ratio
(or rank) from the next epoch on, as ``--ratio_warmup_epochs`` does.  Each
epoch publishes an ``epoch`` record (``--events``), the Prometheus file,
the heartbeat's telemetry and the flight recorder's profile; a failure
leaves a blackbox bundle in ``--flight_dir`` (``harness/postmortem.py``);
``--profile_epoch N`` writes a ``torch.profiler`` trace of epoch N to
``<log_dir>/profile/trace.json``.  With ``--stream_dir`` rank 0 appends a
delta segment (``stream/``) after each ``--stream_every`` epochs, after the
epoch's checkpoint; a worker relaunched with ``--stream_rejoin`` adopts the
parameters from the stream when the survivors commit a warm readmission.
Protocol as in the JAX harness: ``PiecewiseLinear([0, 5, epochs], [0, peak,
0])`` (or the ``step`` shape) at fractional epochs divided by the batch
size, weight decay ``5e-4 * batch_size``, Nesterov when momentum > 0,
Crop/FlipLR/Cutout augmentation, gradients compressed at summed-loss scale
(``grad_scale = batch_size``).  ``--adaptive --adaptive_model twin``
prices the controller's billed bits through the digital twin fitted from
``--twin_records`` (``twin/``).  Every flag of the JAX harness is carried.

Runs on CUDA unless ``--device cpu``; one process is one worker (launch
several with ``torchrun``, e.g. ``torchrun --nproc_per_node 4 -m
tpu_compressed_dp_torch.harness.dawn --mode wire --transport hierarchical
--dp_pods 2 ...``; alone, it runs a 1-rank group).

Run: ``python -m tpu_compressed_dp_torch.harness.dawn --synthetic --epochs 2``
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from tpu_compressed_dp_torch.data import cifar10 as data
from tpu_compressed_dp_torch.harness.loop import (Telemetry, add_adaptive_args,
                                                  add_checkpoint_args, add_process_args,
                                                  add_robustness_args, add_stream_args,
                                                  add_telemetry_args, build_control,
                                                  build_elastic, build_robustness,
                                                  build_twin_pricer,
                                                  control_summary, control_tick,
                                                  elastic_distributed_init, hideable_fraction,
                                                  local_device, make_heartbeat,
                                                  make_preemption, make_stream, preempt_exit,
                                                  profile_trace, stream_rejoin_params,
                                                  train_epoch)
from tpu_compressed_dp_torch.models import alexnet as alexnet_mod
from tpu_compressed_dp_torch.models import graph as graph_mod
from tpu_compressed_dp_torch.models import resnet9 as resnet9_mod
from tpu_compressed_dp_torch.models import vgg as vgg_mod
from tpu_compressed_dp_torch.control import (Controller, comp_for_rung, init_control_state,
                                             migrate_comp_state)
from tpu_compressed_dp_torch.models.common import make_normalizing_apply_fn, param_leaves
from tpu_compressed_dp_torch.ops.compressors import canonical_name
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.parallel.dp import (CompressionConfig, init_comp_state,
                                                 init_ef_state)
from tpu_compressed_dp_torch.train.elastic import PeerFailed
from tpu_compressed_dp_torch.train.optim import SGD
from tpu_compressed_dp_torch.train.guard import init_guard_state
from tpu_compressed_dp_torch.train.rendezvous import RendezvousError
from tpu_compressed_dp_torch.train.schedules import lr_phases_to_knots, piecewise_linear
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.train.step import make_eval_step, make_train_step
from tpu_compressed_dp_torch.utils import flops as flops_mod
from tpu_compressed_dp_torch.utils import resilience
from tpu_compressed_dp_torch.utils.checkpoint import Checkpointer
from tpu_compressed_dp_torch.utils.loggers import TableLogger, TSVLogger
from tpu_compressed_dp_torch.utils.timer import Timer, device_sync

def _fixed_width(name: str, ctor, scale: float, dtype: torch.dtype, seed: int, device):
    # no width or dtype knob on these: refuse a non-default rather than
    # build full-width fp32 under another label (the JAX harness's rule)
    if scale != 1.0:
        raise ValueError(f"{name} does not support channels_scale")
    if dtype != torch.float32:
        raise ValueError(f"{name} does not support --dtype (fp32 only)")
    return ctor(seed=seed, device=device)


# --network -> (channels_scale, dtype, seed, device) -> module
MODELS = {
    "resnet9": lambda s, dtype, seed, device: resnet9_mod.ResNet9(
        channels=resnet9_mod.scaled_channels(s), seed=seed, device=device, dtype=dtype),
    "alexnet": lambda s, dtype, seed, device: resnet9_mod.AlexNetGraph(
        channels=resnet9_mod.alexnet_channels(s), seed=seed, device=device, dtype=dtype),
    "alexnet_module": lambda s, dtype, seed, device: _fixed_width(
        "alexnet_module", alexnet_mod.AlexNet, s, dtype, seed, device),
    "vgg16": lambda s, dtype, seed, device: _fixed_width(
        "vgg16", vgg_mod.vgg16, s, dtype, seed, device),
    "resnet9_graph": lambda s, dtype, seed, device: graph_mod.GraphNet(graph_mod.resnet9_spec(
        channels=resnet9_mod.scaled_channels(s), dtype=dtype, seed=seed, device=device)),
    "alexnet_graph": lambda s, dtype, seed, device: graph_mod.GraphNet(graph_mod.alexnet_spec(
        channels=resnet9_mod.alexnet_channels(s), dtype=dtype, seed=seed, device=device)),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def warmup_ratio_for_epoch(epoch: int, *, ratio: float, warmup_epochs: int, method) -> float:
    """DGC-style sparsity warm-up (the JAX harness's): the keep-ratio
    ``ratio^((epoch + 1) / warmup_epochs)`` over the first ``warmup_epochs``
    epochs, rounded to 2 significant digits, for Top-K, Random-K and
    Block-Top-K; ``ratio`` otherwise."""
    if (warmup_epochs <= 0 or epoch >= warmup_epochs or method is None
            or canonical_name(method) not in ("topk", "randomk", "blocktopk")):
        return ratio
    r = ratio ** ((epoch + 1) / warmup_epochs)
    digits = -int(math.floor(math.log10(abs(r)))) + 1
    return min(1.0, round(r, digits))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--log_dir", type=str, default=".")
    p.add_argument("--network", "-n", type=str, default="resnet9", choices=sorted(MODELS))
    p.add_argument("--compress", "-c", type=str, default="none",
                   choices=["none", "layerwise", "entiremodel", "bucketed"])
    p.add_argument("--method", type=str, default="none")
    p.add_argument("--ratio", "-K", type=float, default=0.5)
    p.add_argument("--threshold", "-V", type=float, default=0.001)
    p.add_argument("--qstates", "-Q", type=int, default=255)
    p.add_argument("--rank", type=int, default=4,
                   help="r for powersgd (per-group payload r * (m + n/m) fp32 words)")
    p.add_argument("--block_size", type=int, default=256,
                   help="blocktopk: elements per contiguous block")
    p.add_argument("--bucket_mb", type=float, default=25.0,
                   help="bucketed granularity: capacity per bucket")
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--clip_norm", type=float, default=0.0,
                   help="local-gradient L2 clip (mean-loss units; 0 = off)")
    p.add_argument("--clip_sent_norm", type=float, default=0.0,
                   help="post-aggregation L2 clip of the synced gradient (mean-loss "
                        "units; 0 = off)")
    p.add_argument("--ratio_warmup_epochs", type=int, default=0,
                   help="DGC-style sparsity warm-up: the keep-ratio decays geometrically to "
                        "--ratio over the first N epochs (topk/randomk/blocktopk)")
    p.add_argument("--lr_schedule", type=str, default="dawn", choices=["dawn", "step"],
                   help="'dawn' = the CIFAR triangle; 'step' = the reference's ImageNet "
                        "shape (warm-up to peak, flat, peak/10 at 60%%, peak/100 at 85%%)")
    p.add_argument("--mode", type=str, default="simulate", choices=["simulate", "wire"])
    p.add_argument("--wire_cap_ratio", type=float, default=0.05,
                   help="wire thresholdv/adaptivethreshold: payload capacity as a "
                        "fraction of each group")
    p.add_argument("--transport", default="allgather",
                   choices=["allgather", "sharded", "hierarchical"],
                   help="wire combine for index-carrying sparsifiers: flat all_gather "
                        "(O(W*k) per worker), owner-sharded reduce (O(k + n/W) per worker, "
                        "ops/wire_sharded.py; size caps via comm/shard_overflow), or the "
                        "two-level hierarchical reduce over a --dp_pods x chips view of the "
                        "world (O(k + n/W_pods) DCN bytes)")
    p.add_argument("--dp_pods", type=int, default=1,
                   help="hierarchical transport: pod count P of the dp_pods x dp_chips "
                        "view of the world (must divide the world size; 1 = flat)")
    p.add_argument("--hier_route_factor_ici", type=float, default=1.25,
                   help="hierarchical transport: intra-pod union capacity in units of k "
                        "(clips fold into EF)")
    p.add_argument("--hier_route_factor_dcn", type=float, default=1.25,
                   help="hierarchical transport: inter-pod bucket capacity in units of "
                        "slab/P (clips fold into EF)")
    p.add_argument("--error_feedback", action="store_true")
    p.add_argument("--overlap", type=int, default=1,
                   help="chunk-pipelined sync (parallel/overlap.py): up to K chunk syncs "
                        "started during the backward pass, each chunk's SGD slice applied "
                        "when it is reduced; numerics unchanged (1 = one sync after the "
                        "backward pass)")
    p.add_argument("--epochs", type=int, default=None, help="override the 24/40 rule")
    p.add_argument("--batch_size", type=int, default=512, help="global batch size")
    p.add_argument("--peak_lr", type=float, default=0.4)
    p.add_argument("--synthetic", action="store_true", help="synthetic data smoke run")
    p.add_argument("--synthetic_hard", action="store_true",
                   help="non-saturating synthetic benchmark (convergence sweeps)")
    p.add_argument("--synthetic_n", type=int, default=2048, help="synthetic train-set size")
    p.add_argument("--channels_scale", type=float, default=1.0,
                   help="width multiplier of the graph-family nets (1.0 = the published "
                        "widths)")
    p.add_argument("--dtype", type=str, default="float32", choices=sorted(DTYPES),
                   help="compute dtype of the graph-family nets (parameters stay fp32)")
    p.add_argument("--seed", type=int, default=0)
    add_adaptive_args(p)
    add_telemetry_args(p)
    p.add_argument("--tensorboard", action="store_true",
                   help="write tensorboard scalars under <log_dir>/tb (needs the tensorboard "
                        "package)")
    p.add_argument("--profile_epoch", type=int, default=None,
                   help="torch.profiler-trace this epoch to <log_dir>/profile/trace.json")
    add_robustness_args(p, check_note="checked at epoch end")
    add_checkpoint_args(p, cadence_help="epochs between asynchronous checkpoint saves "
                                        "(requires --checkpoint_dir; 0 = emergency saves only)")
    add_stream_args(p, cadence_help="epochs between delta-stream appends (requires "
                                    "--stream_dir; 0 disables streaming)")
    add_process_args(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises where CUDA is missing) or cpu")
    return p


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def default_epochs(method: str) -> int:
    # `dawn.py:105-108`
    return 40 if method.lower() in ("randomk", "thresholdv") else 24


def _check_slice(args) -> None:
    if args.method.lower() != "none" and args.compress == "none":
        raise ValueError(f"--method {args.method} requires --compress "
                         "layerwise|entiremodel|bucketed "
                         "(the reference silently trained dense here; we refuse instead)")
    if getattr(args, "adaptive", False) and args.ratio_warmup_epochs > 0:
        raise ValueError("--adaptive and --ratio_warmup_epochs both drive the keep-ratio; "
                         "pick one")


def comp_for_ratio(args, ratio: float) -> CompressionConfig:
    return CompressionConfig(
        method=None if args.compress == "none" or args.method.lower() == "none" else args.method,
        granularity=args.compress if args.compress != "none" else "layerwise",
        mode=args.mode,
        ratio=ratio,
        threshold=args.threshold,
        qstates=args.qstates,
        block_size=args.block_size,
        bucket_mb=args.bucket_mb,
        wire_cap_ratio=args.wire_cap_ratio,
        transport=args.transport,
        dp_pods=args.dp_pods,
        hier_route_factor_ici=args.hier_route_factor_ici,
        hier_route_factor_dcn=args.hier_route_factor_dcn,
        rank=args.rank,
        error_feedback=args.error_feedback,
        sync_overlap=args.overlap,
    )


def run(args) -> dict:
    _check_slice(args)
    device = local_device(args.device)
    # fp32 stays fp32, as in the JAX reference: no TF32 in convolutions or
    # the classifier matmul
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    comp = comp_for_ratio(args, args.ratio)
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


def _run(args, device: torch.device, comp: CompressionConfig, launch, hb) -> dict:
    world, rank = mesh.world(), mesh.rank()
    epochs = args.epochs if args.epochs is not None else default_epochs(args.method)
    bs = args.batch_size
    if bs % world and launch.decision is None:
        # a worker joining a running world takes its trimmed batch
        raise ValueError(f"batch_size {bs} not divisible by world size {world}")
    if rank == 0:
        print(f"world: {world} x {device}; network={args.network} dtype={args.dtype} "
              f"compress={args.compress} method={args.method} epochs={epochs}; "
              "cudnn.allow_tf32="
              f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
              f"{torch.backends.cuda.matmul.allow_tf32}")

    if args.synthetic_hard:
        dataset = data.synthetic_cifar10_hard(n_train=args.synthetic_n,
                                              n_test=max(args.synthetic_n // 4, bs))
    elif args.synthetic:
        dataset = data.synthetic_cifar10(n_train=args.synthetic_n,
                                         n_test=max(args.synthetic_n // 4, bs))
    else:
        dataset = data.load_cifar10(args.data_dir)
    train_x = data.pad(dataset["train"]["data"])
    test_x = dataset["test"]["data"]
    train_batches = data.Batches(
        train_x, dataset["train"]["labels"], bs, shuffle=True, augment=True,
        drop_last=True, seed=args.seed,
        shard=(rank, world) if world > 1 or args.elastic else None)
    test_batches = data.Batches(test_x, dataset["test"]["labels"], bs,
                                shuffle=False, augment=False, drop_last=False)

    model = MODELS[args.network](args.channels_scale, DTYPES[args.dtype], args.seed, device)
    params = param_leaves(model)
    steps_per_epoch = len(train_batches)
    sched = lr_schedule(args, epochs)
    opt = make_optimizer(args, epochs, steps_per_epoch)
    guard_cfg, chaos, crash = build_robustness(args, DTYPES[args.dtype])
    ctrl_cfg = build_control(args, comp)
    state = TrainState.create(model, opt.init(params), init_ef_state(params, comp),
                              seed=args.seed, comp=init_comp_state(params, comp),
                              guard=init_guard_state(guard_cfg),
                              control=init_control_state(ctrl_cfg))
    apply_fn = cifar_apply_fn()
    step_cache: dict = {}

    def train_step_for(state: TrainState, epoch: int):
        # the controller's checkpointed rung picks the sync, else the
        # warm-up schedule's ratio for this epoch: one step per (ratio,
        # rank), the knobs the ladder and the schedule vary
        comp_cfg = (comp_for_rung(comp, ctrl_cfg, int(state.control.rung))
                    if ctrl_cfg is not None else comp_for_ratio(args, warmup_ratio_for_epoch(
                        epoch, ratio=args.ratio, warmup_epochs=args.ratio_warmup_epochs,
                        method=comp.method)))
        key = (comp_cfg.ratio, comp_cfg.rank)
        if key not in step_cache:
            step_cache[key] = make_train_step(
                apply_fn, opt, comp_cfg, grad_scale=float(bs),
                clip_norm=args.clip_norm, clip_sent_norm=args.clip_sent_norm,
                guard_cfg=guard_cfg, chaos=chaos)
        return step_cache[key]

    eval_step = make_eval_step(apply_fn)

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
        start_epoch = int(meta.get("epoch", -1)) + 1
        if rank == 0:
            print(f"resumed step {state.step} from {args.resume} "
                  f"(starting epoch {start_epoch})")

    tel = Telemetry(args, harness="dawn", log_dir=args.log_dir, chaos=chaos, crash=crash,
                    ckpt=ckpt,
                    meta=dict(network=args.network, method=args.method, compress=args.compress,
                              mode=args.mode, transport=args.transport, batch_size=bs,
                              devices=world, epochs=epochs),
                    flight_meta=dict(network=args.network, method=args.method,
                                     compress=args.compress, devices=world))
    stream = make_stream(args, flight=tel.flight, events=tel.events)
    if ckpt is not None:
        # committed checkpoints re-anchor the delta stream's window
        ckpt.stream = stream
    el = build_elastic(args, launch, chaos=chaos, crash=crash, device=device, ckpt=ckpt,
                       events=tel.events, flight=tel.flight, stream=stream)
    # the current world: its size, this rank and the global batch it divides
    cur = {"rank": rank, "world": world, "bs": bs}

    def follow_world() -> None:
        """Re-shard the data (both trimmed to the new world's global batch)
        and rebuild the steps for ``el``'s world."""
        w = el.world
        cur.update(rank=el.rank, world=w, bs=(bs // w) * w)
        train_batches.reshard(el.rank, w, cur["bs"])
        test_batches.trim(cur["bs"])
        step_cache.clear()

    if el is not None and launch.decision is not None:
        # a watchdog-relaunched worker: adopt the running world's replicated
        # state from its coordinator's broadcast (EF starts at zero), its
        # next epoch and its data order; under --stream_rejoin and a warm
        # commit the parameters come off the delta stream instead
        adopted, adopted_info = stream_rejoin_params(args, state, launch.decision,
                                                     flight=tel.flight)
        state = el.join_world(state, launch.decision, adopted_params=adopted,
                              adopted_info=adopted_info)
        start_epoch = int(el.shared.get("next_epoch", start_epoch))
        if "data_rng" in el.shared:
            train_batches.rng.set_state(el.shared["data_rng"])
        follow_world()
    controller, hide_frac = None, 1.0
    if ctrl_cfg is not None:
        controller = Controller(ctrl_cfg, events=tel.events,
                                pricer=build_twin_pricer(args, comp, world=cur["world"]))
        # the overlap schedule's hideable byte fraction scales the measured
        # compute into the per-update budget (unless --adaptive_budget_ms
        # pins it)
        hide_frac = hideable_fraction(params, comp)
        if rank == 0:
            print(f"adaptive: method={ctrl_cfg.method} knob={controller.knob} "
                  f"rungs={ctrl_cfg.rungs} window={ctrl_cfg.window} "
                  f"signal={ctrl_cfg.signal} hideable_frac={hide_frac:.3f}")
    # per-card forward FLOPs for the throughput record, counted once when
    # an exporter can use them
    fwd_flops = (flops_mod.cnn_fwd_flops(model, (bs // world, 32, 32, 3), device)
                 if tel.events is not None or args.prom else None)
    table, tsv = TableLogger(), TSVLogger()
    timer = Timer(lambda: device_sync(device))
    preempt = make_preemption()
    summary: dict = {}

    def run_epoch(state: TrainState, epoch: int) -> TrainState:
        nonlocal summary
        while True:
            try:
                # a signal that landed during eval stops the run before the
                # next epoch dispatches anything
                preempt.check(state.step)
                profiling = args.profile_epoch == epoch and args.log_dir
                with profile_trace(os.path.join(args.log_dir, "profile") if profiling
                                   else None):
                    state, epoch_stats, acc = train_epoch(
                        train_step_for(state, epoch), eval_step, state, train_batches,
                        test_batches, timer, cur["bs"], device, rank=cur["rank"],
                        world=cur["world"], crash=crash, step_offset=state.step,
                        guard_cfg=guard_cfg, preempt=preempt, elastic=el,
                        timeline=tel.timeline, flight=tel.flight)
            except resilience.Preempted as err:
                err.epoch = epoch
                if not hasattr(err, "train_state"):
                    err.train_state = state
                raise
            except Exception as err:
                failure = el.failure_from(err) if el is not None else None
                if failure is None:
                    tel.observe(err, getattr(err, "train_state", state).step)
                    raise
                # coordinated abort: the survivors move to the new world from
                # the last live state and replay the epoch from its first
                # batch; the injectors fire once a process, so the replay
                # does not crash again
                state = el.handle_failure(getattr(err, "train_state", state), failure)
                follow_world()
                continue
            break
        if el is not None:
            # epoch-boundary readmission of relaunched workers parked in the
            # rendezvous join barrier (no-op when none is waiting); a joiner
            # starts at the next epoch with the survivors' data order
            el.shared.update(next_epoch=epoch + 1, data_rng=train_batches.rng.get_state())
            state, grew = el.rejoin_barrier(state)
            if grew:
                follow_world()
        if controller is not None:
            # the tick lands BEFORE the epoch checkpoint: the saved state
            # holds this epoch's accumulation, so a resumed run replays the
            # remaining windows bitwise
            old_rung = int(state.control.rung)
            wall_ms = epoch_stats["train time"] * 1e3 / max(acc.steps, 1)
            state = control_tick(controller, state, guard_cfg=guard_cfg,
                                 mean_bits=acc.mean("comm/sent_bits"), wall_ms=wall_ms,
                                 hide_frac=hide_frac, flight=tel.flight, note={"epoch": epoch})
            new_rung = int(state.control.rung)
            if new_rung != old_rung and controller.knob == "rank":
                # PowerSGD: the next rung's warm Q keeps the learnt columns
                state = dataclasses.replace(state, comp=migrate_comp_state(
                    state.comp, params, comp_for_rung(comp, ctrl_cfg, old_rung),
                    comp_for_rung(comp, ctrl_cfg, new_rung)))
        if ckpt is not None and args.ckpt_every > 0 and (epoch + 1) % args.ckpt_every == 0:
            # the write overlaps the next epoch; the next save (or a
            # preemption) waits for it
            ckpt.save_async(state, {"epoch": epoch})
        if stream is not None and args.stream_every > 0 and (epoch + 1) % args.stream_every == 0:
            # delta segment: codec here, on the parameters' device; commit
            # in the background
            stream.append_async(state.model, step=state.step)
        train_time = epoch_stats["train time"]
        examples_per_sec = acc.steps * cur["bs"] / max(train_time, 1e-9)
        thr = flops_mod.throughput_record(fwd_flops, acc.steps / max(train_time, 1e-9),
                                          examples_per_sec=examples_per_sec, device=device)
        summary = {
            "epoch": epoch + 1,
            "lr": float(sched(epoch + 1)),
            **epoch_stats,
            "img/s": round(examples_per_sec, 1),
            "steps": acc.steps,
        }
        if "throughput/mfu" in thr:
            summary["mfu"] = round(thr["throughput/mfu"], 4)
        summary.update(control_summary(controller, state.control))
        if el is not None:
            summary["world"] = el.world
        control_stats = controller.metrics(state.control) if controller is not None else {}
        tel.window(
            "epoch", {"epoch": epoch + 1, "step": state.step}, summary=summary,
            loss=summary["train loss"], thr=thr,
            comm={k: acc.mean(k) for k in acc.sums if k.startswith("comm/")},
            guard={k: v for k, v in acc.last.items() if k.startswith("guard/")},
            control=control_stats,
            prom_extra={"lr": summary["lr"], **(ckpt.metrics() if ckpt is not None else {}),
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
            table.append(summary)
            tsv.append(summary)
            tel.tb.update_examples_count(acc.steps * cur["bs"])
            tel.tb.log_metrics({f"losses/{k}": v for k, v in summary.items()
                                if k in ("train loss", "test loss", "train acc", "test acc")})
            tel.tb.log_scalar("times/epoch_seconds", summary["train time"])
        return state

    try:
        state, _ = resilience.run_with_recovery(run_epoch, state, epochs, checkpointer=ckpt,
                                                start_epoch=start_epoch,
                                                passthrough=(PeerFailed, RendezvousError))
        if args.log_dir and cur["rank"] == 0:
            tsv.save(args.log_dir)
    except resilience.Preempted as err:
        # drain the write in flight, cut a synchronous emergency save of the
        # live state and exit 75 (the finally still runs)
        raise preempt_exit(err, ckpt=ckpt, state=getattr(err, "train_state", state),
                           meta={"epoch": getattr(err, "epoch", start_epoch) - 1},
                           events=tel.events, flight=tel.flight) from None
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


def make_optimizer(args, epochs: int, steps_per_epoch: int) -> SGD:
    """The protocol's SGD (`dawn.py:142`): the schedule's rate at the
    fractional epoch over the batch size, weight decay ``5e-4 * batch_size``,
    Nesterov when momentum > 0."""
    sched = lr_schedule(args, epochs)
    spe, bs32 = np.float32(steps_per_epoch), np.float32(args.batch_size)
    return SGD(lr=lambda step: sched(np.float32(step) / spe) / bs32,
               momentum=args.momentum, nesterov=args.momentum > 0,
               weight_decay=5e-4 * args.batch_size)


def cifar_apply_fn():
    """The nets' apply with the CIFAR-10 normalisation of uint8 pixels."""
    return make_normalizing_apply_fn(np.asarray(data.CIFAR10_MEAN) * 255.0,
                                     np.asarray(data.CIFAR10_STD) * 255.0)


def lr_schedule(args, epochs: int):
    """The learning rate at a fractional epoch: the CIFAR triangle (`dawn.py:110`,
    the ramp pulled in on runs of 5 epochs or fewer), or with ``--lr_schedule
    step`` the reference's ImageNet shape (`train.py:60-72`): warm-up over the
    first eighth to the peak, flat, a tenth of it at 60 % and a hundredth at
    85 % of the run."""
    if args.lr_schedule == "step":
        ramp_s = epochs / 8.0
        knots, vals = lr_phases_to_knots([
            {"ep": (0, ramp_s), "lr": (0.0, args.peak_lr)},
            {"ep": ramp_s, "lr": args.peak_lr},
            {"ep": 0.6 * epochs, "lr": args.peak_lr / 10.0},
            {"ep": 0.85 * epochs, "lr": args.peak_lr / 100.0},
        ])
        return piecewise_linear(knots, vals)
    ramp_ep = 5 if epochs > 5 else epochs / 2
    return piecewise_linear([0, ramp_ep, epochs], [0, args.peak_lr, 0])


def main(argv: Optional[list] = None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
