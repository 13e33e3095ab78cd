"""Llama pretrain harness on PyTorch: compressed data-parallel SGD.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.harness.lm` on the
``(data, seq, tensor)`` mesh (``--dp --sp --tp``), or with ``--pp > 1`` the
GPipe step on ``(data, seq, pipe, tensor)`` (``train/pp_step.py``,
``--microbatches`` a step): one process per mesh position
(``parallel/mesh.lm_groups``), each holding its tensor shard of the model (of
its pipeline stage) and its ``(data, seq)`` block of the global batch; the
``dp * sp`` compression workers' gradients sync through the ported engines
(dense, PowerSGD at ``--tp 1 --pp 1``, or any compressor in simulate or wire
mode, over the allgather, sharded or hierarchical transport, chunk-pipelined
with ``--overlap``).  ``--experts E`` makes every ``--moe_every``-th layer's
FFN a top-1 mixture of ``E`` experts at ``--capacity_factor`` (experts split
over ``--tp``).  The flag names and defaults are the JAX harness's, plus
``--device``; a flag this port does not carry yet raises
``NotImplementedError`` naming the ROADMAP item that brings it.  The
robustness flags run as in the JAX harness: ``--guard*`` and ``--chaos``
arm the step guard and the fault injection, the wedge check runs every
``--log_every``, ``--checkpoint_dir`` saves asynchronously every
``--ckpt_every`` steps and at the end (each rank its EF, and its model
shard under ``--tp`` / ``--pp``), ``--resume DIR`` continues from the
checkpoint's step, and a SIGTERM/SIGINT cuts an emergency save and exits 75.
``--elastic`` (``train/elastic.py``) runs on a pure data axis: on a dead
worker the survivors re-form the world and re-run the step index on the
``dp - 1`` ranks (each batch cut to ``(global_batch // dp) * dp`` rows), and
relaunched workers are readmitted every ``--log_every`` steps; ``--pp``
raises the JAX harness's ``ValueError``, and ``--sp`` / ``--tp`` above 1
are ROADMAP item 12's model-axes remesh, not ported.  The telemetry flags
(``--events --prom --job_id --flight_dir --logdir --profile_epoch``) and
the compression controller (``--adaptive*``, ratio methods on the
``(data, seq, tensor)`` step) run as in the JAX harness: every
``--log_every`` window publishes a ``step`` record, the Prometheus file and
the heartbeat's telemetry, and the controller ticks on the applied updates
before that window's checkpoint save; a rung switch takes effect at the
next step.  With ``--stream_dir`` rank 0 appends a delta segment
(``stream/``) every ``--stream_every`` steps, after that step's checkpoint
save, and a worker relaunched with ``--stream_rejoin`` adopts the
parameters from the stream when the survivors commit a warm readmission;
at ``--tp`` or ``--pp`` above 1 rank 0 holds only its shard, and the
stream flags raise (ROADMAP item 14, the stream's model axes).
Steady-state tokens/s excludes the first two steps (as the JAX harness
does) and is closed by a device synchronise.

Runs on CUDA unless ``--device cpu``; launch ``dp * sp * pp * tp`` processes
with ``torchrun`` or ``--coordinator --num_processes --process_id`` (e.g.
``torchrun --nproc_per_node 4 -m
tpu_compressed_dp_torch.harness.lm --sp 2 --tp 2 ...``; ``--dp`` defaults to
the world over ``sp * tp * pp``); alone, it runs a 1-rank group.

Run: ``python -m tpu_compressed_dp_torch.harness.lm --preset llama3_8b
--layers 2 --seq_len 8192 --global_batch 1 --compress entiremodel --method
topk --ratio 0.01 --error_feedback``
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional

import torch

from tpu_compressed_dp_torch.data import lm as lm_data
from tpu_compressed_dp_torch.control import Controller, comp_for_rung, init_control_state
from tpu_compressed_dp_torch.control.rungs import ladder_knob
from tpu_compressed_dp_torch.harness.loop import (Telemetry, add_adaptive_args,
                                                  add_stream_args, add_telemetry_args,
                                                  build_control, build_elastic,
                                                  build_robustness, build_twin_pricer,
                                                  control_tick,
                                                  elastic_distributed_init, hideable_fraction,
                                                  make_heartbeat, make_preemption,
                                                  make_stream, preempt_exit, profile_trace,
                                                  stream_rejoin_params, to_device)
from tpu_compressed_dp_torch.models import transformer as tf
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.parallel.dp import CompressionConfig, init_ef_state
from tpu_compressed_dp_torch.train.lm_step import (init_lm_comp_state, init_lm_ef_state,
                                                   local_block, make_lm_train_step)
from tpu_compressed_dp_torch.train import pp_step
from tpu_compressed_dp_torch.train.guard import check_guard_metrics, init_guard_state
from tpu_compressed_dp_torch.train.optim import SGD
from tpu_compressed_dp_torch.train.schedules import piecewise_linear
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.utils import flops as flops_mod
from tpu_compressed_dp_torch.utils import resilience
from tpu_compressed_dp_torch.utils.checkpoint import Checkpointer
from tpu_compressed_dp_torch.utils.loggers import TableLogger
from tpu_compressed_dp_torch.utils.meters import GuardMeter
from tpu_compressed_dp_torch.utils.timer import device_sync

PRESETS = {
    "tiny": tf.tiny_llama,
    "llama3_8b": tf.llama3_8b,
}

_ITEM = "ROADMAP.md queue 1, item {}"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Llama pretrain, compressed data-parallel SGD "
                                            "(PyTorch port)")
    p.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    p.add_argument("--vocab", type=int, default=None)
    p.add_argument("--dim", type=int, default=None)
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--heads", type=int, default=None)
    p.add_argument("--kv_heads", type=int, default=None)
    p.add_argument("--ffn", type=int, default=None)
    p.add_argument("--experts", type=int, default=None, help="MoE expert count (0 = dense)")
    p.add_argument("--moe_every", type=int, default=None)
    p.add_argument("--capacity_factor", type=float, default=None)
    p.add_argument("--fp32", action="store_true", help="disable bf16 compute")
    p.add_argument("--remat", action="store_true", help="rematerialise layers")
    # mesh
    p.add_argument("--dp", type=int, default=None,
                   help="data axis size (default: world // (sp * tp))")
    p.add_argument("--sp", type=int, default=1, help="sequence axis size (ring attention)")
    p.add_argument("--tp", type=int, default=1, help="tensor axis size (Megatron layers)")
    p.add_argument("--pp", type=int, default=1, help="pipeline stages (GPipe)")
    p.add_argument("--microbatches", type=int, default=4,
                   help="pipeline microbatches per step (--pp > 1 only)")
    # data/schedule
    p.add_argument("--corpus", type=str, default=None,
                   help="byte-level text file; default synthetic")
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--global_batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--warmup_steps", type=int, default=10,
                   help="linear learning-rate warm-up steps")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--clip_norm", type=float, default=0.0,
                   help="local-gradient L2 clip (0 = off)")
    p.add_argument("--clip_sent_norm", type=float, default=0.0,
                   help="post-aggregation L2 clip of the synced gradient (0 = off)")
    # compression (the CNN harnesses' surface)
    p.add_argument("--compress", "-c", default="none",
                   choices=["none", "layerwise", "entiremodel", "bucketed"])
    p.add_argument("--method", default="none")
    p.add_argument("--ratio", "-K", type=float, default=0.01)
    p.add_argument("--threshold", "-V", type=float, default=0.001)
    p.add_argument("--qstates", "-Q", type=int, default=255)
    p.add_argument("--rank", type=int, default=4, help="r for powersgd")
    p.add_argument("--block_size", type=int, default=256,
                   help="blocktopk: elements per contiguous block")
    p.add_argument("--bucket_mb", type=float, default=25.0,
                   help="bucketed granularity: capacity per bucket")
    p.add_argument("--wire_cap_ratio", type=float, default=0.05,
                   help="wire thresholdv/adaptive_threshold capacity (fraction of elements)")
    p.add_argument("--mode", default="simulate", choices=["simulate", "wire"])
    p.add_argument("--transport", default="allgather",
                   choices=["allgather", "sharded", "hierarchical"])
    p.add_argument("--error_feedback", action="store_true")
    p.add_argument("--overlap", type=int, default=1,
                   help="chunk-pipelined sync: chunks per signature group")
    p.add_argument("--dp_pods", type=int, default=1,
                   help="hierarchical transport: pod count (must divide the world size)")
    p.add_argument("--hier_route_factor_ici", type=float, default=1.25)
    p.add_argument("--hier_route_factor_dcn", type=float, default=1.25)
    # robustness, telemetry, control and streaming
    p.add_argument("--guard", action="store_true")
    p.add_argument("--guard_init_scale", type=float, default=2.0 ** 15)
    p.add_argument("--guard_backoff", type=float, default=0.5)
    p.add_argument("--guard_growth_interval", type=int, default=200)
    p.add_argument("--guard_max_skips", type=int, default=25)
    p.add_argument("--chaos", type=str, default=None)
    p.add_argument("--heartbeat", type=str, default=None)
    p.add_argument("--heartbeat_interval", type=float, default=10.0)
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--elastic_dir", type=str, default=None)
    p.add_argument("--peer_timeout", type=float, default=60.0)
    p.add_argument("--elastic_ef", type=str, default="drop", choices=("fold", "drop"))
    p.add_argument("--elastic_min_world", type=int, default=2)
    add_stream_args(p, cadence_help="steps between delta-stream appends (requires "
                                    "--stream_dir; 0 disables streaming)")
    add_adaptive_args(p)
    add_telemetry_args(p)
    p.add_argument("--logdir", type=str, default=None, help="output dir for profiler traces")
    p.add_argument("--profile_epoch", type=int, default=None,
                   help="torch.profiler-trace the Nth --log_every window of steps to "
                        "<logdir>/profile/trace.json (the LM loop's 'epoch' is one log "
                        "window)")
    # plumbing
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--ckpt_every", type=int, default=0)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--coordinator", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises where CUDA is missing) or cpu")
    return p


def _check_ported(args) -> None:
    if args.stream_dir and (args.tp > 1 or args.pp > 1):
        raise NotImplementedError(
            "--stream_dir with --tp or --pp above 1 is not ported yet: rank 0, the stream's "
            "writer, holds only its shard of the parameters, "
            f"{_ITEM.format('14 (the stream over the model axes)')}")
    if args.elastic and args.pp > 1:
        # the JAX harness's refusal: a pipeline stage has no replica to
        # recover from
        raise ValueError(
            "--elastic supports dp/dp x sp/dp x tp meshes; losing a worker "
            "of a pp mesh orphans a pipeline stage (that is a checkpoint "
            "restart, not a remesh)")
    if args.elastic and (args.sp > 1 or args.tp > 1):
        raise NotImplementedError(
            "--elastic with --sp or --tp above 1 is not ported yet: losing a rank takes its "
            f"data row's model-axis peers out too, {_ITEM.format('12 (elastic, model axes)')}")


def build_config(args) -> tf.LlamaConfig:
    cfg = PRESETS[args.preset]()
    overrides = {}
    for field, arg in [("vocab_size", args.vocab), ("dim", args.dim),
                       ("n_layers", args.layers), ("n_heads", args.heads),
                       ("n_kv_heads", args.kv_heads), ("ffn_hidden", args.ffn),
                       ("n_experts", args.experts), ("moe_every", args.moe_every),
                       ("capacity_factor", args.capacity_factor)]:
        if arg is not None:
            overrides[field] = arg
    if args.fp32:
        overrides["dtype"] = torch.float32
    if args.remat:
        overrides["remat"] = True
    return dataclasses.replace(cfg, **overrides)


def _device(name: str) -> torch.device:
    if name == "cuda" and "LOCAL_RANK" in os.environ:
        name = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return mesh.resolve_device(name)


def run(args) -> Dict[str, float]:
    _check_ported(args)
    if args.method.lower() != "none" and args.compress == "none":
        raise ValueError(f"--method {args.method} requires --compress layerwise|entiremodel")
    device = _device(args.device)
    # float32 stays float32, as in the JAX reference: no TF32 in the matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    comp = CompressionConfig(
        method=None if args.compress == "none" or args.method.lower() == "none" else args.method,
        granularity=args.compress if args.compress != "none" else "layerwise",
        mode=args.mode, ratio=args.ratio, threshold=args.threshold,
        qstates=args.qstates, block_size=args.block_size, bucket_mb=args.bucket_mb,
        wire_cap_ratio=args.wire_cap_ratio, transport=args.transport,
        dp_pods=args.dp_pods, hier_route_factor_ici=args.hier_route_factor_ici,
        hier_route_factor_dcn=args.hier_route_factor_dcn, rank=args.rank,
        error_feedback=args.error_feedback, sync_overlap=args.overlap,
    )
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


def _mesh(args) -> mesh.LmGroups:
    """This rank's groups on the ``(dp, sp, pp, tp)`` mesh, with the JAX
    harness's checks."""
    world = mesh.world()
    model = args.sp * args.tp * args.pp
    if min(args.sp, args.tp, args.pp) < 1 or world % model:
        raise ValueError(f"--sp {args.sp} x --tp {args.tp} x --pp {args.pp} must divide the "
                         f"world size {world}")
    dp = args.dp if args.dp is not None else world // model
    if dp * model != world:
        raise ValueError(f"--dp {dp} x --sp {args.sp} x --tp {args.tp} x --pp {args.pp} must "
                         f"equal the world size {world} (one process per mesh position)")
    if args.global_batch % (dp * (args.microbatches if args.pp > 1 else 1)):
        raise ValueError(f"--global_batch {args.global_batch} must divide by dp*microbatches")
    if args.seq_len % args.sp:
        raise ValueError(f"--seq_len {args.seq_len} must divide by sp={args.sp}")
    return mesh.lm_groups(dp, args.sp, args.tp, args.pp)


def _check_adaptive(args, ctrl_cfg) -> None:
    """The JAX harness's refusals of ``--adaptive``."""
    if ctrl_cfg is None:
        return
    if args.pp > 1:
        raise ValueError("--adaptive supports the (data, seq, tensor) step; the pipeline "
                         "step's stacked-layer layout has no rung-switch path yet")
    if ladder_knob(ctrl_cfg.method) == "rank":
        raise ValueError("--adaptive rank retuning (powersgd) is CNN-harness-only for now: "
                         "the LM comp-state layout has no cross-rank migration path (use a "
                         "ratio method, or static --rank)")


def _data_step(args, cfg: tf.LlamaConfig, comp: CompressionConfig, opt: SGD, groups,
               guard_cfg=None, chaos=None):
    """The LM step (no pipeline) on ``groups``."""
    return make_lm_train_step(cfg, opt, comp, groups=groups, clip_norm=args.clip_norm,
                              clip_sent_norm=args.clip_sent_norm, guard_cfg=guard_cfg,
                              chaos=chaos)


def _build(args, cfg: tf.LlamaConfig, comp: CompressionConfig, opt: SGD, groups, device,
           guard_cfg=None, chaos=None):
    """This rank's ``(state, train_step, n_params)``: the model (or its
    pipeline stage), the LM or GPipe step, and the whole model's parameter
    count (the JAX tree's: every expert, every tensor shard and stage)."""
    guard = init_guard_state(guard_cfg)
    if groups.pp > 1:
        stage = pp_step.PipelineStage.build(
            cfg, seed=args.seed, device=device, pipe_rank=groups.pipe_index,
            pipe_size=groups.pp, tensor_rank=groups.tensor_index, tensor_size=groups.tp)
        params = pp_step.stage_leaves(stage)
        n_params = sum(p.numel() * (groups.tp if "tensor" in ax else 1)
                       * (groups.pp if "pipe" in ax else 1)
                       for p, ax in zip(params.values(),
                                        pp_step.stage_leaf_axes(cfg, groups.tp)))
        state = TrainState.create(stage, opt.init(params), init_ef_state(params, comp),
                                  seed=args.seed + 1, guard=guard)
        step = pp_step.make_pp_train_step(cfg, opt, comp, groups=groups,
                                          microbatches=args.microbatches,
                                          clip_norm=args.clip_norm,
                                          clip_sent_norm=args.clip_sent_norm,
                                          guard_cfg=guard_cfg, chaos=chaos)
        return state, step, n_params
    model = tf.Llama(cfg, seed=args.seed, device=device, tensor_rank=groups.tensor_index,
                     tensor_size=groups.tp)
    params = tf.param_leaves(model)
    n_params = sum(p.numel() * (groups.tp if sh else 1)
                   for p, sh in zip(params.values(), tf.is_sharded(cfg)))
    state = TrainState.create(model, opt.init(params), init_lm_ef_state(cfg, params, comp),
                              seed=args.seed + 1,
                              comp=init_lm_comp_state(cfg, params, comp, groups), guard=guard)
    return state, _data_step(args, cfg, comp, opt, groups, guard_cfg, chaos), n_params


def _run(args, device: torch.device, comp: CompressionConfig, launch,
         hb) -> Dict[str, float]:
    cfg = build_config(args)
    cfg.validate_mesh(args.tp)
    groups = _mesh(args)
    rank = mesh.rank()
    if args.corpus:
        ds = lm_data.ByteCorpus(args.corpus, args.seq_len, args.global_batch, seed=args.seed)
        if ds.vocab != cfg.vocab_size:
            cfg = dataclasses.replace(cfg, vocab_size=ds.vocab)
            cfg.validate_mesh(args.tp)
    else:
        ds = lm_data.SyntheticTokens(cfg.vocab_size, args.seq_len, args.global_batch,
                                     seed=args.seed)
    rows, cols = local_block(args.global_batch, args.seq_len, groups)
    sched = piecewise_linear(
        [0, max(args.warmup_steps, 1), max(args.steps, args.warmup_steps + 1)],
        [0.0, args.lr, args.lr * 0.1])
    opt = SGD(lr=sched, momentum=args.momentum, weight_decay=args.weight_decay)
    guard_cfg, chaos, crash = build_robustness(args, cfg.dtype)
    ctrl_cfg = build_control(args, comp)
    _check_adaptive(args, ctrl_cfg)
    state, train_step, n_params = _build(args, cfg, comp, opt, groups, device, guard_cfg, chaos)
    state = dataclasses.replace(state, control=init_control_state(ctrl_cfg))
    step_cache: Dict = {}

    def step_for(state: TrainState):
        """The step the controller's checkpointed rung builds (one a visited
        rung, on the current groups); the static step without
        ``--adaptive``."""
        if ctrl_cfg is None:
            return train_step
        c = comp_for_rung(comp, ctrl_cfg, int(state.control.rung))
        key = (c.ratio, c.rank)
        if key not in step_cache:
            step_cache[key] = _data_step(args, cfg, c, opt, groups, guard_cfg, chaos)
        return step_cache[key]

    n_chips = groups.dp * groups.sp * groups.tp * groups.pp
    mesh_str = (f"dp{groups.dp}xsp{groups.sp}xpp{groups.pp}xtp{groups.tp}(mb{args.microbatches})"
                if groups.pp > 1 else f"dp{groups.dp}xsp{groups.sp}xtp{groups.tp}")
    # each rank's file holds its EF, and its model shard where the mesh shards it
    ckpt_kw = dict(sharded_model=groups.tp * groups.pp > 1, layout={"mesh": mesh_str})
    ckpt = (Checkpointer(args.checkpoint_dir, token="joining" if launch.decision else None,
                         **ckpt_kw) if args.checkpoint_dir else None)
    if args.resume:
        restorer = Checkpointer(args.resume, **ckpt_kw)
        try:
            state, _ = restorer.restore(state)
        finally:
            restorer.close()
        if rank == 0:
            print(f"resumed step {state.step}")
    if rank == 0:
        print(f"params={n_params / 1e6:.1f}M mesh={mesh_str} "
              f"seq={args.seq_len} batch={args.global_batch} "
              f"method={comp.method or 'dense'}/{comp.granularity}/{comp.mode} "
              f"device={device} dtype={cfg.dtype}")

    tel = Telemetry(args, harness="lm", log_dir=args.logdir, chaos=chaos, crash=crash,
                    ckpt=ckpt,
                    meta=dict(preset=args.preset, mesh=mesh_str, method=comp.method or "none",
                              compress=args.compress, mode=args.mode,
                              transport=args.transport, seq_len=args.seq_len,
                              global_batch=args.global_batch, steps=args.steps),
                    flight_meta=dict(preset=args.preset, mesh=mesh_str,
                                     method=comp.method or "none"))
    stream = make_stream(args, flight=tel.flight, events=tel.events)
    if ckpt is not None:
        # committed checkpoints re-anchor the delta stream's window
        ckpt.stream = stream
    el = build_elastic(args, launch, chaos=chaos, crash=crash, device=device, ckpt=ckpt,
                       ckpt_layout=lambda w: {"mesh": f"dp{w}xsp1xtp1"},
                       events=tel.events, flight=tel.flight, stream=stream)
    # the global batch cut to the current world's data ranks
    cut = {"rows": args.global_batch}

    def follow_world() -> None:
        """The step and this rank's batch block in ``el``'s world."""
        nonlocal groups, rows, cols, train_step, n_chips
        groups = mesh.lm_groups(el.world)
        cut["rows"] = (args.global_batch // el.world) * el.world
        rows, cols = local_block(cut["rows"], args.seq_len, groups)
        train_step = _data_step(args, cfg, comp, opt, groups, guard_cfg, chaos)
        step_cache.clear()
        n_chips = el.world

    if el is not None and launch.decision is not None:
        # a watchdog-relaunched worker: the running world's replicated state
        # from its coordinator (EF starts at zero); the state's step is the
        # survivors'; under --stream_rejoin and a warm commit the parameters
        # come off the delta stream
        adopted, adopted_info = stream_rejoin_params(args, state, launch.decision,
                                                     flight=tel.flight)
        state = el.join_world(state, launch.decision, adopted_params=adopted,
                              adopted_info=adopted_info)
        follow_world()
    controller, hide_frac = None, 1.0
    if ctrl_cfg is not None:
        controller = Controller(ctrl_cfg, events=tel.events,
                                pricer=build_twin_pricer(args, comp, world=groups.dp))
        hide_frac = hideable_fraction(tf.param_leaves(state.model), comp)
        if rank == 0:
            print(f"adaptive: method={ctrl_cfg.method} knob={controller.knob} "
                  f"rungs={ctrl_cfg.rungs} window={ctrl_cfg.window} "
                  f"signal={ctrl_cfg.signal} hideable_frac={hide_frac:.3f}")
    timeline = tel.timeline
    # --profile_epoch: trace the Nth log window; the ExitStack opens and
    # closes mid-loop, and the finally stops a trace the loop raised inside
    prof = contextlib.ExitStack()
    prof_window = None
    if args.profile_epoch is not None and args.logdir:
        w0 = args.profile_epoch * args.log_every
        prof_window = (w0, w0 + args.log_every)
    table = TableLogger()
    guard_meter = GuardMeter()
    preempt = make_preemption()
    summary: Dict[str, float] = {}
    start = state.step
    t0, timed_from = time.perf_counter(), start
    try:
        step_i = start
        while step_i < args.steps:
            try:
                if prof_window is not None and step_i == prof_window[0]:
                    prof.enter_context(profile_trace(os.path.join(args.logdir, "profile")))
                if crash is not None:
                    crash.check(step_i)
                # after the crash check: crash=preempt signals there
                preempt.check(step_i)
                if el is not None:
                    el.poll(step_i)
                batch = {k: v[:cut["rows"]][rows, cols] for k, v in ds.batch(step_i).items()}
                timeline.batch_ready()
                state, metrics = step_for(state)(state, to_device(batch, device))
                timeline.step_dispatched()
                if crash is not None:
                    crash.check(step_i, phase="mid_collective")
                if prof_window is not None and step_i + 1 == prof_window[1]:
                    prof.close()
                if step_i <= start + 1:
                    # steady state starts after the first two steps (allocator and
                    # library warm-up; the JAX harness excludes its two compiles)
                    device_sync(device)
                    t0, timed_from = time.perf_counter(), step_i + 1
                    timeline.resume()  # the warm-up drain is not data wait
                if (step_i + 1) % args.log_every == 0 or step_i == args.steps - 1:
                    def fetch():
                        return {k: float(v) for k, v in metrics.items()}  # waits for the step

                    m = fetch() if el is None else el.bounded_get(fetch, step=step_i + 1)
                    # the flight rings fill BEFORE the wedge check, so a
                    # GuardExceeded dump carries the streak history
                    drained = tel.drain(step=step_i + 1, metrics=m)
                    if guard_cfg is not None:
                        # the wedge check at the log cadence
                        guard_meter.update(m, step_i + 1)
                        check_guard_metrics(m, guard_cfg, flight=tel.flight)
                    dt = time.perf_counter() - t0
                    steps_timed = step_i + 1 - timed_from
                    tokens_done = steps_timed * cut["rows"] * args.seq_len
                    summary = {"step": step_i + 1, "loss": m["loss"], "lr": m["lr"],
                               "tok/s": round(tokens_done / dt, 1) if steps_timed > 0 else 0.0}
                    thr: Dict[str, float] = {}
                    if steps_timed > 0:
                        # MFU: closed-form 6N + 12 L d s per token (N counts every
                        # expert, as the JAX harness's), per card of the mesh,
                        # against the card's bf16 peak (absent on the CPU and
                        # unknown cards)
                        tok_flops = flops_mod.transformer_train_flops_per_token(
                            n_params, cfg.n_layers, cfg.dim, args.seq_len)
                        fwd_per_card = (tok_flops / 3.0) * cut["rows"] * args.seq_len / n_chips
                        thr = flops_mod.throughput_record(fwd_per_card, steps_timed / dt,
                                                          tokens_per_sec=tokens_done / dt,
                                                          device=device)
                        if "throughput/mfu" in thr:
                            summary["mfu"] = round(thr["throughput/mfu"], 4)
                    if "comm/sent_elems" in m:
                        dense = max(m["comm/dense_elems"], 1.0)
                        summary["sent frac"] = m["comm/sent_elems"] / dense
                        summary["wire frac"] = m["comm/sent_bits"] / (32.0 * dense)
                    if guard_cfg is not None:
                        gsum = guard_meter.summary()
                        summary["skipped"] = gsum.get("guard/skipped", 0.0)
                        summary["loss_scale"] = gsum.get("guard/loss_scale", 1.0)
                    if el is not None:
                        summary["world"] = el.world
                    control_stats: Dict[str, float] = {}
                    if controller is not None:
                        # the tick at the log cadence, on the applied updates,
                        # before the checkpoint save below: the saved state
                        # holds this window's accumulation
                        wall_ms = dt * 1e3 / steps_timed if steps_timed > 0 else None
                        if wall_ms is not None or (ctrl_cfg.signal == "modeled"
                                                   and ctrl_cfg.budget_ms > 0):
                            state = control_tick(
                                controller, state, guard_cfg=guard_cfg,
                                mean_bits=float(m.get("comm/sent_bits", 0.0)),
                                wall_ms=wall_ms, hide_frac=hide_frac, flight=tel.flight,
                                note={"step": step_i + 1})
                        control_stats = controller.metrics(state.control)
                        summary["rung"] = control_stats["control/rung"]
                        summary[controller.knob] = control_stats["control/value"]
                    tel.window(
                        "step", {"step": step_i + 1}, summary=summary, loss=summary["loss"],
                        thr=thr, comm={k: v for k, v in m.items() if k.startswith("comm/")},
                        guard={k: v for k, v in m.items() if k.startswith("guard/")},
                        control=control_stats, drained=drained,
                        prom_extra={"lr": summary["lr"],
                                    **(ckpt.metrics() if ckpt is not None else {}),
                                    **(stream.metrics() if stream is not None else {}),
                                    **(el.metrics() if el is not None else {})},
                        hb=hb, hb_fields=dict(
                            step=step_i + 1,
                            last_good_step=(int(m["guard/last_good_step"])
                                            if guard_cfg is not None else step_i + 1),
                            **(ckpt.heartbeat_fields() if ckpt is not None else {}),
                            **(stream.heartbeat_fields() if stream is not None else {}),
                            **({"elastic": el.metrics()} if el is not None else {}),
                            **(controller.heartbeat_fields(state.control)
                               if controller is not None else {})))
                    if mesh.rank() == 0:
                        table.append(summary)
                    # the window's fetch and export are not the next step's data wait
                    timeline.resume()
                if el is not None and (step_i + 1) % args.log_every == 0:
                    # log-cadence readmission of relaunched workers parked in the
                    # rendezvous join barrier (no-op when none is waiting)
                    state, grew = el.rejoin_barrier(state)
                    if grew:
                        follow_world()
                if ckpt is not None and args.ckpt_every and (step_i + 1) % args.ckpt_every == 0:
                    # a host copy now, the write in the background
                    ckpt.save_async(state, {"step": step_i + 1})
                if (stream is not None and args.stream_every > 0
                        and (step_i + 1) % args.stream_every == 0):
                    # delta segment: Top-K of (params - last streamed) on the
                    # card, commit in the background
                    stream.append_async(state.model, step=state.step)
            except Exception as err:
                failure = el.failure_from(err) if el is not None else None
                if failure is None or isinstance(err, resilience.Preempted):
                    tel.observe(err, step_i)
                    raise
                # coordinated abort: the survivors move to the new world and
                # re-run this step index there (the JAX harness's granularity)
                state = el.handle_failure(state, failure)
                follow_world()
                t0, timed_from = time.perf_counter(), step_i
                timeline.resume()
                continue
            step_i += 1
        if ckpt is not None:
            ckpt.save(state, {"step": state.step})
    except resilience.Preempted as err:
        # drain the write in flight, cut the emergency save, exit 75
        raise preempt_exit(err, ckpt=ckpt, state=state, meta={"step": state.step},
                           events=tel.events, flight=tel.flight) from None
    finally:
        preempt.uninstall()
        prof.close()
        if el is not None:
            el.close()
        if ckpt is not None:
            ckpt.close()   # drains the background writer before the events close
        if stream is not None:
            stream.close()  # drains the in-flight segment commit
        tel.close()
    return summary


def main(argv: Optional[list] = None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
