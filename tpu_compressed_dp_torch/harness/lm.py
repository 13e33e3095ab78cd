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
``NotImplementedError`` naming the ROADMAP item that brings it.
Steady-state tokens/s excludes the first two steps (as the JAX harness
does) and is closed by a device synchronise.

Runs on CUDA unless ``--device cpu``; launch ``dp * sp * pp * tp`` processes
with ``torchrun`` (e.g. ``torchrun --nproc_per_node 4 -m
tpu_compressed_dp_torch.harness.lm --sp 2 --tp 2 ...``; ``--dp`` defaults to
the world over ``sp * tp * pp``); alone, it runs a 1-rank group.

Run: ``python -m tpu_compressed_dp_torch.harness.lm --preset llama3_8b
--layers 2 --seq_len 8192 --global_batch 1 --compress entiremodel --method
topk --ratio 0.01 --error_feedback``
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, Optional

import torch

from tpu_compressed_dp_torch.data import lm as lm_data
from tpu_compressed_dp_torch.harness.loop import to_device
from tpu_compressed_dp_torch.models import transformer as tf
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.parallel.dp import CompressionConfig, init_ef_state
from tpu_compressed_dp_torch.train.lm_step import (init_lm_comp_state, init_lm_ef_state,
                                                   local_block, make_lm_train_step)
from tpu_compressed_dp_torch.train import pp_step
from tpu_compressed_dp_torch.train.optim import SGD
from tpu_compressed_dp_torch.train.schedules import piecewise_linear
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.utils import flops as flops_mod
from tpu_compressed_dp_torch.utils.loggers import TableLogger
from tpu_compressed_dp_torch.utils.timer import device_sync

PRESETS = {
    "tiny": tf.tiny_llama,
    "llama3_8b": tf.llama3_8b,
}

_ITEM = "ROADMAP.md queue 1, item {}"
# flags of the JAX harness this port does not carry yet, by the ROADMAP item
# that ports them: any value but the default raises
_LATER = {
    **dict.fromkeys(("guard", "guard_init_scale", "guard_backoff", "guard_growth_interval",
                     "guard_max_skips", "chaos", "heartbeat", "heartbeat_interval", "elastic",
                     "elastic_dir", "peer_timeout", "elastic_ef", "elastic_min_world",
                     "checkpoint_dir", "ckpt_every", "resume", "coordinator",
                     "num_processes", "process_id"), 12),
    **dict.fromkeys(("adaptive", "adaptive_window", "adaptive_deadband", "adaptive_rungs",
                     "adaptive_budget_ms", "adaptive_bw_mbps", "adaptive_signal",
                     "adaptive_model", "twin_records", "events", "prom", "job_id",
                     "events_max_mb", "flight_dir", "flight_capacity", "logdir",
                     "profile_epoch"), 13),
    **dict.fromkeys(("stream_dir", "stream_every", "stream_keyframe_every", "stream_ratio",
                     "stream_rejoin"), 14),
}


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
    # robustness, telemetry, control and streaming (not ported)
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
    p.add_argument("--elastic_ef", type=str, default="fold", choices=("fold", "drop"))
    p.add_argument("--elastic_min_world", type=int, default=2)
    p.add_argument("--stream_dir", type=str, default=None)
    p.add_argument("--stream_every", type=int, default=1)
    p.add_argument("--stream_keyframe_every", type=int, default=8)
    p.add_argument("--stream_ratio", type=float, default=0.01)
    p.add_argument("--stream_rejoin", action="store_true")
    p.add_argument("--adaptive", action="store_true")
    p.add_argument("--adaptive_window", type=int, default=8)
    p.add_argument("--adaptive_deadband", type=float, default=0.25)
    p.add_argument("--adaptive_rungs", type=str, default=None)
    p.add_argument("--adaptive_budget_ms", type=float, default=0.0)
    p.add_argument("--adaptive_bw_mbps", type=float, default=100.0)
    p.add_argument("--adaptive_signal", type=str, default="modeled",
                   choices=("modeled", "measured"))
    p.add_argument("--adaptive_model", type=str, default="flat", choices=("flat", "twin"))
    p.add_argument("--twin_records", type=str, default=".")
    p.add_argument("--events", type=str, default=None)
    p.add_argument("--prom", type=str, default=None)
    p.add_argument("--job_id", type=str, default=None)
    p.add_argument("--events_max_mb", type=float, default=0.0)
    p.add_argument("--flight_dir", type=str, default=None)
    p.add_argument("--flight_capacity", type=int, default=256)
    p.add_argument("--logdir", type=str, default=None)
    p.add_argument("--profile_epoch", type=int, default=None)
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
    defaults = build_parser().parse_args([])
    for dest, item in _LATER.items():
        if getattr(args, dest) != getattr(defaults, dest):
            raise NotImplementedError(f"--{dest} is not ported yet: {_ITEM.format(item)}")


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
    made_group = not torch.distributed.is_initialized()
    mesh.init_process_group(device)
    try:
        return _run(args, device, comp)
    finally:
        if made_group:
            mesh.destroy()


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


def _build(args, cfg: tf.LlamaConfig, comp: CompressionConfig, opt: SGD, groups, device):
    """This rank's ``(state, train_step, n_params)``: the model (or its
    pipeline stage), the LM or GPipe step, and the whole model's parameter
    count (the JAX tree's: every expert, every tensor shard and stage)."""
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
                                  seed=args.seed + 1)
        step = pp_step.make_pp_train_step(cfg, opt, comp, groups=groups,
                                          microbatches=args.microbatches,
                                          clip_norm=args.clip_norm,
                                          clip_sent_norm=args.clip_sent_norm)
        return state, step, n_params
    model = tf.Llama(cfg, seed=args.seed, device=device, tensor_rank=groups.tensor_index,
                     tensor_size=groups.tp)
    params = tf.param_leaves(model)
    n_params = sum(p.numel() * (groups.tp if sh else 1)
                   for p, sh in zip(params.values(), tf.is_sharded(cfg)))
    state = TrainState.create(model, opt.init(params), init_lm_ef_state(cfg, params, comp),
                              seed=args.seed + 1,
                              comp=init_lm_comp_state(cfg, params, comp, groups))
    step = make_lm_train_step(cfg, opt, comp, groups=groups, clip_norm=args.clip_norm,
                              clip_sent_norm=args.clip_sent_norm)
    return state, step, n_params


def _run(args, device: torch.device, comp: CompressionConfig) -> Dict[str, float]:
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
    state, train_step, n_params = _build(args, cfg, comp, opt, groups, device)
    n_chips = groups.dp * groups.sp * groups.tp * groups.pp
    mesh_str = (f"dp{groups.dp}xsp{groups.sp}xpp{groups.pp}xtp{groups.tp}(mb{args.microbatches})"
                if groups.pp > 1 else f"dp{groups.dp}xsp{groups.sp}xtp{groups.tp}")
    if rank == 0:
        print(f"params={n_params / 1e6:.1f}M mesh={mesh_str} "
              f"seq={args.seq_len} batch={args.global_batch} "
              f"method={comp.method or 'dense'}/{comp.granularity}/{comp.mode} "
              f"device={device} dtype={cfg.dtype}")

    table = TableLogger()
    summary: Dict[str, float] = {}
    t0, timed_from = time.perf_counter(), 0
    for step_i in range(args.steps):
        batch = {k: v[rows, cols] for k, v in ds.batch(step_i).items()}
        state, metrics = train_step(state, to_device(batch, device))
        if step_i <= 1:
            # steady state starts after the first two steps (allocator and
            # library warm-up; the JAX harness excludes its two compiles)
            device_sync(device)
            t0, timed_from = time.perf_counter(), step_i + 1
        if (step_i + 1) % args.log_every == 0 or step_i == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}  # waits for the step
            dt = time.perf_counter() - t0
            steps_timed = step_i + 1 - timed_from
            tokens_done = steps_timed * args.global_batch * args.seq_len
            summary = {"step": step_i + 1, "loss": m["loss"], "lr": m["lr"],
                       "tok/s": round(tokens_done / dt, 1) if steps_timed > 0 else 0.0}
            if steps_timed > 0:
                # MFU: closed-form 6N + 12 L d s per token (N counts every
                # expert, as the JAX harness's), per card of the mesh,
                # against the card's bf16 peak (absent on the CPU and unknown
                # cards)
                tok_flops = flops_mod.transformer_train_flops_per_token(
                    n_params, cfg.n_layers, cfg.dim, args.seq_len)
                fwd_per_card = (tok_flops / 3.0) * args.global_batch * args.seq_len / n_chips
                thr = flops_mod.throughput_record(fwd_per_card, steps_timed / dt,
                                                  tokens_per_sec=tokens_done / dt,
                                                  device=device)
                if "throughput/mfu" in thr:
                    summary["mfu"] = round(thr["throughput/mfu"], 4)
            if "comm/sent_elems" in m:
                dense = max(m["comm/dense_elems"], 1.0)
                summary["sent frac"] = m["comm/sent_elems"] / dense
                summary["wire frac"] = m["comm/sent_bits"] / (32.0 * dense)
            if rank == 0:
                table.append(summary)
    return summary


def main(argv: Optional[list] = None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
