"""CIFAR-10 DAWNBench harness on PyTorch: ResNet-9 with compressed DP SGD.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.harness.dawn`, cut to the
flags of the ported compressors: ``--network resnet9 --compress
{layerwise,entiremodel,bucketed} --method --ratio --threshold --qstates
--block_size --bucket_mb --error_feedback --mode {simulate,wire}
--wire_cap_ratio --transport {allgather,sharded,hierarchical} --dp_pods
--hier_route_factor_ici --hier_route_factor_dcn --epochs --batch_size
--peak_lr --momentum --clip_norm --synthetic --synthetic_n --seed`` plus
``--device``.  Protocol
as in the JAX harness: ``PiecewiseLinear([0, 5, epochs], [0, peak, 0])`` at
fractional epochs divided by the batch size, weight decay ``5e-4 *
batch_size``, Nesterov when momentum > 0, Crop/FlipLR/Cutout augmentation,
gradients compressed at summed-loss scale (``grad_scale = batch_size``).
A flag of the JAX harness that this port does not carry yet raises
``NotImplementedError`` naming the ROADMAP item that brings it.

Runs on CUDA unless ``--device cpu``; one process is one worker (launch
several with ``torchrun``, e.g. ``torchrun --nproc_per_node 4 -m
tpu_compressed_dp_torch.harness.dawn --mode wire --transport hierarchical
--dp_pods 2 ...``; alone, it runs a 1-rank group).

Run: ``python -m tpu_compressed_dp_torch.harness.dawn --synthetic --epochs 2``
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from tpu_compressed_dp_torch.data import cifar10 as data
from tpu_compressed_dp_torch.harness.loop import train_epoch
from tpu_compressed_dp_torch.models.common import make_normalizing_apply_fn
from tpu_compressed_dp_torch.models.resnet9 import ResNet9, param_leaves, scaled_channels
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.parallel.dp import CompressionConfig, init_ef_state
from tpu_compressed_dp_torch.train.optim import SGD
from tpu_compressed_dp_torch.train.schedules import piecewise_linear
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.train.step import make_eval_step, make_train_step
from tpu_compressed_dp_torch.utils.loggers import TableLogger, TSVLogger
from tpu_compressed_dp_torch.utils.timer import Timer, device_sync

_ITEM = "ROADMAP.md queue 1, item {}"
# flags of the JAX harness, by the ROADMAP item that ports them
_LATER_FLAGS = {
    **dict.fromkeys(("--clip_sent_norm", "--ratio_warmup_epochs", "--lr_schedule",
                     "--synthetic_hard"), 16),
    **dict.fromkeys(("--rank", "--overlap", "--dtype"), 9),
    **dict.fromkeys(("--devices", "--coordinator", "--num_processes", "--process_id",
                     "--guard", "--guard_backoff", "--guard_growth_interval",
                     "--guard_init_scale", "--guard_max_skips", "--chaos", "--heartbeat",
                     "--heartbeat_interval", "--elastic", "--elastic_dir", "--elastic_ef",
                     "--elastic_min_world", "--peer_timeout", "--checkpoint_dir",
                     "--resume", "--ckpt_every", "--job_id"), 12),
    **dict.fromkeys(("--adaptive", "--adaptive_budget_ms", "--adaptive_bw_mbps",
                     "--adaptive_deadband", "--adaptive_model", "--adaptive_rungs",
                     "--adaptive_signal", "--adaptive_window", "--twin_records",
                     "--events", "--events_max_mb", "--prom", "--flight_dir",
                     "--flight_capacity", "--tensorboard", "--profile_epoch"), 13),
    **dict.fromkeys(("--stream_dir", "--stream_every", "--stream_keyframe_every",
                     "--stream_ratio", "--stream_rejoin"), 14),
}
_LATER_NETWORKS = ("alexnet", "alexnet_module", "vgg16", "resnet9_graph", "alexnet_graph")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--log_dir", type=str, default=".")
    p.add_argument("--network", "-n", type=str, default="resnet9")
    p.add_argument("--compress", "-c", type=str, default="none",
                   choices=["none", "layerwise", "entiremodel", "bucketed"])
    p.add_argument("--method", type=str, default="none")
    p.add_argument("--ratio", "-K", type=float, default=0.5)
    p.add_argument("--threshold", "-V", type=float, default=0.001)
    p.add_argument("--qstates", "-Q", type=int, default=255)
    p.add_argument("--block_size", type=int, default=256,
                   help="blocktopk: elements per contiguous block")
    p.add_argument("--bucket_mb", type=float, default=25.0,
                   help="bucketed granularity: capacity per bucket")
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--clip_norm", type=float, default=0.0,
                   help="local-gradient L2 clip (mean-loss units; 0 = off)")
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
    p.add_argument("--epochs", type=int, default=None, help="override the 24/40 rule")
    p.add_argument("--batch_size", type=int, default=512, help="global batch size")
    p.add_argument("--peak_lr", type=float, default=0.4)
    p.add_argument("--synthetic", action="store_true", help="synthetic data smoke run")
    p.add_argument("--synthetic_n", type=int, default=2048, help="synthetic train-set size")
    p.add_argument("--channels_scale", type=float, default=1.0,
                   help="width multiplier (1.0 = the published widths)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises where CUDA is missing) or cpu")
    return p


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    args, rest = build_parser().parse_known_args(argv)
    for tok in rest:
        flag = tok.split("=", 1)[0]
        if flag in _LATER_FLAGS:
            raise NotImplementedError(
                f"{flag} is not ported yet: {_ITEM.format(_LATER_FLAGS[flag])}")
    if rest:
        build_parser().error(f"unrecognized arguments: {' '.join(rest)}")
    return args


def default_epochs(method: str) -> int:
    # `dawn.py:105-108`
    return 40 if method.lower() in ("randomk", "thresholdv") else 24


def _check_slice(args) -> None:
    if args.network in _LATER_NETWORKS:
        raise NotImplementedError(f"--network {args.network} is not ported yet: "
                                  f"{_ITEM.format(9)}")
    if args.network != "resnet9":
        raise ValueError(f"unknown network {args.network!r}")
    if args.method.lower() != "none" and args.compress == "none":
        raise ValueError(f"--method {args.method} requires --compress "
                         "layerwise|entiremodel|bucketed "
                         "(the reference silently trained dense here; we refuse instead)")


def _device(name: str) -> torch.device:
    if name == "cuda" and "LOCAL_RANK" in os.environ:
        name = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return mesh.resolve_device(name)


def run(args) -> dict:
    _check_slice(args)
    device = _device(args.device)
    # fp32 stays fp32, as in the JAX reference: no TF32 in convolutions or
    # the classifier matmul
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    comp = CompressionConfig(
        method=None if args.compress == "none" or args.method.lower() == "none" else args.method,
        granularity=args.compress if args.compress != "none" else "layerwise",
        mode=args.mode,
        ratio=args.ratio,
        threshold=args.threshold,
        qstates=args.qstates,
        block_size=args.block_size,
        bucket_mb=args.bucket_mb,
        wire_cap_ratio=args.wire_cap_ratio,
        transport=args.transport,
        dp_pods=args.dp_pods,
        hier_route_factor_ici=args.hier_route_factor_ici,
        hier_route_factor_dcn=args.hier_route_factor_dcn,
        error_feedback=args.error_feedback,
    )
    made_group = not torch.distributed.is_initialized()
    mesh.init_process_group(device)
    try:
        return _run(args, device, comp)
    finally:
        if made_group:
            mesh.destroy()


def _run(args, device: torch.device, comp: CompressionConfig) -> dict:
    world, rank = mesh.world(), mesh.rank()
    epochs = args.epochs if args.epochs is not None else default_epochs(args.method)
    bs = args.batch_size
    if bs % world:
        raise ValueError(f"batch_size {bs} not divisible by world size {world}")
    if rank == 0:
        print(f"world: {world} x {device}; network={args.network} compress={args.compress} "
              f"method={args.method} epochs={epochs}; cudnn.allow_tf32="
              f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
              f"{torch.backends.cuda.matmul.allow_tf32}")

    if args.synthetic:
        dataset = data.synthetic_cifar10(n_train=args.synthetic_n,
                                         n_test=max(args.synthetic_n // 4, bs))
    else:
        dataset = data.load_cifar10(args.data_dir)
    train_x = data.pad(dataset["train"]["data"])
    test_x = dataset["test"]["data"]
    train_batches = data.Batches(
        train_x, dataset["train"]["labels"], bs, shuffle=True, augment=True,
        drop_last=True, seed=args.seed, shard=(rank, world) if world > 1 else None)
    test_batches = data.Batches(test_x, dataset["test"]["labels"], bs,
                                shuffle=False, augment=False, drop_last=False)

    model = ResNet9(channels=scaled_channels(args.channels_scale), seed=args.seed,
                    device=device)
    params = param_leaves(model)
    steps_per_epoch = len(train_batches)
    ramp_ep = 5 if epochs > 5 else epochs / 2
    sched = piecewise_linear([0, ramp_ep, epochs], [0, args.peak_lr, 0])
    spe, bs32 = np.float32(steps_per_epoch), np.float32(bs)
    opt = SGD(lr=lambda step: sched(np.float32(step) / spe) / bs32,  # `dawn.py:142`
              momentum=args.momentum, nesterov=args.momentum > 0,
              weight_decay=5e-4 * bs)
    state = TrainState.create(model, opt.init(params), init_ef_state(params, comp),
                              seed=args.seed)
    apply_fn = make_normalizing_apply_fn(np.asarray(data.CIFAR10_MEAN) * 255.0,
                                         np.asarray(data.CIFAR10_STD) * 255.0)
    train_step = make_train_step(apply_fn, opt, comp, grad_scale=float(bs),
                                 clip_norm=args.clip_norm)
    eval_step = make_eval_step(apply_fn)

    table, tsv = TableLogger(), TSVLogger()
    timer = Timer(lambda: device_sync(device))
    summary: dict = {}
    for epoch in range(epochs):
        state, epoch_stats, acc = train_epoch(
            train_step, eval_step, state, train_batches, test_batches, timer, bs, device,
            rank=rank, world=world)
        train_time = epoch_stats["train time"]
        summary = {
            "epoch": epoch + 1,
            "lr": float(sched(epoch + 1)),
            **epoch_stats,
            "img/s": round(steps_per_epoch * bs / max(train_time, 1e-9), 1),
            "steps": acc.steps,
        }
        if rank == 0:
            table.append(summary)
            tsv.append(summary)
    if args.log_dir and rank == 0:
        tsv.save(args.log_dir)
    return summary


def main(argv: Optional[list] = None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
