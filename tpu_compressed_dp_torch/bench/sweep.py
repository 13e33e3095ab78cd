"""Compression-sweep benchmark driver (the paper's Fig. 3/4 protocol).

PyTorch-port counterpart of :mod:`tpu_compressed_dp.bench.sweep`, with the
same entry points, flags and record keys.  Per (method, ratio, granularity,
transport) grid point, dense baseline included, it measures

  * steady-state train-step throughput (images/sec and images/sec/chip) and
    MFU (``utils/flops``; omitted where the card's peak is unknown, as on
    the CPU);
  * the per-step gradient-sync payload (MB) split by the collective it
    rides, and the per-chip link traffic that implies at this world and at
    ``--project_devices`` (``utils/meters``: ``2(W-1)/W x`` for a ring
    all-reduce, ``(W-1) x`` for an all_gather, ``(W-1)/W x`` for an
    all_to_all), as GB/s at the measured step rate;
  * compression fractions (``sent_elems/dense`` and the wire-bit fraction);
  * with ``--phase_breakdown``, per-phase ms of the Top-K wire sync
    (``bench/phases.py``); with ``--predict``, the digital twin's price of
    the row (``twin/``) and its scale-out projection.

One JSON line per grid point on stdout (progress on stderr), optional TSV.
Runs on the card unless ``--device cpu``; alone it is one worker.  Under
``torchrun`` the world is the process group's: ``--devices`` must equal it,
every rank takes its rows of the one seeded batch, and rank 0 prints.
``--adaptive`` runs the closed-loop controller against every static rung
instead of the grid.  Records a port run writes belong in a directory of
their own: the twin's compute key has no device field.

Run: ``python -m tpu_compressed_dp_torch.bench.sweep --model resnet9 --methods
topk,randomk --ratios 0.001,0.01,0.1 --granularities layerwise,entiremodel``
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import itertools
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_compressed_dp_torch.models.common import param_leaves
from tpu_compressed_dp_torch.ops.compressors import canonical_name
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.parallel.dp import (CompressionConfig, init_comp_state,
                                                 init_ef_state)
from tpu_compressed_dp_torch.train.optim import SGD
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.train.step import make_train_step

__all__ = ["run_point", "run_adaptive_point", "run_sweep", "main", "attach_prediction",
           "PREDICT_WORLDS", "build_parser"]

#: the flagship projection worlds the --predict table prices
PREDICT_WORLDS = (64, 256, 1024, 4096)


def attach_prediction(rec: Dict, calib, *, pod_size: int = 64) -> Dict:
    """Add twin-modeled columns to one flat sweep record, in place.

    ``pred_step_ms`` is the calibrated twin's price for the record's own
    config (context compute anchor + priced comm); ``pred_err_frac`` its
    relative miss against the measured ``step_ms``; ``pred_err_bar_ms``
    the calibration's step-row RMS error scaled to the prediction.
    ``pred_step_ms_w<W>`` prices the SAME config projected to W chips
    (``W // pod_size`` pods, the row's compute held fixed, comm re-laid on
    the scaled schedule) for each W in :data:`PREDICT_WORLDS`.  Records the
    twin cannot price get ``pred_basis`` explaining why; a negative fitted
    compute anchor keeps its own-topology prediction but refuses the W
    projections (``None``)."""
    from tpu_compressed_dp_torch.twin.model import UncalibratedFabricError
    from tpu_compressed_dp_torch.twin.records import context_key, scaled_schedule, step_row

    row = step_row(rec, source="sweep", index=0)
    comm = calib.comm_ms_for(row)
    ctx = context_key(rec)
    if ctx in calib.contexts:
        rec["pred_basis"] = "context"
        compute = calib.contexts[ctx]
    else:
        # config never benchmarked: anchor compute on the measured step
        # (pred_err_frac then only scores the comm model)
        rec["pred_basis"] = "measured_anchor"
        compute = float(rec["step_ms"]) - comm
    pred = compute + comm
    rec["pred_step_ms"] = round(pred, 3)
    rec["pred_err_frac"] = round(
        (pred - float(rec["step_ms"])) / max(float(rec["step_ms"]), 1e-9), 5)
    rec["pred_err_bar_ms"] = round(calib.step_rms_frac * pred, 3)
    for w in PREDICT_WORLDS:
        if compute < 0.0:
            rec[f"pred_step_ms_w{w}"] = None
            continue
        pods = max(1, w // max(int(pod_size), 1))
        try:
            sched = scaled_schedule(rec, world=w, pods=pods)
            rec[f"pred_step_ms_w{w}"] = round(compute + calib.model.comm_ms(sched), 3)
        except UncalibratedFabricError:
            rec[f"pred_step_ms_w{w}"] = None
    return rec


def _build_model(name: str, image_size: int, num_classes: int, channels_scale: float,
                 device):
    """``(module, image size, classes)``: a CIFAR-family net of the dawn
    harness (fp32, scaled by ``channels_scale``) or an ImageNet ResNet
    (bf16, full width), seed 0."""
    from tpu_compressed_dp_torch.harness.dawn import MODELS as CIFAR_MODELS
    from tpu_compressed_dp_torch.harness.imagenet import ARCHS as IMAGENET_ARCHS

    if name in CIFAR_MODELS:
        return CIFAR_MODELS[name](channels_scale, torch.float32, 0, device), 32, 10
    if name in IMAGENET_ARCHS:
        if channels_scale != 1.0:
            # the ImageNet archs take --width, not a multiplier; building
            # full-width silently would record timings as if scaled
            raise ValueError(
                f"{name} does not support channels_scale (CIFAR-family only)")
        return (IMAGENET_ARCHS[name](num_classes=num_classes, dtype=torch.bfloat16, seed=0,
                                     device=device), image_size, num_classes)
    raise ValueError(
        f"unknown model {name!r}; known: {sorted(CIFAR_MODELS) + sorted(IMAGENET_ARCHS)}")


def apply_fn(model, x: torch.Tensor, train: bool, dropout=None) -> torch.Tensor:
    """The nets' apply on float inputs as given (the sweep feeds standard
    normal pixels, no normalisation)."""
    kw = {} if dropout is None else {"dropout": dropout}
    return model(x, train=train, **kw)


def _world(devices: Optional[int]) -> int:
    """The process group's world; ``devices`` must equal it when given."""
    world = mesh.world()
    if devices is not None and int(devices) != world:
        raise ValueError(f"--devices {devices} but the process group has {world} rank(s): "
                         "launch one process per worker (torchrun --nproc_per_node "
                         f"{devices})")
    return world


def _batch(bs: int, sz: int, ncls: int, world: int, device) -> Dict[str, torch.Tensor]:
    """This rank's rows of the one seeded global batch (``default_rng(0)``:
    standard normal NHWC pixels, uniform labels), split by rank in order."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((bs, sz, sz, 3), dtype=np.float32)
    y = rng.integers(0, ncls, size=(bs,), dtype=np.int32)
    r, per = mesh.rank(), bs // world
    rows = slice(r * per, (r + 1) * per)
    return {"input": torch.from_numpy(np.ascontiguousarray(x[rows])).to(device),
            "target": torch.from_numpy(y[rows].astype(np.int64)).to(device)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fp32() -> None:
    # fp32 stays fp32, as in the JAX reference: no TF32 in convolutions or
    # the classifier matmul
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def run_point(
    *,
    model: str = "resnet9",
    method: Optional[str] = None,
    granularity: str = "layerwise",
    mode: str = "simulate",
    transport: str = "allgather",
    ratio: float = 0.01,
    threshold: float = 1e-3,
    qstates: int = 255,
    block_size: int = 256,
    bucket_mb: float = 25.0,
    wire_cap_ratio: float = 0.05,
    shard_route_factor: float = 1.25,
    shard_return_factor: float = 1.25,
    dp_pods: int = 1,
    hier_route_factor_ici: float = 1.25,
    hier_route_factor_dcn: float = 1.25,
    rank: int = 4,
    error_feedback: bool = False,
    sync_overlap: int = 1,
    batch_size: int = 512,
    image_size: int = 128,
    num_classes: int = 1000,
    steps: int = 30,
    warmup: int = 3,
    devices: Optional[int] = None,
    project_devices: int = 32,
    channels_scale: float = 1.0,
    phase_breakdown: bool = False,
    device="cuda",
) -> Dict[str, float]:
    """Measure one grid point; returns a flat record (also JSON-serialisable).

    ``channels_scale`` shrinks the CIFAR-family nets (width multiplier) —
    for smoke runs of the record schema, not for real numbers.  Every rank
    of the process group runs the point; each returns the record (its own
    step time, the world's comm columns)."""
    from tpu_compressed_dp_torch.utils import flops
    from tpu_compressed_dp_torch.utils.meters import (per_chip_traffic_bytes,
                                                      per_fabric_traffic_bytes)

    device = mesh.resolve_device(device)
    _fp32()
    ndev = _world(devices)
    bs = batch_size if batch_size % ndev == 0 else (batch_size // ndev + 1) * ndev

    module, sz, ncls = _build_model(model, image_size, num_classes, channels_scale, device)
    params = param_leaves(module)
    opt = SGD(lr=0.01, momentum=0.9, weight_decay=5e-4)
    cfg = CompressionConfig(
        method=method, granularity=granularity, mode=mode, ratio=ratio,
        threshold=threshold, transport=transport, qstates=qstates, block_size=block_size,
        bucket_mb=bucket_mb, wire_cap_ratio=wire_cap_ratio,
        shard_route_factor=shard_route_factor, shard_return_factor=shard_return_factor,
        dp_pods=dp_pods, hier_route_factor_ici=hier_route_factor_ici,
        hier_route_factor_dcn=hier_route_factor_dcn, rank=rank,
        error_feedback=error_feedback, sync_overlap=sync_overlap)
    state = TrainState.create(module, opt.init(params), init_ef_state(params, cfg), seed=1,
                              comp=init_comp_state(params, cfg))
    train_step = make_train_step(apply_fn, opt, cfg, grad_scale=1.0)
    batch = _batch(bs, sz, ncls, ndev, device)

    # warm-up by time on the card (a fresh process's first steps run slow
    # for a while), by step count on the CPU, a synchronize per burst; every
    # rank runs as many bursts (the steps' collectives pair up)
    min_warm_s = 2.0 if device.type == "cuda" else 0.0
    t0 = time.perf_counter()
    done = 0
    while mesh.more_on_any_rank(done < warmup or time.perf_counter() - t0 < min_warm_s, device):
        for _ in range(8 if min_warm_s else 1):
            state, metrics = train_step(state, batch)
            done += 1
        _sync(device)

    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = train_step(state, batch)
    _sync(device)
    dt = time.perf_counter() - t0
    metrics = {k: float(v) for k, v in metrics.items()}

    images_per_sec = steps * bs / dt
    record: Dict[str, float] = {
        "model": model,
        "method": method or "none",
        "granularity": granularity,
        "mode": mode,
        "ratio": ratio,
        **({"rank": rank} if method is not None and
           canonical_name(method) == "powersgd" else {}),
        "error_feedback": bool(error_feedback),
        **({"sync_overlap": sync_overlap} if sync_overlap != 1 else {}),
        "devices": ndev,
        "batch": bs,
        "image_size": sz,
        "step_ms": round(dt / steps * 1e3, 3),
        "images_per_sec": round(images_per_sec, 1),
        "images_per_sec_per_chip": round(images_per_sec / ndev, 1),
    }
    # MFU: model-only FLOPs (3 x forward) at the measured step rate against
    # the card's bf16 peak, as the JAX record quotes it
    per_chip = 3.0 * flops.cnn_fwd_flops(module, (bs // ndev, sz, sz, 3), device) * steps / dt
    record["model_tflops_per_sec_per_chip"] = round(per_chip / 1e12, 3)
    u = flops.mfu(per_chip, device)
    if u is not None:
        record["mfu"] = round(u, 4)
    if channels_scale != 1.0:
        record["channels_scale"] = channels_scale
    if "comm/sent_bits" in metrics:
        payload_mb = metrics["comm/sent_bits"] / 8 / 1e6  # per worker, per step
        dense_mb = metrics["comm/dense_elems"] * 4 / 1e6
        psum_mb = metrics.get("comm/sent_bits_psum", 0.0) / 8 / 1e6
        ag_mb = metrics.get("comm/sent_bits_allgather", 0.0) / 8 / 1e6
        a2a_mb = metrics.get("comm/sent_bits_alltoall", 0.0) / 8 / 1e6
        ici_mb = metrics.get("comm/sent_bits_ici", 0.0) / 8 / 1e6
        dcn_mb = metrics.get("comm/sent_bits_dcn", 0.0) / 8 / 1e6
        rt_mb = metrics.get("comm/sent_bits_dcn_route", 0.0) / 8 / 1e6
        # the collective(s) the wire form rides: hier group bits mark the
        # two-level transport (a flat bucket beside them is 'mixed'); a2a
        # marks the sharded route stage (its return bills as allgather)
        flat_mb = psum_mb + ag_mb + a2a_mb
        transport_rode = (("hierarchical" if flat_mb == 0.0 else "mixed")
                          if ici_mb + dcn_mb > 0.0
                          else ("sharded" if psum_mb == 0.0 else "mixed")
                          if a2a_mb > 0.0
                          else "psum" if ag_mb == 0.0
                          else "all_gather" if psum_mb == 0.0 else "mixed")

        def fabric_mb(w: int) -> tuple:
            return per_fabric_traffic_bytes(psum_mb, ag_mb, w, a2a_mb, ici_mb, rt_mb,
                                            max(dcn_mb - rt_mb, 0.0), dp_pods)

        def gbps_per_chip(w: int) -> tuple:
            comp_gbps = sum(fabric_mb(w)) / 1e3 * (steps / dt)
            dense_gbps = per_chip_traffic_bytes(dense_mb, 0.0, w) / 1e3 * (steps / dt)
            return comp_gbps, dense_gbps

        comp_gbps, dense_gbps = gbps_per_chip(ndev)
        traffic_ici, traffic_dcn = fabric_mb(ndev)
        dense_elems = max(metrics["comm/dense_elems"], 1.0)
        record.update({
            "payload_mb_per_step": round(payload_mb, 4),
            "payload_mb_psum": round(psum_mb, 4),
            "payload_mb_allgather": round(ag_mb, 4),
            "payload_mb_alltoall": round(a2a_mb, 4),
            "payload_mb_ici": round(ici_mb, 4),
            "payload_mb_dcn": round(dcn_mb, 4),
            "dense_mb_per_step": round(dense_mb, 4),
            "transport": transport_rode,
            "sent_frac": round(metrics["comm/sent_elems"] / dense_elems, 5),
            "wire_frac": round(metrics["comm/sent_bits"] / (32.0 * dense_elems), 5),
            "allreduce_gbps_per_chip": round(comp_gbps, 3),
            "dense_allreduce_gbps_per_chip": round(dense_gbps, 3),
            # per-step per-chip link traffic at the run's world: the
            # rate-free quantity transports are compared on
            "per_chip_traffic_mb": round(traffic_ici + traffic_dcn, 4),
            "per_chip_traffic_mb_ici": round(traffic_ici, 4),
            "per_chip_traffic_mb_dcn": round(traffic_dcn, 4),
            "num_collectives": metrics["comm/num_collectives"],
        })
        if dp_pods > 1:
            record["dp_pods"] = dp_pods
        if "comm/shard_overflow" in metrics:
            record["shard_overflow"] = metrics["comm/shard_overflow"]
        # the W-chip per-chip link traffic at the MEASURED step rate: what
        # the fabric must sustain for compression to keep hiding behind
        # compute (the step time is held at its measured value)
        w = int(project_devices)
        if w > 1:
            p_gbps, p_dense_gbps = gbps_per_chip(w)
            record.update({
                "projected_devices": float(w),
                "projected_allreduce_gbps_per_chip": round(p_gbps, 6),
                "projected_dense_allreduce_gbps_per_chip": round(p_dense_gbps, 6),
            })
    if phase_breakdown:
        # the phase chains are the element Top-K wire sync: breakdown
        # columns exist for topk wire points only
        if method is not None and canonical_name(method) == "topk" and mode == "wire":
            from tpu_compressed_dp_torch.bench.phases import phase_breakdown_cols
            from tpu_compressed_dp_torch.ops import kernels
            from tpu_compressed_dp_torch.ops.compressors import topk_keep_count

            n_flat = sum(p.numel() for p in params.values())
            record.update(phase_breakdown_cols(cfg, n_flat, topk_keep_count(n_flat, ratio),
                                               opt, params, max(steps, 2), device))
            record["pallas_mode"] = kernels.pallas_mode()
        elif mesh.rank() == 0:
            print(f"# phase_breakdown: skipped for {method}/{mode} (the chains cover topk "
                  "wire points)", file=sys.stderr)
    return record


def run_adaptive_point(
    *,
    model: str = "resnet9",
    method: str = "topk",
    granularity: str = "layerwise",
    mode: str = "simulate",
    transport: str = "allgather",
    ratio: float = 0.25,
    rank: int = 4,
    error_feedback: bool = False,
    sync_overlap: int = 1,
    batch_size: int = 512,
    image_size: int = 128,
    num_classes: int = 1000,
    windows: int = 6,
    window: int = 2,
    rungs: Optional[tuple] = None,
    budget_ms: float = 0.0,
    bw_mbps: float = 100.0,
    deadband: float = 0.25,
    devices: Optional[int] = None,
    channels_scale: float = 1.0,
    device="cuda",
) -> Dict:
    """Run the closed-loop controller on one (method, granularity) point and
    bill it against every static rung — the adaptive-vs-best-static record.

    The measured half runs ``windows`` decision windows of ``window`` steps
    through the rung-switching loop (one step per visited rung, ticks keyed
    to applied updates, PowerSGD warm-column migration on rank switches).
    The comparison half times ``window`` steps at EVERY rung from a fresh
    state and picks the best static point: the least-compressed rung whose
    modeled comm fits the hideable budget.  ``budget_ms=0`` derives the
    budget from the measured step wall time scaled by the overlap
    schedule's hideable byte fraction, as the harnesses do."""
    from tpu_compressed_dp_torch.control import (ControlConfig, Controller, build_ladder,
                                                 comp_for_rung, init_control_state,
                                                 ladder_knob, migrate_comp_state)
    from tpu_compressed_dp_torch.harness.loop import hideable_fraction

    device = mesh.resolve_device(device)
    _fp32()
    ndev = _world(devices)
    bs = batch_size if batch_size % ndev == 0 else (batch_size // ndev + 1) * ndev

    module, sz, ncls = _build_model(model, image_size, num_classes, channels_scale, device)
    initial = copy.deepcopy(module)
    params = param_leaves(module)
    opt = SGD(lr=0.01, momentum=0.9, weight_decay=5e-4)
    base = CompressionConfig(method=method, granularity=granularity, mode=mode, ratio=ratio,
                             transport=transport, rank=rank, error_feedback=error_feedback,
                             sync_overlap=sync_overlap)
    canon = canonical_name(method)
    ctrl = ControlConfig(
        method=canon, rungs=tuple(rungs) if rungs else build_ladder(canon, ratio, rank),
        window=window, deadband=deadband, signal="modeled", bandwidth_mbps=bw_mbps,
        budget_ms=budget_ms)
    controller = Controller(ctrl)
    knob = ladder_knob(canon)
    hide_frac = hideable_fraction(params, base)
    batch = _batch(bs, sz, ncls, ndev, device)

    step_cache: Dict[int, object] = {}

    def step_for(rung: int):
        if rung not in step_cache:
            step_cache[rung] = make_train_step(apply_fn, opt, comp_for_rung(base, ctrl, rung),
                                               grad_scale=1.0)
        return step_cache[rung]

    def fresh_state(rung: int, model=None):
        # the static half starts every rung from the initial weights
        m = model if model is not None else copy.deepcopy(initial)
        p = param_leaves(m)
        rcfg = comp_for_rung(base, ctrl, rung)
        return TrainState.create(m, opt.init(p), init_ef_state(p, rcfg), seed=1,
                                 comp=init_comp_state(p, rcfg),
                                 control=init_control_state(ctrl))

    def timed(state, train_step):
        t0 = time.perf_counter()
        for _ in range(window):
            state, m = train_step(state, batch)
        _sync(device)
        return state, {k: float(v) for k, v in m.items()}, (
            time.perf_counter() - t0) / window * 1e3

    # ---------------------------------------------------- adaptive half
    state = fresh_state(0, module)
    window_trace: List[Dict] = []
    adaptive_bits = 0.0
    for w in range(windows):
        rung = int(state.control.rung)
        train_step = step_for(rung)
        entered = len(window_trace) == 0 or window_trace[-1]["rung"] != rung
        if entered:
            # first entry into this rung: one untimed step (it still counts
            # as an applied update for the tick below)
            state, _ = train_step(state, batch)
            _sync(device)
        state, metrics, step_ms = timed(state, train_step)
        bits = metrics.get("comm/sent_bits", 0.0)
        signals = controller.window_signals(mean_bits=bits, compute_ms=step_ms,
                                            hideable_fraction=hide_frac)
        new_control, decisions = controller.tick(state.control, applied=int(state.step),
                                                 signals=signals)
        state = dataclasses.replace(state, control=new_control)
        new_rung = int(new_control.rung)
        if new_rung != rung and knob == "rank":
            state = dataclasses.replace(state, comp=migrate_comp_state(
                state.comp, param_leaves(state.model), comp_for_rung(base, ctrl, rung),
                comp_for_rung(base, ctrl, new_rung)))
        dec = decisions[0] if decisions else None
        adaptive_bits += bits * (window + (1 if entered else 0))
        window_trace.append({
            "window": w, "rung": rung,
            "value": ctrl.rungs[rung],
            "step_ms": round(step_ms, 3),
            "bits_per_update": bits,
            "comm_ms": round(signals.comm_ms, 4),
            "budget_ms": round(signals.budget_ms, 4),
            "direction": dec.direction if dec else None,
            "rung_to": new_rung,
        })
    # ------------------------------------------------------ static half
    static_rungs: List[Dict] = []
    for rung in range(len(ctrl.rungs)):
        s = fresh_state(rung)
        train_step = step_for(rung)
        s, _ = train_step(s, batch)
        _sync(device)
        s, m, step_ms = timed(s, train_step)
        bits = m.get("comm/sent_bits", 0.0)
        sig = controller.window_signals(mean_bits=bits, compute_ms=step_ms,
                                        hideable_fraction=hide_frac)
        static_rungs.append({
            "rung": rung, "value": ctrl.rungs[rung],
            "step_ms": round(step_ms, 3),
            "bits_per_update": bits,
            "comm_ms": round(sig.comm_ms, 4),
            "budget_ms": round(sig.budget_ms, 4),
            "fits_budget": sig.comm_ms <= sig.budget_ms,
        })
    fitting = [r for r in static_rungs if r["fits_budget"]]
    best = fitting[0] if fitting else static_rungs[-1]
    n_updates = sum(window + (1 if i == 0 or window_trace[i - 1]["rung"] != t["rung"] else 0)
                    for i, t in enumerate(window_trace))
    best_static_bits = best["bits_per_update"] * n_updates
    final_rung = int(state.control.rung)
    record: Dict = {
        "model": model, "method": canon, "granularity": granularity,
        "mode": mode, "adaptive": True, "knob": knob,
        "rungs": list(ctrl.rungs), "window": window, "windows": windows,
        "deadband": deadband, "bw_mbps": bw_mbps,
        "budget_ms": budget_ms,
        "error_feedback": bool(error_feedback),
        "devices": ndev, "batch": bs,
        "window_trace": window_trace,
        "static_rungs": static_rungs,
        "best_static": {"rung": best["rung"], "value": best["value"]},
        "final_rung": final_rung,
        "final_value": ctrl.rungs[final_rung],
        "decisions": int(state.control.decisions),
        "updates": n_updates,
        "adaptive_billed_bits": adaptive_bits,
        "best_static_billed_bits": best_static_bits,
        "billed_bits_ratio": round(
            adaptive_bits / best_static_bits, 4) if best_static_bits else None,
        "converged_to_best_static": final_rung == best["rung"],
    }
    if channels_scale != 1.0:
        record["channels_scale"] = channels_scale
    return record


#: the caveats the TSV's header carries (``#`` lines, skipped on parse)
TSV_CAVEATS = (
    "# transport: the collective the method's WIRE form rides; for"
    " mode=simulate rows this is COUNTERFACTUAL — simulate psums"
    " full-size dense tensors and the column names what the wire"
    " payload WOULD ride (payload/wire_frac columns likewise bill"
    " the wire form).  mode=wire rows bill measured payload bytes.\n"
    "# projected_*: W-chip per-chip link traffic at the MEASURED"
    " step rate (compute-bound-scaling assumption: step time held"
    " at its measured value; collectives lengthening the step are"
    " invisible to a single-chip measurement).\n")


def run_sweep(args) -> List[Dict[str, float]]:
    methods = [m.strip() for m in args.methods.split(",") if m.strip()]
    ratios = [float(r) for r in args.ratios.split(",")]
    grans = [g.strip() for g in args.granularities.split(",") if g.strip()]
    transports = [t.strip() for t in args.transports.split(",") if t.strip()]
    records = []
    lead = mesh.rank() == 0

    def note(msg: str) -> None:
        if lead:
            print(msg, file=sys.stderr)

    calib = None
    if getattr(args, "predict", False):
        from tpu_compressed_dp_torch.twin import calibration_rows, fit

        calib = fit(calibration_rows(args.twin_records))
        note(f"# twin: fitted {calib.n_step_rows} step + {calib.n_phase_rows} phase rows "
             f"from {args.twin_records} (step rms {calib.step_rms_frac:.1%})")

    def emit(rec):
        if calib is not None and "step_ms" in rec and "transport" in rec:
            attach_prediction(rec, calib, pod_size=args.twin_pod_size)
        records.append(rec)
        if lead:
            print(json.dumps(rec), flush=True)

    if getattr(args, "adaptive", False):
        # closed-loop comparison instead of the static grid: one nested
        # record per (method, granularity)
        from tpu_compressed_dp_torch.control.config import TUNABLE_METHODS

        ranks = [int(r) for r in args.ranks.split(",") if r.strip()]
        rungs = None
        if args.adaptive_rungs:
            rungs = tuple(float(v) for v in args.adaptive_rungs.split(","))
        for method, gran in itertools.product(methods, grans):
            canon = canonical_name(method)
            if canon not in TUNABLE_METHODS:
                note(f"# skipping {method}: no ladder knob (tunable: "
                     f"{','.join(TUNABLE_METHODS)})")
                continue
            note(f"# adaptive: {method}/{gran}")
            emit(run_adaptive_point(
                model=args.model, method=method, granularity=gran,
                mode=args.mode, transport=transports[0], ratio=ratios[0],
                rank=ranks[0], error_feedback=args.error_feedback,
                sync_overlap=args.overlap, batch_size=args.batch_size,
                image_size=args.image_size, num_classes=args.num_classes,
                windows=args.adaptive_windows, window=args.adaptive_window,
                rungs=rungs, budget_ms=args.adaptive_budget_ms,
                bw_mbps=args.adaptive_bw_mbps, deadband=args.adaptive_deadband,
                devices=args.devices, channels_scale=args.channels_scale,
                device=args.device))
        if args.tsv:
            note("# --tsv skipped: adaptive records are nested (window_trace/static_rungs); "
                 "use the JSON lines")
        return records

    common = dict(
        model=args.model, batch_size=args.batch_size, image_size=args.image_size,
        num_classes=args.num_classes, steps=args.steps, warmup=args.warmup,
        devices=args.devices, project_devices=args.project_devices,
        channels_scale=args.channels_scale, wire_cap_ratio=args.wire_cap_ratio,
        shard_route_factor=args.shard_route_factor,
        shard_return_factor=args.shard_return_factor, dp_pods=args.dp_pods,
        hier_route_factor_ici=args.hier_route_factor_ici,
        hier_route_factor_dcn=args.hier_route_factor_dcn, mode=args.mode,
        threshold=args.threshold, qstates=args.qstates, block_size=args.block_size,
        bucket_mb=args.bucket_mb, error_feedback=args.error_feedback,
        sync_overlap=args.overlap, phase_breakdown=args.phase_breakdown, device=args.device,
    )
    note(f"# dense baseline: {args.model}")
    emit(run_point(method=None, **{**common, "error_feedback": False,
                                   "phase_breakdown": False}))

    from tpu_compressed_dp_torch.ops.wire_sharded import SHARDED_METHODS

    ranks = [int(r) for r in args.ranks.split(",") if r.strip()]
    for method, gran in itertools.product(methods, grans):
        canon = canonical_name(method)
        # the sweep axis is method-specific: k-ratios for the sparsifiers,
        # the low-rank r for powersgd, a single point for everything else
        if canon in ("topk", "randomk", "blocktopk"):
            pts = [("ratio", r) for r in ratios]
        elif canon == "powersgd":
            pts = [("rank", r) for r in ranks]
        else:
            pts = [(None, None)]
        # EF composes with sparsifiers only: quantizers sweep with EF off
        kw = common
        if canon in ("terngrad", "qsgd") and args.error_feedback:
            kw = {**common, "error_feedback": False}
        # the transports axis only differentiates the index-carrying
        # sparsifiers; other methods run once, at the first transport
        m_transports = transports if canon in SHARDED_METHODS else transports[:1]
        for axis, val in pts:
            for tr in m_transports:
                label = f"{method}/{gran}" + (
                    f"/k={val}" if axis == "ratio"
                    else f"/r={val}" if axis == "rank" else "") + (
                    f"/{tr}" if len(m_transports) > 1 else "")
                note(f"# {label}")
                emit(run_point(method=method, granularity=gran, transport=tr,
                               **({axis: val} if axis else {}), **kw))
    if args.tsv and lead:
        os.makedirs(os.path.dirname(os.path.abspath(args.tsv)), exist_ok=True)
        keys = sorted({k for r in records for k in r})
        with open(args.tsv, "w") as f:
            f.write(TSV_CAVEATS)
            f.write("\t".join(keys) + "\n")
            for r in records:
                f.write("\t".join(str(r.get(k, "")) for k in keys) + "\n")
        note(f"# wrote {args.tsv}")
    if calib is not None and lead:
        # the scale-out table, human-shaped (the pred_step_ms_w* columns)
        note(f"# twin projection, modeled step ms (pods = W // {args.twin_pod_size}):")
        cols = "".join(f"{f'W={w}':>12s}" for w in PREDICT_WORLDS)
        note(f"# {'config':40s}{cols}")
        for r in records:
            if f"pred_step_ms_w{PREDICT_WORLDS[0]}" not in r:
                continue
            name = f"{r.get('method')}/{r.get('granularity')}/{r.get('transport')}"
            vals = "".join(
                f"{r.get(f'pred_step_ms_w{w}'):>12.1f}"
                if r.get(f"pred_step_ms_w{w}") is not None else f"{'n/a':>12s}"
                for w in PREDICT_WORLDS)
            note(f"# {name:40s}{vals}")
    return records


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="compression sweep benchmark")
    p.add_argument("--model", default="resnet9")
    p.add_argument("--methods", default="topk,randomk",
                   help="comma list; full set: topk,blocktopk,randomk,"
                        "thresholdv,adaptive_threshold,terngrad,qsgd")
    p.add_argument("--ratios", default="0.001,0.01,0.1",
                   help="k values for topk/blocktopk/randomk (paper: 0.1%%,1%%,10%%)")
    p.add_argument("--ranks", default="1,2,4",
                   help="r values for powersgd (its sweep axis instead of k)")
    p.add_argument("--granularities", default="layerwise,entiremodel")
    p.add_argument("--transports", default="allgather",
                   help="comma list of allgather,sharded,hierarchical — the index-carrying "
                        "sparsifiers run once per transport (sharded = the owner-sharded "
                        "sparse reduce; hierarchical = the two-level dense-pod + sparse "
                        "cross-pod reduce over a dp_pods x dp_chips view of the world); "
                        "other methods are unaffected")
    p.add_argument("--mode", default="simulate", choices=["simulate", "wire"])
    p.add_argument("--threshold", type=float, default=1e-3, help="V for thresholdv")
    p.add_argument("--qstates", type=int, default=255)
    p.add_argument("--block_size", type=int, default=256)
    p.add_argument("--bucket_mb", type=float, default=25.0)
    p.add_argument("--error_feedback", action="store_true")
    p.add_argument("--overlap", type=int, default=1,
                   help="sync_overlap chunk count for every grid point "
                        "(parallel/overlap.py; 1 = single-dispatch sync)")
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--image_size", type=int, default=128,
                   help="input size for the ImageNet archs (CIFAR models fix 32)")
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--devices", type=int, default=None,
                   help="workers; must equal the process group's world (torchrun "
                        "--nproc_per_node N), 1 alone")
    p.add_argument("--project_devices", type=int, default=32,
                   help="W for the analytic W-chip ring allreduce GB/s projection columns "
                        "(0 disables)")
    p.add_argument("--channels_scale", type=float, default=1.0,
                   help="width multiplier for the CIFAR-family nets (smoke runs only; real "
                        "numbers want 1.0)")
    p.add_argument("--wire_cap_ratio", type=float, default=0.05,
                   help="wire thresholdv/adaptive_threshold transport capacity (fraction of "
                        "elements)")
    p.add_argument("--shard_route_factor", type=float, default=1.25,
                   help="sharded transport per-destination bucket capacity, in units of k/W")
    p.add_argument("--shard_return_factor", type=float, default=1.25,
                   help="sharded transport return-union buffer capacity, in units of k/W")
    p.add_argument("--dp_pods", type=int, default=1,
                   help="hierarchical transport: pod count P of the dp_pods x dp_chips view "
                        "(must divide the world; 1 = flat)")
    p.add_argument("--hier_route_factor_ici", type=float, default=1.25,
                   help="hierarchical transport intra-pod union capacity, in units of k")
    p.add_argument("--hier_route_factor_dcn", type=float, default=1.25,
                   help="hierarchical transport inter-pod bucket capacity, in units of "
                        "slab/P")
    p.add_argument("--tsv", type=str, default=None)
    p.add_argument("--phase_breakdown", action="store_true",
                   help="add per-phase ms columns (phase_compress_ms / route / reduce / "
                        "return / ef / update, plus ici_reduce + recompress for "
                        "hierarchical) to topk wire grid points, each stage of the wire "
                        "sync timed at the model's flat gradient size (bench/phases.py); "
                        "the compress/route stages ride the live --pallas dispatch, so an "
                        "off-vs-auto row pair prices the kernels")
    p.add_argument("--pallas", default=None, choices=["auto", "off", "force"],
                   help="pin ops/kernels.pallas_mode() for the whole sweep (default: the "
                        "process default, auto; off runs every kernel's plain version); "
                        "recorded as the pallas_mode column on breakdown rows")
    p.add_argument("--adaptive", action="store_true",
                   help="closed-loop controller comparison instead of the static grid: per "
                        "(method, granularity), run the rung-switching control loop for "
                        "--adaptive_windows decision windows and bill it against every "
                        "static rung (control/)")
    p.add_argument("--adaptive_windows", type=int, default=6,
                   help="decision windows to run the control loop for")
    p.add_argument("--adaptive_window", type=int, default=2,
                   help="steps (applied updates) per decision window")
    p.add_argument("--adaptive_rungs", type=str, default=None,
                   help="explicit comma ladder (ratios, or ranks for powersgd); default "
                        "build_ladder anchored at --ratios[0] / --ranks[0]")
    p.add_argument("--adaptive_budget_ms", type=float, default=0.0,
                   help="pinned hideable-comm budget per update; 0 derives it from "
                        "measured step time x the overlap schedule's hideable byte fraction")
    p.add_argument("--adaptive_bw_mbps", type=float, default=100.0,
                   help="modeled-signal link bandwidth (MB/s) for billed-bits -> comm-ms "
                        "conversion")
    p.add_argument("--adaptive_deadband", type=float, default=0.25,
                   help="controller hysteresis band around the budget")
    p.add_argument("--predict", action="store_true",
                   help="price every row through the calibrated digital twin (twin/): adds "
                        "pred_step_ms/pred_err_frac (+/- pred_err_bar_ms) next to the "
                        "measured columns and a pred_step_ms_w{64,256,1024,4096} scale-out "
                        "projection per row")
    p.add_argument("--twin_records", type=str, default=".",
                   help="directory with the BENCH_r*/MULTICHIP_r* records the twin "
                        "calibrates from (--predict)")
    p.add_argument("--twin_pod_size", type=int, default=64,
                   help="chips per pod assumed by the W-projection columns "
                        "(pods = W // pod_size)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises where CUDA is missing) or cpu")
    return p


def main(argv: Optional[list] = None):
    from tpu_compressed_dp_torch.harness.loop import local_device
    from tpu_compressed_dp_torch.ops import kernels

    args = build_parser().parse_args(argv)
    device = local_device(args.device)
    args.device = str(device)
    made = False
    if not torch.distributed.is_initialized() and "WORLD_SIZE" in os.environ:
        # torchrun: one process per worker, the world the environment's
        mesh.init_process_group(device)
        made = True
    prev = kernels.pallas_mode()
    if args.pallas:
        kernels.set_pallas_mode(args.pallas)
    try:
        return run_sweep(args)
    finally:
        kernels.set_pallas_mode(prev)
        if made:
            mesh.destroy()


if __name__ == "__main__":
    main()
