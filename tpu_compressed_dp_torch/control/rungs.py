"""The discrete rung ladder: mapping ladder positions to sync variants.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.control.rungs`.  The
keep count (Top-K) and the factor shapes (PowerSGD) are fixed when a sync
is built, so the controller walks a small static ladder of rungs.  Each
rung is a full :class:`~tpu_compressed_dp_torch.parallel.dp.CompressionConfig`
(:func:`comp_for_rung`), and the harness keeps one built train step per
visited rung (the ``step_cache`` that ``--ratio_warmup_epochs`` uses).

Ratio rungs (topk/blocktopk/randomk) need no state surgery: the EF
residual is dense and ratio-independent, and those methods carry no
compressor state.  Rank rungs (powersgd) resize the warm-start ``Q``
factors — :func:`migrate_comp_state` re-derives the state at the new rank
and copies the overlapping warm columns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from tpu_compressed_dp_torch.control.config import (ControlConfig, RANK_METHODS,
                                                    RATIO_METHODS)
from tpu_compressed_dp_torch.parallel.dp import CompressionConfig, init_comp_state

__all__ = ["ladder_knob", "build_ladder", "comp_for_rung", "migrate_comp_state",
           "rung_value", "assert_ladder_traceable"]


def ladder_knob(method: str) -> str:
    """Which :class:`CompressionConfig` field the ladder drives:
    ``'ratio'`` or ``'rank'``."""
    if method in RATIO_METHODS:
        return "ratio"
    if method in RANK_METHODS:
        return "rank"
    raise ValueError(f"no ladder knob for method {method!r}")


def build_ladder(method: str, base_ratio: float, base_rank: int,
                 *, depth: int = 5) -> Tuple[float, ...]:
    """Default descending ladder anchored at the CLI-configured knob: ratio
    methods halve per rung (stopping below 1e-3), powersgd halves the rank
    (floored at 1).  Rung 0 is the configured static value."""
    if ladder_knob(method) == "ratio":
        rungs, r = [], float(base_ratio)
        for _ in range(depth):
            rungs.append(r)
            r = r / 2.0
            if r < 1e-3:
                break
        return tuple(rungs)
    rungs, rk = [], int(base_rank)
    while rk >= 1 and len(rungs) < depth:
        rungs.append(float(rk))
        if rk == 1:
            break
        rk = max(1, rk // 2)
    return tuple(rungs)


def rung_value(cfg: ControlConfig, rung: int) -> float:
    """The knob value at a ladder position (bounds-checked)."""
    if not (0 <= rung < len(cfg.rungs)):
        raise ValueError(f"rung {rung} out of range for ladder {cfg.rungs}")
    return cfg.rungs[rung]


def comp_for_rung(base: CompressionConfig, cfg: ControlConfig, rung: int) -> CompressionConfig:
    """The compression config a ladder position builds — the step-cache
    key the harness builds sync variants from."""
    val = rung_value(cfg, rung)
    if ladder_knob(cfg.method) == "ratio":
        return dataclasses.replace(base, ratio=val)
    return dataclasses.replace(base, rank=int(val))


def migrate_comp_state(comp: Any, grads_like: Any, old: CompressionConfig,
                       new: CompressionConfig, *, seed: int = 0) -> Any:
    """Carry the PowerSGD warm start across a rank rung switch: re-derive the
    state at the NEW rank with :func:`init_comp_state` (the same seed on
    every rank) and copy the first ``min(r_old, r_new)`` warm columns where
    a group exists at both ranks.  Stateless methods and no-op switches
    pass through unchanged."""
    if comp == () or old.rank == new.rank:
        return comp
    fresh = init_comp_state(grads_like, new, seed=seed)
    if fresh == ():
        return fresh
    out = {}
    for qk, q_new in fresh.items():
        q_old = comp.get(qk) if isinstance(comp, dict) else None
        if q_old is None or q_old.shape[:-1] != q_new.shape[:-1]:
            out[qk] = q_new
            continue
        r_copy = min(q_old.shape[-1], q_new.shape[-1])
        out[qk] = torch.cat([q_old[..., :r_copy].to(q_new.device), q_new[..., r_copy:]],
                            dim=-1)
    return out


def assert_ladder_traceable(cfg: ControlConfig) -> None:
    """Harness-start check: every rung builds a valid config
    (``CompressionConfig.__post_init__`` validates ranges), so a bad ladder
    fails at launch, not at the first rung switch mid-run."""
    base = CompressionConfig(method=cfg.method)
    for i in range(len(cfg.rungs)):
        comp_for_rung(base, cfg, i)
