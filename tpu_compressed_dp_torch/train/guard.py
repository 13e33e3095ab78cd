"""The step guard: a cross-worker finiteness vote and dynamic loss scaling.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.train.guard`.  Error
feedback and PowerSGD's warm starts carry state from step to step, so one
nonfinite gradient absorbed into the residual replays forever.  Every step
the guard:

  * counts this rank's nonfinite loss and gradients and takes the
    workers' **vote**: one ``all_reduce`` of the nonfinite counts over the
    vote group (:func:`finite_vote`).  The sum is symmetric, so every rank
    reads the same verdict and takes the same branch;
  * on a bad step **skips** the update: the step (``train/step.py``,
    ``train/lm_step.py``, ``train/pp_step.py``) leaves the parameters,
    momentum and BatchNorm statistics as they were, and the sync engines
    (``parallel/dp.py``) hand back the EF residual and compressor state
    they were given, while the **dynamic loss scale** backs off;
  * on good steps regrows the scale after ``growth_interval`` successes in
    a row (loss scaling on the 16-bit float paths, the identity on fp32);
  * keeps the streak of skipped steps in :class:`GuardState`; past
    ``max_consecutive_skips`` :func:`check_guard_metrics` raises
    :class:`GuardExceeded`.

The port reads the verdict on the host once a step (its parameters and
buffers are updated in place, where the JAX step selects between the old
and new trees), so the guard's state machine runs on the host, in
float32 and int32 numpy scalars that follow the JAX arithmetic bit for bit.

The three train steps share the step protocol through :func:`vet` (between
the backward pass and the sync: injection, vote, unscale) and
:func:`finish` (after the sync: the transition and the metrics); each step
itself skips its optimizer on a veto.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.utils import chaos as chaos_mod

__all__ = [
    "GuardConfig", "GuardState", "GuardExceeded", "init_guard_state",
    "tree_all_finite", "finite_vote", "update_guard", "guard_metrics",
    "check_guard_metrics", "worker_index", "guard_to_dict", "guard_from_dict",
    "schedule_step", "loss_scale_of", "scale_objective", "check_state", "check_chaos_worker",
    "needs_whole_backward", "vet", "finish",
]


class GuardExceeded(RuntimeError):
    """Raised on the host when the streak of skipped steps passes
    ``GuardConfig.max_consecutive_skips``: the run is wedged."""


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """The JAX ``GuardConfig``'s fields, defaults and checks.

    init_scale:            starting loss scale (with ``loss_scaling``)
    backoff:               multiplier on a nonfinite step
    growth:                multiplier after ``growth_interval`` good steps
    growth_interval:       good steps in a row before the scale regrows
    max_consecutive_skips: :func:`check_guard_metrics` raises past this
    loss_scaling:          False pins the scale to 1.0 (fp32)
    lr_rewind:             schedules read the count of applied updates
                           (:func:`schedule_step`)
    """

    init_scale: float = 2.0 ** 15
    backoff: float = 0.5
    growth: float = 2.0
    growth_interval: int = 200
    max_consecutive_skips: int = 25
    loss_scaling: bool = True
    lr_rewind: bool = True

    def __post_init__(self):
        if not (0.0 < self.backoff < 1.0):
            raise ValueError(f"backoff must be in (0, 1), got {self.backoff}")
        if self.growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {self.growth}")
        if self.growth_interval < 1:
            raise ValueError(f"growth_interval must be >= 1, got {self.growth_interval}")
        if self.init_scale < 1.0:
            raise ValueError(f"init_scale must be >= 1, got {self.init_scale} "
                             "(the scale is clamped to >= 1 by backoff anyway)")
        if self.max_consecutive_skips < 1:
            raise ValueError(f"max_consecutive_skips must be >= 1, got "
                             f"{self.max_consecutive_skips}")

    @classmethod
    def for_dtype(cls, dtype, **kw) -> "GuardConfig":
        """Loss scaling on the 16-bit float paths, the identity on fp32 (so
        the guarded fp32 step is bitwise the unguarded one)."""
        dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))
        scaling = dt.is_floating_point and torch.finfo(dt).bits <= 16
        return cls(loss_scaling=kw.pop("loss_scaling", scaling), **kw)


@dataclasses.dataclass(frozen=True)
class GuardState:
    """The guard's carry, the same on every rank (the vote makes it so):
    ``loss_scale`` a float32 scalar >= 1, the rest int32 scalars."""

    loss_scale: np.float32     # the dynamic loss scale
    good_steps: np.int32       # good steps in a row since the last scale event
    skips: np.int32            # skipped steps in a row (the streak)
    total_skipped: np.int32    # skipped steps in all
    last_good_step: np.int32   # the step counter after the last applied update


def init_guard_state(cfg: Optional[GuardConfig]) -> Any:
    """A fresh :class:`GuardState` (``()`` when the guard is off)."""
    if cfg is None:
        return ()
    zero = np.int32(0)
    return GuardState(np.float32(cfg.init_scale if cfg.loss_scaling else 1.0),
                      zero, zero, zero, zero)


def guard_to_dict(gs: GuardState) -> Dict[str, torch.Tensor]:
    """The state as 0-d tensors (float32 / int32), for the checkpoint."""
    return {f.name: torch.tensor(getattr(gs, f.name)) for f in dataclasses.fields(gs)}


def guard_from_dict(d: Dict[str, Any]) -> GuardState:
    def host(v):
        return v.item() if isinstance(v, torch.Tensor) else v

    return GuardState(np.float32(host(d["loss_scale"])), np.int32(host(d["good_steps"])),
                      np.int32(host(d["skips"])), np.int32(host(d["total_skipped"])),
                      np.int32(host(d["last_good_step"])))


def loss_scale_of(cfg: Optional[GuardConfig], gs: Any) -> float:
    """The scale the backward pass runs at: the state's with loss scaling,
    1.0 otherwise (unguarded or fp32)."""
    if cfg is None or not cfg.loss_scaling:
        return 1.0
    return float(gs.loss_scale)


def _all_finite(t: torch.Tensor) -> torch.Tensor:
    # one reduction pass and no element-sized mask: NaN propagates through
    # min and max, and an Inf is the max or the min
    if t.numel() == 0:
        return torch.ones((), dtype=torch.bool, device=t.device)
    lo, hi = torch.aminmax(t.detach().reshape(-1))
    return torch.isfinite(lo) & torch.isfinite(hi)


def tree_all_finite(*trees: Any) -> torch.Tensor:
    """A 0-d bool tensor: every float tensor of every tree (a tensor, a dict
    of tensors, or a list of them) is finite; integer tensors are skipped.
    Reduces one tensor at a time, so the transient is a scalar a leaf."""
    ok = None
    for tree in trees:
        leaves = (tree.values() if isinstance(tree, dict)
                  else [tree] if isinstance(tree, torch.Tensor) else tree)
        for leaf in leaves:
            if not leaf.is_floating_point():
                continue
            f = _all_finite(leaf)
            ok = f if ok is None else ok & f
    return torch.ones((), dtype=torch.bool) if ok is None else ok


def finite_vote(local_ok: torch.Tensor, group=None) -> bool:
    """The workers' verdict, read on the host: ``True`` iff every rank of
    ``group`` (``None``: the default group) is finite.  One ``all_reduce``
    of the int32 nonfinite counts, so every rank reads the same verdict."""
    bad = (~local_ok).to(torch.int32).reshape(1)
    if mesh.size(group) > 1:
        dist.all_reduce(bad, group=group)
    return int(bad.item()) == 0


def worker_index(group=None) -> int:
    """This rank's index among the compression workers of ``group`` (the
    JAX ``worker_index`` over the sync axes, row-major): the coordinate
    chaos injection targets."""
    return mesh.group_rank(group)


def schedule_step(cfg: Optional[GuardConfig], gs: Any, new_step: int) -> int:
    """The step schedule-valued hyper-parameters are evaluated at: ``new_step
    - total_skipped`` (applied updates) with ``lr_rewind``; ``new_step``
    when the guard is off.  ``gs`` is the pre-step state."""
    if cfg is None or not cfg.lr_rewind or gs == ():
        return new_step
    return int(np.int32(new_step) - gs.total_skipped)


def update_guard(cfg: GuardConfig, gs: GuardState, ok: bool, new_step: int) -> GuardState:
    """One transition of the state machine, in the JAX ``update_guard``'s
    float32 / int32 arithmetic.  Good: the streak resets, ``good_steps``
    advances and the scale grows by ``growth`` every ``growth_interval``
    good steps.  Bad: the streak and the total advance, ``good_steps``
    resets and the scale backs off, clamped at 1.  Without
    ``loss_scaling`` the scale stays."""
    with np.errstate(over="ignore"):
        good = np.int32(gs.good_steps + np.int32(1)) if ok else np.int32(0)
        scale = gs.loss_scale
        if cfg.loss_scaling:
            grow = bool(good >= cfg.growth_interval)
            if ok:
                scale = np.float32(gs.loss_scale * np.float32(cfg.growth)) if grow else scale
            else:
                scale = np.maximum(np.float32(gs.loss_scale * np.float32(cfg.backoff)),
                                   np.float32(1.0))
            if grow:
                good = np.int32(0)
        return GuardState(
            loss_scale=np.float32(scale),
            good_steps=np.int32(good),
            skips=np.int32(0) if ok else np.int32(gs.skips + np.int32(1)),
            total_skipped=np.int32(gs.total_skipped + np.int32(0 if ok else 1)),
            last_good_step=np.int32(new_step) if ok else gs.last_good_step,
        )


def guard_metrics(gs: GuardState) -> Dict[str, float]:
    """The post-update guard scalars of a step's metrics (float32 values,
    as Python floats); ``guard/nonfinite`` comes from the sync engines."""
    f32 = np.float32
    return {
        "guard/loss_scale": float(f32(gs.loss_scale)),
        "guard/skipped": float(f32(gs.total_skipped)),
        "guard/skip_streak": float(f32(gs.skips)),
        "guard/last_good_step": float(f32(gs.last_good_step)),
    }


def check_guard_metrics(metrics: Dict[str, Any], cfg: GuardConfig, *, flight=None) -> None:
    """Raise :class:`GuardExceeded` when the fetched metrics' skip streak has
    passed ``max_consecutive_skips`` (the harnesses check once an epoch, or
    every ``--log_every`` in the LM harness).  ``flight`` (an
    ``obs/flight.FlightRecorder``) dumps this rank's blackbox bundle before
    the raise, so the streak history and the chaos arm survive the process."""
    streak = metrics.get("guard/skip_streak")
    if streak is None:
        return
    if float(streak) > cfg.max_consecutive_skips:
        err = GuardExceeded(
            f"step guard: {int(float(streak))} consecutive nonfinite steps "
            f"(> max_consecutive_skips={cfg.max_consecutive_skips}); "
            f"loss_scale={float(metrics.get('guard/loss_scale', -1.0)):g}, "
            f"last_good_step={int(float(metrics.get('guard/last_good_step', -1)))}"
        )
        if flight is not None:
            flight.observe(err, step=int(float(metrics.get("guard/last_good_step", -1))))
        raise err


def scale_objective(cfg: Optional[GuardConfig], gs: Any,
                    objective: torch.Tensor) -> torch.Tensor:
    """The objective the backward pass runs on: at the loss scale, or the
    objective itself at 1.0 (``x * 1.0`` is ``x``)."""
    scale = loss_scale_of(cfg, gs)
    return objective * scale if scale != 1.0 else objective


def check_state(cfg: Optional[GuardConfig], gs: Any) -> None:
    """Refuse a guarded step on a state built without a guard."""
    if cfg is not None and gs == ():
        raise ValueError("guard_cfg set but state.guard is empty; build it with "
                         "init_guard_state(guard_cfg)")


def check_chaos_worker(chaos: Any, n_workers: int, what: str) -> None:
    """Refuse an in-step fault aimed at a worker outside the ``n_workers``
    compression workers (``what`` names them): it would never fire."""
    if chaos is not None and chaos.injects_in_graph and chaos.worker >= n_workers:
        raise ValueError(f"chaos worker {chaos.worker} out of range for {n_workers} {what}")


def needs_whole_backward(cfg: Optional[GuardConfig], chaos: Any) -> bool:
    """Whether the step must finish its backward pass before any chunk of
    the sync starts: the vote and the injection read every gradient, so
    the ``sync_overlap`` hooks are off."""
    return cfg is not None or (chaos is not None and chaos.injects_in_graph)


def vet(cfg: Optional[GuardConfig], chaos: Any, state: Any, loss: torch.Tensor,
        grads: Dict[str, torch.Tensor], group=None):
    """The guard's part of a step between the backward pass and the sync, in
    the JAX step's order: ``chaos`` poisons the loss or the gradients of
    worker ``worker_index(group)``, every rank of the world votes on their
    finiteness, and the gradients are unscaled in place (they are the
    step's own float32 tensors).  ``(ok, loss, grads)``: ``ok`` the verdict
    (``None`` unguarded); ``loss`` is zeroed on a veto, since a nonfinite
    loss would poison the metrics' mean while its count still counts."""
    if chaos is not None and chaos.injects_in_graph:
        loss, grads = chaos_mod.inject(chaos, state.step, worker_index(group), loss, grads)
    if cfg is None:
        return None, loss, grads
    # vote before unscaling: an overflow the scale made is what the backoff
    # must see
    ok = finite_vote(tree_all_finite(loss, grads))
    scale = loss_scale_of(cfg, state.guard)
    if scale != 1.0:
        with torch.no_grad():
            for g in grads.values():
                g.div_(scale)
    if not ok:
        loss = torch.zeros_like(loss)
    return ok, loss, grads


def finish(cfg: Optional[GuardConfig], gs: Any, ok: Optional[bool], new_step: int,
           metrics: Dict[str, Any], comm_names, comm_values) -> Any:
    """The guard's part of a step after the sync: the state machine's
    transition (``gs`` as it was unguarded) and its ``guard/*`` scalars,
    then the sync's stats into ``metrics``, ``guard/nonfinite`` (already
    the workers' verdict) under its own name and the rest as ``comm/*``.
    Returns the new guard state."""
    new = gs
    if cfg is not None:
        new = update_guard(cfg, gs, ok, new_step)
        metrics.update(guard_metrics(new))
    for k, v in zip(comm_names, comm_values):
        metrics[k if k.startswith("guard/") else f"comm/{k}"] = v
    return new
