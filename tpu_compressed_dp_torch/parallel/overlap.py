"""Chunk-pipelined gradient sync: compressed collectives started while the
backward pass still runs.

PyTorch counterpart of :mod:`tpu_compressed_dp.parallel.overlap` (the
reference's ``RandomKSparsifiedDDP``, which reduces buckets from autograd
hooks).  The sync is cut into up to ``cfg.sync_overlap`` chunks:

  * chunk boundaries are reduction-group boundaries of the configured
    granularity (:func:`plan_chunks` reuses ``dp.make_leaf_groups``), and
    each chunk's engine gets the chunk's global ``group_offset``, so its
    RNG streams (``leaf_seed(seed, group_offset + gi)``) and PowerSGD warm
    starts (``q<gi>``) are those of the whole-tree sync: ``sync_overlap = K``
    is bitwise ``sync_overlap = 1``, only the schedule changes;
  * the train step (``train/step.py``) lands each parameter's gradient from
    a tensor hook as the backward pass produces it, and a chunk's sync is
    issued the moment its last gradient lands: the chunks go out in the
    order their gradients complete (:func:`issue_order` over the recorded
    production ranks), the simulate engine's all-reduces as asynchronous
    work handles (``async_op=True``);
  * chunk ``i``'s slice of ``SGD.apply`` runs right after its handles are
    waited on, while later chunks' collectives may still be in flight; SGD
    updates each leaf on its own, so the sliced apply is bitwise the
    whole-tree apply.

The wire and PowerSGD engines feed each collective's result into the next
operation, so their chunks finish inside the issue; they still go out
during the backward pass.  ``clip_norm`` needs the whole gradient's norm
before any chunk compresses, so with it the chunks are issued after the
backward pass (reverse leaf order); ``clip_sent_norm`` needs the synced
gradient's norm, so with it the step applies the whole tree after the
chunked sync, as the JAX step does.  The step guard's vote needs every
gradient too, so a guarded step lands them after the backward pass and hands
the verdict to :meth:`ChunkedSync.begin` (the JAX driver takes the vote once
before its chunks).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tpu_compressed_dp_torch.obs import trace as obs_trace
from tpu_compressed_dp_torch.parallel import dp

__all__ = ["ChunkPlan", "plan_chunks", "hideable_byte_fraction", "issue_order",
           "ChunkedSync", "make_chunked_grad_sync", "make_overlap_sync_apply"]

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """One chunk of the gradient tree, in parameter order (chunk 0 holds the
    first leaves): the leaf range ``[leaf_lo, leaf_hi)``, whose ends are
    group boundaries, and the global index of its first group."""

    index: int
    leaf_lo: int
    leaf_hi: int
    group_offset: int
    n_groups: int
    n_bytes: int


def plan_chunks(byte_sizes: Sequence[int], cfg) -> List[ChunkPlan]:
    """At most ``cfg.sync_overlap`` contiguous, byte-balanced chunks aligned
    to the granularity's group boundaries (the JAX ``plan_chunks``).  Greedy
    bucket packing restarts at every group boundary, so re-packing a chunk's
    leaves gives the groups the whole tree assigned them; entire-model
    granularity has one group and so one chunk."""
    byte_sizes = list(byte_sizes)
    groups = dp.make_leaf_groups(byte_sizes, cfg.granularity, cfg.bucket_mb * dp.BUCKET_MB)
    if not groups:
        return []
    k = max(1, min(int(cfg.sync_overlap), len(groups)))
    group_bytes = [float(sum(byte_sizes[i] for i in g)) for g in groups]
    total = sum(group_bytes) or 1.0
    plans: List[ChunkPlan] = []
    gi, cum, leaf_lo = 0, 0.0, 0
    for c in range(k):
        start_g = gi
        target = (c + 1) * total / k
        # take at least one group; keep taking while under the proportional
        # cut and while every later chunk can still have one
        while gi < len(groups) and (
                gi == start_g
                or (cum + group_bytes[gi] <= target and len(groups) - gi > k - c - 1)):
            cum += group_bytes[gi]
            gi += 1
        leaf_hi = groups[gi - 1][-1] + 1
        plans.append(ChunkPlan(index=c, leaf_lo=leaf_lo, leaf_hi=leaf_hi, group_offset=start_g,
                               n_groups=gi - start_g,
                               n_bytes=int(sum(group_bytes[start_g:gi]))))
        leaf_lo = leaf_hi
    if gi != len(groups) or leaf_lo != len(byte_sizes):
        raise AssertionError("chunk plan does not cover the tree")
    return plans


def hideable_byte_fraction(plans: Sequence[ChunkPlan]) -> float:
    """The share of the sync's bytes the chunk schedule can hide behind
    remaining compute: every chunk but the last issued one (chunk 0, the
    first parameters, whose gradients land last).  0 for a single chunk."""
    plans = list(plans)
    total = float(sum(p.n_bytes for p in plans))
    if total <= 0.0 or len(plans) < 2:
        return 0.0
    exposed = float(min(plans, key=lambda p: p.index).n_bytes)
    return max(0.0, 1.0 - exposed / total)


def issue_order(plans: List[ChunkPlan],
                ranks: Optional[Sequence[int]] = None) -> List[ChunkPlan]:
    """Chunk dispatch order.  With per-leaf production ``ranks`` (the order
    in which the backward pass produced each leaf's gradient): by each
    chunk's last landing gradient, earliest first, ties toward the reversed
    leaf order.  Without: reversed leaf order (the last parameters'
    gradients come first)."""
    if ranks is not None:
        return sorted(plans, key=lambda p: (max(ranks[p.leaf_lo:p.leaf_hi]), -p.index))
    return list(reversed(plans))


def _comp_slice(comp: Any, plan: ChunkPlan) -> Any:
    """The chunk's slice of the compressor state: the ``q<gi>`` warm starts
    of its groups, ``()`` where it holds none."""
    if not isinstance(comp, dict):
        return ()
    sub = {f"q{g}": comp[f"q{g}"]
           for g in range(plan.group_offset, plan.group_offset + plan.n_groups)
           if f"q{g}" in comp}
    return sub if sub else ()


class ChunkedSync:
    """The chunk engines of one config over the workers of ``group`` (``None``:
    the default process group), planned once per tree layout (leaf names and
    byte sizes); :meth:`begin` starts one step's round."""

    def __init__(self, cfg, group=None):
        self.cfg = cfg
        self.group = group
        self._layout: Optional[Tuple] = None

    def _plan(self, grads_like: Tree):
        layout = tuple((k, g.numel() * 4) for k, g in grads_like.items())
        if layout != self._layout:
            self.plans = plan_chunks([b for _, b in layout], self.cfg)
            self.issues = [dp.make_issue_grad_sync(self.cfg, p.group_offset, self.group)
                           for p in self.plans]
            self.chunk_of = [c for c, p in enumerate(self.plans)
                             for _ in range(p.leaf_lo, p.leaf_hi)]
            self._layout = layout

    def begin(self, grads_like: Tree, ef: Any, comp: Any, seed: int,
              ok: Optional[bool] = None) -> "_Round":
        """A round over gradients shaped like ``grads_like`` (fp32), gated by
        the guard's verdict ``ok`` (``None``: ungated; ``dp._with_guard``)."""
        self._plan(grads_like)
        return _Round(self, list(grads_like), ef, comp, seed, ok)


class _Round:
    """One step's chunked sync: gradients land one by one (:meth:`land`), a
    chunk's sync is issued when its last one lands, and :meth:`results`
    waits for the chunks in the order they went out."""

    def __init__(self, chunked: ChunkedSync, names: List[str], ef: Any, comp: Any, seed: int,
                 ok: Optional[bool] = None):
        self.c, self.names, self.ef, self.comp, self.seed = chunked, names, ef, comp, seed
        self.ok = ok
        self.grads: List[Optional[torch.Tensor]] = [None] * len(names)
        self.missing = [p.leaf_hi - p.leaf_lo for p in chunked.plans]
        self.ranks = [-1] * len(names)    # each leaf's production rank
        self.landed = 0
        self.pending: List[Tuple[ChunkPlan, Callable]] = []

    def land(self, i: int, g: torch.Tensor) -> None:
        """Leaf ``i``'s gradient (fp32, at the scale the sync compresses)."""
        if self.grads[i] is not None:
            raise RuntimeError(f"gradient of {self.names[i]} landed twice in one step")
        self.grads[i] = g
        self.ranks[i] = self.landed
        self.landed += 1
        ci = self.c.chunk_of[i]
        self.missing[ci] -= 1
        if self.missing[ci] == 0:
            self._issue(ci)

    def land_all(self, grads: Tree) -> None:
        """Every gradient at once (a clipped tree, or a sync outside a
        backward pass): the chunks go out in reverse leaf order."""
        for plan in issue_order(self.c.plans):
            for i in range(plan.leaf_lo, plan.leaf_hi):
                self.land(i, grads[self.names[i]])

    def _issue(self, ci: int) -> None:
        plan = self.c.plans[ci]
        keys = self.names[plan.leaf_lo:plan.leaf_hi]
        sub = dict(zip(keys, self.grads[plan.leaf_lo:plan.leaf_hi]))
        sub_ef = {k: self.ef[k] for k in keys} if self.c.cfg.error_feedback else ()
        # the chunk's range index is its issue order (0 = first issued)
        with obs_trace.chunk(len(self.pending)):
            fin = self.c.issues[ci](sub, sub_ef, _comp_slice(self.comp, plan), self.seed,
                                    ok=self.ok)
        self.pending.append((plan, fin))

    def results(self):
        """``(plan, (synced, new_ef, new_comp, stats))`` per chunk, waited
        for in issue order."""
        if len(self.pending) != len(self.c.plans):
            missing = [self.names[i] for i, g in enumerate(self.grads) if g is None]
            raise RuntimeError(f"chunked sync: no gradient landed for {missing[:4]}")
        for i, (plan, fin) in enumerate(self.pending):
            with obs_trace.chunk(i):
                out = fin()
            yield plan, out

    def _merge(self, parts):
        synced: Tree = {}
        new_ef: Tree = {}
        new_comp: Dict[str, torch.Tensor] = {}
        stats = None
        for out, e, c, s in parts:
            synced.update(out)
            if isinstance(e, dict):
                new_ef.update(e)
            if isinstance(c, dict):
                new_comp.update(c)
            stats = s if stats is None else dp.merge_stat_dicts(stats, s)
        ef_out = {k: new_ef[k] for k in self.names} if self.c.cfg.error_feedback else ()
        # the warm starts in group order, as the single sync keys them
        new_comp = {q: new_comp[q] for q in sorted(new_comp, key=lambda q: int(q[1:]))}
        return synced, ef_out, new_comp if new_comp else (), stats

    def collect(self):
        """``(synced, new_ef, new_comp, stats)`` of the whole tree, as the
        single sync returns them (stats merged in issue order)."""
        synced, new_ef, new_comp, stats = self._merge(r for _, r in self.results())
        return {k: synced[k] for k in self.names}, new_ef, new_comp, stats

    def apply(self, params: Tree, optimizer, opt_state: Dict[str, Any], step: int):
        """Wait for each chunk in issue order and apply its slice of
        ``optimizer`` (SGD, whose per-leaf update makes the slices the
        whole-tree apply); returns ``(new_ef, new_comp, stats)``."""
        parts = []
        for i, (plan, (out, e, c, s)) in enumerate(self.results()):
            keys = self.names[plan.leaf_lo:plan.leaf_hi]
            with obs_trace.chunk(i), obs_trace.phase("update"):
                optimizer.apply({k: params[k] for k in keys}, out, opt_state, step)
            parts.append(({}, e, c, s))
        _, new_ef, new_comp, stats = self._merge(parts)
        return new_ef, new_comp, stats


def make_chunked_grad_sync(cfg):
    """``sync(grads, ef, comp, seed) -> (synced, new_ef, new_comp, stats)``,
    the contract of ``dp.make_stateful_grad_sync``, as ``cfg.sync_overlap``
    chunk syncs issued in reverse leaf order: bitwise the single sync."""
    chunked = ChunkedSync(cfg)

    def sync(grads: Tree, ef: Any, comp: Any, seed: int, ok: Optional[bool] = None):
        rnd = chunked.begin(grads, ef, comp, seed, ok)
        rnd.land_all(grads)
        return rnd.collect()

    return sync


def make_overlap_sync_apply(cfg, optimizer):
    """``fused(params, grads, ef, comp, opt_state, seed, step) -> (new_ef,
    new_comp, stats)``: the chunked sync of a finished gradient tree with
    each chunk's slice of ``optimizer`` applied (in place) as soon as the
    chunk is reduced.  The train step's backward-pass version lands the
    gradients from hooks instead (``train/step.py``)."""
    chunked = ChunkedSync(cfg)

    def fused(params: Tree, grads: Tree, ef: Any, comp: Any, opt_state: Dict[str, Any],
              seed: int, step: int, ok: Optional[bool] = None):
        rnd = chunked.begin(grads, ef, comp, seed, ok)
        rnd.land_all(grads)
        if ok is False:
            # a vetoed step updates nothing: the sync ran for its stats
            _, new_ef, new_comp, stats = rnd.collect()
            return new_ef, new_comp, stats
        return rnd.apply(params, optimizer, opt_state, step)

    return fused
