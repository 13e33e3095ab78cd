"""Elastic data-parallel training: failure detection, coordinated abort,
a W -> W-1 remesh over a re-initialised process group, and readmission.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.train.elastic`.  The
robustness layer survives nonfinite steps (the step guard) and the death of
a process (checkpoint + watchdog relaunch), but only by restarting the
whole job.  This module is the other half: the survivors detect the
failure, abort together, re-form the process group without the dead
worker, and keep training; a relaunched worker is readmitted at an epoch
boundary.

The port runs one process per worker, so every membership change is the
JAX runtime's multi-process path (``_handle_failure_multiprocess``,
``rejoin_barrier``, ``join_world``): agree on a new world epoch through the
file rendezvous (:mod:`tpu_compressed_dp_torch.train.rendezvous`), tear the
old ``torch.distributed`` group down and initialise the committed one, then
rebuild the step for the new world.  There is no counterpart of JAX's
single-process simulation (W devices in one process).

Detection (three planes, all raising :class:`PeerFailed`):

  * **heartbeat gossip** (:class:`PeerGossip`): every process writes its
    own liveness file into ``--elastic_dir`` and reads its peers'.  A peer
    whose record stays unchanged for ``peer_timeout_s`` of local monotonic
    time is dead; a record with a higher ``incarnation`` (``TCDP_RESTART_COUNT``,
    exported by ``harness/watchdog.py --relaunch``) is a restarted peer, a
    rejoin candidate.  The runtime beats from a background thread, so a
    process blocked in a collective on a dead peer still reads as alive.
  * **collective errors and the bounded fetch**: a collective over a group
    with a dead member raises (gloo's closed connection, or the group's
    timeout, which the harnesses set to ``--peer_timeout``), and the
    epoch-end metrics fetch runs under :func:`fetch_with_timeout`.
    :meth:`ElasticRuntime.failure_from` turns either into a
    :class:`PeerFailed` with no culprit and fills the culprit in from the
    gossip, waiting up to twice ``peer_timeout_s`` for the dead peer's file
    to go stale (the error arrives before the staleness does).
  * **deterministic chaos**: ``--chaos crash=mid_collective,...`` raises
    right after step N on every rank; every rank converts it into the death
    of ``worker``, which then leaves with "this rank is among the declared
    dead" while the others remesh, so no survivor enters a collective with
    it.  ``crash=during_remesh`` plays a second death inside the remesh
    handler: the dead set is unioned (a cascade), never below
    ``min_world``.

The contract of a transition:

  * **Ranks.** Gossip, vote and join files are keyed by ORIGINAL launch
    rank (the ``--heartbeat <path>.rank<r>`` suffix too).  After a
    transition the process-group ranks are renumbered contiguously in
    surviving order, and batch shards, dropout seeds and compressor seeds
    follow the new rank, as a JAX mesh position does.
  * **The dead worker's EF** lived only in its process and is lost: every
    remesh behaves as the ``drop`` policy with an unknown norm (the JAX
    multi-process rule); the log line says ``ef_unrecoverable`` and
    ``elastic/dropped_ef_norm`` is unchanged.  So :class:`ElasticConfig`
    has no ``ef_policy`` and the harnesses refuse ``--elastic_ef fold``.
    ``fold`` and the exact ``drop`` norm are the pure functions below
    (:func:`migrate_ef` and friends, over stacked per-worker rows).
  * **One state after every transition.**  The port updates state in
    place (BatchNorm statistics in the forward pass, SGD chunk by chunk
    under ``--overlap``), so a death in the middle of a step can leave the
    survivors with different partial writes.  After the re-init the new
    coordinator (the lowest surviving original rank) broadcasts the
    replicated fields over the new group: parameters, BatchNorm buffers,
    momentum, the compressor state, the guard state, the adaptive
    controller's state and the step.  EF
    stays local.  (JAX's jitted step cannot be half-applied, so it needs no
    such broadcast after a remesh; its ``rejoin_barrier`` broadcasts to
    joiners the same way.)
  * **Readmission.**  A joiner receives the coordinator's replicated
    fields and compressor state, and its EF starts at zero.  A readmit is
    a new epoch, never a rewind.  The survivors agree on the pending joins
    with one collective before they vote, so a join file that appears
    while they read cannot split their views.

``events`` (``obs/export.EventStream``) gets the JAX runtime's ``remesh``,
``remesh_cascade`` and ``readmit`` records, ``flight``
(``obs/flight.FlightRecorder``) the same in its ``elastic`` ring plus a
blackbox dump on every handled failure.  ``stream`` (rank 0's
``stream/writer.StreamWriter``) gets a keyframe request after every
committed world transition.  Warm readmission: when the delta stream is
armed on every process (``stream_armed``), every pending joiner's join
record carries ``stream`` (it could catch up from the stream) and a
survivor holds the writer, the writer's rank flushes the stream
(:meth:`StreamWriter.sync`) before the epoch commit, the commit carries ``warm``, the broadcast skips the parameters
(buffers, momentum, compressor, guard and controller state and the step
still travel) and the joiner adopts them from the stream
(``stream/rejoin.py``); ``stream/rejoin_bytes`` is what it read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.utils.resilience import read_heartbeat

__all__ = [
    "PeerFailed", "ElasticConfig", "PeerGossip", "ElasticRuntime",
    "heartbeat_path", "write_peer_heartbeat", "fetch_with_timeout",
    "abandoned_fetch_count", "migrate_ef", "migrate_comp", "expand_ef",
    "expand_comp", "shrink_state", "expand_state", "TrimBatches",
    "broadcast_replicated", "settle_barrier", "is_collective_error",
]

#: Default failure-detection budget: a peer heartbeat older than this (and
#: a collective fetch blocked longer than this) counts as a dead peer.
DEFAULT_PEER_TIMEOUT_S = 60.0


class PeerFailed(RuntimeError):
    """Coordinated abort signal: one or more peers are gone.

    ``failed`` — ORIGINAL ranks declared dead; may be empty when a
    collective failed before the gossip named a culprit (the runtime then
    consults gossip to fill it in).  ``step`` — the attempted global step,
    when known.  Every survivor raises the same verdict from the same
    evidence (stale files age out at the same deadline; the chaos injection
    is step-keyed), which is what makes the abort coordinated.
    """

    def __init__(self, failed: Iterable[int] = (), *,
                 step: Optional[int] = None, reason: str = "peer failure"):
        self.failed: Tuple[int, ...] = tuple(sorted(int(f) for f in failed))
        self.step = None if step is None else int(step)
        self.reason = reason
        who = list(self.failed) if self.failed else "unknown peer(s)"
        at = f" at step {self.step}" if self.step is not None else ""
        super().__init__(f"elastic: {who} failed{at}: {reason}")


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Knobs of the elastic runtime (CLI surface: ``--elastic*``).

    gossip_dir:      shared directory of per-rank heartbeat files and the
                     rendezvous records (None = no gossip plane)
    rank:            this worker's ORIGINAL rank
    peer_timeout_s:  staleness/fetch deadline before a peer counts as dead,
                     and the process group's collective timeout
    min_world:       refuse to shrink below this many workers

    JAX's ``ef_policy`` is not a field: a live remesh always loses the dead
    worker's EF (the policies are :func:`migrate_ef`'s ``policy``).
    """

    gossip_dir: Optional[str] = None
    rank: int = 0
    peer_timeout_s: float = DEFAULT_PEER_TIMEOUT_S
    min_world: int = 2

    def __post_init__(self):
        if self.peer_timeout_s <= 0:
            raise ValueError("peer_timeout_s must be > 0")
        if self.min_world < 1:
            raise ValueError("min_world must be >= 1")


# ------------------------------------------------------------------ gossip

def heartbeat_path(gossip_dir: str, rank: int) -> str:
    return os.path.join(gossip_dir, f"rank{int(rank)}.json")


def write_peer_heartbeat(gossip_dir: str, rank: int, step: int, *,
                         incarnation: int = 0,
                         ts: Optional[float] = None,
                         wall: Callable[[], float] = time.time) -> str:
    """One atomic heartbeat write into the gossip directory (the record
    shape and tmp+replace of ``utils/resilience.Heartbeat``).  ``ts``
    overrides the record timestamp; ``wall`` is the clock it defaults to
    (peer staleness is judged on LOCAL monotonic freshness, never on this
    field — see :class:`PeerGossip`)."""
    os.makedirs(gossip_dir, exist_ok=True)
    path = heartbeat_path(gossip_dir, rank)
    rec = {"ts": wall() if ts is None else float(ts),
           "step": int(step), "rank": int(rank),
           "incarnation": int(incarnation)}
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, path)
    return path


class PeerGossip:
    """Decentralised failure detector over a shared heartbeat directory.

    Each worker runs one instance: it reads every peer's file per
    :meth:`check` and votes a peer dead once no FRESH record (a changed
    record under the admitted incarnation) has been seen for
    ``peer_timeout_s`` of local monotonic time.  Incarnation rules:

      * the first record seen for a rank admits its incarnation;
      * a record with a LOWER incarnation than admitted is a stale file of
        a dead prior life — it never refreshes liveness;
      * a record with a HIGHER incarnation means the peer process was
        replaced: the admitted life is declared dead (its in-memory EF row
        is gone regardless of how alive the new process looks) and the new
        incarnation becomes a rejoin candidate for the next barrier.

    Construction starts every peer's grace clock at "now", so a cold start
    where peers appear over ``peer_timeout_s`` does not false-positive.
    Staleness is measured on THIS process's monotonic clock, and a peer is
    fresh when its record *changed* since the last sweep: the writer's
    wall-clock ``ts`` is never compared against local time.
    """

    def __init__(self, gossip_dir: str, rank: int, world: int, *,
                 peer_timeout_s: float = DEFAULT_PEER_TIMEOUT_S,
                 incarnation: Optional[int] = None,
                 now: Callable[[], float] = time.monotonic):
        self.gossip_dir = gossip_dir
        self.rank = int(rank)
        self.world = int(world)
        self.peer_timeout_s = float(peer_timeout_s)
        if incarnation is None:
            try:
                incarnation = int(os.environ.get("TCDP_RESTART_COUNT", "0"))
            except ValueError:
                incarnation = 0
        self.incarnation = int(incarnation)
        self._last_beat = float("-inf")
        self._now = now
        t0 = now()
        self._last_fresh: Dict[int, float] = {
            r: t0 for r in range(self.world)}
        self._last_rec: Dict[int, Tuple] = {}    # rank -> last observed record
        self._admitted: Dict[int, Optional[int]] = {
            r: None for r in range(self.world)}
        self._dead: Dict[int, str] = {}          # rank -> reason
        self._rejoin: Dict[int, int] = {}        # rank -> new incarnation

    @property
    def dead(self) -> Tuple[int, ...]:
        return tuple(sorted(self._dead))

    def beat(self, step: int = 0) -> None:
        """Write THIS rank's own liveness file (rate-limited to a quarter of
        the timeout)."""
        now = self._now()
        if now - self._last_beat >= self.peer_timeout_s / 4:
            write_peer_heartbeat(self.gossip_dir, self.rank, step,
                                 incarnation=self.incarnation, ts=now)
            self._last_beat = now

    def note_dead(self, ranks: Iterable[int], reason: str = "declared dead"
                  ) -> None:
        """Record an externally-detected failure (chaos conversion, a peer
        named by another detector) so rejoin tracking stays consistent."""
        for r in ranks:
            self._dead.setdefault(int(r), reason)

    def check(self, now: Optional[float] = None) -> Dict[int, str]:
        """One gossip sweep; returns the NEWLY dead peers ``{rank: why}``
        (already-known dead peers are only re-reported via :attr:`dead`)."""
        now = self._now() if now is None else now
        newly: Dict[int, str] = {}
        for r in range(self.world):
            if r == self.rank:
                continue
            hb = read_heartbeat(heartbeat_path(self.gossip_dir, r))
            inc = None
            changed = False
            if hb is not None:
                inc = int(hb.get("incarnation", 0) or 0)
                rec = (hb.get("ts"), hb.get("step"), inc)
                changed = rec != self._last_rec.get(r)
                if changed:
                    self._last_rec[r] = rec
            if r in self._dead:
                dead_inc = self._admitted.get(r)
                if (hb is not None and changed and inc is not None
                        and (dead_inc is None or inc > dead_inc)):
                    self._rejoin[r] = inc
                continue
            if hb is not None:
                if self._admitted[r] is None:
                    self._admitted[r] = inc
                if inc > self._admitted[r]:
                    # the process we were tracking is gone; its replacement
                    # may rejoin, but the tracked life's state died with it
                    why = (f"incarnation advanced {self._admitted[r]} -> "
                           f"{inc} (peer restarted)")
                    self._dead[r] = why
                    newly[r] = why
                    self._rejoin[r] = inc
                    continue
                if changed and inc == self._admitted[r]:
                    # liveness = "the record is still being rewritten",
                    # stamped with OUR clock — never the writer's wall ts
                    self._last_fresh[r] = max(self._last_fresh[r],
                                              float(now))
            age = now - self._last_fresh[r]
            if age > self.peer_timeout_s:
                why = (f"no fresh heartbeat for {age:.1f}s "
                       f"(> {self.peer_timeout_s:g}s)")
                self._dead[r] = why
                newly[r] = why
        return newly

    def raise_if_dead(self, step: Optional[int] = None,
                      now: Optional[float] = None) -> None:
        newly = self.check(now)
        if newly:
            reason = "; ".join(f"rank {r}: {why}"
                               for r, why in sorted(newly.items()))
            raise PeerFailed(newly, step=step, reason=reason)

    def rejoin_candidates(self, now: Optional[float] = None
                          ) -> Dict[int, int]:
        """Dead ranks whose directory now shows a fresh, newer incarnation
        — ready for re-admission at the next barrier."""
        self.check(now)
        return dict(self._rejoin)

    def readmit(self, rank: int) -> None:
        """Move a rank back to the tracked set under its new incarnation."""
        rank = int(rank)
        inc = self._rejoin.pop(rank, None)
        self._dead.pop(rank, None)
        self._admitted[rank] = inc
        self._last_fresh[rank] = self._now()


# ------------------------------------------------- bounded collective fetch

# Timed-out fetch threads cannot be killed (a copy blocked inside the runtime
# has no cancellation point), but they must not LEAK: each abandoned runner
# is tracked here and reaped as soon as it finishes, and its discard flag
# makes it drop the fetched value instead of pinning it.
_ABANDONED_FETCHES: List[threading.Thread] = []
_ABANDONED_LOCK = threading.Lock()


def abandoned_fetch_count() -> int:
    """Live runner threads whose deadline expired (reaps finished ones
    first).  Steady state is 0 once their blocking fetches drain."""
    with _ABANDONED_LOCK:
        _ABANDONED_FETCHES[:] = [t for t in _ABANDONED_FETCHES
                                 if t.is_alive()]
        return len(_ABANDONED_FETCHES)


def fetch_with_timeout(thunk: Callable[[], Any], timeout_s: float, *,
                       step: Optional[int] = None,
                       what: str = "collective fetch") -> Any:
    """Run a blocking fetch with a deadline.

    The thunk runs in a daemon thread; exceeding ``timeout_s`` raises
    :class:`PeerFailed` (with no culprit — gossip names the rank).  The
    thunk's own exception, if any, is re-raised on the caller's thread.  On
    timeout the runner is marked DISCARDED before it is abandoned: whenever
    the blocked fetch returns, the value is dropped, and the thread is
    tracked until it exits (:func:`abandoned_fetch_count`).
    """
    box: Dict[str, Any] = {}
    done = threading.Event()
    lock = threading.Lock()
    discarded = [False]

    def runner():
        try:
            value = thunk()
            with lock:
                if not discarded[0]:
                    box["value"] = value
            del value
        except BaseException as e:
            with lock:
                if not discarded[0]:  # nobody is left to re-raise it to
                    box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=runner, daemon=True,
                         name=f"tcdp-elastic-fetch({what})")
    t.start()
    if not done.wait(timeout_s):
        with lock:
            discarded[0] = True
        with _ABANDONED_LOCK:
            _ABANDONED_FETCHES[:] = [a for a in _ABANDONED_FETCHES
                                     if a.is_alive()]
            _ABANDONED_FETCHES.append(t)
        raise PeerFailed((), step=step, reason=(
            f"{what} still blocked after {timeout_s:g}s — "
            "a peer died mid-collective"))
    if "error" in box:
        raise box["error"]
    return box.get("value")


# -------------------------------------------------------- state migration
#
# Over stacked per-worker rows: trees (dicts, lists, tuples) of tensors whose
# leading axis is the worker, as the JAX state's EF and compressor trees are.
# A live remesh holds one row a process and never calls these; the tests and
# the chaos drill hold them to the JAX functions bitwise.

def _map(fn, tree):
    """``fn`` over the leaves, visited in ``jax.tree`` order (a dict's keys
    sorted), the result in the tree's own layout."""
    if isinstance(tree, dict):
        out = {k: _map(fn, tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> List[Any]:
    out: List[Any] = []
    _map(out.append, tree)
    return out


def _empty(tree) -> bool:
    return isinstance(tree, tuple) and tree == ()


def migrate_ef(ef: Any, failed: Sequence[int], *, policy: str = "fold",
               fold_into: int = 0) -> Tuple[Any, float]:
    """Shrink the EF residual's leading worker axis by ``failed``.

    ``fold``: the lost rows are added into survivor row ``fold_into``
    (survivor order), summed row after row and then added with one float32
    add a leaf — total residual mass is conserved.  ``drop``: the lost rows
    are discarded; returns their global L2 norm (the root of the squares
    summed over every leaf, accumulated in float64 on the host as the JAX
    function does) so the caller can account the abandoned gradient mass.

    Returns ``(new_ef, dropped_norm)``.
    """
    if policy not in ("fold", "drop"):
        raise ValueError(f"ef policy must be fold|drop, got {policy!r}")
    if _empty(ef):
        return (), 0.0
    failed = sorted({int(f) for f in failed})
    dropped_sq = 0.0

    def one(a):
        nonlocal dropped_sq
        if a.dim() < 1 or a.shape[0] <= max(failed):
            raise ValueError(
                f"EF leaf with leading axis {tuple(a.shape)} cannot lose "
                f"worker(s) {failed}")
        keep = [i for i in range(a.shape[0]) if i not in failed]
        kept = a[keep].clone()
        if policy == "fold":
            lost = a[failed[0]].clone()
            for f in failed[1:]:
                lost += a[f]
            kept[fold_into] = kept[fold_into] + lost
        else:
            lost = a[failed].detach().cpu().numpy()
            dropped_sq += float(np.sum(lost.astype(np.float64) ** 2))
        return kept

    new_ef = _map(one, ef)
    return new_ef, float(np.sqrt(dropped_sq))


def migrate_comp(comp: Any, failed: Sequence[int]) -> Any:
    """Shrink the compressor state's leading worker axis: the PowerSGD
    warm-start rows are identical across workers, so the dead rows are
    deleted with nothing to fold."""
    if _empty(comp):
        return ()
    failed = {int(f) for f in failed}

    def one(a):
        return a[[i for i in range(a.shape[0]) if i not in failed]].clone()

    return _map(one, comp)


def expand_ef(ef: Any, n_new: int = 1) -> Any:
    """Append zero rows for rejoining workers (a fresh worker has not
    withheld any gradient mass yet)."""
    if _empty(ef) or n_new <= 0:
        return ef
    return _map(lambda a: torch.cat([a, a.new_zeros((n_new,) + tuple(a.shape[1:]))]), ef)


def expand_comp(comp: Any, n_new: int = 1) -> Any:
    """Append copies of survivor row 0 for rejoining workers: the newcomer
    adopts the survivors' converged PowerSGD factors."""
    if _empty(comp) or n_new <= 0:
        return comp
    return _map(lambda a: torch.cat([a] + [a[:1]] * n_new), comp)


def _rows_per_data_row(tree: Any, data_world: Optional[int]) -> int:
    """How many leading-axis rows one DATA row owns in an EF/comp tree (the
    sync world over the data extent: ``sp`` rows a data row on a dp x sp
    layout, data-major)."""
    if _empty(tree) or data_world is None:
        return 1
    leaves = _leaves(tree)
    if not leaves:
        return 1
    lead = int(leaves[0].shape[0])
    if data_world <= 0 or lead % data_world:
        raise ValueError(
            f"EF/comp leading axis {lead} does not divide into "
            f"{data_world} data rows")
    return lead // data_world


def _worker_rows(data_rows: Sequence[int], m: int) -> List[int]:
    """Expand failed DATA-row indices into leading-axis row indices
    (identity when ``m == 1``)."""
    return [int(d) * m + j for d in sorted({int(x) for x in data_rows})
            for j in range(m)]


def shrink_state(state, failed: Sequence[int], *, policy: str = "fold",
                 fold_into: int = 0, data_world: Optional[int] = None):
    """A state whose stacked EF/comp rows lose the dead workers (``failed``
    DATA-row indices; ``data_world`` maps them to leading-axis rows when the
    sync world is wider than the data axis), every other field kept.
    Returns ``(new_state, dropped_ef_norm)``."""
    ef_rows = _worker_rows(failed, _rows_per_data_row(state.ef, data_world))
    comp_rows = _worker_rows(failed, _rows_per_data_row(state.comp, data_world))
    new_ef, dropped = migrate_ef(state.ef, ef_rows, policy=policy,
                                 fold_into=fold_into)
    new_comp = migrate_comp(state.comp, comp_rows)
    return dataclasses.replace(state, ef=new_ef, comp=new_comp), dropped


def expand_state(state, n_new: int = 1, *,
                 data_world: Optional[int] = None):
    """A state extended for ``n_new`` rejoining DATA rows (zero EF rows,
    survivor-row-0 comp rows; ``data_world`` the pre-extension extent)."""
    m_ef = _rows_per_data_row(state.ef, data_world)
    m_comp = _rows_per_data_row(state.comp, data_world)
    return dataclasses.replace(state, ef=expand_ef(state.ef, n_new * m_ef),
                               comp=expand_comp(state.comp, n_new * m_comp))


class TrimBatches:
    """Iterable view trimming each batch dict to at most ``size`` rows: the
    remeshed world divides a smaller global batch, so after W -> W-1 each
    batch is cut to ``(bs // W') * W'`` rows (short final batches pass
    through untouched for the eval padding to handle)."""

    def __init__(self, inner, size: int):
        self.inner = inner
        self.size = int(size)

    def __iter__(self):
        for batch in self.inner:
            yield {k: v[:self.size] for k, v in batch.items()}

    def __len__(self):
        return len(self.inner)


# --------------------------------------------------------- the live world

_COLLECTIVE_MARKS = ("gloo", "Connection closed by peer", "Connection reset by peer",
                     "Broken pipe", "Timed out", "timed out", "NCCL", "c10d")


def is_collective_error(exc: BaseException) -> bool:
    """Is ``exc`` a collective that failed on its group (a peer's closed
    connection, the group's timeout)?  ``torch.distributed``'s own error
    types, or a ``RuntimeError`` from the backend."""
    dist_error = getattr(dist, "DistError", None)
    if dist_error is not None and isinstance(exc, dist_error):
        return True
    return isinstance(exc, RuntimeError) and any(m in str(exc) for m in _COLLECTIVE_MARKS)


def _tensors(state, comp: bool, params: bool = True) -> List[torch.Tensor]:
    """The replicated tensors of a state, in one order on every rank:
    parameters (unless ``params`` is false) and buffers (the module's
    ``state_dict`` order), momentum and the other optimizer buffers, and the
    compressor state."""
    names = {n for n, _ in state.model.named_parameters()}
    out = [t for n, t in state.model.state_dict().items() if params or n not in names]
    out += [t for t in _leaves(state.opt_state) if isinstance(t, torch.Tensor)]
    if comp and not _empty(state.comp):
        out += [t for t in _leaves(state.comp) if isinstance(t, torch.Tensor)]
    return out


def settle_barrier(timeout_s: float) -> None:
    """Every rank of the default group arrives, with ``timeout_s`` as the
    deadline (gloo's ``monitored_barrier``; other backends' barrier keeps
    the group's own timeout)."""
    import datetime

    if mesh.world() <= 1:
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=float(timeout_s)))
    else:
        dist.barrier()


@torch.no_grad()
def broadcast_replicated(state, src: int, *, comp: bool = True, extras: Any = None,
                         params: bool = True):
    """Make ``state``'s replicated fields group rank ``src``'s on every rank
    of the default group: the tensors in place (one broadcast a dtype and
    device, flattened), the step, the guard and the controller state by
    value.  ``extras`` (any picklable value) rides along from ``src``;
    ``params=False`` leaves the model's parameters out (a warm readmission:
    the joiner adopted them from the delta stream).  Returns ``(state,
    extras)``; EF is left alone."""
    groups: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in _tensors(state, comp, params):
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    box = [int(state.step), state.guard, state.control, extras]
    dist.broadcast_object_list(box, src=src)
    return (dataclasses.replace(state, step=int(box[0]), guard=box[1], control=box[2]),
            box[3])


class ElasticRuntime:
    """The harness-facing elastic runtime over the process group: converts
    failures, performs the remesh and the readmission, and keeps the
    ``elastic/*`` counters.

    Typical harness shape::

        el = ElasticRuntime(cfg, rendezvous=rdzv, gossip=gossip)
        while epoch < epochs:
            try:
                state = train_epoch(step_for(el.world), state, ...)
            except Exception as e:
                failure = el.failure_from(e)
                if failure is None:
                    raise
                state = el.handle_failure(getattr(e, "train_state", state), failure)
                continue        # replay the epoch in the new world
            state, grew = el.rejoin_barrier(state)
            epoch += 1

    ``ranks`` are the ORIGINAL ranks of the current world in group-rank
    order (default: the group's own ranks).  ``ckpt`` (a
    ``utils/checkpoint.Checkpointer``) follows every transition;
    ``ckpt_layout(world)`` gives its layout's other keys in the new world.
    :attr:`shared` is what the harness keeps of its own position (its next
    epoch, its data order's RNG state): the coordinator's copy reaches every
    rank at each transition, so a joiner resumes where the survivors are.
    ``reinit(decision)`` moves this process into a committed world (default
    :func:`~tpu_compressed_dp_torch.train.rendezvous.reinit_distributed` on
    ``device`` with the group timeout ``peer_timeout_s``); ``broadcast``
    (default :func:`broadcast_replicated`) agrees the replicated state.
    Both are injectable for the single-process tests.
    """

    def __init__(self, cfg: ElasticConfig, *,
                 gossip: Optional[PeerGossip] = None, crash=None, rendezvous=None,
                 ranks: Optional[Sequence[int]] = None, device=None, ckpt=None,
                 ckpt_layout: Optional[Callable[[int], Dict[str, Any]]] = None,
                 reinit: Optional[Callable[[Any], None]] = None,
                 broadcast: Optional[Callable[..., Any]] = None,
                 events=None, flight=None, stream=None, stream_armed=None,
                 log: Callable[[str], None] = print):
        self.cfg = cfg
        self.events = events
        self.flight = flight
        self.gossip = gossip
        self.crash = crash
        self.rendezvous = rendezvous
        self.ckpt = ckpt
        self.ckpt_layout = ckpt_layout
        self._log = log
        self._device = device
        self._reinit = reinit or self._reinit_group
        self._broadcast = broadcast or broadcast_replicated
        self._proc_ranks: Tuple[int, ...] = tuple(
            range(mesh.world()) if ranks is None else ranks)
        if self.cfg.rank not in self._proc_ranks:
            raise ValueError(f"rank {self.cfg.rank} is not in the world {self._proc_ranks}")
        self.epoch = 0                     # last committed rendezvous epoch
        self.peer_failures = 0
        self.remesh_count = 0
        self.cascade_count = 0             # failures converted DURING a remesh
        self.readmit_count = 0
        self.dropped_ef_norm = 0.0         # a live remesh cannot know the lost norm
        self.remesh_latency_ms = 0.0       # latest remesh's host latency
        self.remesh_ms = 0.0               # cumulative remesh + readmit downtime
        self.readmit_ms = 0.0              # latest readmission's host latency
        # the delta StreamWriter (rank 0 only): every committed transition
        # requests a keyframe, and a warm readmission flushes it first
        self.stream = stream
        # whether the stream is armed on EVERY process (--stream_dir): the
        # warm decision keys on this shared value and on the survivors'
        # agreed answer to whether one of them holds the writer, never on
        # self.stream alone, which only rank 0 holds; defaults to following
        # ``stream``
        self.stream_armed = stream is not None if stream_armed is None else bool(stream_armed)
        self.stream_rejoin_bytes = 0.0     # newest warm rejoin's byte cost
        # the harness's position (its next epoch, its data order's RNG state),
        # kept current by the harness and sent to joiners with the state
        self.shared: Dict[str, Any] = {}
        self._step = 0
        self._beat_stop = threading.Event()
        self._beater = None
        if gossip is not None:
            # beat from a thread: a process blocked in a collective on a dead
            # peer must not read as dead itself
            gossip.beat(0)
            self._beater = threading.Thread(target=self._beat_loop, daemon=True,
                                            name="tcdp-elastic-gossip")
            self._beater.start()

    # -- the world -------------------------------------------------------
    @property
    def world(self) -> int:
        return len(self._proc_ranks)

    @property
    def ranks(self) -> Tuple[int, ...]:
        """The current world's ORIGINAL ranks, in group-rank order."""
        return self._proc_ranks

    @property
    def rank(self) -> int:
        """This process's rank in the current group."""
        return self._proc_ranks.index(self.cfg.rank)

    def _beat_loop(self) -> None:
        period = self.cfg.peer_timeout_s / 8
        while not self._beat_stop.wait(period):
            try:
                self.gossip.beat(self._step)
            except OSError:
                pass  # a full disk: the next beat retries

    def close(self) -> None:
        """Stop the gossip beat (the harnesses call it in their finally)."""
        self._beat_stop.set()
        if self._beater is not None:
            self._beater.join(timeout=self.cfg.peer_timeout_s)

    def _reinit_group(self, decision) -> None:
        from tpu_compressed_dp_torch.train.rendezvous import reinit_distributed

        reinit_distributed(decision, device=self._device,
                           timeout_s=self.cfg.peer_timeout_s, log=self._log)

    # -- detection -------------------------------------------------------
    def poll(self, step: Optional[int] = None) -> None:
        """Sweep the peers' heartbeats; raises :class:`PeerFailed` on
        newly-dead peers of the current world.  (This process's own beat
        runs on the runtime's thread.)"""
        if step is not None:
            self._step = int(step)
        if self.gossip is not None:
            newly = {r: why for r, why in self.gossip.check().items()
                     if r in self._proc_ranks}
            if newly:
                raise PeerFailed(newly, step=step, reason="; ".join(
                    f"rank {r}: {why}" for r, why in sorted(newly.items())))

    def bounded_get(self, thunk: Callable[[], Any], *, step: Optional[int] = None,
                    what: str = "step metrics fetch"):
        """``thunk()`` (a device-to-host copy) with the peer-timeout deadline."""
        return fetch_with_timeout(thunk, self.cfg.peer_timeout_s, step=step, what=what)

    def _gossip_names(self) -> Tuple[int, ...]:
        """The current world's dead peers by the gossip, waiting up to twice
        the peer timeout for a dead peer's file to go stale."""
        deadline = time.monotonic() + 2 * self.cfg.peer_timeout_s
        while True:
            self.gossip.check()
            dead = tuple(r for r in self.gossip.dead if r in self._proc_ranks)
            if dead or time.monotonic() >= deadline:
                return dead
            time.sleep(min(0.05, self.cfg.peer_timeout_s / 20))

    def failure_from(self, exc: BaseException) -> Optional[PeerFailed]:
        """Translate an exception into the coordinated failure it signals,
        or None for faults that are not elastic's to handle.

        * :class:`PeerFailed` passes through; an empty culprit list is
          filled in from the gossip's dead set.
        * A collective that failed on its group (:func:`is_collective_error`)
          is a :class:`PeerFailed` with no culprit, filled in the same way.
        * A ``mid_collective`` or ``during_remesh``
          :class:`~tpu_compressed_dp_torch.utils.chaos.ChaosCrash` becomes
          the death of ``chaos.worker``.
        """
        from tpu_compressed_dp_torch.utils.chaos import ChaosCrash

        if not isinstance(exc, PeerFailed) and is_collective_error(exc):
            first = str(exc).strip().splitlines()[0] if str(exc).strip() else type(exc).__name__
            exc = PeerFailed((), step=getattr(exc, "step", None),
                             reason=f"a collective failed: {first[:200]}")
        if isinstance(exc, PeerFailed):
            if not exc.failed and self.gossip is not None:
                dead = self._gossip_names()
                if dead:
                    return PeerFailed(dead, step=exc.step,
                                      reason=f"{exc.reason}; gossip names {list(dead)}")
            return exc
        if (isinstance(exc, ChaosCrash)
                and getattr(exc, "mode", "step") in ("mid_collective", "during_remesh")):
            return PeerFailed((getattr(exc, "worker", 0),),
                              step=getattr(exc, "step", None),
                              reason=("chaos kill during remesh"
                                      if exc.mode == "during_remesh"
                                      else "chaos mid-collective kill"))
        return None

    # -- remesh ----------------------------------------------------------
    def handle_failure(self, state, failure: PeerFailed):
        """Coordinated abort + remesh: agree on the surviving world through
        the rendezvous, re-initialise the process group over it, and agree
        the replicated state from the new coordinator.  Returns the state in
        the new world; the caller rebuilds its step for :attr:`world`.

        ``failure.failed`` are ORIGINAL ranks.  A rank among them leaves
        with :class:`PeerFailed` ("this rank is among the declared dead")
        for the watchdog.  Cascading failures: a peer dying while the
        survivors are inside this handler (the ``crash=during_remesh``
        chaos phase plays it) unions the dead set before anything is
        committed; a union below ``min_world`` raises :class:`PeerFailed`
        on every survivor, nothing committed."""
        from tpu_compressed_dp_torch.utils.chaos import ChaosCrash

        if not failure.failed:
            raise failure
        # dump the blackbox NOW, while the evidence is fresh: the dead
        # peer's why/when must survive a cascade that kills us mid-remesh
        if self.flight is not None:
            self.flight.observe(failure, step=failure.step)
        t0 = time.monotonic()
        dead = {int(f) for f in failure.failed}
        reason = failure.reason
        while True:
            live = [r for r in self._proc_ranks if r not in dead]
            if self.cfg.rank not in live:
                raise PeerFailed(sorted(dead), step=failure.step,
                                 reason=f"{reason}; this rank is among the declared "
                                        "dead — exiting for the watchdog")
            if len(live) < self.cfg.min_world:
                err = PeerFailed(
                    sorted(dead), step=failure.step,
                    reason=(f"{reason}; surviving world {len(live)} below min_world "
                            f"{self.cfg.min_world} — not remeshing"))
                if self.flight is not None:
                    self.flight.observe(err, step=failure.step)
                raise err
            # a second death while we are mid-remesh: probe the chaos
            # injector's during_remesh phase BEFORE committing
            if self.crash is not None:
                try:
                    probe = (failure.step if failure.step is not None
                             else getattr(self.crash, "crash_at_step", 0))
                    self.crash.check(probe, phase="during_remesh")
                except ChaosCrash as e:
                    more = self.failure_from(e)
                    if more is not None and more.failed:
                        extra = set(more.failed) - dead
                        dead |= set(more.failed)
                        self.cascade_count += 1
                        self.peer_failures += len(extra)
                        reason = f"{reason}; then {more.reason}"
                        self._log(f"elastic: peer(s) {sorted(more.failed)} died during "
                                  f"the remesh — re-entering failure handling over "
                                  f"{sorted(dead)}")
                        self._record("remesh_cascade", step=failure.step,
                                     failed=sorted(dead), added=sorted(extra))
                        continue
            break
        if self.rendezvous is None:
            raise PeerFailed(sorted(dead), step=failure.step,
                             reason=f"{reason}; no rendezvous directory (--elastic_dir) to "
                                    "agree a new world through")
        old = len(self._proc_ranks)
        decision = self.rendezvous.propose(live, deadline_s=self.cfg.peer_timeout_s * 4)
        state = self._enter(state, decision)
        if self.gossip is not None:
            self.gossip.note_dead(dead, reason)
        self.peer_failures += len(set(failure.failed))
        self.remesh_count += 1
        self.remesh_latency_ms = (time.monotonic() - t0) * 1e3
        self.remesh_ms += self.remesh_latency_ms
        self._log(f"elastic: epoch {decision.epoch}: re-initialised {old} -> {self.world} "
                  f"processes {list(decision.ranks)} after {reason}; ef_unrecoverable: the "
                  f"dead peers' EF rows are lost (dropped, norm unknown); "
                  f"{self.remesh_latency_ms:.0f} ms")
        if self.events is not None:
            self.events.emit("remesh", step=failure.step, failed=sorted(dead),
                             world=self.world, epoch=decision.epoch, ef_policy="drop",
                             ef_unrecoverable=True, dropped_ef_norm=float("nan"),
                             latency_ms=self.remesh_latency_ms, remesh_ms=self.remesh_ms)
        if self.flight is not None:
            self.flight.record("elastic", "remesh", step=failure.step, failed=sorted(dead),
                               world=self.world, epoch=decision.epoch, ef_policy="drop",
                               latency_ms=self.remesh_latency_ms)
        self._stream_keyframe()
        return state

    def _stream_keyframe(self) -> None:
        """Re-anchor the delta stream after a committed world transition: a
        consumer must never need segments that straddle a membership change
        to reconstruct the state after it."""
        st = self.stream
        if st is not None:
            try:
                st.request_keyframe()
            except Exception:
                pass  # the stream tee must never fail a remesh

    def _record(self, kind: str, **fields) -> None:
        """One elastic record on the event stream and the flight ring."""
        if self.events is not None:
            self.events.emit(kind, **fields)
        if self.flight is not None:
            self.flight.record("elastic", kind, **fields)

    def _enter(self, state, decision, *, joining: bool = False, readmit: bool = False):
        """Join the committed world and agree the replicated state from its
        coordinator (survivors and joiners alike).  A readmission first
        waits for every rank on a barrier with a longer deadline than the
        group's: a joiner builds its model and data after it entered the
        group, while the survivors are already waiting to broadcast.  A
        joiner entered the committed group when it launched
        (``harness/loop.elastic_distributed_init``).  The committed
        ``decision.warm`` bit, the same record on every rank, leaves the
        parameters out of the broadcast."""
        if not joining:
            self._reinit(decision)
        if (joining or readmit) and self._broadcast is broadcast_replicated:
            settle_barrier(max(60.0, 4 * self.cfg.peer_timeout_s))
        src = decision.ranks.index(decision.coordinator)
        extras = {"ckpt": self.ckpt.sequence() if self.ckpt is not None else None,
                  "shared": self.shared}
        state, extras = self._broadcast(state, src, extras=extras,
                                        params=not getattr(decision, "warm", False))
        seq, self.shared = extras["ckpt"], dict(extras["shared"])
        if joining and not _empty(state.ef):
            with torch.no_grad():
                for t in _leaves(state.ef):
                    t.zero_()
        self._proc_ranks = tuple(decision.ranks)
        self.epoch = decision.epoch
        if self.ckpt is not None:
            self.ckpt.follow_world(self.rank, self.world,
                                   layout=self.ckpt_layout(self.world) if self.ckpt_layout
                                   else None, sequence=seq)
        return state

    # -- re-admission ----------------------------------------------------
    def _agreed_joins(self, ready: Sequence[int], device) -> List[int]:
        """The pending joins every survivor saw: one MIN all-reduce of a
        flag a rank, so a join file that lands while the survivors read the
        directory cannot split their proposals."""
        n = max([*self._proc_ranks, *ready, 0]) + 1
        n = max(n, self.gossip.world if self.gossip is not None else 0)
        flags = torch.zeros(n, dtype=torch.float32, device=device)
        for r in ready:
            flags[r] = 1.0
        if mesh.world() > 1:
            flags = -mesh.all_reduce_max(-flags)
        return [int(r) for r in torch.nonzero(flags).flatten().tolist()]

    def _agreed_warm(self, ready: Sequence[int], joins: Dict[int, dict], device) -> bool:
        """Whether a readmission of ``ready`` can be warm, the same answer on
        every survivor (one MAX all-reduce): the stream is armed on every
        process, every joiner's record carries ``stream`` (it could catch
        up), and a survivor holds the writer.  With the writer's process
        dead no survivor can flush the stream to the live parameters, and a
        joiner would adopt a stale reconstruction."""
        if not self.stream_armed:
            return False
        can = all((joins.get(r) or {}).get("stream") is not None for r in ready)
        # [any survivor holds the writer, -(every survivor saw records that can)]
        flags = torch.tensor([float(self.stream is not None), -float(can)], device=device)
        if mesh.world() > 1:
            flags = mesh.all_reduce_max(flags)
        return bool(flags[0] > 0 and flags[1] < 0)

    def rejoin_barrier(self, state):
        """Survivor half of scale-up, called at an epoch boundary: fold the
        join requests every survivor sees (watchdog-relaunched processes
        waiting in :meth:`Rendezvous.join`) into a new world epoch,
        re-initialise, and send the joiners the replicated state.  Returns
        ``(state, changed)``; the caller rebuilds its step when
        ``changed``.

        Warm (:meth:`_agreed_warm`): the writer's rank flushes the stream
        first, so its head reconstructs to the live parameters bitwise, and
        the commit carries ``warm``."""
        if self.rendezvous is None:
            return state, False
        joins = self.rendezvous.pending_joins()
        mine = sorted(set(joins) - set(self._proc_ranks))
        device = next(iter(state.model.parameters())).device
        ready = self._agreed_joins(mine, device)
        if not ready:
            return state, False
        t0 = time.monotonic()
        new_ranks = sorted(set(self._proc_ranks) | set(ready))
        want_warm = self._agreed_warm(ready, joins, device)
        if want_warm and self.stream is not None:
            self.stream.sync(state.model, step=int(state.step))
        # only survivors vote (the joiners are parked in Rendezvous.join);
        # the coordinator is therefore a survivor, the broadcast's source
        decision = self.rendezvous.propose(new_ranks, voters=self._proc_ranks,
                                           warm=want_warm,
                                           deadline_s=self.cfg.peer_timeout_s * 4)
        state = self._enter(state, decision, readmit=True)
        self.readmit_count += len(ready)
        if self.gossip is not None:
            for r in ready:
                self.gossip.readmit(r)
        self.readmit_ms = (time.monotonic() - t0) * 1e3
        self.remesh_ms += self.readmit_ms
        self._log(f"elastic: epoch {decision.epoch}: readmitted process(es) {ready} -> "
                  f"world {self.world} ({self.readmit_ms:.0f} ms)")
        self._record("readmit", ranks=ready, world=self.world, epoch=decision.epoch,
                     warm=bool(getattr(decision, "warm", False)))
        self._stream_keyframe()
        return state, True

    def join_world(self, state, decision, *, adopted_params=None, adopted_info=None):
        """Joiner half of scale-up: called by a relaunched harness right
        after it initialised into the committed world with the
        :class:`~tpu_compressed_dp_torch.train.rendezvous.EpochDecision` its
        join returned.  The fresh-init state supplies shapes; the
        replicated values and the compressor state come from the
        coordinator's broadcast, and the EF starts at zero.  :attr:`shared`
        then holds the survivors' position (the harness resumes there).

        ``adopted_params`` (``{key: tensor}``, ``stream/rejoin.py``) is the
        warm rejoin's reconstruction, ``adopted_info`` its accounting.  The
        broadcast's layout follows the COMMITTED ``decision.warm`` bit, the
        record the survivors read, never the local outcome: a warm commit
        takes the parameters from the stream, and one with no adoption in
        hand raises (joining the parameter-skipping broadcast with fresh-init
        parameters would train from garbage; the watchdog relaunches and the
        next probe re-decides), and so does an adoption that is not the
        survivors' parameters: one the reader did not reconstruct exactly, or
        of another step than the broadcast's; a cold commit discards any
        catch-up."""
        warm = bool(getattr(decision, "warm", False))
        if warm and adopted_params is None:
            from tpu_compressed_dp_torch.train.rendezvous import RendezvousError

            raise RendezvousError(
                f"epoch {decision.epoch} committed warm (the survivors skip the params "
                "broadcast) but this joiner holds no stream reconstruction to adopt — "
                "exiting for the watchdog to relaunch; the next join probe re-decides "
                "warm vs cold")
        if warm:
            from tpu_compressed_dp_torch.stream.rejoin import adopt_params

            adopt_params(state.model, adopted_params)
            self.stream_rejoin_bytes = float((adopted_info or {}).get("bytes", 0))
            if self.flight is not None:
                self.flight.record("stream", "warm_join", epoch=decision.epoch,
                                   **dict(adopted_info or {}))
        elif adopted_params is not None:
            self._log(f"elastic: stream catch-up unused — epoch {decision.epoch} committed a "
                      "cold (full broadcast) admission")
        state = self._enter(state, decision, joining=True)
        if warm:
            info = adopted_info or {}
            if not info.get("exact") or info.get("step") != int(state.step):
                from tpu_compressed_dp_torch.train.rendezvous import RendezvousError

                raise RendezvousError(
                    f"epoch {decision.epoch} committed warm but the stream reconstruction "
                    f"this joiner adopted (step {info.get('step')}, exact "
                    f"{info.get('exact')}) is not the survivors' parameters at step "
                    f"{int(state.step)} — exiting for the watchdog to relaunch")
        if self.gossip is not None:
            self.gossip.note_dead(set(range(self.gossip.world)) - set(decision.ranks),
                                  "not in the world this process joined")
        self._log(f"elastic: rejoined world epoch {decision.epoch} as process "
                  f"{decision.process_id}/{decision.num_processes}")
        return state

    # -- accounting ------------------------------------------------------
    def metrics(self) -> Dict[str, float]:
        """The ``elastic/*`` keys of the JAX runtime and its
        ``stream/rejoin_bytes`` (the newest warm rejoin's bytes read)."""
        return {
            "elastic/peer_failures": float(self.peer_failures),
            "elastic/remesh_count": float(self.remesh_count),
            "elastic/dropped_ef_norm": float(self.dropped_ef_norm),
            "elastic/remesh_latency_ms": float(self.remesh_latency_ms),
            "elastic/remesh_ms": float(self.remesh_ms),
            "stream/rejoin_bytes": float(self.stream_rejoin_bytes),
        }
