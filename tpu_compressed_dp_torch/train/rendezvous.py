"""File-based rendezvous: how a multi-process elastic world agrees to change.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.train.rendezvous`, a
copy of its protocol with the same record schema and file names, so either
package reads the other's directory.  The port runs one process per worker
in a ``torch.distributed`` process group; when a peer dies, every
collective over the old group fails or hangs until the group is torn down
and re-initialised over the survivors.  This module is the agreement
protocol for that teardown, built from the same primitives as the gossip
plane (atomic tmp+``os.replace`` JSON files over the shared
``--elastic_dir``, the ``TCDP_RESTART_COUNT`` incarnation scheme):

  * **epoch file** (``epoch.json``) — the committed world: monotone
    ``epoch`` counter, the surviving original ranks, the re-elected
    coordinator (lowest surviving rank) and its ``host:port``.  One atomic
    replace per transition; readers never see a torn record.
  * **vote files** (``vote.e<E>.rank<R>.json``) — rank R's proposal for
    epoch E: the survivor set it believes in, plus its advertised host.
    The transition commits only when every proposed survivor has voted the
    SAME set (conflicting membership views raise — a split-brain world is
    worse than a dead one); the lowest surviving rank then writes the
    epoch file and everyone else adopts it.
  * **join files** (``join.rank<R>.json``) — a watchdog-relaunched process
    announcing itself (with its new incarnation) to the running world;
    survivors fold pending joins into the next epoch at a readmit barrier,
    and the joiner waits on the epoch file with a bounded deadline,
    falling back to park-and-retry (exit; the watchdog's backoff is the
    retry loop).

The coordinator port is ``base_port + epoch`` — deterministic, so every
survivor derives the same address without another round of agreement, and
a re-elected coordinator on the same host never collides with the dead
world's listener.  The harnesses take ``base_port`` from the launch's own
rendezvous port (``--coordinator``'s, or ``MASTER_PORT`` under
``torchrun``).  :func:`reinit_distributed` tears the old process group
down (``parallel/mesh.destroy``) and joins the committed one.

Everything here is plain files + injectable clocks, so the protocol is unit
tested single-process and deterministic.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

__all__ = [
    "EPOCH_ENV", "ADDR_ENV", "DIR_ENV",
    "RendezvousError", "RendezvousTimeout", "EpochDecision", "Rendezvous",
    "epoch_path", "read_epoch", "write_epoch", "export_env",
    "maybe_rejoin_from_env", "reinit_distributed", "DEFAULT_BASE_PORT",
]

#: Env vars ``harness/watchdog.py --relaunch --elastic_dir`` exports so a
#: restarted process rejoins the RUNNING world instead of forming a fresh one.
EPOCH_ENV = "TCDP_RENDEZVOUS_EPOCH"
ADDR_ENV = "TCDP_RENDEZVOUS_ADDR"
DIR_ENV = "TCDP_ELASTIC_DIR"

#: Coordinator port for epoch E is ``base_port + E`` (see module docstring).
DEFAULT_BASE_PORT = 51300


class RendezvousError(RuntimeError):
    """Unrecoverable disagreement (conflicting membership votes, a commit
    that excludes this rank): the safe move is a full restart, not a limp."""


class RendezvousTimeout(RendezvousError):
    """A bounded wait (vote quorum, join admission) expired.  For a joiner
    this is the park-and-retry exit: the join file stays behind and the
    watchdog's backoff schedules the next attempt."""


def _read_json(path: str) -> Optional[dict]:
    """Tolerant read: None for missing/torn/foreign content (same contract
    as ``utils.resilience.read_heartbeat`` — a reader never crashes on a
    writer's in-flight state, it just retries next poll)."""
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) else None


def _write_json(path: str, rec: dict) -> str:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, path)
    return path


def epoch_path(rdzv_dir: str) -> str:
    return os.path.join(rdzv_dir, "epoch.json")


def read_epoch(rdzv_dir: str) -> Optional[dict]:
    """The committed world record, or None before the first transition."""
    rec = _read_json(epoch_path(rdzv_dir))
    if rec is None or "epoch" not in rec or "ranks" not in rec:
        return None
    return rec


def write_epoch(rdzv_dir: str, rec: dict) -> str:
    os.makedirs(rdzv_dir, exist_ok=True)
    return _write_json(epoch_path(rdzv_dir), rec)


@dataclasses.dataclass(frozen=True)
class EpochDecision:
    """One committed world transition, as seen by one process.

    ``ranks`` are the surviving ORIGINAL launch ranks (sorted) — gossip
    files, gossip ranks, and parked-worker bookkeeping keep using them.
    ``process_id`` is this process's CONTIGUOUS index within ``ranks`` (its
    rank in the re-initialised process group), or None when the commit
    excludes this process (it must park and wait to be readmitted).

    ``warm`` is the committed warm-rejoin bit of a readmission epoch: the
    survivors decided (once, at the barrier) that the params tree is
    SKIPPED in the admission broadcast because every admitted joiner
    adopts it from the delta stream.  Survivors and joiners alike pick
    the broadcast layout from THIS bit — never from local state — so the
    collective's pytree structure agrees fleet-wide by construction
    (``ElasticRuntime.rejoin_barrier`` / ``join_world``).
    """

    epoch: int
    ranks: Tuple[int, ...]
    coordinator: int
    address: str
    process_id: Optional[int]
    warm: bool = False

    @property
    def num_processes(self) -> int:
        return len(self.ranks)


class Rendezvous:
    """One process's handle on the shared rendezvous directory.

    All waits poll with an injectable ``now``/``sleep`` pair (monotonic by
    default — wall-clock steps must not expire agreement deadlines), so
    unit tests script multi-rank interleavings deterministically from a
    single thread.
    """

    def __init__(self, rdzv_dir: str, rank: int, *,
                 host: str = "127.0.0.1",
                 base_port: int = DEFAULT_BASE_PORT,
                 now: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 wall: Callable[[], float] = time.time,
                 poll_s: float = 0.05):
        self.dir = rdzv_dir
        self.rank = int(rank)
        self.host = host
        self.base_port = int(base_port)
        self._now = now
        self._sleep = sleep
        # informational ts fields on shared-dir records; injectable so a
        # replayed transition writes byte-identical files (tcdp-lint TCDP101)
        self._wall = wall
        self.poll_s = float(poll_s)
        os.makedirs(rdzv_dir, exist_ok=True)

    # -- committed world -------------------------------------------------
    def current(self) -> Optional[dict]:
        return read_epoch(self.dir)

    def decision_from(self, rec: dict) -> EpochDecision:
        ranks = tuple(sorted(int(r) for r in rec["ranks"]))
        pid = ranks.index(self.rank) if self.rank in ranks else None
        return EpochDecision(
            epoch=int(rec["epoch"]), ranks=ranks,
            coordinator=int(rec.get("coordinator", ranks[0])),
            address=str(rec["address"]), process_id=pid,
            warm=bool(rec.get("warm", False)))

    # -- votes -----------------------------------------------------------
    def _vote_path(self, epoch: int, rank: int) -> str:
        return os.path.join(self.dir, f"vote.e{int(epoch)}.rank{int(rank)}.json")

    def vote(self, epoch: int, survivors: Iterable[int]) -> None:
        _write_json(self._vote_path(epoch, self.rank), {
            "epoch": int(epoch), "rank": self.rank,
            "survivors": sorted(int(s) for s in survivors),
            "host": self.host, "ts": self._wall()})

    def read_votes(self, epoch: int) -> Dict[int, dict]:
        votes: Dict[int, dict] = {}
        pattern = os.path.join(self.dir, f"vote.e{int(epoch)}.rank*.json")
        for path in glob.glob(pattern):
            m = re.search(r"rank(\d+)\.json$", path)
            rec = _read_json(path) if m else None
            if m and rec is not None and int(rec.get("epoch", -1)) == int(epoch):
                votes[int(m.group(1))] = rec
        return votes

    def _gc_votes(self, committed_epoch: int) -> None:
        # best-effort: stale votes of already-committed epochs are noise,
        # never consulted (read_votes keys on the exact epoch)
        for path in glob.glob(os.path.join(self.dir, "vote.e*.rank*.json")):
            m = re.search(r"vote\.e(\d+)\.", path)
            if m and int(m.group(1)) <= int(committed_epoch):
                try:
                    os.remove(path)
                except OSError:
                    pass

    # -- the transition --------------------------------------------------
    def propose(self, members: Iterable[int], *,
                voters: Optional[Iterable[int]] = None,
                warm: bool = False,
                deadline_s: float = 60.0) -> EpochDecision:
        """Agree on the next epoch over ``members`` (which must include
        this rank).  Every VOTER calls this with the same member set (they
        all derived it from the same coordinated :class:`PeerFailed` or
        the same join files); the lowest voting rank commits the epoch
        file once all votes agree, everyone returns the committed
        decision.  ``voters`` defaults to the members — a readmission
        barrier passes the SURVIVOR subset, because pending joiners are
        parked in :meth:`join` and cannot vote (and the re-elected
        coordinator must be a survivor: it is the broadcast source for
        the replicated state the joiner is missing).  ``warm`` is the
        readmission barrier's warm-rejoin bit; every voter derives it
        from the same immutable join records, the leader publishes it in
        the commit, and BOTH sides of the admission broadcast take their
        layout from the committed record (:class:`EpochDecision`).  A
        commit that lands with a HIGHER epoch than proposed (a cascade
        won the race) is adopted as long as it still names this rank."""
        members = tuple(sorted({int(s) for s in members}))
        voters = (members if voters is None
                  else tuple(sorted({int(v) for v in voters})))
        if self.rank not in members:
            raise RendezvousError(
                f"rank {self.rank} proposing a world {members} that "
                "excludes itself")
        if self.rank not in voters or not set(voters) <= set(members):
            raise RendezvousError(
                f"voters {voters} must include this rank and be a subset "
                f"of the members {members}")
        cur = self.current()
        epoch = (int(cur["epoch"]) if cur else 0) + 1
        self.vote(epoch, members)
        leader = voters[0]
        deadline = self._now() + float(deadline_s)
        while True:
            rec = self.current()
            if rec is not None and int(rec["epoch"]) >= epoch:
                if self.rank not in [int(r) for r in rec["ranks"]]:
                    raise RendezvousError(
                        f"epoch {rec['epoch']} committed without rank "
                        f"{self.rank}: {sorted(rec['ranks'])}")
                return self.decision_from(rec)
            votes = self.read_votes(epoch)
            if set(votes) >= set(voters):
                worlds = {tuple(v.get("survivors", ())) for r, v in
                          votes.items() if r in voters}
                if worlds != {members}:
                    raise RendezvousError(
                        f"conflicting membership votes for epoch {epoch}: "
                        f"{sorted(worlds)} — split-brain, not committing")
                if self.rank == leader:
                    host = str(votes[leader].get("host", self.host))
                    rec = {"epoch": epoch, "ranks": list(members),
                           "coordinator": leader,
                           "address": f"{host}:{self.base_port + epoch}",
                           "warm": bool(warm), "ts": self._wall()}
                    write_epoch(self.dir, rec)
                    self._gc_votes(epoch)
                    return self.decision_from(rec)
            if self._now() >= deadline:
                missing = sorted(set(voters) - set(votes))
                raise RendezvousTimeout(
                    f"epoch {epoch} vote quorum not reached in "
                    f"{deadline_s:g}s (missing votes from {missing})")
            self._sleep(self.poll_s)

    # -- joins -----------------------------------------------------------
    def _join_path(self, rank: int) -> str:
        return os.path.join(self.dir, f"join.rank{int(rank)}.json")

    def request_join(self, *, incarnation: int = 0,
                     stream_seq: Optional[int] = None) -> None:
        rec = {"rank": self.rank, "incarnation": int(incarnation),
               "host": self.host, "ts": self._wall()}
        if stream_seq is not None:
            # warm rejoin: this joiner caught up from the delta stream
            # through segment `stream_seq` — survivors reading the flag
            # flush the stream and skip the params broadcast
            # (ElasticRuntime.rejoin_barrier)
            rec["stream"] = int(stream_seq)
        _write_json(self._join_path(self.rank), rec)

    def pending_joins(self) -> Dict[int, dict]:
        """Relaunched hosts waiting for admission (rank -> join record)."""
        joins: Dict[int, dict] = {}
        for path in glob.glob(os.path.join(self.dir, "join.rank*.json")):
            m = re.search(r"rank(\d+)\.json$", path)
            rec = _read_json(path) if m else None
            if m and rec is not None:
                joins[int(m.group(1))] = rec
        return joins

    def clear_join(self, rank: int) -> None:
        try:
            os.remove(self._join_path(rank))
        except OSError:
            pass

    def join(self, *, incarnation: int = 0,
             stale_epoch: Optional[int] = None,
             deadline_s: float = 60.0,
             stream_seq: Optional[int] = None) -> Optional[EpochDecision]:
        """A relaunched host's admission wait: announce, then poll for a
        commit that names this rank.  ``stale_epoch`` is the epoch the
        relaunch env advertised — the world this process DIED out of; only
        a strictly newer commit admits (the stale epoch file may still
        list us).  ``stream_seq`` advertises a warm rejoin (see
        :meth:`request_join`).  Returns None on deadline (park-and-retry:
        the join file stays behind, the caller exits, the watchdog
        retries)."""
        self.request_join(incarnation=incarnation, stream_seq=stream_seq)
        deadline = self._now() + float(deadline_s)
        while True:
            rec = self.current()
            if (rec is not None
                    and self.rank in [int(r) for r in rec["ranks"]]
                    and (stale_epoch is None
                         or int(rec["epoch"]) > int(stale_epoch))):
                self.clear_join(self.rank)
                return self.decision_from(rec)
            if self._now() >= deadline:
                return None
            self._sleep(self.poll_s)


# -------------------------------------------------- relaunch env plumbing

def export_env(env: dict, rec: dict) -> dict:
    """Stamp the committed epoch into a child environment (the watchdog's
    half of rejoin): the relaunched harness reads these back through
    :func:`maybe_rejoin_from_env`."""
    env[EPOCH_ENV] = str(int(rec["epoch"]))
    env[ADDR_ENV] = str(rec.get("address", ""))
    return env


def maybe_rejoin_from_env(rdzv_dir: Optional[str], rank: int, *,
                          deadline_s: float = 300.0,
                          env: Optional[dict] = None,
                          stream_seq: Optional[int] = None,
                          **rdzv_kw) -> Optional[EpochDecision]:
    """The relaunched harness's entry: if the environment carries a
    rendezvous epoch (the watchdog saw a running world when it respawned
    us), wait in the join barrier for admission and return the decision to
    initialise against.  Returns None when there is nothing to rejoin (a
    fresh launch).  Raises :class:`RendezvousTimeout` when the deadline
    expires — the caller exits nonzero and the watchdog's backoff is the
    retry (park-and-retry)."""
    env = os.environ if env is None else env
    if EPOCH_ENV not in env:
        return None
    rdzv_dir = rdzv_dir or env.get(DIR_ENV)
    if not rdzv_dir:
        return None
    try:
        stale_epoch = int(env[EPOCH_ENV])
    except ValueError:
        stale_epoch = None
    try:
        incarnation = int(env.get("TCDP_RESTART_COUNT", "0") or 0)
    except ValueError:
        incarnation = 0
    rdzv = Rendezvous(rdzv_dir, rank, **rdzv_kw)
    decision = rdzv.join(incarnation=incarnation, stale_epoch=stale_epoch,
                         deadline_s=deadline_s, stream_seq=stream_seq)
    if decision is None:
        raise RendezvousTimeout(
            f"rank {rank} not admitted within {deadline_s:g}s — parking "
            "(join request left behind; the watchdog retries)")
    return decision


def reinit_distributed(decision: EpochDecision, *,
                       shutdown: Optional[Callable[[], None]] = None,
                       initialize: Optional[Callable[..., None]] = None,
                       device=None, timeout_s: Optional[float] = None,
                       log: Callable[[str], None] = print) -> None:
    """Tear down the dead world's process group and bring up the committed
    one: ``shutdown`` (default ``parallel/mesh.destroy``, which also drops
    the cached subgroups; a group wedged on a dead peer may raise, which is
    tolerated), then ``initialize`` (default ``mesh.init_process_group``)
    against the re-elected coordinator, ``tcp://<decision.address>``, with
    this process's new contiguous rank, with the old group's backend.
    ``device`` and ``timeout_s`` (the group's collective timeout) pass
    through to the default ``initialize``; both callables are injectable
    for the single-process unit tests.  Unlike the JAX runtime, a world of
    one process still gets its (1-rank) group: the port's steps and
    checkpoints read the world off the group."""
    if decision.process_id is None:
        raise RendezvousError(
            f"cannot re-initialise into epoch {decision.epoch}: this "
            "process is not in the committed world")
    from tpu_compressed_dp_torch.parallel import mesh

    shutdown = mesh.destroy if shutdown is None else shutdown
    if initialize is None:
        backend = mesh.backend()

        def initialize(*, init_method, world_size, rank):
            mesh.init_process_group("cpu" if device is None else device, backend=backend,
                                    init_method=init_method, world_size=world_size,
                                    rank=rank, timeout_s=timeout_s)
    try:
        shutdown()
    except Exception as e:  # a group wedged on the dead peer
        log(f"rendezvous: process group shutdown raised {e!r} (continuing "
            "into re-init)")
    initialize(init_method=f"tcp://{decision.address}",
               world_size=decision.num_processes, rank=decision.process_id)
