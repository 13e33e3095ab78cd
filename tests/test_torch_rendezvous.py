"""The port's file rendezvous (``train/rendezvous.py``) against the JAX
package's, over one directory, with scripted clocks.

Each package proposes and the other reads the committed ``epoch.json``;
conflicting votes raise in both with the same message; a joiner's wait, the
relaunch environment (``export_env`` / ``maybe_rejoin_from_env``) and the
records themselves (epoch, vote and join files, with ``wall`` injected) are
equal field for field; the port's ``reinit_distributed`` tears the old group
down and joins the committed one through injected callables.
"""

import json
import os

import pytest

from tpu_compressed_dp.train import rendezvous as jr
from tpu_compressed_dp_torch.train import rendezvous as tr

PKGS = {"jax": jr, "torch": tr}


class Clock:
    """A scripted monotonic clock whose ``sleep`` advances it and runs a
    hook (the other ranks' moves in a single-threaded script)."""

    def __init__(self, hook=None):
        self.t = 100.0
        self.hook = hook

    def now(self):
        return self.t

    def sleep(self, s):
        self.t += s
        if self.hook is not None:
            self.hook(self.t)


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            out[name] = json.load(f)
    return out


def _rdzv(pkg, d, rank, clock, **kw):
    return PKGS[pkg].Rendezvous(d, rank, now=clock.now, sleep=clock.sleep,
                                wall=lambda: 1234.5, base_port=40000, **kw)


@pytest.mark.parametrize("leader,follower", [("torch", "jax"), ("jax", "torch")])
def test_propose_commits_across_packages(tmp_path, leader, follower):
    """Ranks 1 and 2 (one package) vote, rank 0 (the other) commits epoch 1
    and rank 1 adopts it; then rank 2 proposes epoch 2 without rank 1 and
    waits while rank 0 commits it.  The directory's records and the
    decisions are an all-JAX run's."""
    runs = {}
    for label, (p0, p1) in {"mixed": (leader, follower), "jax": ("jax", "jax")}.items():
        d = str(tmp_path / label)
        hooks = []
        clock = Clock(lambda t: hooks and hooks.pop()())
        r0, r1, r2 = (_rdzv(p, d, r, clock) for p, r in ((p0, 0), (p1, 1), (p1, 2)))
        r1.vote(1, [0, 1, 2])
        r2.vote(1, [2, 0, 1])
        d0 = r0.propose([0, 1, 2])
        d1 = r1.decision_from(r1.current())
        decided = []
        hooks.append(lambda: decided.append(r0.propose([0, 2])))
        d2 = r2.propose([0, 2])
        runs[label] = ([d0, d1, d2, decided[0]], _files(d), PKGS[p1].read_epoch(d))
    (got, files, read), (want, jfiles, jread) = runs["mixed"], runs["jax"]
    for a, b in zip(got, want):
        assert (a.epoch, a.ranks, a.coordinator, a.address, a.process_id, a.warm,
                a.num_processes) == (b.epoch, b.ranks, b.coordinator, b.address,
                                     b.process_id, b.warm, b.num_processes)
    assert got[1].process_id == 1 and got[2].ranks == (0, 2) and got[2].process_id == 1
    assert got[2].address == "127.0.0.1:40002" and got[3].process_id == 0
    assert files == jfiles and read == jread
    # the committed epochs' votes are collected
    assert not [n for n in files if n.startswith("vote.")]


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_vote_conflict_and_quorum_timeout_raise(tmp_path, pkg):
    msgs = {}
    for p in ("torch", "jax"):
        d = str(tmp_path / p)
        clock = Clock()
        r0, r1 = _rdzv(p, d, 0, clock), _rdzv(pkg, d, 1, clock)
        r1.vote(1, [0, 1, 2])
        with pytest.raises(PKGS[p].RendezvousError) as e:
            r0.propose([0, 1])
        msgs[p] = str(e.value)
        assert "split-brain" in msgs[p]
        with pytest.raises(PKGS[p].RendezvousTimeout, match=r"missing votes from \[3\]"):
            _rdzv(p, str(tmp_path / f"{p}_t"), 0, Clock()).propose([0, 3], deadline_s=1.0)
        with pytest.raises(PKGS[p].RendezvousError, match="excludes itself"):
            r0.propose([1, 2])
    assert msgs["torch"] == msgs["jax"]


@pytest.mark.parametrize("joiner", ["torch", "jax"])
def test_join_readmission_across_packages(tmp_path, joiner):
    """A relaunched rank 2 (one package) parks in ``join`` until the
    survivors (the other package) commit a world naming it; its stale
    epoch's record does not admit it; the join file is cleared."""
    survivor = "jax" if joiner == "torch" else "torch"
    d = str(tmp_path)
    s_clock = Clock()
    s0 = _rdzv(survivor, d, 0, s_clock)
    s1 = _rdzv(survivor, d, 1, s_clock)
    s1.vote(1, [0, 1, 2])
    PKGS[survivor].write_epoch(d, {"epoch": 1, "ranks": [0, 1, 2], "coordinator": 0,
                                   "address": "127.0.0.1:40001", "ts": 0.0})

    def survivors(t):
        # the survivors see the join at their barrier and commit epoch 3
        joins = s0.pending_joins()
        if 2 in joins and (s0.current() or {}).get("epoch") == 2:
            assert joins[2]["incarnation"] == 5 and joins[2]["ts"] == 1234.5
            s1.vote(3, [0, 1, 2])
            s0.propose([0, 1, 2], voters=[0, 1])

    PKGS[survivor].write_epoch(d, {"epoch": 2, "ranks": [0, 1], "coordinator": 0,
                                   "address": "127.0.0.1:40002", "ts": 0.0})
    j_clock = Clock(survivors)
    j = _rdzv(joiner, d, 2, j_clock)
    dec = j.join(incarnation=5, stale_epoch=2, deadline_s=5.0)
    assert (dec.epoch, dec.ranks, dec.process_id, dec.address) == (3, (0, 1, 2), 2,
                                                                    "127.0.0.1:40003")
    assert j.pending_joins() == {}
    # no newer commit: the wait parks (None) and leaves the join file
    dec2 = _rdzv(joiner, d, 2, Clock()).join(incarnation=6, stale_epoch=3, deadline_s=0.2)
    assert dec2 is None and set(s0.pending_joins()) == {2}


def test_join_records_and_env_match(tmp_path):
    recs = {}
    for p in ("torch", "jax"):
        d = str(tmp_path / p)
        _rdzv(p, d, 3, Clock()).request_join(incarnation=2)
        recs[p] = _files(d)
        rec = {"epoch": 4, "ranks": [0, 3], "address": "h:9"}
        assert PKGS[p].export_env({}, rec) == {"TCDP_RENDEZVOUS_EPOCH": "4",
                                               "TCDP_RENDEZVOUS_ADDR": "h:9"}
    assert recs["torch"] == recs["jax"]
    for name in ("EPOCH_ENV", "ADDR_ENV", "DIR_ENV", "DEFAULT_BASE_PORT"):
        assert getattr(tr, name) == getattr(jr, name)


def test_maybe_rejoin_from_env(tmp_path):
    d = str(tmp_path)
    for p in ("torch", "jax"):
        assert PKGS[p].maybe_rejoin_from_env(d, 1, env={}) is None
        assert PKGS[p].maybe_rejoin_from_env(None, 1, env={"TCDP_RENDEZVOUS_EPOCH": "1"}) is None
    tr.write_epoch(d, {"epoch": 2, "ranks": [0, 1], "coordinator": 0,
                       "address": "127.0.0.1:40002", "ts": 0.0})
    env = {"TCDP_RENDEZVOUS_EPOCH": "1", "TCDP_ELASTIC_DIR": d, "TCDP_RESTART_COUNT": "3"}
    got = {p: PKGS[p].maybe_rejoin_from_env(None, 1, env=env, deadline_s=1.0,
                                            now=Clock().now, sleep=Clock().sleep)
           for p in ("torch", "jax")}
    assert (got["torch"].epoch, got["torch"].ranks, got["torch"].process_id) == \
        (got["jax"].epoch, got["jax"].ranks, got["jax"].process_id) == (2, (0, 1), 1)
    env["TCDP_RENDEZVOUS_EPOCH"] = "2"   # the world it died out of: not admitted
    for p in ("torch", "jax"):
        clock = Clock()
        with pytest.raises(PKGS[p].RendezvousTimeout, match="parking"):
            PKGS[p].maybe_rejoin_from_env(None, 1, env=env, deadline_s=0.5, now=clock.now,
                                          sleep=clock.sleep)


def test_reinit_distributed_injected():
    dec = tr.EpochDecision(epoch=2, ranks=(0, 3, 5), coordinator=0, address="10.0.0.1:51302",
                           process_id=1)
    calls, logs = [], []

    def shutdown():
        calls.append("shutdown")
        raise RuntimeError("wedged on the dead peer")

    tr.reinit_distributed(dec, shutdown=shutdown,
                          initialize=lambda **kw: calls.append(("init", kw)), log=logs.append)
    assert calls == ["shutdown", ("init", {"init_method": "tcp://10.0.0.1:51302",
                                           "world_size": 3, "rank": 1})]
    assert "wedged" in logs[0]
    # JAX's takes the same decision to the same coordinator and id
    jcalls = []
    jr.reinit_distributed(jr.EpochDecision(**{f: getattr(dec, f) for f in (
        "epoch", "ranks", "coordinator", "address", "process_id")}),
        shutdown=lambda: jcalls.append("shutdown"),
        initialize=lambda **kw: jcalls.append(("init", kw)), log=lambda s: None)
    assert jcalls == ["shutdown", ("init", {"coordinator_address": "10.0.0.1:51302",
                                            "num_processes": 3, "process_id": 1})]
    for pkg in (tr, jr):
        with pytest.raises(pkg.RendezvousError, match="not in the committed world"):
            pkg.reinit_distributed(pkg.EpochDecision(3, (0,), 0, "h:1", None),
                                   shutdown=lambda: None, initialize=lambda **kw: None)
    # a world of one still gets its group in the port (JAX skips the init)
    one = []
    tr.reinit_distributed(tr.EpochDecision(4, (2,), 2, "h:7", 0), shutdown=lambda: None,
                          initialize=lambda **kw: one.append(kw))
    assert one == [{"init_method": "tcp://h:7", "world_size": 1, "rank": 0}]
