"""The port's elastic runtime (``train/elastic.py``), its pure parts held to
the JAX package's.

  * ``ChaosConfig`` parses and round-trips ``crash=mid_collective``,
    ``crash=during_remesh`` and ``peer_timeout`` as JAX does, and the armed
    ``CrashInjector`` fires in its own phase only;
  * ``ElasticConfig`` validates as JAX's;
  * ``PeerGossip`` on one directory, each package reading the other's
    heartbeat files under one scripted clock: staleness, the beat's rate
    limit, incarnations and rejoin candidates, sweep by sweep equal;
  * ``fetch_with_timeout``: values, errors, the deadline, no leaked threads;
  * the migration functions (``migrate_ef`` fold and drop with its float64
    norm, ``migrate_comp``, ``expand_*``, ``shrink_state`` /
    ``expand_state`` with row groups) bitwise against JAX on the same numpy
    rows; ``TrimBatches``;
  * the runtime's ``failure_from`` conversions (chaos, a collective's
    error, the gossip filling a culprit in), the ``min_world`` refusal, the
    cascade union and ``metrics()``' key set against JAX's, with the
    rendezvous on a directory and the re-init and broadcast injected;
  * the port's watchdog's relaunch loop against the JAX one on a scripted
    child and check sequence;
  * the chaos drill's elastic rows (``harness/chaos_drill.py --elastic``),
    each in a world of 4 gloo processes: gossip, the remesh past worker 3
    and past worker 0 (the coordinator: rank 1 is re-elected), the
    readmission and the cascade (the policy x worker x step matrix runs
    from the command line).
"""

import argparse
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from tpu_compressed_dp.train import elastic as je
from tpu_compressed_dp.utils import chaos as jchaos
from tpu_compressed_dp_torch.train import elastic as te
from tpu_compressed_dp_torch.train import rendezvous as trdzv
from tpu_compressed_dp_torch.utils import chaos as tchaos
from tpu_compressed_dp_torch.utils.resilience import read_heartbeat

ELASTIC_SPECS = [
    "crash=mid_collective,crash_at_step=12,worker=3",
    "crash=mid_collective,crash_at_step=1,peer_timeout=0.5",
    "crash=during_remesh,crash_at_step=12,worker=3,peer_timeout=30",
    "nan,steps=3,crash=mid_collective,crash_at_step=4,worker=2",
    "crash_mode=during_remesh,crash=5",
    "crash=mid_collective,peer_timeout=-1",
    "crash=sideways,crash_at_step=1",
]


@pytest.mark.parametrize("spec", ELASTIC_SPECS)
def test_chaos_elastic_keys_match_jax(spec):
    try:
        want = jchaos.ChaosConfig.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tchaos.ChaosConfig.parse(spec)
        assert str(got.value) == str(e)
        return
    got = tchaos.ChaosConfig.parse(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_spec() == want.to_spec() and tchaos.ChaosConfig.parse(got.to_spec()) == got
    # the armed injectors fire at the same (step, phase) and carry the same
    jinj, tinj = jchaos.maybe_crash_injector(want), tchaos.maybe_crash_injector(got)
    assert (jinj is None) == (tinj is None)
    if jinj is None:
        return
    for step in range(0, 16):
        for phase in ("step", "mid_collective", "during_remesh"):
            outs = []
            for inj, exc in ((jinj, jchaos.ChaosCrash), (tinj, tchaos.ChaosCrash)):
                try:
                    inj.check(step, phase=phase)
                    outs.append(None)
                except exc as e:
                    outs.append((str(e), e.step, e.mode, e.worker))
            assert outs[0] == outs[1], (step, phase)


def test_elastic_config_validation_matches_jax():
    """The port's fields validate as JAX's.  JAX's ``ef_policy`` is not one:
    a live remesh always loses the dead worker's EF."""
    for kw in ({}, {"min_world": 1, "peer_timeout_s": 0.5}, {"gossip_dir": "/d", "rank": 3},
               {"peer_timeout_s": 0.0}, {"min_world": 0}):
        try:
            want = je.ElasticConfig(**kw)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                te.ElasticConfig(**kw)
            assert str(got.value) == str(e)
            continue
        want = dataclasses.asdict(want)
        assert want.pop("ef_policy") == "fold"
        assert dataclasses.asdict(te.ElasticConfig(**kw)) == want
    with pytest.raises(TypeError):
        te.ElasticConfig(ef_policy="drop")


@pytest.mark.parametrize("harness", ["dawn", "imagenet", "lm"])
def test_harness_elastic_ef_drops_and_refuses_fold(harness):
    """``--elastic_ef`` defaults to ``drop``, and ``fold`` is refused where
    the runtime is built: a dead process's EF cannot be folded."""
    import importlib

    from tpu_compressed_dp_torch.harness import loop

    parser = importlib.import_module(f"tpu_compressed_dp_torch.harness.{harness}").build_parser()
    assert parser.parse_args(["--elastic"]).elastic_ef == "drop"
    args = parser.parse_args(["--elastic", "--elastic_ef", "fold"])
    with pytest.raises(ValueError, match="EF residual lived only in its process"):
        loop.build_elastic(args, loop.Launch(rank=0, base_port=None))


# ------------------------------------------------------------------ gossip

class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def test_gossip_across_packages(tmp_path):
    """Rank 0 of each package watches ranks 1-3, whose files the two
    packages write in turn: both sweeps give the same verdicts at every
    tick (silence below and past the timeout, a stale lower incarnation, a
    restart, rejoin candidacy and readmission)."""
    d = str(tmp_path)
    clock = Clock()
    g = {"jax": je.PeerGossip(d, 0, 4, peer_timeout_s=5.0, incarnation=0, now=clock),
         "torch": te.PeerGossip(d, 0, 4, peer_timeout_s=5.0, incarnation=0, now=clock)}
    writers = [je.write_peer_heartbeat, te.write_peer_heartbeat]
    script = [
        # (advance, [(rank, step, incarnation)], readmit)
        (0.0, [(1, 0, 0), (2, 0, 0), (3, 0, 1)], None),
        (4.0, [(1, 1, 0), (3, 1, 1)], None),
        (4.0, [(1, 2, 0), (3, 2, 1)], None),      # rank 2: 8 s silent -> dead
        (1.0, [(1, 3, 0), (3, 3, 0)], None),      # rank 3: a stale lower life
        (1.0, [(1, 4, 0), (2, 0, 1)], None),      # rank 2 restarted: candidate
        (1.0, [(1, 5, 0), (3, 4, 2)], None),      # rank 3 advanced: dead + candidate
        (1.0, [(1, 6, 0), (2, 1, 1)], 2),
        (3.0, [(1, 7, 0), (2, 2, 1)], None),
        (7.0, [(2, 3, 1)], None),                 # rank 1 silent 7 s -> dead
    ]
    for i, (adv, writes, readmit) in enumerate(script):
        clock.t += adv
        for j, (rank, step, inc) in enumerate(writes):
            writers[(i + j) % 2](d, rank, step, incarnation=inc, ts=clock.t)
        if readmit is not None:
            for gg in g.values():
                gg.readmit(readmit)
        got = {k: (gg.check(), gg.dead, gg.rejoin_candidates()) for k, gg in g.items()}
        assert got["torch"] == got["jax"], (i, got)
    assert g["torch"].dead == (1, 3)
    for pkg, gg in g.items():
        with pytest.raises((je.PeerFailed, te.PeerFailed)):
            clock.t += 6.0
            gg.raise_if_dead(step=9)


def test_gossip_beat_rate_limit_and_record(tmp_path):
    clock = Clock()
    files = {}
    for pkg, mod in (("jax", je), ("torch", te)):
        d = str(tmp_path / pkg)
        clock.t = 1000.0
        g = mod.PeerGossip(d, 2, 3, peer_timeout_s=4.0, incarnation=7, now=clock)
        seen = []
        for dt in (0.0, 0.5, 0.6, 0.1, 2.0, 0.5):
            clock.t += dt
            g.beat(step=int(clock.t))
            seen.append(read_heartbeat(mod.heartbeat_path(d, 2)))
        files[pkg] = seen
    assert files["torch"] == files["jax"]
    assert [r["ts"] for r in files["torch"]] == [1000.0, 1000.0, 1001.1, 1001.1, 1003.2, 1003.2]


# ----------------------------------------------------------- bounded fetch

def test_fetch_with_timeout():
    assert te.fetch_with_timeout(lambda: 7, 1.0) == 7
    with pytest.raises(KeyError):
        te.fetch_with_timeout(lambda: {}["x"], 1.0)
    release = threading.Event()
    box = []
    for _ in range(6):
        with pytest.raises(te.PeerFailed) as e:
            te.fetch_with_timeout(lambda: (release.wait(), box.append(1), "late")[2], 0.02,
                                  step=4, what="metrics")
        assert e.value.failed == () and e.value.step == 4
        assert "metrics still blocked after 0.02s" in e.value.reason
    assert te.abandoned_fetch_count() == 6
    release.set()
    deadline = time.monotonic() + 5.0
    while te.abandoned_fetch_count() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert te.abandoned_fetch_count() == 0 and len(box) == 6


# --------------------------------------------------------------- migration

def _rows(seed, w=5):
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.standard_normal((w, 3, 4)).astype(np.float32)},
            "a": rng.standard_normal((w, 7)).astype(np.float32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _same(got, want):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), k)


@pytest.mark.parametrize("failed", [[1], [4], [0, 3], [1, 2, 4]])
@pytest.mark.parametrize("fold_into", [0, 1])
def test_migrate_ef_fold_and_drop_bitwise(failed, fold_into):
    ef = _rows(len(failed) + fold_into)
    for policy in ("fold", "drop"):
        want, wnorm = je.migrate_ef(ef, failed, policy=policy, fold_into=fold_into)
        got, gnorm = te.migrate_ef(_torch(ef), failed, policy=policy, fold_into=fold_into)
        _same(_flat(got), _flat(want))
        assert gnorm == wnorm and (gnorm > 0) == (policy == "drop")
    assert te.migrate_ef((), failed) == ((), 0.0)
    with pytest.raises(ValueError, match="cannot lose"):
        te.migrate_ef(_torch(ef), [5])
    with pytest.raises(ValueError, match="fold|drop"):
        te.migrate_ef(_torch(ef), [1], policy="keep")


def test_migrate_comp_and_expand_bitwise():
    comp = _rows(9, w=4)
    _same(_flat(te.migrate_comp(_torch(comp), [2, 0])),
          _flat(je.migrate_comp(comp, [2, 0])))
    for n in (0, 1, 2):
        _same(_flat(te.expand_ef(_torch(comp), n)),
              _flat(je.expand_ef(comp, n)))
        _same(_flat(te.expand_comp(_torch(comp), n)),
              _flat(je.expand_comp(comp, n)))
    assert te.migrate_comp((), [1]) == () and te.expand_ef((), 2) == ()


@dataclasses.dataclass
class _State:
    ef: object
    comp: object
    step: int = 3


@pytest.mark.parametrize("policy", ["fold", "drop"])
def test_shrink_and_expand_state_row_groups_bitwise(policy):
    """A dp 3 x sp 2 layout: 6 rows, 2 a data row; data row 1 dies."""
    ef, comp = _rows(5, w=6), _rows(6, w=6)
    want, wnorm = je.shrink_state(_State(ef, comp), [1], policy=policy, data_world=3)
    got, gnorm = te.shrink_state(_State(_torch(ef), _torch(comp)), [1], policy=policy,
                                 data_world=3)
    assert gnorm == wnorm and got.step == 3
    for a, b in ((got.ef, want.ef), (got.comp, want.comp)):
        _same(_flat(a), _flat(b))
    wx = je.expand_state(want, 1, data_world=2)
    gx = te.expand_state(got, 1, data_world=2)
    for a, b in ((gx.ef, wx.ef), (gx.comp, wx.comp)):
        _same(_flat(a), _flat(b))
    assert te._rows_per_data_row(_torch(ef), 3) == je._rows_per_data_row(ef, 3) == 2
    assert te._worker_rows([2, 0], 2) == je._worker_rows([2, 0], 2) == [0, 1, 4, 5]
    with pytest.raises(ValueError, match="does not divide"):
        te._rows_per_data_row(_torch(ef), 4)


def test_trim_batches():
    batches = [{"input": np.arange(10 * 2).reshape(10, 2), "target": np.arange(10)},
               {"input": np.zeros((4, 2)), "target": np.zeros(4)}]
    for mod in (je, te):
        out = list(mod.TrimBatches(batches, 9))
        assert len(mod.TrimBatches(batches, 9)) == 2
        assert [b["target"].shape[0] for b in out] == [9, 4]
        np.testing.assert_array_equal(out[0]["input"], batches[0]["input"][:9])


def test_batches_reshard_is_trim_then_shard():
    """``data.cifar10.Batches.reshard``: a rank's rows of each global batch
    trimmed to ``(bs // W) * W`` are ``TrimBatches`` of the unsharded
    iterator, then the W-way split, with the RNG stream carried on."""
    from tpu_compressed_dp_torch.data import cifar10

    x = np.random.default_rng(0).integers(0, 256, (40, 36, 36, 3), dtype=np.uint8)
    y = np.arange(40) % 10
    whole = cifar10.Batches(x, y, 16, shuffle=True, augment=True, drop_last=True, seed=3)
    parts = [cifar10.Batches(x, y, 16, shuffle=True, augment=True, drop_last=True, seed=3,
                             shard=(r, 4)) for r in range(3)]
    for epoch in range(2):
        want = list(te.TrimBatches(whole, 15))
        if epoch == 1:
            for r, p in enumerate(parts):
                p.reshard(r, 3, 15)
        got = [list(p) for p in parts]
        for b, wb in enumerate(want):
            rows = 16 // 4 if epoch == 0 else 5
            for r in range(3):
                lo = r * rows
                np.testing.assert_array_equal(got[r][b]["input"], wb["input"][lo:lo + rows])
                np.testing.assert_array_equal(got[r][b]["target"], wb["target"][lo:lo + rows])
    with pytest.raises(ValueError, match="cannot shard"):
        parts[0].reshard(0, 4, 15)
    # the eval batches: unsharded, the short final batch kept
    test = cifar10.Batches(x[:, 2:34, 2:34], y, 16, shuffle=False, drop_last=False)
    want = list(te.TrimBatches(cifar10.Batches(x[:, 2:34, 2:34], y, 16, shuffle=False), 15))
    test.trim(15)
    got = list(test)
    assert [len(b["target"]) for b in got] == [15, 15, 8]
    for b, wb in zip(got, want):
        for k in ("input", "target"):
            np.testing.assert_array_equal(b[k], wb[k])
    with pytest.raises(ValueError, match="cannot trim"):
        test.trim(17)


# ------------------------------------------------------------------ runtime

def _jax_runtime(mesh8, **kw):
    from tpu_compressed_dp.parallel.mesh import make_data_mesh

    return je.ElasticRuntime(je.ElasticConfig(**kw), make_data_mesh(4), log=lambda s: None)


def _port_runtime(tmp_path, *, ranks=(0, 1, 2, 3), rank=0, crash=None, gossip=None, **kw):
    cfg = te.ElasticConfig(gossip_dir=str(tmp_path), rank=rank, peer_timeout_s=2.0, **kw)
    rdzv = trdzv.Rendezvous(str(tmp_path), rank, base_port=45000)
    calls = []
    rt = te.ElasticRuntime(cfg, ranks=ranks, crash=crash, rendezvous=rdzv, gossip=gossip,
                           reinit=lambda d: calls.append(("reinit", d)),
                           broadcast=lambda st, src, extras=None, params=True: (calls.append(
                               ("broadcast", src)) or (st, extras)),
                           log=lambda s: None)
    return rt, rdzv, calls


def test_failure_from_matches_jax(tmp_path, mesh8):
    jrt = _jax_runtime(mesh8)
    trt, _, _ = _port_runtime(tmp_path)
    pf = te.PeerFailed((2,), step=5, reason="gossip")
    assert trt.failure_from(pf) is pf
    for mode in ("mid_collective", "during_remesh"):
        for mod, rt in ((jchaos, jrt), (tchaos, trt)):
            inj = mod.CrashInjector(3, mode=mode, worker=2)
            with pytest.raises(mod.ChaosCrash) as e:
                inj.check(4, phase=mode)
            got = rt.failure_from(e.value)
            assert (got.failed, got.step, got.reason) == ((2,), 4, (
                "chaos kill during remesh" if mode == "during_remesh"
                else "chaos mid-collective kill"))
    for mod, rt in ((jchaos, jrt), (tchaos, trt)):
        with pytest.raises(mod.ChaosCrash) as e:
            mod.CrashInjector(1).check(1)
        assert rt.failure_from(e.value) is None          # crash=N is not elastic's
        assert rt.failure_from(ValueError("x")) is None
    # a collective's error names no culprit: no gossip, so none
    err = RuntimeError("[gloo/transport/tcp/pair.cc:553] Connection closed by peer")
    got = trt.failure_from(err)
    assert isinstance(got, te.PeerFailed) and got.failed == ()
    assert "a collective failed" in got.reason and te.is_collective_error(err)
    assert not te.is_collective_error(RuntimeError("shape mismatch"))
    assert jrt.failure_from(err) is None                 # JAX's fetch timeout plays this


def test_culprit_filled_from_gossip(tmp_path):
    """A collective error before the dead file went stale: the runtime waits
    for the gossip (the peer's file stays unchanged past the timeout) and
    names only ranks of the current world."""
    d = str(tmp_path)
    for r in (1, 2, 3):
        te.write_peer_heartbeat(d, r, 0, incarnation=0)
    gossip = te.PeerGossip(d, 0, 5, peer_timeout_s=0.3, incarnation=0)
    gossip.note_dead([4], "an earlier remesh")
    trt, _, _ = _port_runtime(tmp_path, gossip=gossip, ranks=(0, 1, 2, 3))
    trt.cfg = dataclasses.replace(trt.cfg, peer_timeout_s=0.3)
    stop = threading.Event()

    def alive():
        i = 0
        while not stop.is_set():
            i += 1
            for r in (1, 3):
                te.write_peer_heartbeat(d, r, i, incarnation=0)
            time.sleep(0.02)

    t = threading.Thread(target=alive, daemon=True)
    t.start()
    try:
        t0 = time.monotonic()
        got = trt.failure_from(RuntimeError("gloo: Timed out waiting 300ms for recv"))
    finally:
        stop.set()
        t.join()
        trt.close()
    assert got.failed == (2,) and "gossip names [2]" in got.reason
    assert 0.25 < time.monotonic() - t0 < 2.0


def _votes(d, epoch, members, ranks):
    for r in ranks:
        trdzv.Rendezvous(d, r).vote(epoch, members)


def test_handle_failure_min_world_and_self_exit(tmp_path, mesh8):
    """Past worker 1: at ``min_world`` 4 every survivor refuses with JAX's
    reason and nothing is committed; at 3 the survivors commit epoch 1 over
    [0, 2, 3] through the rendezvous, re-initialise and agree the state
    from the coordinator; the dead rank itself leaves for the watchdog."""
    from tpu_compressed_dp.parallel.mesh import make_data_mesh

    state = _State(ef={}, comp=())
    trt, _, calls = _port_runtime(tmp_path / "4", min_world=4)
    jrt = je.ElasticRuntime(je.ElasticConfig(min_world=4), make_data_mesh(4),
                            log=lambda s: None)
    errs = []
    for rt, mod in ((trt, te), (jrt, je)):
        with pytest.raises(mod.PeerFailed) as e:
            rt.handle_failure(state, mod.PeerFailed((1,), step=2, reason="drill"))
        errs.append((e.value.failed, e.value.step, e.value.reason))
    assert errs[0] == errs[1] and "surviving world 3 below min_world 4" in errs[0][2]
    assert calls == [] and trt.world == 4 and trdzv.read_epoch(str(tmp_path / "4")) is None
    trt, _, calls = _port_runtime(tmp_path / "3", min_world=3)
    _votes(str(tmp_path / "3"), 1, [0, 2, 3], [2, 3])
    out = trt.handle_failure(state, te.PeerFailed((1,), step=2, reason="drill"))
    assert out is state and trt.ranks == (0, 2, 3) and trt.world == 3 and trt.epoch == 1
    assert [c[0] for c in calls] == ["reinit", "broadcast"] and calls[1][1] == 0
    assert calls[0][1].address == "127.0.0.1:45001" and calls[0][1].process_id == 0
    assert trt.remesh_count == 1 and trt.peer_failures == 1 and trt.remesh_latency_ms > 0
    assert trt.metrics()["elastic/dropped_ef_norm"] == 0.0   # a dead process's EF: unknown
    victim, _, calls = _port_runtime(tmp_path / "victim", rank=1)
    with pytest.raises(te.PeerFailed, match="among the declared dead"):
        victim.handle_failure(state, te.PeerFailed((1,), step=2, reason="drill"))
    with pytest.raises(te.PeerFailed):
        victim.handle_failure(state, te.PeerFailed((), step=2, reason="unnamed"))
    assert calls == []


def test_cascade_union_matches_jax(tmp_path, mesh8):
    """``crash=during_remesh`` while remeshing past worker 1: worker 3 dies
    too and the union commits at ``min_world`` 2; at ``min_world`` 3 the
    union is refused on every survivor, nothing committed — as JAX's
    cascade counts and refuses."""
    chaos = tchaos.ChaosConfig.parse("crash=during_remesh,crash_at_step=2,worker=3")
    state = _State(ef={}, comp=())
    trt, _, calls = _port_runtime(tmp_path / "a", min_world=2,
                                  crash=tchaos.maybe_crash_injector(chaos))
    _votes(str(tmp_path / "a"), 1, [0, 2], [2])
    trt.handle_failure(state, te.PeerFailed((1,), step=2, reason="drill"))
    assert trt.ranks == (0, 2) and trt.cascade_count == 1 and trt.peer_failures == 2
    assert trt.remesh_count == 1
    refused, _, calls = _port_runtime(tmp_path / "b", min_world=3,
                                      crash=tchaos.maybe_crash_injector(chaos))
    with pytest.raises(te.PeerFailed) as e:
        refused.handle_failure(state, te.PeerFailed((1,), step=2, reason="drill"))
    assert e.value.failed == (1, 3) and "below min_world 3" in e.value.reason
    assert calls == [] and refused.world == 4 and refused.remesh_count == 0
    # rank 3, the second victim, leaves itself
    victim, _, _ = _port_runtime(tmp_path / "c", rank=3, min_world=2,
                                 crash=tchaos.maybe_crash_injector(chaos))
    with pytest.raises(te.PeerFailed, match="among the declared dead"):
        victim.handle_failure(state, te.PeerFailed((1,), step=2, reason="drill"))


def test_metrics_keys_match_jax(tmp_path, mesh8):
    trt, _, _ = _port_runtime(tmp_path)
    assert set(trt.metrics()) == set(_jax_runtime(mesh8).metrics())
    assert all(v == 0.0 for v in trt.metrics().values())
    # the telemetry hooks are ported (item 13), and the delta stream: the warm
    # layout keys on stream_armed, a value every rank shares, and on the
    # survivors' agreed answer to whether one of them holds the writer (rank
    # 0 alone holds it); a runtime made directly follows its writer
    for hook in ("events", "flight"):
        rt = te.ElasticRuntime(te.ElasticConfig(), ranks=(0,), **{hook: object()})
        assert getattr(rt, hook) is not None
        rt.close()
    writer = object()
    for kw, armed in (({"stream": writer}, True), ({"stream_armed": True}, True), ({}, False),
                      ({"stream": writer, "stream_armed": False}, False)):
        rt = te.ElasticRuntime(te.ElasticConfig(), ranks=(0,), **kw)
        assert rt.stream is kw.get("stream") and rt.stream_armed is armed, kw
        rt.close()


def test_readmission_agrees_joins_and_zeroes_joiner_ef(tmp_path):
    """Survivor side: the pending joins become a commit voted by the
    survivors only; joiner side: the broadcast state, a zero EF and the
    survivors' ``shared`` position."""
    d = str(tmp_path)
    model = torch.nn.Linear(2, 2)
    state = _State(ef={"w": torch.ones(3)}, comp=())
    state.model = model
    trt, rdzv, calls = _port_runtime(tmp_path, ranks=(0, 2))
    assert trt.rejoin_barrier(state) == (state, False)
    trdzv.Rendezvous(d, 1).request_join(incarnation=1)
    _votes(d, 1, [0, 1, 2], [2])
    trt.shared["next_epoch"] = 4
    out, grew = trt.rejoin_barrier(state)
    assert grew and trt.ranks == (0, 1, 2) and trt.readmit_count == 1
    rec = trdzv.read_epoch(d)
    assert rec["ranks"] == [0, 1, 2] and rec["coordinator"] == 0 and rec["warm"] is False
    joiner, _, jcalls = _port_runtime(tmp_path / "j", ranks=(1,), rank=1)
    jstate = _State(ef={"w": torch.ones(3)}, comp=())
    jstate.model = model
    joiner._broadcast = lambda st, src, extras=None, params=True: (
        st, {"ckpt": None, "shared": {"next_epoch": 4}})
    dec = trdzv.Rendezvous(d, 1).decision_from(rec)
    out = joiner.join_world(jstate, dec)
    assert not out.ef["w"].any() and joiner.ranks == (0, 1, 2) and joiner.rank == 1
    assert joiner.shared == {"next_epoch": 4} and jcalls == []   # a joiner is already in
    with pytest.raises(trdzv.RendezvousError, match="warm"):
        joiner.join_world(jstate, dataclasses.replace(dec, warm=True))


@pytest.mark.parametrize("writer", [True, False])
def test_warm_readmission_needs_the_writer_among_survivors(tmp_path, writer):
    """A joiner whose record carries ``stream`` is admitted warm only when a
    survivor holds the stream writer, which flushes the stream at the
    readmission's step first; with the writer's process dead the commit is
    cold and the joiner takes the parameters from the broadcast."""
    d = str(tmp_path)
    state = _State(ef={}, comp=())
    state.model = torch.nn.Linear(2, 2)
    synced = []
    trt, _, _ = _port_runtime(tmp_path, ranks=(0, 2))
    trt.stream_armed = True
    if writer:
        trt.stream = argparse.Namespace(sync=lambda model, step: synced.append(step),
                                        request_keyframe=lambda: None)
    trdzv.Rendezvous(d, 1).request_join(incarnation=1, stream_seq=4)
    _votes(d, 1, [0, 1, 2], [2])
    _, grew = trt.rejoin_barrier(state)
    assert grew and trdzv.read_epoch(d)["warm"] is writer
    assert synced == ([state.step] if writer else [])


@pytest.mark.parametrize("exact,step,ok", [(True, 3, True), (False, 3, False),
                                           (True, 2, False)])
def test_warm_join_refuses_an_adoption_off_the_broadcast(tmp_path, exact, step, ok):
    """A joiner of a warm commit keeps its adoption only when the reader
    reconstructed it exactly at the broadcast's step (the survivors'
    parameters); otherwise it raises for the watchdog to relaunch."""
    dec = trdzv.Rendezvous(str(tmp_path), 1).decision_from(
        {"epoch": 1, "ranks": [0, 1], "address": "127.0.0.1:45001", "warm": True})
    joiner, _, _ = _port_runtime(tmp_path / "j", ranks=(1,), rank=1)
    joiner._broadcast = lambda st, src, extras=None, params=True: (
        st, {"ckpt": None, "shared": {}})
    jstate = _State(ef={}, comp=())
    jstate.model = torch.nn.Linear(2, 2)
    from tpu_compressed_dp_torch.stream.delta import param_dict

    info = {"exact": exact, "step": step, "bytes": 48}
    if ok:
        joiner.join_world(jstate, dec, adopted_params=param_dict(jstate.model),
                          adopted_info=info)
        assert joiner.ranks == (0, 1) and joiner.metrics()["stream/rejoin_bytes"] == 48
    else:
        with pytest.raises(trdzv.RendezvousError, match="not the survivors' parameters"):
            joiner.join_world(jstate, dec, adopted_params=param_dict(jstate.model),
                              adopted_info=info)


def test_watchdog_relaunch_loop_matches_jax(tmp_path):
    """The port's ``supervise`` and the JAX one, preempt path and storm
    guard included, on one scripted child and check sequence: the same
    spawns, kills, sleeps and verdict.  Then the ``--check`` verdicts on
    the same heartbeat files (staleness here; the telemetry thresholds in
    ``tests/test_torch_obs_harness.py::test_watchdog_check_exit_codes_match_jax``)
    and the CLI's refusals."""
    import importlib.util
    import os

    from tpu_compressed_dp_torch.harness import watchdog as tw

    spec = importlib.util.spec_from_file_location("jax_watchdog", os.path.join(
        os.path.dirname(__file__), "..", "tools", "watchdog.py"))
    jw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jw)

    class Child:
        """Its exit code after ``i`` of the supervisor's sleeps is
        ``rcs[i]`` (the last one past the end); once exited it stays so."""

        def __init__(self, rcs, clock):
            self.rcs, self.clock, self.born = list(rcs), clock, clock[0]
            self.returncode = None

        def poll(self):
            if self.returncode is None:
                self.returncode = self.rcs[min(self.clock[0] - self.born, len(self.rcs) - 1)]
            return self.returncode

    def drive(mod, checks, children, **extra):
        log, kids, chk, clock = [], list(children), list(checks), [0]

        def sleep(s):
            log.append(("sleep", s))
            clock[0] += 1

        rc = mod.supervise(lambda: log.append("spawn") or Child(kids.pop(0), clock),
                           lambda: chk.pop(0) if chk else 0,
                           interval_s=1.0, grace_s=2.0, max_relaunches=2, backoff_s=1.0,
                           sleep=sleep,
                           kill=lambda c: log.append("kill"), log=lambda s: None,
                           max_checks=8, **extra)
        return rc, log

    storm = [[None, 75]] * 4 + [[None] * 9] * 4
    for checks, children, extra in (
            ([0, 1, 1, 1], [[None] * 9] * 4, {}),
            ([1, 0, 0], [[None, None, None, -9], [None] * 4 + [0]], {}),
            ([], [[None, 75], [None] * 3 + [0]], {"preempt_exit_code": None}),
            ([], [[None, 75], [None] * 3 + [0]], {}),
            ([0, 0], storm, {"max_preempts": 2, "preempt_window_s": 600.0})):
        assert drive(tw, checks, children, **extra) == drive(jw, checks, children, **extra)
    hb = tmp_path / "hb.json"
    args = argparse.Namespace(heartbeat=str(hb), max_age=60.0)
    assert tw.run_check(args) == 2
    hb.write_text(json.dumps({"ts": time.time(), "step": 3}))
    assert tw.run_check(args) == 0
    hb.write_text(json.dumps({"ts": time.time() - 61.0, "step": 3}))
    assert tw.run_check(args) == 1
    for flag in (["--check"], ["--check", "--relaunch"]):
        with pytest.raises(SystemExit):
            tw.main([*flag, "--heartbeat", str(hb), "--", "true"])
    # --max_stream_lag (raised as unknown until the stream was ported) reads
    # stream_lag_s plus the heartbeat's age
    hb.write_text(json.dumps({"ts": time.time(), "step": 3, "stream_lag_s": 2.0}))
    assert tw.main(["--check", "--max_stream_lag", "5", "--heartbeat", str(hb)]) == 0
    assert tw.main(["--check", "--max_stream_lag", "1", "--heartbeat", str(hb)]) == 1


def test_chaos_drill_elastic_rows():
    from tpu_compressed_dp_torch.harness import chaos_drill

    got = chaos_drill.run_elastic_drills(["elastic_gossip", "elastic_remesh", "elastic_readmit",
                                          "elastic_cascade"], "cpu")
    assert got["elastic_remesh"]["world"] == 3 and got["elastic_readmit"]["world"] == 4
    assert got["elastic_cascade"] == {"world": 2, "cascades": 1}
    coord = chaos_drill.drill_elastic_remesh("cpu", worker=0, kill_step=0, policy="drop")
    assert coord["world"] == 3 and coord["dropped_ef_norm"] > 0
