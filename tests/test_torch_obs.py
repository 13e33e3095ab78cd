"""The port's observability layer (``tpu_compressed_dp_torch/obs``) against
the JAX package's (``tpu_compressed_dp/obs``, ``tools/trace_report.py``,
``tools/postmortem.py``) on the CPU.

  * the metric registry: spec for spec, ``canonical``, ``prometheus_name``,
    ``engine_diag_reductions``; the engines' diagnostic table and the
    accumulator's sum keys derived from it; every key the port's engines
    emit is declared, over method x mode x transport x granularity at W = 1
    and a W = 2 gloo subset;
  * export: JAX's ``read_events`` / ``read_all_events`` and
    ``tools/trace_report.py`` read the port's rotated event files;
    ``write_prometheus`` is byte-equal; ``StepTimeline`` on an injected
    clock gives JAX's ``snapshot``, ``percentiles`` and ``drain``;
  * flight: the port's bundles pass JAX's ``validate_bundle``, JAX's
    ``tools/postmortem.py`` gives the port postmortem's verdict on them,
    ``straggler_gauges`` and ``profile_from_spans`` are equal;
  * trace: ``phase`` is a shared no-op context with no profiler running, a
    ``tcdp.<name>`` range under one; the annotated engines give bitwise the
    same outputs with the profiler on and off.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_compressed_dp.obs import export as jexport
from tpu_compressed_dp.obs import flight as jflight
from tpu_compressed_dp.obs import registry as jreg
from tpu_compressed_dp.obs import trace as jtrace

import torch

from tpu_compressed_dp_torch.obs import export as texport
from tpu_compressed_dp_torch.obs import flight as tflight
from tpu_compressed_dp_torch.obs import registry as treg
from tpu_compressed_dp_torch.obs import trace as ttrace
from tpu_compressed_dp_torch.parallel import dp as tdp
from tpu_compressed_dp_torch.utils import loggers as tloggers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = (None, "topk", "randomk", "blocktopk", "thresholdv", "adaptivethreshold",
           "terngrad", "qsgd", "powersgd")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the tier-1 run's parallel workers a thread
    per core in every worker oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ registry

def test_registry_equals_jax_spec_for_spec():
    assert list(treg.REGISTRY) == list(jreg.REGISTRY)
    for name, ms in jreg.REGISTRY.items():
        assert dataclasses_tuple(treg.REGISTRY[name]) == dataclasses_tuple(ms), name
    keys = list(jreg.REGISTRY) + ["sent_bits", "sync_agree", "shard_overflow", "made/up",
                                  "nope", "guard/nonfinite"]
    for k in keys:
        assert treg.canonical(k) == jreg.canonical(k), k
        assert treg.prometheus_name(k) == jreg.prometheus_name(k), k
        assert treg.is_declared(k) == jreg.is_declared(k), k
    assert treg.undeclared(keys) == jreg.undeclared(keys)
    assert treg.engine_diag_reductions() == jreg.engine_diag_reductions()
    with pytest.raises(ValueError, match="already declared"):
        treg.declare("loss", treg.COUNTER, "nats", "mean", "step")


def dataclasses_tuple(ms):
    return (ms.name, ms.kind, ms.unit, ms.reduction, ms.emitter, ms.help)


def test_engine_table_and_sum_keys_derive_from_the_registry():
    from tpu_compressed_dp.parallel import dp as jdp
    from tpu_compressed_dp.utils import loggers as jloggers

    red = {"min": torch.distributed.ReduceOp.MIN, "max": torch.distributed.ReduceOp.MAX}
    assert {k: op for k, (op, _) in tdp._DIAG_COMBINE.items()} == {
        k: red[r] for k, r in treg.engine_diag_reductions().items()}
    assert set(tdp._DIAG_COMBINE) == set(jdp._DIAG_STATS) == {"sync_agree", "guard/nonfinite"}
    assert tloggers.MetricAccumulator.SUM_KEYS == jloggers.MetricAccumulator.SUM_KEYS == {
        "correct", "correct5", "count", "loss_sum", "tokens"}


def _configs(world: int):
    """The method x mode x transport x granularity matrix of the JAX
    conformance sweep (EF with everything but the unbiased quantizers and
    dense; PowerSGD has one engine for both modes)."""
    for m, mode, transport, gran in itertools.product(
            METHODS, ("simulate", "wire"), ("allgather", "sharded", "hierarchical"),
            ("layerwise", "entiremodel", "bucketed")):
        if m is None and mode == "wire":
            continue
        yield tdp.CompressionConfig(
            method=m, granularity=gran, mode=mode, transport=transport, ratio=0.25,
            error_feedback=m not in (None, "terngrad", "qsgd"), check_sync=True,
            dp_pods=2 if transport == "hierarchical" and world % 2 == 0 else 1, rank=2,
            bucket_mb=0.0005)


def _sync_keys(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    grads = {"w": torch.randn(64, 8, generator=g), "b": torch.randn(8, generator=g)}
    ef = {k: torch.zeros_like(v) for k, v in grads.items()} if cfg.error_feedback else ()
    comp = tdp.init_comp_state(grads, cfg)
    out = tdp.make_stateful_grad_sync(cfg)(grads, ef, comp, 3, ok=True)
    return set(out[3])


def test_every_engine_key_is_declared_w1():
    seen, bad = set(), []
    for cfg in _configs(1):
        keys = _sync_keys(cfg)
        seen |= keys
        if treg.undeclared(keys):
            bad.append((cfg.method, cfg.mode, cfg.transport, cfg.granularity,
                        treg.undeclared(keys)))
    assert not bad, bad
    for key in ("sent_bits_psum", "sent_bits_allgather", "threshold_overflow", "sync_agree",
                "guard/nonfinite", "num_collectives", "dense_elems"):
        assert key in seen, key


_WORKER = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[4])
from tpu_compressed_dp_torch.parallel import mesh
import tests.test_torch_obs as t
out, port, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
torch.set_num_threads(1)
mesh.init_process_group(torch.device("cpu"), backend="gloo",
                        init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
keys = {}
for cfg in t._configs(2):
    if cfg.granularity != "entiremodel" or cfg.method not in (
            "topk", "randomk", "blocktopk", "thresholdv", "qsgd", None):
        continue
    keys[f"{cfg.method}/{cfg.mode}/{cfg.transport}"] = sorted(t._sync_keys(cfg, rank))
mesh.destroy()
json.dump(keys, open(f"{out}/rank{rank}.json", "w"))
"""


def test_every_engine_key_is_declared_w2_gloo(tmp_path):
    """The sharded and hierarchical transports' own keys appear only with
    more than one worker: a W = 2 gloo subset (entire-model groups)."""
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(tmp_path), port, str(r),
                               REPO], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    assert got[0] == got[1]   # every rank lists the same keys
    seen = set()
    for label, keys in got[0].items():
        assert treg.undeclared(keys) == [], (label, treg.undeclared(keys))
        seen |= set(keys)
    for key in ("sent_bits_alltoall", "shard_overflow", "sent_bits_ici", "sent_bits_dcn",
                "sent_bits_dcn_route", "sync_agree", "guard/nonfinite"):
        assert key in seen, key


# -------------------------------------------------------------------- export

def _write_stream(mod, path, n=12):
    ev = mod.EventStream(str(path), meta={"harness": "dawn", "devices": 1}, max_bytes=400)
    for i in range(n):
        ev.emit("epoch", epoch=i, step=4 * i,
                metrics={"train loss": 2.0 - 0.1 * i, "img/s": 100.0 + i},
                comm={"comm/sent_bits": 6.4e4}, guard={}, control={},
                timeline={"time/step_p95_ms": 1.0},
                step_spans=[{"t0": float(j), "data": 0.01, "dispatch": 0.02, "total": 0.03}
                            for j in range(2)])
    ev.emit("control_decision", knob="ratio", index=0, applied=4)
    ev.close()
    return ev


def test_jax_readers_read_the_ports_rotated_events(tmp_path):
    _write_stream(texport, tmp_path / "ev.jsonl")
    segs = texport.list_segments(str(tmp_path / "ev.jsonl"))
    assert len(segs) > 2 and segs == jexport.list_segments(str(tmp_path / "ev.jsonl"))
    got = jexport.read_all_events(str(tmp_path / "ev.jsonl"))
    assert got == texport.read_all_events(str(tmp_path / "ev.jsonl"))
    assert [r["kind"] for r in got] == (["run_start"] + ["epoch"] * 12
                                        + ["control_decision", "run_end"])
    assert all(r["v"] == jexport.SCHEMA_VERSION for r in got)
    assert [r["seg"] for r in got] == sorted(r["seg"] for r in got)
    # the same records (timestamps aside) as JAX's writer makes
    _write_stream(jexport, tmp_path / "jx.jsonl")
    want = jexport.read_all_events(str(tmp_path / "jx.jsonl"))
    strip = [{k: v for k, v in r.items() if k != "ts"} for r in got]
    assert strip == [{k: v for k, v in r.items() if k != "ts"} for r in want]
    # a job-scoped path
    assert texport.job_scoped_path("d/ev.jsonl", "j") == jexport.job_scoped_path(
        "d/ev.jsonl", "j") == os.path.join("d", "j.ev.jsonl")


def test_trace_report_reads_the_ports_events(tmp_path):
    _write_stream(texport, tmp_path / "ev.jsonl")
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "trace_report.py"),
                          str(tmp_path / "ev.jsonl"), "--chrome", str(tmp_path / "t.json")],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "per-phase step-time breakdown" in out.stdout
    assert json.load(open(tmp_path / "t.json"))["traceEvents"]


def test_prometheus_byte_equal(tmp_path):
    metrics = {"comm/sent_bits": 6.4e4, "sent_elems": 1000, "loss": 2.25, "lr": 0.1,
               "time/step_p95_ms": 12.5, "made/up": 3, "flag": True, "text": "x",
               "control/rung": 2.0, "straggler/rank": -1.0, "net/dcn_mb_per_step": 0.5}
    for labels in (None, {"harness": "dawn", "job": "j1"}):
        a = texport.write_prometheus(metrics, str(tmp_path / "t.prom"), labels=labels)
        b = jexport.write_prometheus(metrics, str(tmp_path / "j.prom"), labels=labels)
        assert a == b
        assert open(tmp_path / "t.prom", "rb").read() == open(tmp_path / "j.prom", "rb").read()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_step_timeline_matches_jax():
    rng = np.random.default_rng(5)
    waits = rng.uniform(0.0, 0.05, 40)
    disp = rng.uniform(0.01, 0.2, 40)
    tls, clocks = [], []
    for mod in (ttrace, jtrace):
        c = _Clock()
        tls.append(mod.StepTimeline(capacity=16, device_sync_every=3, clock=c,
                                    sync=lambda c=c: setattr(c, "t", c.t + 0.007)))
        clocks.append(c)
    drains = [[], []]
    for i in range(40):
        for tl, c, d in zip(tls, clocks, drains):
            c.t += waits[i]
            tl.batch_ready()
            c.t += disp[i]
            tl.step_dispatched()
            if i % 13 == 12:
                tl.resume()
                d.append(tl.drain())
    assert tls[0].snapshot() == tls[1].snapshot()
    assert tls[0].percentiles() == tls[1].percentiles()
    assert drains[0] == drains[1] and tls[0].drain() == tls[1].drain()
    assert texport.telemetry_snapshot(tls[0], step=40, last_good_step=39) == \
        jexport.telemetry_snapshot(tls[1], step=40, last_good_step=39)
    for q in (0.0, 0.5, 0.95, 1.0):
        vals = sorted(waits.tolist())
        assert ttrace.percentile(vals, q) == jtrace.percentile(vals, q)
    assert ttrace.PHASES == jtrace.PHASES


# -------------------------------------------------------------------- flight

def _bundles(mod, directory, case):
    """Four recorders of ``mod`` in ``directory``, each dumping the
    ``case``'s failure; the spans skew rank 3."""
    from tpu_compressed_dp_torch.train.elastic import PeerFailed
    from tpu_compressed_dp_torch.train.guard import GuardExceeded
    from tpu_compressed_dp_torch.utils.chaos import ChaosConfig, ChaosCrash
    from tpu_compressed_dp_torch.utils.checkpoint import CheckpointCorrupt
    from tpu_compressed_dp_torch.utils.resilience import Preempted

    clock = _Clock()
    fls = [mod.FlightRecorder(rank=r, capacity=8, directory=str(directory), clock=clock,
                              meta={"case": case}) for r in range(4)]
    for r, fl in enumerate(fls):
        fl.note_chaos(ChaosConfig(kind="nan", every=1, worker=1) if case == "nan" else
                      ChaosConfig(crash_at_step=2, crash_mode="mid_collective", worker=2))
        fl.note_spans([{"t0": 0.0, "data": 0.01, "dispatch": 0.02,
                        "total": 0.1 * (3 if r == 3 else 1)}] * 3)
        fl.note_step(5, {"loss": 1.5, "guard/skip_streak": 3.0, "guard/skipped": 3.0})
        fl.note_control({"epoch": 1, "rung": 2, "applied": 8})
        clock.t += 1.0
    for r, fl in enumerate(fls):
        if case == "nan":
            fl.observe(GuardExceeded("wedged"), step=4)
        elif case == "dead_peer":
            if r == 2:
                err = ChaosCrash("chaos kill")
                err.step, err.mode, err.worker = 2, "mid_collective", 2
                fl.observe(err)
            else:
                fl.observe(PeerFailed((2,), step=2, reason="stale"))
        elif case == "preempt" and r == 0:
            fl.observe(Preempted("SIGTERM", step=6, signum=15))
        elif case == "preempt":
            fl.observe(PeerFailed((0,), step=6, reason="peer exited"))
        elif case == "corruption" and r == 1:
            fl.observe(CheckpointCorrupt("step 4 failed verification"), step=4)
    return fls


@pytest.mark.parametrize("case", ["nan", "dead_peer", "preempt", "corruption", "straggler"])
def test_bundles_and_verdicts_match_jax(case, tmp_path):
    from tpu_compressed_dp_torch.harness import postmortem as tpm

    jpm = _tool("postmortem")
    fls = _bundles(tflight, tmp_path / "t", case)
    jfls = _bundles(jflight, tmp_path / "j", case)
    if case == "straggler":
        # no failure: dump the rings by hand to read the skew offline
        for fl in fls + jfls:
            fl.dump("manual", step=7)
    tb = tflight.read_bundles(str(tmp_path / "t"))
    jb = jflight.read_bundles(str(tmp_path / "j"))
    assert sorted(tb) == sorted(jb) and tb
    for r in tb:
        assert jflight.validate_bundle(tb[r]) == [] == tflight.validate_bundle(tb[r])
        assert tb[r] == jb[r], r       # the same records, field for field
    v = tpm.classify(tb)
    assert v == jpm.classify(tb) == jpm.classify(jb)
    want = {"nan": ("nan", 1), "dead_peer": ("dead_peer", 2), "preempt": ("preempt", 0),
            "corruption": ("corruption", 1), "straggler": ("straggler", 3)}[case]
    assert (v["kind"], v["rank"]) == want, v
    assert tpm.merge_timeline(tb) == jpm.merge_timeline(tb)
    assert tpm.render_report(tb) == jpm.render_report(tb)
    assert tpm.straggler_from_bundles(tb) == jpm.straggler_from_bundles(tb)
    # the live gauges from the published phase profiles, and the counters
    assert fls[0].publish() == jfls[0].publish()
    assert [f.metrics() for f in fls] == [f.metrics() for f in jfls]


def test_classify_failure_over_the_ports_exceptions():
    from tpu_compressed_dp_torch.train.elastic import PeerFailed
    from tpu_compressed_dp_torch.train.guard import GuardExceeded
    from tpu_compressed_dp_torch.utils.chaos import ChaosCrash
    from tpu_compressed_dp_torch.utils.checkpoint import CheckpointCorrupt
    from tpu_compressed_dp_torch.utils.resilience import Preempted

    errs = [GuardExceeded("g"), ChaosCrash("c"), PeerFailed((1, 2), step=3, reason="r"),
            Preempted("p", step=4, signum=15), CheckpointCorrupt("k"), ValueError("v")]
    assert [tflight.classify_failure(e) for e in errs] == [
        "guard_exceeded", "chaos_crash", "peer_failed", "preempt", "ckpt_corrupt", "error"]
    for e in errs:
        assert tflight.classify_failure(e) == jflight.classify_failure(e)
        assert tflight.describe_error(e) == jflight.describe_error(e)
    assert tflight.describe_error(errs[2])["failed"] == [1, 2]


def test_straggler_gauges_and_profiles_match_jax():
    rng = np.random.default_rng(2)
    spans = {r: [{"kind": "span", "t": 0.0, "seq": i, "data": float(rng.uniform()),
                  "dispatch": float(rng.uniform()), "total": float(rng.uniform(0.5, 2.0))}
                 for i in range(5)] for r in range(3)}
    tp = {r: tflight.profile_from_spans(r, s) for r, s in spans.items()}
    assert tp == {r: jflight.profile_from_spans(r, s) for r, s in spans.items()}
    for sub in ({}, {0: tp[0]}, tp, {0: tp[0], 2: tp[2]}):
        assert tflight.straggler_gauges(sub) == jflight.straggler_gauges(sub)


# --------------------------------------------------------------------- trace

def test_phase_is_free_without_a_profiler_and_a_range_under_one():
    a, b = ttrace.phase("compress"), ttrace.chunk(3)
    assert a is b is ttrace.host_span("data")      # one shared no-op context
    with torch.profiler.profile() as prof:
        with ttrace.phase("compress"), ttrace.chunk(3):
            torch.ones(4).add_(1)
    names = {e.key for e in prof.key_averages()}
    assert {"tcdp.compress", "tcdp.chunk03"} <= names
    assert ttrace.phase("x") is a                    # off again after the profile


@pytest.mark.parametrize("method,mode,gran", [
    ("topk", "simulate", "layerwise"), ("topk", "wire", "entiremodel"),
    ("powersgd", "simulate", "layerwise"), ("thresholdv", "wire", "layerwise")])
def test_annotated_engines_bitwise_with_and_without_the_profiler(method, mode, gran):
    cfg = tdp.CompressionConfig(method=method, mode=mode, granularity=gran, ratio=0.1,
                                rank=2, error_feedback=True, threshold=0.5)
    g = torch.Generator().manual_seed(1)
    grads = {"w": torch.randn(96, 16, generator=g), "b": torch.randn(16, generator=g)}
    ef = {k: torch.randn(v.shape, generator=g) * 0.1 for k, v in grads.items()}
    sync = tdp.make_stateful_grad_sync(cfg)

    def run():
        comp = tdp.init_comp_state(grads, cfg)
        return sync({k: v.clone() for k, v in grads.items()},
                    {k: v.clone() for k, v in ef.items()}, comp, 5, ok=True)

    plain = run()
    with torch.profiler.profile() as prof:
        traced = run()
    for a, b in zip(plain[:3], traced[:3]):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(plain[3][k], traced[3][k]) for k in plain[3])
    names = {e.key for e in prof.key_averages()}
    assert {"tcdp.ef", "tcdp.compress", "tcdp.return"} <= names, names
