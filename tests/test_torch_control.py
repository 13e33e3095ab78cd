"""The port's compression controller (``tpu_compressed_dp_torch/control``)
against the JAX package's (``tpu_compressed_dp/control``) on the CPU.

  * ``ControlConfig`` checks, ``build_ladder``, ``rung_value`` and
    ``comp_for_rung`` are equal;
  * on seeded sequences of signals over 20+ windows (modeled and measured,
    pinned and derived budgets, ticks with no applied update), every
    ``Controller.tick`` gives JAX's ``ControlState`` and ``Decision``s
    bitwise (the float32 rounding of the window accumulators included), and
    the same ``control_decision`` records and gauges;
  * ``migrate_comp_state`` is bitwise JAX's for the same Q and the same
    fresh state;
  * the checkpoint saves and restores the controller's state bitwise, a step
    saved without control restores with a fresh state (JAX's legacy rule),
    and JAX's ``verify_step_dir`` accepts the port's step;
  * the elastic coordinator's broadcast carries the controller's state.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_compressed_dp.control import config as jconfig
from tpu_compressed_dp.control import controller as jcontroller
from tpu_compressed_dp.control import rungs as jrungs
from tpu_compressed_dp.control import signals as jsignals
from tpu_compressed_dp.control import state as jstate
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.utils import checkpoint as jckpt

import torch

from tpu_compressed_dp_torch.control import config as tconfig
from tpu_compressed_dp_torch.control import controller as tcontroller
from tpu_compressed_dp_torch.control import rungs as trungs
from tpu_compressed_dp_torch.control import signals as tsignals
from tpu_compressed_dp_torch.control import state as tstate
from tpu_compressed_dp_torch.parallel import dp as tdp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = [f.name for f in dataclasses.fields(tstate.ControlState)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the tier-1 run's parallel workers a thread
    per core in every worker oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    return tconfig.ControlConfig(**kw), jconfig.ControlConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(method="topk", rungs=(0.5,)), dict(method="topk", rungs=(0.1, 0.2)),
    dict(method="topk", rungs=(1.5, 0.5)), dict(method="powersgd", rungs=(4.0, 2.5)),
    dict(method="qsgd", rungs=(0.5, 0.25)), dict(method="topk", rungs=(0.5, 0.25), window=0),
    dict(method="topk", rungs=(0.5, 0.25), deadband=1.0),
    dict(method="topk", rungs=(0.5, 0.25), signal="x"),
    dict(method="topk", rungs=(0.5, 0.25), bandwidth_mbps=0.0),
    dict(method="topk", rungs=(0.5, 0.25), start_rung=2)])
def test_config_refusals_match_jax(kw):
    with pytest.raises(ValueError) as te:
        tconfig.ControlConfig(**kw)
    with pytest.raises(ValueError) as je:
        jconfig.ControlConfig(**kw)
    assert str(te.value) == str(je.value)


def test_ladders_and_rungs_match_jax():
    for method in ("topk", "randomk", "blocktopk", "powersgd"):
        for ratio, rank in ((0.01, 4), (0.5, 16), (1.0, 1), (0.0011, 3)):
            for depth in (1, 3, 5):
                assert trungs.build_ladder(method, ratio, rank, depth=depth) == \
                    jrungs.build_ladder(method, ratio, rank, depth=depth)
        assert trungs.ladder_knob(method) == jrungs.ladder_knob(method)
    tc, jc = _pair(method="topk", rungs=trungs.build_ladder("topk", 0.01, 4))
    tbase = tdp.CompressionConfig(method="topk", ratio=0.01, error_feedback=True)
    jbase = jdp.CompressionConfig(method="topk", ratio=0.01, error_feedback=True)
    for r in range(len(tc.rungs)):
        assert trungs.rung_value(tc, r) == jrungs.rung_value(jc, r)
        t, j = trungs.comp_for_rung(tbase, tc, r), jrungs.comp_for_rung(jbase, jc, r)
        assert (t.ratio, t.rank, t.method) == (j.ratio, j.rank, j.method)
    with pytest.raises(ValueError, match="out of range"):
        trungs.rung_value(tc, 9)
    tc, jc = _pair(method="powersgd", rungs=(8.0, 4.0, 2.0))
    tbase = tdp.CompressionConfig(method="powersgd", rank=8)
    for r in range(3):
        assert trungs.comp_for_rung(tbase, tc, r).rank == jrungs.comp_for_rung(
            jdp.CompressionConfig(method="powersgd", rank=8), jc, r).rank
    trungs.assert_ladder_traceable(tc)


def _same_state(t, j):
    for f in FIELDS:
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (f, a, b)


class _Rec:
    def __init__(self):
        self.ev = []

    def emit(self, kind, **fields):
        self.ev.append((kind, fields))


@pytest.mark.parametrize("case", ["modeled_pinned", "measured_derived", "modeled_derived"])
def test_tick_sequence_bitwise_jax(case):
    """The port's ``tick`` and JAX's on one seeded signal sequence: every
    state field bit for bit (float32 window sums of non-representable
    doubles), every Decision equal, the same event records and gauges."""
    rng = np.random.default_rng(["modeled_pinned", "measured_derived",
                                 "modeled_derived"].index(case))
    kw = dict(method="topk", rungs=(0.1, 0.05, 0.025, 0.0125), window=5, deadband=0.2,
              bandwidth_mbps=7.3)
    if case == "modeled_pinned":
        kw.update(budget_ms=0.137)
    elif case == "measured_derived":
        kw.update(signal="measured")
    tc, jc = _pair(**kw)
    trec, jrec = _Rec(), _Rec()
    tctl, jctl = tcontroller.Controller(tc, events=trec), jcontroller.Controller(jc, events=jrec)
    ts, js = tstate.init_control_state(tc), jstate.init_control_state(jc)
    _same_state(ts, js)
    applied, n_dec = 0, 0
    for i in range(160):
        applied += int(rng.choice([0, 1, 2, 3, 7]))
        bits = float(rng.uniform(1e3, 3e5)) * (1.0 + 0.1 * np.sin(i))
        wall = float(rng.uniform(0.05, 3.0))
        frac = float(rng.uniform(0.2, 1.0))
        sig = dict(mean_bits=bits, measured_comm_ms=wall, compute_ms=wall * 0.7,
                   hideable_fraction=frac)
        tsig, jsig = tctl.window_signals(**sig), jctl.window_signals(**sig)
        assert dataclasses.astuple(tsig) == dataclasses.astuple(jsig)
        ts, tdec = tctl.tick(ts, applied=applied, signals=tsig)
        js, jdec = jctl.tick(js, applied=applied, signals=jsig)
        _same_state(ts, js)
        assert [dataclasses.asdict(d) for d in tdec] == [dataclasses.asdict(d) for d in jdec]
        n_dec += len(tdec)
        assert tctl.metrics(ts) == jctl.metrics(js)
        assert tctl.heartbeat_fields(ts) == jctl.heartbeat_fields(js)
    assert n_dec >= 20, n_dec
    assert trec.ev == jrec.ev
    dirs = {f["direction"] for _, f in trec.ev}
    assert len(dirs) >= 2, dirs     # the sequence moves the rung, not only holds


def test_signals_match_jax():
    for bits, bw in ((1e6, 100.0), (12345.6, 7.3), (0.0, 1.0)):
        assert tsignals.modeled_comm_ms(bits, bw) == jsignals.modeled_comm_ms(bits, bw)
    m = {"comm/sent_bits": 9e5, "comm/sent_bits_ici": 4e5}
    for pods in (1, 2, 4):
        assert tsignals.billed_signal_bits(m, pods) == jsignals.billed_signal_bits(m, pods)
    tc, jc = _pair(method="topk", rungs=(0.5, 0.25))
    assert tsignals.hideable_budget_ms(tc, compute_ms=3.3, hideable_fraction=0.4) == \
        jsignals.hideable_budget_ms(jc, compute_ms=3.3, hideable_fraction=0.4)
    with pytest.raises(ValueError, match="budget_ms=0"):
        tsignals.hideable_budget_ms(tc)
    for vals in ([], [1.0, 2.0, 4.5]):
        assert tsignals.mean_or_zero(vals) == jsignals.mean_or_zero(vals)
    # the twin model needs its pricer, in both packages
    for ctl, cfg in ((tcontroller.Controller, tconfig.ControlConfig),
                     (jcontroller.Controller, jconfig.ControlConfig)):
        with pytest.raises(ValueError, match="needs a TwinPricer"):
            ctl(cfg(method="topk", rungs=(0.5, 0.25), model="twin"))


def _pricer_args(**kw):
    import argparse

    base = dict(adaptive_model="twin", twin_records=REPO, dp_pods=1)
    return argparse.Namespace(**{**base, **kw})


_PRICER_CASES = [("simulate", "allgather", 1, 1), ("wire", "allgather", 4, 1),
                 ("wire", "sharded", 8, 1), ("wire", "hierarchical", 8, 2),
                 ("wire", "allgather", 64, 4)]


@pytest.mark.parametrize("mode,transport,world,pods", _PRICER_CASES)
def test_build_twin_pricer_matches_jax(mode, transport, world, pods):
    """``harness.loop.build_twin_pricer`` from the same flags: the pricer's
    fields are JAX's (transport mapping, world, pods, evidence rows, compute
    anchor) and its prices are equal bit for bit."""
    from tpu_compressed_dp.harness import loop as jloop
    from tpu_compressed_dp_torch.harness import loop as tloop

    args = _pricer_args(dp_pods=pods)
    tp = tloop.build_twin_pricer(args, tdp.CompressionConfig(
        method="topk", mode=mode, transport=transport), world=world)
    jp = jloop.build_twin_pricer(args, jdp.CompressionConfig(
        method="topk", mode=mode, transport=transport), world=world)
    keys = ("transport", "world", "pods", "num_collectives", "route_frac", "calib_rows",
            "compute_anchor_ms")
    assert {k: getattr(tp, k) for k in keys} == {k: getattr(jp, k) for k in keys}
    assert tp.calib_rows > 0
    assert tp.model.fabrics.keys() == jp.model.fabrics.keys()
    for bits in (0.0, 1.0, 4.2e6, 2.1e8):
        assert tp.comm_ms(bits) == jp.comm_ms(bits)
        assert tp.step_ms(bits) == jp.step_ms(bits)
    assert tloop.build_twin_pricer(_pricer_args(adaptive_model="flat"), None, world=1) is None


@pytest.mark.parametrize("transport", ["psum", "all_gather", "sharded"])
def test_twin_tick_sequence_bitwise_jax(transport):
    """Ticks priced through the twin (``model='twin'``) on one seeded signal
    sequence: every state field, Decision, event record and gauge equal to
    JAX's, the ``twin/*`` gauges included, and the rung moves."""
    from tpu_compressed_dp.twin import calibration_rows as jrows, fit as jfit
    from tpu_compressed_dp_torch.twin import calibration_rows as trows, fit as tfit

    rows_t, rows_j = trows(REPO), jrows(REPO)
    # two pods: the committed records calibrate the DCN fabric's terms (a
    # flat world's ICI terms fit to zero)
    tpr = tsignals.TwinPricer(model=tfit(rows_t).model, world=4, pods=2, transport=transport,
                              calib_rows=len(rows_t), compute_anchor_ms=12.5)
    jpr = jsignals.TwinPricer(model=jfit(rows_j).model, world=4, pods=2, transport=transport,
                              calib_rows=len(rows_j), compute_anchor_ms=12.5)
    rng = np.random.default_rng(7)
    # a budget under the twin's price: the controller walks down the ladder
    kw = dict(method="topk", rungs=(0.1, 0.05, 0.025, 0.0125), window=4, deadband=0.2,
              model="twin", budget_ms=0.6 * tpr.comm_ms(1e6))
    tc, jc = _pair(**kw)
    trec, jrec = _Rec(), _Rec()
    tctl = tcontroller.Controller(tc, events=trec, pricer=tpr)
    jctl = jcontroller.Controller(jc, events=jrec, pricer=jpr)
    ts, js = tstate.init_control_state(tc), jstate.init_control_state(jc)
    applied, n_twin = 0, 0
    for i in range(120):
        applied += int(rng.choice([0, 1, 2, 3]))
        bits = float(rng.uniform(1e5, 4e7)) * 0.5 ** int(ts.rung)
        tsig = tctl.window_signals(mean_bits=bits)
        jsig = jctl.window_signals(mean_bits=bits)
        assert dataclasses.astuple(tsig) == dataclasses.astuple(jsig)
        ts, tdec = tctl.tick(ts, applied=applied, signals=tsig)
        js, jdec = jctl.tick(js, applied=applied, signals=jsig)
        _same_state(ts, js)
        assert [dataclasses.asdict(d) for d in tdec] == [dataclasses.asdict(d) for d in jdec]
        tm, jm = tctl.metrics(ts), jctl.metrics(js)
        assert tm == jm
        n_twin += "twin/pred_step_ms" in tm
    assert n_twin > 10 and trec.ev == jrec.ev
    assert len({f["direction"] for _, f in trec.ev}) >= 2


def test_migrate_comp_state_bitwise_jax(monkeypatch):
    """A rank switch 4 -> 2 and 2 -> 4 on the same Q: the copied warm
    columns and the fresh ones; JAX's function is handed the port's fresh
    state (its own draws use JAX's PRNG)."""
    g = torch.Generator().manual_seed(0)
    grads = {"a": torch.randn(64, 48, generator=g), "b": torch.randn(48, generator=g),
             "c": torch.randn(32, 32, generator=g)}
    jgrads = {k: jnp.asarray(v.numpy()) for k, v in grads.items()}
    for r_old, r_new in ((4, 2), (2, 4), (4, 4)):
        old = tdp.CompressionConfig(method="powersgd", rank=r_old, granularity="layerwise")
        new = dataclasses.replace(old, rank=r_new)
        comp = tdp.init_comp_state(grads, old, seed=3)
        comp = {k: v + 0.5 for k, v in comp.items()}     # a "learnt" Q
        got = trungs.migrate_comp_state(comp, grads, old, new, seed=3)
        fresh = tdp.init_comp_state(grads, new, seed=3)
        monkeypatch.setattr(jrungs, "init_comp_state", lambda *a, **k: {
            q: jnp.asarray(v.numpy()) for q, v in fresh.items()})
        want = jrungs.migrate_comp_state(
            {q: jnp.asarray(v.numpy()) for q, v in comp.items()}, jgrads,
            jdp.CompressionConfig(method="powersgd", rank=r_old),
            jdp.CompressionConfig(method="powersgd", rank=r_new), None, seed=3)
        assert sorted(got) == sorted(want)
        for q in got:
            assert got[q].numpy().tobytes() == np.asarray(want[q]).tobytes(), (r_old, r_new, q)
        if r_old == r_new:
            assert got is comp
    assert trungs.migrate_comp_state((), grads, old, new) == ()


def _state(control, seed=0):
    from tpu_compressed_dp_torch.models import resnet9 as r9
    from tpu_compressed_dp_torch.models.common import param_leaves
    from tpu_compressed_dp_torch.train.optim import SGD
    from tpu_compressed_dp_torch.train.state import TrainState

    model = r9.ResNet9(channels=r9.scaled_channels(0.0625), seed=seed, device="cpu")
    params = param_leaves(model)
    opt = SGD(lr=0.1, momentum=0.9)
    return TrainState.create(model, opt.init(params), (), control=control)


def test_checkpoint_round_trip_and_legacy_rule(tmp_path):
    from tpu_compressed_dp_torch.utils.checkpoint import Checkpointer

    cfg = tconfig.ControlConfig(method="topk", rungs=(0.5, 0.25, 0.125), window=3)
    ctl = tcontroller.Controller(cfg)
    cs = tstate.init_control_state(cfg)
    for applied in (1, 2, 4, 5):
        cs, _ = ctl.tick(cs, applied=applied,
                         signals=ctl.window_signals(mean_bits=1e6 / 3, compute_ms=0.3))
    assert int(cs.rung) == 1 and int(cs.win_updates) == 1   # mid-window
    ck = Checkpointer(str(tmp_path / "with"))
    ck.save(_state(cs))
    ck.close()
    fresh = tstate.init_control_state(cfg)
    restored, _ = Checkpointer(str(tmp_path / "with")).restore(_state(fresh, seed=1))
    _same_state(restored.control, cs)
    # a step saved without control restores with the caller's fresh state
    ck = Checkpointer(str(tmp_path / "without"))
    ck.save(_state(()))
    ck.close()
    restored, _ = Checkpointer(str(tmp_path / "without")).restore(_state(fresh, seed=1))
    assert restored.control is fresh
    # a step saved with control restores into a run without the controller
    restored, _ = Checkpointer(str(tmp_path / "with")).restore(_state(()))
    _same_state(restored.control, cs)
    # the JAX package's verifier accepts the port's step directories
    assert jckpt.verify_step_dir(str(tmp_path / "with"), 0) == []
    assert jckpt.verify_step_dir(str(tmp_path / "without"), 0) == []
    # the dict form: 0-d tensors of JAX's dtypes
    d = tstate.control_to_dict(cs)
    assert [d[f].dtype for f in FIELDS] == [torch.int32] * 3 + [torch.float32] * 3 + [
        torch.int32]
    _same_state(tstate.control_from_dict(d), jstate.control_from_dict(
        {k: np.asarray(v) for k, v in d.items()}))


_WORKER = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[4])
from tpu_compressed_dp_torch.control import state as ts
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.train import elastic
import tests.test_torch_control as t
out, port, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
mesh.init_process_group(torch.device("cpu"), backend="gloo",
                        init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
mine = ts._typed(rung=rank + 1, window_start=4 * rank, win_updates=rank, win_bits=0.1 + rank,
                 win_comm_ms=1.0 / 3 + rank, win_budget_ms=rank, decisions=rank + 2)
state, extras = elastic.broadcast_replicated(t._state(mine, seed=rank), 1, extras={"r": rank})
mesh.destroy()
json.dump({"control": [np.asarray(getattr(state.control, f)).tobytes().hex()
                       for f in t.FIELDS], "extras": extras}, open(f"{out}/{rank}.json", "w"))
"""


def test_elastic_broadcast_carries_control(tmp_path):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(tmp_path), port, str(r), REPO],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = [json.load(open(tmp_path / f"{r}.json")) for r in range(2)]
    assert got[0] == got[1]
    assert got[0]["extras"] == {"r": 1}
    assert bytes.fromhex(got[0]["control"][0]) == np.int32(2).tobytes()
