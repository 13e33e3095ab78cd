"""The port's digital twin (``tpu_compressed_dp_torch/twin``) against the JAX
package's (``tpu_compressed_dp/twin``) on the CPU, bitwise: both are numpy
float64 in the same order.

  * the loader reads every committed ``BENCH_r*.json`` / ``MULTICHIP_r*.json``
    into the same shape and rows, field by field;
  * the fit on the committed rows gives JAX's calibration document,
    residuals and step RMS; planted parameters are recovered, unphysical
    ones clipped, an empty fit refused; a calibration JAX saved loads;
  * ``schedule_for_point`` / ``predict_step_ms`` are equal over a grid of
    worlds, pods, transports and methods, and refuse the same points;
  * the gate gives JAX's verdicts on pins JAX minted, and an inflated pin
    trips both;
  * ``bench.sweep.attach_prediction`` gives JAX's columns on ``BENCH_r10``;
  * ``harness/twin_report.py --json`` prints ``tools/twin_report.py``'s
    document.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from tpu_compressed_dp import twin as jtwin
from tpu_compressed_dp.bench import sweep as jsweep
from tpu_compressed_dp.twin import model as jmodel
from tpu_compressed_dp.twin import records as jrecords

from tpu_compressed_dp_torch import twin as ttwin
from tpu_compressed_dp_torch.bench import sweep as tsweep
from tpu_compressed_dp_torch.twin import model as tmodel
from tpu_compressed_dp_torch.twin import records as trecords

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = jtwin.discover_record_paths(REPO)


def _row(r):
    return dataclasses.asdict(r)


def test_discovers_the_same_records():
    assert ttwin.discover_record_paths(REPO) == PATHS
    assert len(PATHS) >= 10
    assert sorted(ttwin.__all__) == sorted(jtwin.__all__)


@pytest.mark.parametrize("path", PATHS, ids=[os.path.basename(p) for p in PATHS])
def test_loader_matches_jax(path):
    t, j = ttwin.load_record_file(path), jtwin.load_record_file(path)
    assert (t.source, t.shape, t.raw) == (j.source, j.shape, j.raw)
    assert [_row(r) for r in t.rows] == [_row(r) for r in j.rows]
    for r in t.rows:
        # field by field, the target a float of the same bits
        assert isinstance(r.target_ms, float) and r.kind in ("step", "phase")


def test_loader_refusals_match_jax(tmp_path):
    p = tmp_path / "BENCH_r99.json"
    for doc in ({"n": 1, "cmd": "x", "rc": 0, "records": [
            {"model": "m", "method": "none", "granularity": "g", "mode": "wire",
             "devices": 8, "batch": 64, "step_ms": "fast", "payload_mb_per_step": 1.0,
             "transport": "psum"}]},
                {"n": 1, "cmd": "x", "rc": 0},
                {"n": 1, "cmd": "x", "rc": 0, "records": [{"model": "m"}]}):
        p.write_text(json.dumps(doc))
        with pytest.raises(ValueError) as te:
            ttwin.load_record_file(str(p))
        with pytest.raises(ValueError) as je:
            jtwin.load_record_file(str(p))
        assert str(te.value) == str(je.value)


def test_context_key_and_scaled_schedule_match_jax():
    for path in PATHS:
        rf = jtwin.load_record_file(path)
        recs = (rf.raw["records"] if rf.shape == "sweep"
                else [rf.raw["parsed"]] if rf.shape == "step" else [])
        for rec in recs:
            assert trecords.context_key(rec) == jrecords.context_key(rec)
            for w, pods in ((8, 1), (64, 1), (256, 4), (4096, 64)):
                t = trecords.scaled_schedule(rec, world=w, pods=pods)
                j = jrecords.scaled_schedule(rec, world=w, pods=pods)
                assert [dataclasses.asdict(c) for c in t] == [dataclasses.asdict(c) for c in j]


def _fits():
    t, j = ttwin.fit(ttwin.calibration_rows(REPO)), jtwin.fit(jtwin.calibration_rows(REPO))
    return t, j


def test_fit_matches_jax():
    t, j = _fits()
    assert t.to_json() == j.to_json()
    assert [dataclasses.asdict(r) for r in t.residuals] == \
        [dataclasses.asdict(r) for r in j.residuals]
    assert [r.err_frac for r in t.residuals] == [r.err_frac for r in j.residuals]
    assert t.step_rms_frac == j.step_rms_frac
    assert (t.n_step_rows, t.n_phase_rows) == (j.n_step_rows, j.n_phase_rows)
    assert t.n_step_rows > 0 and t.n_phase_rows > 0


def _synthetic_rows(pkg, alpha, beta, gamma, fabric="dcn"):
    """``tests/test_twin.py``'s planted rows, built with ``pkg``'s model."""
    model, records = pkg
    truth = model.CostModel({fabric: model.FabricParams(alpha, beta, gamma, rows=1)})
    rows = []
    for i, (count, mb, w) in enumerate([(1.0, 2.0, 8), (2.0, 0.5, 8), (4.0, 8.0, 4),
                                        (1.0, 16.0, 16), (3.0, 1.0, 32)]):
        sched = [dataclasses.replace(
            model.flat_schedule(world=w, pods=2, count=count, psum_mb=mb)[0], fabric=fabric)]
        rows.append(records.CalibRow(source="synt", index=i, kind="phase", label=f"ph{i}",
                                     context=None, features=model.schedule_features(sched),
                                     target_ms=truth.comm_ms(sched)))
    for ctx, compute in (("a", 100.0), ("b", 250.0)):
        sched = model.flat_schedule(world=8, pods=2, count=2.0, psum_mb=4.0)
        rows.append(records.CalibRow(source="synt", index=10, kind="step", label=f"st-{ctx}",
                                     context=ctx, features=model.schedule_features(sched),
                                     target_ms=compute + truth.comm_ms(sched)))
    return rows


@pytest.mark.parametrize("planted", [(3.0, 1.5, 0.25), (3.0, 0.0, 0.0)],
                         ids=["recovers", "clips"])
def test_fit_planted_matches_jax(planted):
    t = ttwin.fit(_synthetic_rows((tmodel, trecords), *planted))
    j = jtwin.fit(_synthetic_rows((jmodel, jrecords), *planted))
    assert t.to_json() == j.to_json()
    p = t.fabrics["dcn"]
    if planted[1] > 0.0:
        assert p.alpha_ms == pytest.approx(3.0, rel=1e-6)
        assert p.beta_ms_per_mb == pytest.approx(1.5, rel=1e-6)
        assert p.gamma_ms_per_hop == pytest.approx(0.25, rel=1e-6)
        assert t.contexts["a"] == pytest.approx(100.0, rel=1e-6)
        assert t.contexts["b"] == pytest.approx(250.0, rel=1e-6)
        assert all(abs(r.err_frac) < 1e-6 for r in t.residuals)
    else:
        # the active-set pass clips what noise would fit negative, and the
        # step contexts re-solve exactly
        assert p.beta_ms_per_mb >= 0.0 and p.gamma_ms_per_hop >= 0.0
        assert all(abs(r.err_frac) < 1e-6 for r in t.residuals if r.kind == "step")


def test_fit_refuses_empty_as_jax():
    with pytest.raises(ValueError) as te:
        ttwin.fit([])
    with pytest.raises(ValueError) as je:
        jtwin.fit([])
    assert str(te.value) == str(je.value) and "no calibration rows" in str(te.value)


def test_load_calibration_reads_jax(tmp_path):
    t, j = _fits()
    path = str(tmp_path / "calib.json")
    jtwin.save_calibration(j, path)
    got = ttwin.load_calibration(path)
    assert got.to_json() == j.from_json(json.load(open(path))).to_json()
    assert got.step_rms_frac == jtwin.load_calibration(path).step_rms_frac
    tpath = str(tmp_path / "calib_t.json")
    ttwin.save_calibration(t, tpath)
    assert open(tpath).read() == open(path).read()


_WORLDS = [(1, 1), (2, 1), (8, 1), (8, 2), (64, 1), (64, 4), (256, 4), (4096, 64)]
_TRANSPORTS = ["psum", "all_gather", "sharded", "hierarchical"]
_METHODS = ["topk", "randomk", "qsgd", "none"]


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the refusal's type and text are compared
        return type(e).__name__, str(e)


@pytest.mark.parametrize("transport", _TRANSPORTS)
def test_prices_match_jax(transport):
    """Every (W, pods) x method at this transport: the schedule, the price
    under the fitted calibration and under one with DCN uncalibrated, or
    the same refusal (``UncalibratedFabricError`` included)."""
    t_cal, j_cal = _fits()
    t_ici = tmodel.CostModel({"ici": t_cal.fabrics["ici"]})
    j_ici = jmodel.CostModel({"ici": j_cal.fabrics["ici"]})
    refused = set()
    for (w, pods) in _WORLDS:
        for method in _METHODS:
            kw = dict(world=w, transport=transport, n_params=6_573_120, dp_pods=pods,
                      method=method, ratio=0.01, num_collectives=3.0, compute_ms=41.5,
                      hideable_fraction=0.25)
            tp, jp = tmodel.TwinPoint(**kw), jmodel.TwinPoint(**kw)
            ts = _outcome(lambda: [dataclasses.asdict(c)
                                   for c in tmodel.schedule_for_point(tp)])
            js = _outcome(lambda: [dataclasses.asdict(c)
                                   for c in jmodel.schedule_for_point(jp)])
            assert ts == js, (w, pods, method)
            for tm, jm in ((t_cal.model, j_cal.model), (t_ici, j_ici)):
                got = _outcome(lambda: tmodel.predict_step_ms(tm, tp))
                assert got == _outcome(lambda: jmodel.predict_step_ms(jm, jp)), (w, pods,
                                                                                 method)
                refused.add(got[0])
    # every pods > 1 point bills DCN, which the second model lacks
    assert "UncalibratedFabricError" in refused and "ok" in refused


def test_uncalibrated_fabric_refused_as_jax():
    kw = dict(world=64, transport="all_gather", n_params=1000, dp_pods=4, method="topk",
              ratio=0.1)
    for pkg, point in ((tmodel, tmodel.TwinPoint(**kw)), (jmodel, jmodel.TwinPoint(**kw))):
        cm = pkg.CostModel({"ici": pkg.FabricParams(1.0, 1.0, 1.0, rows=3),
                            "dcn": pkg.FabricParams(1.0, 1.0, 1.0, rows=0)})
        with pytest.raises(pkg.UncalibratedFabricError, match="'dcn' has no calibration"):
            pkg.predict_step_ms(cm, point)


def _pins(calib):
    """Pins minted by JAX's ``make_pin`` over a few of the calibration's
    contexts: dense psum, sparse all_gather and sharded at the records' W,
    and a 2-pod hierarchical point."""
    ctx = sorted(calib.contexts)
    dense = next(c for c in ctx if "method=none" in c and "devices=8" in c
                 and "pods=1" in c and "mode=wire" in c)
    topk = next(c for c in ctx if "method=topk" in c and "transport=all_gather" in c)
    points = [("dense-psum-w8", dict(world=8, transport="psum", n_params=412950,
                                     method="none", num_collectives=25.0), dense),
              ("topk-ag-w8", dict(world=8, transport="all_gather", n_params=412950,
                                  method="topk", ratio=0.01), topk),
              ("topk-sharded-w64", dict(world=64, transport="sharded", n_params=412950,
                                        method="topk", ratio=0.01, dp_pods=2), topk),
              ("topk-hier-w64", dict(world=64, transport="hierarchical", n_params=412950,
                                     method="topk", ratio=0.01, dp_pods=4), topk)]
    return {"tolerance_frac": 0.1,
            "pins": [jtwin.make_pin(name, point, c, calib) for name, point, c in points]}


def test_gate_matches_jax(tmp_path):
    t_cal, j_cal = _fits()
    doc = _pins(j_cal)
    path = tmp_path / "pins.json"
    path.write_text(json.dumps(doc))
    tdoc, jdoc = ttwin.load_pins(str(path)), jtwin.load_pins(str(path))
    tres, jres = ttwin.check_pins(tdoc, t_cal), jtwin.check_pins(jdoc, j_cal)
    assert [dataclasses.asdict(r) for r in tres] == [dataclasses.asdict(r) for r in jres]
    assert all(r.ok for r in tres)
    for pin in doc["pins"]:
        assert ttwin.make_pin(pin["name"], pin["point"], pin["context"], t_cal) == pin
        assert ttwin.price_pin(pin, t_cal) == jtwin.price_pin(pin, j_cal)
    # a pin minted far below today's price is a modeled regression in both
    bad = copy.deepcopy(doc)
    bad["pins"][1]["modeled_step_ms"] *= 0.5
    tres, jres = ttwin.check_pins(bad, t_cal), jtwin.check_pins(bad, j_cal)
    assert [dataclasses.asdict(r) for r in tres] == [dataclasses.asdict(r) for r in jres]
    assert not tres[1].ok and "regression" in tres[1].note
    # and a vanished context is unpriceable in both
    gone = copy.deepcopy(doc)
    gone["pins"][0]["context"] = "model=gone"
    assert [dataclasses.asdict(r) for r in ttwin.check_pins(gone, t_cal)] == \
        [dataclasses.asdict(r) for r in jtwin.check_pins(gone, j_cal)]


def test_attach_prediction_matches_jax():
    t_cal, j_cal = _fits()
    raw = json.load(open(os.path.join(REPO, "BENCH_r10.json")))
    assert raw["records"]
    for rec in raw["records"]:
        for pod_size in (64, 2):
            got = tsweep.attach_prediction(dict(rec), t_cal, pod_size=pod_size)
            want = jsweep.attach_prediction(dict(rec), j_cal, pod_size=pod_size)
            assert got == want
            assert "pred_step_ms" in got and "pred_basis" in got
    assert tsweep.PREDICT_WORLDS == jsweep.PREDICT_WORLDS


@pytest.mark.parametrize("flags", [["--json"], ["--json", "--gate"], []],
                         ids=["json", "json-gate", "text"])
def test_twin_report_matches_jax(flags, tmp_path):
    """The report's output on the repository's records, the port's report
    against ``tools/twin_report.py``, with ``--pins`` in ``tmp_path``."""
    pins = tmp_path / "pins.json"
    pins.write_text(json.dumps(_pins(_fits()[1])))
    argv = ["--records", REPO, "--pins", str(pins), *flags]
    outs = []
    for cmd in ([sys.executable, "-m", "tpu_compressed_dp_torch.harness.twin_report"],
                [sys.executable, os.path.join(REPO, "tools", "twin_report.py")]):
        res = subprocess.run(cmd + argv, cwd=REPO, capture_output=True, text=True, timeout=240,
                             env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert res.returncode == 0, res.stderr[-2000:]
        outs.append(res.stdout)
    assert outs[0] == outs[1]
    if "--json" in flags:
        doc = json.loads(outs[0])
        assert doc["projection"] and ("gate" in doc) == ("--gate" in flags)


def test_twin_report_pins_only_where_given(tmp_path):
    """``--gate`` / ``--update_pins`` need ``--pins``; ``--update_pins``
    rewrites that file only, at today's prices (JAX's ``make_pin``)."""
    from tpu_compressed_dp_torch.harness import twin_report

    with pytest.raises(SystemExit):
        twin_report.main(["--records", REPO, "--gate"])
    doc = _pins(_fits()[1])
    stale = copy.deepcopy(doc)
    for pin in stale["pins"]:
        pin["modeled_step_ms"] = 1.0
    path = tmp_path / "pins.json"
    path.write_text(json.dumps(stale))
    assert twin_report.main(["--records", REPO, "--update_pins", "--pins", str(path)]) == 0
    got = json.loads(path.read_text())
    assert [p["modeled_step_ms"] for p in got["pins"]] == \
        [p["modeled_step_ms"] for p in doc["pins"]]
    assert twin_report.main(["--records", REPO, "--gate", "--pins", str(path)]) == 0
