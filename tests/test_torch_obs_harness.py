"""The port's harnesses with the telemetry and control flags, the drill rows,
``watchdog --check`` and the postmortem, against the JAX package on the CPU.

  * dawn: one tiny run of each package with ``--events --prom --flight_dir
    --job_id --heartbeat --adaptive`` (wire Top-K, so both bill exactly the
    keep counts): the same record kinds with the same fields, the same
    Prometheus names, the ``control_decision`` records equal field for field
    (the rung schedule bitwise JAX's);
  * ImageNet (PowerSGD ranks) and the LM (ratios at the log cadence): the
    decisions the port's harness logged are what JAX's ``Controller`` gives
    on the windows the harness logged;
  * ``--profile_epoch`` writes a trace with the ``tcdp.*`` ranges;
  * a guard-wedging ``--chaos`` run leaves a bundle both postmortems name;
  * the drill rows ``control_resume`` and ``forensics`` run;
  * ``watchdog --check`` gives JAX's exit codes on the same heartbeat files.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest

import torch

from tpu_compressed_dp.control import config as jconfig
from tpu_compressed_dp.control import controller as jcontroller
from tpu_compressed_dp.control import signals as jsignals
from tpu_compressed_dp.control import state as jstate
from tpu_compressed_dp.harness import dawn as jdawn
from tpu_compressed_dp.obs import export as jexport

from tpu_compressed_dp_torch.harness import dawn as tdawn
from tpu_compressed_dp_torch.harness import imagenet as timagenet
from tpu_compressed_dp_torch.harness import lm as tlm
from tpu_compressed_dp_torch.obs import export as texport
from tpu_compressed_dp_torch.obs import flight as tflight

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAWN = ["--synthetic", "--synthetic_n", "64", "--batch_size", "32", "--epochs", "3",
        "--compress", "entiremodel", "--method", "topk", "--ratio", "0.05", "--error_feedback",
        "--mode", "wire", "--channels_scale", "0.125", "--log_dir", "", "--adaptive",
        "--adaptive_window", "2", "--adaptive_budget_ms", "1e-6"]


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


def _telemetry(d):
    return ["--events", f"{d}/ev.jsonl", "--prom", f"{d}/m.prom", "--flight_dir", f"{d}/fl",
            "--job_id", "jj", "--heartbeat", f"{d}/hb.json", "--events_max_mb", "0.002"]


@pytest.fixture(scope="module")
def dawn_runs(tmp_path_factory):
    """``(port dir, JAX dir)``: the same tiny dawn run in each package."""
    t, j = tmp_path_factory.mktemp("tdawn"), tmp_path_factory.mktemp("jdawn")
    tdawn.main(DAWN + _telemetry(t) + ["--device", "cpu"])
    jdawn.main(DAWN + _telemetry(j))
    return str(t), str(j)


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("ts", "seg")}


def test_dawn_records_match_the_jax_harness(dawn_runs):
    t, j = dawn_runs
    tev = texport.read_all_events(f"{t}/jj.ev.jsonl")
    jev = jexport.read_all_events(f"{j}/jj.ev.jsonl")
    # both rotate (--events_max_mb), and each reader reads the other's files
    assert texport.list_segments(f"{t}/jj.ev.jsonl")
    assert jexport.read_all_events(f"{t}/jj.ev.jsonl") == tev
    assert [r["kind"] for r in tev] == [r["kind"] for r in jev]
    for a, b in zip(tev, jev):
        assert set(a) == set(b), (a["kind"], set(a) ^ set(b))
        if a["kind"] == "epoch":
            for part in ("control", "timeline", "comm"):
                assert set(a[part]) <= set(b[part]) | {"comm/sent_bits_ici"}, part
            assert set(a["control"]) == set(b["control"])
            assert set(a["metrics"]) - set(b["metrics"]) <= {"steps"}
        if a["kind"] == "run_start":
            assert _strip(a) == _strip(b) | {"devices": 1}
    # the decisions: bitwise JAX's (wire mode bills exactly the keep counts)
    tdec = [_strip(r) for r in tev if r["kind"] == "control_decision"]
    jdec = [_strip(r) for r in jev if r["kind"] == "control_decision"]
    assert tdec == jdec and len(tdec) == 3
    assert [r["rung_to"] for r in tdec] == [1, 2, 3]
    # Prometheus: the same metric names under the job label
    def names(path):
        return {ln.split("{")[0] for ln in open(path) if ln and not ln.startswith("#")}
    tn, jn = names(f"{t}/jj.m.prom"), names(f"{j}/jj.m.prom")
    assert tn - jn <= {"tcdp_comm_sent_bits_ici"}, tn - jn
    assert jn - tn <= {"tcdp_throughput_model_tflops_per_chip"}, jn - tn
    assert 'job="jj"' in open(f"{t}/jj.m.prom").read()
    # a clean run: no bundle, one phase profile; the heartbeat's fields
    assert tflight.read_bundles(f"{t}/fl/jj") == {}
    assert os.path.exists(f"{t}/fl/jj/flight.rank0.phases.json")
    thb, jhb = json.load(open(f"{t}/jj.hb.json")), json.load(open(f"{j}/jj.hb.json"))
    assert set(thb) == set(jhb)
    assert (thb["control_rung"], thb["control_value"]) == (jhb["control_rung"],
                                                           jhb["control_value"])


def _replay(records, cfg_kw, bits_of, applied_of):
    """JAX's Controller over the windows a port harness logged."""
    cfg = jconfig.ControlConfig(**cfg_kw)
    ctl = jcontroller.Controller(cfg)
    cs = jstate.init_control_state(cfg)
    out = []
    for r in records:
        cs, decs = ctl.tick(cs, applied=applied_of(r),
                            signals=ctl.window_signals(mean_bits=bits_of(r)))
        out += [d.event_fields() for d in decs]
    return out


def test_imagenet_and_lm_decisions_are_jaxs(tmp_path):
    d = str(tmp_path)
    timagenet.main(["--synthetic", "--arch", "resnet18", "--width", "8", "--num_classes", "8",
                    "--compress", "layerwise", "--method", "powersgd", "--rank", "4",
                    "--error_feedback", "--workers", "2", "--device", "cpu", "--adaptive",
                    "--adaptive_window", "4", "--adaptive_budget_ms", "0.05",
                    "--adaptive_bw_mbps", "50", "--events", f"{d}/im.jsonl", "--synthetic_n",
                    "64"])
    ev = texport.read_events(f"{d}/im.jsonl")
    got = [_strip(r) for r in ev if r["kind"] == "control_decision"]
    want = _replay([r for r in ev if r["kind"] == "epoch"],
                   dict(method="powersgd", rungs=(4.0, 2.0, 1.0), window=4, budget_ms=0.05,
                        bandwidth_mbps=50.0),
                   lambda r: jsignals.billed_signal_bits(r["comm"], 1), lambda r: r["step"])
    assert [{k: v for k, v in g.items() if k not in ("v", "kind", "knob")} for g in got] == want
    assert got and all(g["knob"] == "rank" for g in got)
    tlm.main(["--device", "cpu", "--preset", "tiny", "--steps", "12", "--log_every", "2",
              "--seq_len", "32", "--global_batch", "2", "--fp32", "--compress", "entiremodel",
              "--method", "topk", "--ratio", "0.05", "--error_feedback", "--adaptive",
              "--adaptive_window", "3", "--adaptive_budget_ms", "0.02", "--events",
              f"{d}/lm.jsonl"])
    ev = texport.read_events(f"{d}/lm.jsonl")
    got = [_strip(r) for r in ev if r["kind"] == "control_decision"]
    want = _replay([r for r in ev if r["kind"] == "step"],
                   dict(method="topk", rungs=(0.05, 0.025, 0.0125, 0.00625, 0.003125),
                        window=3, budget_ms=0.02),
                   lambda r: r["comm"]["comm/sent_bits"], lambda r: r["step"])
    assert [{k: v for k, v in g.items() if k not in ("v", "kind", "knob")} for g in got] == want
    assert len(got) >= 3


def test_profile_epoch_traces_the_phases(tmp_path):
    tdawn.main(["--synthetic", "--synthetic_n", "64", "--batch_size", "32", "--epochs", "2",
                "--compress", "layerwise", "--method", "topk", "--ratio", "0.05",
                "--error_feedback", "--channels_scale", "0.125", "--log_dir", str(tmp_path),
                "--profile_epoch", "1", "--device", "cpu"])
    trace = json.load(open(tmp_path / "profile" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"tcdp.grad", "tcdp.ef", "tcdp.compress", "tcdp.reduce", "tcdp.return",
            "tcdp.update"} <= names, sorted(n for n in names if str(n).startswith("tcdp"))


def test_wedged_guard_leaves_a_bundle_both_postmortems_name(tmp_path):
    from tpu_compressed_dp_torch.harness import postmortem as tpm
    from tpu_compressed_dp_torch.train.guard import GuardExceeded

    with pytest.raises(GuardExceeded):
        tdawn.main(["--synthetic", "--synthetic_n", "128", "--batch_size", "32", "--epochs",
                    "1", "--channels_scale", "0.125", "--log_dir", "", "--chaos",
                    "nan,target=grads,every=1", "--guard_max_skips", "2", "--flight_dir",
                    str(tmp_path), "--device", "cpu"])
    bundles = tflight.read_bundles(str(tmp_path))
    assert list(bundles) == [0] and bundles[0]["reason"] == "guard_exceeded"
    assert tflight.validate_bundle(bundles[0]) == []
    v = tpm.classify(bundles)
    assert (v["kind"], v["rank"]) == ("nan", 0) and v == _tool("postmortem").classify(bundles)
    for cli in ([sys.executable, "-m", "tpu_compressed_dp_torch.harness.postmortem"],
                [sys.executable, os.path.join(REPO, "tools", "postmortem.py")]):
        out = subprocess.run([*cli, str(tmp_path)], cwd=REPO, capture_output=True, text=True,
                             timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
        assert out.returncode == 0 and out.stdout.startswith("postmortem: nan rank=0"), (
            out.stdout + out.stderr)


def test_drill_rows_run():
    from tpu_compressed_dp_torch.harness import chaos_drill

    assert {"control_resume", "forensics"} <= set(chaos_drill.FULL)
    got = chaos_drill.run_drills(["control_resume", "forensics"], "cpu")
    assert got["control_resume"]["rungs"] == [1, 2, 2]
    assert got["forensics"]["verdicts"] == {"nan": "nan", "dead_peer": "dead_peer",
                                            "preempt": "preempt", "corruption": "corruption"}


def test_watchdog_check_exit_codes_match_jax(tmp_path):
    from tpu_compressed_dp_torch.harness import watchdog as tw

    jw = _tool("watchdog")
    hb = tmp_path / "hb.json"
    now = time.time()
    payloads = [
        {"ts": now, "step": 10, "last_good_step": 10},
        {"ts": now - 300, "step": 10, "last_good_step": 10},
        {"ts": now, "step": 500, "last_good_step": 10},
        {"ts": now, "step": 10, "telemetry": {"steps_per_sec": 0.001, "step_p95_ms": 5.0}},
        {"ts": now, "step": 10, "telemetry": {"steps_per_sec": 5.0, "step_p95_ms": 900.0}},
        {"ts": now, "step": 10, "ckpt_age_s": 4000.0, "last_ckpt_step": 4},
        {"ts": now, "step": 10, "straggler_skew_s": 2.5, "straggler_rank": 3},
        {"ts": now, "step": 10, "straggler_skew_s": 0.0, "straggler_rank": -1,
         "control_rung": 2, "telemetry": {"steps_per_sec": 5.0, "step_p95_ms": 5.0}},
    ]
    flags = ["--max_age", "60", "--max_wedge", "100", "--min_step_rate", "0.01",
             "--max_step_p95_ms", "500", "--max_ckpt_age", "600", "--max_straggler_skew", "1"]
    rcs = []
    for p in payloads + [None]:
        if p is None:
            hb.unlink()
        else:
            hb.write_text(json.dumps(p))
        argv = ["--check", "--heartbeat", str(hb), *flags]
        rc = tw.main(argv)
        assert rc == jw.main(argv)
        rcs.append(rc)
    assert rcs == [0, 1, 1, 1, 1, 1, 1, 0, 2]
