"""The port's compression sweep (``tpu_compressed_dp_torch/bench``) against the
JAX package's ``bench/sweep.py`` on the CPU: ResNet-9 at channels_scale
0.125, batch 64, 2 timed steps, the JAX initial parameters planted into the
port (``models/common.load_flax_params``), so data-dependent bills match.

  * W = 1 in-process: the dense row, layer-wise Top-K simulate + EF and
    entire-model wire Top-K; W = 2 gloo processes against JAX on a 2-device
    mesh: entire-model wire Top-K over allgather and over sharded, and over
    sharded at the default capacity factors on planted gradients.  The
    records have the same key set (``mfu`` is absent on both sides on the
    CPU, whose peak neither package knows); the analytic columns are equal
    exactly; times are finite and above 0;
  * ``run_adaptive_point`` at rungs (0.5, 0.25) with a pinned budget: the
    rungs and directions of the window trace, the bits per update, the
    billed bits and the best static rung are JAX's;
  * the CLI: its JSON lines, wrapped in the BENCH shape, load as ``sweep``
    under both packages' loaders with equal rows; ``--phase_breakdown``
    columns carry the JAX sweep's key set on the Top-K wire rows and no
    other row; ``run_sweep``'s grid, ``--predict`` columns, JSON lines and
    ``--tsv`` file are JAX's ``run_sweep`` fed the same measurements;
  * the flags are JAX's plus ``--device``; a missing card, a ``--devices``
    the process group does not have and the chains' stage maps refuse or
    match as JAX's.
"""

from __future__ import annotations

import copy
import io
import json
import math
import os
import pickle
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_compressed_dp.bench import sweep as jsweep
from tpu_compressed_dp.models.common import init_model

import torch

from tpu_compressed_dp_torch.bench import phases as tphases
from tpu_compressed_dp_torch.bench import sweep as tsweep
from tpu_compressed_dp_torch.models import common as tcommon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
SCALE = 0.125
POINT = dict(model="resnet9", channels_scale=SCALE, batch_size=64, steps=2, warmup=3)
#: the columns the analytic bills fix: equal to JAX's exactly
EXACT = ("payload_mb_per_step", "payload_mb_psum", "payload_mb_allgather",
         "payload_mb_alltoall", "payload_mb_ici", "payload_mb_dcn", "dense_mb_per_step",
         "transport", "sent_frac", "wire_frac", "num_collectives", "per_chip_traffic_mb",
         "per_chip_traffic_mb_ici", "per_chip_traffic_mb_dcn")
#: the measured columns: held by contract only
TIMES = ("step_ms", "images_per_sec", "images_per_sec_per_chip",
         "model_tflops_per_sec_per_chip")
W1_CASES = {"dense": dict(method=None),
            "topk lw simulate ef": dict(method="topk", granularity="layerwise",
                                        error_feedback=True),
            "wire topk em": dict(method="topk", granularity="entiremodel", mode="wire",
                                 error_feedback=True)}
#: capacity factors at which the owner-sharded transport clips nothing: its
#: route / return clips follow which coordinates the search picks, and the
#: two frameworks' own float32 gradients differ (JAX's on the CPU stray from
#: its float64 ones by up to ~5 % of a leaf's largest entry for this net,
#: tests/test_torch_resnet9_step.py), so they pick other coordinates;
#: PLANTED_CASES hold the clips at the default factors on equal gradients
LOSSLESS = 1e6
W2_CASES = {"wire topk em allgather": dict(method="topk", granularity="entiremodel",
                                           mode="wire", error_feedback=True),
            "wire topk em sharded": dict(method="topk", granularity="entiremodel", mode="wire",
                                         error_feedback=True, transport="sharded",
                                         shard_route_factor=LOSSLESS,
                                         shard_return_factor=LOSSLESS)}
#: the sharded transport at its default capacity factors (1.25) on planted
#: gradients, the same on both sides (:func:`_planted`), whose survivors
#: crowd into owner 0's half so that the route and return clip
PLANTED_CASES = {"wire topk em sharded planted": dict(
    method="topk", granularity="entiremodel", mode="wire", error_feedback=True,
    transport="sharded")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the tier-1 run's parallel workers a thread
    per core in every worker oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_init():
    """The JAX sweep's initial ResNet-9 (``init_model`` at key 0) as numpy
    trees."""
    module = jsweep._build_model("resnet9", 128, 1000, SCALE)[0]
    params, stats = init_model(module, jax.random.key(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return as_np(params), as_np(stats)


def _plant(monkeypatch, init):
    """Make the port's sweep build its nets from the JAX init."""
    build = tsweep._build_model

    def from_jax(*a, **k):
        module, sz, ncls = build(*a, **k)
        tcommon.load_flax_params(module, *init)
        return module, sz, ncls

    monkeypatch.setattr(tsweep, "_build_model", from_jax)


@pytest.fixture(scope="module")
def jax_init():
    return _jax_init()


def _planted(params) -> list:
    """Each of two ranks' gradient, a tree shaped like ``params`` from a
    seed, its raveled first half four times the second in magnitude."""
    from jax.flatten_util import ravel_pytree

    flat, unravel = ravel_pytree(params)
    g = np.random.default_rng(7).normal(size=(2, flat.size)).astype(np.float32) * 1e-2
    g[:, : flat.size // 2] *= 4.0
    return [jax.tree.map(np.asarray, unravel(jnp.asarray(row))) for row in g]


def _jax_planted_sync(grads: list):
    """``train.step.make_grad_sync`` whose syncs take device i's gradient
    from ``grads[i]`` in place of the step's."""
    from tpu_compressed_dp.train import step as jstep

    real = jstep.make_grad_sync
    stacked = jax.tree.map(lambda *a: np.stack(a), *grads)

    def make(cfg, axis_name):
        sync = real(cfg, axis_name)

        def planted(scaled, ef, comp, key, ok=None):
            i = jax.lax.axis_index(axis_name)
            return sync(jax.tree.map(lambda a: jnp.asarray(a)[i], stacked), ef, comp, key,
                        ok=ok)

        return planted

    return make


def _check_pair(got: dict, want: dict, label: str) -> None:
    assert set(got) == set(want), (label, set(got) ^ set(want))
    assert "mfu" not in got     # no known peak on the CPU, in either package
    for k in EXACT:
        assert got[k] == want[k], (label, k, got[k], want[k])
    for k in TIMES:
        assert math.isfinite(got[k]) and got[k] > 0, (label, k, got[k])
    same = {k for k in got if k not in TIMES and not k.startswith(("allreduce", "dense_allreduce",
                                                                   "projected_"))}
    assert {k: got[k] for k in same} == {k: want[k] for k in same}, label


@pytest.mark.parametrize("label", list(W1_CASES))
def test_run_point_w1_matches_jax(label, jax_init, monkeypatch):
    _plant(monkeypatch, jax_init)
    kw = {**POINT, **W1_CASES[label]}
    got = tsweep.run_point(**kw, device="cpu")
    want = jsweep.run_point(**kw, devices=1)
    _check_pair(got, want, label)
    assert got["devices"] == 1 and got["batch"] == 64


_WORKER = r"""
import json, pickle, sys
import torch
sys.path.insert(0, sys.argv[4])
from tpu_compressed_dp_torch.bench import sweep
from tpu_compressed_dp_torch.models import common
from tpu_compressed_dp_torch.parallel import mesh
out, port, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
torch.set_num_threads(1)
init, planted = pickle.load(open(f"{out}/init.pkl", "rb"))
point, cases, planted_cases = json.load(open(f"{out}/cases.json"))
build = sweep._build_model
grads = {}

def from_jax(*a, **k):
    module, sz, ncls = build(*a, **k)
    common.load_flax_params(module, *init)
    grads["rank"] = common.flax_to_leaves(module, planted[rank])
    return module, sz, ncls

sweep._build_model = from_jax
mesh.init_process_group(torch.device("cpu"), backend="gloo",
                        init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
recs = {label: sweep.run_point(**point, **kw, devices=2, device="cpu")
        for label, kw in cases.items()}
# the planted cases: every sync takes this rank's planted gradient
from tpu_compressed_dp_torch.train import step
real_sync = step.make_stateful_grad_sync

def planted_sync(cfg):
    sync = real_sync(cfg)
    return lambda scaled, ef, comp, seed, ok=None: sync(grads["rank"], ef, comp, seed, ok=ok)

step.make_stateful_grad_sync = planted_sync
for label, kw in planted_cases.items():
    recs[label] = sweep.run_point(**point, **kw, devices=2, device="cpu")
step.make_stateful_grad_sync = real_sync
try:
    sweep.run_point(**point, devices=4, device="cpu")
    recs["refused"] = None
except ValueError as e:
    recs["refused"] = str(e)
# the phase chains whose collectives span the two ranks
from tpu_compressed_dp_torch.bench import phases
from tpu_compressed_dp_torch.parallel.dp import CompressionConfig
from tpu_compressed_dp_torch.train.optim import SGD
recs["phases"] = {
    tr: phases.phase_breakdown_cols(
        CompressionConfig(method="topk", mode="wire", transport=tr, dp_pods=pods),
        50000, 500, SGD(lr=0.01), {"w": torch.zeros(64)}, 2, "cpu")
    for tr, pods in (("allgather", 1), ("sharded", 1), ("hierarchical", 2))}
mesh.destroy()
json.dump(recs, open(f"{out}/rank{rank}.json", "w"))
"""


def test_run_point_w2_gloo_matches_jax(jax_init, tmp_path, monkeypatch):
    """Two gloo ranks, one process each, against JAX's 2-device mesh: every
    rank returns the world's analytic columns, rank 0's record matches
    JAX's, on the planted gradients at the default capacity factors too,
    where the route and return clip; a ``--devices`` the group does not
    have raises."""
    from tpu_compressed_dp.train import step as jstep
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    planted = _planted(jax_init[0])
    with open(tmp_path / "init.pkl", "wb") as f:
        pickle.dump((jax_init, planted), f)
    (tmp_path / "cases.json").write_text(json.dumps([POINT, W2_CASES, PLANTED_CASES]))
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(tmp_path), port, str(r), REPO],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    want = {label: jsweep.run_point(**POINT, **kw, devices=2) for label, kw in W2_CASES.items()}
    with monkeypatch.context() as m:
        m.setattr(jstep, "make_grad_sync", _jax_planted_sync(planted))
        want.update({label: jsweep.run_point(**POINT, **kw, devices=2)
                     for label, kw in PLANTED_CASES.items()})
    logs = [p.communicate(timeout=400)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    for label in [*W2_CASES, *PLANTED_CASES]:
        _check_pair(got[0][label], want[label], label)
        for k in EXACT:
            assert got[1][label][k] == got[0][label][k], (label, k)
        assert got[0][label]["devices"] == 2
    assert want["wire topk em sharded"]["transport"] == "sharded"
    clipped = got[0]["wire topk em sharded planted"]
    assert clipped["transport"] == "sharded" and clipped["shard_overflow"] > 0, clipped
    assert clipped["shard_overflow"] == want["wire topk em sharded planted"]["shard_overflow"]
    assert "has 2 rank(s)" in got[0]["refused"]
    for tr, cols in got[0]["phases"].items():
        key = "all_gather" if tr == "allgather" else tr
        want_keys = {f"phase_{p}_ms" for p in tphases.PHASE_OF[key].values()}
        assert set(cols) == want_keys | {"phase_update_ms"}, tr
        assert set(got[1]["phases"][tr]) == set(cols)
        assert all(math.isfinite(v) and v >= 0.0 for v in cols.values()), (tr, cols)


def test_run_adaptive_point_matches_jax(jax_init, monkeypatch):
    """The closed loop at rungs (0.5, 0.25) with the budget pinned between
    the two rungs' modeled comm: the decisions depend only on billed bits,
    so the trajectory, the bills and the best static rung are JAX's."""
    _plant(monkeypatch, jax_init)
    kw = dict(model="resnet9", method="topk", granularity="layerwise", ratio=0.5,
              error_feedback=True, batch_size=64, windows=3, window=2, rungs=(0.5, 0.25),
              budget_ms=20.0, channels_scale=SCALE)
    got = tsweep.run_adaptive_point(**kw, device="cpu")
    want = jsweep.run_adaptive_point(**kw, devices=1)
    assert set(got) == set(want)
    trace = lambda r: [(w["rung"], w["value"], w["direction"], w["rung_to"],  # noqa: E731
                        w["bits_per_update"], w["comm_ms"], w["budget_ms"])
                       for w in r["window_trace"]]
    assert trace(got) == trace(want)
    assert [w["direction"] for w in got["window_trace"]] == ["down", "hold", "hold"]
    for key in ("adaptive_billed_bits", "best_static", "best_static_billed_bits",
                "billed_bits_ratio", "final_rung", "decisions", "updates",
                "converged_to_best_static", "rungs", "knob"):
        assert got[key] == want[key], key
    assert [(r["rung"], r["bits_per_update"], r["fits_budget"]) for r in got["static_rungs"]] \
        == [(r["rung"], r["bits_per_update"], r["fits_budget"]) for r in want["static_rungs"]]
    assert all(w["step_ms"] > 0 for w in got["window_trace"] + got["static_rungs"])


def _jax_phase_maps() -> dict:
    """The JAX sweep's stage -> phase maps by transport, read from the
    source of ``_phase_breakdown_cols`` (its ladders are ``shard_map``
    programs this host's jax refuses to trace, so they are not run here)."""
    import ast
    import inspect

    fn = ast.parse(inspect.getsource(jsweep._phase_breakdown_cols)).body[0]
    sharded = next(n for n in fn.body if isinstance(n, ast.If))   # if / elif / else
    hier = sharded.orelse[0]
    bodies = {"sharded": sharded.body, "hierarchical": hier.body, "all_gather": hier.orelse}
    return {tr: ast.literal_eval(next(n for n in body if isinstance(n, ast.Assign)
                                      and n.targets[0].id == "phase_of").value)
            for tr, body in bodies.items()}


def _jax_phase_keys(transport: str) -> set:
    """The phase columns JAX's ``--phase_breakdown`` adds for ``transport``."""
    return {f"phase_{p}_ms" for p in _jax_phase_maps()[transport].values()} | {
        "phase_update_ms"}


CLI = ["--channels_scale", str(SCALE), "--batch_size", "64", "--steps", "2", "--methods",
       "topk,terngrad", "--ratios", "0.01", "--granularities", "entiremodel", "--mode", "wire",
       "--error_feedback", "--transports", "allgather,sharded", "--phase_breakdown",
       "--predict", "--twin_records", REPO]


def test_sweep_cli_matches_jax_run_sweep(jax_init, monkeypatch, tmp_path):
    """The port's CLI on the CPU, then JAX's ``run_sweep`` with the same
    flags fed the port's measurements in call order: the same grid, JSON
    lines (``--predict`` columns included) and TSV file; the records load as
    a ``sweep`` under both loaders; phase columns only on the Top-K wire
    rows, with JAX's key set."""
    from tpu_compressed_dp.twin import load_record_file as jload
    from tpu_compressed_dp_torch.twin import load_record_file as tload

    _plant(monkeypatch, jax_init)
    tsv_t, tsv_j = str(tmp_path / "t.tsv"), str(tmp_path / "j.tsv")
    raw = []
    real_point = tsweep.run_point

    def keep_raw(**kw):
        rec = real_point(**kw)
        raw.append(copy.deepcopy(rec))
        return rec

    monkeypatch.setattr(tsweep, "run_point", keep_raw)
    out = io.StringIO()
    with redirect_stdout(out):
        got = tsweep.main(CLI + ["--tsv", tsv_t, "--device", "cpu"])
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    assert lines == got and len(got) == 4          # dense, topk x 2 transports, terngrad
    assert [r["method"] for r in got] == ["none", "topk", "topk", "terngrad"]

    calls = []

    def replay(**kw):
        calls.append(kw)
        return copy.deepcopy(raw[len(calls) - 1])

    monkeypatch.setattr(jsweep, "run_point", replay)
    out = io.StringIO()
    with redirect_stdout(out):
        want = jsweep.run_sweep(jsweep.build_parser().parse_args(CLI + ["--tsv", tsv_j]))
    assert got == want
    assert [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")] == lines
    assert open(tsv_t).read() == open(tsv_j).read()
    assert open(tsv_t).read().startswith("# transport: the collective")

    bench = {"n": 1, "cmd": "python -m tpu_compressed_dp_torch.bench.sweep", "rc": 0,
             "records": got}
    path = tmp_path / "BENCH_r98.json"
    path.write_text(json.dumps(bench))
    t, j = tload(str(path)), jload(str(path))
    assert t.shape == j.shape == "sweep"
    assert [r.__dict__ for r in t.rows] == [r.__dict__ for r in j.rows]

    keys = {"all_gather": _jax_phase_keys("all_gather"), "sharded": _jax_phase_keys("sharded")}
    for rec, call in zip(got, calls):
        phase = {k for k in rec if k.startswith("phase_")}
        if rec["method"] == "topk":
            tr = "sharded" if call["transport"] == "sharded" else "all_gather"
            assert phase == keys[tr], (tr, phase ^ keys[tr])
            assert rec["pallas_mode"] == "auto"
            assert all(rec[k] >= 0.0 and math.isfinite(rec[k]) for k in phase)
        else:
            assert not phase and "pallas_mode" not in rec


def test_phase_maps_match_jax():
    """The port's stage lists are ``tools/wire_profile.py``'s and its stage
    -> phase maps the JAX sweep's."""
    from tools import wire_profile as wp

    assert tphases.DISPATCH_STAGES == wp.DISPATCH_STAGES
    assert tphases.SHARDED_STAGES == wp.SHARDED_STAGES
    assert tphases.HIER_STAGES == wp.HIER_STAGES
    assert tphases.PHASE_OF == _jax_phase_maps()
    for tr, stages in (("all_gather", wp.DISPATCH_STAGES), ("sharded", wp.SHARDED_STAGES),
                       ("hierarchical", wp.HIER_STAGES)):
        assert list(tphases.PHASE_OF[tr]) == stages


def test_hierarchical_phase_chain_runs():
    """The hierarchical chain on one worker (one pod): every stage timed,
    the phase columns of the JAX breakdown's hierarchical map."""
    from tpu_compressed_dp_torch.parallel.dp import CompressionConfig
    from tpu_compressed_dp_torch.train.optim import SGD

    cfg = CompressionConfig(method="topk", mode="wire", transport="hierarchical")
    cols = tphases.phase_breakdown_cols(cfg, 4096, 41, SGD(lr=0.01),
                                        {"w": torch.zeros(64)}, 2, "cpu")
    want = {f"phase_{p}_ms" for p in tphases.PHASE_OF["hierarchical"].values()}
    assert set(cols) == want | {"phase_update_ms"}
    assert all(v >= 0.0 for v in cols.values())


def test_parser_surface_matches_jax():
    jflags = {a.dest: a.default for a in jsweep.build_parser()._actions if a.dest != "help"}
    tflags = {a.dest: a.default for a in tsweep.build_parser()._actions if a.dest != "help"}
    assert set(tflags) - set(jflags) == {"device"} and tflags["device"] == "cuda"
    assert {k: tflags[k] for k in jflags} == jflags


def test_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsweep.main(["--channels_scale", str(SCALE), "--steps", "1"])
