"""The port's convergence-grid and time-to-accuracy tools
(``harness/convergence_sweep.py``, ``harness/time_to_accuracy.py``) against
the JAX package's tools (``tools/convergence_sweep.py``,
``tools/time_to_accuracy.py``) on the CPU.

  * the grid and the TSV columns are JAX's, label for label and argument
    for argument; every label's dawn argv is the JAX tool's, followed by
    ``--device``, plain and under ``--quick``;
  * with both packages' ``dawn.main`` stubbed to return one summary, the two
    convergence TSVs are byte-equal but for the ``total_s`` column;
  * every point, with the tool's argv plus the harness's small-size
    flags, runs through the port's dawn harness at 1/8 width, and the
    tool's row of its summary is a well-formed TSV row;
  * over a planted convergence TSV and a measure cache keyed as JAX keys it
    (so neither side measures), with the port's link table set to JAX's, the
    headline and sensitivity TSVs are byte-equal to JAX's;
  * ``effective_sent_frac`` equals JAX's over a warm-up grid, exactly;
  * a run with the defaults writes only under ``build/``.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools import convergence_sweep as jcs  # noqa: E402
from tools import time_to_accuracy as jtta  # noqa: E402
from tpu_compressed_dp.harness import dawn as jdawn  # noqa: E402

from tpu_compressed_dp_torch.harness import convergence_sweep as tcs  # noqa: E402
from tpu_compressed_dp_torch.harness import dawn as tdawn  # noqa: E402
from tpu_compressed_dp_torch.harness import time_to_accuracy as ttta  # noqa: E402

SUMMARY = {"epoch": 3, "train acc": 0.912345678, "test acc": 0.87654321,
           "train loss": 0.3141592, "test loss": 0.4142135, "sent frac": 0.0100004,
           "wire frac": 0.0200016, "lr": 0.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the tier-1 run's parallel workers a thread
    per core in every worker oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stub(monkeypatch, module, calls, summary=SUMMARY):
    def main(argv):
        calls.append(list(argv))
        return dict(summary)
    monkeypatch.setattr(module, "main", main)


# ------------------------------------------------------------------ the grid

def test_grid_and_columns_are_jax():
    assert tcs.GRID == jcs.GRID
    assert tcs.COLS == jcs.COLS
    assert len({label for label, _ in tcs.GRID}) == len(tcs.GRID)


@pytest.mark.parametrize("quick", [False, True], ids=["plain", "quick"])
def test_point_argv_is_jax(quick, monkeypatch, tmp_path):
    jcalls, tcalls = [], []
    _stub(monkeypatch, jdawn, jcalls)
    _stub(monkeypatch, tdawn, tcalls)
    flags = ["--synthetic_n", "2048"] + (["--quick"] if quick else [])
    jcs.main(["--out", str(tmp_path / "j.tsv")] + flags)
    tcs.main(["--out", str(tmp_path / "t.tsv"), "--device", "cpu"] + flags)
    assert len(jcalls) == len(jcs.GRID) == len(tcalls)
    for (label, extra), j, t in zip(jcs.GRID, jcalls, tcalls):
        assert t == j + ["--device", "cpu"], label
        assert tcs.point_argv(extra, synthetic_n=2048, quick=quick, device="cuda") == (
            j + ["--device", "cuda"]), label


@pytest.mark.parametrize("only", [None, "dense,topk-em-1%-wire,terngrad-em,powersgd-em-r4"],
                         ids=["all", "only"])
def test_tsv_byte_equal_but_total_s(only, monkeypatch, tmp_path):
    _stub(monkeypatch, jdawn, [])
    _stub(monkeypatch, tdawn, [])
    flags = ["--quick"] + (["--only", only] if only else [])
    jcs.main(["--out", str(tmp_path / "j.tsv")] + flags)
    rows = tcs.main(["--out", str(tmp_path / "t.tsv"), "--device", "cpu"] + flags)
    j = (tmp_path / "j.tsv").read_text().splitlines()
    t = (tmp_path / "t.tsv").read_text().splitlines()
    assert len(t) == len(j) == 1 + (len(jcs.GRID) if only is None else 4) == 1 + len(rows)
    cut = jcs.COLS.index("total_s")
    assert t[0] == j[0]
    for a, b in zip(t[1:], j[1:]):
        a, b = a.split("\t"), b.split("\t")
        assert a[:cut] + a[cut + 1:] == b[:cut] + b[cut + 1:]
        assert float(a[cut]) >= 0.0


@pytest.mark.parametrize("label", [label for label, _ in tcs.GRID])
def test_point_runs_through_the_port(label, tmp_path):
    """Every grid point: the tool's argv plus the harness's small-size
    flags through the port's dawn harness at 1/8 width (one epoch of 2
    steps), and the tool's row of its summary, written as a TSV."""
    extra = dict(tcs.GRID)[label]
    argv = tcs.point_argv(extra, synthetic_n=64, quick=True, device="cpu") + [
        "--batch_size", "32", "--epochs", "1", "--channels_scale", "0.125"]
    row = tcs.point_row(label, extra, tdawn.main(argv), 0.25)
    path = tmp_path / "conv.tsv"
    tcs.write_tsv(str(path), [row])
    lines = path.read_text().splitlines()
    assert lines[0].split("\t") == tcs.COLS and len(lines) == 2
    row = dict(zip(tcs.COLS, lines[1].split("\t")))
    assert (row["label"], row["epochs"]) == (label, "1")
    assert (row["method"], row["ratio"], row["mode"]) == (
        jtta.arg_val(extra, "--method", "none"), jtta.arg_val(extra, "--ratio", ""),
        jtta.arg_val(extra, "--mode", "simulate"))
    for k in ("train_acc", "test_acc"):
        assert 0.0 <= float(row[k]) <= 1.0
    for k in ("train_loss", "test_loss"):
        assert np.isfinite(float(row[k]))
    # a (value, index) pair bills 64 bits: the wire fraction passes 1 where
    # more than half the coordinates go (Threshold-V, a warm-up's first epoch)
    assert 0.0 < float(row["sent_frac"]) <= 1.0 and 0.0 < float(row["wire_frac"]) <= 2.0
    if label == "topk-em-1%":
        # entire-model Top-K 1 % sends 1 % of the coordinates
        assert 0.0099 <= float(row["sent_frac"]) <= 0.0101


# ------------------------------------------------------------ the projection

CONV = [
    # label, epochs, test acc (a planted grid: rows of every payload shape)
    ("dense-step", 24, 0.9612),
    ("topk-em-1%-wire-EF-step", 24, 0.9588),
    ("randomk-em-1%-wire-EF-mom9", 60, 0.9539),
    ("randomk-em-10%-wire-EF-mom9", 24, 0.9526),
    ("topk-lw-1%", 24, 0.9602),
    ("terngrad-em", 24, 0.9431),
    ("qsgd-lw-8bit", 24, 0.9590),
    ("randomk-em-0.1%-wire-EF-mom9-120ep", 120, 0.9604),
    ("not-a-grid-label", 24, 0.5),
]


def _record(label: str) -> dict:
    """A planted ``run_point`` record for the label's config."""
    extra = dict(jcs.GRID)[label]
    method = jtta.arg_val(extra, "--method")
    ratio = float(jtta.arg_val(extra, "--ratio", 0.01))
    wire = jtta.arg_val(extra, "--mode") == "wire"
    dense_mb = 26.29248
    rec = {"model": "resnet9", "method": method or "none", "step_ms": 56.97 + 3.1 * len(label),
           "dense_mb_per_step": dense_mb}
    if method is None:
        return rec    # dense rows carry no comm columns
    if method in ("terngrad", "qsgd"):
        mb = dense_mb / (16 if method == "terngrad" else 4)
        rec.update(payload_mb_per_step=mb, transport="psum", num_collectives=
                   1.0 if "-em" in label else 62.0)
        if method == "qsgd":
            rec["payload_mb_psum"] = mb     # the per-bucket split
        return rec
    mb = dense_mb * ratio * (2 if wire else 1)
    if wire and method == "topk":
        # a legacy record: the all_gather payload without the split
        rec.update(payload_mb_per_step=mb, transport="all_gather", num_collectives=2.0)
    elif wire:
        rec.update(payload_mb_per_step=mb, payload_mb_psum=0.0, payload_mb_allgather=mb,
                   payload_mb_alltoall=0.0, transport="all_gather", num_collectives=2.0)
    else:
        rec.update(payload_mb_per_step=mb, payload_mb_psum=mb, payload_mb_allgather=0.0,
                   transport="psum", num_collectives=62.0 if "-lw" in label else 0.0)
    return rec


def _plant(d, steps=30, warmup=3) -> tuple:
    conv = d / "conv.tsv"
    with open(conv, "w") as f:
        f.write("# a planted convergence grid\n" + "\t".join(jcs.COLS) + "\n")
        for label, epochs, acc in CONV:
            extra = dict(jcs.GRID).get(label, [])
            row = dict(label=label, method=jtta.arg_val(extra, "--method", "none"),
                       ratio=jtta.arg_val(extra, "--ratio", ""),
                       mode="wire" if "--mode" in extra else "simulate", epochs=epochs,
                       train_acc=0.99, test_acc=acc, train_loss=0.01, test_loss=0.2,
                       sent_frac=0.01, wire_frac=0.02, total_s=100.0)
            f.write("\t".join(str(row[c]) for c in jcs.COLS) + "\n")
    cache = {}
    for label, _, _ in CONV[:-1]:
        extra = dict(jcs.GRID)[label]
        # keyed as the JAX tool keys it: a hit on both sides, so nothing is
        # measured
        key = (f"{label}@steps={steps},warmup={warmup},args="
               + hashlib.md5(json.dumps(list(extra)).encode()).hexdigest()[:10])
        cache[key] = _record(label)
        assert jtta.measure_row(label, extra, cache, steps, warmup) == (cache[key], True)
        assert ttta.measure_row(label, extra, cache, steps, warmup) == (cache[key], True)
    path = d / "cache.json"
    path.write_text(json.dumps(cache))
    return str(conv), str(path)


@pytest.mark.parametrize("target", [0.95, 0.96])
def test_projection_tsvs_byte_equal_jax(target, monkeypatch, tmp_path, capsys):
    conv, cache = _plant(tmp_path)
    monkeypatch.setattr(ttta, "BANDWIDTHS", list(jtta.BANDWIDTHS))
    common = ["--convergence", conv, "--target", str(target), "--measure_cache", cache]
    cached = open(cache).read()
    jtta.main(common + ["--out", str(tmp_path / "j.tsv"),
                        "--sensitivity_out", str(tmp_path / "js.tsv")])
    j_out = capsys.readouterr().out
    assert ttta.main(common + ["--out", str(tmp_path / "t.tsv"),
                               "--sensitivity_out", str(tmp_path / "ts.tsv"),
                               "--device", "cpu"]) == 0
    t_out = capsys.readouterr().out
    j, t = (tmp_path / "j.tsv").read_bytes(), (tmp_path / "t.tsv").read_bytes()
    assert t == j
    assert (tmp_path / "ts.tsv").read_bytes() == (tmp_path / "js.tsv").read_bytes()
    assert t_out == j_out
    body = [ln for ln in t.decode().splitlines() if not ln.startswith("#")]
    assert len(body) == len(CONV)   # the header and every row in the grid
    # every row hit the cache on both sides: neither rewrote it
    assert open(cache).read() == cached


def test_link_table_names_the_h100_classes():
    assert ttta.WORLDS == jtta.WORLDS == [8, 32]
    assert ttta.STEPS_PER_EPOCH_DEFAULT == jtta.STEPS_PER_EPOCH_DEFAULT
    assert ttta.BANDWIDTHS == [("nvlink4_450GBps", 450e9), ("nic_25Gbps", 25e9 / 8)]
    # the NIC class is the reference's own 25 Gbit/s
    assert ttta.BANDWIDTHS[1][1] == jtta.BANDWIDTHS[1][1]


def test_effective_sent_frac_is_jax():
    for ratio in (0.001, 0.002, 0.003, 0.01, 0.03, 0.05, 0.1, 1.0):
        for warmup in (0, 1, 2, 5, 8, 16, 24, 32):
            for epochs in (24, 40, 60, 90, 120):
                got = ttta.effective_sent_frac(ratio, warmup, epochs)
                want = jtta.effective_sent_frac(ratio, warmup, epochs)
                assert got == want, (ratio, warmup, epochs, got, want)
    assert ttta.grid_args("topk-em-1%") == jtta.grid_args("topk-em-1%")
    assert ttta.grid_args("nope") is None and jtta.grid_args("nope") is None


def test_defaults_write_only_under_build(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    _stub(monkeypatch, tdawn, [])
    tcs.main(["--only", "dense-step,topk-em-1%-wire-EF-step", "--quick", "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == ["build"]
    assert os.listdir(tmp_path / "build") == ["convergence_r2.tsv"]
    # the projection's defaults read the sweep's default output and a cache
    # beside it; nothing is measured (every key hits)
    conv, cache = _plant(tmp_path / "build")
    os.replace(cache, tmp_path / "build" / ".tta_measure_cache.json")
    os.replace(conv, tmp_path / "build" / "convergence_r2.tsv")
    monkeypatch.setattr("tpu_compressed_dp_torch.bench.sweep.run_point",
                        lambda **kw: pytest.fail(f"measured {kw}"))
    assert ttta.main(["--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["build"]
    assert sorted(os.listdir(tmp_path / "build")) == [
        ".tta_measure_cache.json", "convergence_r2.tsv", "time_to_accuracy_r4.tsv"]
    from tpu_compressed_dp_torch.harness import validate_transport as tvt
    for path in (tcs.DEFAULT_OUT, ttta.DEFAULT_OUT, ttta.DEFAULT_CACHE, tvt.DEFAULT_OUT):
        assert path.startswith("build/"), path
