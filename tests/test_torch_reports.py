"""The port's offline readers (``harness/trace_report.py``,
``harness/control_report.py``, ``harness/ckpt_fsck.py``) against the JAX
package's tools (``tools/trace_report.py``, ``tools/control_report.py``,
``tools/ckpt_fsck.py``) on the CPU.

The inputs are written by tiny port runs (the dawn harness at 1/8 width,
2 epochs of 2 steps): ``--events``, ``--adaptive --events``,
``--checkpoint_dir`` and ``--stream_dir``.  On the same files:

  * both trace reports print the same text and JSON (``--control`` too) and
    write the same chrome traces, one stream or merged rank lanes;
  * both control reports print the same text and JSON, twin-priced from the
    same records with the run's topology or an overridden one;
  * both fscks print the same lines and exit with the same code, on clean
    checkpoint and stream directories, a checkpoint tree with the stream
    beside it, after a byte of a checkpoint file is flipped and a stream
    segment deleted (exit 1), with ``--list``, with ``--prune``, on a
    missing and an empty directory (exit 2).
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools import ckpt_fsck as jfsck  # noqa: E402
from tools import control_report as jcr  # noqa: E402
from tools import trace_report as jtr  # noqa: E402

from tpu_compressed_dp_torch.harness import ckpt_fsck as tfsck  # noqa: E402
from tpu_compressed_dp_torch.harness import control_report as tcr  # noqa: E402
from tpu_compressed_dp_torch.harness import trace_report as ttr  # noqa: E402

TINY = ["--device", "cpu", "--synthetic", "--synthetic_n", "64", "--batch_size", "32",
        "--epochs", "2", "--channels_scale", "0.125", "--log_dir", "", "--compress",
        "entiremodel", "--method", "topk", "--ratio", "0.01", "--error_feedback"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four port runs' files, with one intra-op thread."""
    from tpu_compressed_dp_torch.harness import dawn

    d = tmp_path_factory.mktemp("runs")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        dawn.main(TINY + ["--events", str(d / "ev.jsonl")])
        dawn.main(TINY + ["--adaptive", "--adaptive_window", "2", "--mode", "wire",
                          "--events", str(d / "ad.jsonl")])
        dawn.main(TINY + ["--checkpoint_dir", str(d / "ck"), "--ckpt_every", "1"])
        dawn.main(TINY + ["--stream_dir", str(d / "st"), "--stream_every", "1"])
    finally:
        torch.set_num_threads(n)
    recs = d / "records"
    recs.mkdir()
    for name in ("BENCH_r10.json", "BENCH_r11.json"):
        shutil.copy(os.path.join(REPO, name), recs / name)
    return d


def _both(capsys, jmain, tmain, argv_of):
    """Run the JAX tool, then the port's, on the argv ``argv_of(side)``
    gives; returns ((rc, stdout) JAX, (rc, stdout) port)."""
    out = []
    for side, main in (("j", jmain), ("t", tmain)):
        rc = main(argv_of(side))
        out.append((rc, capsys.readouterr().out))
    return out


# ---------------------------------------------------------------- trace_report

@pytest.mark.parametrize("stream,flags", [
    ("ev", []), ("ev", ["--json"]), ("ad", ["--control"]), ("ad", ["--json", "--control"]),
    ("ev", ["--chrome"]), ("ad", ["--control", "--chrome"])],
    ids=["text", "json", "control", "json-control", "chrome", "control-chrome"])
def test_trace_report_is_jax(runs, capsys, stream, flags):
    def argv(side):
        a = [str(runs / f"{stream}.jsonl")] + [f for f in flags if f != "--chrome"]
        return a + (["--chrome", str(runs / f"{side}-trace.json")] if "--chrome" in flags
                    else [])

    (jrc, jout), (trc, tout) = _both(capsys, jtr.main, ttr.main, argv)
    assert trc == jrc == 0
    assert tout == jout.replace(str(runs / "j-trace.json"), str(runs / "t-trace.json"))
    assert "per-phase step-time breakdown" in tout or '"phase_breakdown"' in tout
    if "--control" in flags:
        assert "rung trajectory" in tout or '"control"' in tout
    if "--chrome" in flags:
        t = json.load(open(runs / "t-trace.json"))
        assert t == json.load(open(runs / "j-trace.json")) and t["traceEvents"]


def test_trace_report_merge_is_jax(runs, capsys):
    def argv(side):
        return [str(runs / "ev.jsonl"), str(runs / "ad.jsonl"), "--merge", "--chrome",
                str(runs / f"{side}-merged.json")]

    (jrc, jout), (trc, tout) = _both(capsys, jtr.main, ttr.main, argv)
    assert trc == jrc == 0
    assert tout == jout.replace("j-merged", "t-merged")
    t = json.load(open(runs / "t-merged.json"))
    assert t == json.load(open(runs / "j-merged.json"))
    assert {e["pid"] for e in t["traceEvents"]} == {0, 1}


# -------------------------------------------------------------- control_report

@pytest.mark.parametrize("stream,flags", [
    ("ad", []), ("ad", ["--json"]), ("ev", []),
    ("ad", ["--twin_records", "REC"]),
    ("ad", ["--twin_records", "REC", "--json", "--twin_world", "8", "--twin_pods", "2",
            "--twin_transport", "hierarchical"])],
    ids=["text", "json", "no-decisions", "twin", "twin-json-topology"])
def test_control_report_is_jax(runs, capsys, stream, flags):
    argv = [str(runs / f"{stream}.jsonl")] + [str(runs / "records") if f == "REC" else f
                                              for f in flags]
    (jrc, jout), (trc, tout) = _both(capsys, jcr.main, tcr.main, lambda side: argv)
    assert trc == jrc == 0 and tout == jout
    if stream == "ad" and "--json" not in flags:
        assert "rung trajectory" in tout and "summary:" in tout
        assert "no control_decision records" not in tout
    if "--twin_records" in flags and "--json" not in flags:
        assert "twin ms" in tout and "calib_rows=" in tout


# ------------------------------------------------------------------- ckpt_fsck

def _fsck_both(capsys, argv_of):
    return _both(capsys, jfsck.main, tfsck.main, argv_of)


@pytest.mark.parametrize("target", ["ck", "st", "ck+st"])
@pytest.mark.parametrize("flags", [[], ["--list"]], ids=["verify", "list"])
def test_fsck_clean_is_jax(runs, capsys, tmp_path, target, flags):
    d = tmp_path / "t"
    if target == "ck+st":
        # a checkpoint tree with the stream beside it, in stream/
        shutil.copytree(runs / "ck", d)
        shutil.copytree(runs / "st", d / "stream")
    else:
        shutil.copytree(runs / target, d)
    (jrc, jout), (trc, tout) = _fsck_both(capsys, lambda side: [str(d)] + flags)
    assert trc == jrc == 0 and tout == jout
    if "ck" in target:
        assert "step 2:" in tout and "step 4:" in tout
    if "st" in target:
        assert "seg 0:" in tout and "seg 1:" in tout


def _corrupt(d):
    """Flip one byte of step 4's rank file and delete segment 1's payload."""
    path = d / "4" / "rank0.pt"
    b = bytearray(path.read_bytes())
    b[len(b) // 2] ^= 0xFF
    path.write_bytes(bytes(b))
    os.remove(d / "stream" / "seg-00000001.npz")


@pytest.mark.parametrize("flags", [[], ["--list"], ["--prune"], ["--prune", "--keep_windows",
                                                                 "1"]],
                         ids=["verify", "list", "prune", "prune-keep1"])
def test_fsck_corrupt_is_jax(runs, capsys, tmp_path, flags):
    for side in ("j", "t"):
        shutil.copytree(runs / "ck", tmp_path / side)
        shutil.copytree(runs / "st", tmp_path / side / "stream")
        _corrupt(tmp_path / side)
    (jrc, jout), (trc, tout) = _fsck_both(capsys, lambda side: [str(tmp_path / side)] + flags)
    assert trc == jrc and tout == jout.replace(str(tmp_path / "j"), str(tmp_path / "t"))
    if not flags:
        assert trc == 1
        assert "step 4: CORRUPT: digest mismatch: rank0.pt" in tout
        assert "stream: CORRUPT: segment 1: missing payload" in tout
    if "--prune" in flags:
        assert trc == 0 and "pruned step 4" in tout
        listing = {s: sorted(os.listdir(tmp_path / s)) for s in ("j", "t")}
        assert listing["t"] == listing["j"] and "4" not in listing["t"]
        # the pruned tree still fails only on the stream's missing payload
        (jrc, jout), (trc, tout) = _fsck_both(capsys, lambda side: [str(tmp_path / side)])
        assert trc == jrc and tout == jout.replace(str(tmp_path / "j"), str(tmp_path / "t"))


def test_fsck_missing_and_empty_are_jax(capsys, tmp_path):
    (tmp_path / "empty").mkdir()
    for name in ("nothere", "empty"):
        (jrc, jout), (trc, tout) = _fsck_both(capsys, lambda side: [str(tmp_path / name)])
        assert trc == jrc == 2 and tout == jout
