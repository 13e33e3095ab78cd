"""The delta stream through the port's entry points and its elastic
runtime, on the CPU.

  * **Warm readmission at W = 2 gloo ranks** (dawn, ResNet-9 at
    channels_scale 0.125, entire-model Top-K + EF, ``--stream_dir`` on both
    ranks): rank 1 runs under ``harness/watchdog.py --relaunch`` and is
    SIGKILLed after its second epoch; rank 0 remeshes to W = 1
    (``--elastic_min_world 1``); the relaunched rank, with
    ``--stream_rejoin``, advertises the stream in its join record, rank 0
    (the writer) flushes the stream and commits a warm epoch, the broadcast
    skips the parameters and the joiner adopts them from the stream: its
    parameters are bitwise the survivor's at the readmission,
    ``epoch.json`` says ``warm: true`` and the joiner's
    ``stream/rejoin_bytes`` is above 0.  Both ranks then finish at W = 2.
    With rank 0, the writer, killed instead, the readmission is cold and
    the joiner takes the parameters from the broadcast.
  * **The harness streams hold the live parameters**: at a window close
    the reconstruction is bitwise the model the harness last appended
    (dawn, ImageNet, the LM); the heartbeat carries ``stream_lag_s`` and
    the Prometheus file the ``stream/*`` gauges.
  * **The LM's model axes**: ``--stream_dir`` with ``--tp`` or ``--pp``
    above 1 raises, naming the ROADMAP entry.
  * **The loop helpers**: ``make_stream`` on rank 0 only, the join probe
    and a cold commit's skipped catch-up, as the JAX package's.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_compressed_dp_torch.harness import loop
from tpu_compressed_dp_torch.stream import StreamReader, StreamWriter, store
from tpu_compressed_dp_torch.stream import delta as td

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = "0.125"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's in-process runs (the tier-1
    run's parallel workers would otherwise oversubscribe the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*a, **k):
    pass


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


# ------------------------------------------------------- warm readmission

# One dawn rank: argv out <dawn argv>; records the parameters' digest at the
# readmission (survivor) or the join (joiner) and the runtime's metrics.
# Under KILL_AT_STEP it SIGKILLs itself as that step starts, once.
_DAWN = r"""
import hashlib, json, os, signal, sys, time
import torch
torch.set_num_threads(1)
from tpu_compressed_dp_torch.harness import dawn
from tpu_compressed_dp_torch.train import elastic

out, argv = sys.argv[1], sys.argv[2:]
rank = int(argv[argv.index("--process_id") + 1])
rec = {}


def digest(state):
    h = hashlib.sha256()
    for p in state.model.parameters():
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


rb, jw, hf, pl = (elastic.ElasticRuntime.rejoin_barrier, elastic.ElasticRuntime.join_world,
                  elastic.ElasticRuntime.handle_failure, elastic.ElasticRuntime.poll)
kill_at, killed = int(os.environ.get("KILL_AT_STEP", -1)), f"{out}/killed"


def poll(self, step=None):
    if step == kill_at and not os.path.exists(killed):
        open(killed, "w").close()
        os.kill(os.getpid(), signal.SIGKILL)
    return pl(self, step)


def handle_failure(self, state, failure):
    state = hf(self, state, failure)
    rec["remesh"] = {"ranks": list(self.ranks)}
    return state


def rejoin_barrier(self, state):
    if "remesh" in rec and "readmit" not in rec:
        deadline = time.time() + 120
        while not set(self.rendezvous.pending_joins()) - set(self.ranks):
            assert time.time() < deadline, "the relaunched rank never asked to join"
            time.sleep(0.05)
    state, grew = rb(self, state)
    if grew:
        rec["readmit"] = {"ranks": list(self.ranks), "params": digest(state)}
    return state, grew


def join_world(self, state, decision, **kw):
    state = jw(self, state, decision, **kw)
    rec["joined"] = {"ranks": list(self.ranks), "params": digest(state),
                     "warm": bool(decision.warm), "metrics": self.metrics(),
                     "adopted": kw.get("adopted_info")}
    return state


elastic.ElasticRuntime.handle_failure = handle_failure
elastic.ElasticRuntime.poll = poll
elastic.ElasticRuntime.rejoin_barrier = rejoin_barrier
elastic.ElasticRuntime.join_world = join_world
rec["summary"] = dawn.main(argv)
with open(f"{out}/dawn_rank{rank}.json", "w") as f:
    json.dump(rec, f, default=str)
"""


def _finish(procs, timeout):
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], logs


def _w2_readmission(tmp_path, victim):
    """Ranks 0 and 1 of a W = 2 dawn world with ``--stream_dir``; ``victim``
    runs under ``harness/watchdog.py --relaunch`` with ``--stream_rejoin``,
    SIGKILLs itself as step 6 starts, in its second epoch (4 steps an
    epoch; rank 0 has appended at the first one's end), and is relaunched.  Returns the ranks' rcs and logs, their
    records and the last ``epoch.json``."""
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    out, port = str(tmp_path), free_port()
    hb, edir, sd = f"{out}/hb.json", f"{out}/el", f"{out}/stream"
    argv = ["--synthetic", "--synthetic_n", "96", "--batch_size", "24", "--epochs", "5",
            "--compress", "entiremodel", "--method", "topk", "--ratio", "0.05",
            "--error_feedback", "--momentum", "0.9", "--device", "cpu", "--channels_scale",
            SCALE, "--log_dir", "", "--elastic", "--elastic_dir", edir, "--peer_timeout", "8",
            "--elastic_min_world", "1", "--heartbeat", hb, "--heartbeat_interval", "0.5",
            "--stream_dir", sd, "--stream_keyframe_every", "3", "--coordinator",
            f"127.0.0.1:{port}", "--num_processes", "2"]
    cmd = [sys.executable, "-c", _DAWN, out]
    procs = []
    for r in (0, 1):
        if r == victim:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpu_compressed_dp_torch.harness.watchdog",
                 "--relaunch", "--heartbeat", f"{hb}.rank{r}", "--elastic_dir", edir,
                 "--interval", "0.2", "--grace", "30", "--max_age", "20", "--backoff", "0.2",
                 "--max_relaunches", "3", "--", *cmd, *argv, "--process_id", str(r),
                 "--stream_rejoin"], env=dict(_env(), KILL_AT_STEP="6"), cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        else:
            procs.append(subprocess.Popen(cmd + argv + ["--process_id", str(r)], env=_env(),
                                          cwd=REPO, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    rcs, logs = _finish(procs, timeout=180)
    assert rcs == [0, 0], [lg[-3000:] for lg in logs]
    recs = {r: json.load(open(f"{out}/dawn_rank{r}.json")) for r in (0, 1)}
    with open(f"{edir}/epoch.json") as f:
        epoch = json.load(f)
    assert os.path.exists(f"{out}/killed")
    for r in (0, 1):
        assert recs[r]["summary"]["epoch"] == 5 and recs[r]["summary"]["world"] == 2
    assert store.verify_stream(sd)[0] == []
    return logs, recs, epoch


def test_warm_readmission_w2(tmp_path):
    logs, recs, epoch = _w2_readmission(tmp_path, victim=1)
    assert epoch["ranks"] == [0, 1] and epoch["warm"] is True, epoch
    assert recs[0]["remesh"]["ranks"] == [0] and recs[0]["readmit"]["ranks"] == [0, 1]
    j = recs[1]["joined"]
    assert j["warm"] and j["ranks"] == [0, 1] and j["adopted"]["exact"]
    assert j["params"] == recs[0]["readmit"]["params"]
    assert j["metrics"]["stream/rejoin_bytes"] > 0
    assert j["metrics"]["stream/rejoin_bytes"] == j["adopted"]["bytes"]
    assert "warm rejoin: adopted" in logs[1]


def test_readmission_is_cold_when_the_writer_died(tmp_path):
    """Rank 0, the stream's only writer, is the one killed: no survivor can
    flush the stream to the live parameters, so the relaunched rank's
    readmission commits cold and it takes the parameters from rank 1's
    broadcast, bitwise, though its join record carried ``stream``."""
    logs, recs, epoch = _w2_readmission(tmp_path, victim=0)
    assert epoch["ranks"] == [0, 1] and epoch["warm"] is False, epoch
    assert recs[1]["remesh"]["ranks"] == [1] and recs[1]["readmit"]["ranks"] == [0, 1]
    j = recs[0]["joined"]
    assert not j["warm"] and j["ranks"] == [0, 1] and j["adopted"] is None
    assert j["params"] == recs[1]["readmit"]["params"]
    assert j["metrics"]["stream/rejoin_bytes"] == 0
    assert "committed a cold admission" in logs[0]


# ------------------------------------------ the harness streams hold params

@pytest.fixture
def appended(monkeypatch):
    """The flat vector of every append a harness makes, as it was then."""
    seen = []
    enc = StreamWriter._encode

    def _encode(self, params, **kw):
        seen.append(td.flatten_params(params)[0].clone())
        return enc(self, params, **kw)

    monkeypatch.setattr(StreamWriter, "_encode", _encode)
    return seen


def _check_head_exact(sd, want):
    reader = StreamReader(sd, log=_quiet)
    reader.catch_up()
    assert reader.exact and store.verify_stream(sd)[0] == []
    assert np.array_equal(reader._vec.view(np.int32), want.numpy().view(np.int32))


def test_dawn_stream_holds_the_live_params(tmp_path, appended):
    from tpu_compressed_dp_torch.harness import dawn

    sd, hb, prom = str(tmp_path / "s"), str(tmp_path / "hb.json"), str(tmp_path / "m.prom")
    dawn.main(["--device", "cpu", "--synthetic", "--synthetic_n", "64", "--batch_size", "32",
               "--epochs", "4", "--channels_scale", SCALE, "--compress", "entiremodel",
               "--method", "topk", "--ratio", "0.05", "--error_feedback", "--log_dir", "",
               "--stream_dir", sd, "--stream_keyframe_every", "4", "--heartbeat", hb,
               "--prom", prom])
    assert len(appended) == 4
    _check_head_exact(sd, appended[-1])
    rec = json.load(open(hb))
    # the last epoch's commit may land after its heartbeat: the newest
    # committed segment is that epoch's or the one before
    assert rec["stream_last_step"] in (6, 8) and rec["stream_lag_s"] >= 0.0
    text = open(prom).read()
    assert "stream_segments" in text and "stream_append_ms" in text


def test_imagenet_stream_holds_the_live_params(tmp_path, appended):
    from tpu_compressed_dp_torch.harness import imagenet

    sd = str(tmp_path / "s")
    imagenet.main(["--synthetic", "--arch", "resnet18", "--width", "8", "--num_classes", "8",
                   "--compress", "layerwise", "--method", "topk", "--error_feedback",
                   "--device", "cpu", "--synthetic_n", "64", "--phases",
                   '[{"ep": 0, "sz": 64, "bs": 32}, {"ep": [0, 2], "lr": [0.1, 0.2]}]',
                   "--stream_dir", sd, "--stream_keyframe_every", "2"])
    assert len(appended) == 2
    _check_head_exact(sd, appended[-1])


def test_lm_stream_holds_the_live_params(tmp_path, appended):
    from tpu_compressed_dp_torch.harness import lm

    sd = str(tmp_path / "s")
    lm.main(["--device", "cpu", "--preset", "tiny", "--steps", "6", "--log_every", "3",
             "--seq_len", "32", "--global_batch", "2", "--fp32", "--compress", "entiremodel",
             "--method", "topk", "--ratio", "0.05", "--error_feedback", "--stream_dir", sd,
             "--stream_keyframe_every", "3"])
    assert len(appended) == 6
    _check_head_exact(sd, appended[-1])


@pytest.mark.parametrize("axis", ["--tp", "--pp"])
def test_lm_stream_refuses_the_model_axes(axis, tmp_path):
    from tpu_compressed_dp_torch.harness import lm

    with pytest.raises(NotImplementedError, match="item 14 \\(the stream over the model axes"):
        lm.main(["--device", "cpu", "--preset", "tiny", "--steps", "1", axis, "2",
                 "--stream_dir", str(tmp_path / "s")])


# ------------------------------------------------------------ loop helpers

def _args(extra=()):
    p = argparse.ArgumentParser()
    loop.add_stream_args(p, cadence_help="test cadence")
    return p.parse_args(list(extra))


def test_stream_args_and_make_stream(tmp_path):
    a = _args()
    assert (a.stream_dir, a.stream_every, a.stream_keyframe_every, a.stream_ratio,
            a.stream_rejoin) == (None, 1, 8, 0.01, False)
    assert loop.make_stream(a) is None
    w = loop.make_stream(_args(["--stream_dir", str(tmp_path / "s"), "--stream_ratio", "0.2",
                                "--stream_keyframe_every", "3"]), log=_quiet)
    assert isinstance(w, StreamWriter) and (w.ratio, w.keyframe_every) == (0.2, 3)
    w.close()


def test_stream_join_probe_and_cold_commit(tmp_path):
    from tpu_compressed_dp_torch.train.rendezvous import EpochDecision

    sd = str(tmp_path / "s")
    w = StreamWriter(sd, ratio=0.05, keyframe_every=4, log=_quiet)
    w.sync({"w": torch.arange(8, dtype=torch.float32)}, step=1)
    w.close()
    assert loop.stream_join_seq(_args(["--stream_dir", sd])) is None
    a = _args(["--stream_dir", sd, "--stream_rejoin"])
    assert loop.stream_join_seq(a) == 0
    cold = EpochDecision(epoch=1, ranks=(0, 1), coordinator=0, address="h:1", process_id=1,
                         warm=False)
    assert loop.stream_rejoin_params(a, None, cold, log=_quiet) == (None, None)
    path = store.segment_payload_path(sd, 0)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(os.path.getsize(path) // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    assert loop.stream_join_seq(a) is None       # an unusable stream joins cold
