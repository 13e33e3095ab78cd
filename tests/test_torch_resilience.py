"""The port's failure detection and recovery (``utils/resilience.py``).

  * ``check_heartbeat`` reports the JAX package's problems, word for word,
    on the same records; ``read_heartbeat`` / ``is_stale`` likewise.
  * ``Heartbeat`` writes its record atomically, with the incarnation from
    ``TCDP_RESTART_COUNT``.
  * ``spawn_supervised`` composes the JAX function's child environment
    (captured through an injected ``popen``); its elastic-rejoin half raises
    naming the elastic item.
  * ``PreemptionHandler`` turns a real SIGTERM into ``Preempted`` at the
    next check and restores the previous handler.
  * ``run_with_recovery``: a chaos crash at step 3 of 6 restores the newest
    checkpoint and replays to the state of the uncrashed run, bitwise; a
    crash before any checkpoint re-raises the crash; ``Preempted`` passes
    through; the chaos drill's port rows at W = 2 (crash recovery with each
    rank's injector firing at one global step).
  * Preemption of a real process: the LM harness (tiny config, float32,
    Top-K + EF, the guard armed) sends itself SIGTERM at step 3
    (``--chaos crash=preempt,crash_at_step=3``), saves, exits 75, and its
    ``--resume`` finishes at the uninterrupted run's final checkpoint (step
    4), every tensor bitwise.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpu_compressed_dp.utils import resilience as jres

from tpu_compressed_dp_torch.models import common as tcommon
from tpu_compressed_dp_torch.models import resnet9 as tres
from tpu_compressed_dp_torch.parallel import dp as tdp
from tpu_compressed_dp_torch.train import guard as tguard
from tpu_compressed_dp_torch.train import optim as toptim
from tpu_compressed_dp_torch.train import step as tstep
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.utils import chaos as tchaos
from tpu_compressed_dp_torch.utils import checkpoint as tckpt
from tpu_compressed_dp_torch.utils import resilience as tres_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 1_000_000.0
RECORDS = [
    None,
    {"ts": NOW - 1.0, "step": 10},
    {"ts": NOW - 120.0, "step": 10},
    {"ts": NOW - 1.0, "step": 100, "last_good_step": 40},
    {"ts": NOW - 1.0, "step": 100, "last_good_step": 95},
    {"ts": NOW - 5.0, "step": 7, "telemetry": {"steps_per_sec": 0.01, "step_p95_ms": 900.0}},
    {"ts": NOW - 30.0, "ckpt_age_s": 200.0, "last_ckpt_step": 3},
    {"ts": NOW - 2.0, "stream_lag_s": 50.0, "stream_last_step": 9},
    {"ts": NOW - 2.0, "straggler_skew_s": 3.5, "straggler_rank": 2},
    {"ts": NOW - 2.0, "telemetry": {"straggler_skew_s": 0.1}},
    {"ts": NOW - 200.0, "step": 50, "last_good_step": 1,
     "telemetry": {"steps_per_sec": 0.001, "step_p95_ms": 5000.0},
     "ckpt_age_s": 1000.0, "stream_lag_s": 1000.0, "straggler_skew_s": 9.0},
]
LIMITS = dict(max_age_s=60.0, max_wedge_steps=25, min_steps_per_sec=0.5,
              max_step_p95_ms=500.0, max_ckpt_age_s=120.0, max_stream_lag_s=30.0,
              max_straggler_skew_s=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small in-process steps: under
    the tier-1 run's parallel workers, a thread per core in every worker
    oversubscribes the machine, and small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_check_heartbeat_matches_jax(tmp_path, i):
    path = str(tmp_path / "hb.json")
    if RECORDS[i] is not None:
        with open(path, "w") as f:
            json.dump(RECORDS[i], f)
    for limits in (LIMITS, {}):
        want = jres.check_heartbeat(path, now=NOW, **limits)
        assert tres_mod.check_heartbeat(path, now=NOW, **limits) == want
    assert tres_mod.read_heartbeat(path) == jres.read_heartbeat(path)
    assert tres_mod.is_stale(path, 30.0) == jres.is_stale(path, 30.0)


def test_heartbeat_file(tmp_path, monkeypatch):
    monkeypatch.setenv("TCDP_RESTART_COUNT", "3")
    path = str(tmp_path / "hb.json")
    with open(path, "w") as f:
        f.write('{"ts": "x"')            # a torn record reads as none
    assert tres_mod.read_heartbeat(path) is None and tres_mod.is_stale(path, 1e9)
    hb = tres_mod.Heartbeat(path, interval_s=0.05, payload={"rank": 0})
    hb.update(step=12, last_good_step=11)
    time.sleep(0.2)
    rec = tres_mod.read_heartbeat(path)
    hb.stop()
    assert rec["incarnation"] == 3 and rec["step"] == 12 and rec["last_good_step"] == 11
    assert hb.last_error is None and not tres_mod.is_stale(path, 60.0)
    assert tres_mod.check_heartbeat(path, max_wedge_steps=0) == jres.check_heartbeat(
        path, max_wedge_steps=0)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_spawn_supervised_env_matches_jax(tmp_path):
    seen = []

    def popen(cmd, env):
        seen.append((cmd, env))
        return len(seen)

    base = {"PATH": "/bin", "TCDP_RESTART_COUNT": "0", "MINE": "keep"}
    kw = dict(restart_count=4, env=base, extra_env={"TCDP_JOB_ID": "j7", "N": 2}, popen=popen)
    assert tres_mod.spawn_supervised(["python", "-m", "x"], **kw) == 1
    jres.spawn_supervised(["python", "-m", "x"], **kw)
    assert seen[0] == seen[1]
    assert seen[0][1]["TCDP_RESTART_COUNT"] == "4" and seen[0][1]["MINE"] == "keep"
    assert base["TCDP_RESTART_COUNT"] == "0"
    # the elastic rejoin hint: the directory, and the committed epoch where
    # the directory holds one, as the JAX supervisor exports them
    d = str(tmp_path)
    for rec in (None, {"epoch": 3, "ranks": [0, 2], "address": "h:5"}):
        if rec is not None:
            with open(os.path.join(d, "epoch.json"), "w") as f:
                json.dump(rec, f)
        seen.clear()
        for mod in (tres_mod, jres):
            mod.spawn_supervised(["x"], restart_count=1, elastic_dir=d, env=base, popen=popen,
                                 log=lambda s: None)
        assert seen[0] == seen[1] and seen[0][1]["TCDP_ELASTIC_DIR"] == d
        assert seen[0][1].get("TCDP_RENDEZVOUS_EPOCH") == (None if rec is None else "3")


def test_preemption_handler_real_sigterm():
    before = signal.getsignal(signal.SIGTERM)
    handler = tres_mod.PreemptionHandler(log=lambda s: None).install()
    assert handler.installed
    try:
        handler.check(0)
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(1000):
            if handler.triggered:
                break
            time.sleep(0.001)
        with pytest.raises(tres_mod.Preempted) as err:
            handler.check(5)
        assert err.value.step == 5 and err.value.signum == signal.SIGTERM
    finally:
        handler.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before
    assert tres_mod.PREEMPT_EXIT == jres.PREEMPT_EXIT == 75


# ------------------------------------------------------- run_with_recovery

def _setup():
    model = tres.ResNet9(channels=tres.scaled_channels(0.125), seed=0)
    leaves = tres.param_leaves(model)
    cfg = tdp.CompressionConfig(method="topk", ratio=0.05, error_feedback=True)
    opt = toptim.SGD(lr=0.05, momentum=0.9, nesterov=True)
    gcfg = tguard.GuardConfig(loss_scaling=False)
    state = TrainState.create(model, opt.init(leaves), tdp.init_ef_state(leaves, cfg), seed=2,
                              guard=tguard.init_guard_state(gcfg))
    step = tstep.make_train_step(tcommon.make_normalizing_apply_fn([120.0] * 3, [60.0] * 3),
                                 opt, cfg, grad_scale=8.0, guard_cfg=gcfg,
                                 chaos=tchaos.ChaosConfig(kind="nan", steps=(2,)))
    return state, step


def _batches(n=2):
    rng = np.random.default_rng(1)
    return [{"input": torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)),
             "target": torch.from_numpy(rng.integers(0, 10, 8))} for _ in range(n)]


def _run(crash, ckpt_dir, epochs=3):
    state, step = _setup()
    batches = _batches()
    ckpt = tckpt.Checkpointer(ckpt_dir) if ckpt_dir else None

    def epoch_fn(state, epoch):
        for i, b in enumerate(batches):
            if crash is not None:
                crash.check(epoch * len(batches) + i)
            state, _ = step(state, b)
        if ckpt is not None:
            ckpt.save_async(state, {"epoch": epoch})
        return state

    final, info = tres_mod.run_with_recovery(epoch_fn, state, epochs, checkpointer=ckpt)
    if ckpt is not None:
        ckpt.close()
    return final, info


def _tensors(state):
    return [t.detach().clone() for t in [*state.model.state_dict().values(),
                                         *state.opt_state["momentum"].values(),
                                         *state.ef.values()]]


def test_run_with_recovery_bitwise(tmp_path):
    clean, info = _run(None, None)
    assert info == {"failures": 0, "restores": 0}
    crashed, info = _run(tchaos.CrashInjector(3), str(tmp_path / "ck"))
    assert info == {"failures": 0, "restores": 1}
    assert crashed.step == clean.step == 6
    assert all(torch.equal(a, b) for a, b in zip(_tensors(clean), _tensors(crashed)))
    assert crashed.guard == clean.guard and int(clean.guard.total_skipped) == 1
    # a crash before the first checkpoint re-raises the crash itself
    with pytest.raises(tchaos.ChaosCrash):
        _run(tchaos.CrashInjector(1), str(tmp_path / "ck2"))

    def preempted(state, epoch):
        raise tres_mod.Preempted("stop", step=0)

    with pytest.raises(tres_mod.Preempted):
        tres_mod.run_with_recovery(preempted, None, 2,
                                   checkpointer=tckpt.Checkpointer(str(tmp_path / "ck")))


# -------------------------------------------- a real process, preempted

_LM = ["-m", "tpu_compressed_dp_torch.harness.lm", "--preset", "tiny", "--device", "cpu",
       "--steps", "4", "--seq_len", "64", "--global_batch", "4", "--fp32", "--log_every", "2",
       "--compress", "entiremodel", "--method", "topk", "--ratio", "0.05", "--error_feedback",
       "--guard", "--ckpt_every", "2"]


def _lm(*extra):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *_LM, *extra], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_preempted_process_exits_75_and_resumes_bitwise(tmp_path, capsys):
    from tpu_compressed_dp_torch.harness import lm

    a, b, c = (str(tmp_path / n) for n in "abc")
    # the uninterrupted run and the resume run in this process; the
    # preempted one is a process of its own, which the SIGTERM ends
    lm.main(_LM[2:] + ["--checkpoint_dir", c])
    cut = _lm("--checkpoint_dir", a, "--chaos", "crash=preempt,crash_at_step=3")
    assert cut.returncode == tres_mod.PREEMPT_EXIT, (cut.returncode, cut.stderr[-2000:])
    assert "emergency checkpoint committed at step 3" in cut.stdout
    man = tckpt.read_manifest(a, 3)
    assert man["meta"] == {"step": 3, "emergency": True, "layout": {"world": 1,
                                                                   "mesh": "dp1xsp1xtp1"}}
    capsys.readouterr()
    lm.main(_LM[2:] + ["--resume", a, "--checkpoint_dir", b])
    assert "resumed step 3" in capsys.readouterr().out
    for rel in ("state.pt", "rank0.pt"):
        want = torch.load(os.path.join(c, "4", rel), weights_only=True)
        got = torch.load(os.path.join(b, "4", rel), weights_only=True)
        _same_tree(got, want, rel)


def _same_tree(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), where
    else:
        assert got == want, where


def test_dataclass_guard_state_is_frozen():
    gs = tguard.init_guard_state(tguard.GuardConfig())
    with pytest.raises(dataclasses.FrozenInstanceError):
        gs.skips = 1


def test_chaos_drill_port_rows():
    """``python -m tpu_compressed_dp_torch.harness.chaos_drill`` on 2 gloo
    processes runs every port row (the quick rows of
    ``tools/chaos_drill.py`` that need no elastic or fleet layer, and
    comp_hold, ef_identity, poison_control and the control rows): each rank's
    crash injector fires at the same global step, both restore the world's
    checkpoint and replay bitwise; the poisoned worker is rank 1."""
    from tpu_compressed_dp_torch.harness import chaos_drill
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()))
    cmd = [sys.executable, "-m", "tpu_compressed_dp_torch.harness.chaos_drill"]
    procs = [subprocess.Popen(cmd + ["--device", "cpu"], env={**env, "RANK": str(r)}, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert [ln[5:] for ln in logs[0].splitlines() if ln.startswith("PASS ")] == \
        chaos_drill.FULL
    assert chaos_drill.QUICK == ["skip_consistency", "loss_scale", "max_skips",
                                 "crash_recovery", "ckpt_preempt", "ckpt_corrupt",
                                 "stream_corrupt"]

def test_chaos_drill_lists_its_rows(capsys):
    from tpu_compressed_dp_torch.harness import chaos_drill

    assert chaos_drill.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == [
        "quick:", *chaos_drill.QUICK, "full:", "comp_hold", "ef_identity", "poison_control",
        "control_resume", "forensics", "elastic:", "elastic_gossip", "elastic_remesh", "elastic_readmit", "elastic_cascade",
        *[f"elastic[{p},w{w},s{s}]" for p in ("fold", "drop") for w in (0, 3) for s in (0, 3)],
        "elastic[sharded-wire]"]
    # the elastic rows are ported (tests/test_torch_elastic.py runs them), the
    # control and forensics rows (tests/test_torch_obs_harness.py) and the
    # stream row (tests/test_torch_stream.py); the fleet rows are not
    with pytest.raises(SystemExit):
        chaos_drill.main(["--drill", "fleet"])
