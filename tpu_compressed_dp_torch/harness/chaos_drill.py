"""Chaos drill: the fault-injection rows that assert the step guard's, the
checkpoints' and the elastic runtime's invariants end to end, on the port.

PyTorch-port counterpart of the rows of ``tools/chaos_drill.py`` that need
no fleet layer.  Each row drives the port's
guarded ResNet-9 step (channels_scale 0.125, a batch of 8 a worker, Top-K +
EF unless the row says otherwise).  The guard and checkpoint rows run in
this process's world: alone it is one worker; under ``torchrun`` every rank
runs the rows together, and the poisoned worker is the last one.

Quick rows (``--quick``):

  * ``skip_consistency``: NaN into one worker's gradients at step 2 of 5;
    every rank skips that step and holds parameters, momentum, BatchNorm
    statistics and EF bitwise; every other step applies.
  * ``loss_scale``: an Inf on the loss backs the scale off (1024 -> 512);
    ``growth_interval`` (3) good steps regrow it.
  * ``max_skips``: a fault every step wedges the run; ``check_guard_metrics``
    raises ``GuardExceeded`` once the streak passes 3 (at step 3).
  * ``crash_recovery``: a host crash at step 5 recovers through
    ``run_with_recovery`` to the uncrashed run's state, bitwise (a NaN at
    step 3 replays identically).
  * ``ckpt_preempt``: ``crash=preempt`` sends this process a real SIGTERM
    at step 3; the loop drains the asynchronous save, cuts an emergency
    checkpoint, and the relaunched state finishes bitwise the uninterrupted
    run (a NaN at step 4, after the preemption, lines the replay up).
  * ``ckpt_corrupt``: one flipped byte in the newest checkpoint; restore
    walks back to the step before (``ckpt/rollback_steps`` 1).
  * ``stream_corrupt``: the same discipline for the delta state stream
    (``stream/``, parameters on the row's device): a flipped payload byte in
    a mid-window delta segment fails its manifest digest, the reader walks
    back to its stored keyframe bitwise and re-converges bitwise once the
    next keyframe and window close land; a torn keyframe with no later
    anchor makes the stream unusable, and ``warm_rejoin`` adopts nothing
    (the joiner joins cold).

Full rows (the default): the quick rows and ``comp_hold`` (PowerSGD's warm
starts held bitwise on the vetoed step, moved on good ones),
``ef_identity`` (on a guarded good sync the workers' mean of what they
sent, ``acc - new_ef``, is the synced gradient) and ``poison_control``
(the same injection with the guard off makes the parameters nonfinite),
and the observability and control rows:

  * ``control_resume``: a preemption one update into a decision window
    (window 3, preempt at step 4) of the adaptive controller (rungs 0.5 /
    0.25 / 0.125, 1e6 modeled bits an update against a 0.5 ms budget);
    the relaunch restores the open window from the checkpoint, and the rung
    schedule (down, down, hold), the state and the ``control_decision``
    records before and after the cut are bitwise the uninterrupted run's;
  * ``forensics``: four simulated ranks share a flight dir per case — nan
    (a NaN on every step of the last worker wedges the guard), dead_peer (a
    ``mid_collective`` kill of worker 2; the survivors' bundles come from
    ``ElasticRuntime.handle_failure`` over the file rendezvous, with the
    group re-init and broadcast stubbed), preempt (a real SIGTERM on rank
    0, the survivors likewise) and corruption (a flipped checkpoint byte):
    each leaves valid bundles whose ``harness/postmortem.py`` verdict names
    the injected rank and kind; a clean run leaves none, and the recorder
    (host floats only) leaves the trajectory bitwise unchanged.

Elastic rows (``--elastic``; ``train/elastic.py``): each spawns its own
world of ``W = 4`` gloo processes of this module, since a remesh takes a
process out of its world (run them from one process, not under
``torchrun``):

  * ``elastic_gossip``: heartbeat-directory detection on a simulated clock
    (one process): silence past the timeout is death, and only then; a
    restarted rank (higher incarnation) is a rejoin candidate, never the
    dead life's liveness;
  * ``elastic_remesh``: ``crash=mid_collective`` kills worker 3 after step
    2; it leaves, the survivors commit a W - 1 world through the
    rendezvous and finish the run.  The replicated state (parameters,
    BatchNorm, momentum) is bitwise the pre-kill one on every survivor and
    each survivor's EF row passes bitwise; the dead row, which the victim
    leaves behind before it exits, is migrated by ``migrate_ef``: ``drop``
    gives the survivors' live rows bitwise and the dead row's float64 norm,
    ``fold`` adds it into survivor row 0 with one float32 add (a live
    remesh cannot fold: the dead process's EF is gone with it);
  * ``elastic_readmit``: PowerSGD r 2 + EF; worker 2 dies at step 0, the
    survivors step at W = 3, then the dead process rejoins (the rendezvous
    join barrier, a new group, ``join_world``): its warm starts are the
    survivors' bitwise and its EF zero, and the world steps at W = 4 again;
  * ``elastic_cascade``: ``crash=during_remesh`` kills worker 3 while the
    survivors are past worker 1: at ``min_world`` 2 the union commits over
    [0, 2] (one cascade); at ``min_world`` 3 every survivor raises a
    ``PeerFailed`` naming [1, 3] and nothing is committed;
  * ``elastic_matrix``: the remesh row over policy x worker x kill step
    (``fold``/``drop`` x workers 0 and 3 x steps 0 and 3), plus wire Top-K
    over the sharded transport (the owner partition rebuilt at W = 3).

Run: ``python -m tpu_compressed_dp_torch.harness.chaos_drill --quick`` (on
the card; ``--device cpu`` elsewhere, ``--drill NAME`` for one row,
``--elastic`` for the elastic rows, ``--list`` for the rows).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_compressed_dp_torch.models import resnet9 as r9
from tpu_compressed_dp_torch.models.common import make_normalizing_apply_fn, param_leaves
from tpu_compressed_dp_torch.parallel import mesh
from tpu_compressed_dp_torch.parallel.dp import (CompressionConfig, init_comp_state,
                                                 init_ef_state, make_grad_sync)
from tpu_compressed_dp_torch.train.guard import (GuardConfig, GuardExceeded,
                                                 check_guard_metrics, init_guard_state)
from tpu_compressed_dp_torch.train.optim import SGD
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.train.step import make_train_step
from tpu_compressed_dp_torch.utils import resilience
from tpu_compressed_dp_torch.utils.chaos import ChaosConfig, ChaosCrash, CrashInjector
from tpu_compressed_dp_torch.utils.checkpoint import Checkpointer

__all__ = ["QUICK", "FULL", "ELASTIC", "run_drills", "run_elastic_drills", "expand_rows",
           "main"]

QUICK = ["skip_consistency", "loss_scale", "max_skips", "crash_recovery", "ckpt_preempt",
         "ckpt_corrupt", "stream_corrupt"]
FULL = QUICK + ["comp_hold", "ef_identity", "poison_control", "control_resume", "forensics"]
ELASTIC = ["elastic_gossip", "elastic_remesh", "elastic_readmit", "elastic_cascade",
           "elastic_matrix"]
#: the JAX runtime's ``metrics()`` keys
ELASTIC_KEYS = {"elastic/peer_failures", "elastic/remesh_count", "elastic/dropped_ef_norm",
                "elastic/remesh_latency_ms", "elastic/remesh_ms", "stream/rejoin_bytes"}
ELASTIC_WORLD = 4
TOPK_EF = CompressionConfig(method="topk", ratio=0.25, error_feedback=True)


@dataclasses.dataclass
class _Env:
    device: torch.device
    world: int
    rank: int

    @property
    def last(self) -> int:
        return self.world - 1


def _setup(env: _Env, comp: CompressionConfig, guard: Optional[GuardConfig],
           chaos: Optional[ChaosConfig], momentum: float = 0.9, control=None,
           with_factory: bool = False):
    """The scaled ResNet-9, SGD and the guarded step on ``env``'s device
    (``control``: a ``ControlConfig`` for the state's controller slot;
    ``with_factory`` adds the ``step_for(comp)`` that builds the step of
    another compression config)."""
    from tpu_compressed_dp_torch.control import init_control_state

    model = r9.ResNet9(channels=r9.scaled_channels(0.125), seed=0, device=env.device)
    params = param_leaves(model)
    opt = SGD(lr=0.05, momentum=momentum, nesterov=momentum > 0)
    state = TrainState.create(model, opt.init(params), init_ef_state(params, comp), seed=1,
                              comp=init_comp_state(params, comp),
                              guard=init_guard_state(guard),
                              control=init_control_state(control))

    def step_for(c: CompressionConfig):
        return make_train_step(make_normalizing_apply_fn([125.0] * 3, [64.0] * 3), opt, c,
                               grad_scale=8.0, guard_cfg=guard, chaos=chaos)

    if with_factory:
        return state, step_for(comp), step_for
    return state, step_for(comp)


def _batch(env: _Env, seed: int = 0) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng([seed, env.rank])
    return {"input": torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
                                      ).to(env.device),
            "target": torch.from_numpy(rng.integers(0, 10, 8)).to(env.device)}


def _snap(state) -> List[torch.Tensor]:
    ts = [*param_leaves(state.model).values(), *state.model.buffers(),
          *state.opt_state["momentum"].values()]
    ts += list(state.ef.values()) if isinstance(state.ef, dict) else []
    ts += list(state.comp.values()) if isinstance(state.comp, dict) else []
    return [t.detach().clone() for t in ts]


def _assert_bitwise(a: List[torch.Tensor], b: List[torch.Tensor], what: str) -> None:
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), (
        f"{what}: a tensor differs")


def drill_skip_consistency(env: _Env, *, bad_step: int = 2, n_steps: int = 5) -> Dict:
    gcfg = GuardConfig(loss_scaling=False, max_consecutive_skips=10)
    chaos = ChaosConfig(kind="nan", steps=(bad_step,), worker=env.last)
    state, step = _setup(env, TOPK_EF, gcfg, chaos)
    batch = _batch(env)
    nonfinite = []
    for i in range(n_steps):
        pre = _snap(state)
        state, m = step(state, batch)
        nonfinite.append(float(m["guard/nonfinite"]))
        if i == bad_step:
            _assert_bitwise(pre, _snap(state), "skip_consistency held state")
            assert m["guard/skip_streak"] == 1.0 and m["guard/last_good_step"] == bad_step
        else:
            assert not all(torch.equal(x, y) for x, y in zip(pre, _snap(state)))
        assert np.isfinite(float(m["loss"]))
    assert nonfinite == [1.0 if i == bad_step else 0.0 for i in range(n_steps)], nonfinite
    assert all(torch.all(torch.isfinite(e)) for e in state.ef.values()), "EF took the poison"
    return {"nonfinite": nonfinite}


def drill_comp_hold(env: _Env) -> Dict:
    comp = CompressionConfig(method="powersgd", rank=2, error_feedback=True)
    chaos = ChaosConfig(kind="inf", steps=(1,), worker=0)
    state, step = _setup(env, comp, GuardConfig(loss_scaling=False), chaos)
    batch = _batch(env)
    state, m = step(state, batch)
    assert float(m["guard/nonfinite"]) == 0.0
    pre = [t.clone() for t in [*state.comp.values(), *state.ef.values()]]
    state, m = step(state, batch)
    assert float(m["guard/nonfinite"]) == 1.0
    _assert_bitwise(pre, [*state.comp.values(), *state.ef.values()], "comp_hold")
    state, m = step(state, batch)
    assert float(m["guard/nonfinite"]) == 0.0
    assert any(not torch.equal(a, b) for a, b in zip(pre, state.comp.values())), (
        "the warm starts never move on good steps")
    return {}


def drill_loss_scale(env: _Env) -> Dict:
    gcfg = GuardConfig(init_scale=1024.0, backoff=0.5, growth=2.0, growth_interval=3,
                       loss_scaling=True)
    chaos = ChaosConfig(kind="inf", target="loss", steps=(1,), worker=0)
    state, step = _setup(env, CompressionConfig(), gcfg, chaos, momentum=0.0)
    batch = _batch(env)
    scales = []
    for _ in range(6):
        state, m = step(state, batch)
        scales.append(m["guard/loss_scale"])
    assert scales == [1024.0, 512.0, 512.0, 512.0, 1024.0, 1024.0], scales
    return {"scales": scales}


def drill_ef_identity(env: _Env) -> Dict:
    cfg = CompressionConfig(method="topk", ratio=0.25, error_feedback=True,
                            granularity="entiremodel")
    rng = np.random.default_rng([3, env.rank])
    g = torch.from_numpy(rng.standard_normal(512).astype(np.float32)).to(env.device)
    e = torch.from_numpy((0.1 * rng.standard_normal(512)).astype(np.float32)).to(env.device)
    synced, new_ef, stats = make_grad_sync(cfg)({"w": g.clone()}, {"w": e}, 0, ok=True)
    sent = g + e - new_ef["w"]          # what this worker transmitted
    if env.world > 1:
        dist.all_reduce(sent)
    gap = float((sent / env.world - synced["w"]).abs().max())
    assert gap < 1e-5 and float(stats["guard/nonfinite"]) == 0.0, gap
    return {"max_gap": gap}


def drill_poison_control(env: _Env) -> Dict:
    chaos = ChaosConfig(kind="nan", steps=(1,), worker=env.last)
    state, step = _setup(env, CompressionConfig(), None, chaos, momentum=0.0)
    batch = _batch(env)
    for _ in range(2):
        state, _ = step(state, batch)
    finite = all(torch.all(torch.isfinite(p)) for p in param_leaves(state.model).values())
    assert not finite, "the chaos injection did not fire"
    return {}


def drill_max_skips(env: _Env) -> Dict:
    gcfg = GuardConfig(loss_scaling=False, max_consecutive_skips=3)
    chaos = ChaosConfig(kind="nan", every=1, worker=0)
    state, step = _setup(env, CompressionConfig(), gcfg, chaos, momentum=0.0)
    batch = _batch(env)
    raised_at = None
    try:
        for i in range(8):
            state, m = step(state, batch)
            check_guard_metrics({k: float(v) for k, v in m.items()}, gcfg)
    except GuardExceeded:
        raised_at = i
    assert raised_at == 3, f"GuardExceeded at step {raised_at}, expected 3"
    return {"raised_at_step": raised_at}


def _shared_dir(env: _Env, td: str) -> str:
    """Rank 0's temporary directory, on every rank (one machine)."""
    name = [td]
    if env.world > 1:
        dist.broadcast_object_list(name, src=0)
    return name[0]


def drill_crash_recovery(env: _Env, *, crash_at_step: int = 5) -> Dict:
    gcfg = GuardConfig(loss_scaling=False)
    chaos = ChaosConfig(kind="nan", steps=(3,), worker=env.last)
    epochs, per_epoch = 4, 2
    batches = [_batch(env, s) for s in range(per_epoch)]

    def run(crash: Optional[CrashInjector], ckpt_dir: Optional[str]):
        state, step = _setup(env, TOPK_EF, gcfg, chaos)
        ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None

        def epoch_fn(state, epoch):
            for i, b in enumerate(batches):
                if crash is not None:
                    crash.check(epoch * per_epoch + i)
                state, _ = step(state, b)
            if ckpt is not None:
                ckpt.save_async(state, {"epoch": epoch})
            return state

        final, info = resilience.run_with_recovery(epoch_fn, state, epochs, checkpointer=ckpt)
        if ckpt is not None:
            ckpt.close()
        return final, info

    clean, _ = run(None, None)
    with tempfile.TemporaryDirectory() as td:
        crashed, info = run(CrashInjector(crash_at_step), _shared_dir(env, td) + "/ck")
        if env.world > 1:
            dist.barrier()
    assert info["restores"] == 1, info
    _assert_bitwise(_snap(clean), _snap(crashed), "crash_recovery state")
    assert clean.step == crashed.step == epochs * per_epoch and clean.guard == crashed.guard
    return {"restores": info["restores"]}


def drill_ckpt_preempt(env: _Env, *, preempt_at_step: int = 3, n_steps: int = 6) -> Dict:
    gcfg = GuardConfig(loss_scaling=False)
    # the NaN lands after the preemption: only a replay that lines up
    # step for step passes the bitwise check
    chaos = ChaosConfig(kind="nan", steps=(4,), worker=env.last,
                        crash_at_step=preempt_at_step, crash_mode="preempt")
    batches = [_batch(env, s) for s in range(n_steps)]
    clean, step = _setup(env, TOPK_EF, gcfg, chaos)
    for i in range(n_steps):
        clean, _ = step(clean, batches[i])
    with tempfile.TemporaryDirectory() as td:
        d = _shared_dir(env, td)
        state, step = _setup(env, TOPK_EF, gcfg, chaos)
        ckpt = Checkpointer(d)
        crash = CrashInjector(chaos.crash_at_step, mode=chaos.crash_mode)
        handler = resilience.PreemptionHandler(log=lambda s: None).install()
        assert handler.installed, "the drill runs on the main thread"
        preempted_at = None
        try:
            i = 0
            while i < n_steps:
                crash.check(i)          # preempt mode: a real SIGTERM, no raise
                for _ in range(1000):   # the handler has run; wait out any lag
                    if handler.triggered or not crash.fired:
                        break
                    time.sleep(0.001)
                handler.check(i)
                state, _ = step(state, batches[i])
                i += 1
                if i % 2 == 0:
                    ckpt.save_async(state, {"step_i": i})
            raise AssertionError("the preemption never fired")
        except resilience.Preempted as err:
            preempted_at = err.step
            ckpt.drain(raise_error=False)
            ckpt.save(state, {"step_i": i, "emergency": True})
            ckpt.close()
        finally:
            handler.uninstall()
        assert preempted_at == preempt_at_step, preempted_at
        # the relaunch: a fresh state restored, the remaining steps run
        state2, step2 = _setup(env, TOPK_EF, gcfg, chaos)
        restorer = Checkpointer(d)
        state2, meta = restorer.restore(state2)
        restorer.close()
        if env.world > 1:
            dist.barrier()
    assert meta.get("emergency") is True and int(meta["step_i"]) == preempt_at_step, meta
    for i in range(int(meta["step_i"]), n_steps):
        state2, _ = step2(state2, batches[i])
    _assert_bitwise(_snap(clean), _snap(state2), "ckpt_preempt state")
    assert clean.step == state2.step == n_steps and clean.guard == state2.guard
    return {"preempted_at": preempted_at, "bitwise": True}


def _flip_byte(directory: str, step: int) -> None:
    path = os.path.join(directory, str(step), "state.pt")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


def drill_ckpt_corrupt(env: _Env, *, n_steps: int = 4) -> Dict:
    state, step = _setup(env, TOPK_EF, GuardConfig(loss_scaling=False), None)
    batch = _batch(env)
    with tempfile.TemporaryDirectory() as td:
        d = _shared_dir(env, td)
        ckpt = Checkpointer(d)
        snaps = {}
        for i in range(n_steps):
            state, _ = step(state, batch)
            ckpt.save(state, {"step_i": i + 1})
            snaps[state.step] = _snap(state)
        ckpt.close()
        if env.world > 1:
            dist.barrier()
        if env.rank == 0:
            _flip_byte(d, n_steps)     # the newest step, now torn
        if env.world > 1:
            dist.barrier()
        fresh, _ = _setup(env, TOPK_EF, GuardConfig(loss_scaling=False), None)
        reader = Checkpointer(d)
        restored, meta = reader.restore(fresh)
        assert restored.step == n_steps - 1 and int(meta["step_i"]) == n_steps - 1, meta
        _assert_bitwise(snaps[n_steps - 1], _snap(restored), "ckpt_corrupt fallback")
        assert reader.metrics()["ckpt/rollback_steps"] == 1.0
        reader.close()
        if env.world > 1:
            dist.barrier()
    return {"rollback_steps": 1, "restored_step": n_steps - 1}


def drill_stream_corrupt(env: _Env, *, keyframe_every: int = 4) -> Dict:
    """The JAX row's sequence on tensors of the row's device: corrupt
    delta -> walk-back and re-anchor; torn keyframe -> unusable, no warm
    adoption.  Every rank runs it in a directory of its own."""
    import copy
    import types

    from tpu_compressed_dp_torch.stream import StreamCorrupt, StreamReader, StreamWriter
    from tpu_compressed_dp_torch.stream.rejoin import warm_rejoin
    from tpu_compressed_dp_torch.stream.store import segment_payload_path

    rng = np.random.RandomState(7)
    dev = env.device
    params = {"dense": {"kernel": torch.from_numpy(rng.randn(48, 8).astype(np.float32)).to(dev)},
              "bias": torch.from_numpy(rng.randn(64).astype(np.float32)).to(dev)}

    def advance():
        params["dense"]["kernel"] = params["dense"]["kernel"] + torch.from_numpy(
            rng.randn(48, 8).astype(np.float32) * 0.01).to(dev)
        params["bias"] = params["bias"] + torch.from_numpy(
            rng.randn(64).astype(np.float32) * 0.01).to(dev)

    def host(tree):
        return {"dense": {"kernel": tree["dense"]["kernel"].cpu().numpy()},
                "bias": tree["bias"].cpu().numpy()}

    def same(want, got, what):
        for a, b in ((want["dense"]["kernel"], got["dense"]["kernel"]),
                     (want["bias"], got["bias"])):
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), f"{what}: not bitwise"

    def flip(path):
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))

    def quiet(*a, **k):
        pass

    with tempfile.TemporaryDirectory() as td:
        sd = os.path.join(td, "stream")
        w = StreamWriter(sd, ratio=0.25, keyframe_every=keyframe_every, log=quiet)
        w.append(params, step=1)                    # seq 0: keyframe
        kf_params = copy.deepcopy(host(params))
        advance(); w.append(params, step=2)         # seq 1: delta
        advance(); w.append(params, step=3)         # seq 2: delta (mid-window)
        flip(segment_payload_path(sd, 2))           # torn delta
        r = StreamReader(sd, log=quiet)
        r.catch_up()
        # the digest notices; the reconstruction reverts to the keyframe's
        assert r.metrics()["stream/corrupt_segments"] == 1.0
        assert int(r.applied_seq) == 0 and int(r.applied_step) == 1
        same(kf_params, r.params_like(kf_params), "stream_corrupt walk-back")
        advance(); w.append(params, step=4)         # seq 3: flush (skipped)
        advance(); w.append(params, step=5)         # seq 4: fresh keyframe
        kf2 = host(params)
        r.catch_up()
        assert int(r.applied_seq) == 4, int(r.applied_seq)
        same(kf2, r.params_like(kf2), "stream_corrupt re-anchor")
        advance(); w.sync(params, step=6)           # window-closing flush
        r.catch_up()
        assert r.exact, "head not exact after sync"
        now = host(params)
        same(now, r.params_like(now), "stream_corrupt reconverged head")
        w.close()

        # a torn KEYFRAME with no later anchor: the reader raises and warm
        # rejoin adopts nothing, leaving the joiner's model as it was
        sd2 = os.path.join(td, "stream2")
        gen = torch.Generator().manual_seed(7)
        model = torch.nn.Linear(16, 8).to(dev)
        w2 = StreamWriter(sd2, ratio=0.25, keyframe_every=keyframe_every, log=quiet)
        w2.append(model, step=1)                    # seq 0: keyframe
        with torch.no_grad():
            model.weight.add_(0.5)
        w2.append(model, step=2)                    # seq 1: delta
        w2.close()
        flip(segment_payload_path(sd2, 0))
        try:
            StreamReader(sd2, log=quiet).catch_up()
            raise AssertionError("torn keyframe went unnoticed")
        except StreamCorrupt:
            pass
        joiner = types.SimpleNamespace(model=torch.nn.Linear(16, 8).to(dev))
        with torch.no_grad():
            joiner.model.weight.copy_(torch.randn(8, 16, generator=gen).to(dev))
        before = [p.detach().clone() for p in joiner.model.parameters()]
        adopted, info = warm_rejoin(joiner, sd2, log=quiet)
        assert info is None and adopted is joiner, "warm rejoin adopted from an unusable stream"
        _assert_bitwise(before, list(joiner.model.parameters()), "stream_corrupt cold joiner")
    return {"corrupt_segments": 1, "walkback_seq": 0, "reconverged": True,
            "keyframe_fallback": True}


class _Recorder:
    """An event-stream stand-in that keeps ``(kind, fields)`` in order."""

    def __init__(self):
        self.events: List = []

    def emit(self, kind: str, **fields) -> None:
        self.events.append((kind, fields))

    def decisions(self) -> List:
        return [(k, f) for k, f in self.events if k == "control_decision"]


def drill_control_resume(env: _Env, *, preempt_at_step: int = 4, n_steps: int = 9) -> Dict:
    from tpu_compressed_dp_torch.control import ControlConfig, Controller, comp_for_rung

    base = CompressionConfig(method="topk", ratio=0.5, error_feedback=True)
    # window 3, preempt at 4: the cut lands one update INTO a window; the
    # modeled comm (1e6 bits at 100 Mbit/s = 10 ms an update) is far past
    # the pinned 0.5 ms budget, so the schedule is down, down, hold
    ctrl_cfg = ControlConfig(method="topk", rungs=(0.5, 0.25, 0.125), window=3,
                             budget_ms=0.5)
    gcfg = GuardConfig(loss_scaling=False)
    batches = [_batch(env, s) for s in range(n_steps)]

    def span(state, step_for, controller, i0, i1):
        cache = {}
        for i in range(i0, i1):
            rung = int(state.control.rung)
            if rung not in cache:
                cache[rung] = step_for(comp_for_rung(base, ctrl_cfg, rung))
            state, _ = cache[rung](state, batches[i])
            new_control, _ = controller.tick(
                state.control, applied=state.step,
                signals=controller.window_signals(mean_bits=1e6))
            state = dataclasses.replace(state, control=new_control)
        return state

    rec_clean = _Recorder()
    clean, _, sf = _setup(env, base, gcfg, None, control=ctrl_cfg, with_factory=True)
    clean = span(clean, sf, Controller(ctrl_cfg, events=rec_clean), 0, n_steps)
    with tempfile.TemporaryDirectory() as td:
        d = _shared_dir(env, td)
        # first life: preempted mid-window, the emergency save
        rec_a = _Recorder()
        s1, _, sf1 = _setup(env, base, gcfg, None, control=ctrl_cfg, with_factory=True)
        s1 = span(s1, sf1, Controller(ctrl_cfg, events=rec_a), 0, preempt_at_step)
        ckpt = Checkpointer(d)
        ckpt.save(s1, {"step_i": preempt_at_step, "emergency": True})
        ckpt.close()
        # the relaunch: a fresh state restored, the run finished
        rec_b = _Recorder()
        s2, _, sf2 = _setup(env, base, gcfg, None, control=ctrl_cfg, with_factory=True)
        restorer = Checkpointer(d)
        s2, meta = restorer.restore(s2)
        restorer.close()
        if env.world > 1:
            dist.barrier()
    assert int(meta["step_i"]) == preempt_at_step, meta
    # the open window's accumulation rode the checkpoint
    assert int(s2.control.win_updates) == preempt_at_step % ctrl_cfg.window, s2.control
    s2 = span(s2, sf2, Controller(ctrl_cfg, events=rec_b), preempt_at_step, n_steps)
    _assert_bitwise(_snap(clean), _snap(s2), "control_resume state")
    assert clean.step == s2.step == n_steps and clean.control == s2.control
    # the decision stream: before + after the cut == the uninterrupted run's
    assert rec_a.decisions() + rec_b.decisions() == rec_clean.decisions(), (
        rec_a.decisions() + rec_b.decisions(), rec_clean.decisions())
    rungs = [f["rung_to"] for _, f in rec_clean.decisions()]
    dirs = [f["direction"] for _, f in rec_clean.decisions()]
    assert rungs == [1, 2, 2] and dirs == ["down", "down", "hold"], (rungs, dirs)
    return {"decisions": len(rungs), "rungs": rungs, "resumed_mid_window": True}


def drill_forensics(env: _Env) -> Dict:
    from tpu_compressed_dp_torch.harness.postmortem import classify, merge_timeline
    from tpu_compressed_dp_torch.obs.flight import (FlightRecorder, read_bundles,
                                                    validate_bundle)
    from tpu_compressed_dp_torch.train.elastic import ElasticConfig, ElasticRuntime, PeerFailed
    from tpu_compressed_dp_torch.train.rendezvous import Rendezvous
    from tpu_compressed_dp_torch.utils.checkpoint import CheckpointCorrupt

    ranks = 4

    def survivors_remesh(fls, dead, step, reason):
        """Every survivor's ``ElasticRuntime.handle_failure`` with its flight
        recorder, one thread a survivor over one real file rendezvous: the
        bundles are the ones a live remesh dumps.  The process group's
        re-init and the state broadcast are stubbed, since one process plays
        every rank."""
        from concurrent.futures import ThreadPoolExecutor

        live = [r for r in range(ranks) if r not in dead]

        def remesh(rd, r):
            rt = ElasticRuntime(
                ElasticConfig(rank=r, peer_timeout_s=5.0), ranks=range(ranks),
                rendezvous=Rendezvous(rd, r), flight=fls[r], reinit=lambda d: None,
                broadcast=lambda st, src, extras=None, params=True: (st, extras),
                log=lambda s: None)
            try:
                rt.handle_failure(dataclasses.make_dataclass("S", ["ef"])({}),
                                  PeerFailed(dead, step=step, reason=reason))
                return rt.ranks
            finally:
                rt.close()

        with tempfile.TemporaryDirectory() as rd, ThreadPoolExecutor(len(live)) as pool:
            got = [f.result() for f in [pool.submit(remesh, rd, r) for r in live]]
        assert got == [tuple(live)] * len(live), (got, live)

    def recorders(directory, chaos=None):
        out = []
        for r in range(ranks):
            fl = FlightRecorder(rank=r, capacity=32, directory=directory,
                                meta={"drill": "forensics"})
            if chaos is not None:
                fl.note_chaos(chaos)
            out.append(fl)
        return out

    def check_bundles(directory, expect):
        bundles = read_bundles(directory)
        assert sorted(bundles) == sorted(expect), (sorted(bundles), sorted(expect))
        for r, b in bundles.items():
            problems = validate_bundle(b)
            assert not problems, (r, problems)
        return bundles

    verdicts = {}
    # nan: a NaN on every step of the last worker wedges the guard everywhere
    gcfg = GuardConfig(loss_scaling=False, max_consecutive_skips=2)
    chaos = ChaosConfig(kind="nan", target="grads", every=1, worker=env.last)
    state, step = _setup(env, TOPK_EF, gcfg, chaos)
    batch = _batch(env)
    for _ in range(4):
        state, metrics = step(state, batch)
    m = {k: float(v) for k, v in metrics.items()}
    with tempfile.TemporaryDirectory() as td:
        for fl in recorders(td, chaos):
            fl.note_step(3, m)
            try:
                check_guard_metrics(m, gcfg, flight=fl)
                raise AssertionError("the guard did not wedge")
            except GuardExceeded:
                pass
        bundles = check_bundles(td, range(ranks))
        assert all(b["reason"] == "guard_exceeded" for b in bundles.values()), bundles
        v = classify(bundles)
        assert (v["kind"], v["rank"]) == ("nan", env.last), v
        assert merge_timeline(bundles), "empty merged timeline"
        verdicts["nan"] = v
    # dead_peer: a mid-collective kill of worker 2; the survivors remesh
    # past it, the dying rank's own injector reports itself
    chaos = ChaosConfig(crash_at_step=1, crash_mode="mid_collective", worker=2)
    with tempfile.TemporaryDirectory() as td:
        fls = recorders(td, chaos)
        crash = CrashInjector(1, mode="mid_collective", worker=2)
        crash.flight = fls[2]
        try:
            crash.check(1, phase="mid_collective")
            raise AssertionError("the injector did not fire")
        except ChaosCrash as err:
            fls[2].observe(err)
        survivors_remesh(fls, (2,), 1, "gossip heartbeat stale")
        bundles = check_bundles(td, range(ranks))
        assert bundles[2]["reason"] == "chaos_crash", bundles[2]
        v = classify(bundles)
        assert (v["kind"], v["rank"]) == ("dead_peer", 2), v
        verdicts["dead_peer"] = v
    # preempt: a real SIGTERM on rank 0 through the handler; the peers'
    # remesh (PeerFailed) loses to it in the verdict's priority
    chaos = ChaosConfig(crash_at_step=0, crash_mode="preempt")
    with tempfile.TemporaryDirectory() as td:
        fls = recorders(td, chaos)
        crash = CrashInjector(0, mode="preempt")
        crash.flight = fls[0]
        handler = resilience.PreemptionHandler(log=lambda s: None).install()
        assert handler.installed, "the drill runs on the main thread"
        try:
            crash.check(0)          # a real SIGTERM, no raise
            for _ in range(1000):
                if handler.triggered:
                    break
                time.sleep(0.001)
            handler.check(0)
            raise AssertionError("the preemption never fired")
        except resilience.Preempted as err:
            fls[0].observe(err)
        finally:
            handler.uninstall()
        survivors_remesh(fls, (0,), 0, "peer exited")
        bundles = check_bundles(td, range(ranks))
        assert bundles[0]["reason"] == "preempt", bundles[0]
        v = classify(bundles)
        assert (v["kind"], v["rank"]) == ("preempt", 0), v
        verdicts["preempt"] = v
    # corruption: a flipped byte, then an explicit-step restore trips the
    # manifest digest and the Checkpointer dumps before it raises
    state, step = _setup(env, TOPK_EF, GuardConfig(loss_scaling=False), None)
    with tempfile.TemporaryDirectory() as td, tempfile.TemporaryDirectory() as fl_dir:
        ck_dir = _shared_dir(env, td)
        fls = recorders(fl_dir)
        ckpt = Checkpointer(ck_dir)
        state, _ = step(state, batch)
        ckpt.save(state, {"step_i": 1})
        ckpt.close()
        if env.world > 1:
            dist.barrier()
        if env.rank == 0:
            _flip_byte(ck_dir, 1)
        if env.world > 1:
            dist.barrier()
        reader = Checkpointer(ck_dir)
        reader.flight = fls[0]
        try:
            reader.restore(state, step=1)
            raise AssertionError("the corrupt restore did not raise")
        except CheckpointCorrupt:
            pass
        finally:
            reader.close()
        if env.world > 1:
            dist.barrier()
        bundles = check_bundles(fl_dir, [0])
        assert bundles[0]["reason"] == "ckpt_corrupt", bundles[0]
        v = classify(bundles)
        assert v["kind"] == "corruption", v
        verdicts["corruption"] = v
    # control: a clean run leaves no bundle; the recorder sees only the
    # host's metric floats, and the two trajectories (one step function, two
    # identically built states, one of them recorded) stay bitwise equal
    plain, step = _setup(env, TOPK_EF, GuardConfig(loss_scaling=False), None)
    observed, _ = _setup(env, TOPK_EF, GuardConfig(loss_scaling=False), None)
    with tempfile.TemporaryDirectory() as td:
        fls = recorders(td)
        for i in range(3):
            plain, _ = step(plain, batch)
            observed, m2 = step(observed, batch)
            for fl in fls:
                fl.note_step(i, {k: float(v) for k, v in m2.items()})
        for fl in fls:
            fl.publish()    # phase profiles are not bundles
        assert read_bundles(td) == {}, "a clean run left blackbox bundles"
    _assert_bitwise(_snap(plain), _snap(observed), "forensics control")
    return {"verdicts": {k: v["kind"] for k, v in verdicts.items()},
            "ranks": {k: v["rank"] for k, v in verdicts.items()},
            "clean_bundles": 0, "bitwise": True}


# ----------------------------------------------------------- elastic rows

def drill_elastic_gossip() -> Dict:
    """Heartbeat-gossip failure detection on a simulated clock."""
    from tpu_compressed_dp_torch.train.elastic import (PeerFailed, PeerGossip,
                                                       write_peer_heartbeat)

    clock = {"t": 1000.0}
    with tempfile.TemporaryDirectory() as td:
        g = PeerGossip(td, 0, 4, peer_timeout_s=5.0, now=lambda: clock["t"])
        for r in (1, 2, 3):
            write_peer_heartbeat(td, r, 0, ts=clock["t"])
        assert g.check() == {}, "fresh peers misread as dead"
        clock["t"] += 4.0                       # rank 2 goes silent here
        for r in (1, 3):
            write_peer_heartbeat(td, r, 1, ts=clock["t"])
        assert g.check() == {}, "silence below the timeout misread as death"
        clock["t"] += 4.0                       # rank 2 now 8 s stale (> 5 s)
        for r in (1, 3):
            write_peer_heartbeat(td, r, 2, ts=clock["t"])
        try:
            g.raise_if_dead(step=7)
            raise AssertionError("gossip missed the dead peer")
        except PeerFailed as pf:
            assert pf.failed == (2,) and pf.step == 7, pf
        assert g.dead == (2,)
        clock["t"] += 1.0
        write_peer_heartbeat(td, 2, 0, incarnation=1, ts=clock["t"])
        assert g.rejoin_candidates() == {2: 1}
        assert g.dead == (2,), "rejoin candidacy must not undeclare death"
        g.readmit(2)
        assert g.dead == () and g.check() == {}
    return {"detected": [2]}


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _replicated(state) -> str:
    return _digest([*state.model.state_dict().values(),
                    *state.opt_state["momentum"].values()])


def _ef_rows(state) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in state.ef.items()}


def elastic_rank(row: str, rank: int, world: int, port: int, out: str, device: str,
                 kw: dict) -> int:
    """One process of an elastic row's world: the row's steps, the kill and
    the remesh (or the readmission); its record goes to
    ``<out>/rank<r>.json`` and its EF rows around the remesh to
    ``<out>/ef_rank<r>.npz``.  Exits 3 where the runtime declared it dead."""
    from tpu_compressed_dp_torch.train.elastic import ElasticConfig, ElasticRuntime, PeerFailed
    from tpu_compressed_dp_torch.train.rendezvous import Rendezvous

    torch.set_num_threads(1)
    dev = mesh.resolve_device(device)
    edir = os.path.join(out, "el")
    mesh.init_process_group(dev, backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank, timeout_s=30.0)
    comp = (CompressionConfig(method="powersgd", rank=2, error_feedback=True)
            if kw.get("powersgd") else
            CompressionConfig(method="topk", ratio=0.25, error_feedback=True,
                              granularity="entiremodel", mode=kw.get("mode", "simulate"),
                              transport=kw.get("transport", "allgather")))
    state, step = _setup(_Env(dev, world, rank), comp, None, None)
    kill = CrashInjector(kw["kill_step"], mode="mid_collective", worker=kw["worker"])
    cascade = (CrashInjector(kw["kill_step"], mode="during_remesh", worker=kw["cascade"])
               if "cascade" in kw else None)
    cfg = ElasticConfig(gossip_dir=edir, rank=rank, peer_timeout_s=30.0,
                        min_world=kw.get("min_world", 2))
    el = ElasticRuntime(cfg, crash=cascade, rendezvous=Rendezvous(edir, rank, base_port=port),
                        device=dev, log=lambda s: None)
    rec: Dict = {"rank": rank}

    def save(name, payload):
        with open(os.path.join(out, name), "w") as f:
            json.dump(payload, f, default=str)

    i = 0
    while i < kw["n_steps"]:
        state, m = step(state, _batch(_Env(dev, el.world, el.rank), i))
        rec.setdefault("comm", []).append({k: float(v) for k, v in m.items()
                                           if k.startswith("comm/sent_bits")})
        try:
            kill.check(i, phase="mid_collective")
        except ChaosCrash as err:
            pre, pre_ef = _replicated(state), _ef_rows(state)
            np.savez(os.path.join(out, f"ef_rank{rank}.npz"), **pre_ef)
            try:
                state = el.handle_failure(state, el.failure_from(err))
            except PeerFailed as pf:
                rec["left"] = str(pf)
                save(f"rank{rank}.json", rec)
                if not kw.get("powersgd"):
                    mesh.destroy()
                    return 3
                # the readmission row: this process plays the relaunched
                # worker, parked in the join barrier until the survivors
                # admit it into a new world
                mesh.destroy()
                decision = Rendezvous(edir, rank).join(incarnation=1, stale_epoch=el.epoch + 1,
                                                       deadline_s=120.0)
                mesh.init_process_group(dev, backend="gloo",
                                        init_method=f"tcp://{decision.address}",
                                        world_size=decision.num_processes,
                                        rank=decision.process_id, timeout_s=30.0)
                state, step = _setup(_Env(dev, decision.num_processes, decision.process_id),
                                     comp, None, None)
                el = ElasticRuntime(cfg, ranks=decision.ranks, device=dev,
                                    rendezvous=Rendezvous(edir, rank, base_port=port),
                                    log=lambda s: None)
                state = el.join_world(state, decision)
                rec["joined"] = {"comp": _digest(list(state.comp.values())),
                                 "ef_zero": all(not bool(t.any()) for t in state.ef.values()),
                                 "step": state.step}
                i = state.step
                continue
            rec["remesh"] = {"pre": pre, "post": _replicated(state), "ranks": list(el.ranks),
                             "rank": el.rank, "ef_held": all(
                                 np.array_equal(v.view(np.uint32), pre_ef[k].view(np.uint32))
                                 for k, v in _ef_rows(state).items()),
                             "cascades": el.cascade_count, "metrics": el.metrics()}
            if kw.get("powersgd"):
                # one step at W - 1, then wait at the barrier for the rejoin
                state, _ = step(state, _batch(_Env(dev, el.world, el.rank), i + 1))
                deadline = time.time() + 120.0
                while not set(el.rendezvous.pending_joins()) - set(el.ranks):
                    assert time.time() < deadline, "the dead rank never asked to join"
                    time.sleep(0.05)
                state, grew = el.rejoin_barrier(state)
                rec["readmit"] = {"grew": grew, "comp": _digest(list(state.comp.values())),
                                  "world": el.world, "readmits": el.readmit_count}
                i += 1
        i += 1
    torch.cuda.synchronize() if dev.type == "cuda" else None
    rec.update(step=state.step, world=el.world, final=_replicated(state),
               metric_keys=sorted(el.metrics()), metrics=el.metrics())
    save(f"rank{rank}.json", rec)
    mesh.destroy()
    return 0


# the elastic rows' world directories, removed when the rows are done
_ELASTIC_DIRS: List[str] = []


def _elastic_world(row: str, kw: dict, device: str, world: int = ELASTIC_WORLD):
    """Spawn the row's world; ``(exit codes, records, directory, logs)``."""
    out = tempfile.mkdtemp(prefix=f"tcdp_{row}_")
    _ELASTIC_DIRS.append(out)
    port = mesh.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, "-m", "tpu_compressed_dp_torch.harness.chaos_drill",
                               "--elastic_rank", row, str(r), str(world), str(port), out, device,
                               json.dumps(kw)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = {}
    for r in range(world):
        path = os.path.join(out, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                recs[r] = json.load(f)
    rcs = [p.returncode for p in procs]
    return rcs, recs, out, logs


def _check_remesh(label: str, kw: dict, rcs, recs, out) -> Dict:
    from tpu_compressed_dp_torch.train.elastic import migrate_ef
    from tpu_compressed_dp_torch.train.rendezvous import read_epoch

    w = kw["worker"]
    survivors = [r for r in range(ELASTIC_WORLD) if r != w]
    assert rcs[w] == 3 and "among the declared dead" in recs[w]["left"], (label, rcs)
    assert all(rcs[r] == 0 for r in survivors), (label, rcs)
    assert read_epoch(os.path.join(out, "el"))["ranks"] == survivors
    for new, r in enumerate(survivors):
        rm = recs[r]["remesh"]
        assert rm["ranks"] == survivors and rm["rank"] == new and rm["ef_held"], (label, rm)
        assert rm["pre"] == rm["post"] == recs[survivors[0]]["remesh"]["post"], \
            f"{label}: the replicated state moved through the remesh"
        assert recs[r]["step"] == kw["n_steps"] and recs[r]["world"] == ELASTIC_WORLD - 1
        assert set(recs[r]["metric_keys"]) == ELASTIC_KEYS
        assert recs[r]["metrics"]["elastic/remesh_count"] == 1.0
        assert recs[r]["metrics"]["elastic/peer_failures"] == 1.0
    assert len({recs[r]["final"] for r in survivors}) == 1, f"{label}: the survivors differ"
    # the EF migration over the world's stacked rows, the dead one included
    rows = [dict(np.load(os.path.join(out, f"ef_rank{r}.npz"))) for r in range(ELASTIC_WORLD)]
    stacked = {k: torch.from_numpy(np.stack([row[k] for row in rows])) for k in rows[0]}
    dropped, norm = migrate_ef(stacked, [w], policy="drop")
    for k, v in dropped.items():
        assert np.array_equal(v.numpy().view(np.uint32),
                              np.stack([rows[r][k] for r in survivors]).view(np.uint32)), k
    want_sq = sum(float(np.sum(rows[w][k].astype(np.float64) ** 2)) for k in sorted(rows[w]))
    assert norm == float(np.sqrt(want_sq)) > 0.0
    folded, fnorm = migrate_ef(stacked, [w], policy="fold")
    for k, v in folded.items():
        want = rows[survivors[0]][k] + rows[w][k]
        assert np.array_equal(v[0].numpy().view(np.uint32), want.view(np.uint32)), k
    assert fnorm == 0.0
    return {"world": ELASTIC_WORLD - 1, "ef_unrecoverable": True,
            "dropped_ef_norm": norm if kw.get("policy") == "drop" else 0.0}


def drill_elastic_remesh(device: str, *, kill_step: int = 2, worker: int = 3,
                         policy: str = "fold", n_steps: int = 5, transport: str = "allgather",
                         mode: str = "simulate") -> Dict:
    kw = dict(kill_step=kill_step, worker=worker, policy=policy, n_steps=n_steps,
              transport=transport, mode=mode)
    rcs, recs, out, logs = _elastic_world("elastic_remesh", kw, device)
    try:
        res = _check_remesh(f"elastic_remesh {kw}", kw, rcs, recs, out)
    except Exception:
        print("\n".join(lg[-2000:] for lg in logs))
        raise
    if mode == "wire" and transport == "sharded":
        from tpu_compressed_dp_torch.parallel.dp import _sharded_group_bits

        n = sum(p.numel() for p in param_leaves(r9.ResNet9(channels=r9.scaled_channels(0.125),
                                                            seed=0, device="cpu")).values())
        cfg = CompressionConfig(method="topk", ratio=0.25, mode="wire", transport="sharded",
                                granularity="entiremodel", error_feedback=True)
        for r, rec in recs.items():
            if r == worker:
                continue
            for i, c in enumerate(rec["comm"]):
                route, ret = _sharded_group_bits("topk", n, 4 if i <= kill_step else 3, cfg)
                assert c["comm/sent_bits"] == route + ret, (r, i, c)
    return res


def drill_elastic_readmit(device: str) -> Dict:
    kw = dict(kill_step=0, worker=2, n_steps=3, powersgd=True)
    rcs, recs, out, logs = _elastic_world("elastic_readmit", kw, device)
    try:
        assert rcs == [0] * ELASTIC_WORLD, rcs
        joined = recs[2]["joined"]
        assert joined["ef_zero"], "the rejoiner's EF is not zero"
        for r in (0, 1, 3):
            rd = recs[r]["readmit"]
            assert rd["grew"] and rd["world"] == ELASTIC_WORLD and rd["readmits"] == 1, rd
            assert rd["comp"] == joined["comp"], "the warm starts were not broadcast"
        assert len({rec["final"] for rec in recs.values()}) == 1
        assert all(rec["world"] == ELASTIC_WORLD for rec in recs.values())
    except Exception:
        print("\n".join(lg[-2000:] for lg in logs))
        raise
    return {"world": ELASTIC_WORLD, "readmits": 1}


def drill_elastic_cascade(device: str) -> Dict:
    from tpu_compressed_dp_torch.train.rendezvous import read_epoch

    kw = dict(kill_step=2, worker=1, cascade=3, n_steps=4, min_world=2)
    rcs, recs, out, logs = _elastic_world("elastic_cascade", kw, device)
    try:
        assert rcs == [0, 3, 0, 3], rcs
        assert read_epoch(os.path.join(out, "el"))["ranks"] == [0, 2]
        for r in (0, 2):
            assert recs[r]["remesh"]["cascades"] == 1 and recs[r]["world"] == 2
            assert recs[r]["metrics"]["elastic/peer_failures"] == 2.0
        rcs, recs, out, logs = _elastic_world("elastic_cascade", dict(kw, min_world=3), device)
        assert rcs == [3] * ELASTIC_WORLD, rcs
        for r in (0, 2):
            assert "[1, 3] failed" in recs[r]["left"] and "below min_world 3" in recs[r]["left"]
        assert read_epoch(os.path.join(out, "el")) is None, "a stale world was committed"
    except Exception:
        print("\n".join(lg[-2000:] for lg in logs))
        raise
    return {"world": 2, "cascades": 1}


def expand_rows(names) -> List[str]:
    """The concrete rows a name list runs (``elastic_matrix`` expands to its
    cells), the JAX drill's naming."""
    rows = []
    for name in names:
        if name == "elastic_matrix":
            rows += [f"elastic[{policy},w{worker},s{kill_step}]" for policy in ("fold", "drop")
                     for worker in (0, ELASTIC_WORLD - 1) for kill_step in (0, 3)]
            rows.append("elastic[sharded-wire]")
        else:
            rows.append(name)
    return rows


def run_elastic_drills(names, device: str = "cuda") -> Dict[str, Dict]:
    """The named elastic rows, each in a world of its own; raises on the
    first failing invariant."""
    import shutil

    mesh.resolve_device(device)
    results = {}
    try:
        _run_elastic(names, device, results)
    finally:
        while _ELASTIC_DIRS:
            shutil.rmtree(_ELASTIC_DIRS.pop(), ignore_errors=True)
    return results


def _run_elastic(names, device: str, results: Dict) -> None:
    for name in names:
        if name == "elastic_gossip":
            results[name] = drill_elastic_gossip()
        elif name == "elastic_matrix":
            for policy in ("fold", "drop"):
                for worker in (0, ELASTIC_WORLD - 1):
                    for kill_step in (0, 3):
                        key = f"elastic[{policy},w{worker},s{kill_step}]"
                        results[key] = drill_elastic_remesh(device, kill_step=kill_step,
                                                            worker=worker, policy=policy)
                        print(f"PASS {key}")
            key = "elastic[sharded-wire]"
            results[key] = drill_elastic_remesh(device, transport="sharded", mode="wire",
                                                worker=2, policy="fold")
            print(f"PASS {key}")
            continue
        else:
            results[name] = globals()[f"drill_{name}"](device)
        print(f"PASS {name}")


def run_drills(names, device: str = "cuda") -> Dict[str, Dict]:
    """Run the named rows in this process's world; raises on the first
    failing invariant."""
    dev = mesh.resolve_device(device)
    made = not dist.is_initialized()
    mesh.init_process_group(dev)
    env = _Env(dev, mesh.world(), mesh.rank())
    try:
        results = {}
        for name in names:
            results[name] = globals()[f"drill_{name}"](env)
            if env.rank == 0:
                print(f"PASS {name}")
        return results
    finally:
        if made:
            mesh.destroy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--quick", action="store_true", help=f"the quick rows ({', '.join(QUICK)})")
    p.add_argument("--elastic", action="store_true",
                   help=f"the elastic rows ({', '.join(ELASTIC)}), each in a world of its own")
    p.add_argument("--elastic_rank", nargs=7, default=None, help=argparse.SUPPRESS)
    p.add_argument("--drill", action="append", default=None, help="run only the named row(s)")
    p.add_argument("--list", action="store_true", help="print the rows and exit")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises where CUDA is missing) or cpu")
    args = p.parse_args(argv)
    if args.elastic_rank:
        row, rank, world, port, out, device, kw = args.elastic_rank
        return elastic_rank(row, int(rank), int(world), int(port), out, device, json.loads(kw))
    if args.list:
        print("quick:")
        for row in QUICK:
            print(f"  {row}")
        print("full:")
        for row in FULL:
            if row not in QUICK:
                print(f"  {row}")
        print("elastic:")
        for row in expand_rows(ELASTIC):
            print(f"  {row}")
        return 0
    names = args.drill or (ELASTIC if args.elastic else QUICK if args.quick else FULL)
    unknown = [n for n in names if n not in FULL + ELASTIC]
    if unknown:
        p.error(f"unknown drill(s) {unknown}; --list prints the rows")
    elastic = [n for n in names if n in ELASTIC]
    if elastic and mesh.world() == 1 and "WORLD_SIZE" not in os.environ:
        run_elastic_drills(elastic, args.device)
    elif elastic:
        p.error("the elastic rows start their own worlds: run them from one process")
    run_drills([n for n in names if n not in ELASTIC], args.device)
    print(f"chaos drill: {len(names)} row(s) passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
