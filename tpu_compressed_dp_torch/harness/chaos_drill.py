"""Chaos drill: the fault-injection rows that assert the step guard's and the
checkpoints' invariants end to end, on the port.

PyTorch-port counterpart of the rows of ``tools/chaos_drill.py`` that need
neither the elastic runtime nor the stream, control or fleet layers.  Each
row drives the port's guarded ResNet-9 step (channels_scale 0.125, a batch
of 8 a worker, Top-K + EF unless the row says otherwise) in this process's
world: alone it is one worker; under ``torchrun`` every rank runs the rows
together, and the poisoned worker is the last one.

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

Full rows (the default): the quick rows and ``comp_hold`` (PowerSGD's warm
starts held bitwise on the vetoed step, moved on good ones),
``ef_identity`` (on a guarded good sync the workers' mean of what they
sent, ``acc - new_ef``, is the synced gradient) and ``poison_control``
(the same injection with the guard off makes the parameters nonfinite).

Run: ``python -m tpu_compressed_dp_torch.harness.chaos_drill --quick`` (on
the card; ``--device cpu`` elsewhere, ``--drill NAME`` for one row,
``--list`` for the rows).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
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
from tpu_compressed_dp_torch.utils.chaos import ChaosConfig, CrashInjector
from tpu_compressed_dp_torch.utils.checkpoint import Checkpointer

__all__ = ["QUICK", "FULL", "run_drills", "main"]

QUICK = ["skip_consistency", "loss_scale", "max_skips", "crash_recovery", "ckpt_preempt",
         "ckpt_corrupt"]
FULL = QUICK + ["comp_hold", "ef_identity", "poison_control"]
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
           chaos: Optional[ChaosConfig], momentum: float = 0.9):
    """The scaled ResNet-9, SGD and the guarded step on ``env``'s device."""
    model = r9.ResNet9(channels=r9.scaled_channels(0.125), seed=0, device=env.device)
    params = param_leaves(model)
    opt = SGD(lr=0.05, momentum=momentum, nesterov=momentum > 0)
    state = TrainState.create(model, opt.init(params), init_ef_state(params, comp), seed=1,
                              comp=init_comp_state(params, comp),
                              guard=init_guard_state(guard))
    step = make_train_step(make_normalizing_apply_fn([125.0] * 3, [64.0] * 3), opt, comp,
                           grad_scale=8.0, guard_cfg=guard, chaos=chaos)
    return state, step


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
    p.add_argument("--drill", action="append", default=None, help="run only the named row(s)")
    p.add_argument("--list", action="store_true", help="print the rows and exit")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises where CUDA is missing) or cpu")
    args = p.parse_args(argv)
    if args.list:
        print("quick:")
        for row in QUICK:
            print(f"  {row}")
        print("full:")
        for row in FULL:
            if row not in QUICK:
                print(f"  {row}")
        return 0
    names = args.drill or (QUICK if args.quick else FULL)
    unknown = [n for n in names if n not in FULL]
    if unknown:
        p.error(f"unknown drill(s) {unknown}; --list prints the rows")
    run_drills(names, args.device)
    print(f"chaos drill: {len(names)} row(s) passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
