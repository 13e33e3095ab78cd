"""The port's step guard and chaos injection against the JAX package's.

  * The guard's state machine (``update_guard``, ``schedule_step``,
    ``guard_metrics``, ``check_guard_metrics``) over seeded random verdict
    sequences, with and without loss scaling: every field bitwise (the
    float32 scale and the int32 counters), the raise and its message equal.
  * ``ChaosConfig.parse`` / ``to_spec`` over the same specs, the error
    cases included: equal fields, equal strings, equal error messages.
  * ``GuardMeter`` on the same samples: equal summaries.
  * The guarded syncs and ResNet-9 step at W = 2 against JAX:
    ``tests/test_torch_guard_resnet.py`` (this file's worker and
    :func:`spawn_world` run its port side).
  * The guarded LM step (tiny config, bf16, loss scaling at 2^15, Inf on
    the loss at step 1 of 3, dense sync) on the ``(2, 1, 1)`` mesh and,
    under ``-m slow`` (one more JAX compile), the ``(1, 1, 2)`` mesh:
    guard/* and comm/* equal JAX's at every step, the vetoed step held
    bitwise, the loss within rtol 2e-2 (bf16 forward passes of the two
    frameworks differ by a few bf16 ulps, ``tests/test_torch_tp4_bf16.py``).
  * Within the port: the guarded fp32 step is bitwise the unguarded step
    (the scale is the identity), the guarded bf16 step at the loss scale
    2^15 is bitwise the unguarded bf16 step (ResNet-9 and the tiny LM: the
    unscale is exact), and the guarded ``--overlap 4`` step is bitwise the
    guarded ``--overlap 1`` step through a vetoed step.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_compressed_dp.data import cifar10 as jdata
from tpu_compressed_dp.data import lm as jlmdata
from tpu_compressed_dp.models import transformer as jtf
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.train import guard as jguard
from tpu_compressed_dp.train import lm_step as jlm
from tpu_compressed_dp.train import optim as joptim
from tpu_compressed_dp.train import schedules as jsched
from tpu_compressed_dp.train.state import TrainState as JState
from tpu_compressed_dp.utils import chaos as jchaos
from tpu_compressed_dp.utils import meters as jmeters

import torch

from tpu_compressed_dp_torch.models import common as tcommon
from tpu_compressed_dp_torch.models import resnet9 as tres
from tpu_compressed_dp_torch.models import transformer as ttf
from tpu_compressed_dp_torch.parallel import dp as tdp
from tpu_compressed_dp_torch.train import guard as tguard
from tpu_compressed_dp_torch.train import lm_step as tlm
from tpu_compressed_dp_torch.train import optim as toptim
from tpu_compressed_dp_torch.train import step as tstep
from tpu_compressed_dp_torch.train.state import TrainState as TState
from tpu_compressed_dp_torch.utils import chaos as tchaos
from tpu_compressed_dp_torch.utils import meters as tmeters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("loss_scale", "good_steps", "skips", "total_skipped", "last_good_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small in-process steps: under
    the tier-1 run's parallel workers, a thread per core in every worker
    oversubscribes the machine, and small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ state machine

def _same_state(t, j):
    for f in FIELDS:
        want = np.asarray(getattr(j, f))
        got = np.asarray(getattr(t, f))
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        assert got.tobytes() == want.tobytes(), (f, got, want)


@pytest.mark.parametrize("scaling", [True, False], ids=["scaling", "identity"])
def test_state_machine_bitwise(scaling):
    rng = np.random.default_rng(7 if scaling else 8)
    kw = dict(init_scale=2.0 ** 15, backoff=0.5, growth=2.0, growth_interval=3,
              max_consecutive_skips=4, loss_scaling=scaling)
    cfg_j, cfg_t = jguard.GuardConfig(**kw), tguard.GuardConfig(**kw)
    gs_j, gs_t = jguard.init_guard_state(cfg_j), tguard.init_guard_state(cfg_t)
    _same_state(gs_t, gs_j)
    # bursts of vetoes (long enough to reach the scale's floor of 1) between
    # runs of good steps
    verdicts = []
    while len(verdicts) < 200:
        verdicts += [bool(rng.random() < 0.6)] * int(rng.integers(1, 20))
    for i, ok in enumerate(verdicts):
        new_step = i + 1
        assert tguard.schedule_step(cfg_t, gs_t, new_step) == \
            int(jguard.schedule_step(cfg_j, gs_j, jnp.asarray(new_step, jnp.int32)))
        gs_j = jguard.update_guard(cfg_j, gs_j, jnp.asarray(ok), jnp.asarray(new_step, jnp.int32))
        gs_t = tguard.update_guard(cfg_t, gs_t, ok, new_step)
        _same_state(gs_t, gs_j)
        m_j = {k: float(v) for k, v in jguard.guard_metrics(gs_j).items()}
        m_t = tguard.guard_metrics(gs_t)
        assert m_t == m_j
        try:
            jguard.check_guard_metrics(m_j, cfg_j)
            err_j = None
        except jguard.GuardExceeded as e:
            err_j = str(e)
        try:
            tguard.check_guard_metrics(m_t, cfg_t)
            err_t = None
        except tguard.GuardExceeded as e:
            err_t = str(e)
        assert err_t == err_j
    # the scale reached its floor and grew back from it
    assert min(float(np.asarray(v)) for v in [gs_t.loss_scale]) >= 1.0
    # the checkpoint form round-trips
    back = tguard.guard_from_dict(tguard.guard_to_dict(gs_t))
    _same_state(back, gs_j)
    # off: no state, and the schedule reads the raw step
    assert tguard.init_guard_state(None) == () and tguard.schedule_step(None, (), 5) == 5


def test_config_checks_and_dtype_rule():
    for kw in (dict(backoff=1.0), dict(growth=1.0), dict(growth_interval=0),
               dict(init_scale=0.5), dict(max_consecutive_skips=0)):
        with pytest.raises(ValueError) as e_t:
            tguard.GuardConfig(**kw)
        with pytest.raises(ValueError) as e_j:
            jguard.GuardConfig(**kw)
        assert str(e_t.value) == str(e_j.value)
    for dt_t, dt_j in ((torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16),
                       (torch.float32, jnp.float32)):
        assert (tguard.GuardConfig.for_dtype(dt_t).loss_scaling
                == jguard.GuardConfig.for_dtype(dt_j).loss_scaling)


def test_finiteness_and_vote():
    ok = tguard.tree_all_finite(torch.tensor(1.0), {"a": torch.ones(3), "i": torch.arange(3)})
    assert bool(ok) and tguard.finite_vote(ok)
    for bad in (float("nan"), float("inf"), -float("inf")):
        x = torch.ones(1000, dtype=torch.bfloat16)
        x[517] = bad
        assert not bool(tguard.tree_all_finite({"a": torch.ones(3), "b": x}))
        assert not tguard.finite_vote(tguard.tree_all_finite(torch.tensor(bad)))
    assert bool(tguard.tree_all_finite({"e": torch.ones(0)}))


# ------------------------------------------------------------------- chaos

CHAOS_SPECS = [
    "nan", "inf,target=loss,every=50", "nan,target=grads,steps=3+7,worker=1", "crash=120",
    "crash=preempt,crash_at_step=12", "crash=mid_collective,crash_at_step=12,worker=3",
    "crash=during_remesh,crash_at_step=4", "peer_timeout=0.5", "kind=inf,steps=+2+",
    "crash_mode=preempt,crash=5", " nan , worker=2 ,",
    # the error cases
    "nan,bogus=1", "zap", "target=weights", "kind=zero", "every=-1", "crash_mode=reboot",
    "peer_timeout=-1", "steps=x",
]


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_chaos_parse_matches_jax(spec):
    try:
        want = jchaos.ChaosConfig.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tchaos.ChaosConfig.parse(spec)
        assert str(got.value) == str(e)
        return
    got = tchaos.ChaosConfig.parse(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_spec() == want.to_spec()
    assert tchaos.ChaosConfig.parse(got.to_spec()) == got
    assert got.injects_in_graph == want.injects_in_graph
    for step in range(0, 120, 7):
        assert tchaos.fires_at(got, step) == bool(jchaos.fires_at(want, jnp.asarray(step)))
    # the elastic runtime's crash modes arm an injector that fires in its
    # own phase, at JAX's step, with JAX's message
    jinj, tinj = jchaos.maybe_crash_injector(want), tchaos.maybe_crash_injector(got)
    assert (jinj is None) == (tinj is None)
    if tinj is not None and got.crash_mode != "preempt":
        for phase in ("step", "mid_collective", "during_remesh"):
            fired = []
            for inj, exc in ((jinj, jchaos.ChaosCrash), (tinj, tchaos.ChaosCrash)):
                try:
                    inj.check(max(got.crash_at_step, 0) + 1, phase=phase)
                    fired.append(None)
                except exc as e:
                    fired.append((str(e), e.mode, e.worker))
            assert fired[0] == fired[1], phase


def test_chaos_inject_and_crash_injector():
    chaos = tchaos.ChaosConfig(kind="inf", steps=(2,), worker=1)
    g = {"a": torch.ones(4), "b": torch.zeros(2, 2)}
    loss = torch.tensor(0.5)
    same_loss, same = tchaos.inject(chaos, 2, 0, loss, g)
    assert same_loss is loss and all(torch.all(torch.isfinite(v)) for v in same.values())
    _, hit = tchaos.inject(chaos, 2, 1, loss, g)
    assert all(torch.all(torch.isinf(v)) for v in hit.values())
    hit_loss, _ = tchaos.inject(dataclasses.replace(chaos, target="loss", kind="nan"), 2, 1,
                                loss, {"a": torch.ones(1)})
    assert torch.isnan(hit_loss)
    crash = tchaos.maybe_crash_injector(tchaos.ChaosConfig.parse("crash=3"))
    crash.check(2)
    with pytest.raises(tchaos.ChaosCrash):
        crash.check(4)          # >=, and once a process
    crash.check(5)
    assert tchaos.maybe_crash_injector(tchaos.ChaosConfig()) is None
    # the elastic runtime's modes fire after the dispatch, in their phase only
    mid = tchaos.CrashInjector(3, mode="mid_collective", worker=2)
    mid.check(4)
    with pytest.raises(tchaos.ChaosCrash, match="mid-collective") as e:
        mid.check(4, phase="mid_collective")
    assert (e.value.step, e.value.mode, e.value.worker) == (4, "mid_collective", 2)


def test_guard_meter_matches_jax():
    rng = np.random.default_rng(3)
    m_j, m_t = jmeters.GuardMeter(), tmeters.GuardMeter()
    skipped = 5.0
    assert m_t.summary() == m_j.summary() == {}
    m_t.update({"loss": 1.0}, 3)
    m_j.update({"loss": 1.0}, 3)
    for step in range(10, 200, 10):
        skipped += float(rng.integers(0, 4))
        metrics = {"guard/skipped": skipped, "guard/loss_scale": 2.0 ** float(rng.integers(0, 15)),
                   "guard/skip_streak": float(rng.integers(0, 3)), "loss": 2.0}
        m_j.update(metrics, step)
        m_t.update(metrics, step)
        assert m_t.summary() == m_j.summary()


# --------------------------------------------- port against itself (W = 1)

SCALE, BS = 0.125, 32
MEAN = np.asarray(jdata.CIFAR10_MEAN) * 255.0
STD = np.asarray(jdata.CIFAR10_STD) * 255.0


def _cifar_batches(n=3, bs=BS):
    rng = np.random.default_rng(0)
    return [{"input": rng.integers(0, 256, (bs, 32, 32, 3), dtype=np.uint8),
             "target": rng.integers(0, 10, (bs,)).astype(np.int32)} for _ in range(n)]


def _snapshot(state):
    return ([p.detach().clone() for p in tres.param_leaves(state.model).values()]
            + [b.clone() for b in state.model.buffers()]
            + [v.clone() for v in state.opt_state["momentum"].values()]
            + ([v.clone() for v in state.ef.values()] if isinstance(state.ef, dict) else [])
            + ([v.clone() for v in state.comp.values()] if isinstance(state.comp, dict) else []))


def _bits(t):
    t = t.detach().contiguous().view(-1)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _bitwise(a, b):
    return len(a) == len(b) and all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _port_run(cfg_kw, guard, chaos=None, steps=3, bs=8, dtype=torch.float32):
    model = tres.ResNet9(channels=tres.scaled_channels(SCALE), seed=0, dtype=dtype)
    leaves = tres.param_leaves(model)
    cfg = tdp.CompressionConfig(**cfg_kw)
    opt = toptim.SGD(lr=lambda s: np.float32(0.05) * np.float32(s), momentum=0.9,
                     nesterov=True, weight_decay=5e-4 * bs)
    # loss scaling at 2^15 on bf16, the identity on fp32
    gcfg = tguard.GuardConfig.for_dtype(dtype) if guard else None
    state = TState.create(model, opt.init(leaves), tdp.init_ef_state(leaves, cfg), seed=3,
                          comp=tdp.init_comp_state(leaves, cfg),
                          guard=tguard.init_guard_state(gcfg))
    step = tstep.make_train_step(tcommon.make_normalizing_apply_fn(MEAN, STD), opt, cfg,
                                 grad_scale=float(bs), guard_cfg=gcfg, chaos=chaos)
    held, trace = [], []
    for s, b in enumerate(_cifar_batches(steps, bs)):
        pre = _snapshot(state)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        held.append(_bitwise(pre, _snapshot(state)))
        trace.append({k: float(v) for k, v in m.items()})
    return state, trace, held


@pytest.mark.parametrize("gran", ["layerwise", "entiremodel"])
def test_guarded_fp32_step_is_unguarded_step(gran):
    kw = dict(method="topk", ratio=0.05, granularity=gran, error_feedback=True)
    s_u, t_u, _ = _port_run(kw, guard=False)
    s_g, t_g, held = _port_run(kw, guard=True)
    assert _bitwise(_snapshot(s_u), _snapshot(s_g))
    assert not any(held)
    for m_u, m_g in zip(t_u, t_g):
        assert m_g["guard/nonfinite"] == 0.0 and m_g["guard/loss_scale"] == 1.0
        for k, v in m_u.items():
            assert m_g[k] == v, k


def _port_lm_run(guard, steps=3):
    """The tiny LM (bf16 compute, float32 parameters) at W = 1, entire-model
    Top-K 5 % + EF: the final parameters, momentum and EF, and the metrics."""
    cfg = ttf.tiny_llama()
    model = ttf.Llama(cfg, seed=0)
    leaves = ttf.param_leaves(model)
    comp = tdp.CompressionConfig(method="topk", ratio=0.05, granularity="entiremodel",
                                 error_feedback=True)
    opt = toptim.SGD(lr=lambda s: np.float32(0.03), momentum=0.9)
    gcfg = tguard.GuardConfig.for_dtype(cfg.dtype) if guard else None
    state = TState.create(model, opt.init(leaves), tlm.init_lm_ef_state(cfg, leaves, comp),
                          seed=1, guard=tguard.init_guard_state(gcfg))
    step = tlm.make_lm_train_step(cfg, opt, comp, guard_cfg=gcfg)
    rng = np.random.default_rng(0)
    trace = []
    for _ in range(steps):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 65)))
        state, m = step(state, {"input": toks[:, :-1], "target": toks[:, 1:]})
        trace.append({k: float(v) for k, v in m.items()})
    return ([p.detach() for p in leaves.values()] + list(state.opt_state["momentum"].values())
            + list(state.ef.values())), trace


@pytest.mark.parametrize("model", ["resnet9", "lm"])
def test_guarded_bf16_step_is_unguarded_step(model):
    """The bf16 backward pass at the loss scale 2^15, unscaled, is the
    unscaled backward pass bitwise: scaling by a power of two commutes with
    every rounding away from overflow and underflow.  So the guarded
    step's update, EF and momentum equal the unguarded step's bit for bit."""
    if model == "lm":
        s_u, t_u = _port_lm_run(guard=False)
        s_g, t_g = _port_lm_run(guard=True)
    else:
        kw = dict(method="topk", ratio=0.05, granularity="layerwise", error_feedback=True)
        st_u, t_u, _ = _port_run(kw, guard=False, dtype=torch.bfloat16)
        st_g, t_g, _ = _port_run(kw, guard=True, dtype=torch.bfloat16)
        s_u, s_g = _snapshot(st_u), _snapshot(st_g)
    assert _bitwise(s_u, s_g)
    for m_u, m_g in zip(t_u, t_g):
        assert m_g["guard/nonfinite"] == 0.0 and m_g["guard/loss_scale"] == 32768.0
        for k, v in m_u.items():
            assert m_g[k] == v, k


@pytest.mark.parametrize("method", ["topk", "powersgd"])
def test_guarded_overlap4_is_overlap1(method):
    kw = dict(method=method, ratio=0.05, rank=2, granularity="layerwise", error_feedback=True)
    chaos = tchaos.ChaosConfig(kind="nan", steps=(1,))
    s1, t1, h1 = _port_run({**kw, "sync_overlap": 1}, True, chaos)
    s4, t4, h4 = _port_run({**kw, "sync_overlap": 4}, True, chaos)
    assert h1 == h4 == [False, True, False]
    assert _bitwise(_snapshot(s1), _snapshot(s4))
    assert t1 == t4
    assert [m["guard/nonfinite"] for m in t1] == [0.0, 1.0, 0.0]


# ------------------------------------------------ W = 2: port against JAX

LM_MESHES = {"2x1x1": (2, 1, 1), "1x1x2": (1, 1, 2)}
LM_CFG_J = jtf.tiny_llama()            # bf16 compute, float32 parameters
LM_BATCH, LM_SEQ, LM_LR = 4, 64, 0.03
BAD_STEP, STEPS = 1, 3


def _lm_params():
    return jax.tree.map(np.asarray, jtf.init_llama(LM_CFG_J, jax.random.key(0)))


def _names(tree):
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


_WORKER = r"""
import json, sys, numpy as np, torch
from tpu_compressed_dp_torch.models import common, resnet9 as tres, transformer as tf
from tpu_compressed_dp_torch.parallel import dp, mesh
from tpu_compressed_dp_torch.train import guard, lm_step, optim, schedules, step as tstep
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.utils.chaos import ChaosConfig
out, port, rank, what = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
mesh.init_process_group("cpu", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
inp = np.load(f"{out}/inputs.npz", allow_pickle=False)
meta = json.loads(str(inp["meta"]))
res = {}


def bits(ts):
    return [t.detach().contiguous().view(-1).view(torch.int32).clone()
            if t.dtype == torch.float32 else t.detach().clone() for t in ts]


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


# --- ResNet-9, W = 2, NaN into worker 1's gradients at the bad step
if what == "resnet":
    bs, half = meta["bs"], meta["bs"] // 2
    params = {k[2:]: inp[k] for k in inp.files if k.startswith("p/")}
    stats = {k[2:]: inp[k] for k in inp.files if k.startswith("s/")}


    def nest(flat):
        tree = {}
        for k, v in flat.items():
            node = tree
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return tree


    for label, kw in meta["resnet"].items():
        model = tres.ResNet9(channels=tres.scaled_channels(meta["scale"]), seed=1)
        tres.load_flax_params(model, nest(params), nest(stats))
        leaves = tres.param_leaves(model)
        sched = schedules.piecewise_linear([0, 1.5, 3], [0, 0.4, 0])
        opt = optim.SGD(lr=lambda s: sched(np.float32(s)) / np.float32(bs), momentum=0.9,
                        nesterov=True, weight_decay=5e-4 * bs)
        cfg = dp.CompressionConfig(**kw)
        comp = {k[len(f"q/{label}/"):]: torch.from_numpy(inp[k]) for k in inp.files
                if k.startswith(f"q/{label}/")} or ()
        gcfg = guard.GuardConfig(loss_scaling=False)
        state = TrainState.create(model, opt.init(leaves), dp.init_ef_state(leaves, cfg), seed=1,
                                  comp=comp, guard=guard.init_guard_state(gcfg))
        step = tstep.make_train_step(common.make_normalizing_apply_fn(meta["mean"], meta["std"]),
                                     opt, cfg, grad_scale=float(bs), guard_cfg=gcfg,
                                     chaos=ChaosConfig(kind="nan", steps=(meta["bad"],), worker=1))

        def snap():
            return bits(list(leaves.values()) + list(model.buffers())
                        + list(state.opt_state["momentum"].values()) + list(state.ef.values())
                        + (list(state.comp.values()) if isinstance(state.comp, dict) else []))

        for s in range(meta["steps"]):
            x = inp[f"x{s}"][rank * half:(rank + 1) * half]
            y = inp[f"y{s}"][rank * half:(rank + 1) * half]
            pre = snap()
            state, m = step(state, {"input": torch.from_numpy(x), "target": torch.from_numpy(y)})
            res[f"{label}/held{s}"] = np.asarray(same(pre, snap()))
            for k, v in m.items():
                res[f"{label}/m{s}/{k}"] = np.asarray(v, np.float32)
        flat_p = tres.leaves_to_flax({k: p.detach() for k, p in leaves.items()})
        flat_e = tres.leaves_to_flax(state.ef)

        def walk(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from walk(v, f"{prefix}{k}/")
                else:
                    yield f"{prefix}{k}", np.asarray(v)

        for k, v in walk(flat_p, ""):
            res[f"{label}/param/{k}"] = v
        for k, v in walk(flat_e, ""):
            res[f"{label}/ef/{k}"] = v
        if isinstance(state.comp, dict):
            for k, v in state.comp.items():
                res[f"{label}/comp/{k}"] = v.numpy()

# --- the guarded syncs on fixed gradients, vetoed (NaN on rank 1) and not
if what == "resnet":
    names = meta["sync_names"]
    for label, kw in meta["syncs"].items():
        sync = dp.make_stateful_grad_sync(dp.CompressionConfig(**kw))
        comp0 = {k[len(f"sq/{label}/"):]: torch.from_numpy(inp[k]) for k in inp.files
                 if k.startswith(f"sq/{label}/")} or ()
        for ok in (False, True):
            src = "sgbad" if not ok else "sg"
            g = {k: torch.from_numpy(inp[f"{src}/{k}"][rank].copy()) for k in names}
            e = {k: torch.from_numpy(inp[f"se/{k}"][rank].copy()) for k in names}
            synced, new_ef, new_comp, stats = sync(g, e, comp0, 0, ok=ok)
            tag = f"sync/{label}/{int(ok)}"
            res[f"{tag}/held"] = np.asarray(new_ef is e and new_comp is comp0)
            for k in names:
                res[f"{tag}/out/{k}"] = synced[k].numpy()
                res[f"{tag}/ef/{k}"] = new_ef[k].numpy()
            for k, v in (new_comp.items() if isinstance(new_comp, dict) else ()):
                res[f"{tag}/q/{k}"] = v.numpy()
            for k, v in stats.items():
                res[f"{tag}/stat/{k}"] = np.asarray(v, np.float32)

# --- the tiny LM, bf16, Inf on the loss at the bad step
if what == "lm":
    names = meta["names"]
    lm_cfg = tf.LlamaConfig(**{**meta["cfg"], "dtype": torch.bfloat16})
    lp = {k: inp[f"lm{i}"] for i, k in enumerate(names)}
    tree = {"embed": lp["embed"], "final_norm": lp["final_norm"], "lm_head": lp["lm_head"],
            "layers": [{k.split(".")[2]: v for k, v in lp.items() if k.startswith(f"layers.{i}.")}
                       for i in range(lm_cfg.n_layers)]}
    for label, (dpn, spn, tpn) in meta["lm"].items():
        g = mesh.lm_groups(dpn, spn, tpn)
        model = tf.load_jax_params(lm_cfg, tree, g.tensor_index, tpn)
        leaves = tf.param_leaves(model)
        lr = meta["lr"]
        opt = optim.SGD(lr=schedules.piecewise_linear([0, 1, 3], [0.0, lr, lr * 0.1]), momentum=0.9)
        cfg = dp.CompressionConfig()
        gcfg = guard.GuardConfig.for_dtype(torch.bfloat16, growth_interval=2)
        state = TrainState.create(model, opt.init(leaves), (), seed=1,
                                  guard=guard.init_guard_state(gcfg))
        step = lm_step.make_lm_train_step(
            lm_cfg, opt, cfg, groups=g, guard_cfg=gcfg,
            chaos=ChaosConfig(kind="inf", target="loss", steps=(meta["bad"],), worker=dpn - 1))
        rows, cols = lm_step.local_block(meta["lm_batch"], meta["lm_seq"], g)
        for s in range(meta["steps"]):
            batch = {k: torch.from_numpy(np.ascontiguousarray(inp[f"lm_{k}{s}"][rows, cols]))
                     for k in ("input", "target")}
            pre = bits(list(leaves.values()) + list(state.opt_state["momentum"].values()))
            state, m = step(state, batch)
            res[f"lm/{label}/held{s}"] = np.asarray(
                same(pre, bits(list(leaves.values()) + list(state.opt_state["momentum"].values()))))
            for k, v in m.items():
                res[f"lm/{label}/m{s}/{k}"] = np.asarray(v, np.float32)
np.savez(f"{out}/{what}_rank{rank}.npz", **res)
mesh.destroy()
"""


def spawn_world(what, out, meta, arrays):
    """Both ranks' results of the worker's ``what`` runs, one gloo world of
    two processes."""
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    np.savez(f"{out}/inputs.npz", meta=json.dumps(meta), **arrays)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, out, port, str(r), what],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=400)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(f"{out}/{what}_rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def lm_world(tmp_path_factory):
    lm_params = _lm_params()
    ds = jlmdata.SyntheticTokens(LM_CFG_J.vocab_size, LM_SEQ, LM_BATCH, seed=0)
    cfg = {f.name: getattr(LM_CFG_J, f.name) for f in dataclasses.fields(LM_CFG_J)
           if f.name != "dtype"}
    meta = dict(lm=LM_MESHES, bad=BAD_STEP, steps=STEPS, names=_names(lm_params), cfg=cfg,
                lr=LM_LR, lm_batch=LM_BATCH, lm_seq=LM_SEQ)
    arrays = {f"lm{i}": a for i, a in enumerate(jax.tree.leaves(lm_params))}
    for s in range(STEPS):
        b = ds.batch(s)
        arrays[f"lm_input{s}"], arrays[f"lm_target{s}"] = b["input"], b["target"]
    return spawn_world("lm", str(tmp_path_factory.mktemp("torch_guard_lm")), meta, arrays)


def _jax_lm(label):
    dpn, spn, tpn = LM_MESHES[label]
    mesh = jlm.make_lm_mesh(dpn, spn, tpn)
    params = _lm_params()
    opt = joptim.SGD(lr=jsched.piecewise_linear([0, 1, 3], [0.0, LM_LR, LM_LR * 0.1]),
                     momentum=0.9)
    comp = jdp.CompressionConfig()
    gcfg = jguard.GuardConfig.for_dtype(jnp.bfloat16, growth_interval=2)
    state = JState.create(params, {}, opt.init(params),
                          jlm.init_lm_ef_state(LM_CFG_J, params, comp, mesh), jax.random.key(1),
                          guard=jguard.init_guard_state(gcfg))
    step = jlm.make_lm_train_step(
        LM_CFG_J, opt, comp, mesh, donate=False, guard_cfg=gcfg,
        chaos=jchaos.ChaosConfig(kind="inf", target="loss", steps=(BAD_STEP,),
                                 worker=dpn - 1))
    ds = jlmdata.SyntheticTokens(LM_CFG_J.vocab_size, LM_SEQ, LM_BATCH, seed=0)
    trace = []
    for s in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in ds.batch(s).items()})
        trace.append({k: float(v) for k, v in m.items()})
    return trace


@pytest.mark.parametrize("label", [pytest.param(k, marks=pytest.mark.slow) if k == "1x1x2"
                                   else k for k in LM_MESHES])
def test_guarded_lm_step_matches_jax(lm_world, label):
    trace = _jax_lm(label)
    scales = [m["guard/loss_scale"] for m in trace]
    assert scales == [32768.0, 16384.0, 16384.0]
    for r in (0, 1):
        got = lm_world[r]
        pre = f"lm/{label}"
        assert [bool(got[f"{pre}/held{s}"]) for s in range(STEPS)] == [False, True, False]
        for s, m in enumerate(trace):
            mine = {k[len(f"{pre}/m{s}/"):]: float(v) for k, v in got.items()
                    if k.startswith(f"{pre}/m{s}/")}
            assert set(mine) == set(m)
            for k, v in m.items():
                if k.startswith(("guard/", "comm/")) or k in ("lr", "tokens"):
                    assert mine[k] == v, (r, s, k, mine[k], v)
            np.testing.assert_allclose(mine["loss"], m["loss"], rtol=2e-2)
