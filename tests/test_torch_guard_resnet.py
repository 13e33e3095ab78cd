"""The guarded ResNet-9 step and the guarded syncs at W = 2 against the JAX
package's.

The port on two gloo processes (the worker of ``tests/test_torch_guard.py``),
JAX under ``shard_map`` on 2 CPU devices.

  * The guarded syncs (simulate Top-K + EF layer-wise, wire Top-K + EF
    entire-model, PowerSGD r 2 + EF layer-wise with JAX's warm starts) on
    the same numpy gradients and EF, vetoed with a NaN in rank 1's
    gradients and not: on the veto the EF and the compressor state come
    back as the very tensors that went in (so bitwise JAX's held ones) and
    the output, computed on zeroed gradients and the EF, and every stat
    (``guard/nonfinite`` included) equal JAX's; unvetoed, as the unguarded
    sync: bitwise for Top-K, PowerSGD within 1e-5 of each leaf's largest
    entry (``tests/test_torch_lowrank.py``'s bound: another matmul order).
  * The guarded ResNet-9 step (channels_scale 0.125, batches of 32), NaN
    into worker 1's gradients at step 1 of 3, simulate Top-K + EF: the
    vetoed step leaves params, momentum, BatchNorm statistics and EF
    bitwise as they were on both ranks, the other steps move them, both
    ranks hold the same replicated bits, and the guard's counters read as
    JAX's state machine gives them (``tests/test_torch_guard.py``).
  * Under ``-m slow`` (a JAX ResNet-9 compile each, ~20 s): the same step
    against JAX's in float64 (as ``tests/test_torch_resnet9_step.py``) for
    simulate Top-K, wire Top-K and PowerSGD (JAX's warm starts injected):
    guard/* equal at every step and comm/* at the vetoed step; the other
    steps within the port's ResNet-9 step contract (loss rtol 1e-3, at
    most 0.1 % of the kept coordinates differing, PowerSGD's parameters
    within 5 % of their update).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tpu_compressed_dp.compat import shard_map
from tpu_compressed_dp.models import resnet9 as jres
from tpu_compressed_dp.models.common import init_model, make_normalizing_apply_fn
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.parallel.mesh import make_data_mesh
from tpu_compressed_dp.train import guard as jguard
from tpu_compressed_dp.train import optim as joptim
from tpu_compressed_dp.train import schedules as jsched
from tpu_compressed_dp.train import step as jstep
from tpu_compressed_dp.train.state import TrainState as JState
from tpu_compressed_dp.utils import chaos as jchaos

from test_torch_guard import BAD_STEP, BS, MEAN, SCALE, STD, STEPS, _cifar_batches, spawn_world

RESNET_CONFIGS = {
    "simulate-topk-lw": dict(method="topk", ratio=0.05, granularity="layerwise",
                             error_feedback=True),
    "wire-topk-em": dict(method="topk", ratio=0.05, granularity="entiremodel", mode="wire",
                         error_feedback=True),
    "powersgd-lw": dict(method="powersgd", rank=2, granularity="layerwise",
                        error_feedback=True),
}

def _flax_module(dtype=jnp.float32):
    return jres.ResNet9(channels={k: max(8, int(v * SCALE)) for k, v in
                                  {"prep": 64, "layer1": 128, "layer2": 256,
                                   "layer3": 512}.items()}, dtype=dtype)


def _flax_init():
    params, stats = init_model(_flax_module(), jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_comp(label, params):
    cfg = jdp.CompressionConfig(**RESNET_CONFIGS[label])
    comp = jdp.init_comp_state(params, cfg, 1)
    return {k: np.asarray(v[0]) for k, v in comp.items()} if comp else {}




def _jax_resnet(label):
    with jax.enable_x64(True):
        params, stats = _flax_init()
        f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        sched = jsched.piecewise_linear([0, 1.5, 3], [0, 0.4, 0])
        opt = joptim.SGD(lr=lambda step: sched(step / 1) / BS, momentum=0.9, nesterov=True,
                         weight_decay=5e-4 * BS)
        cfg = jdp.CompressionConfig(**RESNET_CONFIGS[label])
        mesh = make_data_mesh(2)
        gcfg = jguard.GuardConfig(loss_scaling=False)
        comp = jdp.init_comp_state(params, cfg, 2)
        state = JState.create(f64(params), f64(stats), opt.init(f64(params)),
                              jdp.init_ef_state(params, cfg, 2), jax.random.key(1),
                              comp=comp, guard=jguard.init_guard_state(gcfg))
        step = jstep.make_train_step(
            make_normalizing_apply_fn(_flax_module(jnp.float64), MEAN, STD), opt, cfg, mesh,
            grad_scale=float(BS), donate=False, guard_cfg=gcfg,
            chaos=jchaos.ChaosConfig(kind="nan", steps=(BAD_STEP,), worker=1))
        trace = []
        for b in _cifar_batches(STEPS):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            trace.append({k: float(v) for k, v in m.items()})
        return params, state, trace


SYNC_SHAPES = {"a/w": (64, 48), "b/w": (40, 30), "c/b": (300,)}
SYNC_CONFIGS = {
    "simulate-topk-lw": dict(method="topk", ratio=0.05, granularity="layerwise",
                             error_feedback=True),
    "wire-topk-em": dict(method="topk", ratio=0.05, granularity="entiremodel", mode="wire",
                         error_feedback=True),
    "powersgd-lw": dict(method="powersgd", rank=2, granularity="layerwise",
                        error_feedback=True),
}
TIER1 = ("simulate-topk-lw",)


def _sync_inputs():
    rng = np.random.default_rng(11)
    g = {k: rng.standard_normal((2,) + sh).astype(np.float32) for k, sh in SYNC_SHAPES.items()}
    e = {k: (0.1 * rng.standard_normal((2,) + sh)).astype(np.float32)
         for k, sh in SYNC_SHAPES.items()}
    bad = {k: v.copy() for k, v in g.items()}
    bad["a/w"][1, 5, 7] = np.nan          # rank 1's gradient: the veto
    return g, bad, e


def _nest2(flat):
    out = {}
    for k, v in flat.items():
        a, b = k.split("/")
        out.setdefault(a, {})[b] = v
    return out


def _sync_comp(label):
    g, _, _ = _sync_inputs()
    comp = jdp.init_comp_state(_nest2({k: v[0] for k, v in g.items()}),
                               jdp.CompressionConfig(**SYNC_CONFIGS[label]), 1)
    return {k: np.asarray(v[0]) for k, v in comp.items()} if comp else {}


def _world(tmp_path_factory, labels, name):
    params, stats = _flax_init()
    g, bad, e = _sync_inputs()
    meta = dict(resnet={k: RESNET_CONFIGS[k] for k in labels}, bs=BS, scale=SCALE,
                bad=BAD_STEP, steps=STEPS, mean=MEAN.tolist(), std=STD.tolist(),
                syncs=SYNC_CONFIGS if name == "tier1" else {}, sync_names=list(SYNC_SHAPES))
    arrays = {f"p/{k}": v for k, v in _flat(params).items()}
    arrays.update({f"s/{k}": v for k, v in _flat(stats).items()})
    for label in labels:
        arrays.update({f"q/{label}/{k}": v for k, v in _jax_comp(label, params).items()})
    for s, b in enumerate(_cifar_batches(STEPS)):
        arrays[f"x{s}"], arrays[f"y{s}"] = b["input"], b["target"]
    for k in SYNC_SHAPES:
        arrays[f"sg/{k}"], arrays[f"sgbad/{k}"], arrays[f"se/{k}"] = g[k], bad[k], e[k]
    for label in SYNC_CONFIGS:
        arrays.update({f"sq/{label}/{k}": v for k, v in _sync_comp(label).items()})
    return spawn_world("resnet", str(tmp_path_factory.mktemp(f"torch_guard_{name}")), meta,
                       arrays)


@pytest.fixture(scope="module")
def port_world(tmp_path_factory):
    return _world(tmp_path_factory, TIER1, "tier1")


@pytest.fixture(scope="module")
def port_world_slow(tmp_path_factory):
    return _world(tmp_path_factory, list(RESNET_CONFIGS), "slow")


def _jax_guarded_sync(label, ok):
    cfg = jdp.CompressionConfig(**SYNC_CONFIGS[label])
    g, bad, e = _sync_inputs()
    comp = _sync_comp(label)
    sync = jdp.make_grad_sync(cfg, "data")

    def f(gl, el, cl):
        local = jax.tree.map(lambda x: x[0], gl)
        out, new_ef, new_comp, stats = sync(local, jax.tree.map(lambda x: x[0], el),
                                            jax.tree.map(lambda x: x[0], cl),
                                            jax.random.key(0), ok=jnp.asarray(ok))
        lead = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731
        return lead(out), lead(new_ef), lead(new_comp), lead(stats)

    tiled = {k: np.tile(v[None], (2, 1, 1)) for k, v in comp.items()}
    fn = jax.jit(shard_map(f, mesh=make_data_mesh(2), in_specs=(P("data"),) * 3,
                           out_specs=(P("data"),) * 4, check_vma=False))
    out, new_ef, new_comp, stats = fn(_nest2(g if ok else bad), _nest2(e), tiled)
    flat = lambda t: {"/".join(k.key for k in p): np.asarray(v)  # noqa: E731
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    return flat(out), flat(new_ef), {k: np.asarray(v) for k, v in new_comp.items()}, \
        {k: np.asarray(v) for k, v in stats.items()}


@pytest.mark.parametrize("ok", [False, True], ids=["vetoed", "applied"])
@pytest.mark.parametrize("label", list(SYNC_CONFIGS))
def test_guarded_sync_w2_matches_jax(port_world, label, ok):
    out_j, ef_j, comp_j, stats_j = _jax_guarded_sync(label, ok)
    _, _, e = _sync_inputs()
    psgd = SYNC_CONFIGS[label]["method"] == "powersgd"
    tag = f"sync/{label}/{int(ok)}"
    for r in (0, 1):
        got = port_world[r]
        assert bool(got[f"{tag}/held"]) == (not ok)
        for k in SYNC_SHAPES:
            want, mine = out_j[k][r], got[f"{tag}/out/{k}"]
            if psgd:
                np.testing.assert_allclose(mine, want, rtol=0,
                                           atol=1e-5 * np.abs(want).max(), err_msg=k)
            else:
                np.testing.assert_array_equal(mine.view(np.uint32), want.view(np.uint32), k)
            if not ok:   # held: the input EF, bitwise, as JAX's select gives
                np.testing.assert_array_equal(got[f"{tag}/ef/{k}"].view(np.uint32),
                                              e[k][r].view(np.uint32), k)
            np.testing.assert_allclose(got[f"{tag}/ef/{k}"], ef_j[k][r], rtol=0,
                                       atol=(1e-5 * np.abs(ef_j[k][r]).max()) if psgd else 0)
        for k, v in comp_j.items():
            np.testing.assert_allclose(got[f"{tag}/q/{k}"], v[r], rtol=0,
                                       atol=0 if not ok else 1e-5 * np.abs(v[r]).max())
        mine = {key[len(f"{tag}/stat/"):]: float(v) for key, v in got.items()
                if key.startswith(f"{tag}/stat/")}
        assert mine == {k: float(v[r]) for k, v in stats_j.items()}
        assert mine["guard/nonfinite"] == (0.0 if ok else 1.0)


@pytest.mark.parametrize("label", TIER1)
def test_guarded_resnet9_w2_holds(port_world, label):
    """The port alone: the vetoed step holds every rank's state bitwise, the
    others move it, the guard's counters and both ranks' replicated bits."""
    for r in (0, 1):
        got = port_world[r]
        assert [bool(got[f"{label}/held{s}"]) for s in range(STEPS)] == [False, True, False]
        m = [{k[len(f"{label}/m{s}/"):]: float(v) for k, v in got.items()
              if k.startswith(f"{label}/m{s}/")} for s in range(STEPS)]
        assert [x["guard/nonfinite"] for x in m] == [0.0, 1.0, 0.0]
        assert [x["guard/skipped"] for x in m] == [0.0, 1.0, 1.0]
        assert [x["guard/last_good_step"] for x in m] == [1.0, 1.0, 3.0]
        assert all(np.isfinite(x["loss"]) for x in m)
        assert all(np.all(np.isfinite(v)) for k, v in got.items() if k.startswith(f"{label}/ef/"))
    for k in port_world[0]:
        if k.startswith(f"{label}/param/"):
            np.testing.assert_array_equal(port_world[0][k], port_world[1][k], err_msg=k)


@pytest.mark.slow
@pytest.mark.parametrize("label", list(RESNET_CONFIGS))
def test_guarded_resnet9_w2_matches_jax(port_world_slow, label):
    port_world = port_world_slow
    p0, state_j, trace = _jax_resnet(label)
    for r in (0, 1):
        got = port_world[r]
        assert [bool(got[f"{label}/held{s}"]) for s in range(STEPS)] == [False, True, False]
        for s, m in enumerate(trace):
            mine = {k[len(f"{label}/m{s}/"):]: float(v) for k, v in got.items()
                    if k.startswith(f"{label}/m{s}/")}
            assert set(mine) == set(m)
            for k, v in m.items():
                if k.startswith("guard/") or (s == BAD_STEP and k.startswith("comm/")):
                    assert mine[k] == v, (r, s, k, mine[k], v)
            np.testing.assert_allclose(mine["loss"], m["loss"], rtol=1e-3)
            if s != BAD_STEP:
                sent = mine["comm/sent_elems"]
                assert abs(sent - m["comm/sent_elems"]) <= 0.001 * m["comm/sent_elems"]
        assert trace[BAD_STEP]["guard/nonfinite"] == 1.0
        assert trace[BAD_STEP]["guard/skipped"] == 1.0
    # the replicated state is the same bits on both ranks
    for k in port_world[0]:
        if k.startswith(f"{label}/param/") or k.startswith(f"{label}/comp/"):
            np.testing.assert_array_equal(port_world[0][k], port_world[1][k], err_msg=k)
    for r in (0, 1):
        got = port_world[r]
        if RESNET_CONFIGS[label]["method"] == "topk":
            ef_j = _flat(jax.tree.map(lambda e: np.asarray(e)[r], state_j.ef))
            kept_j = np.concatenate([(ef_j[k] == 0).ravel() for k in ef_j])
            kept_t = np.concatenate([(got[f"{label}/ef/{k}"] == 0).ravel() for k in ef_j])
            assert kept_j.sum() > 0
            assert (kept_j != kept_t).sum() <= 0.001 * kept_j.sum()
        else:
            want_p, start = _flat(state_j.params), _flat(p0)
            for k, v in want_p.items():
                gap = np.abs(got[f"{label}/param/{k}"] - v).max()
                assert gap <= 0.05 * np.abs(v - start[k]).max() + 1e-7, (k, gap)
