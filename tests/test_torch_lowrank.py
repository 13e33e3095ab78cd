"""The port's PowerSGD (``ops/lowrank.py`` and the stateful sync of
``parallel/dp.py``) against the JAX package's, on the CPU.

Both sides take the same numpy gradients, EF residuals and warm starts
(the JAX ``init_comp_state`` draws, carried into the port's compressor
state).  Tolerances, and why:

  * ``powersgd_dims`` / ``powersgd_group_bits`` / the payload widths and
    every ``comm`` stat: exactly equal (integer arithmetic);
  * ``gram_schmidt``, ``powersgd_approx`` and the sync's synced gradient,
    EF residual and new warm start: within 1e-5 of each tensor's largest
    |entry| -- the factor products are summed in other orders by the two
    frameworks, and each sync rank sums its own products before the mean;
  * the sync at W = 2 (two processes on a gloo group) against the JAX
    engine on 2 devices, the sync at W = 1 on the ranks' mean gradient
    against the JAX engine on 1 device and against the W = 2 result, all
    within 1e-5 of the largest |entry| (the last is the engine's
    psum-linearity: every nonlinear step follows a mean);
  * a 3-step PowerSGD + EF training run of the scaled ResNet-9 against the
    JAX step (float64 gradients, as ``tests/test_torch_resnet9_step.py``):
    every step's loss to rtol 1e-4 and the weights after the first step to
    rtol 1e-4 / atol 1e-5, as the dense steps; after three steps the
    weights, EF residuals and warm starts within 5 % of each leaf's update,
    largest |EF| and largest |Q|.  PowerSGD + EF carries rounding forward
    and magnifies it: run against itself, the port's 3-step weights move by
    up to 27 % of their update when the initial weights move by 1e-6 of
    themselves, and the float32 differences of the two frameworks' first
    gradients (~4e-6 of each leaf) leave layer-wise weights up to 2.1 % of
    their update and EF up to 3.8 % of its largest entry apart after the
    third step.

The port flattens each leaf in the flax layout's element order before the
``[m, n2]`` reshape (OIHW convs as HWIO, ``(out, in)`` Dense kernels as
``(in, out)``), so its low-rank approximation is the JAX one's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tpu_compressed_dp.compat import shard_map
from tpu_compressed_dp.ops import compressors as jc
from tpu_compressed_dp.ops import lowrank as jlr
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.parallel.mesh import make_data_mesh

import torch

from tpu_compressed_dp_torch.models import common as tcommon
from tpu_compressed_dp_torch.ops import compressors as tc
from tpu_compressed_dp_torch.ops import lowrank as tlr
from tpu_compressed_dp_torch.parallel import dp as tdp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
REL = 1e-5
STEP_SHARE = 0.05
# flax-layout leaves: a conv kernel (HWIO), a Dense kernel and its bias, a
# BatchNorm scale; sorted, as jax.tree.flatten orders them
SHAPES = {"bn/scale": (8,), "conv/kernel": (3, 3, 4, 8), "dense/bias": (30,),
          "dense/kernel": (20, 30)}
CONFIGS = [
    dict(granularity="layerwise", error_feedback=True, rank=4),
    dict(granularity="entiremodel", error_feedback=True, rank=4, check_sync=True),
    dict(granularity="bucketed", error_feedback=True, rank=2, bucket_mb=0.001),
    dict(granularity="layerwise", error_feedback=False, rank=1),
]
IDS = ["layerwise-ef-r4", "entiremodel-ef-r4-check", "bucketed-ef-r2", "layerwise-noef-r1"]


def _nest(flat):
    out = {}
    for path, v in flat.items():
        a, b = path.split("/")
        out.setdefault(a, {})[b] = v
    return out


def _inputs():
    rng = np.random.default_rng(0)
    g = {k: rng.standard_normal((WORLD,) + s).astype(np.float32) for k, s in SHAPES.items()}
    e = {k: (0.1 * rng.standard_normal((WORLD,) + s)).astype(np.float32)
         for k, s in SHAPES.items()}
    return g, e


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=REL * np.abs(want).max() + 1e-30, err_msg=what)


def _jcfg(c):
    return jdp.CompressionConfig(method="powersgd", **c)


def _jax_comp(c):
    """The JAX warm starts (one per compressed group), as numpy."""
    g, _ = _inputs()
    comp = jdp.init_comp_state(_nest({k: v[0] for k, v in g.items()}), _jcfg(c))
    return {k: np.asarray(v) for k, v in comp.items()} if comp else {}


def _jax_sync(c, g=None, e=None):
    """The JAX engine on a mesh of as many devices as the inputs' leading
    axis (the ranks)."""
    cfg = _jcfg(c)
    if g is None:
        g, e = _inputs()
    world = next(iter(g.values())).shape[0]
    comp = _jax_comp(c)
    sync = jdp.make_grad_sync(cfg, "data")

    def f(gl, el, cl):
        local = jax.tree.map(lambda x: x[0], gl)
        ef = jax.tree.map(lambda x: x[0], el) if cfg.error_feedback else ()
        out, new_ef, new_comp, stats = sync(local, ef, jax.tree.map(lambda x: x[0], cl),
                                            jax.random.key(0))
        lead = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731
        return lead(out), lead(new_ef), lead(new_comp), lead(stats)

    tiled = {k: np.tile(v[None], (world, 1, 1)) for k, v in comp.items()}
    fn = jax.jit(shard_map(f, mesh=make_data_mesh(world), in_specs=(P("data"),) * 3,
                           out_specs=(P("data"),) * 4, check_vma=False))
    out, new_ef, new_comp, stats = fn(_nest(g), _nest(e), tiled)
    flat = lambda t: {"/".join(k.key for k in p): np.asarray(v)  # noqa: E731
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    return flat(out), flat(new_ef), {k: np.asarray(v) for k, v in new_comp.items()}, \
        {k: np.asarray(v) for k, v in stats.items()}


def _port_tree(flax_leaves):
    return {k: torch.from_numpy(np.ascontiguousarray(tcommon.to_torch_layout(k, v)))
            for k, v in flax_leaves.items()}


def _port_sync(c, grads, ef, comp):
    cfg = tdp.CompressionConfig(method="powersgd", **c)
    return tdp.make_stateful_grad_sync(cfg)(
        _port_tree(grads), _port_tree(ef) if cfg.error_feedback else (),
        {k: torch.from_numpy(v) for k, v in comp.items()}, 0)


def _flax_of(tree):
    return {k: tcommon.to_flax_layout(k, v.numpy()) for k, v in tree.items()}


# one worker process: every config in turn, results to <out>/rank<r>.npz
_WORKER = r"""
import sys, numpy as np, torch
sys.path.insert(0, sys.argv[5])
import test_torch_lowrank as t
from tpu_compressed_dp_torch.parallel import mesh
out, port, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
mesh.init_process_group("cpu", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
inp = np.load(f"{out}/inputs.npz")
res = {}
for ci, c in enumerate(t.CONFIGS):
    grads = {k: inp[f"g_{k}"][rank] for k in t.SHAPES}
    ef = {k: inp[f"e_{k}"][rank] for k in t.SHAPES}
    comp = {k[len(f"q{ci}_"):]: inp[k] for k in inp.files if k.startswith(f"q{ci}_")}
    o, e, q, stats = t._port_sync(c, grads, ef, comp)
    for k, v in t._flax_of(o).items():
        res[f"{ci}/out/{k}"] = v
    if c["error_feedback"]:
        for k, v in t._flax_of(e).items():
            res[f"{ci}/ef/{k}"] = v
    for k, v in (q or {}).items():
        res[f"{ci}/q/{k}"] = v.numpy()
    for k, v in stats.items():
        res[f"{ci}/stat/{k}"] = v.numpy()
np.savez(f"{out}/rank{rank}.npz", **res)
mesh.destroy()
"""


@pytest.fixture(scope="module")
def port_w2(tmp_path_factory):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    out = str(tmp_path_factory.mktemp("torch_lowrank"))
    g, e = _inputs()
    qs = {f"q{ci}_{k}": v for ci, c in enumerate(CONFIGS) for k, v in _jax_comp(c).items()}
    np.savez(f"{out}/inputs.npz", **{f"g_{k}": v for k, v in g.items()},
             **{f"e_{k}": v for k, v in e.items()}, **qs)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = str(free_port())
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, out, port, str(r), str(WORLD),
                               tests_dir], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(f"{out}/rank{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("rank", [1, 2, 4, 7])
def test_dims_and_bits(rank):
    for n in (1, 2, 8, 30, 100, 288, 600, 1727, 65536, 2359296, 102760448, 134301514):
        assert tlr.powersgd_dims(n, rank) == jlr.powersgd_dims(n, rank), n
        assert tlr.powersgd_group_bits(n, rank) == jlr.powersgd_group_bits(n, rank), n
        assert tc.payload_bits_per_elem("powersgd", rank=rank, n=n) == \
            jc.payload_bits_per_elem("powersgd", rank=rank, n=n), n
    # VGG16's fc1 at rank 4: 81,100 words a factor pair
    assert tlr.powersgd_dims(102_760_448, 4) == (10137, 10138, 4)
    assert tlr.powersgd_group_bits(102_760_448, 4) == 32.0 * 81_100


@pytest.mark.parametrize("shape", [(50, 1), (50, 4), (3, 40, 4), (6, 3)])
def test_gram_schmidt(shape):
    p = np.random.default_rng(shape[-1]).standard_normal(shape).astype(np.float32)
    if shape == (6, 3):
        p[:, 1] = 0.0  # a zero column (a zero gradient) comes back 0, not NaN
    got = tlr.gram_schmidt(torch.from_numpy(p)).numpy()
    want = np.asarray(jlr.gram_schmidt(jnp.asarray(p)))
    assert np.isfinite(got).all()
    _close(got, want, str(shape))


@pytest.mark.parametrize("n,rank", [(600, 4), (4097, 2), (30, 4)])
def test_powersgd_approx(monkeypatch, n, rank):
    """The stateless form from the JAX ``Q0``; the registry's bound form;
    a dense-fallback size returns its input."""
    flat = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    key = jax.random.key(3)
    want = np.asarray(jlr.powersgd_approx(jnp.asarray(flat), key, rank=rank))
    dims = jlr.powersgd_dims(n, rank)
    if dims is not None:
        q0 = torch.from_numpy(np.asarray(jax.random.normal(key, (dims[1], dims[2]))))
        monkeypatch.setattr(tlr, "_normal", lambda shape, seed, device: q0)
    got = tlr.powersgd_approx(torch.from_numpy(flat), 0, rank=rank).numpy()
    _close(got, want, f"n={n}")
    bound = tc.get_compressor("powersgd", rank=rank)
    assert (bound.name, bound.needs_rng, bound.is_stateful) == ("powersgd", True, True)
    assert np.array_equal(bound.fn(torch.from_numpy(flat), 0).numpy(), got)


def test_approx_is_one_warm_started_sync():
    """At W = 1, the sync from ``init_group_state(n, r, seed)`` is
    ``powersgd_approx(acc, seed)`` bitwise: the same Q0, the same products,
    and a mean over one rank."""
    acc = torch.from_numpy(np.random.default_rng(1).standard_normal(5000).astype(np.float32))
    q = tlr.init_group_state(5000, 4, 77, "cpu")
    recon, q_new, sent, bits = tlr.powersgd_group_sync(acc, q, 4, 1)
    assert torch.equal(recon, tlr.powersgd_approx(acc, 77, rank=4))
    m, n2, r = tlr.powersgd_dims(5000, 4)
    assert q_new.shape == (n2, r) and sent == r * (m + n2) and bits == 32.0 * sent
    with pytest.raises(ValueError, match="warm-start"):
        tlr.powersgd_group_sync(acc, q[:-1], 4, 1)


@pytest.mark.parametrize("ci", range(len(CONFIGS)), ids=IDS)
def test_sync_matches_jax_w1_and_w2(port_w2, ci):
    """The port's stateful sync against the JAX engine on a 2-device mesh
    (two gloo ranks), and the W = 2 result against W = 1 on the mean."""
    c = CONFIGS[ci]
    out_j, ef_j, comp_j, stats_j = _jax_sync(c)
    g, e = _inputs()
    for r in range(WORLD):
        got = port_w2[r]
        for k in SHAPES:
            _close(got[f"{ci}/out/{k}"], out_j[k][r], f"rank {r} synced {k}")
            if c["error_feedback"]:
                _close(got[f"{ci}/ef/{k}"], ef_j[k][r], f"rank {r} EF {k}")
        for k, v in comp_j.items():
            _close(got[f"{ci}/q/{k}"], v[r], f"rank {r} {k}")
        assert {key.split("/", 2)[2] for key in got if key.startswith(f"{ci}/stat/")} == \
            set(stats_j)
        for k, v in stats_j.items():
            assert float(got[f"{ci}/stat/{k}"]) == float(v[r]), (r, k)
    if c.get("check_sync"):
        assert float(port_w2[0][f"{ci}/stat/sync_agree"]) == 1.0
    assert float(port_w2[0][f"{ci}/stat/sent_bits_allgather"]) == 0.0
    # psum-linearity: W = 1 on the mean of the ranks' gradients and EF
    mean = lambda t: {k: v.mean(0, dtype=np.float64).astype(np.float32)  # noqa: E731
                      for k, v in t.items()}
    o1, e1, q1, s1 = _port_sync(c, mean(g), mean(e), _jax_comp(c))
    for k, v in _flax_of(o1).items():
        _close(port_w2[0][f"{ci}/out/{k}"], v, f"W=2 vs W=1 on the mean: {k}")
    for k, v in (q1 or {}).items():
        _close(port_w2[0][f"{ci}/q/{k}"], v.numpy(), f"W=2 vs W=1 on the mean: {k}")
    # and W = 1 against the JAX engine on one device, the same inputs
    out_1, ef_1, comp_1, stats_1 = _jax_sync(c, {k: v[None] for k, v in mean(g).items()},
                                             {k: v[None] for k, v in mean(e).items()})
    for k, v in _flax_of(o1).items():
        _close(v, out_1[k][0], f"W=1 synced {k}")
    if c["error_feedback"]:
        for k, v in _flax_of(e1).items():
            _close(v, ef_1[k][0], f"W=1 EF {k}")
    for k, v in comp_1.items():
        _close(q1[k].numpy(), v[0], f"W=1 {k}")
    for k, v in stats_1.items():
        assert float(s1[k]) == float(v[0]), k


def test_stateful_surface():
    """Stateless methods pass the compressor state through; the stateless
    sync refuses PowerSGD; the state holds one warm start per compressed
    group, the same draw on every call."""
    grads = _port_tree({k: v[0] for k, v in _inputs()[0].items()})
    cfg = tdp.CompressionConfig(method="topk", ratio=0.1)
    state = object()
    out, _, comp, _ = tdp.make_stateful_grad_sync(cfg)(grads, (), state, 0)
    ref, _, _ = tdp.make_grad_sync(cfg)(grads, (), 0)
    assert comp is state and all(torch.equal(out[k], ref[k]) for k in grads)
    assert tdp.init_comp_state(grads, cfg) == ()
    with pytest.raises(ValueError, match="make_stateful_grad_sync"):
        tdp.make_grad_sync(tdp.CompressionConfig(method="powersgd"))
    pcfg = tdp.CompressionConfig(method="powersgd", granularity="layerwise")
    a, b = tdp.init_comp_state(grads, pcfg), tdp.init_comp_state(grads, pcfg)
    # the conv kernel (group 1) and the Dense kernel (group 3) compress
    assert list(a) == ["q1", "q3"] and all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="warm-start state"):
        tdp.make_stateful_grad_sync(pcfg)(grads, (), {}, 0)


@pytest.mark.parametrize("gran", ["entiremodel",
                                  pytest.param("layerwise", marks=pytest.mark.slow)])
def test_resnet9_powersgd_ef_three_steps_match(gran):
    """Three steps of the scaled ResNet-9 with PowerSGD rank 4 + EF, the JAX
    warm starts carried across."""
    from tpu_compressed_dp.data import cifar10 as jdata
    from tpu_compressed_dp.models import resnet9 as jres
    from tpu_compressed_dp.models.common import init_model, make_normalizing_apply_fn
    from tpu_compressed_dp.train import optim as joptim
    from tpu_compressed_dp.train import step as jstep
    from tpu_compressed_dp.train.state import TrainState as JState

    from tpu_compressed_dp_torch.models import resnet9 as tres
    from tpu_compressed_dp_torch.train import optim as toptim
    from tpu_compressed_dp_torch.train import step as tstep
    from tpu_compressed_dp_torch.train.state import TrainState as TState

    bs, scale = 32, 0.125
    mean_, std_ = np.asarray(jdata.CIFAR10_MEAN) * 255.0, np.asarray(jdata.CIFAR10_STD) * 255.0
    rng = np.random.default_rng(0)
    batches = [{"input": rng.integers(0, 256, (bs, 32, 32, 3), dtype=np.uint8),
                "target": rng.integers(0, 10, (bs,)).astype(np.int32)} for _ in range(3)]
    kw = dict(momentum=0.9, nesterov=True, weight_decay=5e-4 * bs)
    cfg_kw = dict(method="powersgd", rank=4, granularity=gran, error_feedback=True)
    with jax.enable_x64(True):
        ch = tres.scaled_channels(scale)
        params, stats = init_model(jres.ResNet9(channels=ch), jax.random.key(0),
                                   jnp.zeros((1, 32, 32, 3)))
        params, stats = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)
        model = tres.ResNet9(channels=ch, seed=1)
        tcommon.load_flax_params(model, params, stats)
        f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        opt_j = joptim.SGD(lr=lambda step: 0.4 * step / 3 / bs, **kw)
        opt_t = toptim.SGD(lr=lambda step: np.float32(0.4) * np.float32(step)
                           / np.float32(3) / np.float32(bs), **kw)
        cfg_j = jdp.CompressionConfig(**cfg_kw)
        comp_j = jdp.init_comp_state(params, cfg_j, 1)
        state_j = JState.create(f64(params), f64(stats), opt_j.init(f64(params)),
                                jdp.init_ef_state(params, cfg_j, 1), jax.random.key(1),
                                comp=comp_j)
        step_j = jstep.make_train_step(
            make_normalizing_apply_fn(jres.ResNet9(channels=ch, dtype=jnp.float64),
                                      mean_, std_),
            opt_j, cfg_j, make_data_mesh(1), grad_scale=float(bs), donate=False)
        cfg_t = tdp.CompressionConfig(**cfg_kw)
        leaves = tcommon.param_leaves(model)
        comp_t = {k: torch.from_numpy(np.asarray(v[0])) for k, v in comp_j.items()}
        assert set(comp_t) == set(tdp.init_comp_state(leaves, cfg_t))
        state_t = TState.create(model, opt_t.init(leaves), tdp.init_ef_state(leaves, cfg_t),
                                comp=comp_t)
        step_t = tstep.make_train_step(tcommon.make_normalizing_apply_fn(mean_, std_),
                                       opt_t, cfg_t, grad_scale=float(bs))
        for i, batch in enumerate(batches):
            state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()})
            state_t, m_t = step_t(state_t, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
            np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=1e-4,
                                       atol=1e-5)
            for k in ("sent_elems", "sent_bits", "num_collectives"):
                assert float(m_t[f"comm/{k}"]) == float(m_j[f"comm/{k}"]), k
            assert float(m_t["comm/sent_bits_allgather"]) == 0.0
            if i == 0:
                got_p = _flat_tree(tcommon.leaves_to_flax(tcommon.param_leaves(model)))
                for k, v in _flat_tree(state_j.params).items():
                    np.testing.assert_allclose(got_p[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    p0 = _flat_tree(params)
    got_p = _flat_tree(tcommon.leaves_to_flax(tcommon.param_leaves(state_t.model)))
    got_e = _flat_tree(tcommon.leaves_to_flax(state_t.ef))
    want_e = _flat_tree(jax.tree.map(lambda x: x[0], state_j.ef))
    for k, v in _flat_tree(state_j.params).items():
        _within(got_p[k], v, STEP_SHARE * np.abs(v - p0[k]).max(), f"{gran} weights {k}")
        _within(got_e[k], want_e[k], STEP_SHARE * np.abs(want_e[k]).max(), f"{gran} EF {k}")
    assert set(state_t.comp) == set(state_j.comp)
    for k, v in state_j.comp.items():
        want = np.asarray(v[0])
        _within(state_t.comp[k].numpy(), want, STEP_SHARE * np.abs(want).max(),
                f"{gran} {k}")


def _flat_tree(t):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}


def _within(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=tol + 1e-30, err_msg=what)
