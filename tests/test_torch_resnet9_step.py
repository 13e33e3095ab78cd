"""The port's ResNet-9 training slice against the JAX package's.

Both packages start from the same flax-initialised parameters (carried into
the port by ``load_flax_params``) at channels_scale 0.125 and see the same
numpy-seeded uint8 batches of 32.  Tolerances, and why:

  * dense: logits, loss, gradients, BatchNorm statistics and the parameters
    after 3 SGD steps to rtol 1e-4 / atol 1e-5 -- the two frameworks sum
    convolutions and reductions in different orders;
  * Top-K + EF, in simulate and in wire mode: loss to rtol 1e-3 and at most
    0.1 % of the kept coordinates differing after 3 steps -- a coordinate
    within rounding of the threshold may flip between the two runs.

The JAX side computes its gradients in float64 (``jax.enable_x64``, the
module at ``dtype=float64``; the step still compresses and reduces in
float32).  Its float32 gradients on the CPU are not a usable reference: for
this net they differ from its own float64 gradients by up to ~5 % of a
leaf's largest entry in the first layers (``prep``, ``layer1``), while the
port's float32 gradients agree with the float64 ones to ~1e-6.

Also here: the port imports nothing of JAX.  (The entry point's drives on
the CPU are in ``tests/test_torch_dawn_drive.py``.)
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_compressed_dp.data import cifar10 as jdata
from tpu_compressed_dp.models import resnet9 as jres
from tpu_compressed_dp.models.common import init_model, make_normalizing_apply_fn
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.parallel.mesh import make_data_mesh
from tpu_compressed_dp.train import optim as joptim
from tpu_compressed_dp.train import schedules as jsched
from tpu_compressed_dp.train import step as jstep
from tpu_compressed_dp.train.state import TrainState as JState

import torch

from tpu_compressed_dp_torch.data import cifar10 as tdata
from tpu_compressed_dp_torch.models import common as tcommon
from tpu_compressed_dp_torch.models import resnet9 as tres
from tpu_compressed_dp_torch.parallel import dp as tdp
from tpu_compressed_dp_torch.train import optim as toptim
from tpu_compressed_dp_torch.train import schedules as tsched
from tpu_compressed_dp_torch.train import step as tstep
from tpu_compressed_dp_torch.train.state import TrainState as TState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 32
SCALE = 0.125
MEAN = np.asarray(jdata.CIFAR10_MEAN) * 255.0
STD = np.asarray(jdata.CIFAR10_STD) * 255.0


def _batches(n: int = 3):
    rng = np.random.default_rng(0)
    return [{"input": rng.integers(0, 256, (BS, 32, 32, 3), dtype=np.uint8),
             "target": rng.integers(0, 10, (BS,)).astype(np.int32)} for _ in range(n)]


def _flax_module(dtype=jnp.float32):
    return jres.ResNet9(channels={k: max(8, int(v * SCALE)) for k, v in
                                  {"prep": 64, "layer1": 128, "layer2": 256,
                                   "layer3": 512}.items()}, dtype=dtype)


def _flax_init():
    module = _flax_module()
    params, stats = init_model(module, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    return module, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _port_model(params, stats):
    model = tres.ResNet9(channels=tres.scaled_channels(SCALE), seed=1, device="cpu")
    tres.load_flax_params(model, params, stats)
    return model


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, rtol=1e-4, atol=1e-5):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _port_stats(model):
    return {k.replace(".", "/"): v.numpy() for k, v in model.named_buffers()}


def _sgd_pair():
    sched_j = jsched.piecewise_linear([0, 1.5, 3], [0, 0.4, 0])
    sched_t = tsched.piecewise_linear([0, 1.5, 3], [0, 0.4, 0])
    kw = dict(momentum=0.9, nesterov=True, weight_decay=5e-4 * BS)
    opt_j = joptim.SGD(lr=lambda step: sched_j(step / 1) / BS, **kw)
    opt_t = toptim.SGD(lr=lambda step: sched_t(np.float32(step)) / np.float32(BS), **kw)
    return opt_j, opt_t


def test_forward_and_grads_match():
    module, params, stats = _flax_init()
    model = _port_model(params, stats)
    batch = _batches(1)[0]
    apply_j = make_normalizing_apply_fn(module, MEAN, STD)

    def loss_j(p):
        logits, new_bs = apply_j(p, stats, jnp.asarray(batch["input"]), True, {})
        return jstep.cross_entropy_sum(logits, jnp.asarray(batch["target"])) / BS, (logits, new_bs)

    loss_jv, (logits_j, bs_j) = jax.jit(loss_j)(params)
    with jax.enable_x64(True):
        apply_64 = make_normalizing_apply_fn(_flax_module(jnp.float64), MEAN, STD)
        stats64 = _f64(stats)

        def loss_64(p):
            logits, _ = apply_64(p, stats64, jnp.asarray(batch["input"]), True, {})
            return jstep.cross_entropy_sum(logits, jnp.asarray(batch["target"])) / BS

        grads_j = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_64))(_f64(params)))
    apply_t = tcommon.make_normalizing_apply_fn(MEAN, STD)
    leaves = tres.param_leaves(model)
    logits_t = apply_t(model, torch.from_numpy(batch["input"]), True)
    loss_t = tstep.cross_entropy_sum(logits_t, torch.from_numpy(batch["target"])) / BS
    grads_t = torch.autograd.grad(loss_t, list(leaves.values()))
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_jv), rtol=1e-4, atol=1e-5)
    _close(_flat(tres.leaves_to_flax(dict(zip(leaves, grads_t)))), _flat(grads_j))
    _close(_port_stats(model), _flat(bs_j))
    # the port's leaf order is jax.tree.flatten's
    assert list(leaves) == list(_flat(params))


def _run_both(cfg_kw, steps=3, clip_sent_norm=0.0):
    with jax.enable_x64(True):
        return _run_both_x64(cfg_kw, steps, clip_sent_norm)


def _run_both_x64(cfg_kw, steps, clip_sent_norm=0.0):
    _, params, stats = _flax_init()
    model = _port_model(params, stats)
    module = _flax_module(jnp.float64)
    params, stats = _f64(params), _f64(stats)
    opt_j, opt_t = _sgd_pair()
    cfg_j = jdp.CompressionConfig(**cfg_kw)
    cfg_t = tdp.CompressionConfig(**cfg_kw)
    mesh = make_data_mesh(1)
    state_j = JState.create(params, stats, opt_j.init(params),
                            jdp.init_ef_state(params, cfg_j, 1), jax.random.key(1))
    step_j = jstep.make_train_step(make_normalizing_apply_fn(module, MEAN, STD), opt_j,
                                   cfg_j, mesh, grad_scale=float(BS), donate=False,
                                   clip_sent_norm=clip_sent_norm)
    leaves = tres.param_leaves(model)
    state_t = TState.create(model, opt_t.init(leaves), tdp.init_ef_state(leaves, cfg_t))
    step_t = tstep.make_train_step(tcommon.make_normalizing_apply_fn(MEAN, STD), opt_t, cfg_t,
                                   grad_scale=float(BS), clip_sent_norm=clip_sent_norm)
    trace = []
    for batch in _batches(steps):
        state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()})
        state_t, m_t = step_t(state_t, {k: torch.from_numpy(v) for k, v in batch.items()})
        trace.append((m_j, m_t))
    return state_j, state_t, trace


def test_dense_three_steps_match():
    state_j, state_t, trace = _run_both(dict(method=None))
    for m_j, m_t in trace:
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=1e-4, atol=1e-5)
        assert float(m_t["lr"]) == float(m_j["lr"])
        assert float(m_t["comm/sent_elems"]) == float(m_j["comm/sent_elems"])
    _close(_flat(tres.leaves_to_flax(tres.param_leaves(state_t.model))),
           _flat(state_j.params))
    _close(_port_stats(state_t.model), _flat(state_j.batch_stats))
    assert state_t.step == int(state_j.step) == 3


def test_clip_sent_norm_step_matches():
    # one step of the scaled ResNet-9 with the synced-gradient clip active
    # (0.05 in mean-loss units, below the first gradient's norm), against
    # the JAX step in float64, within the dense steps' tolerance
    state_j, state_t, trace = _run_both(dict(method=None), steps=1, clip_sent_norm=0.05)
    (m_j, m_t), = trace
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=1e-4, atol=1e-5)
    _close(_flat(tres.leaves_to_flax(tres.param_leaves(state_t.model))),
           _flat(state_j.params))
    # the clip was active: the unclipped step moves the port's weights elsewhere
    _, params, stats = _flax_init()
    model = _port_model(params, stats)
    opt_t = _sgd_pair()[1]
    leaves = tres.param_leaves(model)
    cfg = tdp.CompressionConfig()
    step_t = tstep.make_train_step(tcommon.make_normalizing_apply_fn(MEAN, STD), opt_t, cfg,
                                   grad_scale=float(BS))
    batch = _batches(1)[0]
    free, _ = step_t(TState.create(model, opt_t.init(leaves), tdp.init_ef_state(leaves, cfg)),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    moved = {k: (p - p0).norm().item() for (k, p), p0 in zip(
        tres.param_leaves(state_t.model).items(), tres.param_leaves(free.model).values())}
    assert max(moved.values()) > 0


def _check_topk_ef_run(state_j, state_t, trace):
    for m_j, m_t in trace:
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=1e-3)
        sent_t, sent_j = float(m_t["comm/sent_elems"]), float(m_j["comm/sent_elems"])
        assert abs(sent_t - sent_j) <= 0.001 * sent_j
        assert float(m_t["comm/num_collectives"]) == float(m_j["comm/num_collectives"])
    ef_j = _flat(jax.tree.map(lambda e: e[0], state_j.ef))
    ef_t = _flat(tres.leaves_to_flax(state_t.ef))
    kept_j = np.concatenate([(ef_j[k] == 0).ravel() for k in ef_j])
    kept_t = np.concatenate([(ef_t[k] == 0).ravel() for k in ef_j])
    assert kept_j.sum() > 0
    assert (kept_j != kept_t).sum() <= 0.001 * kept_j.sum()


@pytest.mark.parametrize("granularity", ["layerwise", "entiremodel"])
def test_topk_ef_three_steps_match(granularity):
    _check_topk_ef_run(*_run_both(dict(method="topk", ratio=0.05, granularity=granularity,
                                       error_feedback=True)))


@pytest.mark.parametrize("granularity", ["layerwise", "entiremodel"])
def test_wire_topk_ef_three_steps_match(granularity):
    # the wire sync's (value, index) payload at world 1; its measured bits
    # are the JAX run's exactly
    state_j, state_t, trace = _run_both(dict(method="topk", ratio=0.05, mode="wire",
                                             granularity=granularity, error_feedback=True))
    _check_topk_ef_run(state_j, state_t, trace)
    for m_j, m_t in trace:
        assert float(m_t["comm/sent_bits"]) == float(m_j["comm/sent_bits"]) > 0


def test_ef_and_momentum_trees_carry_over():
    # a JAX-side EF / momentum tree (flax layout) lands on the port's leaves
    # in the port's layout, and comes back unchanged
    _, params, stats = _flax_init()
    model = _port_model(params, stats)
    rng = np.random.default_rng(4)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    leaves = tres.flax_to_leaves(model, tree)
    for k, p in tres.param_leaves(model).items():
        assert leaves[k].shape == p.shape and leaves[k].dtype == torch.float32
    back = _flat(tres.leaves_to_flax(leaves))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError):
        tres.flax_to_leaves(model, {"prep": tree["prep"]})


def test_cifar_pipeline_copy_matches():
    ds_j = jdata.synthetic_cifar10(n_train=64, n_test=16, seed=3)
    ds_t = tdata.synthetic_cifar10(n_train=64, n_test=16, seed=3)
    np.testing.assert_array_equal(ds_t["train"]["data"], ds_j["train"]["data"])
    it_j = jdata.Batches(jdata.pad(ds_j["train"]["data"]), ds_j["train"]["labels"], 16,
                         shuffle=True, augment=True, drop_last=True, seed=5)
    it_t = tdata.Batches(tdata.pad(ds_t["train"]["data"]), ds_t["train"]["labels"], 16,
                         shuffle=True, augment=True, drop_last=True, seed=5)
    for b_j, b_t in zip(it_j, it_t):
        np.testing.assert_array_equal(b_t["input"], b_j["input"])
        np.testing.assert_array_equal(b_t["target"], b_j["target"])


def test_schedule_bitwise():
    sched_j = jsched.piecewise_linear([0, 5, 24], [0, 0.4, 0])
    sched_t = tsched.piecewise_linear([0, 5, 24], [0, 0.4, 0])
    for step in (0, 1, 97, 490, 491, 2351, 2352, 9999):
        t = np.float32(step) / np.float32(98)
        want = np.asarray(sched_j(jnp.asarray(step, jnp.int32) / 98) / 512)
        got = sched_t(t) / np.float32(512)
        assert np.float32(got).view(np.uint32) == want.view(np.uint32), step


def test_port_imports_no_jax():
    # statically: no import of jax, flax or the JAX package anywhere in the
    # port or chip_smoke.py
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "tpu_compressed_dp_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    banned = ("jax", "flax", "tpu_compressed_dp")
    for path in files:
        tree = ast.parse(open(path, encoding="utf-8").read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split(".")[0] not in banned, f"{path} imports {mod}"
    # and at run time, in a fresh interpreter
    code = ("import pkgutil, importlib, sys, tpu_compressed_dp_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'tpu_compressed_dp_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'tpu_compressed_dp')]\n"
            "assert not bad, bad\nprint('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr[-2000:]
