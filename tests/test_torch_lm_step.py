"""The port's LM train step and its partitioned sync against the JAX package's.

The JAX side runs ``make_grouped_grad_sync`` and ``make_lm_train_step`` under
``shard_map`` on a ``(dp, 1, 1)`` ``(data, seq, tensor)`` slice of the
virtual CPU mesh; the port runs in spawned processes (one at W = 1, two
joined by gloo at W = 2), all started together.  Both get the same numpy
gradients, EF residuals, ``tiny_llama`` parameters (float32) and token
batches.

  * The partitioned sync: two signature groups (the tensor-replicated
    embedding and norms, then the tensor-sharded projections and head, as
    the JAX step syncs them even at tensor size 1), Top-K + EF at
    entiremodel and layerwise, simulate and wire mode, exact (``off``) and
    histogram (``force``) thresholds: synced gradients, EF and every stat
    bitwise (the mean of one or two rows is order-free).
  * 3 whole steps: dense to rtol 1e-4 / atol 1e-5 on loss and parameters;
    entire-model Top-K + EF to rtol 1e-3 on the loss and at most 0.1 % of
    the kept coordinates differing (a coordinate within rounding of the
    threshold may flip), the ResNet-9 contract.
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
from jax.sharding import PartitionSpec as P

from tpu_compressed_dp.compat import shard_map
from tpu_compressed_dp.data import lm as jdata
from tpu_compressed_dp.models import transformer as jtf
from tpu_compressed_dp.ops import kernels as jk
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.train import lm_step as jlm
from tpu_compressed_dp.train import optim as joptim
from tpu_compressed_dp.train import schedules as jsched
from tpu_compressed_dp.train.state import TrainState as JState

import torch

from tpu_compressed_dp_torch.parallel import dp as tdp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_J = dataclasses.replace(jtf.tiny_llama(), dtype=jnp.float32)
WORLDS = (1, 2)
RATIO = 0.05
STEP_SEED = 1234
LR = 0.03
BATCH, SEQ, STEPS = 4, 64, 3

SYNC_CONFIGS = [dict(gran=g, mode=m, pallas=p)
                for g in ("entiremodel", "layerwise") for m in ("simulate", "wire")
                for p in ("off", "force") if p == "off" or g == "entiremodel"]
STEP_CONFIGS = {"dense": dict(method=None),
                "topk": dict(method="topk", ratio=RATIO, granularity="entiremodel",
                             error_feedback=True)}


def _sync_kw(c):
    return dict(method="topk", ratio=RATIO, granularity=c["gran"], mode=c["mode"],
                error_feedback=True)


def _params():
    return jax.tree.map(np.asarray, jtf.init_llama(CFG_J, jax.random.key(0)))


def _names(tree):
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _grads(world):
    rng = np.random.default_rng(world)
    leaves = jax.tree.leaves(_params())
    g = [rng.standard_normal((world,) + a.shape).astype(np.float32) for a in leaves]
    e = [(0.1 * rng.standard_normal((world,) + a.shape)).astype(np.float32) for a in leaves]
    return g, e


def _batches():
    ds = jdata.SyntheticTokens(CFG_J.vocab_size, SEQ, BATCH, seed=0)
    return [ds.batch(i) for i in range(STEPS)]


_WORKER = r"""
import json, sys, numpy as np, torch
from tpu_compressed_dp_torch.data import lm as lm_data
from tpu_compressed_dp_torch.models import transformer as tf
from tpu_compressed_dp_torch.ops import kernels
from tpu_compressed_dp_torch.parallel import dp, mesh
from tpu_compressed_dp_torch.train import lm_step, optim, schedules
from tpu_compressed_dp_torch.train.state import TrainState
out, port, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
if world > 1:
    mesh.init_process_group("cpu", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
inp = np.load(f"{out}/inputs_w{world}.npz")
meta = json.loads(str(inp["meta"]))
names = meta["names"]
cfg = tf.LlamaConfig(**{**meta["cfg"], "dtype": torch.float32})
res = {}
for ci, c in enumerate(meta["sync"]):
    kernels.set_pallas_mode(c["pallas"])
    sync = dp.make_grouped_grad_sync(dp.CompressionConfig(**c["kw"]), tf.is_sharded(cfg))
    grads = {k: torch.from_numpy(inp[f"g{i}"][rank]) for i, k in enumerate(names)}
    ef = {k: torch.from_numpy(inp[f"e{i}"][rank]) for i, k in enumerate(names)}
    o, e, stats = sync(grads, ef, meta["step_seed"])
    for i, k in enumerate(names):
        res[f"sync{ci}/out/{i}"] = o[k].numpy()
        res[f"sync{ci}/ef/{i}"] = e[k].numpy()
    for k, v in stats.items():
        res[f"sync{ci}/stat/{k}"] = v.numpy()
kernels.set_pallas_mode("auto")
ds = lm_data.SyntheticTokens(cfg.vocab_size, meta["seq"], meta["batch"], seed=0)
rows = lm_step.local_rows(meta["batch"], world, rank)
for label, kw in meta["steps"].items():
    model = tf.Llama(cfg)
    leaves = tf.param_leaves(model)
    with torch.no_grad():
        for i, k in enumerate(names):
            leaves[k].copy_(torch.from_numpy(inp[f"p{i}"]))
    lr = meta["lr"]
    opt = optim.SGD(lr=schedules.piecewise_linear([0, 1, 3], [0.0, lr, lr * 0.1]),
                    momentum=0.9)
    comp = dp.CompressionConfig(**kw)
    state = TrainState.create(model, opt.init(leaves), lm_step.init_lm_ef_state(cfg, leaves, comp),
                              seed=1)
    step = lm_step.make_lm_train_step(cfg, opt, comp)
    for s in range(meta["steps_n"]):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                 for k, v in ds.batch(s).items()}
        state, m = step(state, batch)
        res[f"{label}/loss{s}"] = m["loss"].numpy()
        res[f"{label}/lr{s}"] = np.float32(m["lr"])
        res[f"{label}/tokens{s}"] = m["tokens"].numpy()
        for k, v in m.items():
            if k.startswith("comm/"):
                res[f"{label}/{k}{s}"] = v.numpy()
    for i, k in enumerate(names):
        res[f"{label}/param/{i}"] = leaves[k].detach().numpy()
        if comp.error_feedback:
            res[f"{label}/ef/{i}"] = state.ef[k].numpy()
np.savez(f"{out}/w{world}_rank{rank}.npz", **res)
if world > 1:
    mesh.destroy()
"""


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    out = str(tmp_path_factory.mktemp("torch_lm_step"))
    params = _params()
    cfg = {f.name: getattr(CFG_J, f.name) for f in dataclasses.fields(CFG_J)
           if f.name != "dtype"}
    meta = dict(names=_names(params), cfg=cfg, step_seed=STEP_SEED, seq=SEQ, batch=BATCH,
                lr=LR, steps_n=STEPS, steps=STEP_CONFIGS,
                sync=[dict(pallas=c["pallas"], kw=_sync_kw(c)) for c in SYNC_CONFIGS])
    leaves = jax.tree.leaves(params)
    procs = []
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    for world in WORLDS:
        g, e = _grads(world)
        np.savez(f"{out}/inputs_w{world}.npz", meta=json.dumps(meta),
                 **{f"g{i}": a for i, a in enumerate(g)}, **{f"e{i}": a for i, a in enumerate(e)},
                 **{f"p{i}": a for i, a in enumerate(leaves)})
        port = str(free_port())
        procs += [subprocess.Popen([sys.executable, "-c", _WORKER, out, port, str(r), str(world)],
                                   env=env, cwd=REPO, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                  for r in range(world)]
    logs = [p.communicate(timeout=400)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return {w: [dict(np.load(f"{out}/w{w}_rank{r}.npz")) for r in range(w)] for w in WORLDS}


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _jax_sync(c, world):
    cfg = jdp.CompressionConfig(**_sync_kw(c))
    g, e = _grads(world)
    treedef = jax.tree.structure(_params())
    sync = jdp.make_grouped_grad_sync(cfg, ("data", "seq"), jlm._lm_is_sharded(CFG_J), "tensor")

    def f(gl, el):
        local = jax.tree.map(lambda x: x[0], gl)
        ef = jax.tree.map(lambda x: x[0], el)
        out, new_ef, _, stats = sync(local, ef, (), jax.random.key(0))
        lead = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731
        return lead(out), lead(new_ef), lead(stats)

    spec = P(("data", "seq"))
    old = jk.pallas_mode()
    jk.set_pallas_mode(c["pallas"])
    try:
        fn = jax.jit(shard_map(f, mesh=jlm.make_lm_mesh(world, 1, 1), in_specs=(spec, spec),
                               out_specs=(spec, spec, spec), check_vma=False))
        out, new_ef, stats = fn(jax.tree.unflatten(treedef, g), jax.tree.unflatten(treedef, e))
    finally:
        jk.set_pallas_mode(old)
    return ([np.asarray(x) for x in jax.tree.leaves(out)],
            [np.asarray(x) for x in jax.tree.leaves(new_ef)],
            {k: np.asarray(v) for k, v in stats.items()})


def _sync_id(c):
    return f"{c['gran']}-{c['mode']}-{c['pallas']}"


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"w{w}")
@pytest.mark.parametrize("ci", range(len(SYNC_CONFIGS)),
                         ids=[_sync_id(c) for c in SYNC_CONFIGS])
def test_partitioned_sync_bitwise_vs_jax(port_results, world, ci):
    out_j, ef_j, stats_j = _jax_sync(SYNC_CONFIGS[ci], world)
    for r in range(world):
        got = port_results[world][r]
        for i in range(len(out_j)):
            np.testing.assert_array_equal(_bits(got[f"sync{ci}/out/{i}"]), _bits(out_j[i][r]),
                                          err_msg=f"rank {r} synced leaf {i}")
            np.testing.assert_array_equal(_bits(got[f"sync{ci}/ef/{i}"]), _bits(ef_j[i][r]),
                                          err_msg=f"rank {r} EF leaf {i}")
        assert {k.split("/", 2)[2] for k in got if k.startswith(f"sync{ci}/stat/")} == \
            set(stats_j)
        for k, v in stats_j.items():
            assert float(got[f"sync{ci}/stat/{k}"]) == float(v[r]), (r, k)
    # two signature groups, so entire-model granularity makes two collectives
    want_groups = 2 if SYNC_CONFIGS[ci]["gran"] == "entiremodel" else len(out_j)
    assert float(stats_j["num_collectives"][0]) == want_groups


def _jax_steps(label, world):
    comp = jdp.CompressionConfig(**STEP_CONFIGS[label])
    mesh = jlm.make_lm_mesh(world, 1, 1)
    params = _params()
    opt = joptim.SGD(lr=jsched.piecewise_linear([0, 1, 3], [0.0, LR, LR * 0.1]), momentum=0.9)
    state = JState.create(params, {}, opt.init(params),
                          jlm.init_lm_ef_state(CFG_J, params, comp, mesh), jax.random.key(1))
    step = jlm.make_lm_train_step(CFG_J, opt, comp, mesh, donate=False)
    trace = []
    for batch in _batches():
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        trace.append({k: float(v) for k, v in m.items()})
    return state, trace


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"w{w}")
@pytest.mark.parametrize("label", list(STEP_CONFIGS))
def test_three_steps_match_jax(port_results, world, label):
    state_j, trace = _jax_steps(label, world)
    params_j = [np.asarray(x) for x in jax.tree.leaves(state_j.params)]
    dense = label == "dense"
    for r in range(world):
        got = port_results[world][r]
        for s, m in enumerate(trace):
            np.testing.assert_allclose(float(got[f"{label}/loss{s}"]), m["loss"],
                                       rtol=1e-4 if dense else 1e-3, atol=1e-5 if dense else 0)
            assert float(got[f"{label}/lr{s}"]) == m["lr"]
            assert float(got[f"{label}/tokens{s}"]) == m["tokens"] == BATCH * SEQ
            if dense:
                assert float(got[f"{label}/comm/sent_elems{s}"]) == m["comm/sent_elems"]
            else:
                sent = float(got[f"{label}/comm/sent_elems{s}"])
                assert abs(sent - m["comm/sent_elems"]) <= 0.001 * m["comm/sent_elems"]
                assert float(got[f"{label}/comm/num_collectives{s}"]) == \
                    m["comm/num_collectives"] == 2
        if dense:
            for i, want in enumerate(params_j):
                np.testing.assert_allclose(got[f"{label}/param/{i}"], want, rtol=1e-4,
                                           atol=1e-5, err_msg=f"rank {r} param {i}")
            continue
        ef_j = [np.asarray(x)[r] for x in jax.tree.leaves(state_j.ef)]
        kept_j = np.concatenate([(x == 0).ravel() for x in ef_j])
        kept_t = np.concatenate([(got[f"{label}/ef/{i}"] == 0).ravel()
                                 for i in range(len(ef_j))])
        assert kept_j.sum() > 0
        assert (kept_j != kept_t).sum() <= 0.001 * kept_j.sum()


def test_step_surface():
    from tpu_compressed_dp_torch.models import transformer as ttf
    from tpu_compressed_dp_torch.train import lm_step as tlm
    from tpu_compressed_dp_torch.train import optim as toptim

    cfg = dataclasses.replace(ttf.tiny_llama(), dtype=torch.float32)
    opt = toptim.SGD(lr=0.1)
    for kw, item in ((dict(guard_cfg=object()), "item 12"), (dict(chaos=object()), "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            tlm.make_lm_train_step(cfg, opt, tdp.CompressionConfig(), **kw)
    # PowerSGD and the chunked sync build on the data-parallel mesh; the
    # warm starts are per signature group
    for comp in (tdp.CompressionConfig(sync_overlap=2), tdp.CompressionConfig(method="powersgd")):
        assert callable(tlm.make_lm_train_step(cfg, opt, comp))
    leaves = ttf.param_leaves(ttf.Llama(cfg))
    state = tlm.init_lm_comp_state(cfg, leaves, tdp.CompressionConfig(method="powersgd"))
    assert sorted(state) == ["sig0", "sig1"] and state["sig1"]
    assert tlm.init_lm_comp_state(cfg, leaves, tdp.CompressionConfig(method="topk")) == ()
    assert tlm.local_rows(8, 4, 3) == slice(6, 8)
    with pytest.raises(ValueError):
        tlm.local_rows(6, 4, 0)


def test_merge_stats_and_clip_match_jax():
    a = {"sent_elems": torch.tensor(3.0), "sync_agree": torch.tensor(1.0)}
    b = {"sent_elems": torch.tensor(4.0), "sync_agree": torch.tensor(0.0),
         "bits": torch.tensor(64.0)}
    got = tdp.merge_stat_dicts(a, b)
    want = jdp.merge_stat_dicts({k: jnp.asarray(v.numpy()) for k, v in a.items()},
                                {k: jnp.asarray(v.numpy()) for k, v in b.items()})
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == float(want[k]), k
    assert set(tdp.merge_stat_dicts(a, {"sent_elems": torch.tensor(1.0)})) == \
        {"sent_elems", "sync_agree"}
    rng = np.random.default_rng(5)
    tree = {f"l{i}": rng.standard_normal((7, 3)).astype(np.float32) for i in range(4)}
    sharded = [True, False, True, False]
    for limit in (0.5, 100.0):
        got = tdp.make_sharded_clip(sharded, "tensor")(
            {k: torch.from_numpy(v) for k, v in tree.items()}, limit)
        clip_j = jdp.make_sharded_clip(sharded, "tensor")
        want = jax.jit(shard_map(lambda t, lim=limit: clip_j(t, lim),
                                 mesh=jlm.make_lm_mesh(1, 1, 1), in_specs=(P(),),
                                 out_specs=P(), check_vma=False))(
            {k: jnp.asarray(v) for k, v in tree.items()})
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)


def test_eval_step_matches_jax():
    from tpu_compressed_dp_torch.models import transformer as ttf
    from tpu_compressed_dp_torch.train import lm_step as tlm
    from tpu_compressed_dp_torch.train.state import TrainState as TState

    params = _params()
    batch = _batches()[0]
    state_j = JState.create(params, {}, (), (), jax.random.key(0))
    want = jlm.make_lm_eval_step(CFG_J, jlm.make_lm_mesh(1, 1, 1))(
        state_j, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = dataclasses.replace(ttf.tiny_llama(), dtype=torch.float32)
    state_t = TState.create(ttf.load_jax_params(cfg, params), {}, ())
    got = tlm.make_lm_eval_step(cfg)(state_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    assert float(got["tokens"]) == float(want["tokens"]) == BATCH * SEQ
