"""The port's LM on the whole ``(data, seq, tensor)`` mesh against the JAX package.

The JAX side runs under ``shard_map`` on ``make_lm_mesh(dp, sp, tp)`` of the
virtual CPU mesh; the port runs one spawned process per mesh position, joined
by gloo, one world per mesh, all started together.  Both get the same numpy
inputs: the ``tiny_llama`` parameters (vocab 256, dim 64, 4/2 heads, ffn
128, 2 layers, float32), token batches of seq 256, attention operands,
per-worker gradients and EF residuals.  Each rank takes its ``(data, seq)``
block and its tensor shard.

  * Ring attention alone (``sp = 2``), output and q/k/v gradients: rtol
    1e-5 against the JAX ring under ``shard_map``.
  * The local loss and every leaf's gradient (each worker's, this shard of
    it) at the four meshes: rtol 1e-4 / atol 1e-5 (JAX's float32 CPU
    gradients of this model agree with its float64 ones to ~1e-7, see
    ``test_torch_transformer.py``); ``--remat`` bitwise equal to no remat.
  * The partitioned sync at ``tp = 2``, the fused head and the clip over a
    tensor group: ``test_torch_lm_axes_sync.py`` (this file's worker, a
    world of its own).
  * 3 steps, dense and entire-model Top-K + EF, by ``test_torch_lm_step.py``'s
    contract.
  * PowerSGD in the LM step at ``(2, 1, 1)`` with JAX's warm starts carried
    across: within 1e-5; it raises at ``tp > 1`` as JAX does.
  * ``sync_overlap = 4`` bitwise equal to 1 at ``(1, 1, 1)``, ``(2, 1, 1)``,
    ``(1, 1, 2)`` and ``(1, 2, 1)``, the ring's backward with and without
    ``--remat`` beside the hooks' collectives.
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

from tpu_compressed_dp import compat
from tpu_compressed_dp.compat import shard_map
from tpu_compressed_dp.data import lm as jdata
from tpu_compressed_dp.models import transformer as jtf
from tpu_compressed_dp.ops import ring_attention as jra
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.train import lm_step as jlm
from tpu_compressed_dp.train import optim as joptim
from tpu_compressed_dp.train import schedules as jsched
from tpu_compressed_dp.train.state import TrainState as JState

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_J = dataclasses.replace(jtf.tiny_llama(), dtype=jnp.float32)
AXES = [(1, 2, 1), (1, 1, 2), (2, 1, 2), (1, 2, 2)]
EXTRA = [(1, 1, 1), (2, 1, 1)]            # PowerSGD and sync_overlap only
OVERLAP = [(1, 1, 1), (2, 1, 1), (1, 1, 2), (1, 2, 1)]
BATCH, SEQ, STEPS = 4, 256, 3
LR, RATIO, STEP_SEED = 0.03, 0.05, 1234
RING_SHAPE = (2, 4, SEQ, 16)              # q: B, H, T, D; K/V have 2 heads

SYNC_CONFIGS = [dict(gran=g, mode=m, transport=t)
                for g in ("entiremodel", "layerwise")
                for m, t in (("simulate", "allgather"), ("wire", "allgather"), ("wire", "sharded"),
                             ("wire", "hierarchical"))]
STEP_CONFIGS = {"dense": dict(method=None),
                "topk": dict(method="topk", ratio=RATIO, granularity="entiremodel",
                             error_feedback=True)}
PSGD_KW = dict(method="powersgd", rank=2, granularity="layerwise", error_feedback=True)
OVERLAP_KW = {"topk": dict(method="topk", ratio=RATIO, granularity="layerwise",
                           error_feedback=True),
              "powersgd": PSGD_KW,
              "topk-remat": dict(method="topk", ratio=RATIO, granularity="layerwise",
                                 error_feedback=True)}
# PowerSGD runs at tensor size 1 only; --remat (the model's, not the sync's:
# "-remat" runs the model with cfg.remat) where the ring's forward
# collectives rerun in the backward
OVERLAP_CASES = [(m, name) for m in OVERLAP for name in OVERLAP_KW
                 if (name != "powersgd" or m[2] == 1) and (name != "topk-remat" or m[1] > 1)]


def _mid(m):
    return "x".join(map(str, m))


def _sync_kw(c):
    # the hierarchical transport's two pods of one worker each: its pod and
    # column groups are subgroups of each tensor index's workers group
    return dict(method="topk", ratio=RATIO, granularity=c["gran"], mode=c["mode"],
                transport=c["transport"], error_feedback=True,
                dp_pods=2 if c["transport"] == "hierarchical" else 1)


def _params():
    return jax.tree.map(np.asarray, jtf.init_llama(CFG_J, jax.random.key(0)))


def _names(tree):
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _specs():
    return jax.tree.leaves(jtf.param_specs(CFG_J), is_leaf=lambda x: isinstance(x, P))


def _batches():
    ds = jdata.SyntheticTokens(CFG_J.vocab_size, SEQ, BATCH, seed=0)
    return [ds.batch(i) for i in range(STEPS)]


def _ring_inputs():
    rng = np.random.default_rng(7)
    b, h, t, d = RING_SHAPE
    q = rng.standard_normal((b, h, t, d)).astype(np.float32)
    k = rng.standard_normal((b, h // 2, t, d)).astype(np.float32)
    v = rng.standard_normal((b, h // 2, t, d)).astype(np.float32)
    do = rng.standard_normal((b, h, t, d)).astype(np.float32)
    return q, k, v, do


def _head_inputs():
    rng = np.random.default_rng(8)
    h = rng.standard_normal((96, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 256)) / 8.0).astype(np.float32)
    t = rng.integers(0, 256, (96,)).astype(np.int32)
    return h, w, t


def _sync_grads(workers):
    rng = np.random.default_rng(100 + workers)
    leaves = jax.tree.leaves(_params())
    g = [rng.standard_normal((workers,) + a.shape).astype(np.float32) for a in leaves]
    e = [(0.1 * rng.standard_normal((workers,) + a.shape)).astype(np.float32) for a in leaves]
    return g, e


def _jax_psgd_q(mesh_shape):
    """JAX's PowerSGD warm starts of the LM step (worker 0's; every worker
    holds the same)."""
    comp = jdp.CompressionConfig(**PSGD_KW)
    state = jlm.init_lm_comp_state(CFG_J, _params(), comp, jlm.make_lm_mesh(*mesh_shape))
    return {f"{s}/{q}": np.asarray(a)[0] for s, sub in state.items() for q, a in sub.items()}


_WORKER = r"""
import dataclasses, json, sys, numpy as np, torch
from tpu_compressed_dp_torch.models import transformer as tf
from tpu_compressed_dp_torch.ops import ring_attention as ra
from tpu_compressed_dp_torch.parallel import dp, mesh
from tpu_compressed_dp_torch.train import lm_step, optim, schedules
from tpu_compressed_dp_torch.train.state import TrainState
out, port, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dpn, spn, tpn = (int(a) for a in sys.argv[4].split("x"))
world = dpn * spn * tpn
if world > 1:
    mesh.init_process_group("cpu", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
g = mesh.lm_groups(dpn, spn, tpn)
inp = np.load(f"{out}/inputs.npz")
meta = json.loads(str(inp["meta"]))
tasks = meta["tasks"][sys.argv[4]]
names = meta["names"]
cfg = tf.LlamaConfig(**{**meta["cfg"], "dtype": torch.float32})
w = g.data_index * spn + g.seq_index
t = g.tensor_index
res = {}


def shard(name, a):
    return tf._shard(a, name, t, tpn)


def model_of(c=cfg):
    params = {k: inp[f"p{i}"] for i, k in enumerate(names)}
    tree = {"embed": params["embed"], "final_norm": params["final_norm"],
            "lm_head": params["lm_head"],
            "layers": [{k.split(".")[2]: v for k, v in params.items()
                        if k.startswith(f"layers.{i}.")} for i in range(c.n_layers)]}
    return tf.load_jax_params(c, tree, t, tpn)


def block(a):
    rows, cols = lm_step.local_block(meta["batch"], meta["seq"], g)
    return torch.from_numpy(np.ascontiguousarray(a[rows, cols]))


if "ring" in tasks:
    tl = meta["seq"] // spn
    sl = slice(g.seq_index * tl, (g.seq_index + 1) * tl)
    q, k, v, do = (torch.from_numpy(np.ascontiguousarray(inp[n][:, :, sl]))
                   for n in ("rq", "rk", "rv", "rdo"))
    for a in (q, k, v):
        a.requires_grad_(True)
    o = ra.ring_attention(q, k, v, group=g.seq)
    gq, gk, gv = torch.autograd.grad((o * do).sum(), (q, k, v))
    for n, a in (("o", o), ("dq", gq), ("dk", gk), ("dv", gv)):
        res[f"ring/{n}"] = a.detach().numpy()

if "grads" in tasks:
    x, y = block(inp["x0"]), block(inp["y0"])
    for label, c in (("plain", cfg), ("remat", dataclasses.replace(cfg, remat=True))):
        model = model_of(c)
        leaves = tf.param_leaves(model)
        loss, _ = lm_step.lm_loss(c, model, x, y, g)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        res[f"{label}/loss"] = loss.detach().numpy()
        for i, gr in enumerate(grads):
            res[f"{label}/g{i}"] = gr.numpy()
    ev = lm_step.make_lm_eval_step(cfg, g)(TrainState.create(model_of(), {}, ()),
                                           {"input": x, "target": y})
    res["eval/loss"] = ev["loss"].numpy()
    res["eval/tokens"] = ev["tokens"].numpy()

if "head" in tasks:
    h = torch.from_numpy(inp["hh"]).requires_grad_(True)
    wl = torch.from_numpy(np.ascontiguousarray(shard("lm_head", inp["hw"]))).requires_grad_(True)
    loss = tf.fused_head_xent(h, wl, torch.from_numpy(inp["ht"]), 64, tensor_group=g.tensor)
    dh, dw = torch.autograd.grad(loss, (h, wl))
    res["head/loss"], res["head/dh"], res["head/dw"] = loss.detach().numpy(), dh.numpy(), dw.numpy()
    sq = [torch.from_numpy(np.ascontiguousarray(shard(k, inp[f"g{i}"][w])))
          for i, k in enumerate(names)]
    clip = dp.make_sharded_clip(tf.is_sharded(cfg), "tensor", {"tensor": g.tensor})
    for i, a in enumerate(clip(dict(zip(names, sq)), 0.5).values()):
        res[f"clip/{i}"] = a.numpy()

for ci, kw in enumerate(meta["sync"] if "sync" in tasks else []):
    sync = dp.make_grouped_grad_sync(dp.CompressionConfig(**kw), tf.is_sharded(cfg),
                                     group=g.workers, axis_groups={"tensor": g.tensor})
    grads = {k: torch.from_numpy(np.ascontiguousarray(shard(k, inp[f"g{i}"][w])))
             for i, k in enumerate(names)}
    ef = {k: torch.from_numpy(np.ascontiguousarray(shard(k, inp[f"e{i}"][w])))
          for i, k in enumerate(names)}
    o, e, stats = sync(grads, ef, meta["step_seed"])
    for i, k in enumerate(names):
        res[f"sync{ci}/out/{i}"] = o[k].numpy()
        res[f"sync{ci}/ef/{i}"] = e[k].numpy()
    for k, v in stats.items():
        res[f"sync{ci}/stat/{k}"] = v.numpy()


def run_steps(label, kw, steps, comp_state=None, c=cfg):
    model = model_of(c)
    leaves = tf.param_leaves(model)
    lr = meta["lr"]
    opt = optim.SGD(lr=schedules.piecewise_linear([0, 1, 3], [0.0, lr, lr * 0.1]), momentum=0.9)
    comp = dp.CompressionConfig(**kw)
    state = TrainState.create(model, opt.init(leaves), lm_step.init_lm_ef_state(c, leaves, comp),
                              seed=1, comp=lm_step.init_lm_comp_state(c, leaves, comp, g))
    if comp_state is not None:
        state.comp = comp_state
    step = lm_step.make_lm_train_step(c, opt, comp, groups=g)
    for s in range(steps):
        state, m = step(state, {"input": block(inp[f"x{s}"]), "target": block(inp[f"y{s}"])})
        for k, v in m.items():
            res[f"{label}/{k}{s}"] = np.asarray(v, np.float32)
    for i, k in enumerate(names):
        res[f"{label}/param/{i}"] = leaves[k].detach().numpy()
        if comp.error_feedback:
            res[f"{label}/ef/{i}"] = state.ef[k].numpy()
    if isinstance(state.comp, dict):
        for s_key, sub in state.comp.items():
            for q_key, a in sub.items():
                res[f"{label}/comp/{s_key}/{q_key}"] = a.numpy()


for label, kw in (meta["steps"].items() if "steps" in tasks else ()):
    run_steps(label, kw, meta["steps_n"])
if "powersgd" in tasks:
    q0 = {k[len("q/"):]: torch.from_numpy(inp[k]) for k in inp.files if k.startswith("q/")}
    comp_state = {}
    for k, a in q0.items():
        s_key, q_key = k.split("/")
        comp_state.setdefault(s_key, {})[q_key] = a
    run_steps("powersgd", meta["psgd_kw"], 2, comp_state)
for name, kw in meta["overlap"].get(sys.argv[4], {}).items():
    for k in (1, 4):
        run_steps(f"overlap/{name}/k{k}", {**kw, "sync_overlap": k}, 2,
                  c=dataclasses.replace(cfg, remat=name.endswith("-remat")))
np.savez(f"{out}/{sys.argv[4]}_rank{rank}.npz", **res)
if world > 1:
    mesh.destroy()
"""


def _tasks(m):
    dpn, spn, tpn = m
    tasks = []
    if m in AXES:
        tasks += ["grads", "steps"] + (["ring"] if spn > 1 else [])
    if m == (2, 1, 1):
        tasks.append("powersgd")
    return tasks


def run_port(out, tasks):
    """Every mesh of ``tasks`` (mesh -> task names) as one spawned gloo world
    running ``_WORKER``, all started together; each rank's results."""
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    params = _params()
    cfg = {f.name: getattr(CFG_J, f.name) for f in dataclasses.fields(CFG_J)
           if f.name != "dtype"}
    meshes = list(tasks)
    meta = dict(names=_names(params), cfg=cfg, step_seed=STEP_SEED, seq=SEQ, batch=BATCH,
                lr=LR, steps_n=STEPS, steps=STEP_CONFIGS, psgd_kw=PSGD_KW,
                overlap={_mid(m): {n: OVERLAP_KW[n] for mm, n in OVERLAP_CASES if mm == m}
                         for m in OVERLAP},
                sync=[_sync_kw(c) for c in SYNC_CONFIGS],
                tasks={_mid(m): t for m, t in tasks.items()})
    q, k, v, do = _ring_inputs()
    hh, hw, ht = _head_inputs()
    g, e = _sync_grads(2)
    arrays = {f"p{i}": a for i, a in enumerate(jax.tree.leaves(params))}
    for s, b in enumerate(_batches()):
        arrays[f"x{s}"], arrays[f"y{s}"] = b["input"], b["target"]
    arrays.update(rq=q, rk=k, rv=v, rdo=do, hh=hh, hw=hw, ht=ht)
    arrays.update({f"g{i}": a for i, a in enumerate(g)})
    arrays.update({f"e{i}": a for i, a in enumerate(e)})
    arrays.update({f"q/{k}": a for k, a in _jax_psgd_q((2, 1, 1)).items()})
    np.savez(f"{out}/inputs.npz", meta=json.dumps(meta), **arrays)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = []
    for m in meshes:
        port = str(free_port())
        procs += [subprocess.Popen([sys.executable, "-c", _WORKER, out, port, str(r), _mid(m)],
                                   env=env, cwd=REPO, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                  for r in range(int(np.prod(m)))]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return {m: [dict(np.load(f"{out}/{_mid(m)}_rank{r}.npz")) for r in range(int(np.prod(m)))]
            for m in meshes}


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    return run_port(str(tmp_path_factory.mktemp("torch_lm_axes")),
                    {m: _tasks(m) for m in AXES + EXTRA})


def _coords(m, r):
    dpn, spn, tpn = m
    return r // (spn * tpn), (r // tpn) % spn, r % tpn


def _shard(a, spec, t, tpn):
    """Tensor rank ``t``'s slice of a whole leaf ``a`` under ``spec``."""
    for axis, name in enumerate(spec):
        if name == "tensor":
            n = a.shape[axis] // tpn
            a = np.take(a, np.arange(t * n, (t + 1) * n), axis=axis)
    return a


def _ranks(m):
    for r in range(int(np.prod(m))):
        d, s, t = _coords(m, r)
        yield r, d * m[1] + s, s, t


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


_ids = {"ids": _mid}


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [m for m in AXES if m[1] > 1], **_ids)
def test_ring_attention_matches_jax(port_results, m):
    q, k, v, do = (jnp.asarray(a) for a in _ring_inputs())
    spec = P(None, None, "seq", None)
    ring = shard_map(lambda a, b, c: jra.ring_attention(a, b, c, axis_name="seq"),
                     mesh=jlm.make_lm_mesh(*m), in_specs=(spec,) * 3, out_specs=spec,
                     check_vma=False)

    def f(a, b, c):
        o = ring(a, b, c)
        return jnp.sum(o * do), o

    (_, o_j), grads_j = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tl = SEQ // m[1]
    for r, _, s, _ in _ranks(m):
        got = port_results[m][r]
        sl = slice(s * tl, (s + 1) * tl)
        for name, want in (("o", o_j), ("dq", grads_j[0]), ("dk", grads_j[1]),
                           ("dv", grads_j[2])):
            want = np.asarray(want)[:, :, sl]
            np.testing.assert_allclose(got[f"ring/{name}"], want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(), err_msg=f"rank {r} {name}")


def test_ring_of_one_block_is_dense_attention():
    from tpu_compressed_dp_torch.ops import ring_attention as tra

    q, k, v, _ = (torch.from_numpy(a) for a in _ring_inputs())
    np.testing.assert_array_equal(tra.ring_attention(q, k, v).numpy(),
                                  tra.dense_causal_attention(q, k, v).numpy())


# ---------------------------------------------------------------------------
# Loss and gradients, remat, the fused head over a tensor group
# ---------------------------------------------------------------------------


def _jax_grads_fn(m):
    """``fn(params, x, y) -> (loss [workers], grads [workers, ...])``: each
    worker's local loss and gradient, as the JAX LM step takes them."""
    mesh = jlm.make_lm_mesh(*m)
    pspecs = jtf.param_specs(CFG_J)
    axes = ("data", "seq")

    def local(params, x, y):
        def loss_fn(p):
            logits = jtf.apply_llama(CFG_J, p, x, tensor_axis="tensor", seq_axis="seq")
            return jtf.vocab_parallel_xent(logits, y, tensor_axis="tensor")

        varying = jax.tree.map(lambda p: compat.pcast(p, axes, to="varying"), params)
        loss, grads = jax.value_and_grad(loss_fn)(varying)
        return loss[None], jax.tree.map(lambda a: a[None], grads)

    gspecs = jax.tree.map(lambda s: P(axes, *s), pspecs, is_leaf=lambda x: isinstance(x, P))
    return jax.jit(shard_map(local, mesh=mesh, in_specs=(pspecs, P("data", "seq"),
                                                         P("data", "seq")),
                             out_specs=(P(axes), gspecs)))


def _jax_grads(m):
    b = _batches()[0]
    loss, grads = _jax_grads_fn(m)(_params(), jnp.asarray(b["input"]), jnp.asarray(b["target"]))
    return np.asarray(loss), [np.asarray(a) for a in jax.tree.leaves(grads)]


@pytest.mark.parametrize("m", AXES, **_ids)
def test_loss_and_gradients_match_jax(port_results, m):
    loss_j, grads_j = _jax_grads(m)
    specs = _specs()
    b = _batches()[0]
    for r, w, s, t in _ranks(m):
        got = port_results[m][r]
        np.testing.assert_allclose(float(got["plain/loss"]), float(loss_j[w]), rtol=1e-5)
        for i, (gj, spec) in enumerate(zip(grads_j, specs)):
            want = _shard(gj[w], spec, t, m[2])
            np.testing.assert_allclose(got[f"plain/g{i}"], want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {r} leaf {i}")
            # remat recomputes the same operations
            np.testing.assert_array_equal(_bits(got[f"remat/g{i}"]), _bits(got[f"plain/g{i}"]))
        assert _bits(got["remat/loss"]) == _bits(got["plain/loss"])
        # the eval step: the workers' mean of the same local losses
        np.testing.assert_allclose(float(got["eval/loss"]), float(loss_j.mean()), rtol=1e-5)
        assert float(got["eval/tokens"]) == b["input"].size


# ---------------------------------------------------------------------------
# Whole steps
# ---------------------------------------------------------------------------


def _jax_steps(kw, m, steps=STEPS, comp_init=None):
    comp = jdp.CompressionConfig(**kw)
    mesh = jlm.make_lm_mesh(*m)
    params = _params()
    opt = joptim.SGD(lr=jsched.piecewise_linear([0, 1, 3], [0.0, LR, LR * 0.1]), momentum=0.9)
    state = JState.create(params, {}, opt.init(params),
                          jlm.init_lm_ef_state(CFG_J, params, comp, mesh), jax.random.key(1),
                          comp=jlm.init_lm_comp_state(CFG_J, params, comp, mesh))
    step = jlm.make_lm_train_step(CFG_J, opt, comp, mesh, donate=False)
    trace = []
    for batch in _batches()[:steps]:
        state, mt = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        trace.append({k: float(v) for k, v in mt.items()})
    return state, trace


@pytest.mark.parametrize("m", AXES, **_ids)
@pytest.mark.parametrize("label", list(STEP_CONFIGS))
def test_three_steps_match_jax(port_results, m, label):
    state_j, trace = _jax_steps(STEP_CONFIGS[label], m)
    specs = _specs()
    params_j = [np.asarray(x) for x in jax.tree.leaves(state_j.params)]
    dense = label == "dense"
    for r, w, _, t in _ranks(m):
        got = port_results[m][r]
        for s, mt in enumerate(trace):
            np.testing.assert_allclose(float(got[f"{label}/loss{s}"]), mt["loss"],
                                       rtol=1e-4 if dense else 1e-3, atol=1e-5 if dense else 0)
            assert float(got[f"{label}/lr{s}"]) == mt["lr"]
            assert float(got[f"{label}/tokens{s}"]) == mt["tokens"] == BATCH * SEQ
            sent = float(got[f"{label}/comm/sent_elems{s}"])
            if dense:
                assert sent == mt["comm/sent_elems"]
            else:
                assert abs(sent - mt["comm/sent_elems"]) <= 0.001 * mt["comm/sent_elems"]
                # one group a signature, the sharded one's counted on each
                # tensor rank
                assert float(got[f"{label}/comm/num_collectives{s}"]) == \
                    mt["comm/num_collectives"] == 1 + m[2]
        if dense:
            for i, (want, spec) in enumerate(zip(params_j, specs)):
                np.testing.assert_allclose(got[f"{label}/param/{i}"],
                                           _shard(want, spec, t, m[2]), rtol=1e-4, atol=1e-5,
                                           err_msg=f"rank {r} param {i}")
            continue
        ef_j = [_shard(np.asarray(x)[w], spec, t, m[2])
                for x, spec in zip(jax.tree.leaves(state_j.ef), specs)]
        kept_j = np.concatenate([(x == 0).ravel() for x in ef_j])
        kept_t = np.concatenate([(got[f"{label}/ef/{i}"] == 0).ravel()
                                 for i in range(len(ef_j))])
        assert kept_j.sum() > 0
        assert (kept_j != kept_t).sum() <= 0.001 * kept_j.sum()
    # the replicated leaves are the same bits on every tensor rank
    for r, w, _, t in _ranks(m):
        base = port_results[m][r - t]
        for i, sh in enumerate(jlm._lm_is_sharded(CFG_J)):
            if not sh:
                np.testing.assert_array_equal(_bits(port_results[m][r][f"{label}/param/{i}"]),
                                              _bits(base[f"{label}/param/{i}"]))


def _jax_psgd_steps(m, steps):
    """The JAX LM step's PowerSGD arithmetic, step by step: each worker's
    gradient (:func:`_jax_grads_fn`), ``make_grouped_grad_sync`` over the
    workers with the warm starts of ``init_lm_comp_state``, then SGD.  The
    JAX ``make_lm_train_step`` itself refuses PowerSGD on this JAX: its
    ``shard_map`` output check cannot infer the warm starts' replication
    over the tensor axis, even at tensor size 1 (``ROADMAP.md`` queue 3)."""
    comp = jdp.CompressionConfig(**PSGD_KW)
    mesh = jlm.make_lm_mesh(*m)
    params = jax.tree.map(jnp.asarray, _params())
    opt = joptim.SGD(lr=jsched.piecewise_linear([0, 1, 3], [0.0, LR, LR * 0.1]), momentum=0.9)
    opt_state = opt.init(params)
    ef = jlm.init_lm_ef_state(CFG_J, params, comp, mesh)
    cstate = jlm.init_lm_comp_state(CFG_J, params, comp, mesh)
    sync = jdp.make_grouped_grad_sync(comp, ("data", "seq"), jlm._lm_is_sharded(CFG_J), "tensor")

    def local(g, e, c):
        first = lambda t: jax.tree.map(lambda a: a[0], t)  # noqa: E731
        lead = lambda t: jax.tree.map(lambda a: a[None], t)  # noqa: E731
        out, new_e, new_c, stats = sync(first(g), first(e), first(c), jax.random.key(0))
        return lead(out), lead(new_e), lead(new_c), lead(stats)

    w = P(("data", "seq"))
    sync_fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(w, w, w), out_specs=(w, w, w, w),
                                check_vma=False))
    grads_fn = _jax_grads_fn(m)
    trace = []
    for s, batch in enumerate(_batches()[:steps]):
        loss, grads = grads_fn(params, jnp.asarray(batch["input"]), jnp.asarray(batch["target"]))
        synced, ef, cstate, stats = sync_fn(grads, ef, cstate)
        params, opt_state = opt.apply(params, jax.tree.map(lambda a: a[0], synced), opt_state,
                                      s + 1)
        trace.append({"loss": float(np.mean(loss)),
                      **{f"comm/{k}": float(np.mean(v)) for k, v in stats.items()}})
    return params, ef, cstate, trace


def test_powersgd_step_matches_jax(port_results):
    m = (2, 1, 1)
    params_j, ef_j, comp_j, trace = _jax_psgd_steps(m, 2)
    params_j = [np.asarray(x) for x in jax.tree.leaves(params_j)]
    ef_j = [np.asarray(x) for x in jax.tree.leaves(ef_j)]
    comp_j = {f"{s}/{q}": np.asarray(a) for s, sub in comp_j.items() for q, a in sub.items()}
    for r in range(2):
        got = port_results[m][r]
        for s, mt in enumerate(trace):
            np.testing.assert_allclose(float(got[f"powersgd/loss{s}"]), mt["loss"], rtol=1e-5)
            for k in ("sent_elems", "sent_bits", "num_collectives", "dense_elems"):
                assert float(got[f"powersgd/comm/{k}{s}"]) == mt[f"comm/{k}"], k
        for i, want in enumerate(params_j):
            np.testing.assert_allclose(got[f"powersgd/param/{i}"], want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} param {i}")
            np.testing.assert_allclose(got[f"powersgd/ef/{i}"], ef_j[i][r], rtol=1e-5,
                                       atol=1e-5 * np.abs(ef_j[i][r]).max(),
                                       err_msg=f"rank {r} EF {i}")
        assert {k.split("/", 2)[2] for k in got if k.startswith("powersgd/comp/")} == set(comp_j)
        for k, want in comp_j.items():
            np.testing.assert_allclose(got[f"powersgd/comp/{k}"], want[r], rtol=1e-5,
                                       atol=1e-5 * np.abs(want[r]).max(), err_msg=k)


def test_powersgd_raises_over_a_tensor_axis():
    from tpu_compressed_dp_torch.models import transformer as ttf
    from tpu_compressed_dp_torch.parallel import dp as tdp
    from tpu_compressed_dp_torch.parallel import mesh as tmesh
    from tpu_compressed_dp_torch.train import lm_step as tlm
    from tpu_compressed_dp_torch.train import optim as toptim

    comp = jdp.CompressionConfig(**PSGD_KW)
    with pytest.raises(NotImplementedError, match="shard-local warm starts"):
        jlm.make_lm_train_step(CFG_J, joptim.SGD(lr=0.1), comp, jlm.make_lm_mesh(1, 1, 2))
    cfg = dataclasses.replace(ttf.tiny_llama(), dtype=torch.float32)
    groups = tmesh.LmGroups(1, 1, 2, 0, 0, 0, None, None, None)
    with pytest.raises(NotImplementedError, match="shard-local warm starts"):
        tlm.make_lm_train_step(cfg, toptim.SGD(lr=0.1), tdp.CompressionConfig(**PSGD_KW),
                               groups=groups)
    with pytest.raises(NotImplementedError, match="shard-local warm starts"):
        tlm.init_lm_comp_state(cfg, {}, tdp.CompressionConfig(**PSGD_KW), groups)


@pytest.mark.parametrize("m,name", OVERLAP_CASES, ids=[f"{_mid(m)}-{n}" for m, n in OVERLAP_CASES])
def test_sync_overlap_is_bitwise_the_single_sync(port_results, m, name):
    for r in range(int(np.prod(m))):
        got = port_results[m][r]
        one = {k[len(f"overlap/{name}/k1/"):]: v for k, v in got.items()
               if k.startswith(f"overlap/{name}/k1/")}
        four = {k[len(f"overlap/{name}/k4/"):]: v for k, v in got.items()
                if k.startswith(f"overlap/{name}/k4/")}
        assert set(one) == set(four) and any(k.startswith("ef/") for k in one)
        for k, v in one.items():
            if k.startswith(("param/", "ef/", "comp/", "loss")):
                np.testing.assert_array_equal(_bits(four[k]), _bits(v), err_msg=f"rank {r} {k}")
