"""The port's mixture-of-experts layers (``--experts``) against the JAX package.

Both packages hold the same parameters: the JAX ``init_llama`` tree of a
``tiny_llama`` with 4 experts on every second layer (vocab 256, dim 64, ffn
128, 2 layers, float32), carried into the port by ``load_jax_params``.  The
JAX side runs ``apply_llama`` / ``_moe_ffn`` (under ``shard_map`` on
``make_lm_mesh(1, 1, tp)`` of the virtual CPU mesh at ``tp = 2``); the port
runs one spawned gloo process per mesh position, one world per mesh, all
started together.  Two capacity factors: 4.0 (drop-free, ``cf >= E``) and
1.0 (tokens over capacity fall through; the test asserts that some do).

Tolerances, and why: the two frameworks sum matmuls and reductions in other
orders, and for this model JAX's float32 CPU gradients agree with its float64
ones to ~1e-6 of each leaf's largest entry (``test_jax_float32_is_exact_
enough``), so the float32 JAX run is the reference:
  * ``_moe_ffn``'s output and aux, and their gradients: rtol 1e-5, atol 1e-6
    of the largest entry;
  * the loss, the cross-entropy and the aux: rtol 1e-5;
  * every leaf's gradient at ``(dp, sp, tp)`` = ``(1, 1, 1)`` and ``(1, 1,
    2)``, ``router`` and ``mlp_norm`` included (they catch a misplaced
    tensor-group sum: a factor of 2 on the aux path or a missing half on the
    experts' path): rtol 1e-4, atol 1e-5 of the leaf's largest entry;
  * one expert (``E = 1``, drop-free) is the dense SwiGLU FFN: rtol 1e-6;
  * 3 steps of entire-model Top-K 1 % + EF through ``make_lm_train_step``:
    losses rtol 1e-3, sent elements within 0.1 %, and the kept coordinates
    (zero EF entries) agree but for 0.1 % (the Top-K + EF contract of
    ``test_torch_lm_axes.py``).
"""

import dataclasses
import json
import math
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
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.train import lm_step as jlm
from tpu_compressed_dp.train import optim as joptim
from tpu_compressed_dp.train import schedules as jsched
from tpu_compressed_dp.train.state import TrainState as JState

import torch

from tpu_compressed_dp_torch.models import transformer as ttf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_J = dataclasses.replace(jtf.tiny_llama(), dtype=jnp.float32, n_experts=4)
CFG_T = dataclasses.replace(ttf.tiny_llama(), dtype=torch.float32, n_experts=4)
CFS = {"dropfree": 4.0, "drops": 1.0}
MESHES = [(1, 1, 1), (1, 1, 2)]
BATCH, SEQ, STEPS = 2, 128, 3
LR, RATIO = 0.03, 0.01
TOPK = dict(method="topk", ratio=RATIO, granularity="entiremodel", error_feedback=True)


def _cfg_j(cf):
    return dataclasses.replace(CFG_J, capacity_factor=cf)


def _params():
    return jax.tree.map(np.asarray, jtf.init_llama(CFG_J, jax.random.key(0)))


def _names(tree):
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _batches():
    ds = jdata.SyntheticTokens(CFG_J.vocab_size, SEQ, BATCH, seed=0)
    return [ds.batch(i) for i in range(STEPS)]


def _mid(m):
    return "x".join(map(str, m))


def _close(got, want, rtol, atol_share, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_share * np.abs(want).max(),
                               err_msg=msg)


# ---------------------------------------------------------------------------
# The MoE FFN alone
# ---------------------------------------------------------------------------


def _ffn_inputs(seed=3, n_tok=(2, 48)):
    rng = np.random.default_rng(seed)
    d, f, e = CFG_J.dim, CFG_J.ffn, CFG_J.n_experts
    x = rng.standard_normal(n_tok + (d,)).astype(np.float32)
    lp = {"router": rng.standard_normal((d, e)).astype(np.float32),
          "w_gate": (rng.standard_normal((e, d, f)) / 8).astype(np.float32),
          "w_up": (rng.standard_normal((e, d, f)) / 8).astype(np.float32),
          "w_down": (rng.standard_normal((e, f, d)) / 11).astype(np.float32)}
    ct = rng.standard_normal(n_tok + (d,)).astype(np.float32)
    return x, lp, ct


def _routing(cfg, router, x):
    """(tokens routed to each expert, capacity) of ``_moe_ffn``'s routing."""
    xf = x.reshape(-1, x.shape[-1])
    top = np.argmax(np.asarray(jax.nn.softmax(jnp.asarray(xf @ router), axis=-1)), axis=-1)
    n = xf.shape[0]
    return np.bincount(top, minlength=cfg.n_experts), max(int(math.ceil(
        n / cfg.n_experts * cfg.capacity_factor)), 1)


@pytest.mark.parametrize("label", list(CFS))
def test_moe_ffn_matches_jax(label):
    cfg_j = _cfg_j(CFS[label])
    cfg_t = dataclasses.replace(CFG_T, capacity_factor=CFS[label])
    x, lp, ct = _ffn_inputs()
    counts, cap = _routing(cfg_j, lp["router"], x)
    assert (counts.max() > cap) == (label == "drops"), (counts, cap)

    def f(x_, lp_):
        out, aux = jtf._moe_ffn(cfg_j, lp_, x_, None)
        return jnp.sum(out * ct) + 0.5 * aux, (out, aux)

    (_, (out_j, aux_j)), grads_j = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    lpt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in lp.items()}
    out_t, aux_t = ttf._moe_ffn(cfg_t, lpt, xt)
    obj = (out_t * torch.from_numpy(ct)).sum() + 0.5 * aux_t
    gx, *glp = torch.autograd.grad(obj, [xt, *lpt.values()])
    _close(out_t.detach().numpy(), out_j, 1e-5, 1e-6, "out")
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    _close(gx.numpy(), grads_j[0], 1e-5, 1e-6, "dx")
    for k, g in zip(lpt, glp):
        _close(g.numpy(), grads_j[1][k], 1e-5, 1e-6, k)


def test_one_expert_is_the_dense_swiglu():
    """E = 1 at capacity factor 1: every token gets a slot and a gate of
    exactly 1, so the expert is the dense FFN of the same weights."""
    cfg = dataclasses.replace(CFG_T, n_experts=1, capacity_factor=1.0)
    x, lp, _ = _ffn_inputs(seed=4)
    xt = torch.from_numpy(x)
    lpt = {"router": torch.from_numpy(lp["router"][:, :1]),
           **{k: torch.from_numpy(lp[k][:1]) for k in ("w_gate", "w_up", "w_down")}}
    out, aux = ttf._moe_ffn(cfg, lpt, xt)
    gate = torch.nn.functional.silu(xt @ lpt["w_gate"][0])
    dense = (gate * (xt @ lpt["w_up"][0])) @ lpt["w_down"][0]
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=1e-6, atol=1e-7)
    assert float(aux) == 1.0


def test_layout_matches_jax():
    """Leaf order, shapes, values and tensor sharding of an MoE model: the
    router after ``mlp_norm``, the expert stacks split on their leading
    axis, the router replicated; ``moe_every`` picks the same layers."""
    params = _params()
    model = ttf.load_jax_params(CFG_T, params)
    leaves = ttf.param_leaves(model)
    assert list(leaves) == _names(params)
    for p, a in zip(leaves.values(), jax.tree.leaves(params)):
        np.testing.assert_array_equal(p.detach().numpy(), a)
    assert ttf.is_sharded(CFG_T) == jlm._lm_is_sharded(CFG_J)
    for every in (1, 2, 3):
        for i in range(6):
            assert (dataclasses.replace(CFG_T, moe_every=every).is_moe_layer(i)
                    == dataclasses.replace(CFG_J, moe_every=every).is_moe_layer(i))
    specs = jax.tree.leaves(jtf.param_specs(CFG_J), is_leaf=lambda x: isinstance(x, P))
    for name, spec in zip(leaves, specs):
        moe = name.startswith("layers.1.")
        want = next((ax for ax, s in enumerate(spec) if s == "tensor"), None)
        assert ttf.shard_axis(name, moe) == want, name
    half = ttf.load_jax_params(CFG_T, params, tensor_rank=1, tensor_size=2)
    np.testing.assert_array_equal(half.layers[1].w_gate.detach().numpy(),
                                  params["layers"][1]["w_gate"][2:])
    np.testing.assert_array_equal(half.layers[1].router.detach().numpy(),
                                  params["layers"][1]["router"])
    with pytest.raises(ValueError, match="n_experts"):
        dataclasses.replace(CFG_T, n_experts=3).validate_mesh(2)
    # the port's own draws: the shards of one seed make up the whole model
    whole = ttf.param_leaves(ttf.Llama(CFG_T, seed=5))
    parts = [ttf.param_leaves(ttf.Llama(CFG_T, seed=5, tensor_rank=t, tensor_size=2))
             for t in range(2)]
    for name, w in whole.items():
        ax = ttf.shard_axis(name, name.startswith("layers.1."))
        got = (parts[0][name] if ax is None else torch.cat([p[name] for p in parts], ax))
        np.testing.assert_array_equal(got.detach().numpy(), w.detach().numpy())


def test_jax_float32_is_exact_enough():
    """The reference's own float32 CPU gradients of this MoE model against
    its float64 ones: within 1e-5 of each leaf's largest entry, so the
    float32 run serves as the reference."""
    params = _params()
    x, y = (jnp.asarray(_batches()[0][k]) for k in ("input", "target"))

    def grads(dtype):
        cfg = dataclasses.replace(_cfg_j(1.0), dtype=dtype)

        def loss(p):
            lg, aux = jtf.apply_llama(cfg, p, x, with_aux=True)
            return jtf.vocab_parallel_xent(lg, y) + cfg.moe_aux_weight * aux

        p = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
        return jax.tree.leaves(jax.grad(loss)(p))

    g32 = grads(jnp.float32)
    with jax.enable_x64(True):
        g64 = [np.asarray(a) for a in grads(jnp.float64)]
    for a, b in zip(g32, g64):
        assert np.abs(np.asarray(a) - b).max() <= 1e-5 * np.abs(b).max()


# ---------------------------------------------------------------------------
# The model and step on the mesh
# ---------------------------------------------------------------------------

_WORKER = r"""
import dataclasses, json, sys, numpy as np, torch
from tpu_compressed_dp_torch.models import transformer as tf
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
names = meta["names"]
base = tf.LlamaConfig(**{**meta["cfg"], "dtype": torch.float32})
t = g.tensor_index
res = {}


def model_of(c):
    params = {k: inp[f"p{i}"] for i, k in enumerate(names)}
    tree = {"embed": params["embed"], "final_norm": params["final_norm"],
            "lm_head": params["lm_head"],
            "layers": [{k.split(".")[2]: v for k, v in params.items()
                        if k.startswith(f"layers.{i}.")} for i in range(c.n_layers)]}
    return tf.load_jax_params(c, tree, t, tpn)


def block(a):
    rows, cols = lm_step.local_block(meta["batch"], meta["seq"], g)
    return torch.from_numpy(np.ascontiguousarray(a[rows, cols]))


x, y = block(inp["x0"]), block(inp["y0"])
for label, cf in meta["cfs"].items():
    c = dataclasses.replace(base, capacity_factor=cf)
    model = model_of(c)
    leaves = tf.param_leaves(model)
    logits, aux = model(x, tensor_group=g.tensor, seq_group=g.seq, with_aux=True)
    objective, xent = lm_step.lm_loss(c, model, x, y, g)
    grads = torch.autograd.grad(objective, list(leaves.values()))
    res[f"{label}/objective"] = objective.detach().numpy()
    res[f"{label}/xent"] = xent.detach().numpy()
    res[f"{label}/aux"] = aux.detach().numpy()
    for i, gr in enumerate(grads):
        res[f"{label}/g{i}"] = gr.numpy()

c = dataclasses.replace(base, capacity_factor=meta["step_cf"])
model = model_of(c)
leaves = tf.param_leaves(model)
lr = meta["lr"]
opt = optim.SGD(lr=schedules.piecewise_linear([0, 1, 3], [0.0, lr, lr * 0.1]), momentum=0.9)
comp = dp.CompressionConfig(**meta["topk"])
state = TrainState.create(model, opt.init(leaves), lm_step.init_lm_ef_state(c, leaves, comp),
                          seed=1)
step = lm_step.make_lm_train_step(c, opt, comp, groups=g)
for s in range(meta["steps"]):
    state, m = step(state, {"input": block(inp[f"x{s}"]), "target": block(inp[f"y{s}"])})
    for k, v in m.items():
        res[f"steps/{k}{s}"] = np.asarray(v, np.float32)
for i, k in enumerate(names):
    res[f"steps/param/{i}"] = leaves[k].detach().numpy()
    res[f"steps/ef/{i}"] = state.ef[k].numpy()
np.savez(f"{out}/{sys.argv[4]}_rank{rank}.npz", **res)
if world > 1:
    mesh.destroy()
"""


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    out = str(tmp_path_factory.mktemp("torch_moe"))
    params = _params()
    cfg = {f.name: getattr(CFG_J, f.name) for f in dataclasses.fields(CFG_J) if f.name != "dtype"}
    meta = dict(names=_names(params), cfg=cfg, cfs=CFS, step_cf=CFS["drops"], seq=SEQ,
                batch=BATCH, lr=LR, steps=STEPS, topk=TOPK)
    arrays = {f"p{i}": a for i, a in enumerate(jax.tree.leaves(params))}
    for s, b in enumerate(_batches()):
        arrays[f"x{s}"], arrays[f"y{s}"] = b["input"], b["target"]
    np.savez(f"{out}/inputs.npz", meta=json.dumps(meta), **arrays)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = []
    for m in MESHES:
        port = str(free_port())
        procs += [subprocess.Popen([sys.executable, "-c", _WORKER, out, port, str(r), _mid(m)],
                                   env=env, cwd=REPO, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                  for r in range(int(np.prod(m)))]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return {m: [dict(np.load(f"{out}/{_mid(m)}_rank{r}.npz")) for r in range(int(np.prod(m)))]
            for m in MESHES}


def _specs(cfg):
    return jax.tree.leaves(jtf.param_specs(cfg), is_leaf=lambda x: isinstance(x, P))


def _shard(a, spec, t, tpn):
    for axis, name in enumerate(spec):
        if name == "tensor":
            n = a.shape[axis] // tpn
            a = np.take(a, np.arange(t * n, (t + 1) * n), axis=axis)
    return a


def _jax_grads(cfg, m):
    """Each worker's objective, cross-entropy, aux and gradient of the
    objective, as the JAX LM step takes them inside ``shard_map``."""
    mesh = jlm.make_lm_mesh(*m)
    pspecs = jtf.param_specs(cfg)
    axes = ("data", "seq")

    def local(params, x, y):
        def loss_fn(p):
            logits, aux = jtf.apply_llama(cfg, p, x, tensor_axis="tensor", seq_axis="seq",
                                          with_aux=True)
            xent = jtf.vocab_parallel_xent(logits, y, tensor_axis="tensor")
            return xent + cfg.moe_aux_weight * aux, (xent, aux)

        varying = jax.tree.map(lambda p: compat.pcast(p, axes, to="varying"), params)
        (obj, (xent, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(varying)
        return obj[None], xent[None], aux[None], jax.tree.map(lambda a: a[None], grads)

    gspecs = jax.tree.map(lambda s: P(axes, *s), pspecs, is_leaf=lambda x: isinstance(x, P))
    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(pspecs, P("data", "seq"),
                                                       P("data", "seq")),
                           out_specs=(P(axes),) * 3 + (gspecs,)))
    b = _batches()[0]
    obj, xent, aux, grads = fn(_params(), jnp.asarray(b["input"]), jnp.asarray(b["target"]))
    return (np.asarray(obj), np.asarray(xent), np.asarray(aux),
            [np.asarray(a) for a in jax.tree.leaves(grads)])


@pytest.mark.parametrize("label", list(CFS))
@pytest.mark.parametrize("m", MESHES, ids=_mid)
def test_loss_aux_and_gradients_match_jax(port_results, m, label):
    cfg = _cfg_j(CFS[label])
    obj_j, xent_j, aux_j, grads_j = _jax_grads(cfg, m)
    specs = _specs(cfg)
    names = _names(_params())
    for r, got in enumerate(port_results[m]):
        t = r % m[2]
        np.testing.assert_allclose(float(got[f"{label}/objective"]), float(obj_j[0]), rtol=1e-5)
        np.testing.assert_allclose(float(got[f"{label}/xent"]), float(xent_j[0]), rtol=1e-5)
        np.testing.assert_allclose(float(got[f"{label}/aux"]), float(aux_j[0]), rtol=1e-5)
        for i, (gj, spec) in enumerate(zip(grads_j, specs)):
            _close(got[f"{label}/g{i}"], _shard(gj[0], spec, t, m[2]), 1e-4, 1e-5,
                   f"rank {r} {names[i]}")


def _jax_steps(m):
    comp = jdp.CompressionConfig(**TOPK)
    mesh = jlm.make_lm_mesh(*m)
    cfg = _cfg_j(CFS["drops"])
    params = _params()
    opt = joptim.SGD(lr=jsched.piecewise_linear([0, 1, 3], [0.0, LR, LR * 0.1]), momentum=0.9)
    state = JState.create(params, {}, opt.init(params),
                          jlm.init_lm_ef_state(cfg, params, comp, mesh), jax.random.key(1))
    step = jlm.make_lm_train_step(cfg, opt, comp, mesh, donate=False)
    trace = []
    for batch in _batches():
        state, mt = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        trace.append({k: float(v) for k, v in mt.items()})
    return state, trace


@pytest.mark.parametrize("m", MESHES, ids=_mid)
def test_three_topk_steps_match_jax(port_results, m):
    state_j, trace = _jax_steps(m)
    specs = _specs(CFG_J)
    for r, got in enumerate(port_results[m]):
        t = r % m[2]
        for s, mt in enumerate(trace):
            # the logged loss is the cross-entropy, the aux rides only in
            # the objective
            np.testing.assert_allclose(float(got[f"steps/loss{s}"]), mt["loss"], rtol=1e-3)
            sent = float(got[f"steps/comm/sent_elems{s}"])
            assert abs(sent - mt["comm/sent_elems"]) <= 0.001 * mt["comm/sent_elems"]
            assert float(got[f"steps/comm/num_collectives{s}"]) == mt["comm/num_collectives"]
        ef_j = [_shard(np.asarray(x)[0], spec, t, m[2])
                for x, spec in zip(jax.tree.leaves(state_j.ef), specs)]
        kept_j = np.concatenate([(x == 0).ravel() for x in ef_j])
        kept_t = np.concatenate([(got[f"steps/ef/{i}"] == 0).ravel() for i in range(len(ef_j))])
        assert kept_j.sum() > 0
        assert (kept_j != kept_t).sum() <= 0.001 * kept_j.sum()
    if m[2] > 1:
        # the replicated leaves, the router among them, are the same bits on
        # both tensor ranks
        for i, sh in enumerate(jlm._lm_is_sharded(CFG_J)):
            if not sh:
                a, b = (port_results[m][r][f"steps/param/{i}"] for r in range(2))
                np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
