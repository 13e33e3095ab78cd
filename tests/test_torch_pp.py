"""The port's GPipe pipeline step (``--pp``, ``--microbatches``) against the JAX package.

The JAX side runs ``make_pp_train_step`` on ``make_pp_mesh(dp, pp, tp, sp)``
of the virtual CPU mesh; the port runs ``train/pp_step.py`` as one spawned
gloo process per mesh position (rank ``((d * sp + s) * pp + p) * tp + t``),
one world per mesh, every check of a mesh inside its world, all worlds
started together.  Both start from the same JAX ``init_llama`` parameters
of a 4-layer ``tiny_llama`` (vocab 256, dim 64, ffn 128, float32), so each
of the 2 stages stacks 2 layers per key as JAX stacks them, and see the same
token batches.

  * Loss and every leaf's gradient after the pipe sums (each worker's, this
    stage's and tensor shard's slice), at ``(dp, sp, pp, tp)`` = ``(1, 1, 2,
    1)`` with ``M = 2`` and ``M = 3`` (the uneven head split), ``(2, 1, 2,
    1)``, ``(1, 1, 2, 2)``, ``(1, 2, 2, 1)`` and an MoE config (4 experts on
    every layer) at ``(1, 1, 2, 1)``: loss rtol 1e-5, gradients rtol 1e-4 /
    atol 1e-5 of the leaf's largest entry (float32 in both, summed in other
    orders).  JAX's gradients are read off its step: a sync that returns
    the gradients as the EF residual stands in for the compressed one.
  * 3 steps at ``(1, 1, 2, 1)`` and ``(2, 1, 2, 1)``, dense and Top-K 5 % +
    EF at both granularities: losses (rtol 1e-4 dense, 1e-3 Top-K), the
    ``comm/*`` stats (dense and collective counts equal, sent elements within
    0.1 %), dense parameters (rtol 1e-4 / atol 1e-5), and the Top-K EF's
    kept coordinates agreeing but for 0.1 % (the contract of
    ``test_torch_lm_axes.py``); the pipe-replicated leaves are the same bits
    on every stage.
  * ``sync_overlap = 4`` at ``(1, 1, 2, 1)`` and ``(2, 1, 2, 1)``, dense and
    Top-K at both granularities: bitwise the one-sync step (parameters, EF,
    losses).  Its gradient hooks sum the pipe-replicated leaves over
    ``pipe`` inside the backward pass, beside the hand-offs' and the drain's
    collectives on the same group.
  * ``PipelineStage.build`` holds only its stage's layers, bitwise those of
    the seed's whole model, dense and MoE, at tensor rank 1 of 2.
  * PowerSGD and ``moe_every=2`` are refused as JAX refuses them.
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

from tpu_compressed_dp.data import lm as jdata
from tpu_compressed_dp.models import transformer as jtf
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.train import optim as joptim
from tpu_compressed_dp.train import pp_step as jpp
from tpu_compressed_dp.train import schedules as jsched
from tpu_compressed_dp.train.state import TrainState as JState

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_J = dataclasses.replace(jtf.tiny_llama(layers=4), dtype=jnp.float32)
CFG_MOE = dataclasses.replace(CFG_J, n_experts=4, moe_every=1, capacity_factor=1.0)
BATCH, SEQ, STEPS = 12, 64, 3
LR, RATIO = 0.03, 0.05
# label -> ((dp, sp, pp, tp), microbatches, moe)
GRADS = {"1x1x2x1-mb2": ((1, 1, 2, 1), 2, False), "1x1x2x1-mb3": ((1, 1, 2, 1), 3, False),
         "2x1x2x1-mb2": ((2, 1, 2, 1), 2, False), "1x1x2x2-mb2": ((1, 1, 2, 2), 2, False),
         "1x2x2x1-mb2": ((1, 2, 2, 1), 2, False), "moe-1x1x2x1-mb2": ((1, 1, 2, 1), 2, True)}
STEP_MESHES = [(1, 1, 2, 1), (2, 1, 2, 1)]
STEP_CONFIGS = {"dense": dict(method=None),
                "topk-em": dict(method="topk", ratio=RATIO, granularity="entiremodel",
                                error_feedback=True),
                "topk-lw": dict(method="topk", ratio=RATIO, granularity="layerwise",
                                error_feedback=True)}
OVERLAP_CONFIGS = {f"{k}-ov4": {**kw, "sync_overlap": 4} for k, kw in STEP_CONFIGS.items()}
MESHES = sorted({m for m, _, _ in GRADS.values()} | set(STEP_MESHES))


def _mid(m):
    return "x".join(map(str, m))


def _params(cfg=CFG_J):
    return jax.tree.map(np.asarray, jtf.init_llama(cfg, jax.random.key(0)))


def _batches():
    ds = jdata.SyntheticTokens(CFG_J.vocab_size, SEQ, BATCH, seed=0)
    return [ds.batch(i) for i in range(STEPS)]


def _names(tree):
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


_WORKER = r"""
import dataclasses, json, sys, numpy as np, torch
from tpu_compressed_dp_torch.models import transformer as tf
from tpu_compressed_dp_torch.parallel import dp, mesh
from tpu_compressed_dp_torch.train import lm_step, optim, pp_step, schedules
from tpu_compressed_dp_torch.train.state import TrainState
out, port, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dpn, spn, ppn, tpn = (int(a) for a in sys.argv[4].split("x"))
world = dpn * spn * ppn * tpn
mesh.init_process_group("cpu", init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=rank)
g = mesh.lm_groups(dpn, spn, tpn, ppn)
inp = np.load(f"{out}/inputs.npz")
meta = json.loads(str(inp["meta"]))
res = {}


def stage_of(c, prefix):
    names = meta[prefix + "names"]
    params = {k: inp[f"{prefix}p{i}"] for i, k in enumerate(names)}
    tree = {"embed": params["embed"], "final_norm": params["final_norm"],
            "lm_head": params["lm_head"],
            "layers": [{k.split(".")[2]: v for k, v in params.items()
                        if k.startswith(f"layers.{i}.")} for i in range(c.n_layers)]}
    model = tf.load_jax_params(c, tree, g.tensor_index, tpn)
    return pp_step.PipelineStage(model, g.pipe_index, ppn)


def block(a):
    rows, cols = lm_step.local_block(meta["batch"], meta["seq"], g)
    return torch.from_numpy(np.ascontiguousarray(a[rows, cols]))


for label, (m, mb, moe) in meta["grads"].items():
    if "x".join(map(str, m)) != sys.argv[4]:
        continue
    c = tf.LlamaConfig(**{**meta["moe_cfg" if moe else "cfg"], "dtype": torch.float32})
    stage = stage_of(c, "moe_" if moe else "")
    leaves = pp_step.stage_leaves(stage)
    share = pp_step.pp_loss(c, stage, block(inp["x0"]), block(inp["y0"]), g, mb)
    grads = torch.autograd.grad(share, list(leaves.values()))
    res[f"{label}/loss"] = mesh.all_reduce_sum(share.detach(), g.pipe).numpy()
    for i, (k, gr) in enumerate(zip(leaves, grads)):
        if k in ("embed", "final_norm", "lm_head"):
            gr = mesh.all_reduce_sum(gr, g.pipe)
        res[f"{label}/g{i}"] = gr.numpy()

if sys.argv[4] in meta["step_meshes"]:
    c = tf.LlamaConfig(**{**meta["cfg"], "dtype": torch.float32})
    for label, kw in meta["steps"].items():
        stage = stage_of(c, "")
        leaves = pp_step.stage_leaves(stage)
        lr = meta["lr"]
        opt = optim.SGD(lr=schedules.piecewise_linear([0, 1, 3], [0.0, lr, lr * 0.1]),
                        momentum=0.9)
        comp = dp.CompressionConfig(**kw)
        state = TrainState.create(stage, opt.init(leaves), dp.init_ef_state(leaves, comp),
                                  seed=1)
        step = pp_step.make_pp_train_step(c, opt, comp, groups=g, microbatches=2)
        for s in range(meta["steps_n"]):
            state, mt = step(state, {"input": block(inp[f"x{s}"]),
                                     "target": block(inp[f"y{s}"])})
            for k, v in mt.items():
                res[f"{label}/{k}{s}"] = np.asarray(v, np.float32)
        for i, (k, p) in enumerate(leaves.items()):
            res[f"{label}/param/{i}"] = p.detach().numpy()
            if comp.error_feedback:
                res[f"{label}/ef/{i}"] = state.ef[k].numpy()
np.savez(f"{out}/{sys.argv[4]}_rank{rank}.npz", **res)
mesh.destroy()
"""


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    out = str(tmp_path_factory.mktemp("torch_pp"))

    def fields(cfg):
        return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                if f.name != "dtype"}

    params, moe = _params(), _params(CFG_MOE)
    meta = dict(names=_names(params), moe_names=_names(moe), cfg=fields(CFG_J),
                moe_cfg=fields(CFG_MOE), seq=SEQ, batch=BATCH, lr=LR, steps_n=STEPS,
                steps={**STEP_CONFIGS, **OVERLAP_CONFIGS}, grads=GRADS,
                step_meshes=[_mid(m) for m in STEP_MESHES])
    arrays = {f"p{i}": a for i, a in enumerate(jax.tree.leaves(params))}
    arrays.update({f"moe_p{i}": a for i, a in enumerate(jax.tree.leaves(moe))})
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


def _coords(m, r):
    """``(d, s, p, t)`` of rank ``r`` on the mesh ``m`` = ``(dp, sp, pp, tp)``."""
    dpn, spn, ppn, tpn = m
    return r // (spn * ppn * tpn), (r // (ppn * tpn)) % spn, (r // tpn) % ppn, r % tpn


def _jax_run(cfg, m, kw, microbatches, steps, capture, monkeypatch):
    """The JAX pipeline step on ``m``: ``(state, metrics per step)``.  With
    ``capture`` its sync returns each worker's gradient as the new EF."""
    dpn, spn, ppn, tpn = m
    if capture:
        def sync_of(comp, sync_axes, leaf_axes):
            # the workers' mean as the synced gradient (the shard_map output
            # is replicated over the sync axes), each worker's own as its EF
            return lambda g, e, c, key, ok=None: (
                jax.tree.map(lambda a: jax.lax.pmean(a, sync_axes), g), g, (), {})

        monkeypatch.setattr(jpp, "make_partitioned_grad_sync", sync_of)
    mesh = jpp.make_pp_mesh(dpn, ppn, tpn, spn)
    comp = jdp.CompressionConfig(**kw)
    params = jpp.stack_layer_params(jtf.init_llama(cfg, jax.random.key(0)))
    opt = joptim.SGD(lr=jsched.piecewise_linear([0, 1, 3], [0.0, LR, LR * 0.1]), momentum=0.9)
    state = JState.create(params, {}, opt.init(params),
                          jpp.init_pp_ef_state(cfg, params, comp, mesh), jax.random.key(1))
    step = jpp.make_pp_train_step(cfg, opt, comp, mesh, microbatches=microbatches, donate=False)
    trace = []
    for batch in _batches()[:steps]:
        state, mt = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        trace.append({k: float(v) for k, v in mt.items()})
    return state, trace


def _slice(a, spec, p, t, m):
    """Stage ``p``'s, tensor rank ``t``'s slice of a whole stacked leaf."""
    ppn, tpn = m[2], m[3]
    for axis, name in enumerate(spec):
        n = {"pipe": ppn, "tensor": tpn}.get(name)
        if n:
            k = a.shape[axis] // n
            i = p if name == "pipe" else t
            a = np.take(a, np.arange(i * k, (i + 1) * k), axis=axis)
    return a


def _specs(cfg, m):
    from jax.sharding import PartitionSpec as P

    tree = jpp.pp_state_specs(cfg, jdp.CompressionConfig(), tensor=m[3] > 1, seq=m[1] > 1)
    return jax.tree.leaves(tree.params, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("label", list(GRADS))
def test_loss_and_gradients_match_jax(port_results, label, monkeypatch):
    m, mb, moe = GRADS[label]
    cfg = CFG_MOE if moe else CFG_J
    state, trace = _jax_run(cfg, m, dict(method=None, error_feedback=True), mb, 1, True,
                            monkeypatch)
    grads = [np.asarray(a) for a in jax.tree.leaves(state.ef)]
    specs = _specs(cfg, m)
    for r, got in enumerate(port_results[m]):
        d, s, p, t = _coords(m, r)
        w = d * m[1] + s
        # the JAX loss is the workers' mean; at dp * sp = 1 it is the worker's
        if m[0] * m[1] == 1:
            np.testing.assert_allclose(float(got[f"{label}/loss"]), trace[0]["loss"],
                                       rtol=1e-5)
        for i, (gj, spec) in enumerate(zip(grads, specs)):
            want = _slice(gj[w], spec, p, t, m)
            np.testing.assert_allclose(got[f"{label}/g{i}"], want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"{label} rank {r} leaf {i}")
    losses = [float(res[f"{label}/loss"]) for res in port_results[m]]
    np.testing.assert_allclose(np.mean(losses), trace[0]["loss"], rtol=1e-5)


@pytest.mark.parametrize("label", list(STEP_CONFIGS))
@pytest.mark.parametrize("m", STEP_MESHES, ids=_mid)
def test_three_steps_match_jax(port_results, m, label, monkeypatch):
    state_j, trace = _jax_run(CFG_J, m, STEP_CONFIGS[label], 2, STEPS, False, monkeypatch)
    specs = _specs(CFG_J, m)
    dense = label == "dense"
    params_j = [np.asarray(a) for a in jax.tree.leaves(state_j.params)]
    for r, got in enumerate(port_results[m]):
        d, s, p, t = _coords(m, r)
        w = d * m[1] + s
        for st, mt in enumerate(trace):
            np.testing.assert_allclose(float(got[f"{label}/loss{st}"]), mt["loss"],
                                       rtol=1e-4 if dense else 1e-3)
            assert float(got[f"{label}/lr{st}"]) == mt["lr"]
            assert float(got[f"{label}/tokens{st}"]) == mt["tokens"] == BATCH * SEQ
            for k in ("dense_elems", "num_collectives"):
                assert float(got[f"{label}/comm/{k}{st}"]) == mt[f"comm/{k}"], k
            sent = float(got[f"{label}/comm/sent_elems{st}"])
            assert abs(sent - mt["comm/sent_elems"]) <= 0.001 * mt["comm/sent_elems"]
        if dense:
            for i, (want, spec) in enumerate(zip(params_j, specs)):
                want = _slice(want, spec, p, t, m)
                np.testing.assert_allclose(got[f"{label}/param/{i}"], want, rtol=1e-4,
                                           atol=1e-5, err_msg=f"rank {r} param {i}")
            continue
        ef_j = [_slice(np.asarray(x)[w], spec, p, t, m)
                for x, spec in zip(jax.tree.leaves(state_j.ef), specs)]
        kept_j = np.concatenate([(x == 0).ravel() for x in ef_j])
        kept_t = np.concatenate([(got[f"{label}/ef/{i}"] == 0).ravel()
                                 for i in range(len(ef_j))])
        assert kept_j.sum() > 0
        assert (kept_j != kept_t).sum() <= 0.001 * kept_j.sum()
    # the pipe-replicated leaves (embed, final_norm, lm_head) hold the same
    # bits on every stage
    for r, got in enumerate(port_results[m]):
        d, s, p, t = _coords(m, r)
        base = port_results[m][r - p * m[3]]
        for i in (0, 1, len(specs) - 1):
            np.testing.assert_array_equal(got[f"{label}/param/{i}"].view(np.uint32),
                                          base[f"{label}/param/{i}"].view(np.uint32))


@pytest.mark.parametrize("label", list(STEP_CONFIGS))
@pytest.mark.parametrize("m", STEP_MESHES, ids=_mid)
def test_sync_overlap_is_bitwise_the_single_sync(port_results, m, label):
    for r, got in enumerate(port_results[m]):
        one = {k[len(label) + 1:]: v for k, v in got.items() if k.startswith(f"{label}/")}
        four = {k[len(label) + 5:]: v for k, v in got.items() if k.startswith(f"{label}-ov4/")}
        assert set(one) == set(four) and any(k.startswith("param/") for k in one)
        for k, v in one.items():
            if k.startswith(("param/", "ef/", "loss")):
                np.testing.assert_array_equal(four[k].view(np.uint32), v.view(np.uint32),
                                              err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_stage_build_holds_its_layers_of_the_seeds_model(moe):
    from tpu_compressed_dp_torch.models import transformer as ttf
    from tpu_compressed_dp_torch.train import pp_step as tpp

    cfg = dataclasses.replace(ttf.tiny_llama(layers=4), dtype=torch.float32,
                              **(dict(n_experts=4, moe_every=1) if moe else {}))
    whole = ttf.Llama(cfg, seed=3, tensor_rank=1, tensor_size=2)
    for p in range(2):
        stage = tpp.PipelineStage.build(cfg, seed=3, pipe_rank=p, pipe_size=2, tensor_rank=1,
                                        tensor_size=2)
        want = tpp.stage_leaves(tpp.PipelineStage(whole, p, 2))
        got = tpp.stage_leaves(stage)
        assert list(got) == list(want)
        for k, v in got.items():
            assert torch.equal(v, want[k]), (p, k)
    part = ttf.Llama(cfg, seed=3, layers=range(2, 4))
    assert part.layer_ids == (2, 3) and len(part.layers) == 2
    assert list(ttf.param_leaves(part))[2].startswith("layers.2.")
    with pytest.raises(ValueError, match="has no forward"):
        part(torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="needs layers"):
        tpp.PipelineStage(part, 0, 2)


def test_refusals_match_jax():
    from tpu_compressed_dp_torch.models import transformer as ttf
    from tpu_compressed_dp_torch.parallel import dp as tdp
    from tpu_compressed_dp_torch.parallel import mesh as tmesh
    from tpu_compressed_dp_torch.train import optim as toptim
    from tpu_compressed_dp_torch.train import pp_step as tpp

    mesh = jpp.make_pp_mesh(1, 2)
    psgd = dict(method="powersgd", rank=2, granularity="layerwise")
    with pytest.raises(NotImplementedError, match="powersgd is not yet supported") as jerr:
        jpp.make_pp_train_step(CFG_J, joptim.SGD(lr=0.1), jdp.CompressionConfig(**psgd), mesh,
                               microbatches=2)
    groups = tmesh.LmGroups(1, 1, 1, 0, 0, 0, None, None, None, pp=2, pipe_index=0, pipe=None)
    cfg = dataclasses.replace(ttf.tiny_llama(layers=4), dtype=torch.float32)
    with pytest.raises(NotImplementedError) as terr:
        tpp.make_pp_train_step(cfg, toptim.SGD(lr=0.1), tdp.CompressionConfig(**psgd),
                               groups=groups, microbatches=2)
    assert str(terr.value) == str(jerr.value)
    moe2 = dict(n_experts=4, moe_every=2)
    with pytest.raises(ValueError, match="moe_every=1") as jerr:
        jpp.make_pp_train_step(dataclasses.replace(CFG_J, **moe2), joptim.SGD(lr=0.1),
                               jdp.CompressionConfig(), mesh, microbatches=2)
    with pytest.raises(ValueError) as terr:
        tpp.make_pp_train_step(dataclasses.replace(cfg, **moe2), toptim.SGD(lr=0.1),
                               tdp.CompressionConfig(), groups=groups, microbatches=2)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="moe_every=1"):
        tpp.PipelineStage.build(dataclasses.replace(cfg, **moe2), pipe_size=2)
    with pytest.raises(ValueError, match="must divide by pipe size"):
        tpp.PipelineStage.build(dataclasses.replace(cfg, n_layers=3), pipe_size=2)
    from tpu_compressed_dp_torch.train.guard import GuardConfig

    assert callable(tpp.make_pp_train_step(cfg, toptim.SGD(lr=0.1), tdp.CompressionConfig(),
                                           groups=groups, microbatches=2,
                                           guard_cfg=GuardConfig()))


def test_stage_layout_matches_jax():
    """The stacked leaves, their order and their signatures are the JAX
    ``stack_layer_params`` tree's and ``pp_state_specs``' at tensor 1 and 2,
    dense and MoE."""
    from tpu_compressed_dp_torch.models import transformer as ttf
    from tpu_compressed_dp_torch.train import pp_step as tpp

    for cfg_j in (CFG_J, CFG_MOE):
        params = _params(cfg_j)
        stacked = jax.tree.map(np.asarray, jpp.stack_layer_params(params))
        cfg_t = ttf.LlamaConfig(**{f.name: getattr(cfg_j, f.name)
                                   for f in dataclasses.fields(cfg_j) if f.name != "dtype"})
        model = ttf.load_jax_params(cfg_t, params)
        for p in range(2):
            stage = tpp.PipelineStage(model, p, 2)
            leaves = tpp.stage_leaves(stage)
            assert list(leaves) == _names(stacked)
            specs = _specs(cfg_j, (1, 1, 2, 1))
            for (name, got), want, spec in zip(leaves.items(), jax.tree.leaves(stacked), specs):
                np.testing.assert_array_equal(got.detach().numpy(),
                                              _slice(want, spec, p, 0, (1, 1, 2, 1)), name)
        for tp in (1, 2):
            from jax.sharding import PartitionSpec as P

            model_axes = ("pipe", "tensor") if tp > 1 else ("pipe",)
            specs = _specs(cfg_j, (1, 1, 2, tp))
            want = [tuple(a for a in model_axes if any(ax == a for ax in spec))
                    for spec in specs]
            assert [tuple(a) for a in tpp.stage_leaf_axes(cfg_t, tp)] == want
            assert all(isinstance(s, P) for s in specs)
