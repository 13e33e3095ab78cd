"""The chunk-pipelined sync (``parallel/overlap.py``) on the CPU.

  * ``plan_chunks`` and ``issue_order`` equal the JAX functions on ResNet-50's
    161 leaf sizes (every granularity, K from 1 to 200, production ranks
    from seeded permutations);
  * ``sync_overlap = K`` (K = 2, 4) is bitwise ``sync_overlap = 1``: synced
    gradients, EF residuals, PowerSGD warm starts and every stat, two syncs
    in a row, for every stateless method x {simulate, wire} x {layerwise,
    bucketed} x EF on/off (EF off only for the quantizers, which refuse it
    in wire mode), dense, and PowerSGD, at W = 1 and at W = 2 gloo ranks
    (spawned processes); Top-K also in ``force`` mode (histogram threshold,
    fused sparsify);
  * the train step's hook-driven path (gradients land during the backward
    pass, each chunk's SGD slice applied when it is reduced) is bitwise the
    single sync after two steps of a ResNet-9 at 1/8 width: parameters,
    momentum, EF, warm starts, BatchNorm statistics, metrics; with
    ``clip_norm`` and ``clip_sent_norm`` too;
  * the port's chunked sync at W = 2 equals the JAX ``make_grad_sync`` with
    ``sync_overlap = K`` on the same numpy gradients, bitwise (Top-K's exact
    threshold, Threshold-V, dense: the mean of two values is order-free).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from tpu_compressed_dp.compat import shard_map
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.parallel import overlap as jov
from tpu_compressed_dp.parallel.mesh import make_data_mesh

import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's in-process torch work: under
    the tier-1 run's parallel workers, a thread per core in every worker
    oversubscribes the machine, and small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"a": (3000,), "b": (40,), "c": (12, 100), "d": (8, 3, 5, 5), "e": (700,)}
RATIO = 0.05
STEP_SEED = 4321
SPARSIFIERS = ("topk", "randomk", "thresholdv", "adaptive_threshold", "blocktopk")
# the JAX comparison rows: (method, granularity, mode, EF, K)
JAX_ROWS = [("topk", "layerwise", "simulate", True, 3), ("topk", "bucketed", "simulate", True, 2),
            ("thresholdv", "bucketed", "wire", True, 2), (None, "bucketed", "simulate", False, 2)]


def _matrix():
    rows = []
    for method in SPARSIFIERS + ("terngrad", "qsgd"):
        for mode in ("simulate", "wire"):
            for gran in ("layerwise", "bucketed"):
                for ef in ((True, False) if method in SPARSIFIERS else (False,)):
                    rows.append(dict(method=method, mode=mode, gran=gran, ef=ef, force=False))
    rows += [dict(method="topk", mode=m, gran=g, ef=True, force=True)
             for m in ("simulate", "wire") for g in ("layerwise", "bucketed")]
    rows += [dict(method=None, mode="simulate", gran=g, ef=False, force=False)
             for g in ("layerwise", "bucketed")]
    rows += [dict(method="powersgd", mode="simulate", gran=g, ef=True, force=False)
             for g in ("layerwise", "bucketed")]
    return rows


MATRIX = _matrix()
STEP_ROWS = [dict(method="topk", mode="simulate", gran="layerwise", ef=True, clip=(0.0, 0.0)),
             dict(method="randomk", mode="simulate", gran="bucketed", ef=True, clip=(0.0, 0.0)),
             dict(method="topk", mode="wire", gran="bucketed", ef=True, clip=(0.0, 0.0)),
             dict(method="powersgd", mode="simulate", gran="layerwise", ef=True,
                  clip=(0.0, 0.0)),
             dict(method=None, mode="simulate", gran="layerwise", ef=False, clip=(0.0, 0.0)),
             dict(method="topk", mode="simulate", gran="layerwise", ef=True, clip=(1.0, 0.0)),
             dict(method="thresholdv", mode="wire", gran="layerwise", ef=True,
                  clip=(0.0, 1.0))]


def _row_id(r):
    return "-".join([str(r["method"]), r["mode"], r["gran"], f"ef={r['ef']}"]
                    + (["force"] if r.get("force") else []))


# one worker: the K matrix, the step rows and the JAX rows' outputs, at
# (world, rank); results to <out>/w<world>_rank<rank>.json / .npz
_WORKER = r"""
import json, sys, numpy as np, torch
from tpu_compressed_dp_torch.ops import kernels
from tpu_compressed_dp_torch.parallel import dp, mesh, overlap
out, port, rank, world, ratio, seed = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                       int(sys.argv[4]), float(sys.argv[5]), int(sys.argv[6]))
if world > 1:
    mesh.init_process_group("cpu", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
spec = json.load(open(f"{out}/spec.json"))
inp = np.load(f"{out}/inputs.npz")
names = sorted(spec["shapes"])
grads_np = [{k: inp[f"g{s}_{k}"][rank] for k in names} for s in range(2)]
ef_np = {k: inp[f"e_{k}"][rank] for k in names}

def cfg_of(r, K):
    kw = dict(bucket_mb=0.01) if r["gran"] == "bucketed" else {}
    return dp.CompressionConfig(method=r["method"], granularity=r["gran"], mode=r["mode"],
                                ratio=ratio, error_feedback=r["ef"], sync_overlap=K, rank=2,
                                threshold=0.5, **kw)

def equal(a, b):
    if isinstance(a, dict):
        return list(a) == list(b) and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and bool(
            torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                        b.view(torch.int32) if b.dtype == torch.float32 else b))
    return a == b

def run_sync(r, K):
    cfg = cfg_of(r, K)
    kernels.set_pallas_mode("force" if r["force"] else "auto")
    grads0 = {k: torch.from_numpy(grads_np[0][k]) for k in names}
    sync = (dp.make_stateful_grad_sync(cfg) if K == 1 else overlap.make_chunked_grad_sync(cfg))
    ef = ({k: torch.from_numpy(ef_np[k]) for k in names} if r["ef"] else ())
    comp = dp.init_comp_state(grads0, cfg)
    outs = []
    for s in range(2):
        g = {k: torch.from_numpy(grads_np[s][k]) for k in names}
        o, ef, comp, stats = sync(g, ef, comp, seed + s)
        outs.append((o, ef, comp, stats))
    kernels.set_pallas_mode("auto")
    return outs

res = {"matrix": {}, "steps": {}}
for r in spec["matrix"]:
    base = run_sync(r, 1)
    for K in (2, 4):
        got = run_sync(r, K)
        res["matrix"][f"{r['id']} K={K}"] = all(equal(x, y) for a, b in zip(base, got)
                                                for x, y in zip(a, b))
arrays = {}
for i, (m, gran, mode, ef, K) in enumerate(spec["jax_rows"]):
    r = dict(method=m, gran=gran, mode=mode, ef=ef, force=False)
    o, new_ef, _, stats = run_sync(r, K)[0]
    for k in names:
        arrays[f"{i}/out/{k}"] = o[k].numpy()
        if ef:
            arrays[f"{i}/ef/{k}"] = new_ef[k].numpy()
    for k, v in stats.items():
        arrays[f"{i}/stat/{k}"] = v.numpy()
# the train step's hook-driven path: K = 3 against K = 1, two steps
from tpu_compressed_dp_torch.models import resnet9 as r9
from tpu_compressed_dp_torch.models.common import make_normalizing_apply_fn, param_leaves
from tpu_compressed_dp_torch.train.optim import SGD
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.train.step import make_train_step
rng = np.random.default_rng(100 + rank)
x = torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3)).astype(np.uint8))
y = torch.from_numpy(rng.integers(0, 10, 8))
apply_fn = make_normalizing_apply_fn([120.0] * 3, [60.0] * 3)

def run_steps(r, K):
    cfg = cfg_of(r, K)
    model = r9.ResNet9(channels=r9.scaled_channels(0.125), seed=0)
    params = param_leaves(model)
    opt = SGD(lr=0.05, momentum=0.9, nesterov=True, weight_decay=5e-4)
    st = TrainState.create(model, opt.init(params), dp.init_ef_state(params, cfg), seed=3,
                           comp=dp.init_comp_state(params, cfg))
    step = make_train_step(apply_fn, opt, cfg, grad_scale=8.0, clip_norm=r["clip"][0],
                           clip_sent_norm=r["clip"][1])
    for _ in range(2):
        st, metrics = step(st, {"input": x, "target": y})
    return (dict(param_leaves(st.model)), dict(st.model.named_buffers()),
            st.opt_state["momentum"], st.ef, st.comp, metrics)

for r in spec["steps"]:
    base = run_steps(r, 1)
    got = run_steps(r, 3)
    res["steps"][r["id"]] = all(equal(a, b) for a, b in zip(base, got))
np.savez(f"{out}/w{world}_rank{rank}.npz", **arrays)
json.dump(res, open(f"{out}/w{world}_rank{rank}.json", "w"))
if world > 1:
    mesh.destroy()
"""


def _inputs(world):
    rng = np.random.default_rng(0)
    g = {f"g{s}_{k}": rng.standard_normal((world,) + sh).astype(np.float32)
         for s in range(2) for k, sh in SHAPES.items()}
    e = {f"e_{k}": (0.1 * rng.standard_normal((world,) + sh)).astype(np.float32)
         for k, sh in SHAPES.items()}
    return {**g, **e}


def _spawn(out, world):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = str(free_port())
    return [subprocess.Popen([sys.executable, "-c", _WORKER, out, port, str(r), str(world),
                              str(RATIO), str(STEP_SEED)], env=env, cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Worker results at W = 1 and W = 2 (all three processes at once)."""
    runs = {}
    procs = []
    for world in (1, 2):
        out = str(tmp_path_factory.mktemp(f"overlap_w{world}"))
        spec = {"shapes": SHAPES, "jax_rows": JAX_ROWS,
                "matrix": [{**r, "id": _row_id(r)} for r in MATRIX],
                "steps": [{**r, "id": _row_id(r) + f"-clip={r['clip']}"} for r in STEP_ROWS]}
        with open(f"{out}/spec.json", "w") as f:
            json.dump(spec, f)
        np.savez(f"{out}/inputs.npz", **_inputs(world))
        runs[world] = out
        procs += _spawn(out, world)
    logs = [p.communicate(timeout=400)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return {w: [(json.load(open(f"{out}/w{w}_rank{r}.json")),
                 dict(np.load(f"{out}/w{w}_rank{r}.npz"))) for r in range(w)]
            for w, out in runs.items()}


RESNET50_BYTES = None


def _resnet50_bytes():
    import jax.numpy as jnp

    from tpu_compressed_dp.models import resnet as jres

    global RESNET50_BYTES
    if RESNET50_BYTES is None:
        shapes = jax.eval_shape(lambda: jres.resnet50().init(jax.random.key(0),
                                                            jnp.zeros((1, 64, 64, 3))))
        RESNET50_BYTES = [4 * int(np.prod(s.shape))
                          for s in jax.tree.leaves(shapes["params"])]
    return RESNET50_BYTES


@pytest.mark.parametrize("gran", ["layerwise", "entiremodel", "bucketed"])
def test_plan_and_issue_order_match_jax_on_resnet50(gran):
    from tpu_compressed_dp_torch.parallel import dp as tdp
    from tpu_compressed_dp_torch.parallel import overlap as tov

    sizes = _resnet50_bytes()
    assert len(sizes) == 161 and sum(sizes) == 4 * 25_557_032
    rng = np.random.default_rng(7)
    for k in (1, 2, 3, 4, 8, 200):
        for mb in (1.0, 25.0):
            kw = dict(granularity=gran, sync_overlap=k, bucket_mb=mb)
            want = jov.plan_chunks(sizes, jdp.CompressionConfig(**kw))
            got = tov.plan_chunks(sizes, tdp.CompressionConfig(**kw))
            assert [dict(vars(p)) for p in got] == [dict(vars(p)) for p in want]
            assert tov.hideable_byte_fraction(got) == jov.hideable_byte_fraction(want)
            for ranks in (None, list(rng.permutation(161)), [5] * 161):
                assert ([p.index for p in tov.issue_order(got, ranks)]
                        == [p.index for p in jov.issue_order(want, ranks)])
            if gran == "entiremodel":
                assert len(got) == 1


def test_chunk_slices_of_the_state():
    from tpu_compressed_dp_torch.parallel import overlap as tov

    plan = tov.ChunkPlan(index=1, leaf_lo=3, leaf_hi=6, group_offset=2, n_groups=3, n_bytes=0)
    comp = {"q0": 0, "q2": 2, "q4": 4, "q5": 5}
    assert tov._comp_slice(comp, plan) == {"q2": 2, "q4": 4}
    assert tov._comp_slice((), plan) == ()
    assert tov._comp_slice({"q0": 0}, plan) == ()


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("row", MATRIX, ids=[_row_id(r) for r in MATRIX])
def test_chunked_sync_bitwise_to_single(results, world, row):
    for res, _ in results[world]:
        for k in (2, 4):
            assert res["matrix"][f"{_row_id(row)} K={k}"], (world, k)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("row", STEP_ROWS, ids=[_row_id(r) + f"-clip={r['clip']}"
                                                for r in STEP_ROWS])
def test_overlapped_train_step_bitwise(results, world, row):
    for res, _ in results[world]:
        assert res["steps"][_row_id(row) + f"-clip={row['clip']}"], world


def _jax_chunked(method, gran, mode, ef, k):
    kw = dict(bucket_mb=0.01) if gran == "bucketed" else {}
    cfg = jdp.CompressionConfig(method=method, granularity=gran, mode=mode, ratio=RATIO,
                                error_feedback=ef, sync_overlap=k, threshold=0.5, **kw)
    inp = _inputs(2)
    g = {n: inp[f"g0_{n}"] for n in SHAPES}
    e = {n: inp[f"e_{n}"] for n in SHAPES}
    sync = jdp.make_grad_sync(cfg, "data")

    def f(gl, el):
        local = jax.tree.map(lambda x: x[0], gl)
        efl = jax.tree.map(lambda x: x[0], el) if ef else ()
        out, new_ef, _, stats = sync(local, efl, (), jax.random.key(0))
        lead = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731
        return lead(out), lead(new_ef), lead(stats)

    fn = jax.jit(shard_map(f, mesh=make_data_mesh(2), in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data"), P("data")), check_vma=False))
    out, new_ef, stats = fn(g, e)
    return (jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, new_ef),
            {k: np.asarray(v) for k, v in stats.items()})


@pytest.mark.parametrize("i", range(len(JAX_ROWS)),
                         ids=[f"{m}-{g}-{mo}-ef={e}-K={k}" for m, g, mo, e, k in JAX_ROWS])
def test_chunked_sync_matches_jax(results, i):
    method, gran, mode, ef, k = JAX_ROWS[i]
    out, new_ef, stats = _jax_chunked(method, gran, mode, ef, k)
    for rank, (_, arrays) in enumerate(results[2]):
        for n in SHAPES:
            got = arrays[f"{i}/out/{n}"]
            want = out[n][rank]
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=n)
            if ef:
                np.testing.assert_array_equal(arrays[f"{i}/ef/{n}"].view(np.uint32),
                                              new_ef[n][rank].view(np.uint32), err_msg=n)
        for key, v in stats.items():
            np.testing.assert_array_equal(arrays[f"{i}/stat/{key}"], v[rank], err_msg=key)


def test_dawn_overlap_flag_is_bitwise():
    """The CIFAR harness carries ``--overlap``: a 2-epoch run at K = 3 ends
    with the K = 1 run's losses and accuracies exactly."""
    from tpu_compressed_dp_torch.harness import dawn

    argv = ["--synthetic", "--synthetic_n", "128", "--batch_size", "32", "--epochs", "2",
            "--compress", "bucketed", "--bucket_mb", "0.1", "--method", "randomk", "--ratio",
            "0.05", "--error_feedback", "--channels_scale", "0.125", "--device", "cpu",
            "--log_dir", ""]
    a = dawn.main(argv)
    b = dawn.main(argv + ["--overlap", "3"])
    for key in ("train loss", "train acc", "test loss", "test acc", "sent frac", "wire frac"):
        assert a[key] == b[key], key


def test_hooks_issue_chunks_in_production_order():
    """Landing gradients from tensor hooks issues each chunk when its last
    gradient lands: the issue order is ``issue_order`` over the recorded
    production ranks, which for ResNet-9 is not the reversed leaf order
    (flax sorts ``prep``, whose gradient lands last, after ``linear``)."""
    import torch

    from tpu_compressed_dp_torch.models import resnet9 as r9
    from tpu_compressed_dp_torch.models.common import param_leaves
    from tpu_compressed_dp_torch.parallel import dp as tdp
    from tpu_compressed_dp_torch.parallel import overlap as tov

    model = r9.ResNet9(channels=r9.scaled_channels(0.125), seed=0)
    params = param_leaves(model)
    cfg = tdp.CompressionConfig(method="topk", ratio=0.1, sync_overlap=4)
    chunked = tov.ChunkedSync(cfg)
    rnd = chunked.begin(params, (), (), 9)
    hooks = [p.register_hook(lambda g, i=i: rnd.land(i, g)) for i, p in enumerate(params.values())]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 32, 32, 3))
                         .astype(np.float32))
    try:
        torch.autograd.grad(model(x, train=True).square().sum(), list(params.values()))
    finally:
        for h in hooks:
            h.remove()
    issued = [plan.index for plan, _ in rnd.pending]
    assert sorted(rnd.ranks) == list(range(len(params)))
    assert issued == [p.index for p in tov.issue_order(chunked.plans, rnd.ranks)]
    assert issued != [p.index for p in tov.issue_order(chunked.plans)]
    names = list(params)
    assert rnd.ranks[names.index("prep/conv/kernel")] == len(params) - 1
    synced, _, _, stats = rnd.collect()
    want, _, _, want_stats = tdp.make_stateful_grad_sync(cfg)(
        {k: g for k, g in zip(names, rnd.grads)}, (), (), 9)
    assert all(torch.equal(synced[k], want[k]) for k in names)
    assert {k: float(v) for k, v in stats.items()} == {k: float(v) for k, v in want_stats.items()}


def test_overlap_sync_apply_is_sync_then_sgd():
    """``make_overlap_sync_apply`` (each chunk's SGD slice as it is reduced)
    leaves parameters, momentum and EF bitwise where the single sync and a
    whole-tree ``SGD.apply`` leave them."""
    import torch

    from tpu_compressed_dp_torch.parallel import dp as tdp
    from tpu_compressed_dp_torch.parallel import overlap as tov
    from tpu_compressed_dp_torch.train.optim import SGD

    rng = np.random.default_rng(3)
    shapes = {"a": (300,), "b": (4, 5), "c": (7, 3, 2, 2)}
    grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
    init = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}
    opt = SGD(lr=0.1, momentum=0.9, weight_decay=1e-3, wd_mask={"a": True, "b": False, "c": True})
    cfg = tdp.CompressionConfig(method="topk", ratio=0.1, error_feedback=True, sync_overlap=3)
    ends = []
    for fused in (False, True):
        params = {k: v.clone() for k, v in init.items()}
        state = opt.init(params)
        ef = tdp.init_ef_state(params, cfg)
        if fused:
            new_ef, _, _ = tov.make_overlap_sync_apply(cfg, opt)(params, grads, ef, (), state,
                                                                  5, 1)
        else:
            synced, new_ef, _, _ = tdp.make_stateful_grad_sync(cfg)(grads, ef, (), 5)
            opt.apply(params, synced, state, 1)
        ends.append((params, state["momentum"], new_ef))
    for a, b in zip(*ends):
        assert all(torch.equal(a[k], b[k]) for k in shapes)
