"""The port's elastic remesh and readmission across spawned gloo processes.

Each world is a set of processes on the CPU, one torch intra-op thread each,
at small widths (ResNet-9 at channels_scale 0.125, a global batch of 48,
entire-model Top-K 5 % + EF).  The worlds are started together when the
module's fixture runs and the JAX references are computed meanwhile.

  * **W = 4 simulate, ``crash=mid_collective``** after step 2, once of
    worker 1 and once of worker 3, ``ef_policy='drop'``: the victim exits
    non-zero and the survivors commit a W = 3 world.  Held to the JAX
    single-process runtime on 4 CPU devices (``ElasticRuntime.
    handle_failure`` with ``drop``, the same flax initial weights and
    batches, the JAX model in float64 as in ``tests/test_torch_resnet9_
    step.py``) after the remesh and after 2 more steps at W = 3: the loss of
    every step to rtol 1e-3 and at most 0.1 % of the survivors' kept
    coordinates (the EF zeros) differing, as the ResNet-9 step contract of
    ``tests/test_torch_resnet9_step.py`` holds them (a coordinate within
    rounding of the threshold may flip); parameters, momentum and BatchNorm
    statistics within 1e-3 of each leaf's largest entry on all but 0.1 %
    of the elements (that file holds dense steps to 1e-4; under Top-K a
    flipped coordinate moves the next step's gradients of the first layers
    by more than 1e-4 of a leaf's largest entry: 0.6 % of the momentum
    entries after the W = 3 steps of the worker-3 run, 0.01 % at 1e-3).
    The 2 steps at W = 3 start JAX's survivors from the port's state at the
    remesh, so they compare the W = 3 steps alone.  Each survivor's EF row
    passes through the remesh bitwise, as JAX's ``drop`` keeps the
    survivors' rows.  The JAX model computes in float64 and needs a local
    batch of 12 or more: at 6 images a worker even one dense step at W = 1
    moves ``layer3_residual``'s first conv by 3.5 % of its update apart.
    In both runs survivor 2 half-applies a step before the remesh (one
    parameter, one BatchNorm buffer, one momentum leaf and its step moved):
    after the remesh every survivor's replicated state is bitwise the new
    coordinator's broadcast and its EF row its own.
  * **Wire Top-K over the sharded transport**, W = 4 -> 3: the owner
    partition is rebuilt at W = 3, and the ``sent_bits_*`` of each step at
    W = 3 equal the analytic ones; the survivors' next 2 steps are bitwise
    those of a fresh 3-rank world started from their state as it was right
    after the remesh.
  * **``crash=during_remesh``** (worker 3 dies while the survivors are past
    worker 1): at ``min_world`` 2 the survivors union the dead set and
    commit W = 2 (one cascade); at ``min_world`` 3 every survivor exits
    with a ``PeerFailed`` naming [1, 3] and "below min_world", and nothing
    is committed.  No process hangs (each world has a deadline).
  * **SIGKILL and readmission**, W = 3 -> 2 -> 3, PowerSGD r 2 + EF through
    the dawn entry point: rank 2 runs under the port's watchdog
    (``harness/watchdog.py --relaunch --elastic_dir``) and is SIGKILLed in
    an epoch; the survivors detect it (gloo's error, the gossip) and remesh
    to 2; the relaunched rank is readmitted at the next epoch boundary with
    the survivors' parameters, momentum and PowerSGD warm starts bitwise
    and a zero EF, and the final ``epoch.json`` ranks are [0, 1, 2]; the
    survivors' parameters, momentum and warm starts already agree right
    after the remesh.
    Ports come from ``free_port()``.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_compressed_dp.models import resnet9 as jres
from tpu_compressed_dp.models.common import init_model, make_normalizing_apply_fn
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.parallel.mesh import make_data_mesh
from tpu_compressed_dp.train import elastic as je
from tpu_compressed_dp.train import optim as joptim
from tpu_compressed_dp.train import schedules as jsched
from tpu_compressed_dp.train import step as jstep
from tpu_compressed_dp.train.state import TrainState as JState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 48
SCALE = 0.125
STEPS = 5
KILL = 2
MEAN, STD = [125.3, 123.0, 113.9], [63.0, 62.1, 66.7]
TOPK = dict(method="topk", ratio=0.05, error_feedback=True, granularity="entiremodel")
WIRE = dict(TOPK, mode="wire", transport="sharded")
PT = 20.0  # the chaos worlds' peer timeout, seconds (no detection waits on it)

# One rank of a world: argv out_dir port rank world label.  The world's
# runs are described in inputs.npz's meta; results go to <label>_rank<r>.npz.
_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from tpu_compressed_dp_torch.models import common as tcommon
from tpu_compressed_dp_torch.models import resnet9 as tres
from tpu_compressed_dp_torch.parallel import dp as tdp, mesh
from tpu_compressed_dp_torch.train import elastic as te, optim as toptim
from tpu_compressed_dp_torch.train import schedules as tsched, step as tstep
from tpu_compressed_dp_torch.train.rendezvous import Rendezvous
from tpu_compressed_dp_torch.train.state import TrainState
from tpu_compressed_dp_torch.utils.chaos import ChaosCrash, CrashInjector

out, label = sys.argv[1], sys.argv[5]
port, rank, world = (int(a) for a in sys.argv[2:5])
inp = np.load(f"{out}/inputs.npz")
meta = json.loads(str(inp["meta"]))
run = meta["runs"][label]
mesh.init_process_group("cpu", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                        rank=rank, timeout_s=meta["pt"])


def flat(tree, prefix=""):
    res = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            res.update(flat(v, prefix + k + "/"))
        else:
            res[prefix + k] = np.array(v.detach() if isinstance(v, torch.Tensor) else v)
    return res


def nest(keys):
    tree = {}
    for k in keys:
        node = tree
        *path, leaf = k.split("/")[1:]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = inp[k]
    return tree


def snap(state, tag, res):
    for k, v in flat(tres.leaves_to_flax(tres.param_leaves(state.model))).items():
        res[f"{tag}/p/{k}"] = v
    for k, v in flat(tres.leaves_to_flax(state.opt_state["momentum"])).items():
        res[f"{tag}/m/{k}"] = v
    for k, v in flat(tres.leaves_to_flax(state.ef) if state.ef != () else {}).items():
        res[f"{tag}/ef/{k}"] = v
    for k, v in state.model.named_buffers():
        res[f"{tag}/s/{k.replace('.', '/')}"] = v.detach().numpy().copy()


def build(cfg_kw):
    model = tres.ResNet9(channels=tres.scaled_channels(meta["scale"]), seed=1, device="cpu")
    tres.load_flax_params(model, nest([k for k in inp.files if k.startswith("p/")]),
                          nest([k for k in inp.files if k.startswith("s/")]))
    sched = tsched.piecewise_linear([0, 3, 6], [0.0, 0.4, 0.1])
    bs = np.float32(meta["bs"])
    opt = toptim.SGD(lr=lambda s: sched(np.float32(s)) / bs, momentum=0.9, nesterov=True,
                     weight_decay=5e-4 * meta["bs"])
    cfg = tdp.CompressionConfig(**cfg_kw)
    leaves = tres.param_leaves(model)
    state = TrainState.create(model, opt.init(leaves), tdp.init_ef_state(leaves, cfg), seed=1)
    step = tstep.make_train_step(tcommon.make_normalizing_apply_fn(meta["mean"], meta["std"]),
                                 opt, cfg, grad_scale=float(meta["bs"]))
    return state, step


def local(s, r, w):
    per = meta["bs"] // w
    return {"input": torch.from_numpy(inp[f"x{s}"][r * per:(r + 1) * per]),
            "target": torch.from_numpy(inp[f"y{s}"][r * per:(r + 1) * per])}


res = {}
if run.get("fresh"):
    # a fresh world from the dumped post-remesh state of survivor run["ranks"][rank]
    dump = np.load(f"{out}/{run['fresh']}_rank{run['ranks'][rank]}.npz")
    state, step = build(run["cfg"])
    src = {k: dump[k] for k in dump.files}
    with torch.no_grad():
        for prefix, tgt in (("p", tres.param_leaves(state.model)),
                            ("m", state.opt_state["momentum"]), ("ef", state.ef)):
            vals = {}
            for k in src:
                if k.startswith(f"remesh/{prefix}/"):
                    node = vals
                    *path, leaf = k[len(f"remesh/{prefix}/"):].split("/")
                    for p in path:
                        node = node.setdefault(p, {})
                    node[leaf] = src[k]
            for name, t in tres.flax_to_leaves(state.model, vals).items():
                tgt[name].copy_(t)
        for k, v in state.model.named_buffers():
            v.copy_(torch.from_numpy(src[f"remesh/s/{k.replace('.', '/')}"]))
    state.step = int(src["remesh_step"])
    for s in range(state.step, meta["steps"]):
        state, _ = step(state, local(s, rank, world))
    snap(state, "final", res)
else:
    state, step = build(run["cfg"])
    crash = CrashInjector(meta["kill"], mode="mid_collective", worker=run["victim"])
    cascade = (CrashInjector(meta["kill"], mode="during_remesh", worker=run["cascade"])
               if "cascade" in run else None)
    edir = f"{out}/{label}_el"
    el = te.ElasticRuntime(te.ElasticConfig(gossip_dir=edir, rank=rank, peer_timeout_s=meta["pt"],
                                            min_world=run.get("min_world", 2)),
                           crash=cascade, rendezvous=Rendezvous(edir, rank, base_port=port),
                           device="cpu", log=lambda s: None)
    for s in range(meta["steps"]):
        state, m = step(state, local(s, el.rank, el.world))
        res[f"loss{s}"] = float(m["loss"])
        for k, v in m.items():
            if k.startswith("comm/"):
                res[f"m{s}/{k}"] = float(v)
        try:
            crash.check(s, phase="mid_collective")
        except ChaosCrash as err:
            if run.get("perturb") == rank:
                # a partial write this survivor alone made before the failure
                with torch.no_grad():
                    next(iter(tres.param_leaves(state.model).values())).add_(1.0)
                    next(iter(state.opt_state["momentum"].values())).add_(1.0)
                    next(b for n, b in state.model.named_buffers() if n.endswith(".mean")).add_(1.0)
                state.step += 7
                res["perturbed"] = True
            pre = flat(tres.leaves_to_flax(state.ef))
            try:
                state = el.handle_failure(state, el.failure_from(err))
            except te.PeerFailed as pf:
                print(f"exit: {pf}", flush=True)
                sys.exit(3)
            snap(state, "remesh", res)
            res["remesh_step"] = state.step
            res["ef_held"] = all(np.array_equal(v.view(np.uint32),
                                                res[f"remesh/ef/{k}"].view(np.uint32))
                                 for k, v in pre.items())
            res["ranks"] = np.asarray(el.ranks)
            res["new_rank"] = el.rank
            res["cascades"] = el.cascade_count
    snap(state, "final", res)
np.savez(f"{out}/{label}_rank{rank}.npz", **res)
mesh.destroy()
"""


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


def _batches():
    rng = np.random.default_rng(5)
    return [{"input": rng.integers(0, 256, (BS, 32, 32, 3), dtype=np.uint8),
             "target": rng.integers(0, 10, (BS,)).astype(np.int32)} for _ in range(STEPS)]


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


def _start(out, label, world):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    port = str(free_port())
    return [subprocess.Popen([sys.executable, "-c", _WORKER, out, port, str(r), str(world),
                              label], env=_env(), cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _finish(procs, timeout=240):
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], logs


RUNS = {"w1": dict(cfg=TOPK, victim=1, perturb=2), "w3": dict(cfg=TOPK, victim=3, perturb=2),
        "wire": dict(cfg=WIRE, victim=1),
        "cascade2": dict(cfg=TOPK, victim=1, cascade=3, min_world=2),
        "cascade3": dict(cfg=TOPK, victim=1, cascade=3, min_world=3)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every chaos world started at once; the JAX references are computed
    while they run; then the wire run's fresh world."""
    out = str(tmp_path_factory.mktemp("torch_elastic_world"))
    params, stats = _flax_init()
    meta = dict(runs=RUNS, bs=BS, scale=SCALE, steps=STEPS, kill=KILL, mean=MEAN, std=STD,
                pt=PT)
    arrays = {f"p/{k}": v for k, v in _flat(params).items()}
    arrays.update({f"s/{k}": v for k, v in _flat(stats).items()})
    for s, b in enumerate(_batches()):
        arrays[f"x{s}"], arrays[f"y{s}"] = b["input"], b["target"]
    fresh = {"fresh_wire": dict(cfg=WIRE, fresh="wire", ranks=[0, 2, 3])}
    np.savez(f"{out}/inputs.npz", meta=json.dumps({**meta, "runs": {**RUNS, **fresh}}),
             **arrays)
    procs = {label: _start(out, label, 4) for label in RUNS}
    jax_runs = _jax_elastic((1, 3))
    done = {label: _finish(p) for label, p in procs.items()}
    load = lambda label, r: dict(np.load(f"{out}/{label}_rank{r}.npz"))  # noqa: E731
    for v, (losses, at_remesh, then) in list(jax_runs.items()):
        if done[f"w{v}"][0] == [0 if r != v else 3 for r in range(4)]:
            # steps 3-4 on JAX's 3 survivors from the port's state at the remesh
            tail, final = then([load(f"w{v}", r) for r in range(4) if r != v])
            jax_runs[v] = (losses + tail, at_remesh, final)
    fresh_done = _finish(_start(out, "fresh_wire", 3)) if done["wire"][0][1] == 3 else None
    return dict(out=out, done=done, jax=jax_runs, load=load, fresh=fresh_done)


def _jax_elastic(victims):
    """The JAX single-process run: steps 0-2 on 4 devices, then for each
    victim the ``drop`` remesh past it.  Returns ``{victim: (losses, the
    state at the remesh, then)}``; ``then(rows)`` runs steps 3-4 on the 3
    survivors from the port's state at the remesh."""
    with jax.enable_x64(True):
        params, stats = _flax_init()
        f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        sched = jsched.piecewise_linear([0, 3, 6], [0.0, 0.4, 0.1])
        opt = joptim.SGD(lr=lambda step: sched(step / 1) / BS, momentum=0.9, nesterov=True,
                         weight_decay=5e-4 * BS)
        cfg = jdp.CompressionConfig(**TOPK)
        state = JState.create(f64(params), f64(stats), opt.init(f64(params)),
                              jdp.init_ef_state(params, cfg, 4), jax.random.key(1))

        def step_for(mesh):
            return jstep.make_train_step(
                make_normalizing_apply_fn(_flax_module(jnp.float64), MEAN, STD), opt, cfg, mesh,
                grad_scale=float(BS), donate=False)

        mesh = make_data_mesh(4)
        step = step_for(mesh)
        losses = []
        batches = _batches()
        for s in range(KILL + 1):
            state, m = step(state, {k: jnp.asarray(v) for k, v in batches[s].items()})
            losses.append(float(m["loss"]))
        out = {}
        for victim in victims:
            el = je.ElasticRuntime(je.ElasticConfig(ef_policy="drop"), mesh, log=lambda s: None)
            at_remesh = el.handle_failure(state, je.PeerFailed((victim,), step=KILL))

            def then(rows, el=el, at_remesh=at_remesh, step=step_for(el.mesh)):
                with jax.enable_x64(True):
                    st, tail = _jax_from_port(at_remesh, rows, el.mesh), []
                    for s in range(KILL + 1, STEPS):
                        st, m = step(st, {k: jnp.asarray(v) for k, v in batches[s].items()})
                        tail.append(float(m["loss"]))
                    return tail, _jax_snap(st)

            out[victim] = (list(losses), _jax_snap(at_remesh), then)
        return out


def _jax_from_port(jstate, rows, mesh):
    """``jstate`` with the port's state after the remesh, placed on
    ``mesh``: new rank 0's parameters, momentum and BatchNorm statistics,
    and each new rank's EF row (``rows``, the loaded results in new-rank
    order)."""
    got = rows[0]

    def put(tree, tag, part):
        return jax.tree_util.tree_map_with_path(
            lambda path, leaf: np.asarray(got[f"{tag}/{part}/" + "/".join(
                str(getattr(k, "key", k)) for k in path)], np.float64).reshape(leaf.shape),
            tree)

    with jax.enable_x64(True):
        ef = jax.tree_util.tree_map_with_path(
            lambda path, leaf: np.stack([np.asarray(r["remesh/ef/" + "/".join(
                str(getattr(k, "key", k)) for k in path)]).reshape(leaf.shape[1:])
                for r in rows]).astype(np.asarray(leaf).dtype), jax.device_get(jstate.ef))
        host = jax.device_get(jstate)
        host = host.replace(params=put(host.params, "remesh", "p"),
                            batch_stats=put(host.batch_stats, "remesh", "s"),
                            opt_state={**host.opt_state, "momentum": put(
                                host.opt_state["momentum"], "remesh", "m")}, ef=ef)
        return host.with_mesh_sharding(mesh)


def _jax_snap(state):
    return {"p": _flat(state.params), "m": _flat(state.opt_state["momentum"]),
            "s": _flat(state.batch_stats), "ef": _flat(state.ef)}


def _contract(got, want, what):
    """All but 0.1 % of the elements within 1e-3 of the leaf's largest
    entry (and 1e-6 absolute)."""
    bad = total = 0
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64).reshape(w.shape)
        tol = 1e-3 * np.abs(w).max() + 1e-6
        bad += int((np.abs(g - w) > tol).sum())
        total += w.size
    assert bad <= 1e-3 * total, f"{what}: {bad} of {total} elements outside the contract"


def _kept_differ(got_ef, want_ef):
    kept_j = np.concatenate([(np.asarray(v) == 0).ravel() for v in want_ef.values()])
    kept_t = np.concatenate([(got_ef[k] == 0).ravel() for k in want_ef])
    assert kept_j.sum() > 0
    return int((kept_j != kept_t).sum()), int(kept_j.sum())


@pytest.mark.parametrize("victim", [1, 3])
def test_w4_chaos_remesh_holds_to_jax_drop(worlds, victim):
    label = f"w{victim}"
    rcs, logs = worlds["done"][label]
    survivors = [r for r in range(4) if r != victim]
    assert rcs[victim] == 3 and "among the declared dead" in logs[victim], logs[victim][-2000:]
    assert all(rcs[r] == 0 for r in survivors), [lg[-2000:] for lg in logs]
    with open(f"{worlds['out']}/{label}_el/epoch.json") as f:
        rec = json.load(f)
    assert rec["epoch"] == 1 and rec["ranks"] == survivors and rec["coordinator"] == 0
    losses, at_remesh, final = worlds["jax"][victim]
    snaps = {"remesh": at_remesh, "final": final}
    differ = {"remesh": [0, 0], "final": [0, 0]}
    for new, r in enumerate(survivors):
        got = worlds["load"](label, r)
        assert bool(got["ef_held"]) and int(got["new_rank"]) == new
        assert list(got["ranks"]) == survivors and int(got["remesh_step"]) == KILL + 1
        for s in range(STEPS):
            np.testing.assert_allclose(float(got[f"loss{s}"]), losses[s], rtol=1e-3)
        for tag in ("remesh", "final"):
            want = snaps[tag]
            for part in ("p", "m", "s"):
                _contract({k[len(f"{tag}/{part}/"):]: v for k, v in got.items()
                           if k.startswith(f"{tag}/{part}/")}, want[part],
                          f"{label} rank {r} {tag} {part}")
            ef = {k[len(f"{tag}/ef/"):]: v for k, v in got.items()
                  if k.startswith(f"{tag}/ef/")}
            ef_j = {k: v[new] for k, v in want["ef"].items()}
            assert all(v.shape[0] == 3 for v in want["ef"].values())
            d, kept = _kept_differ(ef, ef_j)
            differ[tag] = [differ[tag][0] + d, differ[tag][1] + kept]
    for tag, (d, kept) in differ.items():
        # the survivors' kept coordinates, summed over their EF rows
        assert d <= 1e-3 * kept, (label, tag, d, kept)


@pytest.mark.parametrize("victim", [1, 3])
def test_remesh_agrees_the_coordinators_replicated_state(worlds, victim):
    """Survivor 2 changed a parameter, a BatchNorm buffer, a momentum leaf
    and its step just before the failure (a half-applied step); after the
    remesh every survivor's parameters, momentum, BatchNorm buffers and
    step are bitwise the new coordinator's (original rank 0), and each EF
    row is the survivor's own."""
    label = f"w{victim}"
    coord = worlds["load"](label, 0)
    keys = [k for k in coord if k.startswith(("remesh/p/", "remesh/m/", "remesh/s/"))]
    assert any(k.endswith("bn/mean") for k in keys)
    for r in (r for r in range(4) if r != victim):
        got = worlds["load"](label, r)
        assert bool(got.get("perturbed", False)) == (r == 2)
        assert bool(got["ef_held"]) and int(got["remesh_step"]) == KILL + 1
        for k in keys:
            assert got[k].tobytes() == coord[k].tobytes(), (label, r, k)


def test_wire_sharded_remesh_to_w3(worlds):
    """The sharded owner partition at W = 3, the analytic bits, and the
    survivors' 2 steps bitwise a fresh 3-rank world's."""
    from tpu_compressed_dp_torch.parallel import dp as tdp
    from tpu_compressed_dp_torch.models import resnet9 as tres

    rcs, logs = worlds["done"]["wire"]
    assert rcs == [0, 3, 0, 0], [lg[-2000:] for lg in logs]
    sizes = [p.numel() for p in tres.param_leaves(
        tres.ResNet9(channels=tres.scaled_channels(SCALE), seed=1, device="cpu")).values()]
    n = sum(sizes)
    cfg = tdp.CompressionConfig(**WIRE)
    for w, steps in ((4, range(KILL + 1)), (3, range(KILL + 1, STEPS))):
        route, ret = tdp._sharded_group_bits("topk", n, w, cfg)
        for r in (0, 2, 3):
            got = worlds["load"]("wire", r)
            for s in steps:
                assert got[f"m{s}/comm/sent_bits_alltoall"] == route, (w, s)
                assert got[f"m{s}/comm/sent_bits_allgather"] == ret, (w, s)
                assert got[f"m{s}/comm/sent_bits"] == route + ret
    frcs, flogs = worlds["fresh"]
    assert frcs == [0, 0, 0], [lg[-2000:] for lg in flogs]
    for new, r in enumerate((0, 2, 3)):
        got, fresh = worlds["load"]("wire", r), worlds["load"]("fresh_wire", new)
        keys = [k for k in got if k.startswith("final/")]
        assert keys and sorted(keys) == sorted(k for k in fresh if k.startswith("final/"))
        for k in keys:
            assert np.array_equal(got[k].view(np.uint32), fresh[k].view(np.uint32)), k


def test_during_remesh_cascade_and_min_world_refusal(worlds):
    rcs, logs = worlds["done"]["cascade2"]
    assert rcs == [0, 3, 0, 3], [lg[-2000:] for lg in logs]
    assert "among the declared dead" in logs[1] and "among the declared dead" in logs[3]
    with open(f"{worlds['out']}/cascade2_el/epoch.json") as f:
        assert json.load(f)["ranks"] == [0, 2]
    for r in (0, 2):
        got = worlds["load"]("cascade2", r)
        assert int(got["cascades"]) == 1 and list(got["ranks"]) == [0, 2]
        assert np.isfinite([got[f"loss{s}"] for s in range(STEPS)]).all()
    rcs, logs = worlds["done"]["cascade3"]
    assert rcs == [3, 3, 3, 3], [lg[-2000:] for lg in logs]
    for r in (0, 2):
        assert "[1, 3] failed" in logs[r] and "below min_world 3" in logs[r], logs[r][-2000:]
    assert not os.path.exists(f"{worlds['out']}/cascade3_el/epoch.json")


# the readmission run: dawn with PowerSGD, each rank's transitions recorded
_DAWN = r"""
import json, os, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from tpu_compressed_dp_torch.harness import dawn
from tpu_compressed_dp_torch.train import elastic

out, argv = sys.argv[1], sys.argv[2:]
rank = int(argv[argv.index("--process_id") + 1])
rec = {}
rb, jw, hf = (elastic.ElasticRuntime.rejoin_barrier, elastic.ElasticRuntime.join_world,
              elastic.ElasticRuntime.handle_failure)


def digests(state):
    import hashlib
    out = {}
    for key, tensors in (("model", state.model.state_dict().values()),
                         ("momentum", state.opt_state["momentum"].values()),
                         ("comp", state.comp.values()), ("ef", state.ef.values())):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().numpy().tobytes())
        out[key] = h.hexdigest()
    out["ef_zero"] = all(not bool(t.any()) for t in state.ef.values())
    return out


def handle_failure(self, state, failure):
    state = hf(self, state, failure)
    rec["remesh"] = {"ranks": list(self.ranks), "failed": list(failure.failed), **digests(state)}
    return state


def rejoin_barrier(self, state):
    if "remesh" in rec and "readmit" not in rec:
        deadline = time.time() + 90
        while not set(self.rendezvous.pending_joins()) - set(self.ranks):
            assert time.time() < deadline, "the relaunched rank never asked to join"
            time.sleep(0.05)
    state, grew = rb(self, state)
    if grew:
        rec["readmit"] = {"ranks": list(self.ranks), **digests(state)}
    return state, grew


def join_world(self, state, decision, **kw):
    state = jw(self, state, decision, **kw)
    rec["joined"] = {"ranks": list(self.ranks), **digests(state)}
    return state


elastic.ElasticRuntime.handle_failure = handle_failure
elastic.ElasticRuntime.rejoin_barrier = rejoin_barrier
elastic.ElasticRuntime.join_world = join_world
rec["summary"] = dawn.main(argv)
with open(f"{out}/dawn_rank{rank}.json", "w") as f:
    json.dump(rec, f, default=str)
"""


def _child_of(ppid):
    for pid in os.listdir("/proc"):
        if pid.isdigit():
            try:
                with open(f"/proc/{pid}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == ppid:
                        return int(pid)
            except (OSError, ValueError, IndexError):
                continue
    return None


def test_sigkill_and_readmission_w3_2_3(tmp_path):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    out, port = str(tmp_path), free_port()
    hb, edir = f"{out}/hb.json", f"{out}/el"
    argv = ["--synthetic", "--synthetic_n", "96", "--batch_size", "24", "--epochs", "6",
            "--compress", "layerwise", "--method", "powersgd", "--rank", "2",
            "--error_feedback", "--momentum", "0.9", "--device", "cpu", "--channels_scale",
            str(SCALE), "--log_dir", "", "--elastic", "--elastic_dir", edir, "--peer_timeout",
            "8", "--heartbeat", hb, "--heartbeat_interval", "0.5", "--coordinator",
            f"127.0.0.1:{port}", "--num_processes", "3"]
    cmd = [sys.executable, "-c", _DAWN, out]
    procs = [subprocess.Popen(cmd + argv + ["--process_id", str(r)], env=_env(), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    # rank 2 under the watchdog; its heartbeat's age (20 s) outlasts the
    # survivors' detection (at most 2 x the peer timeout, 8 s: a loaded
    # machine's slow step must not read as a death), and the grace (30 s)
    # covers a launch's imports
    procs.append(subprocess.Popen(
        [sys.executable, "-m", "tpu_compressed_dp_torch.harness.watchdog", "--relaunch",
         "--heartbeat", f"{hb}.rank2", "--elastic_dir", edir, "--interval", "0.2", "--grace",
         "30", "--max_age", "20", "--backoff", "0.2", "--max_relaunches", "3", "--",
         *cmd, *argv, "--process_id", "2"], env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
    try:
        deadline, victim = time.time() + 120, None
        while victim is None:
            assert time.time() < deadline and all(p.poll() is None for p in procs)
            try:
                with open(f"{hb}.rank2") as f:
                    if int(json.load(f).get("epoch", -1)) >= 0:
                        victim = _child_of(procs[2].pid)
            except (OSError, ValueError):
                pass
            time.sleep(0.02)
        os.kill(victim, signal.SIGKILL)
    finally:
        rcs, logs = _finish(procs, timeout=180)
    assert rcs == [0, 0, 0], [lg[-3000:] for lg in logs]
    recs = {r: json.load(open(f"{out}/dawn_rank{r}.json")) for r in range(3)}
    with open(f"{edir}/epoch.json") as f:
        assert json.load(f)["ranks"] == [0, 1, 2]
    for r in (0, 1):
        rm = recs[r]["remesh"]
        assert rm["ranks"] == [0, 1] and rm["failed"] == [2]
        assert recs[r]["readmit"]["ranks"] == [0, 1, 2] and recs[r]["summary"]["world"] == 3
    for key in ("model", "momentum", "comp"):
        # the survivors agree right after the remesh, as at the readmission
        assert recs[0]["remesh"][key] == recs[1]["remesh"][key], key
    j = recs[2]["joined"]
    assert j["ef_zero"] and j["ranks"] == [0, 1, 2] and "TCDP_RENDEZVOUS_EPOCH" not in os.environ
    for key in ("model", "momentum", "comp"):
        assert {recs[r]["readmit"][key] for r in (0, 1)} == {j[key]}, key
    assert recs[2]["summary"]["epoch"] == 6 and np.isfinite(recs[2]["summary"]["train loss"])
    assert "watchdog: spawn: rejoin hint" in logs[2]


# an entry point's main(argv) in one rank of a harness world; the summary
# it returns goes to <out>/summary_rank<process_id>.json
_HARNESS = r"""
import importlib, json, sys
import torch
torch.set_num_threads(1)
out, module, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
summary = importlib.import_module(module).main(argv)
rank = argv[argv.index("--process_id") + 1]
with open(f"{out}/summary_rank{rank}.json", "w") as f:
    json.dump(summary, f, default=str)
"""


def harness_world(module, argv, world, out, timeout=240):
    """``module.main`` on ``world`` gloo processes on the CPU joined through
    ``--coordinator`` (a ``free_port()``), each with ``--process_id`` and
    ``--elastic_dir <out>/el``: their exit codes, logs, summaries (None for
    a rank that wrote none) and the committed world (None where nothing
    was committed)."""
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    os.makedirs(out, exist_ok=True)
    port = free_port()
    common = [*argv, "--device", "cpu", "--elastic", "--elastic_dir", f"{out}/el",
              "--coordinator", f"127.0.0.1:{port}", "--num_processes", str(world)]
    procs = [subprocess.Popen([sys.executable, "-c", _HARNESS, str(out), module, *common,
                               "--process_id", str(r)], env=_env(), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    rcs, logs = _finish(procs, timeout)
    summaries = []
    for r in range(world):
        path = f"{out}/summary_rank{r}.json"
        summaries.append(json.load(open(path)) if os.path.exists(path) else None)
    from tpu_compressed_dp_torch.train.rendezvous import read_epoch

    return rcs, logs, summaries, read_epoch(f"{out}/el")
