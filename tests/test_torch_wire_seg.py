"""The port's segmented wire Top-K path against the JAX engine's, at W = 1
and W = 2.

Both packages gate the path off (``_SEG_PACK_DISPATCH = False``); here both
switches are set and both run in ``force`` mode, so the real gates pass it
at every size (the histogram threshold on both sides: the Pallas
interpreter against the port's plain versions, bitwise).  The JAX segmented
pack runs with ``interpret=True``, as ``tests/test_wire.py``'s
``TestSegPackWirePath`` forces it.  The port runs in-process at W = 1 and in
2 spawned processes joined by gloo at W = 2, on the same numpy gradients and
EF residuals.  The gathered payload is scatter-added in one pass in both
packages and the mean of two values is order-free, so the synced gradient,
the EF residual and every stat (``sent_elems``, the measured ``sent_bits``,
and with EF off ``topk_surplus_dropped``) agree bitwise.

  * ``spread``: no segment holds more than 128 survivors; the path equals
    the port's default wire Top-K path (select+pack) bitwise, stats too;
  * ``concentrated``: 400 large coordinates in the first segment overflow
    its 128 slots; the overflow stays in the EF residual (with EF off it is
    reported as dropped), and the world mean of ``acc - new_ef`` is the
    synced gradient.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch
from jax.sharding import PartitionSpec as P

from tpu_compressed_dp.compat import shard_map
from tpu_compressed_dp.ops import kernels as jk
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.parallel.mesh import make_data_mesh
from tpu_compressed_dp_torch.ops import compressors as tc
from tpu_compressed_dp_torch.ops import kernels as tk
from tpu_compressed_dp_torch.parallel import dp as tdp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_SEED = 77
# case -> (leaf shapes, ratio, hot coordinates at the front of leaf "a")
CASES = {"spread": ({"a": (3000,), "b": (40,), "c": (12, 100)}, 0.01, 0),
         "concentrated": ({"a": (20000,), "b": (40,)}, 0.015, 400)}
CONFIGS = [("spread", True, "entiremodel"), ("spread", False, "entiremodel"),
           ("spread", True, "layerwise"), ("concentrated", True, "entiremodel"),
           ("concentrated", False, "entiremodel")]


def _id(c):
    return f"{c[0]}-{'ef' if c[1] else 'no-ef'}-{c[2]}"


def _inputs(case, world):
    shapes, _, hot = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    g = {k: rng.standard_normal((world,) + s).astype(np.float32) for k, s in shapes.items()}
    g["a"][:, :hot] *= 100.0
    e = {k: (0.1 * rng.standard_normal((world,) + s)).astype(np.float32)
         for k, s in shapes.items()}
    return g, e


def _cfg_kw(c):
    case, ef, gran = c
    return dict(method="topk", mode="wire", granularity=gran, ratio=CASES[case][1],
                error_feedback=ef)


def _jax_sync(c, world, monkeypatch):
    monkeypatch.setattr(jk, "_SEG_PACK_DISPATCH", True)
    monkeypatch.setattr(jk, "seg_pack_by_threshold",
                        functools.partial(jk.seg_pack_by_threshold, interpret=True))
    old = jk.pallas_mode()
    jk.set_pallas_mode("force")
    try:
        sync = jdp.make_grad_sync(jdp.CompressionConfig(**_cfg_kw(c)), "data")

        def f(gl, el):
            local = jax.tree.map(lambda x: x[0], gl)
            ef = jax.tree.map(lambda x: x[0], el) if c[1] else ()
            out, new_ef, _, stats = sync(local, ef, (), jax.random.key(0))
            lead = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731
            return lead(out), lead(new_ef), lead(stats)

        fn = jax.jit(shard_map(f, mesh=make_data_mesh(world), in_specs=(P("data"), P("data")),
                               out_specs=(P("data"), P("data"), P("data")), check_vma=False))
        out, new_ef, stats = fn(*_inputs(c[0], world))
    finally:
        jk.set_pallas_mode(old)
    return (jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, new_ef),
            {k: np.asarray(v) for k, v in stats.items()})


def _port_sync(c, g, e, rank, seg):
    """The port's sync of rank ``rank``'s inputs, through the segmented path
    (``seg``) or the default one; numpy results."""
    old_mode, old_dispatch = tk.pallas_mode(), tk._SEG_PACK_DISPATCH
    tk.set_pallas_mode("force")
    tk._SEG_PACK_DISPATCH = seg
    try:
        grads = {k: torch.from_numpy(v[rank]) for k, v in g.items()}
        ef = {k: torch.from_numpy(v[rank]) for k, v in e.items()} if c[1] else ()
        out, new_ef, stats = tdp.make_grad_sync(tdp.CompressionConfig(**_cfg_kw(c)))(
            grads, ef, STEP_SEED)
    finally:
        tk.set_pallas_mode(old_mode)
        tk._SEG_PACK_DISPATCH = old_dispatch
    return ({k: v.numpy() for k, v in out.items()},
            {k: v.numpy() for k, v in new_ef.items()} if c[1] else {},
            {k: v.numpy() for k, v in stats.items()})


# one worker process: every config, through the segmented and the default
# path, results to <out>/rank<r>.npz (keys "<config>/<seg>/<out|ef|stat>/<name>")
_WORKER = r"""
import json, sys
import numpy as np, torch
from tpu_compressed_dp_torch.ops import kernels
from tpu_compressed_dp_torch.parallel import dp, mesh
out, port, rank, world, seed = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                int(sys.argv[4]), int(sys.argv[5]))
mesh.init_process_group("cpu", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
inp = np.load(f"{out}/inputs.npz")
kernels.set_pallas_mode("force")
res = {}
for spec in json.loads(str(inp["configs"])):
    cid, kw, names = spec["id"], spec["kw"], spec["names"]
    grads = {k: torch.from_numpy(inp[f"{cid}/g/{k}"][rank]) for k in names}
    ef = ({k: torch.from_numpy(inp[f"{cid}/e/{k}"][rank]) for k in names}
          if kw["error_feedback"] else ())
    for seg in (True, False):
        kernels._SEG_PACK_DISPATCH = seg
        o, new_ef, stats = dp.make_grad_sync(dp.CompressionConfig(**kw))(grads, ef, seed)
        for k in names:
            res[f"{cid}/{seg}/out/{k}"] = o[k].numpy()
            if kw["error_feedback"]:
                res[f"{cid}/{seg}/ef/{k}"] = new_ef[k].numpy()
        for k, v in stats.items():
            res[f"{cid}/{seg}/stat/{k}"] = v.numpy()
np.savez(f"{out}/rank{rank}.npz", **res)
mesh.destroy()
"""


@pytest.fixture(scope="module")
def port_w2(tmp_path_factory):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    out = str(tmp_path_factory.mktemp("torch_wire_seg"))
    arrays, specs = {}, []
    for c in CONFIGS:
        g, e = _inputs(c[0], 2)
        specs.append({"id": _id(c), "kw": _cfg_kw(c), "names": list(g)})
        arrays.update({f"{_id(c)}/g/{k}": v for k, v in g.items()})
        arrays.update({f"{_id(c)}/e/{k}": v for k, v in e.items()})
    np.savez(f"{out}/inputs.npz", configs=np.asarray(json.dumps(specs)), **arrays)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, out, port, str(r), "2",
                               str(STEP_SEED)], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = []
    for r in range(2):
        flat = dict(np.load(f"{out}/rank{r}.npz"))
        per = {}
        for key, v in flat.items():
            cid, seg, kind, name = key.split("/")
            per.setdefault(f"{cid}/{seg}", ({}, {}, {}))[
                ("out", "ef", "stat").index(kind)][name] = v
        res.append(per)
    return res


def _port(c, world, rank, seg, port_w2):
    if world == 1:
        return _port_sync(c, *_inputs(c[0], 1), rank, seg)
    return port_w2[rank][f"{_id(c)}/{seg}"]


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _assert_same(got, want, what):
    (go, ge, gs), (wo, we, ws) = got, want
    for k in wo:
        np.testing.assert_array_equal(_bits(go[k]), _bits(wo[k]), err_msg=f"{what} synced {k}")
    assert set(ge) == set(we)
    for k in we:
        np.testing.assert_array_equal(_bits(ge[k]), _bits(we[k]), err_msg=f"{what} EF {k}")
    assert set(gs) == set(ws), (what, set(gs) ^ set(ws))
    for k in ws:
        assert float(gs[k]) == float(ws[k]), (what, k, float(gs[k]), float(ws[k]))


@pytest.fixture
def port_results(request):
    # W = 1 needs no worker processes
    return request.getfixturevalue("port_w2") if request.param == 2 else None


@pytest.mark.parametrize("port_results", [1, 2], indirect=True, ids=["W1", "W2"])
@pytest.mark.parametrize("c", CONFIGS, ids=_id)
def test_seg_path_bitwise_vs_jax(port_results, c, monkeypatch):
    world = 1 if port_results is None else 2
    out_j, ef_j, stats_j = _jax_sync(c, world, monkeypatch)
    if not c[1]:
        assert "topk_surplus_dropped" in stats_j
    for r in range(world):
        want = ({k: v[r] for k, v in out_j.items()},
                {k: v[r] for k, v in ef_j.items()} if c[1] else {},
                {k: v[r] for k, v in stats_j.items()})
        _assert_same(_port(c, world, r, True, port_results), want, f"{_id(c)} rank {r}")


@pytest.mark.parametrize("port_results", [1, 2], indirect=True, ids=["W1", "W2"])
def test_spread_equals_default_path(port_results):
    world = 1 if port_results is None else 2
    for c in CONFIGS:
        if c[0] != "spread":
            continue
        for r in range(world):
            _assert_same(_port(c, world, r, True, port_results),
                         _port(c, world, r, False, port_results), f"{_id(c)} rank {r}")


@pytest.mark.parametrize("port_results", [1, 2], indirect=True, ids=["W1", "W2"])
def test_concentrated_overflow_conserves_mass(port_results):
    world = 1 if port_results is None else 2
    c_ef, c_drop = ("concentrated", True, "entiremodel"), ("concentrated", False, "entiremodel")
    g, e = _inputs("concentrated", world)
    n = sum(v[0].size for v in g.values())
    keep = tc.topk_keep_count(n, CASES["concentrated"][1])
    for r in range(world):
        out, new_ef, stats = _port(c_ef, world, r, True, port_results)
        # the first segment's 400 hot survivors fill only its 128 slots
        assert float(stats["sent_elems"]) < keep
        assert float(stats["sent_bits"]) == 64.0 * keep
        for k in g:
            acc = g[k] + e[k]
            sent = np.sum(acc - np.stack([_port(c_ef, world, w, True, port_results)[1][k]
                                          for w in range(world)]), axis=0) / np.float32(world)
            np.testing.assert_array_equal(sent, out[k])
            # every coordinate either kept whole in the residual or sent whole
            res = new_ef[k]
            np.testing.assert_array_equal(res[res != 0], acc[r][res != 0])
        assert np.count_nonzero(new_ef["a"][:4096] == 0) == 128
        _, _, stats_drop = _port(c_drop, world, r, True, port_results)
        assert float(stats_drop["topk_surplus_dropped"]) > 0
        assert float(stats_drop["sent_elems"]) + float(stats_drop["topk_surplus_dropped"]) >= keep
