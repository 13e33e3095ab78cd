"""The port's compressed gradient sync against the JAX engine at W = 2.

The JAX side runs ``make_grad_sync`` under ``shard_map`` on a 2-device slice
of the virtual CPU mesh; the port runs it in 2 spawned processes joined by a
gloo group (``dist.all_reduce(comp) / world`` in place of ``lax.psum(comp) /
world``).  Both get the same numpy gradients and EF residuals.  The mean of
two values is order-free, so the reduced gradient, the new EF residual and
every stat must agree bitwise, in ``off`` (exact threshold) and ``force``
(histogram threshold + fused sparsify; Pallas interpreter vs the port's
plain versions) modes.
"""

import itertools
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from tpu_compressed_dp.compat import shard_map
from tpu_compressed_dp.ops import kernels as jk
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.parallel.mesh import make_data_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
CONFIGS = [dict(granularity=g, error_feedback=ef, mode=m)
           for g, ef, m in itertools.product(("layerwise", "entiremodel"), (True, False),
                                             ("off", "force"))]
SHAPES = {"a": (3000,), "b": (40,), "c": (12, 100)}
RATIO = 0.05

# one worker process: every config in turn, results to <out>/rank<r>.npz
_WORKER = r"""
import sys, numpy as np, torch
from tpu_compressed_dp_torch.ops import kernels
from tpu_compressed_dp_torch.parallel import dp, mesh
out, port, rank, world, ratio = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), float(sys.argv[5])
mesh.init_process_group("cpu", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
inp = np.load(f"{out}/inputs.npz")
res = {}
for ci, spec in enumerate(inp["configs"].tolist()):
    gran, ef_on, mode = spec.split(",")
    kernels.set_pallas_mode(mode)
    cfg = dp.CompressionConfig(method="topk", granularity=gran, ratio=ratio,
                               error_feedback=ef_on == "1")
    names = ["a", "b", "c"]
    grads = {k: torch.from_numpy(inp[f"g_{k}"][rank]) for k in names}
    ef = {k: torch.from_numpy(inp[f"e_{k}"][rank]) for k in names} if cfg.error_feedback else ()
    out_g, new_ef, stats = dp.make_grad_sync(cfg)(grads, ef)
    for k in names:
        res[f"{ci}/out/{k}"] = out_g[k].numpy()
        if cfg.error_feedback:
            res[f"{ci}/ef/{k}"] = new_ef[k].numpy()
    for k, v in stats.items():
        res[f"{ci}/stat/{k}"] = v.numpy()
np.savez(f"{out}/rank{rank}.npz", **res)
mesh.destroy()
"""


def _inputs():
    rng = np.random.default_rng(0)
    g = {k: rng.standard_normal((WORLD,) + s).astype(np.float32) for k, s in SHAPES.items()}
    e = {k: (0.1 * rng.standard_normal((WORLD,) + s)).astype(np.float32)
         for k, s in SHAPES.items()}
    return g, e


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    out = str(tmp_path_factory.mktemp("torch_sync"))
    g, e = _inputs()
    specs = [f"{c['granularity']},{int(c['error_feedback'])},{c['mode']}" for c in CONFIGS]
    np.savez(f"{out}/inputs.npz", configs=np.asarray(specs),
             **{f"g_{k}": v for k, v in g.items()}, **{f"e_{k}": v for k, v in e.items()})
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, out, port, str(r), str(WORLD),
                               str(RATIO)], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(f"{out}/rank{r}.npz")) for r in range(WORLD)]


def _jax_sync(cfg_kw):
    mode = cfg_kw["mode"]
    cfg = jdp.CompressionConfig(method="topk", granularity=cfg_kw["granularity"],
                                ratio=RATIO, error_feedback=cfg_kw["error_feedback"])
    g, e = _inputs()
    sync = jdp.make_grad_sync(cfg, "data")

    def f(gl, el):
        local = jax.tree.map(lambda x: x[0], gl)
        ef = jax.tree.map(lambda x: x[0], el) if cfg.error_feedback else ()
        out, new_ef, _, stats = sync(local, ef, (), jax.random.key(0))
        lead = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731
        return lead(out), lead(new_ef), lead(stats)

    old = jk.pallas_mode()
    jk.set_pallas_mode(mode)
    try:
        fn = jax.jit(shard_map(f, mesh=make_data_mesh(WORLD), in_specs=(P("data"), P("data")),
                               out_specs=(P("data"), P("data"), P("data")), check_vma=False))
        out, new_ef, stats = fn(g, e)
    finally:
        jk.set_pallas_mode(old)
    return (jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, new_ef),
            {k: np.asarray(v) for k, v in stats.items()})


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("ci", range(len(CONFIGS)),
                         ids=["-".join(str(v) for v in c.values()) for c in CONFIGS])
def test_sync_bitwise_vs_jax(port_results, ci):
    out_j, ef_j, stats_j = _jax_sync(CONFIGS[ci])
    for r in range(WORLD):
        got = port_results[r]
        for k in SHAPES:
            np.testing.assert_array_equal(_bits(got[f"{ci}/out/{k}"]), _bits(out_j[k][r]),
                                          err_msg=f"rank {r} synced {k}")
            if CONFIGS[ci]["error_feedback"]:
                np.testing.assert_array_equal(_bits(got[f"{ci}/ef/{k}"]), _bits(ef_j[k][r]),
                                              err_msg=f"rank {r} EF {k}")
        assert {key.split("/", 2)[2] for key in got if key.startswith(f"{ci}/stat/")} == \
            set(stats_j)
        for k, v in stats_j.items():
            assert float(got[f"{ci}/stat/{k}"]) == float(v[r]), (r, k)


def test_leaf_groups_and_config_surface():
    from tpu_compressed_dp_torch.parallel import dp as tdp

    sizes = [4 * n for n in (1728, 64, 64, 73728, 5120)]
    for gran in ("layerwise", "entiremodel", "bucketed"):
        assert tdp.make_leaf_groups(sizes, gran, 300000.0) == \
            jdp.make_leaf_groups(sizes, gran, 300000.0)
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(jdp.CompressionConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tdp.CompressionConfig)}
    assert tf == jf
    with pytest.raises(NotImplementedError, match="item 7"):
        tdp.make_grad_sync(tdp.CompressionConfig(method="topk", mode="wire"))
    with pytest.raises(ValueError):
        tdp.CompressionConfig(granularity="per-row")
