"""The port's compressed gradient sync against the JAX engine at W = 2.

The JAX side runs ``make_grad_sync`` under ``shard_map`` on a 2-device slice
of the virtual CPU mesh; the port runs it in 2 spawned processes joined by a
gloo group (``dist.all_reduce(comp) / world`` in place of ``lax.psum(comp) /
world``).  Both get the same numpy gradients and EF residuals.  The mean of
two values is order-free, so the reduced gradient, the new EF residual and
every stat must agree bitwise:

  * Top-K, Threshold-V and Adaptive-Threshold in ``off``/``auto`` (exact
    threshold) and ``force`` (histogram threshold + fused sparsify; Pallas
    interpreter vs the port's plain versions) modes;
  * Random-K (per-worker and shared masks), TernGrad and QSGD on the
    formula paths, with the JAX uniforms of each (group, rank) injected into
    the port's ``draw_uniform`` in the spawned processes;
  * TernGrad on the kernel path (``force``) with a zero dither on both sides
    (the Pallas interpreter's PRNG is a zero stub);
  * Block-Top-K, whose scores are summed in another order, on inputs with no
    block score near the threshold.

QSGD's norm is summed in another order too, so its outputs and EF agree to
one quantisation level on a few elements (stats stay exact).

The wire rows (``mode='wire'``, ids ``wire-...``) hold the port's allgather
wire engine to the JAX one the same way: the gathered payloads are
scatter-added one rank row after another in both, and the mean of two
decoded rows is order-free, so synced gradients, EF residuals and every
stat (``sent_bits`` measured from the payload tensors,
``threshold_overflow``, ``topk_surplus_dropped``, ``sync_agree``) agree
bitwise; QSGD by the contract above.  Top-K runs in ``off`` (exact
threshold, mask -> packed indices -> gather) and ``force`` (histogram
threshold, fused select+pack; the Pallas interpreter against the port's
plain version); TernGrad and QSGD s = 255 in ``force`` reach the fused
quantize+pack with a zero dither on both sides.
"""

import itertools
import json
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
SHAPES = {"a": (3000,), "b": (40,), "c": (12, 100)}
RATIO = 0.05
STEP_SEED = 1234  # the port's step seed (the JAX side's key is key(0))
GRANS = ("layerwise", "entiremodel", "bucketed")


def _cfg(method, gran, mode, ef=True, draws=None, **kw):
    if gran == "bucketed":
        kw["bucket_mb"] = 0.01  # 10485 bytes: groups [a], [b, c]
    return dict(method=method, granularity=gran, error_feedback=ef, mode=mode,
                draws=draws, kw=kw)


def _wire(method, gran, mode, ef=True, draws=None, **kw):
    c = _cfg(method, gran, mode, ef, draws, **kw)
    c["kw"]["mode"] = "wire"
    return c


CONFIGS = (
    [_cfg("topk", g, m, ef) for g, ef, m in itertools.product(
        ("layerwise", "entiremodel"), (True, False), ("off", "force"))]
    + [_cfg(meth, g, m, threshold=1.5) for meth in ("thresholdv", "adaptive_threshold")
       for m in ("auto", "force") for g in GRANS]
    + [_cfg("randomk", g, "auto", draws="jax", shared_mask=sh) for sh in (None, True)
       for g in GRANS]
    + [_cfg("terngrad", g, "auto", ef=False, draws="jax", **kw)
       for kw in ({}, {"terngrad_chunk": 1000}) for g in GRANS]
    + [_cfg("terngrad", "layerwise", "force", ef=False, draws="zero"),
       _cfg("terngrad", "entiremodel", "force", ef=False, draws="zero", terngrad_chunk=1000)]
    + [_cfg("qsgd", g, "auto", ef=False, draws="jax", qstates=s) for s in (127, 255)
       for g in GRANS]
    + [_cfg("blocktopk", g, "auto", block_size=64) for g in GRANS]
    # wire mode, allgather transport
    + [_wire("topk", g, m, ef) for g, ef, m in itertools.product(
        GRANS, (True, False), ("off", "force"))]
    # |g| >= 1.5 keeps ~13 % of a standard normal: the default 5 % capacity
    # overflows, 20 % does not; Adaptive (|g| >= max/2) keeps ~1 %
    + [_wire(meth, g, m, threshold=1.5) for meth in ("thresholdv", "adaptive_threshold")
       for m in ("auto", "force") for g in GRANS]
    + [_wire("thresholdv", "layerwise", "force", threshold=1.5, wire_cap_ratio=0.2),
       _wire("thresholdv", "entiremodel", "auto", ef=False, threshold=1.5),
       _wire("adaptive_threshold", "entiremodel", "force", wire_cap_ratio=0.002)]
    + [_wire("randomk", g, "auto", draws="jax", check_sync=True) for g in GRANS]
    + [_wire("randomk", "layerwise", "auto", ef=False, draws="jax")]
    + [_wire("blocktopk", g, "auto", block_size=bs) for bs in (64, 256) for g in GRANS]
    + [_wire("terngrad", g, "auto", ef=False, draws="jax", **kw)
       for kw in ({}, {"terngrad_chunk": 1000}) for g in GRANS]
    + [_wire("terngrad", "layerwise", "force", ef=False, draws="zero"),
       _wire("terngrad", "entiremodel", "force", ef=False, draws="zero", terngrad_chunk=1000)]
    + [_wire("qsgd", g, "auto", ef=False, draws="jax", qstates=s) for s in (127, 255)
       for g in GRANS]
    + [_wire("qsgd", g, "force", ef=False, draws="zero", qstates=255)
       for g in ("layerwise", "entiremodel")]
)


def _config_id(c):
    wire = c["kw"].get("mode") == "wire"
    if c["method"] == "topk" and not wire:  # the simulate Top-K rows keep their ids
        return f"{c['granularity']}-{c['error_feedback']}-{c['mode']}"
    extra = "-".join(f"{k}={v}" for k, v in c["kw"].items() if k not in ("bucket_mb", "mode"))
    if c["method"] in ("topk", "randomk", "thresholdv") and wire:
        extra = "-".join(x for x in (f"ef={c['error_feedback']}", extra) if x)
    return "-".join(x for x in ("wire" if wire else "", c["method"], c["granularity"],
                                c["mode"], extra) if x)


def _per_worker(c) -> bool:
    shared = jdp.CompressionConfig(**c["kw"]).resolved_shared_mask
    return c["method"] in ("randomk", "terngrad", "qsgd") and not shared


def _groups(c):
    sizes = [4 * int(np.prod(s)) for s in SHAPES.values()]
    bucket = c["kw"].get("bucket_mb", 25.0) * jdp.BUCKET_MB
    return jdp.make_leaf_groups(sizes, c["granularity"], bucket)


# one worker process: every config in turn, results to <out>/rank<r>.npz
_WORKER = r"""
import json, sys, numpy as np, torch
from tpu_compressed_dp_torch.ops import compressors, kernels
from tpu_compressed_dp_torch.parallel import dp, mesh
out, port, rank, world, ratio, step_seed = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                            int(sys.argv[4]), float(sys.argv[5]), int(sys.argv[6]))
mesh.init_process_group("cpu", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
inp = np.load(f"{out}/inputs.npz")
draw_uniform, uniform_plain = compressors.draw_uniform, kernels.uniform_plain
res = {}
for ci, spec in enumerate(inp["configs"].tolist()):
    c = json.loads(spec)
    kernels.set_pallas_mode(c["mode"])
    cfg = dp.CompressionConfig(method=c["method"], granularity=c["granularity"], ratio=ratio,
                               error_feedback=c["error_feedback"], **c["kw"])
    # the JAX uniforms of each (group, rank), keyed by the seed the port
    # derives for that group
    table = {compressors.leaf_seed(step_seed, gi, rank if c["per_worker"] else None):
             torch.from_numpy(inp[f"d{ci}_{gi}_{rank}"]) for gi in range(c["n_groups"])
             if f"d{ci}_{gi}_{rank}" in inp}
    compressors.draw_uniform = (lambda seed, n, device: table[seed]) if table else draw_uniform
    kernels.uniform_plain = ((lambda seed, n, device="cpu": torch.zeros(n))
                             if c["draws"] == "zero" else uniform_plain)
    names = ["a", "b", "c"]
    grads = {k: torch.from_numpy(inp[f"g_{k}"][rank]) for k in names}
    ef = {k: torch.from_numpy(inp[f"e_{k}"][rank]) for k in names} if cfg.error_feedback else ()
    out_g, new_ef, stats = dp.make_grad_sync(cfg)(grads, ef, step_seed)
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


def _jax_draws():
    """The uniforms the JAX engine draws for each config's (group, rank):
    ``uniform(leaf_key(key(0), gi, per_worker), (n_g,))``."""
    draws = {}
    sizes = [int(np.prod(s)) for s in SHAPES.values()]
    for ci, c in enumerate(CONFIGS):
        if c["draws"] != "jax":
            continue
        for gi, idxs in enumerate(_groups(c)):
            n_g = sum(sizes[i] for i in idxs)
            k = jax.random.fold_in(jax.random.key(0), gi)
            for r in range(WORLD):
                kr = jax.random.fold_in(k, r) if _per_worker(c) else k
                draws[f"d{ci}_{gi}_{r}"] = np.asarray(jax.random.uniform(kr, (n_g,)))
    return draws


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    out = str(tmp_path_factory.mktemp("torch_sync"))
    g, e = _inputs()
    specs = [json.dumps({**c, "per_worker": _per_worker(c), "n_groups": len(_groups(c))})
             for c in CONFIGS]
    np.savez(f"{out}/inputs.npz", configs=np.asarray(specs), **_jax_draws(),
             **{f"g_{k}": v for k, v in g.items()}, **{f"e_{k}": v for k, v in e.items()})
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, out, port, str(r), str(WORLD),
                               str(RATIO), str(STEP_SEED)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(f"{out}/rank{r}.npz")) for r in range(WORLD)]


def _jax_sync(c):
    cfg = jdp.CompressionConfig(method=c["method"], granularity=c["granularity"],
                                ratio=RATIO, error_feedback=c["error_feedback"], **c["kw"])
    g, e = _inputs()
    sync = jdp.make_grad_sync(cfg, "data")

    def f(gl, el):
        local = jax.tree.map(lambda x: x[0], gl)
        ef = jax.tree.map(lambda x: x[0], el) if cfg.error_feedback else ()
        out, new_ef, _, stats = sync(local, ef, (), jax.random.key(0))
        lead = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731
        return lead(out), lead(new_ef), lead(stats)

    old = jk.pallas_mode()
    jk.set_pallas_mode(c["mode"])
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


def _qsgd_close(got, want, step):
    """QSGD's contract: equal but where the two norms' rounding moves an
    element across a floor boundary, by one level (``step``) at most."""
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max() <= step * 1.001 + 1e-6 * np.abs(want).max()
    # the rest differ by the scales' last-bit rounding only
    assert (diff > 0.01 * step).sum() <= 5


@pytest.mark.parametrize("ci", range(len(CONFIGS)), ids=[_config_id(c) for c in CONFIGS])
def test_sync_bitwise_vs_jax(port_results, ci):
    c = CONFIGS[ci]
    out_j, ef_j, stats_j = _jax_sync(c)
    g, e = _inputs()
    for r in range(WORLD):
        got = port_results[r]
        for k in SHAPES:
            if c["method"] == "qsgd":
                # one level of the larger rank's scale (||acc|| / s), halved by the mean
                step = max(np.linalg.norm(np.concatenate([g[x][w].ravel() for x in SHAPES]
                                                         if c["granularity"] != "layerwise"
                                                         else [g[k][w].ravel()]))
                           for w in range(WORLD)) / c["kw"]["qstates"]
                _qsgd_close(got[f"{ci}/out/{k}"], out_j[k][r], step / WORLD)
                continue
            np.testing.assert_array_equal(_bits(got[f"{ci}/out/{k}"]), _bits(out_j[k][r]),
                                          err_msg=f"rank {r} synced {k}")
            if c["error_feedback"]:
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
    # sync_overlap is the train step's chunked sync (tests/test_torch_overlap.py):
    # the engines build for any K, and K < 1 is refused as in JAX
    tdp.make_grad_sync(tdp.CompressionConfig(method="topk", mode="wire", transport="sharded",
                                             sync_overlap=2))
    with pytest.raises(ValueError, match="sync_overlap"):
        tdp.CompressionConfig(sync_overlap=0)
    # PowerSGD is ported, behind the stateful sync (tests/test_torch_lowrank.py)
    with pytest.raises(ValueError, match="make_stateful_grad_sync"):
        tdp.make_grad_sync(tdp.CompressionConfig(method="powersgd"))
    with pytest.raises(ValueError):
        tdp.CompressionConfig(granularity="per-row")


@pytest.mark.parametrize("idxs", [[0, 1, 2], [1], [2], [0]])
def test_groups_lay_kernels_out_as_jax(idxs):
    """A group's flat vector is JAX's ravel of the flax leaves (conv and
    Dense kernels in the flax layout, where positions decide Random-K's
    draws, owner routing and capacity clips), and splitting it gives the
    port's leaves back."""
    import torch
    from jax.flatten_util import ravel_pytree

    from tpu_compressed_dp_torch.models.common import to_torch_layout
    from tpu_compressed_dp_torch.parallel import dp as tdp

    rng = np.random.default_rng(3)
    names = ["bn/bias", "conv/kernel", "dense/kernel"]
    flax = [rng.normal(size=s).astype(np.float32) for s in ((8,), (3, 3, 4, 8), (8, 5))]
    leaves = [torch.from_numpy(np.ascontiguousarray(to_torch_layout(k, a)))
              for k, a in zip(names, flax)]
    flat = tdp.group_concat(names, leaves, idxs)
    want, _ = ravel_pytree([flax[i] for i in idxs])
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    out = [None] * len(leaves)
    tdp.group_split(flat, names, leaves, idxs, out)
    for i in idxs:
        assert out[i].shape == leaves[i].shape and torch.equal(out[i], leaves[i])


def test_resolved_fields_and_wire_transport():
    from tpu_compressed_dp_torch.parallel import dp as tdp

    for gran, mode, shared, chunk, transport in itertools.product(
            GRANS, ("simulate", "wire"), (None, False, True), (-1, 0, 4096),
            ("allgather", "sharded", "hierarchical")):
        kw = dict(granularity=gran, mode=mode, shared_mask=shared, terngrad_chunk=chunk,
                  ratio=0.3, block_size=64, transport=transport)
        t, j = tdp.CompressionConfig(**kw), jdp.CompressionConfig(**kw)
        assert t.resolved_shared_mask == j.resolved_shared_mask
        assert t.resolved_terngrad_chunk == j.resolved_terngrad_chunk
        for name in ("none", "topk", "blocktopk", "randomk", "thresholdv",
                     "adaptive_threshold", "terngrad", "qsgd"):
            for n in (64, 150, 5000):
                assert tdp.wire_transport(name, n, t) == jdp.wire_transport(name, n, j)
