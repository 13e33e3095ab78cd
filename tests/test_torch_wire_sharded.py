"""The port's owner-sharded and hierarchical wire transports against the JAX
package.

  * the static geometry (``make_shard_plan``, ``owner_bounds``,
    ``owner_of_unit``, ``sharded_payload_bits``, ``make_hier_plan``,
    ``hier_axis_groups``, ``hier_payload_bits``) equals the JAX functions'
    over a grid of group sizes, keep counts, worlds 1-8, pod counts and
    capacity factors, ragged tails included;
  * ``fused_bucket_route_plain`` is bitwise equal to
    ``fused_bucket_route(interpret=True)`` (the Pallas window copy, which
    keeps a ``-0.0`` and a NaN's payload), and to the JAX ``[W*cap+1]``
    scatter build on data without signed zeros (the scatter adds into zeros,
    turning ``-0.0`` into ``+0.0``); ``route_buckets_plain`` (the one-launch
    route's buckets and ``accepted``) to that window copy and the JAX
    ``_per_dest_slots``' ``accepted``; the plain twin of the route kernel's
    lower-bound search to the count-based starts;
  * at W = 2 and W = 4 the port runs in spawned processes joined by gloo
    (subgroups for the hierarchical pods and columns), the JAX engine under
    ``shard_map`` on 2 and 4 CPU devices, on the same numpy gradients and EF
    residuals.  The owner reduce adds rank rows in rank order in both, and a
    pod sum of two is order-free, so synced gradients, EF residuals and
    every stat (``shard_overflow`` and the measured ``sent_bits_*`` split
    included) agree bitwise: Top-K (EF on and off), Threshold-V and
    Block-Top-K (block 16) over ``sharded`` and ``hierarchical`` (2 pods; 1
    pod at W = 2; 4 one-chip pods at W = 4), at lossless and default
    capacity factors, ``pallas_mode`` auto and force, entiremodel, layerwise
    and bucketed; and the simulate engine's counterfactual billing of both
    (its stats bitwise; its dense all-reduce of four rows within an ulp,
    summed in another order by gloo than by XLA);
  * under forced clipping the EF identity holds at W = 4: the world mean of
    ``acc - new_ef`` is the synced gradient;
  * the quantizers' allgather combine at W = 4 (entiremodel, kernel path,
    zero dither): both packages add the four decoded rows rank after rank,
    so TernGrad's synced gradient is bitwise the JAX one; QSGD's agrees by
    its norm contract; the stats of both bitwise.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``; ``chip_smoke.py``).
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
import torch
from jax.sharding import PartitionSpec as P

from tpu_compressed_dp.compat import shard_map
from tpu_compressed_dp.ops import kernels as jk
from tpu_compressed_dp.ops import wire_sharded as jws
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.parallel.mesh import make_data_mesh
from tpu_compressed_dp_torch.ops import kernels as tk
from tpu_compressed_dp_torch.ops import wire_sharded as tws
from tpu_compressed_dp_torch.parallel import dp as tdp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"a": (3000,), "b": (40,), "c": (12, 100)}
RATIO = 0.05
STEP_SEED = 1234
LOSSLESS = 1e6  # capacity factors at which every cap clamps to its lossless bound
FACTOR_KEYS = ("shard_route_factor", "shard_return_factor", "hier_route_factor_ici",
               "hier_route_factor_dcn")


@pytest.fixture(autouse=True)
def _modes():
    j_mode, t_mode = jk.pallas_mode(), tk.pallas_mode()
    yield
    jk.set_pallas_mode(j_mode)
    tk.set_pallas_mode(t_mode)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

FACTORS = ((1.25, 1.25), (LOSSLESS, LOSSLESS), (0.5, 100.0), (3.0, 0.1))


@pytest.mark.parametrize("world", range(1, 9))
def test_shard_plan_matches_jax(world):
    for n_units in (1, 3, 7, 10, 64, 1000, 70001):
        for keep in sorted({1, max(n_units // 4, 1), n_units}):
            for unit in (1, 16):
                for rf, tf in FACTORS:
                    args = (n_units, keep, world, unit, rf, tf)
                    got, want = tws.make_shard_plan(*args), jws.make_shard_plan(*args)
                    assert dataclasses.astuple(got) == dataclasses.astuple(want), args
                    assert tws.sharded_payload_bits(*args) == jws.sharded_payload_bits(*args)
                    assert tws.owner_bounds(got) == jws.owner_bounds(want)
                    if n_units <= 1000:
                        assert ([tws.owner_of_unit(u, got) for u in range(n_units)]
                                == [jws.owner_of_unit(u, want) for u in range(n_units)])
    plan = tws.make_shard_plan(10, 4, world, 1, LOSSLESS, LOSSLESS)
    for bad in (-1, 10):
        with pytest.raises(ValueError):
            tws.owner_of_unit(bad, plan)


@pytest.mark.parametrize("n_units", [1, 3, 7, 10, 64, 1000])
def test_remesh_partition_covers_exactly(n_units):
    # TestRemeshPartition's ragged tails: the bounds tile [0, n_units) at
    # the old and the new world, and agree with the JAX ones
    for world in (4, 3):
        args = (n_units, max(n_units // 4, 1), world, 1, LOSSLESS, LOSSLESS)
        bounds = tws.owner_bounds(tws.make_shard_plan(*args))
        assert bounds == jws.owner_bounds(jws.make_shard_plan(*args))
        assert bounds[0][0] == 0 and bounds[-1][1] == n_units
        assert all(hi == lo for (_, hi), (lo, _) in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("world", range(1, 9))
def test_hier_plan_matches_jax(world):
    for pods in range(1, 9):
        if world % pods:
            for pkg in (tws, jws):
                with pytest.raises(ValueError):
                    pkg.hier_axis_groups(world, pods)
                with pytest.raises(ValueError):
                    pkg.make_hier_plan(1000, 50, world, pods, 1.25, 1.25)
            continue
        assert tws.hier_axis_groups(world, pods) == jws.hier_axis_groups(world, pods)
        for n in (1, 5, 40, 4240, 70001):
            for keep in sorted({1, max(n // 20, 1), n}):
                for fi, fd in FACTORS:
                    args = (n, keep, world, pods, fi, fd)
                    got, want = tws.make_hier_plan(*args), jws.make_hier_plan(*args)
                    assert (dataclasses.astuple(got)[:-1] == dataclasses.astuple(want)[:-1]
                            and dataclasses.astuple(got.dcn) == dataclasses.astuple(want.dcn))
                    assert tws.hier_payload_bits(*args) == jws.hier_payload_bits(*args)


def test_group_bits_match_jax():
    for world in (2, 4, 8):
        for pods in (1, 2):
            kw = dict(ratio=RATIO, block_size=16, dp_pods=pods, wire_cap_ratio=0.05,
                      shard_route_factor=1.25, shard_return_factor=0.7)
            t, j = tdp.CompressionConfig(**kw), jdp.CompressionConfig(**kw)
            for name in ("topk", "blocktopk", "thresholdv", "adaptive_threshold"):
                for n in (40, 1200, 4240, 6_573_120):
                    assert (tdp._sharded_group_bits(name, n, world, t)
                            == jdp._sharded_group_bits(name, n, world, j))
                    assert (tdp._hier_group_bits(name, n, world, t)
                            == jdp._hier_group_bits(name, n, world, j))


# ---------------------------------------------------------------------------
# The bucket route
# ---------------------------------------------------------------------------


def _xla_build(vals, idx, valid, W, cap, shard_n):
    """The JAX ``[W*cap+1]`` scatter build of ``sharded_combine`` (its
    ``use_bucket_route``-off path), and the destinations."""
    dest = jnp.minimum(idx // shard_n, W - 1).astype(jnp.int32)
    if valid is not None:
        dest = jnp.where(valid, dest, W)
    counts = jnp.zeros((W + 1,), jnp.int32).at[dest].add(1)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(idx.shape[0], dtype=jnp.int32) - starts[dest]
    accepted = rank < cap
    if valid is not None:
        accepted = accepted & valid
    slot = jnp.where(accepted, dest * cap + rank, W * cap)
    local = (idx - dest * shard_n).astype(jnp.int32)
    bvals = jnp.zeros((W * cap + 1,), vals.dtype).at[slot].add(vals)[:-1]
    bidx = jnp.full((W * cap + 1,), shard_n, jnp.int32).at[slot].set(local)[:-1]
    return bvals.reshape(W, cap), bidx.reshape(W, cap), dest


def _route_case(seed, n, keep, W, cap, nvalid=None, span=1.0, poison=False):
    """A payload of ``keep`` slots, ascending indices drawn from the first
    ``span`` of ``[0, n)``, the first ``nvalid`` valid."""
    rng = np.random.default_rng(seed)
    nvalid = keep if nvalid is None else nvalid
    pick = np.sort(rng.choice(int(n * span), nvalid, replace=False))
    idx = np.concatenate([pick, np.zeros(keep - nvalid)]).astype(np.int32)
    vals = np.concatenate([rng.standard_normal(nvalid), np.zeros(keep - nvalid)])
    vals = vals.astype(np.float32)
    if poison:
        vals[::7] = -0.0
        vals[1::11] = np.float32(np.nan)
        vals[2::13] = np.inf
        vals[3::17] = -np.inf
        # a NaN with a payload of its own
        vals[4::19] = np.array([0x7FC01234], np.uint32).view(np.float32)[0]
    valid = None if nvalid == keep else np.arange(keep) < nvalid
    return vals, idx, valid, W, cap, -(-n // W)


ROUTE_CASES = {
    # tests/test_kernels.py's cases: balanced buckets
    "w8": (0, 70000, 700, 8, int(1.25 * 700 / 8)),
    "w4": (1, 30000, 333, 4, int(1.25 * 333 / 4)),
    # a zero-padded tail that routes to the dump bucket
    "valid-prefix": (2, 40000, 77, 8, 13, 60),
    # buckets that overflow the capacity (every pick in the first half of
    # the shards) and empty ones
    "overflow-empty": (3, 800, 300, 8, 20, None, 0.5),
    "w2-one-slot": (4, 5000, 50, 2, 1),
}


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
@pytest.mark.parametrize("poison", [False, True], ids=["finite", "signed-zero-nan-inf"])
def test_bucket_route_plain_bitwise(case, poison):
    vals, idx, valid, W, cap, shard_n = _route_case(*ROUTE_CASES[case], poison=poison)
    xv, xi, dest = _xla_build(jnp.asarray(vals), jnp.asarray(idx),
                              None if valid is None else jnp.asarray(valid), W, cap, shard_n)
    fv, fi = jk.fused_bucket_route(jnp.asarray(vals), jnp.asarray(idx), dest, W, cap,
                                   shard_n, interpret=True)
    tv, ti = tk.fused_bucket_route_plain(torch.from_numpy(vals), torch.from_numpy(idx),
                                         torch.from_numpy(np.array(dest)), W, cap, shard_n)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32 and tv.shape == (W, cap)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(fv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(fi))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))
    if poison:
        # the scatter build adds into zeros: -0.0 -> +0.0, NaN payloads may go
        same = (_bits(tv.numpy()) == _bits(xv)) | (np.isnan(tv.numpy()) & np.isnan(xv))
        assert np.all(tv.numpy()[~same] == 0.0)
        assert np.any((tv.numpy() == 0.0) & np.signbit(tv.numpy()))
    else:
        np.testing.assert_array_equal(_bits(tv.numpy()), _bits(xv))
    # monotone rows: a filled ascending prefix, then the constant guard index
    for w in range(W):
        row = ti.numpy()[w]
        filled = row[row < shard_n]
        assert np.all(np.diff(filled) > 0) and np.all(row[len(filled):] == shard_n)
    # the CPU wrapper is the plain version and launches nothing
    tk.reset_launches()
    tv2, ti2 = tk.fused_bucket_route(torch.from_numpy(vals), torch.from_numpy(idx),
                                     torch.from_numpy(np.array(dest)), W, cap, shard_n)
    assert torch.equal(tv2.view(torch.int32), tv.view(torch.int32)) and torch.equal(ti2, ti)
    assert tk.LAUNCHES["bucket_route"] == 0


def _jax_plan(W, cap, shard_n, keep):
    return jws.ShardPlan(n_units=W * shard_n, keep=keep, world=W, unit_size=1,
                         shard_n=shard_n, cap_dest=cap, cap_ret=1, dense_return=True)


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
@pytest.mark.parametrize("poison", [False, True], ids=["finite", "signed-zero-nan-inf"])
def test_route_buckets_plain_bitwise(case, poison):
    """The one-launch route's plain version: the JAX ``_per_dest_slots``'
    ``accepted`` and the Pallas window copy, bitwise; no launch on the CPU."""
    vals, idx, valid, W, cap, shard_n = _route_case(*ROUTE_CASES[case], poison=poison)
    jvalid = None if valid is None else jnp.asarray(valid)
    _, j_acc, j_dest = jws._per_dest_slots(jnp.asarray(idx), jvalid,
                                           _jax_plan(W, cap, shard_n, idx.shape[0]))
    fv, fi = jk.fused_bucket_route(jnp.asarray(vals), jnp.asarray(idx), j_dest, W, cap,
                                   shard_n, interpret=True)
    tvalid = None if valid is None else torch.from_numpy(valid)
    tk.reset_launches()
    got = tk.route_buckets(torch.from_numpy(vals), torch.from_numpy(idx), tvalid, W, cap,
                           shard_n)
    assert tk.LAUNCHES["bucket_route"] == 0
    plain = tk.route_buckets_plain(torch.from_numpy(vals), torch.from_numpy(idx), tvalid, W,
                                   cap, shard_n)
    for g, p in zip(got, plain):
        assert torch.equal(g.view(torch.uint8), p.view(torch.uint8))
    tv, ti, acc = got
    assert acc.dtype == torch.bool and acc.shape == (idx.shape[0],)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(fv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(fi))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    # accepted is each window's first min(count, cap) slots: the buckets' fill
    assert int(acc.sum()) == int((ti < shard_n).sum())


# the search's edges beyond ROUTE_CASES: one slot, every slot bound for the
# last destination, an all-invalid payload, windows of exactly 32 and 33 and
# of a round's 1024 probes and one more
SEARCH_EDGES = {
    "window-1024-1025": (np.concatenate([np.arange(1024), 5000 + np.arange(1025)]).astype(
        np.int32), None, 2, 5000),
    "one-slot": (np.array([5], np.int32), None, 4, 10),
    "all-last": (np.arange(90, 150, dtype=np.int32), None, 4, 25),
    "all-invalid": (np.zeros(40, np.int32), np.zeros(40, bool), 2, 100),
    "window-32-33": (np.concatenate([np.arange(32), 100 + np.arange(33)]).astype(np.int32),
                     None, 2, 100),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES) + sorted(SEARCH_EDGES))
def test_route_starts_search_equals_count(case):
    """The plain twin of the kernel's 32-ary lower-bound search equals the
    count-based ``route_starts`` (dump tails and empty buckets included)."""
    if case in ROUTE_CASES:
        _, idx, valid, W, _, shard_n = _route_case(*ROUTE_CASES[case])
    else:
        idx, valid, W, shard_n = SEARCH_EDGES[case]
    t_idx = torch.from_numpy(idx)
    t_valid = None if valid is None else torch.from_numpy(valid)
    dest = tk.route_slots(t_idx, t_valid, W, 1, shard_n)[2]
    want = tk.route_starts(dest, W)
    assert torch.equal(tk.route_starts_search(t_idx, t_valid, W, shard_n), want)
    assert torch.equal(tk.route_starts_search(t_idx, None, W, shard_n, dest=dest), want)


def test_route_starts_and_gate():
    dest = torch.tensor([0, 0, 1, 3, 3, 3, 4, 4], dtype=torch.int32)
    assert tk.route_starts(dest, 4).tolist() == [0, 2, 3, 3, 6]
    assert tk.route_starts(dest, 4).dtype == torch.int32
    for mode, cpu_big, cuda_small, cuda_big in (("auto", False, False, True),
                                                ("force", True, True, True),
                                                ("off", False, False, False)):
        tk.set_pallas_mode(mode)
        assert tk.use_bucket_route(1 << 16, 2, 64, "cpu") is cpu_big
        assert tk.use_bucket_route(1000, 4, 64, "cuda") is cuda_small
        assert tk.use_bucket_route(1 << 16, 8, 64, "cuda") is cuda_big
        # no routing at world 1
        assert tk.use_bucket_route(1 << 16, 1, 64, "cuda") is False
    tk.set_pallas_mode("auto")
    # the JAX VMEM bound (cap_p <= 2^15) is dropped: full-width entire-model
    # Top-K at W = 2 takes the kernel here, where the JAX gate refuses it
    assert tk.use_bucket_route(65732, 2, 41083, "cuda")
    jk.set_pallas_mode("force")
    assert not jk.use_bucket_route(65732, 2, 41083)


# ---------------------------------------------------------------------------
# The engines at W = 2 and W = 4 against the JAX engine
# ---------------------------------------------------------------------------


def _cfg(method, gran, transport, *, pods=1, factors=None, ef=True, pallas="auto",
         simulate=False, ef_identity=False, draws=None, **kw):
    if gran == "bucketed":
        kw["bucket_mb"] = 0.01  # 10485 bytes: groups [a], [b, c]
    if factors is not None:
        kw.update(dict.fromkeys(FACTOR_KEYS, factors))
    if method == "blocktopk":
        kw["block_size"] = 16
    if method == "thresholdv":
        kw["threshold"] = 1.5
    kw.update(transport=transport, dp_pods=pods, mode="simulate" if simulate else "wire")
    c = dict(method=method, granularity=gran, error_feedback=ef, pallas=pallas,
             ef_identity=ef_identity, kw=kw)
    if draws:
        c["draws"] = draws
    return c


def _configs(world):
    cs = []
    for transport, pods in (("sharded", 1), ("hierarchical", 2)):
        cs += [_cfg("topk", "entiremodel", transport, pods=pods, factors=LOSSLESS),
               _cfg("topk", "entiremodel", transport, pods=pods),
               _cfg("topk", "entiremodel", transport, pods=pods, pallas="force"),
               _cfg("topk", "entiremodel", transport, pods=pods, ef=False),
               _cfg("topk", "layerwise", transport, pods=pods),
               _cfg("thresholdv", "entiremodel", transport, pods=pods),
               _cfg("blocktopk", "entiremodel", transport, pods=pods),
               _cfg("blocktopk", "layerwise", transport, pods=pods, factors=LOSSLESS)]
    cs += [_cfg("topk", "bucketed", "sharded"),
           # the simulate engine's counterfactual billing
           _cfg("topk", "entiremodel", "sharded", simulate=True),
           _cfg("topk", "layerwise", "hierarchical", pods=2, simulate=True)]
    if world == 2:
        cs += [_cfg("thresholdv", "layerwise", t, pods=p, pallas="force", wire_cap_ratio=0.2)
               for t, p in (("sharded", 1), ("hierarchical", 2), ("hierarchical", 1))]
        cs += [_cfg("topk", "entiremodel", "hierarchical", pods=1),
               _cfg("topk", "bucketed", "hierarchical", pods=2, factors=LOSSLESS),
               _cfg("blocktopk", "layerwise", "sharded", simulate=True),
               _cfg("thresholdv", "entiremodel", "hierarchical", pods=2, simulate=True,
                    pallas="force")]
    else:
        # four one-chip pods: the exchange across pods alone
        cs += [_cfg("topk", "entiremodel", "hierarchical", pods=4),
               _cfg("topk", "entiremodel", "hierarchical", pods=4, pallas="force"),
               _cfg("thresholdv", "entiremodel", "hierarchical", pods=4),
               # forced clipping on both levels: the EF identity
               _cfg("topk", "entiremodel", "hierarchical", pods=2, ef_identity=True,
                    hier_route_factor_ici=0.5, hier_route_factor_dcn=0.25),
               _cfg("topk", "entiremodel", "sharded", ef_identity=True,
                    shard_route_factor=0.3, shard_return_factor=0.3),
               # the quantizers' allgather combine of four decoded rows, on
               # the kernel path with a zero dither on both sides (the Pallas
               # interpreter's PRNG is a zero stub)
               _cfg("terngrad", "entiremodel", "allgather", ef=False, pallas="force",
                    draws="zero"),
               _cfg("qsgd", "entiremodel", "allgather", ef=False, pallas="force",
                    draws="zero", qstates=255)]
    return cs


def _config_id(c):
    kw = c["kw"]
    parts = ["sim" if kw["mode"] == "simulate" else "wire", c["method"], c["granularity"],
             kw["transport"] + (f"-p{kw['dp_pods']}" if kw["transport"] == "hierarchical"
                                else ""),
             c["pallas"], f"ef={c['error_feedback']}"]
    if kw.get("shard_route_factor") == LOSSLESS:
        parts.append("lossless")
    if kw.get("wire_cap_ratio"):
        parts.append(f"cap={kw['wire_cap_ratio']}")
    if c["ef_identity"]:
        parts.append("forced-clip")
    return "-".join(parts)


CONFIGS = {w: _configs(w) for w in (2, 4)}
CASES = [pytest.param(w, ci, id=f"w{w}-{_config_id(c)}")
         for w in (2, 4) for ci, c in enumerate(CONFIGS[w])]

_WORKER = r"""
import json, sys, numpy as np, torch
from tpu_compressed_dp_torch.ops import kernels
from tpu_compressed_dp_torch.parallel import dp, mesh
out, port, rank, world, ratio, step_seed = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                            int(sys.argv[4]), float(sys.argv[5]), int(sys.argv[6]))
mesh.init_process_group("cpu", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
inp = np.load(f"{out}/inputs.npz")
res = {}
uniform_plain = kernels.uniform_plain
for ci, spec in enumerate(inp["configs"].tolist()):
    c = json.loads(spec)
    kernels.set_pallas_mode(c["pallas"])
    kernels.uniform_plain = ((lambda seed, n, device="cpu": torch.zeros(n))
                             if c.get("draws") == "zero" else uniform_plain)
    cfg = dp.CompressionConfig(method=c["method"], granularity=c["granularity"], ratio=ratio,
                               error_feedback=c["error_feedback"], **c["kw"])
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


def _inputs(world):
    rng = np.random.default_rng(world)
    g = {k: rng.standard_normal((world,) + s).astype(np.float32) for k, s in SHAPES.items()}
    e = {k: (0.1 * rng.standard_normal((world,) + s)).astype(np.float32)
         for k, s in SHAPES.items()}
    return g, e


def _spawn(world, tmp_path_factory):
    from tpu_compressed_dp_torch.parallel.mesh import free_port

    out = str(tmp_path_factory.mktemp(f"torch_sharded_w{world}"))
    g, e = _inputs(world)
    np.savez(f"{out}/inputs.npz", configs=np.asarray([json.dumps(c) for c in CONFIGS[world]]),
             **{f"g_{k}": v for k, v in g.items()}, **{f"e_{k}": v for k, v in e.items()})
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, out, port, str(r), str(world),
                               str(RATIO), str(STEP_SEED)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(f"{out}/rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def port_w2(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def port_w4(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


def _jax_sync(c, world):
    cfg = jdp.CompressionConfig(method=c["method"], granularity=c["granularity"],
                                ratio=RATIO, error_feedback=c["error_feedback"], **c["kw"])
    g, e = _inputs(world)
    sync = jdp.make_grad_sync(cfg, "data")

    def f(gl, el):
        local = jax.tree.map(lambda x: x[0], gl)
        ef = jax.tree.map(lambda x: x[0], el) if cfg.error_feedback else ()
        out, new_ef, _, stats = sync(local, ef, (), jax.random.key(0))
        lead = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731
        return lead(out), lead(new_ef), lead(stats)

    jk.set_pallas_mode(c["pallas"])
    fn = jax.jit(shard_map(f, mesh=make_data_mesh(world), in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data"), P("data")), check_vma=False))
    out, new_ef, stats = fn(g, e)
    return (jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, new_ef),
            {k: np.asarray(v) for k, v in stats.items()})


@pytest.mark.parametrize("world,ci", CASES)
def test_sync_bitwise_vs_jax(request, world, ci):
    port = request.getfixturevalue(f"port_w{world}")
    c = CONFIGS[world][ci]
    out_j, ef_j, stats_j = _jax_sync(c, world)
    kw = c["kw"]
    wire = kw["mode"] == "wire"
    if c["method"] == "qsgd":
        # QSGD's norm is summed in another order by the two packages (see
        # tests/test_torch_sync.py): the rows differ in the scale's last bit
        # and by one level (the larger rank's ||g|| / s, over the world by the
        # mean) where that moves an element across a floor boundary.  The
        # four rows are summed in one order by both (rank after rank), as the
        # bitwise TernGrad row shows.
        g, _ = _inputs(world)
        level = max(np.linalg.norm(np.concatenate([g[k][w].ravel() for k in SHAPES]))
                    for w in range(world)) / kw["qstates"] / world
    for r in range(world):
        got = port[r]
        for k in SHAPES:
            if c["method"] == "qsgd":
                diff = np.abs(got[f"{ci}/out/{k}"].astype(np.float64) - out_j[k][r])
                assert diff.max() <= level * 1.001 + 1e-6 * np.abs(out_j[k][r]).max()
                assert (diff > 0.01 * level).sum() <= 5
            elif not wire and world > 2:
                # the simulate engine's dense all-reduce of four rows: gloo
                # and XLA sum them in other orders (an ulp apart)
                np.testing.assert_allclose(got[f"{ci}/out/{k}"], out_j[k][r], rtol=0,
                                           atol=1e-6, err_msg=f"rank {r} synced {k}")
            else:
                np.testing.assert_array_equal(_bits(got[f"{ci}/out/{k}"]),
                                              _bits(out_j[k][r]),
                                              err_msg=f"rank {r} synced {k}")
            if c["error_feedback"]:
                np.testing.assert_array_equal(_bits(got[f"{ci}/ef/{k}"]), _bits(ef_j[k][r]),
                                              err_msg=f"rank {r} EF {k}")
        assert {key.split("/", 2)[2] for key in got if key.startswith(f"{ci}/stat/")} == \
            set(stats_j)
        for k, v in stats_j.items():
            assert float(got[f"{ci}/stat/{k}"]) == float(v[r]), (r, k)
    if wire and kw.get("shard_route_factor") == LOSSLESS:
        assert float(stats_j["shard_overflow"][0]) == 0.0
    elif (wire and c["method"] != "blocktopk" and c["granularity"] == "entiremodel"
          and (kw["transport"] == "sharded" or kw["dp_pods"] > 1)):
        # the default factors clip on these independent gradients (one pod
        # has no DCN exchange to clip)
        assert max(float(port[r][f"{ci}/stat/shard_overflow"]) for r in range(world)) > 0
    # the measured bits are the analytic ones, group by group
    n = sum(int(np.prod(s)) for s in SHAPES.values())
    if (c["granularity"] == "entiremodel" and c["method"] != "blocktopk"
            and kw["transport"] != "allgather"):
        cfg = tdp.CompressionConfig(method=c["method"], ratio=RATIO, **kw)
        stats = {k.split("/", 2)[2]: float(v) for k, v in port[0].items()
                 if k.startswith(f"{ci}/stat/")}
        if kw["transport"] == "sharded":
            route, ret = tdp._sharded_group_bits(c["method"], n, world, cfg)
            assert (stats["sent_bits_alltoall"], stats["sent_bits_allgather"]) == (route, ret)
        else:
            ici, rt, ret = tdp._hier_group_bits(c["method"], n, world, cfg)
            assert (stats["sent_bits_ici"], stats["sent_bits_dcn_route"],
                    stats["sent_bits_dcn"]) == (ici, rt, rt + ret)


def test_ef_identity_under_forced_clipping(port_w4):
    """W = 4, tight capacities: what the workers kept out of the EF residual
    is exactly what the synced gradient holds (world mean of ``acc -
    new_ef``), with the clips counted in ``shard_overflow``."""
    g, e = _inputs(4)
    acc = np.stack([np.concatenate([g[k][r].ravel() + e[k][r].ravel() for k in SHAPES])
                    for r in range(4)])
    cases = [ci for ci, c in enumerate(CONFIGS[4]) if c["ef_identity"]]
    assert len(cases) == 2
    for ci in cases:
        new_ef = np.stack([np.concatenate([port_w4[r][f"{ci}/ef/{k}"].ravel() for k in SHAPES])
                           for r in range(4)])
        synced = np.concatenate([port_w4[0][f"{ci}/out/{k}"].ravel() for k in SHAPES])
        assert all(float(port_w4[r][f"{ci}/stat/shard_overflow"]) > 0 for r in range(4))
        np.testing.assert_allclose(np.mean(acc - new_ef, axis=0), synced, atol=1e-6)
        for r in range(1, 4):
            for k in SHAPES:
                np.testing.assert_array_equal(port_w4[r][f"{ci}/out/{k}"],
                                              port_w4[0][f"{ci}/out/{k}"])
