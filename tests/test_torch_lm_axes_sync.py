"""The port's partitioned sync, fused head + xent and clip over a tensor group
against the JAX package, at ``tp = 2``.

The meshes ``(1, 1, 2)``, ``(2, 1, 2)`` and ``(1, 2, 2)``: the JAX side under
``shard_map`` on ``make_lm_mesh(dp, sp, tp)`` of the virtual CPU mesh, the
port as one spawned gloo world per mesh (``test_torch_lm_axes.py``'s worker
and inputs).  Each rank takes its worker's gradient and EF residual and its
tensor shard of them.

  * The partitioned sync (Top-K + EF, layerwise and entiremodel; simulate,
    wire allgather, wire sharded): synced gradients, EF and every stat
    bitwise (the mean of one or two rows is order-free; the sharded
    signature group's stats are summed over the tensor group, as the JAX
    engine psums them).
  * ``fused_head_xent`` over the tensor group (each rank's vocab shard of
    the head): loss to rtol 1e-6, ``dh`` (summed over the group) and each
    shard's ``dw`` to rtol 1e-5; the full-model clip, its sharded squared
    norms summed over the group, to rtol 1e-6.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tpu_compressed_dp.compat import shard_map
from tpu_compressed_dp.models import transformer as jtf
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.train import lm_step as jlm

from test_torch_lm_axes import (AXES, CFG_J, SYNC_CONFIGS, _bits, _head_inputs, _ids,
                                _params, _ranks, _shard, _specs, _sync_grads, _sync_kw,
                                run_port)

TP2 = [m for m in AXES if m[2] > 1]


@pytest.fixture(scope="module")
def sync_results(tmp_path_factory):
    return run_port(str(tmp_path_factory.mktemp("torch_lm_axes_sync")),
                    {m: ["sync", "head"] for m in TP2})


@pytest.mark.parametrize("m", TP2, **_ids)
def test_fused_head_and_clip_over_the_tensor_group(sync_results, m):
    h, w, t_ids = _head_inputs()
    mesh = jlm.make_lm_mesh(*m)
    fn = shard_map(lambda a, b, c: jtf.fused_head_xent(a, b, c, "tensor", 64), mesh=mesh,
                   in_specs=(P(), P(None, "tensor"), P()), out_specs=P())
    loss_j, (dh_j, dw_j) = jax.jit(jax.value_and_grad(
        lambda a, b: fn(a, b, jnp.asarray(t_ids)), argnums=(0, 1)))(jnp.asarray(h),
                                                                     jnp.asarray(w))
    g, _ = _sync_grads(2)
    sharded = jlm._lm_is_sharded(CFG_J)
    clip_j = jdp.make_sharded_clip(sharded, "tensor")
    specs = _specs()
    treedef = jax.tree.structure(_params())
    for r, wk, _, t in _ranks(m):
        got = sync_results[m][r]
        np.testing.assert_allclose(float(got["head/loss"]), float(loss_j), rtol=1e-6)
        np.testing.assert_allclose(got["head/dh"], np.asarray(dh_j), rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(got["head/dw"], _shard(np.asarray(dw_j), ("", "tensor"), t,
                                                          m[2]), rtol=1e-5, atol=1e-8)
    gspecs = [P(("data", "seq"), *s) for s in specs]
    clipped = jax.jit(shard_map(
        lambda tree: jax.tree.map(lambda a: a[None], clip_j(
            jax.tree.map(lambda a: a[0], tree), 0.5)),
        mesh=mesh, in_specs=(jax.tree.unflatten(treedef, gspecs),),
        out_specs=jax.tree.unflatten(treedef, gspecs), check_vma=False))(
        jax.tree.unflatten(treedef, [a[:m[0] * m[1]] for a in g]))
    for r, wk, _, t in _ranks(m):
        for i, (a, spec) in enumerate(zip(jax.tree.leaves(clipped), specs)):
            np.testing.assert_allclose(sync_results[m][r][f"clip/{i}"],
                                       _shard(np.asarray(a)[wk], spec, t, m[2]), rtol=1e-6)


# ---------------------------------------------------------------------------
# The partitioned sync at tp = 2
# ---------------------------------------------------------------------------


def _jax_sync(c, m):
    cfg = jdp.CompressionConfig(**_sync_kw(c))
    workers = m[0] * m[1]
    g, e = _sync_grads(2)
    g, e = [a[:workers] for a in g], [a[:workers] for a in e]
    treedef = jax.tree.structure(_params())
    sync = jdp.make_grouped_grad_sync(cfg, ("data", "seq"), jlm._lm_is_sharded(CFG_J), "tensor")

    def f(gl, el):
        local = jax.tree.map(lambda x: x[0], gl)
        ef = jax.tree.map(lambda x: x[0], el)
        out, new_ef, _, stats = sync(local, ef, (), jax.random.key(0))
        lead = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731
        return lead(out), lead(new_ef), lead(stats)

    lspec = jax.tree.unflatten(treedef, [P(("data", "seq"), *s) for s in _specs()])
    fn = jax.jit(shard_map(f, mesh=jlm.make_lm_mesh(*m), in_specs=(lspec, lspec),
                           out_specs=(lspec, lspec, P(("data", "seq"))), check_vma=False))
    out, new_ef, stats = fn(jax.tree.unflatten(treedef, g), jax.tree.unflatten(treedef, e))
    return ([np.asarray(x) for x in jax.tree.leaves(out)],
            [np.asarray(x) for x in jax.tree.leaves(new_ef)],
            {k: np.asarray(v) for k, v in stats.items()})


@pytest.mark.parametrize("m", TP2, **_ids)
@pytest.mark.parametrize("ci", range(len(SYNC_CONFIGS)),
                         ids=["-".join(c.values()) for c in SYNC_CONFIGS])
def test_partitioned_sync_bitwise_vs_jax(sync_results, m, ci):
    out_j, ef_j, stats_j = _jax_sync(SYNC_CONFIGS[ci], m)
    specs = _specs()
    for r, w, _, t in _ranks(m):
        got = sync_results[m][r]
        for i, spec in enumerate(specs):
            np.testing.assert_array_equal(_bits(got[f"sync{ci}/out/{i}"]),
                                          _bits(_shard(out_j[i][w], spec, t, m[2])),
                                          err_msg=f"rank {r} synced leaf {i}")
            np.testing.assert_array_equal(_bits(got[f"sync{ci}/ef/{i}"]),
                                          _bits(_shard(ef_j[i][w], spec, t, m[2])),
                                          err_msg=f"rank {r} EF leaf {i}")
        assert {k.split("/", 2)[2] for k in got if k.startswith(f"sync{ci}/stat/")} == \
            set(stats_j)
        for k, v in stats_j.items():
            assert float(got[f"sync{ci}/stat/{k}"]) == float(v[w]), (r, k)
