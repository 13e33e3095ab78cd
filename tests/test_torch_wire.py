"""The port's wire-mode packers, select+pack and quantize+pack against the
JAX package.

  * the byte layouts (``pack_ternary``, ``pack_bits``, ``qsgd_wire_pack`` and
    their unpackers) are bitwise equal to :mod:`tpu_compressed_dp.ops.wire`'s;
  * ``fused_select_pack_plain`` is bitwise equal to
    ``fused_select_pack(interpret=True)`` and to the mask ->
    ``packed_indices_from_mask`` -> gather chain wherever the mask fills the
    buffer, and pads an underfull mask with 0 / 0 as the Pallas kernel does;
  * ``terngrad_pack_plain`` / ``qsgd_pack_plain`` with a zero dither are
    bitwise equal to the Pallas quantize+pack kernels in interpret mode
    (whose PRNG is a zero stub); QSGD given the same inverse norm, since
    ``torch.linalg.vector_norm`` sums in another order than
    ``jnp.linalg.norm``;
  * on the port's own Philox draws, unpacking the packed bytes gives the
    level kernels' levels;
  * the wire sync at world 1 (no process group) equals the JAX wire engine
    on a 1-device mesh.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``; ``chip_smoke.py``).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from tpu_compressed_dp.compat import shard_map
from tpu_compressed_dp.ops import compressors as jc
from tpu_compressed_dp.ops import kernels as jk
from tpu_compressed_dp.ops import wire as jw
from tpu_compressed_dp.parallel import dp as jdp
from tpu_compressed_dp.parallel.mesh import make_data_mesh
from tpu_compressed_dp_torch.ops import compressors as tc
from tpu_compressed_dp_torch.ops import kernels as tk
from tpu_compressed_dp_torch.ops import wire as tw
from tpu_compressed_dp_torch.parallel import dp as tdp

SEED = 0x243F6A8885A308D3
PACK_SIZES = (7, 12345, 65533, 70000)


@pytest.fixture(autouse=True)
def _modes():
    j_mode, t_mode = jk.pallas_mode(), tk.pallas_mode()
    yield
    jk.set_pallas_mode(j_mode)
    tk.set_pallas_mode(t_mode)


@pytest.fixture
def zero_dither(monkeypatch):
    """The port's plain kernels draw u = 0, as the Pallas interpreter does."""
    monkeypatch.setattr(tk, "uniform_plain",
                        lambda seed, n, device="cpu": torch.zeros(n, dtype=torch.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint8), want.view(np.uint8))


# ---------------------------------------------------------------------------
# Byte layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", PACK_SIZES)
def test_ternary_bytes(n):
    levels = np.random.default_rng(n).integers(-1, 2, n).astype(np.int8)
    packed = tw.pack_ternary(_t(levels))
    _eq(packed, jw.pack_ternary(jnp.asarray(levels)))
    # the unpacker takes a leading gather axis
    rows = torch.stack([packed, tw.pack_ternary(_t(-levels))])
    _eq(tw.unpack_ternary(rows, n), jw.unpack_ternary(jnp.asarray(rows.numpy()), n))
    assert torch.equal(tw.unpack_ternary(rows, n)[0], _t(levels))


@pytest.mark.parametrize("n", PACK_SIZES)
def test_bitmap_bytes(n):
    bits = np.random.default_rng(n + 1).random(n) < 0.3
    packed = tw.pack_bits(_t(bits))
    _eq(packed, jw.pack_bits(jnp.asarray(bits)))
    rows = torch.stack([packed, packed.flip(0)])
    _eq(tw.unpack_bits(rows, n), jw.unpack_bits(jnp.asarray(rows.numpy()), n))


@pytest.mark.parametrize("n", PACK_SIZES)
@pytest.mark.parametrize("qstates", [127, 255, 1000])
def test_qsgd_wire_layout(n, qstates):
    levels = np.random.default_rng(n + qstates).integers(-qstates, qstates + 1, n)
    levels = levels.astype(np.int16)
    got = tw.qsgd_wire_pack(_t(levels), qstates)
    want = jw.qsgd_wire_pack(jnp.asarray(levels), qstates)
    assert len(got) == len(want) == (2 if 127 < qstates <= 255 else 1)
    for g, w in zip(got, want):
        _eq(g, w)
    rows = tuple(torch.stack([p, p]) for p in got)
    dec = tw.qsgd_wire_unpack(rows, n, qstates)
    _eq(dec, jw.qsgd_wire_unpack(tuple(jnp.asarray(r.numpy()) for r in rows), n, qstates))
    np.testing.assert_array_equal(dec[1].numpy(), levels.astype(np.float32))


# ---------------------------------------------------------------------------
# Select + pack
# ---------------------------------------------------------------------------


def _jax_chain(flat, mag, t, keep):
    mask = mag >= t
    idx = jw.packed_indices_from_mask(mask, keep)
    return jw._sorted_gather(flat, idx), idx, jnp.sum(mask, dtype=jnp.int32)


@pytest.mark.parametrize("n,keep", [(70000, 700), (65536, 1), (4096, 4096), (12345, 300)])
def test_select_pack_plain_bitwise(n, keep):
    flat = np.asarray(jax.random.normal(jax.random.key(n + keep), (n,)))
    mag = jnp.abs(jnp.asarray(flat))
    t = jk.topk_threshold(mag, keep)
    fv, fi, fc = jk.fused_select_pack(jnp.asarray(flat), t, keep, interpret=True)
    xv, xi, xc = _jax_chain(jnp.asarray(flat), mag, t, keep)
    tv, ti, tc_ = tk.fused_select_pack_plain(_t(flat), _t(t), keep)
    for got, f, x in ((tv, fv, xv), (ti, fi, xi)):
        _eq(got, f)
        _eq(got, x)
    assert int(tc_) == int(fc) == int(xc) and tc_.dtype == torch.int32
    # the wrapper on a CPU tensor is the plain version, and the port's own
    # unfused chain agrees with it
    tk.set_pallas_mode("off")
    for a, b in zip(tk.fused_select_pack(_t(flat), _t(t), keep),
                    tw._select_pack(_t(flat), _t(mag), _t(t), keep)):
        assert torch.equal(a, b)


def test_select_pack_underfull_pads_zero():
    # the threshold above all but two |x|: value 0 / index 0 padding, unlike
    # the unfused chain's flat[0]
    flat = np.arange(1.0, 5001.0, dtype=np.float32)
    fv, fi, fc = jk.fused_select_pack(jnp.asarray(flat), jnp.float32(4998.5), 10,
                                      interpret=True)
    tv, ti, tcount = tk.fused_select_pack_plain(_t(flat), torch.tensor(4998.5), 10)
    _eq(tv, fv)
    _eq(ti, fi)
    assert int(tcount) == int(fc) == 2
    np.testing.assert_array_equal(tv.numpy(), [4999.0, 5000.0] + [0.0] * 8)
    np.testing.assert_array_equal(ti.numpy(), [4998, 4999] + [0] * 8)


def test_select_pack_blocktopk_scores():
    flat = np.asarray(jax.random.normal(jax.random.key(4), (40960,)))
    scores = np.asarray(jc.blocktopk_scores(jnp.asarray(flat), 256))
    t = jk.topk_threshold(jnp.asarray(scores), 16)
    fv, fi, fc = jk.fused_select_pack(jnp.asarray(scores), t, 16, interpret=True)
    tv, ti, tcount = tk.fused_select_pack_plain(_t(scores), _t(t), 16)
    _eq(tv, fv)
    _eq(ti, fi)
    assert int(tcount) == int(fc) >= 16
    assert bool(tw.packed_indices_monotone(ti))


@pytest.mark.parametrize("mode", ["auto", "force"])
def test_packed_indices_from_mask(mode):
    # the oracle: np.flatnonzero(mask)[:keep] padded with 0, for keep below,
    # at and above the set count
    tk.set_pallas_mode(mode)
    mask = np.random.default_rng(3).random(70001) < 0.02
    count = int(mask.sum())
    for keep in (1, count // 2, count, count + 37):
        want = np.zeros(keep, np.int32)
        nz = np.flatnonzero(mask)[:keep]
        want[:nz.size] = nz
        got = tw.packed_indices_from_mask(_t(mask), keep)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jw.packed_indices_from_mask(jnp.asarray(mask), keep)))
        assert bool(tw.packed_indices_monotone(got)) == (keep <= count)


def test_select_pack_topk_matches_jax():
    flat = np.asarray(jax.random.normal(jax.random.key(9), (30000,)))
    for got, want in zip(tw.select_pack_topk(_t(flat), 300),
                         jw.select_pack_topk(jnp.asarray(flat), 300)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Quantize + pack
# ---------------------------------------------------------------------------


def _grad(n=20000, seed=0, scale=1e-2):
    return (scale * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def test_terngrad_pack_bitwise(zero_dither):
    g = _grad(seed=1)
    packed_j, scale_j = jk.terngrad_pack(jnp.asarray(g), jax.random.key(3), interpret=True)
    packed_t, scale_t = tk.terngrad_pack(_t(g), SEED)
    _eq(packed_t, packed_j)
    assert scale_t.item() == float(scale_j)


def test_terngrad_pack_prescaled_bitwise(zero_dither):
    scaled, _ = jc.terngrad_prescale(jnp.asarray(_grad(20001, seed=2)), 3000)
    want = jk.terngrad_pack_prescaled(scaled, jax.random.key(0), interpret=True)
    _eq(tk.terngrad_pack_prescaled(_t(scaled), SEED), want)


def test_terngrad_pack_given_inv_bitwise(zero_dither):
    g = _grad(20003, seed=3)
    g[::101] = np.nan
    g[1::103] = np.inf
    g[2::107] = -np.inf
    inv = np.float32(0.5) / np.float32(np.abs(g[np.isfinite(g)]).max())
    (want,) = jk._run_quant_pack(jk._terngrad_pack_kernel, jnp.asarray(g), jnp.float32(inv),
                                 jnp.int32(5), (4,), True)
    got = tk.terngrad_pack_plain(_t(g), torch.tensor(inv), SEED)
    _eq(got, np.asarray(want).reshape(-1)[:got.shape[0]])


@pytest.mark.parametrize("n", [20000, 20005])
def test_qsgd_pack_given_inv_bitwise(zero_dither, n):
    # QSGD's scale: inv = 1 / ||g||, so every level fits a byte (|level| <= 256)
    g = _grad(n, seed=4)
    g[::97] = np.nan
    g[3::89] = 0.0
    g[4::83] = -0.0
    inv = np.float32(1.0) / np.float32(np.linalg.norm(np.nan_to_num(g).astype(np.float64)))
    mags_j, signs_j = jk._run_quant_pack(functools.partial(jk._qsgd_pack_kernel, 255),
                                         jnp.asarray(g), jnp.float32(inv), jnp.int32(5),
                                         (1, 8), True)
    mags_t, signs_t = tk.qsgd_pack_plain(_t(g), torch.tensor(inv), SEED, 255)
    _eq(mags_t, np.asarray(mags_j).reshape(-1)[:n])
    _eq(signs_t, np.asarray(signs_j).reshape(-1)[:signs_t.shape[0]])


def test_qsgd_pack_contract(zero_dither):
    g = _grad(seed=5)
    mags_j, signs_j, scale_j = jk.qsgd_pack(jnp.asarray(g), jax.random.key(0), interpret=True)
    mags_t, signs_t, scale_t = tk.qsgd_pack(_t(g), SEED)
    assert abs(scale_t.item() - float(scale_j)) <= 1e-6 * float(scale_j)
    diff = np.abs(mags_t.numpy().astype(np.int32) - np.asarray(mags_j, np.int32))
    assert diff.max() <= 1 and (diff > 0).sum() <= 5
    _eq(signs_t, signs_j)
    with pytest.raises(ValueError):
        tk.qsgd_pack(_t(g), SEED, qstates=256)


@pytest.mark.parametrize("n", [1, 4099, 65537])
def test_unpacked_bytes_are_the_levels(n):
    # the port's own Philox dither: pack == levels, packed
    x = _t(_grad(n, seed=6))
    x[::13] = float("nan")
    x[1::17] = 0.0
    inv = tk._safe_inv(torch.linalg.vector_norm(torch.nan_to_num(x)))
    for i in (inv, torch.tensor(40.0)):
        levels = tk.terngrad_levels_kernel(x, i, SEED)
        packed = tk.terngrad_pack_kernel(x, i, SEED)
        assert packed.shape == (-(-n // 4),) and packed.dtype == torch.uint8
        assert torch.equal(tw.unpack_ternary(packed, n), levels)
        assert torch.equal(packed, tw.pack_ternary(levels))
    lv = tk.qsgd_levels_kernel(x, inv, SEED, 255)
    mags, signs = tk.qsgd_pack_kernel(x, inv, SEED, 255)
    assert torch.equal(tw.qsgd_wire_unpack((mags, signs), n, 255), lv.to(torch.float32))
    for got, want in zip((mags, signs), tw.qsgd_wire_pack(lv, 255)):
        assert torch.equal(got, want)


def test_dispatch_gates():
    for mode, cpu_big, cuda_small, cuda_big in (("auto", False, False, True),
                                                ("force", True, True, True),
                                                ("off", False, False, False)):
        tk.set_pallas_mode(mode)
        assert tk.use_select_pack(1 << 16, 100, "cpu") is cpu_big
        assert tk.use_select_pack(1000, 10, "cuda") is cuda_small
        assert tk.use_select_pack(1 << 16, 100, "cuda") is cuda_big
        assert tk.use_select_pack(1 << 16, 0, "cuda") is False
        assert tk.use_quant_pack(1 << 16, "cpu") is cpu_big
        assert tk.use_quant_pack(1 << 16, "cuda") is cuda_big
    tk.set_pallas_mode("force")
    assert not tk.use_select_pack((1 << 31) + 2, 100, "cuda")


def test_plain_versions_do_not_count_launches():
    tk.reset_launches()
    tk.set_pallas_mode("force")
    grads = {"a": _t(_grad(70000)), "b": _t(_grad(300, seed=1))}
    for method in ("topk", "randomk", "thresholdv", "terngrad", "qsgd"):
        cfg = tdp.CompressionConfig(method=method, mode="wire", ratio=0.01,
                                    granularity="entiremodel")
        tdp.make_grad_sync(cfg)(grads, (), SEED)
    assert set(tk.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# The engine at world 1
# ---------------------------------------------------------------------------

W1_SHAPES = {"a": (3000,), "b": (40,), "c": (12, 100)}


@pytest.mark.parametrize("method,mode,kw", [
    ("topk", "force", {}),
    ("randomk", "auto", {"check_sync": True}),
    ("blocktopk", "auto", {"block_size": 64}),
    ("thresholdv", "force", {"threshold": 1.5}),
    ("adaptive_threshold", "auto", {}),
    ("terngrad", "force", {"terngrad_chunk": 1000}),
    ("qsgd", "force", {"qstates": 255}),
])
def test_world_one_matches_jax(monkeypatch, zero_dither, method, mode, kw):
    ef_on = method not in ("terngrad", "qsgd")
    cfg_kw = dict(method=method, mode="wire", granularity="entiremodel", ratio=0.05,
                  error_feedback=ef_on, **kw)
    rng = np.random.default_rng(8)
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in W1_SHAPES.items()}
    e = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in W1_SHAPES.items()}
    key = jax.random.key(0)
    n = sum(int(np.prod(s)) for s in W1_SHAPES.values())
    draws = torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, 0), (n,))))
    monkeypatch.setattr(tc, "draw_uniform", lambda seed, n_, device: draws[:n_])

    sync_j = jdp.make_grad_sync(jdp.CompressionConfig(**cfg_kw), "data")

    def f(gl, el):
        out, new_ef, _, stats = sync_j(gl, el if ef_on else (), (), key)
        return out, new_ef, stats

    jk.set_pallas_mode(mode)
    tk.set_pallas_mode(mode)
    fn = jax.jit(shard_map(f, mesh=make_data_mesh(1), in_specs=(P(), P()),
                           out_specs=(P(), P(), P()), check_vma=False))
    out_j, ef_j, stats_j = fn(g, e)
    out_t, ef_t, stats_t = tdp.make_grad_sync(tdp.CompressionConfig(**cfg_kw))(
        {k: _t(v) for k, v in g.items()}, {k: _t(v) for k, v in e.items()} if ef_on else (),
        SEED)
    for k in W1_SHAPES:
        if method == "qsgd":
            # the norms round apart: one level (||acc|| / s) on a few elements
            step = np.linalg.norm(np.concatenate([v.ravel() for v in g.values()])) / 255
            diff = np.abs(out_t[k].numpy().astype(np.float64) - np.asarray(out_j[k]))
            assert diff.max() <= step * 1.001 and (diff > 0.01 * step).sum() <= 5
            continue
        _eq(out_t[k], out_j[k])
        if ef_on:
            _eq(ef_t[k], ef_j[k])
    assert set(stats_t) == set(stats_j)
    for k, v in stats_j.items():
        assert stats_t[k].item() == float(v), k


def test_wire_config_refusals_and_dense():
    # the JAX engine's build-time refusals, and dense falling through to the
    # simulate all-reduce (its wire form)
    for kw in (dict(method="randomk", shared_mask=False),
               dict(method="terngrad", error_feedback=True),
               dict(method="qsgd", error_feedback=True)):
        for pkg in (jdp, tdp):
            with pytest.raises(ValueError):
                pkg.make_grad_sync(pkg.CompressionConfig(mode="wire", **kw))
    grads = {"a": _t(_grad(300)), "b": _t(_grad(40, seed=1))}
    # at world 1 the hierarchical transport degrades to the allgather
    # combine: the same result, bit for bit, and the same bill
    ef = {k: torch.zeros_like(v) for k, v in grads.items()}
    base = dict(method="topk", mode="wire", ratio=0.05, error_feedback=True,
                granularity="entiremodel")
    out_a, ef_a, stats_a = tdp.make_grad_sync(tdp.CompressionConfig(**base))(grads, ef, SEED)
    out_h, ef_h, stats_h = tdp.make_grad_sync(tdp.CompressionConfig(
        transport="hierarchical", dp_pods=1, **base))(grads, ef, SEED)
    for k in grads:
        _eq(out_h[k], out_a[k].numpy())
        _eq(ef_h[k], ef_a[k].numpy())
    assert {k: v.item() for k, v in stats_h.items()} == {k: v.item() for k, v in stats_a.items()}
    out_w, _, stats_w = tdp.make_grad_sync(tdp.CompressionConfig(mode="wire"))(grads, (), SEED)
    out_s, _, stats_s = tdp.make_grad_sync(tdp.CompressionConfig())(grads, (), SEED)
    assert all(torch.equal(out_w[k], out_s[k]) for k in grads)
    assert {k: v.item() for k, v in stats_w.items()} == {k: v.item() for k, v in stats_s.items()}
