"""The port's compressors against the JAX package's, on numpy inputs.

Random-K's mask is held bitwise given the same draws (the JAX uniforms are
injected into both packages' draw functions, forced ties included); the
deterministic operators are bitwise outright.  Block-Top-K scores are sums
of squares taken in another order (rtol 1e-6), so its selection is held
equal on inputs where no block score lies within that margin of the
threshold.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpu_compressed_dp.ops import compressors as jc
from tpu_compressed_dp.ops import kernels as jk
from tpu_compressed_dp_torch.ops import compressors as tc
from tpu_compressed_dp_torch.ops import kernels as tk


@pytest.fixture(autouse=True)
def _modes():
    j_mode, t_mode = jk.pallas_mode(), tk.pallas_mode()
    yield
    jk.set_pallas_mode(j_mode)
    tk.set_pallas_mode(t_mode)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).reshape(-1).view(np.uint32)


def _grad(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


class TestRandomK:
    @pytest.mark.parametrize("case", ["plain", "ties", "keep_zero", "keep_all", "big"])
    @pytest.mark.parametrize("mode", ["off", "force"])
    def test_mask_bitwise_given_draws(self, monkeypatch, case, mode):
        n, keep = {"plain": (5000, 50), "ties": (5000, 700), "keep_zero": (300, 0),
                   "keep_all": (300, 300), "big": (1 << 17, 1311)}[case]
        w = np.asarray(jax.random.uniform(jax.random.key(3), (n,)))
        if case == "ties":
            w = np.floor(w * 16) / 16  # 16 distinct values: the boundary is tied
        monkeypatch.setattr(jk, "uniform", lambda key, n_: jnp.asarray(w))
        monkeypatch.setattr(tc, "draw_uniform", lambda seed, n_, device: _t(w))
        jk.set_pallas_mode(mode)
        tk.set_pallas_mode(mode)
        want = np.asarray(jc.randomk_mask(jax.random.key(0), n, keep))
        got = tc.randomk_mask(1, n, keep, "cpu").numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() == min(max(keep, 0), n)

    def test_random_k_bitwise(self, monkeypatch):
        g = _grad(7000, 1)
        key = jax.random.key(5)
        w = np.asarray(jax.random.uniform(key, (7000,)))
        monkeypatch.setattr(tc, "draw_uniform", lambda seed, n_, device: _t(w))
        jk.set_pallas_mode("off")
        want = jc.random_k(jnp.asarray(g), key, ratio=0.03)
        got = tc.random_k(_t(g), 9, ratio=0.03)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))

    def test_own_draws(self):
        # the port's stream: deterministic in the seed, exactly keep, and a
        # different subset for another seed
        a = tc.randomk_mask(11, 10000, 100, "cpu")
        assert torch.equal(a, tc.randomk_mask(11, 10000, 100, "cpu"))
        assert a.sum().item() == 100
        assert (a & tc.randomk_mask(12, 10000, 100, "cpu")).sum().item() < 20

    @pytest.mark.parametrize("n,ratio", [(1, 0.5), (10, 0.01), (1000, 0.3), (6573120, 0.01),
                                         (100, 1.0), (7, 0.0)])
    def test_keep_counts(self, n, ratio):
        assert tc.randomk_keep_count(n, ratio) == jc.randomk_keep_count(n, ratio)
        for bs in (8, 256):
            assert tc.blocktopk_keep_blocks(n, ratio, bs) == jc.blocktopk_keep_blocks(n, ratio, bs)
            assert tc.blocktopk_num_blocks(n, bs) == jc.blocktopk_num_blocks(n, bs)


class TestDeterministicOperators:
    @pytest.mark.parametrize("threshold", [1e-3, 0.5, 1.7])
    def test_threshold_v(self, threshold):
        g = _grad(5000, 2)
        g[::50] = np.float32(threshold)
        want = jc.threshold_v(jnp.asarray(g), threshold=threshold)
        got = tc.threshold_v(_t(g), threshold=threshold)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))

    def test_adaptive_threshold(self):
        g = _grad(5000, 3)
        g[17] = -2.0 * np.abs(g).max()
        g[18] = -g[17] / 2  # exactly on the boundary
        want = jc.adaptive_threshold(jnp.asarray(g))
        got = tc.adaptive_threshold(_t(g))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))

    @pytest.mark.parametrize("chunk", [1000, 1024, 4999, 5000])
    def test_terngrad_prescale(self, chunk):
        g = _grad(5000, 4)
        g[1500:2500] = 0.0  # an all-zero chunk
        s_j, m_j = jc.terngrad_prescale(jnp.asarray(g), chunk)
        s_t, m_t = tc.terngrad_prescale(_t(g), chunk)
        np.testing.assert_array_equal(_bits(s_t.numpy()), _bits(s_j))
        np.testing.assert_array_equal(_bits(m_t.numpy()), _bits(m_j))

    @pytest.mark.parametrize("n,chunk", [(5000, 0), (5000, 8000), (5000, 1000), (5001, 1000)])
    def test_terngrad_num_chunks(self, n, chunk):
        assert tc.terngrad_num_chunks(n, chunk) == jc.terngrad_num_chunks(n, chunk)


class TestBlockTopK:
    @pytest.mark.parametrize("n,block_size,ratio", [(10000, 256, 0.05), (10001, 8, 0.02),
                                                    (3000, 64, 0.1), (500, 256, 0.9)])
    @pytest.mark.parametrize("mode", ["off", "force"])
    def test_contract(self, n, block_size, ratio, mode):
        g = _grad(n, 5)
        s_j = np.asarray(jc.blocktopk_scores(jnp.asarray(g), block_size))
        s_t = tc.blocktopk_scores(_t(g), block_size).numpy()
        np.testing.assert_allclose(s_t, s_j, rtol=1e-6)
        keep = jc.blocktopk_keep_blocks(n, ratio, block_size)
        # the inputs' premise: no score within 1e-6 of the threshold
        if keep < s_j.size:
            t = np.sort(s_j.astype(np.float64))[-keep]
            near = np.abs(s_j - t) <= 1e-6 * t
            assert near.sum() == 1
        jk.set_pallas_mode(mode)
        tk.set_pallas_mode(mode)
        want = jc.block_top_k(jnp.asarray(g), ratio=ratio, block_size=block_size)
        got = tc.block_top_k(_t(g), ratio=ratio, block_size=block_size)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


class TestRegistry:
    @pytest.mark.parametrize("name", [m for m in jc.REGISTRY if m != "powersgd"])
    def test_payload_bits(self, name):
        assert tc.REGISTRY == jc.REGISTRY
        for qstates in (127, 255, 1000):
            for shared in (False, True):
                for bs in (8, 256):
                    kw = dict(qstates=qstates, shared_mask=shared, block_size=bs)
                    assert tc.payload_bits_per_elem(name, **kw) == \
                        jc.payload_bits_per_elem(name, **kw), kw
        with pytest.raises(ValueError):
            tc.payload_bits_per_elem("nonsense")

    def test_aliases(self):
        assert tc._ALIASES == jc._ALIASES
        for alias, canon in jc._ALIASES.items():
            assert tc.canonical_name(alias) == jc.canonical_name(alias) == canon
            assert tc.canonical_name(alias.upper()) == canon
        assert tc.canonical_name(None) == "none"
        with pytest.raises(ValueError):
            tc.canonical_name("nonsense")

    def test_bound_compressors(self):
        for name in jc.REGISTRY:
            if name == "powersgd":
                continue
            b_t, b_j = tc.get_compressor(name), jc.get_compressor(name)
            assert (b_t.name, b_t.needs_rng, b_t.is_sparsifier) == \
                (b_j.name, b_j.needs_rng, b_j.is_sparsifier)

    def test_powersgd_raises(self):
        # PowerSGD is ported (tests/test_torch_lowrank.py): every spelling
        # binds its stateless form, and its wire width, which depends on the
        # group's size, raises without one, as in the JAX registry
        for spelling in ("powersgd", "power_sgd", "lowrank"):
            b_t, b_j = tc.get_compressor(spelling, rank=2), jc.get_compressor(spelling, rank=2)
            assert (b_t.name, b_t.needs_rng, b_t.is_sparsifier, b_t.is_stateful) == \
                (b_j.name, b_j.needs_rng, b_j.is_sparsifier, b_j.is_stateful)
        for pkg in (tc, jc):
            with pytest.raises(ValueError, match="pass n"):
                pkg.payload_bits_per_elem("powersgd")
        for n in (100, 600, 2359296):
            assert tc.payload_bits_per_elem("powersgd", n=n, rank=4) == \
                jc.payload_bits_per_elem("powersgd", n=n, rank=4)


def test_seed_helpers():
    assert tc.fold_in(0, 1) == tc.fold_in(0, 1)
    seeds = {tc.leaf_seed(s, i, r) for s in (0, 1) for i in range(50) for r in (None, 0, 1)}
    assert len(seeds) == 2 * 50 * 3
    assert all(0 <= s < (1 << 64) for s in seeds)
    assert tc.leaf_seed(7, 3) == tc.fold_in(7, 3)
    assert tc.leaf_seed(7, 3, 1) == tc.fold_in(tc.fold_in(7, 3), 1)
    assert tc.fold_in(-1, 0) == tc.fold_in((1 << 64) - 1, 0)
