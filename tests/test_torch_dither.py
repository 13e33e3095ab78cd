"""The port's Philox uniforms and dither quantizers against the JAX package.

The TPU's hardware PRNG has no counterpart off the TPU, and the Pallas
interpreter stubs it with zeros, so the anchors are:

  * the kernel formula (``(|x| * inv) * s + u``, ``u < |x| * inv``): the
    port's plain version with ``u = 0`` injected, bitwise against the JAX
    wrappers under ``interpret=True`` (whose dither is 0 there);
  * the formula paths below the kernels' cut-off (``|g| / ||g|| * s + u``,
    ``coin < |g| / max|g|``): bitwise against the JAX package's jnp paths
    (``set_pallas_mode("off")``) with the JAX uniforms injected;
  * the port's own Philox stream by contract: Random123's known answers,
    deterministic in the seed, different across seeds, uniform, on the
    2^-24 grid, and an unbiased dither.

QSGD's norm is summed in another order by ``torch.linalg.vector_norm`` than
by ``jnp.linalg.norm``; given the same inverse norm its levels are bitwise,
otherwise at most a few levels differ by one and the scale agrees to 1e-6.
The CUDA kernels run only on the card (``tests/test_torch_cuda.py``; ``chip_smoke.py``).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpu_compressed_dp.ops import compressors as jc
from tpu_compressed_dp.ops import kernels as jk
from tpu_compressed_dp_torch.ops import compressors as tc
from tpu_compressed_dp_torch.ops import kernels as tk

N = 20000
SEED = 0x243F6A8885A308D3


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


def _grad(n=N, seed=0, scale=1e-2):
    return (scale * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


class TestPhilox:
    @pytest.mark.parametrize("ctr,key,want", [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ])
    def test_known_answers(self, ctr, key, want):
        # Random123's kat_vectors for philox4x32 with 10 rounds
        words = tk.philox4x32_plain(*(torch.tensor([c], dtype=torch.int64) for c in ctr),
                                    key[0] | (key[1] << 32))
        assert tuple(int(w) for w in words) == want

    def test_deterministic_and_seed_sensitive(self):
        a = tk.uniform(SEED, 4099, "cpu")
        assert torch.equal(a, tk.uniform(SEED, 4099, "cpu"))
        assert torch.equal(a, tk.uniform_plain(SEED, 4099))
        # element i depends on (seed, i) only: a shorter draw is a prefix
        assert torch.equal(a[:1001], tk.uniform(SEED, 1001, "cpu"))
        b = tk.uniform(SEED + 1, 4099, "cpu")
        assert (a == b).float().mean() < 0.01
        with pytest.raises(ValueError):
            tk.uniform(-1, 4, "cpu")
        with pytest.raises(ValueError):
            tk.uniform(1 << 64, 4, "cpu")

    def test_uniform_on_the_24_bit_grid(self):
        u = tk.uniform(7, 1 << 16, "cpu").numpy()
        grid = u.astype(np.float64) * (1 << 24)
        assert np.array_equal(grid, np.floor(grid))
        assert u.min() >= 0.0 and u.max() < 1.0
        # chi-square over 64 equal bins (63 dof: p = 0.001 at 103.4)
        counts = np.bincount(np.floor(u * 64).astype(int), minlength=64)
        expected = u.size / 64
        assert ((counts - expected) ** 2 / expected).sum() < 103.4
        # Kolmogorov-Smirnov distance (p = 0.001 at 1.95 / sqrt(n))
        s = np.sort(u.astype(np.float64))
        i = np.arange(1, s.size + 1)
        d = max((i / s.size - s).max(), (s - (i - 1) / s.size).max())
        assert d < 1.95 / np.sqrt(s.size)
        assert abs(u.mean() - 0.5) < 0.01


class TestKernelFormula:
    """The kernels' formula against the JAX wrappers in interpret mode (u = 0)."""

    def test_interpreter_dither_is_zero(self):
        # the premise of this class: interpret mode draws u == 0
        g = _grad()
        levels, _ = jk.qsgd_quantize(jnp.asarray(g), jax.random.key(3), interpret=True)
        norm = np.float32(np.linalg.norm(g.astype(np.float64)))
        assert np.abs(np.asarray(levels)).max() <= np.floor(np.abs(g).max() / norm * 255) + 1

    @pytest.mark.parametrize("qstates", [127, 255, 1000])
    def test_qsgd_levels_bitwise_given_inv(self, zero_dither, qstates):
        g = _grad()
        g[::101] = np.nan
        g[1::103] = np.inf
        g[2::107] = -np.inf
        g[3::109] = 0.0
        inv = np.float32(31.0)
        want = jk._run_quant(functools.partial(jk._qsgd_kernel, qstates), jnp.int16,
                             jnp.asarray(g), jnp.float32(inv), jnp.int32(5), True)
        got = tk.qsgd_levels_kernel(_t(g), torch.tensor(inv), SEED, qstates)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # NaN has sign 0, +-Inf saturates
        assert (got.numpy()[np.isnan(g)] == 0).all()
        assert got[1].item() == 32767 and got[2].item() == -32768

    def test_terngrad_levels_bitwise_given_inv(self, zero_dither):
        g = _grad()
        g[::101] = np.nan
        g[1::103] = np.inf
        inv = np.float32(0.5) / np.float32(np.abs(g[np.isfinite(g)]).max())
        want = jk._run_quant(jk._terngrad_kernel, jnp.int8, jnp.asarray(g), jnp.float32(inv),
                             jnp.int32(5), True)
        got = tk.terngrad_levels_kernel(_t(g), torch.tensor(inv), SEED)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_terngrad_quantize_bitwise(self, zero_dither):
        g = _grad(seed=1)
        lv_j, gmax_j = jk.terngrad_quantize(jnp.asarray(g), jax.random.key(0), interpret=True)
        lv_t, gmax_t = tk.terngrad_quantize(_t(g), SEED)
        np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))
        assert gmax_t.item() == float(gmax_j)

    def test_terngrad_quantize_prescaled_bitwise(self, zero_dither):
        scaled, _ = jc.terngrad_prescale(jnp.asarray(_grad(seed=2)), 3000)
        want = jk.terngrad_quantize_prescaled(scaled, jax.random.key(0), interpret=True)
        got = tk.terngrad_quantize_prescaled(_t(scaled), SEED)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_qsgd_quantize_contract(self, zero_dither):
        g = _grad(seed=3)
        lv_j, scale_j = jk.qsgd_quantize(jnp.asarray(g), jax.random.key(0), interpret=True)
        lv_t, scale_t = tk.qsgd_quantize(_t(g), SEED)
        assert abs(scale_t.item() - float(scale_j)) <= 1e-6 * float(scale_j)
        diff = np.abs(lv_t.numpy().astype(np.int32) - np.asarray(lv_j, np.int32))
        assert diff.max() <= 1 and (diff > 0).sum() <= 5

    def test_zero_vector(self):
        z = torch.zeros(1000)
        levels, scale = tk.qsgd_quantize(z, SEED)
        assert levels.abs().max().item() == 0 and scale.item() == 0.0
        levels, gmax = tk.terngrad_quantize(z, SEED)
        assert levels.abs().max().item() == 0 and gmax.item() == 0.0


class TestFormulaPaths:
    """The compressors below the kernels' cut-off vs the JAX jnp paths, with
    the JAX uniforms injected."""

    @pytest.fixture(autouse=True)
    def _off(self):
        jk.set_pallas_mode("off")
        tk.set_pallas_mode("off")

    @staticmethod
    def _inject(monkeypatch, key, n):
        draws = torch.from_numpy(np.asarray(jax.random.uniform(key, (n,))))
        monkeypatch.setattr(tc, "draw_uniform", lambda seed, n_, device: draws[:n_])

    @pytest.mark.parametrize("chunk", [0, 3000, N])
    def test_terngrad_levels_bitwise(self, monkeypatch, chunk):
        g = _grad(seed=4)
        g[::211] = np.nan
        key = jax.random.key(11)
        self._inject(monkeypatch, key, N)
        lv_j, sc_j = jc.terngrad_levels(jnp.asarray(g), key, chunk=chunk)
        lv_t, sc_t = tc.terngrad_levels(_t(g), SEED, chunk=chunk)
        np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))
        np.testing.assert_array_equal(np.atleast_1d(sc_t.numpy()), np.atleast_1d(sc_j))
        # the dense estimator, bitwise (on finite input: NaN payloads differ)
        g = _grad(seed=4)
        dense_j = jc.terngrad(jnp.asarray(g), key, chunk=chunk)
        dense_t = tc.terngrad(_t(g), SEED, chunk=chunk)
        np.testing.assert_array_equal(dense_t.numpy().view(np.uint32),
                                      np.asarray(dense_j).view(np.uint32))

    @pytest.mark.parametrize("qstates", [127, 255, 1000])
    def test_qsgd_levels(self, monkeypatch, qstates):
        g = _grad(seed=5)
        key = jax.random.key(12)
        self._inject(monkeypatch, key, N)
        lv_j, sc_j = jc.qsgd_levels(jnp.asarray(g), key, qstates=qstates)
        lv_t, sc_t = tc.qsgd_levels(_t(g), SEED, qstates=qstates)
        assert abs(sc_t.item() - float(sc_j)) <= 1e-6 * float(sc_j)
        diff = np.abs(lv_t.numpy().astype(np.int32) - np.asarray(lv_j, np.int32))
        assert diff.max() <= 1 and (diff > 0).sum() <= 5
        if sc_t.item() == float(sc_j):
            # the same norm: bitwise
            np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))

    def test_nan_and_inf(self, monkeypatch):
        g = _grad(seed=6)
        g[::97] = np.nan
        g[5] = np.inf
        key = jax.random.key(13)
        self._inject(monkeypatch, key, N)
        lv_t, sc_t = tc.qsgd_levels(_t(g), SEED)
        lv_j, sc_j = jc.qsgd_levels(jnp.asarray(g), key)
        np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))
        assert (lv_t.numpy()[np.isnan(g)] == 0).all()


class TestUnbiased:
    """The port's own dither: E[scale * levels] = g, within 3 sigma."""

    @staticmethod
    def _check(est, g, p, scale):
        err = (est.double() - g.double()).mean().item()
        sigma = (scale.double() ** 2 * p * (1 - p)).sum().sqrt().item() / g.numel()
        assert abs(err) <= 3 * sigma, (err, sigma)

    @pytest.mark.parametrize("mode", ["off", "force"])
    def test_qsgd(self, mode):
        tk.set_pallas_mode(mode)
        g = _t(_grad(1 << 16, seed=7))
        levels, scale = tc.qsgd_levels(g, SEED)
        v = g.double().abs() / torch.linalg.vector_norm(g).double() * 255
        self._check(scale * levels.float(), g, v - v.floor(), scale)

    @pytest.mark.parametrize("mode", ["off", "force"])
    def test_terngrad(self, mode):
        tk.set_pallas_mode(mode)
        g = _t(_grad(1 << 16, seed=8))
        levels, gmax = tc.terngrad_levels(g, SEED)
        self._check(gmax * levels.float(), g, g.double().abs() / gmax.double(), gmax)

    def test_kernel_and_formula_share_the_stream(self):
        # the kernel path's in-kernel dither is draw_uniform's stream: with
        # inv = 1 / max the two TernGrad formulas agree wherever the
        # division and the multiplication round alike
        g = _t(_grad(5000, seed=9))
        tk.set_pallas_mode("force")
        lv_k, _ = tc.terngrad_levels(g, SEED)
        tk.set_pallas_mode("off")
        lv_f, _ = tc.terngrad_levels(g, SEED)
        assert (lv_k != lv_f).sum().item() <= 2


def test_dispatch():
    for mode, cpu_big, cuda_small, cuda_big in (("auto", False, False, True),
                                                ("force", True, True, True),
                                                ("off", False, False, False)):
        tk.set_pallas_mode(mode)
        assert tk.use_quant_kernels(1 << 16, "cpu") is cpu_big
        assert tk.use_quant_kernels(1000, "cuda") is cuda_small
        assert tk.use_quant_kernels(1 << 16, "cuda") is cuda_big


def test_plain_versions_do_not_count_launches():
    tk.reset_launches()
    tk.set_pallas_mode("force")
    g = _t(_grad(70000))
    tc.random_k(g, SEED, ratio=0.01)
    tc.terngrad(g, SEED)
    tc.random_dithering(g, SEED)
    assert set(tk.LAUNCHES.values()) == {0}
