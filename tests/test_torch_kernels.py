"""The PyTorch port's Top-K kernels against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port's wrappers run their kernels' plain versions; the JAX side runs
its Pallas kernels in interpret mode, as ``tests/test_kernels.py`` does.
Thresholds, fused-sparsify outputs and counts must agree bitwise: the port's
glue repeats the reference's fp32 arithmetic op for op.  The CUDA kernels
themselves run only on the card (``-m cuda``; ``python3 chip_smoke.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_compressed_dp.ops import compressors as jc
from tpu_compressed_dp.ops import kernels as jk
from tpu_compressed_dp_torch.ops import compressors as tc
from tpu_compressed_dp_torch.ops import kernels as tk


@pytest.fixture(autouse=True)
def _modes():
    j_mode, t_mode = jk.pallas_mode(), tk.pallas_mode()
    jk.set_pallas_mode("off")
    tk.set_pallas_mode("force")
    yield
    jk.set_pallas_mode(j_mode)
    tk.set_pallas_mode(t_mode)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).reshape(-1).view(np.uint32)


def _mag(n: int, seed: int) -> np.ndarray:
    return np.abs(np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _case(name: str):
    if name == "full_range":
        return _mag(5000, 1), 500
    if name == "mid_size":
        return _mag(70000, 2), 7000
    if name == "ties":
        return np.ones(4096, np.float32), 100
    if name == "nan":
        m = _mag(3000, 3)
        m[::7] = np.nan
        return m, 300
    if name == "inf":
        m = _mag(3000, 4)
        m[::11] = np.inf
        return m, 300
    if name == "sampled":
        return _mag(1 << 20, 5), (1 << 20) // 10
    raise AssertionError(name)


class TestThreshold:
    @pytest.mark.parametrize("name", ["full_range", "mid_size", "ties", "nan", "inf",
                                      "sampled"])
    def test_histogram_bitwise_vs_pallas(self, name):
        mag, keep = _case(name)
        if name == "sampled":
            # n = 2^20 with keep = n/10 takes the sampled-quantile first round
            # (kernels.py:330-342): the sample is exactly n/16 elements
            assert tk._sample_plan(mag.size, keep) == (2048, 512, 65536)
        else:
            assert tk._sample_plan(mag.size, keep) is None
        want = jk._topk_threshold_pallas(jnp.asarray(mag), keep, interpret=True)
        got = tk.topk_threshold(torch.from_numpy(mag), keep)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        finite = np.isfinite(mag)
        if finite.all():
            assert int((mag >= got.item()).sum()) >= keep

    def test_scatter_fallback_bitwise_vs_jnp(self):
        mag = _mag(5000, 6)
        want = jk._topk_threshold_jnp(jnp.asarray(mag), 500)
        got = tk._topk_threshold_scatter(torch.from_numpy(mag), 500)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))

    @pytest.mark.parametrize("with_nan", [False, True])
    def test_exact_path_bitwise(self, with_nan):
        tk.set_pallas_mode("off")
        mag = _mag(4000, 7)
        if with_nan:
            mag[::13] = np.nan
        want = jk.topk_threshold(jnp.asarray(mag), 40)
        got = tk.topk_threshold(torch.from_numpy(mag), 40)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))

    def test_keep_all_is_zero(self):
        assert float(tk.topk_threshold(torch.from_numpy(_mag(128, 8)), 128)) == 0.0


class TestTopK:
    @pytest.mark.parametrize("n,ratio", [(5000, 0.01), (777, 0.1), (70000, 0.01)])
    def test_top_k_bitwise(self, n, ratio):
        tk.set_pallas_mode("off")
        g = np.random.default_rng(n).standard_normal(n).astype(np.float32)
        want = jc.top_k(jnp.asarray(g), ratio=ratio)
        got = tc.top_k(torch.from_numpy(g), ratio=ratio)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))

    @pytest.mark.parametrize("n,ratio", [(1, 0.5), (10, 0.01), (1000, 0.3), (6573120, 0.01)])
    def test_keep_count(self, n, ratio):
        assert tc.topk_keep_count(n, ratio) == jc.topk_keep_count(n, ratio)

    def test_unported_methods_raise(self):
        assert tc.canonical_name("Topk") == "topk"
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tc.get_compressor("powersgd")
        with pytest.raises(ValueError):
            tc.get_compressor("nonsense")


class TestFusedSparsify:
    @pytest.mark.parametrize("want_ef", [True, False])
    def test_bitwise_vs_pallas(self, want_ef):
        acc = np.random.default_rng(9).standard_normal(5000).astype(np.float32)
        acc[::97] = 0.0
        t = jk.topk_threshold(jnp.abs(jnp.asarray(acc)), 500)
        comp_j, ef_j, cnt_j = jk.fused_sparsify(jnp.asarray(acc), t, want_ef=want_ef,
                                                interpret=True)
        comp_t, ef_t, cnt_t = tk.fused_sparsify(torch.from_numpy(acc),
                                                torch.tensor(np.asarray(t)), want_ef=want_ef)
        np.testing.assert_array_equal(_bits(comp_t.numpy()), _bits(comp_j))
        if want_ef:
            np.testing.assert_array_equal(_bits(ef_t.numpy()), _bits(ef_j))
        else:
            assert ef_t is None and ef_j is None
        assert float(cnt_t) == float(cnt_j)

    def test_zero_threshold_counts_nonzeros_only(self):
        acc = np.ones(200, np.float32)
        acc[[7, 100]] = 0.0
        comp_j, ef_j, cnt_j = jk.fused_sparsify(jnp.asarray(acc), jnp.float32(0.0),
                                                interpret=True)
        comp_t, ef_t, cnt_t = tk.fused_sparsify(torch.from_numpy(acc), torch.tensor(0.0))
        assert float(cnt_t) == float(cnt_j) == 198.0
        np.testing.assert_array_equal(_bits(comp_t.numpy()), _bits(comp_j))
        np.testing.assert_array_equal(_bits(ef_t.numpy()), _bits(ef_j))


class TestDispatch:
    def test_modes(self):
        for mode, cpu_small, cpu_big, cuda_small, cuda_big in (
                ("auto", False, False, False, True),
                ("force", True, True, True, True),
                ("off", False, False, False, False)):
            tk.set_pallas_mode(mode)
            assert tk.use_fused_sparsify(1000, "cpu") is cpu_small
            assert tk.use_fused_sparsify(1 << 16, "cpu") is cpu_big
            assert tk.use_fused_sparsify(1000, "cuda") is cuda_small
            assert tk.use_fused_sparsify(1 << 16, "cuda") is cuda_big
        assert tk.MIN_PALLAS_ELEMS == jk.MIN_PALLAS_ELEMS
        with pytest.raises(ValueError):
            tk.set_pallas_mode("sometimes")

    def test_auto_on_cpu_is_exact(self):
        tk.set_pallas_mode("auto")
        mag = _mag(70000, 10)
        got = tk.topk_threshold(torch.from_numpy(mag), 700)
        assert float(got) == float(np.sort(mag)[-700])

    def test_plain_versions_do_not_count_launches(self):
        tk.reset_launches()
        mag = torch.from_numpy(_mag(300000, 11))
        tk.topk_threshold(mag, 3000)
        tk.fused_sparsify(mag, torch.tensor(1.0))
        assert tk.LAUNCHES == {"count_ge": 0, "count_edges": 0, "fused_sparsify": 0,
                               "uniform": 0, "qsgd": 0, "terngrad": 0, "select_pack": 0,
                               "terngrad_pack": 0, "qsgd_pack": 0, "bucket_route": 0,
                               "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """On the card: every kernel equals its plain version bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    dev = torch.device("cuda")
    mag = torch.from_numpy(_mag(300000, 12)).to(dev)
    hi = mag.max() * 1.0000002 + 1e-30
    edges = torch.cat([hi / 16 * torch.arange(16, device=dev, dtype=torch.float32),
                       hi.reshape(1)])
    assert torch.equal(tk.count_ge_edges(mag, edges), tk.count_ge_edges_plain(mag, edges))
    t = tk.topk_threshold(mag, 3000)
    t_plain = tk._topk_threshold_hist(
        mag, 3000, count_fn=lambda x, e, route: tk.count_ge_edges_plain(x, e))
    assert t.item() == t_plain.item()
    for got, want in zip(tk.fused_sparsify(mag, t), tk.fused_sparsify_plain(mag, t)):
        assert torch.equal(got, want)
