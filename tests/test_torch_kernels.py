"""The PyTorch port's Top-K kernels against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port's wrappers run their kernels' plain versions; the JAX side runs
its Pallas kernels in interpret mode, as ``tests/test_kernels.py`` does.
Thresholds, fused-sparsify outputs and counts must agree bitwise: the port's
glue repeats the reference's fp32 arithmetic op for op.  The CUDA kernels
themselves run only on the card (``tests/test_torch_cuda.py``; ``python3 chip_smoke.py``).
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

    @pytest.mark.parametrize("name", ["candidates", "b_zero", "overflow", "nan_inf", "zeros"])
    def test_sampled_search_branches_bitwise_vs_pallas(self, name, monkeypatch):
        """Each branch of the device-resident search at n = 2^20 (keep n/10,
        the sampled first round): the refinement rounds count the candidates;
        the sampled round picks bin 0 (the first 128 elements of every
        2048-block, the whole sample, raised by 10), so every round counts the
        whole tensor; the candidate buffer overflows; NaN and Inf mixed in;
        95 % exact zeros (as the embedding gradient outside a batch's tokens),
        so the sample's edges are 0 up to e[15] and the zeros, counted apart,
        stay out of the candidates."""
        n = 1 << 20
        mag, keep = _mag(n, 5), n // 10
        if name == "b_zero":
            mag.reshape(-1, 2048)[:, :128] += 10.0
        if name == "overflow":
            monkeypatch.setattr(tk, "_CAND_SLACK", 0.5)
        if name == "nan_inf":
            # few enough that the window still holds the keep-th finite value
            mag[::997] = np.nan
            mag[5::1009] = np.inf
        if name == "zeros":
            mag[np.random.default_rng(6).random(n) < 0.95] = 0.0
        assert tk._sample_plan(n, keep) == (2048, 512, 65536)
        want = jk._topk_threshold_pallas(jnp.asarray(mag), keep, interpret=True)
        state = tk._hist_search(torch.from_numpy(mag), keep)
        got = tk.topk_threshold(torch.from_numpy(mag), keep)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        np.testing.assert_array_equal(_bits(state.view(torch.float32)[tk._ST_LO].numpy()),
                                      _bits(want))
        assert int(state[tk._ST_ROUNDS]) == 5
        cand_ok = int(state[tk._ST_CAND_OK])
        cand_rounds = int(state[tk._ST_CAND_ROUNDS])
        if name in ("candidates", "nan_inf", "zeros"):
            assert cand_ok == 1 and cand_rounds == 4
            if name == "zeros":
                assert int(state[tk._ST_CAND_EQ]) == int((mag == 0).sum())
                assert int(state[tk._ST_CAND_LEN]) == int((mag > 0).sum())
        elif name == "b_zero":
            assert cand_ok == 0 and cand_rounds == 0
            # the sampled round's bin: its counts at e[1] fall short of keep
            sample_top = mag.reshape(-1, 2048)[:, :128]
            assert (mag >= 10.0).sum() == sample_top.size < keep
        else:
            assert cand_ok == 0 and cand_rounds == 0
            assert int(state[tk._ST_CAND_LEN]) > tk._sample_values(
                torch.from_numpy(mag), keep, tk._sample_plan(n, keep))[2]
        finite = np.isfinite(mag)
        kept = int((mag[finite] >= got.item()).sum()) + int(np.isinf(mag).sum())
        assert kept >= keep

    @pytest.mark.parametrize("variant", ["count_ge", "count_edges"])
    @pytest.mark.parametrize("data", ["random", "ties"])
    def test_fused_round_equals_glue(self, variant, data):
        """The plain fused round (the kernel's split of the counts and its
        epilogue on the state) equals count_ge_edges_plain + the glue's
        narrowing bitwise, over random brackets; a refinement round over the
        candidates equals one over the whole tensor."""
        rng = np.random.default_rng(21)
        if data == "random":
            x = _mag(20000, 22)
        else:
            x = np.repeat(rng.standard_normal(40).astype(np.float32) ** 2, 500)
        xt = torch.from_numpy(x)
        for trial in range(12):
            keep_f = float(rng.integers(1, x.size))
            if variant == "count_ge":
                lo, hi = np.sort(rng.choice(x, 2)).astype(np.float32)
                hi = np.float32(hi * np.float32(1.5) + np.float32(trial % 2))
                above = np.float32(rng.integers(0, x.size // 4))
                state = tk.new_search_state("cpu")
                sf = state.view(torch.float32)
                sf[tk._ST_LO], sf[tk._ST_HI], sf[tk._ST_ABOVE] = float(lo), float(hi), float(above)
                lo_t, hi_t, ab_t = (torch.tensor(v, dtype=torch.float32) for v in (lo, hi, above))
                width = (hi_t - lo_t) / 16
                edges = torch.cat([lo_t + width * torch.arange(16, dtype=torch.float32),
                                   hi_t.reshape(1)])
                counts = tk.count_ge_edges_plain(xt, edges)
                want = tk._narrow(lo_t, hi_t, ab_t, counts.to(torch.float32), keep_f)
                tk.count_round_plain(xt, state, keep_f)
                # the same round over the bracket's elements as candidates:
                # those above lo, and a count of those equal to it
                win = xt[(xt > edges[0]) & (xt < edges[16])]
                st2 = tk.new_search_state("cpu")
                st2.view(torch.float32)[:3] = torch.tensor([lo, hi, above])
                st2[tk._ST_CAND_OK], st2[tk._ST_CAND_LEN] = 1, win.numel()
                st2[tk._ST_CAND_EQ] = int((xt == edges[0]).sum())
                st2.view(torch.float32)[tk._ST_WIN_LO] = edges[0]
                st2.view(torch.float32)[tk._ST_WIN_HI] = edges[16]
                tk.count_round_plain(xt, st2, keep_f, cand=win.clone())
                assert int(st2[tk._ST_CAND_ROUNDS]) == 1
                for lo_w, hi_w in ((0, 3), (tk._ST_LAST_COUNTS, tk._ST_LAST_COUNTS + 16)):
                    np.testing.assert_array_equal(st2[lo_w:hi_w].numpy(),
                                                  state[lo_w:hi_w].numpy())
            else:
                edges = torch.from_numpy(np.concatenate(
                    [[0.0], np.sort(rng.choice(x, 15)), [x.max() * 1.0000002 + 1e-30]]
                ).astype(np.float32))
                counts = tk.count_ge_edges_plain(xt, edges)
                cf = counts.to(torch.float32)
                b = ((cf >= keep_f).sum() - 1).clamp(0, 15)
                ext = torch.cat([cf, cf.new_zeros(1)])
                want = (tk._pick(edges, b), tk._pick(edges, b + 1),
                        tk._pick(ext, (b + 1).clamp(0, 16)))
                state = tk.new_search_state("cpu")
                cand = torch.empty(x.size, dtype=torch.float32)
                tk.count_round_plain(xt, state, keep_f, edges=edges, cand=cand)
                length = int(state[tk._ST_CAND_LEN])
                win = x[(x > edges[1].item()) & (x < edges[16].item())]
                assert length == win.size
                assert int(state[tk._ST_CAND_EQ]) == int((x == edges[1].item()).sum())
                np.testing.assert_array_equal(np.sort(cand[:length].numpy()), np.sort(win))
                assert int(state[tk._ST_CAND_OK]) == int(int(b) >= 1)
            got = state.view(torch.float32)[:3]
            np.testing.assert_array_equal(_bits(got.numpy()),
                                          _bits(torch.stack(list(want)).numpy()))
            np.testing.assert_array_equal(
                state[tk._ST_LAST_COUNTS:tk._ST_LAST_COUNTS + 16].numpy(), counts.numpy())
            assert not state[tk._ST_COUNTS:tk._ST_TICKET + 1].any()

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
        # every method of the registry is ported (PowerSGD last); an unknown
        # one raises
        assert tc.canonical_name("Topk") == "topk"
        assert {tc.get_compressor(m).name for m in tc.REGISTRY} == set(tc.REGISTRY)
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
        assert tk.LAUNCHES == {"count_ge": 0, "count_edges": 0, "search_init": 0,
                               "fused_sparsify": 0,
                               "uniform": 0, "qsgd": 0, "terngrad": 0, "select_pack": 0,
                               "terngrad_pack": 0, "qsgd_pack": 0, "bucket_route": 0,
                               "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                               "threshold_pack": 0, "seg_pack": 0, "ternary_bytes": 0,
                               "qsgd_bytes": 0}


def test_chip_smoke_names_template_kernels():
    """``chip_smoke.py``'s ptxas report keeps each template instance of a
    kernel apart: the select+pack tilings, the flash kernels' element type
    and head size, and the count kernel's bool."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_names", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ns = "_ZN47_GLOBAL__N__f1b82417_14_select_pack_cu_81a3c5b9"
    small = ns + "18select_pack_kernelINS_6TilingILi512ELi8ELi0ELi3EEEEEvPKfxiiS4_iPfPiS6_PyiPj"
    large = ns + "18select_pack_kernelINS_6TilingILi256ELi16ELi8ELi3EEEEEvPKfxiiS4_iPfPiS6_PyiPj"
    assert smoke._demangle(small) == "select_pack_kernel<Tiling<512, 8, 0, 3>>"
    assert smoke._demangle(large) == "select_pack_kernel<Tiling<256, 16, 8, 3>>"
    report = smoke.ptxas_report(
        f"ptxas info    : Compiling entry function '{small}' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 528 bytes smem\n"
        f"ptxas info    : Compiling entry function '{large}' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 80 registers, used 1 barriers, 784 bytes smem\n")
    assert report == {"select_pack_kernel<Tiling<512, 8, 0, 3>>": {"registers": 40,
                                                                    "spill_stores": 0},
                      "select_pack_kernel<Tiling<256, 16, 8, 3>>": {"registers": 80,
                                                                     "spill_stores": 0}}
    assert smoke._demangle("_ZN12_GLOBAL__N_121count_ge_edges_kernelILb1EEEvPKf") == (
        "count_ge_edges_kernel<true>")
