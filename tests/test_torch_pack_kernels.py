"""The port's threshold pack, segmented pack and byte packers against the JAX
package's Pallas kernels.

Inputs are made with numpy from a seed.  The JAX side runs its kernels in
interpret mode; the threshold pack's only with ``_PACK_ROWS`` cut to 16
rows, as ``tests/test_kernels.py`` does, and the port's plain version takes
the same block rows as its ``rows`` argument.  On finite data every output
is bitwise equal: payload values and indices, EF residual, counts, the
segmented payload and the packed bytes.  (On NaN / Inf data and ``-0.0``
survivors the Pallas threshold pack's one-hot sums change payload values,
which the port copies; the card holds the port's kernels to their plain
versions there, ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.)  The
slot counts and the segmented path's dispatch gate equal the JAX ones.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_compressed_dp.ops import kernels as jk
from tpu_compressed_dp_torch.ops import kernels as tk


@pytest.fixture(autouse=True)
def _modes():
    j_mode, t_mode = jk.pallas_mode(), tk.pallas_mode()
    yield
    jk.set_pallas_mode(j_mode)
    tk.set_pallas_mode(t_mode)


def _eq(got, want):
    """Same dtype, shape and bytes (``None`` on both sides counts as equal)."""
    if want is None:
        assert got is None
        return
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape,
                                                                  want.dtype, want.shape)
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                  want.reshape(-1).view(np.uint8))


# (n, keep, seed): tests/test_kernels.py's TestPackKernel sizes; the 8192 /
# 128 case at t = 0.01 keeps ~99 %, far past the payload (whole-block
# truncation into the residual)
PACK_CASES = [(5000, 50, 0), (17000, 700, 0), (40000, 350, 0), (8192, 128, 3)]


@pytest.mark.parametrize("n,keep,seed", PACK_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("want_ef", [True, False], ids=["ef", "no-ef"])
def test_pack_by_threshold_plain_bitwise(monkeypatch, n, keep, seed, want_ef):
    monkeypatch.setattr(jk, "_PACK_ROWS", 16)  # interpreter-tractable
    acc = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    t = (np.float32(0.01) if (n, keep) == (8192, 128)
         else np.partition(np.abs(acc), n - keep)[n - keep])
    want = jk.pack_by_threshold(jnp.asarray(acc), jnp.asarray(t), keep, want_ef=want_ef,
                                interpret=True)
    got = tk.pack_by_threshold(torch.from_numpy(acc), torch.tensor(t), keep,
                               want_ef=want_ef, rows=16)
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[0].shape == (jk.pack_payload_slots(n, keep),)
    if (n, keep) == (8192, 128):
        # the overflow regime: payload + residual is the input, nothing lost
        assert int(got[3]) < int((np.abs(acc) >= t).sum())
        if want_ef:
            dense = np.zeros(n, np.float32)
            dense[got[1].numpy()] += got[0].numpy()
            np.testing.assert_array_equal(dense + got[2].numpy(), acc)


# (n, t, keep, seed): tests/test_kernels.py's TestSegPack cases
SEG_CASES = [(13000, 2.0, 150, 0), (9000, 0.5, 200, 3), (4096 * 2 + 777, 1.5, 64, 5),
             (6000, 2.0, 40, 7)]


@pytest.mark.parametrize("n,t,keep,seed", SEG_CASES, ids=lambda v: str(v))
def test_seg_pack_plain_bitwise(n, t, keep, seed):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    want_ef = (n, keep) != (6000, 40)   # TestSegPack's want_ef=False case
    want = jk.seg_pack_by_threshold(jnp.asarray(x), jnp.float32(t), keep, want_ef=want_ef,
                                    interpret=True)
    got = tk.seg_pack_by_threshold(torch.from_numpy(x), torch.tensor(t, dtype=torch.float32),
                                   keep, want_ef=want_ef)
    for g, w in zip(got, want):
        _eq(g, w)
    # the padded segment count of the reference's layout
    assert got[0].shape == (-(-n // 65536) * 16, 128)
    pv, pi = tk.seg_pack_payload(got[0], got[1], got[3], keep)
    wv, wi = jk.seg_pack_payload(want[0], want[1], want[3], keep)
    _eq(pv, wv)
    _eq(pi, wi)


@pytest.mark.parametrize("n", [70000, 12345, 65533, 7])
def test_pack_ternary_bytes_plain_bitwise(n):
    levels = np.random.default_rng(n).integers(-1, 2, n).astype(np.int8)
    _eq(tk.pack_ternary_bytes(torch.from_numpy(levels)),
        jk.pack_ternary_pallas(jnp.asarray(levels), interpret=True))


@pytest.mark.parametrize("n", [70000, 12347])
def test_qsgd_pack_bytes_plain_bitwise(n):
    levels = np.random.default_rng(n).integers(-255, 256, n).astype(np.int16)
    got = tk.qsgd_pack_bytes(torch.from_numpy(levels))
    want = jk.qsgd_pack_pallas(jnp.asarray(levels), interpret=True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _eq(g, w)


def test_slots_and_seg_pack_gate(monkeypatch):
    for n, keep in ((1, 1), (5000, 50), (65536, 700), (6_573_120, 65_732),
                    (961_544_192, 9_615_442)):
        assert tk.pack_payload_slots(n, keep) == jk.pack_payload_slots(n, keep)
        assert tk.seg_pack_slots(n) == jk.seg_pack_slots(n)
    monkeypatch.setattr(jk, "_PACK_ROWS", 16)
    assert tk.pack_payload_slots(17000, 700, rows=16) == jk.pack_payload_slots(17000, 700)
    sizes = [(1 << 20, (1 << 20) // 100), (1 << 20, (1 << 20) // 10), (1 << 20, 8192),
             (1 << 20, 8193), (1000, 5), ((1 << 31) + 10, 1000)]
    for dispatch in (False, True):
        monkeypatch.setattr(jk, "_SEG_PACK_DISPATCH", dispatch)
        monkeypatch.setattr(tk, "_SEG_PACK_DISPATCH", dispatch)
        for mode in ("auto", "off", "force"):
            jk.set_pallas_mode(mode)
            tk.set_pallas_mode(mode)
            for n, keep in sizes:
                # the JAX gate's backend is the CPU here: the port's with a
                # CPU device; a CUDA device stands for the TPU
                assert tk.use_seg_pack(n, keep, "cpu") == jk.use_seg_pack(n, keep), (
                    dispatch, mode, n, keep)
                want_card = dispatch and mode != "off" and n <= (1 << 31) - 1 and (
                    n >= tk.MIN_PALLAS_ELEMS or mode == "force") and keep * 8192 <= n * 128
                assert tk.use_seg_pack(n, keep, "cuda") == want_card
    monkeypatch.setattr(tk, "_SEG_PACK_DISPATCH", False)
    tk.set_pallas_mode("auto")
    assert not tk.use_seg_pack(6_573_120, 65_732, "cuda")   # off by default


def test_plain_versions_do_not_count_launches():
    tk.reset_launches()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(70000).astype(np.float32))
    t = torch.tensor(2.0)
    tk.pack_by_threshold(x, t, 700)
    tk.seg_pack_by_threshold(x, t, 700)
    tk.pack_ternary_bytes(torch.zeros(100, dtype=torch.int8))
    tk.qsgd_pack_bytes(torch.zeros(100, dtype=torch.int16))
    assert set(tk.LAUNCHES.values()) == {0}
    m = torch.zeros(10, device="meta")
    for fn in (lambda: tk.pack_by_threshold(m, t, 1), lambda: tk.seg_pack_by_threshold(m, t, 1),
               lambda: tk.pack_ternary_bytes(m.to(torch.int8)),
               lambda: tk.qsgd_pack_bytes(m.to(torch.int16))):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            fn()
