"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and the CUDA toolkit (the kernels build
with ``nvcc`` at first use) and skips without one.  The file imports only
``torch``, ``numpy``, ``pytest`` and the port, so it runs on a host without
JAX: ``python -m pytest -m cuda --noconftest tests/test_torch_cuda.py``
(``tests/conftest.py`` sets up JAX's CPU mesh for the other test files and
imports ``jax``; ``--noconftest`` leaves it out).  Each kernel is held to
its plain version bitwise (the flash kernels elementwise, by the rule of
``chip_smoke.py``); the plain versions are held to the JAX package on the
CPU by the other ``tests/test_torch_*.py`` files.
"""

import math

import numpy as np
import pytest
import torch

from tpu_compressed_dp_torch.ops import flash_attention as tfa
from tpu_compressed_dp_torch.ops import kernels as tk

SEED = 0x243F6A8885A308D3


def _mag(n: int, seed: int) -> np.ndarray:
    return np.abs(np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _grad(n=20000, seed=0, scale=1e-2):
    return (scale * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


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


def _assert_bf16_close(got, want, rms_share, name):
    """Elementwise ``|got - want| <= 2^-7 |want| + rms_share * rms(want)``:
    one bf16 ulp where both round float32 sums to either side of a rounding
    boundary, plus a share of the tensor's rms for what the sums differ by
    before the rounding."""
    rms = float(np.sqrt(np.mean(np.square(want, dtype=np.float64))))
    excess = np.abs(got - want) - 2.0 ** -7 * np.abs(want)
    assert excess.max() <= rms_share * rms, (name, float(excess.max()), rms)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (a float32 NaN equals itself)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


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


@pytest.mark.cuda
def test_cuda_dither_matches_plain():
    """On the card: the uniform, QSGD and TernGrad kernels equal their plain
    versions bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    dev = torch.device("cuda")
    for n in (1, 5, 70001):
        assert torch.equal(tk.uniform(SEED, n, dev), tk.uniform_plain(SEED, n, dev))
        x = torch.from_numpy(_grad(n)).to(dev)
        x[::7] = float("nan")
        inv = torch.tensor(3.0, device=dev)
        assert torch.equal(tk.qsgd_levels_kernel(x, inv, SEED, 255),
                           tk.qsgd_levels_plain(x, inv, SEED, 255))
        assert torch.equal(tk.terngrad_levels_kernel(x, inv, SEED),
                           tk.terngrad_levels_plain(x, inv, SEED))


@pytest.mark.cuda
def test_cuda_wire_kernels_match_plain():
    """On the card: select+pack and quantize+pack equal their plain
    versions bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    dev = torch.device("cuda")
    for n in (1, 4097, 70001):
        x = torch.from_numpy(_grad(n, seed=n)).to(dev)
        x[::7] = float("nan")
        for keep, t in ((1, 0.0), (max(1, n // 50), 0.01), (n + 3, 0.02)):
            t = torch.tensor(t, device=dev)
            got, want = tk.fused_select_pack(x, t, keep), tk.fused_select_pack_plain(x, t, keep)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        inv = torch.tensor(30.0, device=dev)
        assert torch.equal(tk.terngrad_pack_kernel(x, inv, SEED),
                           tk.terngrad_pack_plain(x, inv, SEED))
        for a, b in zip(tk.qsgd_pack_kernel(x, inv, SEED, 255),
                        tk.qsgd_pack_plain(x, inv, SEED, 255)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_bucket_route_matches_plain():
    """On the card: the bucket-route kernel equals its plain version
    bitwise, signed zeros and NaN payloads included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    dev = torch.device("cuda")
    for case in sorted(ROUTE_CASES):
        vals, idx, valid, W, cap, shard_n = _route_case(*ROUTE_CASES[case], poison=True)
        v, i = torch.from_numpy(vals).to(dev), torch.from_numpy(idx).to(dev)
        dest = torch.clamp(i // shard_n, max=W - 1).to(torch.int32)
        if valid is not None:
            dest = torch.where(torch.from_numpy(valid).to(dev), dest, W)
        got = tk.fused_bucket_route(v, i, dest, W, cap, shard_n)
        want = tk.fused_bucket_route_plain(v, i, dest, W, cap, shard_n)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_flash_kernels_match_plain():
    """On the card: forward, dq and dk/dv kernels against their plain
    versions, elementwise: float32 to 1e-4, lse to 1e-5, bf16 to one ulp plus
    a share of the rms (``chip_smoke.py``'s rule: o 2^-4, dq and dk 2^-7, dv
    2^-10; o's p is rounded against the running max of 64-row tiles, the
    plain version's of 512-row blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, dt in (((1, 4, 1024, 128), torch.float32), ((2, 3, 1024, 64), torch.bfloat16)):
        q, k, v, do = ((0.5 * torch.randn(shape, generator=gen, device=dev)).to(dt)
                       for _ in range(4))
        s = 1.0 / math.sqrt(shape[-1])
        o, lse = tfa.flash_fwd(q, k, v, s)
        delta = (do.float() * o.float()).sum(-1)
        got = [o, lse, tfa.flash_dq(q, k, v, do, lse, delta, s),
               *tfa.flash_dkv(q, k, v, do, lse, delta, s)]
        o2, lse2 = tfa.flash_fwd_plain(q, k, v, s)
        want = [o2, lse2, tfa.flash_dq_plain(q, k, v, do, lse, delta, s),
                *tfa.flash_dkv_plain(q, k, v, do, lse, delta, s)]
        shares = {"o": 2.0 ** -4, "dq": 2.0 ** -7, "dk": 2.0 ** -7, "dv": 2.0 ** -10}
        for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
            a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
            if name == "lse":
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)
            elif dt == torch.float32:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)
            else:
                _assert_bf16_close(a, b, shares[name], name)


def _poisoned(n: int, seed: int, dev) -> torch.Tensor:
    """A standard-normal vector with NaN, +-Inf and -0.0 planted."""
    x = torch.from_numpy(_grad(n, seed=seed, scale=1.0)).to(dev)
    x[::97] = float("nan")
    x[1::101] = float("inf")
    x[2::103] = -float("inf")
    x[3::107] = -0.0
    return x


# (n, rows, threshold): ragged multi-block sizes at block rows 16 and 512, a
# threshold that keeps ~99 % (every block past the first few overflows the
# payload), and t = 0 (zeros and -0.0 survive)
THRESHOLD_PACK_CASES = [(5000, 16, 2.0), (17000, 16, 2.5), (200_001, 512, 2.0),
                        (8192, 16, 0.01), (300_000, 512, 0.01), (70_001, 512, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("poison", [False, True], ids=["finite", "nan-inf-negzero"])
def test_cuda_threshold_pack_matches_plain(poison):
    """On the card: the threshold pack equals its plain version bitwise
    (vals, idx, EF and the shipped count), EF on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    dev = torch.device("cuda")
    for n, rows, t in THRESHOLD_PACK_CASES:
        x = _poisoned(n, n, dev) if poison else torch.from_numpy(_grad(n, n, 1.0)).to(dev)
        keep = max(1, n // 100)
        tt = torch.tensor(t, device=dev)
        for want_ef in (True, False):
            got = tk.pack_by_threshold(x, tt, keep, want_ef=want_ef, rows=rows)
            want = tk.pack_by_threshold_plain(x, tt, keep, want_ef=want_ef, rows=rows)
            assert got[0].shape == (tk.pack_payload_slots(n, keep, rows),)
            for a, b in zip(got, want):
                assert (a is None and b is None) or _bits_equal(a, b), (n, rows, t, want_ef)


@pytest.mark.cuda
@pytest.mark.parametrize("poison", [False, True], ids=["finite", "nan-inf-negzero"])
def test_cuda_seg_pack_matches_plain(poison):
    """On the card: the segmented pack equals its plain version bitwise (all
    five outputs), and so does the payload built from it; thresholds that
    leave segments under the cap and overflow it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    dev = torch.device("cuda")
    for n, t, keep in ((13000, 2.0, 150), (9000, 0.5, 200), (4096 * 2 + 777, 1.5, 64),
                       (300_001, 2.5, 3000), (70_000, 0.0, 700)):
        x = _poisoned(n, n, dev) if poison else torch.from_numpy(_grad(n, n, 1.0)).to(dev)
        tt = torch.tensor(t, device=dev)
        for want_ef in (True, False):
            got = tk.seg_pack_by_threshold(x, tt, keep, want_ef=want_ef)
            want = tk.seg_pack_by_threshold_plain(x, tt, keep, want_ef=want_ef)
            for a, b in zip(got, want):
                assert (a is None and b is None) or _bits_equal(a, b), (n, t, want_ef)
            for a, b in zip(tk.seg_pack_payload(got[0], got[1], got[3], keep),
                            tk.seg_pack_payload(want[0], want[1], want[3], keep)):
                assert _bits_equal(a, b)


@pytest.mark.cuda
def test_cuda_byte_packers_match_plain():
    """On the card: the ternary and QSGD byte packers equal their plain
    versions bitwise, over the full int8 / int16 ranges too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    dev = torch.device("cuda")
    for n in (1, 7, 12345, 65533, 70000):
        rng = np.random.default_rng(n)
        for lo, hi in ((-1, 2), (-128, 128)):
            lv = torch.from_numpy(rng.integers(lo, hi, n).astype(np.int8)).to(dev)
            assert _bits_equal(tk.pack_ternary_bytes(lv), tk.pack_ternary_bytes_plain(lv))
        for lo, hi in ((-255, 256), (-32768, 32768)):
            lv = torch.from_numpy(rng.integers(lo, hi, n).astype(np.int16)).to(dev)
            for a, b in zip(tk.qsgd_pack_bytes(lv), tk.qsgd_pack_bytes_plain(lv)):
                assert _bits_equal(a, b)
