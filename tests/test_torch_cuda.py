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


def _search_case(name: str):
    """``(mag, keep)`` for the device-resident search's branches: the
    refinement rounds count the candidates; the sampled round picks bin 0
    (the first 128 elements of every 2048-block, the whole sample, raised by
    10); the candidate buffer overflows (``_CAND_SLACK`` set small by the
    caller); NaN and Inf mixed in; 95 % exact zeros (the sample's edges 0 up
    to e[15], the zeros counted apart from the candidates); and n = 2^25,
    where the counts pass 2^24 and their float32 rounds."""
    n = 1 << 25 if name == "n2^25" else 1 << 20
    mag = _mag(n, 5)
    if name == "b_zero":
        mag.reshape(-1, 2048)[:, :128] += 10.0
    if name == "nan_inf":
        mag[::997] = np.nan
        mag[5::1009] = np.inf
    if name == "zeros":
        mag[np.random.default_rng(6).random(n) < 0.95] = 0.0
    return mag, n // 10


def _plain_search(mag, keep):
    return tk._topk_threshold_hist(mag, keep, count_fn=tk.count_ge_edges_plain)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(monkeypatch):
    """On the card: every kernel equals its plain version bitwise, and the
    device-resident threshold search equals the unfused glue on the plain
    counts and the CPU search (its whole state) in each of its branches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    dev = torch.device("cuda")
    mag = torch.from_numpy(_mag(300000, 12)).to(dev)
    hi = mag.max() * 1.0000002 + 1e-30
    edges = torch.cat([hi / 16 * torch.arange(16, device=dev, dtype=torch.float32),
                       hi.reshape(1)])
    state = tk.new_search_state(dev)
    tk.count_round(mag, state, 0.0, edges=edges)
    assert torch.equal(state[tk._ST_LAST_COUNTS:tk._ST_LAST_COUNTS + 16],
                       tk.count_ge_edges_plain(mag, edges))
    t = tk.topk_threshold(mag, 3000)
    t_plain = _plain_search(mag, 3000)
    assert t.item() == t_plain.item()
    for got, want in zip(tk.fused_sparsify(mag, t), tk.fused_sparsify_plain(mag, t)):
        assert torch.equal(got, want)
    # single refinement rounds over random brackets where lo and width * b
    # are of one size (there a contracted FMA rounds the new lo apart from
    # the glue's two roundings in ~12 % of bins): the kernel's whole state
    # against the plain round's
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_mag(65536, 13)).to(dev)
    for _ in range(64):
        lo = np.float32(rng.uniform(0.2, 1.0))
        state = tk.new_search_state(dev)
        state.view(torch.float32)[:3] = torch.tensor(
            [lo, lo * np.float32(rng.uniform(1.5, 3.0)), float(rng.integers(0, 2000))])
        want = state.clone()
        keep_f = float(rng.integers(1, 40000))
        tk.count_round(x, state, keep_f)
        tk.count_round_plain(x, want, keep_f)
        assert torch.equal(state, want), (state[:3].view(torch.float32), want[:3].view(
            torch.float32))
    for name in ("candidates", "b_zero", "overflow", "nan_inf", "zeros", "n2^25"):
        with monkeypatch.context() as m:
            if name == "overflow":
                m.setattr(tk, "_CAND_SLACK", 0.5)
            host, keep = _search_case(name)
            x = torch.from_numpy(host).to(dev)
            state = tk._hist_search(x, keep)
            want = _plain_search(x, keep)
            assert _bits_equal(state.view(torch.float32)[tk._ST_LO], want), name
            assert _bits_equal(tk.topk_threshold(x, keep), want), name
            # the CPU search (plain rounds) ends in the same state, word for word
            assert torch.equal(state.cpu(), tk._hist_search(torch.from_numpy(host), keep)), name
            cand_rounds = int(state[tk._ST_CAND_ROUNDS])
            assert cand_rounds == (4 if name in ("candidates", "nan_inf", "zeros", "n2^25")
                                   else 0), name


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


def _select_pack_cases(dev):
    """``(label, x, t, keep)`` for the one-pass select+pack's look-back and
    edges: n at one tile and one tile +- 1 of either tiling, on both sides
    of the size that picks the tiling, and across more than 1,000 tiles;
    survivors only in the last tile, or only in the first; ``count == keep``
    with ties at ``t``; ``keep > n``; misaligned views; ``-0.0`` survivors at
    ``t = 0``; ``t = NaN``; n > 2^24."""
    lib = tk._lib("select_pack")
    large_from = lib.tcdp_select_pack_large_from()
    small, large = lib.tcdp_select_pack_tile(1), lib.tcdp_select_pack_tile(large_from)
    full = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    cases = []
    for n in (small - 1, small, small + 1, large_from - 1, large_from,
              342 * large - 1, 342 * large, 342 * large + 1):
        x = torch.from_numpy(_grad(n, seed=n)).to(dev)
        cases += [(f"n={n} all survive", x, full(0.0), n),
                  (f"n={n} zeros t=0", torch.zeros(n, device=dev), full(0.0), n + 1),
                  (f"n={n} 2 %", x, tk.topk_threshold(x.abs(), n // 50), n // 50),
                  (f"n={n} keep > n", x, full(0.01), 2 * n + 5)]
    n = 1000 * large + 123
    x = torch.from_numpy(_grad(n, seed=1)).to(dev)
    cases.append(("1,000 tiles, 1 %", x, tk.topk_threshold(x.abs(), n // 100), n // 100))
    for where, sl in (("last", slice(n - 100, n)), ("first", slice(0, 100))):
        y = x.clone()
        y[sl] = 5.0
        cases += [(f"survivors only in the {where} tile", y, full(1.0), 64),
                  (f"survivors only in the {where} tile, underfull", y, full(1.0), 300)]
    ties = torch.from_numpy(np.random.default_rng(2).choice(
        np.float32([0.5, 1.0, -1.0, 2.0]), 3 * small + 17)).to(dev)
    cases.append(("count == keep, ties at t", ties, full(1.0), int((ties.abs() >= 1.0).sum())))
    for m in (3 * small + 5, large_from + 5):
        base = torch.from_numpy(_grad(m + 4, seed=4)).to(dev)
        for off in (1, 2, 3):
            v = base[off:off + m]
            cases.append((f"misaligned x[{off}:] of {m}", v, tk.topk_threshold(v.abs(), 200), 200))
    signed = torch.zeros(2 * small + 3, device=dev)
    signed[::3] = -0.0
    cases.append(("-0.0 survivors at t=0", signed, full(0.0), small))
    cases.append(("t=NaN", x, full(float("nan")), 77))
    n = (1 << 24) + 4099
    big = torch.from_numpy(_grad(n, seed=5)).to(dev)
    cases.append(("n > 2^24", big, tk.topk_threshold(big.abs(), n // 100), n // 100))
    return cases


@pytest.mark.cuda
def test_cuda_wire_kernels_match_plain():
    """On the card: select+pack and quantize+pack equal their plain
    versions bitwise; select+pack also in the look-back's cases
    (``_select_pack_cases``) and over 50 back-to-back launches on one
    input."""
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
    cases = _select_pack_cases(dev)
    for label, x, t, keep in cases:
        got, want = tk.fused_select_pack(x, t, keep), tk.fused_select_pack_plain(x, t, keep)
        assert all(_bits_equal(a, b) for a, b in zip(got, want)), label
    # the ranks come from the scan, not from the order the tiles ran in
    x, t, keep = next((x, t, k) for label, x, t, k in cases if label == "1,000 tiles, 1 %")
    want = tk.fused_select_pack_plain(x, t, keep)
    runs = [tk.fused_select_pack(x, t, keep) for _ in range(50)]
    for got in runs:
        assert all(_bits_equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_select_pack_state():
    """On the card: the select+pack's persistent state serves calls of
    alternating sizes (stale status words of a larger call ignored), a second
    stream keeps its own, and the epoch's wrap clears the status words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    dev = torch.device("cuda")
    big = torch.from_numpy(_grad(300_001, seed=6)).to(dev)
    inputs = [(big, 3000), (big[:70_001], 700), (big[5:100_006], 1000), (big, 3000)]
    for x, keep in inputs + inputs:
        t = tk.topk_threshold(x.abs(), keep)
        got, want = tk.fused_select_pack(x, t, keep), tk.fused_select_pack_plain(x, t, keep)
        assert all(_bits_equal(a, b) for a, b in zip(got, want))
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    t = tk.topk_threshold(big.abs(), 3000)
    want = tk.fused_select_pack_plain(big, t, 3000)
    with torch.cuda.stream(side):
        got = tk.fused_select_pack(big, t, 3000)
    torch.cuda.synchronize()
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    assert len({v.data_ptr() for k, v in tk._LB_STATE.items() if k[0] == big.device}) >= 2
    # the last epoch before the wrap, then the wrap's first
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = tk.lookback_state(big.device, stream, 1)
    state[-1] = (1 << 30) - 1  # ctrl word 2 (the epoch), little-endian
    for x, keep in inputs:
        t = tk.topk_threshold(x.abs(), keep)
        got, want = tk.fused_select_pack(x, t, keep), tk.fused_select_pack_plain(x, t, keep)
        assert all(_bits_equal(a, b) for a, b in zip(got, want))
    assert int(state[-1]) == (1 << 30) + len(inputs) - 1


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


def _route_equal(got, want) -> bool:
    return all(torch.equal(g.view(torch.uint8), w.view(torch.uint8)) for g, w in zip(got, want))


@pytest.mark.cuda
def test_cuda_route_buckets_matches_plain():
    """On the card: the one-launch route (windows found by the kernel's
    search, ``accepted`` written by the same launch) equals its plain
    version, ``route_slots`` + ``fused_bucket_route_plain``, bitwise, on the
    route cases, on views at odd offsets (the hierarchical slab's slices),
    and at the LM's payload k = 5,253,571 at W = 2 and 4; one kernel launch a
    call, by ``LAUNCHES`` and by the profiler's trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    inputs = []
    for case in sorted(ROUTE_CASES):
        vals, idx, valid, W, cap, shard_n = _route_case(*ROUTE_CASES[case], poison=True)
        v, i = torch.from_numpy(vals).to(dev), torch.from_numpy(idx).to(dev)
        ok = None if valid is None else torch.from_numpy(valid).to(dev)
        inputs.append((case, v, i, ok, W, cap, shard_n))
        # the same payload one element into a larger buffer
        vb, ib = torch.zeros(len(vals) + 1, device=dev), torch.zeros(
            len(vals) + 1, dtype=torch.int32, device=dev)
        vb[1:], ib[1:] = v, i
        okb = None
        if ok is not None:
            okb = torch.zeros(len(vals) + 1, dtype=torch.bool, device=dev)
            okb[1:] = ok
        inputs.append((f"{case} view", vb[1:], ib[1:], None if okb is None else okb[1:], W,
                       cap, shard_n))
    gen = torch.Generator(device=dev).manual_seed(9)
    n, k = 525_357_056, 5_253_571
    pick = torch.randperm(n, generator=gen, device=dev)[:k].sort().values.to(torch.int32)
    big = torch.randn(k, generator=gen, device=dev)
    for W in (2, 4):
        inputs.append((f"lm W={W}", big, pick, None, W, -(-int(round(1.25 * k)) // W),
                       -(-n // W)))
    for label, v, i, ok, W, cap, shard_n in inputs:
        tk.reset_launches()
        got = tk.route_buckets(v, i, ok, W, cap, shard_n)
        assert tk.LAUNCHES["bucket_route"] == 1, label
        want = tk.route_buckets_plain(v, i, ok, W, cap, shard_n)
        assert _route_equal(got, want), label
        dest = tk.route_slots(i, ok, W, cap, shard_n)[2]
        assert _route_equal(tk.fused_bucket_route(v, i, dest, W, cap, shard_n), want[:2]), label
    label, v, i, ok, W, cap, shard_n = inputs[-1]
    for _ in range(2):
        tk.route_buckets(v, i, ok, W, cap, shard_n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            tk.route_buckets(v, i, ok, W, cap, shard_n)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # CUPTI drops a record now and then: at most one activity a call, each the kernel
    assert 5 <= len(names) <= 10 and all("route_kernel" in nm for nm in names), names


@pytest.mark.cuda
def test_cuda_flash_kernels_match_plain():
    """On the card: forward, dq and dk/dv kernels against their plain
    versions, elementwise: float32 to 1e-4, lse to 1e-5, bf16 to one ulp plus
    a share of the rms (``chip_smoke.py``'s rule: o 2^-4, dq and dk 2^-7, dv
    2^-10; o's p is rounded against the running max of 64-row tiles, the
    plain version's of 512-row blocks).  bf16 runs on the tensor cores in
    64-row tiles: T = 192 takes three, an odd count of the 128-row blocks the
    dispatch gate asks for.  The cases with q scaled 4x concentrate the
    attention, so more entries take the ``seq_dots`` branch of dq and dk/dv
    (p >= 2^-8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, dt, q_scale in (((1, 4, 1024, 128), torch.float32, 1),
                               ((2, 3, 1024, 64), torch.bfloat16, 1),
                               ((1, 4, 1024, 128), torch.bfloat16, 1),
                               ((1, 2, 192, 128), torch.bfloat16, 1),
                               ((2, 2, 192, 64), torch.bfloat16, 1),
                               ((1, 4, 1024, 128), torch.bfloat16, 4),
                               ((2, 2, 192, 64), torch.bfloat16, 4)):
        q, k, v, do = ((0.5 * torch.randn(shape, generator=gen, device=dev)).to(dt)
                       for _ in range(4))
        q = q * q_scale
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
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                           err_msg=f"{name} {shape} q x{q_scale}")
            elif dt == torch.float32:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)
            else:
                _assert_bf16_close(a, b, shares[name], f"{name} {shape} q x{q_scale}")


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


def _hold_packs(x, t, keep, rows, label):
    """Both packs bitwise against their plain versions (the segmented one's
    payload too), EF on and off; ``rows`` None skips the threshold pack."""
    for want_ef in (True, False):
        if rows is not None:
            got = tk.pack_by_threshold(x, t, keep, want_ef=want_ef, rows=rows)
            want = tk.pack_by_threshold_plain(x, t, keep, want_ef=want_ef, rows=rows)
            for a, b in zip(got, want):
                assert (a is None and b is None) or _bits_equal(a, b), (label, rows, want_ef)
        got = tk.seg_pack_by_threshold(x, t, keep, want_ef=want_ef)
        want = tk.seg_pack_by_threshold_plain(x, t, keep, want_ef=want_ef)
        for a, b in zip(got, want):
            assert (a is None and b is None) or _bits_equal(a, b), (label, want_ef)
        for a, b in zip(tk.seg_pack_payload(got[0], got[1], got[3], keep),
                        tk.seg_pack_payload(want[0], want[1], want[3], keep)):
            assert _bits_equal(a, b), label


@pytest.mark.cuda
def test_cuda_packs_one_pass_edges():
    """On the card: the one-pass threshold and segmented packs at the edges
    of their units: n one short of, at and one past a source block (rows 16
    and 512), a unit of 65,536 elements and a 4096-element segment; rows 3
    (source blocks that do not divide a unit) and rows 600 / 1024 (a source
    block longer than a unit: the count pre-pass); misaligned views
    ``x[1:]``..``x[3:]``; truncation at block 0 and inside a unit; a keep cut
    inside a segmented tile; t above every |x| and t = NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    dev = torch.device("cuda")
    big = torch.from_numpy(_grad(400_003, seed=21, scale=1.0)).to(dev)
    full = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    for n in (1, 7, 2047, 2048, 2049, 4095, 4096, 4097, 16383, 16385, 65535, 65536, 65537,
              131073, 300_001):
        for rows in (3, 16, 512, 600, 1024):
            _hold_packs(big[:n], full(2.0), max(1, n // 100), rows, f"n={n}")
        _hold_packs(big[:n], full(0.0), max(1, n // 100), 512, f"n={n} t=0")
    for off in (1, 2, 3):
        for rows in (16, 512, 600):
            _hold_packs(big[off:], full(2.3), 4000, rows, f"x[{off}:]")
    # truncation at block 0: every element survives, 512 rows against 35
    _hold_packs(big[:200_001], full(0.0), 2000, 512, "truncated at block 0")
    # ~13 % survive at rows 16: 3 rows a block against 0.6 on average, so the
    # first block that does not ship lies inside a 32-block unit
    _hold_packs(big, full(1.5), 4000, 16, "truncated inside a unit")
    _hold_packs(big, full(1.0), 4000, 600, "truncated, rows 600")
    # keep cut after 2 of the 4 segments of tile 10 and 5 survivors more
    x = big[:300_001]
    elig = tk.seg_pack_by_threshold_plain(x, full(2.0), 1)[3]
    keep = int(elig[:42].sum()) + 5
    _hold_packs(x, full(2.0), keep, None, "keep cut inside a tile")
    _hold_packs(big, full(10.0), 5000, 512, "t above every |x|")
    _hold_packs(big, full(float("nan")), 5000, 512, "t = NaN")


@pytest.mark.cuda
def test_cuda_packs_state():
    """On the card: the threshold and segmented packs and select+pack share
    one look-back state a stream; back-to-back calls of all three at
    alternating sizes stay bitwise, a second stream keeps its own state, and
    the epoch's wrap clears the status words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    dev = torch.device("cuda")
    big = torch.from_numpy(_grad(300_001, seed=22, scale=1.0)).to(dev)
    t = torch.tensor(2.0, device=dev)
    inputs = [(big, 3000, 512), (big[:70_001], 700, 16), (big[5:100_006], 1000, 600),
              (big, 3000, 16)]

    def run_all():
        for x, keep, rows in inputs:
            _hold_packs(x, t, keep, rows, f"n={x.numel()}")
            got = tk.fused_select_pack(x, t, keep)
            assert all(_bits_equal(a, b)
                       for a, b in zip(got, tk.fused_select_pack_plain(x, t, keep)))

    run_all()
    run_all()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    want = tk.pack_by_threshold_plain(big, t, 3000)
    with torch.cuda.stream(side):
        got = tk.pack_by_threshold(big, t, 3000)
        got_seg = tk.seg_pack_by_threshold(big, t, 3000)
    torch.cuda.synchronize()
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    assert all(_bits_equal(a, b)
               for a, b in zip(got_seg, tk.seg_pack_by_threshold_plain(big, t, 3000)))
    assert len({v.data_ptr() for k, v in tk._LB_STATE.items() if k[0] == big.device}) >= 2
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = tk.lookback_state(big.device, stream, 1)
    state[-1] = (1 << 30) - 1  # ctrl word 2 (the epoch), little-endian
    run_all()
    # five launches an input: two of each pack (EF on and off) and select+pack
    assert int(state[-1]) == (1 << 30) - 1 + 5 * len(inputs)


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
    # the QSGD packer's 16-byte runs: every n % 32 class, views at each
    # element offset from a 16-byte boundary, the full int16 range
    full = torch.from_numpy(np.random.default_rng(3).integers(
        -32768, 32768, 1 << 16).astype(np.int16)).to(dev)
    for n in (32, 33, 39, 40, 63, 4096, 65519):
        for off in range(9):
            lv = full[off:off + n]
            for a, b in zip(tk.qsgd_pack_bytes(lv), tk.qsgd_pack_bytes_plain(lv)):
                assert _bits_equal(a, b), (n, off)


# the CIFAR nets: network -> (constructor(dtype), batch); fixed-width nets
# at their only width, the graph family at full width
def _cifar_nets():
    from tpu_compressed_dp_torch.harness import dawn

    return {name: (lambda dtype, n=name: dawn.MODELS[n](1.0, dtype, 0, "cpu"))
            for name in ("resnet9", "alexnet", "alexnet_module", "vgg16", "resnet9_graph",
                         "alexnet_graph")}


# card vs CPU, float32: cuDNN's convolutions sum in other orders than the
# CPU's (TF32 off); the logits within 1e-4 of the largest |logit|
CARD_FWD_REL = 1e-4
# bf16: one ulp of each logit plus 0.05 of the logits' rms, as the CPU
# parity tests hold the bf16 nets to the JAX modules
CARD_BF16_RMS_SHARE = 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_cifar_nets_forward_match_cpu(dtype):
    """On the card: every CIFAR net's forward (eval and train mode, dropout
    masks given) equals its CPU forward from the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    from tpu_compressed_dp_torch.harness import dawn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = dawn.DTYPES[dtype]
    dev = torch.device("cuda")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 32, 32, 3))
                         .astype(np.float32))
    for name, make in _cifar_nets().items():
        if dt != torch.float32 and name in ("alexnet_module", "vgg16"):
            continue  # fp32 only, as in the JAX harness
        cpu = make(dt)
        card = make(dt).to(dev)
        card.load_state_dict(cpu.state_dict())
        for train in (False, True):
            kw = {}
            if train and getattr(cpu, "dropout_rate", 0.0) > 0.0:
                g = torch.Generator().manual_seed(1)
                kw = {"dropout": [torch.rand(8, 1024 if name == "alexnet_module" else 4096,
                                             generator=g) < 0.5,
                                  torch.rand(8, 4096, generator=g) < 0.5]}
            want = cpu(x, train, **kw).detach().double().numpy()
            got = card(x.to(dev), train, **kw).detach().cpu().double().numpy()
            if dt == torch.float32:
                assert np.abs(got - want).max() <= CARD_FWD_REL * np.abs(want).max(), name
            else:
                _assert_bf16_close(got, want, CARD_BF16_RMS_SHARE, f"{name} train={train}")
        del card


@pytest.mark.cuda
def test_cuda_vgg16_fc1_topk_count_contract():
    """VGG16's fc1 (102,760,448 elements, past 2^24): the threshold the
    search returns keeps at least the keep count, ``count(|g| >= t) >=
    keep``, with a surplus only from ties at the threshold's resolution
    (well under 1 % of keep on normal data)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    from tpu_compressed_dp_torch.ops import compressors as tc

    dev = torch.device("cuda")
    n = 25088 * 4096
    g = torch.Generator(device=dev).manual_seed(3)
    mag = torch.randn(n, generator=g, device=dev).abs_()
    keep = tc.topk_keep_count(n, 0.01)
    t = tk.topk_threshold(mag, keep)
    at_least = int((mag >= t).sum())
    assert keep <= at_least <= 1.01 * keep, (at_least, keep)
    _, _, sent = tk.fused_sparsify(mag, t)
    assert int(sent.item()) == at_least


@pytest.mark.cuda
def test_cuda_powersgd_sync_is_approx():
    """On the card, at W = 1: the warm-started sync from
    ``init_group_state(n, r, seed)`` equals ``powersgd_approx(acc, seed)``
    bitwise (the same Q0 and the same fp32 products), at ResNet-9's largest
    leaf and VGG16's fc1; and equals the CPU's within 1e-4 of its largest
    entry (cuBLAS sums the products in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    from tpu_compressed_dp_torch.ops import lowrank as tlr
    from tpu_compressed_dp_torch.parallel import dp as tdp

    dev = torch.device("cuda")
    for n in (2_359_296, 102_760_448):
        g = torch.Generator(device=dev).manual_seed(n)
        acc = torch.randn(n, generator=g, device=dev) * 1e-2
        recon, q_new, _, _ = tlr.powersgd_group_sync(acc, tlr.init_group_state(n, 4, 9, dev),
                                                     4, 1)
        assert _bits_equal(recon, tlr.powersgd_approx(acc, 9, rank=4))
        # the dp sync (one 1-D leaf: no layout change) from the same warm start
        cfg = tdp.CompressionConfig(method="powersgd", rank=4, error_feedback=True)
        out, ef, comp, stats = tdp.make_stateful_grad_sync(cfg)(
            {"w": acc}, {"w": torch.zeros_like(acc)},
            {"q0": tlr.init_group_state(n, 4, 9, dev)}, 0)
        assert _bits_equal(out["w"], recon) and _bits_equal(comp["q0"], q_new)
        assert torch.equal(ef["w"], acc - recon)
        assert float(stats["sent_bits"]) == tlr.powersgd_group_bits(n, 4)
        if n < 10_000_000:
            cpu = tlr.powersgd_group_sync(acc.cpu(), tlr.init_group_state(n, 4, 9, dev).cpu(),
                                          4, 1)[0]
            assert (recon.cpu() - cpu).abs().max() <= 1e-4 * cpu.abs().max()


def _resnet50_state(cfg, dev):
    from tpu_compressed_dp_torch.models import resnet as tres
    from tpu_compressed_dp_torch.models.common import param_leaves
    from tpu_compressed_dp_torch.parallel import dp as tdp
    from tpu_compressed_dp_torch.train.optim import SGD
    from tpu_compressed_dp_torch.train.state import TrainState

    model = tres.resnet50(dtype=torch.bfloat16, seed=0, device=dev)
    params = param_leaves(model)
    opt = SGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
    return opt, TrainState.create(model, opt.init(params), tdp.init_ef_state(params, cfg),
                                  seed=7, comp=tdp.init_comp_state(params, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["topk", "randomk"])
def test_cuda_resnet50_step_and_overlap_bitwise(method):
    """Full-width bf16 ResNet-50 (1000 classes), batch 32 at 128 px, layer-wise
    sparsification 1 % + EF: two steps are finite, launch the method's
    kernels, and ``sync_overlap = 4`` (chunks issued from the backward
    pass's hooks) ends bitwise where ``sync_overlap = 1`` does: parameters,
    momentum, EF and BatchNorm statistics.  cuDNN runs its deterministic
    algorithms here: its default weight-gradient kernels may add in another
    order from run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda where there is one")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _resnet50_overlap_check(method)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _resnet50_overlap_check(method):
    from tpu_compressed_dp_torch.data.imagenet import IMAGENET_MEAN, IMAGENET_STD
    from tpu_compressed_dp_torch.models.common import make_normalizing_apply_fn, param_leaves
    from tpu_compressed_dp_torch.parallel import dp as tdp
    from tpu_compressed_dp_torch.train.step import make_train_step

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    batch = {"input": torch.randint(0, 256, (32, 128, 128, 3), generator=g, device=dev,
                                    dtype=torch.uint8),
             "target": torch.randint(0, 1000, (32,), generator=g, device=dev)}
    apply_fn = make_normalizing_apply_fn(IMAGENET_MEAN, IMAGENET_STD)
    ends = []
    for k in (1, 4):
        cfg = tdp.CompressionConfig(method=method, granularity="layerwise", ratio=0.01,
                                    error_feedback=True, sync_overlap=k)
        opt, state = _resnet50_state(cfg, dev)
        step = make_train_step(apply_fn, opt, cfg)
        tk.reset_launches()
        for _ in range(2):
            state, m = step(state, batch)
        assert math.isfinite(float(m["loss"]))
        want = ("count_ge", "fused_sparsify") if method == "topk" else ("uniform",)
        assert all(tk.LAUNCHES[r] > 0 for r in want), dict(tk.LAUNCHES)
        ends.append((param_leaves(state.model), dict(state.model.named_buffers()),
                     state.opt_state["momentum"], state.ef))
    for a, b in zip(*ends):
        assert list(a) == list(b)
        assert all(_bits_equal(a[k], b[k]) for k in a)
