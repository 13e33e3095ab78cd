"""The port's causal flash attention against the JAX package's.

The JAX side runs ``flash_causal_attention`` (the Pallas kernels in interpret
mode) and its ``jax.grad``; its ``lse`` comes from ``_fa_fwd``'s residual.
The port's plain versions (``flash_fwd_plain``, ``flash_dq_plain``,
``flash_dkv_plain``, the CPU path of the kernel wrappers) get the same numpy
inputs and a fixed cotangent ``do``.  Tolerances, and why:

  * float32: 1e-5 absolute (the JAX flash tests' own): both sum the same
    products over the same blocks, in other orders;
  * bfloat16: ``lse`` to 1e-5; ``o``, dq, dk and dv elementwise to one bf16
    ulp of each element (2^-7 |w|: both round float32 sums, which may sit on
    either side of a rounding boundary) plus 2^-8 of the tensor's rms for
    what the sums differ by before the rounding (the same blocks and
    rounding points, another summation order).

Also: the port's ``autograd.Function`` under ``force`` mode (the Pallas
interpreter's counterpart) against autograd through the unfused
``dense_causal_attention``, GQA through ``ring_attention`` against the JAX
function, and the dispatch gate.  The CUDA kernels themselves run only on
the card (``tests/test_torch_cuda.py``; ``python3 chip_smoke.py``).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_compressed_dp.ops import flash_attention as jfa
from tpu_compressed_dp.ops import ring_attention as jra

import torch

from tpu_compressed_dp_torch.ops import flash_attention as tfa
from tpu_compressed_dp_torch.ops import kernels as tk
from tpu_compressed_dp_torch.ops import ring_attention as tra

SHAPES = [(1, 2, 128, 64), (2, 1, 256, 128), (1, 1, 384, 64)]


def _inputs(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal(shape)).astype(dtype) for _ in range(4)]


def _jax_flash(q, k, v, do, dtype=jnp.float32):
    qj, kj, vj = (jnp.asarray(x, dtype) for x in (q, k, v))
    o, res = jfa._fa_fwd(qj, kj, vj, None, True)

    def f(a, b, c):
        out = jfa.flash_causal_attention(a, b, c, None, True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do, jnp.float32))

    grads = jax.grad(f, argnums=(0, 1, 2))(qj, kj, vj)
    to_np = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    return to_np(o), to_np(res[4]), [to_np(g) for g in grads]


def _port_plain(q, k, v, do, dtype=torch.float32):
    tq, tk_, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    s = 1.0 / math.sqrt(q.shape[-1])
    o, lse = tfa.flash_fwd_plain(tq, tk_, tv, s)
    delta = (tdo.to(torch.float32) * o.to(torch.float32)).sum(-1)
    dq = tfa.flash_dq_plain(tq, tk_, tv, tdo, lse, delta, s)
    dk, dv = tfa.flash_dkv_plain(tq, tk_, tv, tdo, lse, delta, s)
    return [x.to(torch.float32).numpy() for x in (o, lse, dq, dk, dv)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_versions_match_jax_interpret_f32(shape):
    q, k, v, do = _inputs(shape)
    o_j, lse_j, (dq_j, dk_j, dv_j) = _jax_flash(q, k, v, do)
    o, lse, dq, dk, dv = _port_plain(q, k, v, do)
    for name, got, want in (("o", o, o_j), ("lse", lse, lse_j), ("dq", dq, dq_j),
                            ("dk", dk, dk_j), ("dv", dv, dv_j)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)


def _assert_bf16_close(got, want, rms_share, name):
    """Elementwise ``|got - want| <= 2^-7 |want| + rms_share * rms(want)``:
    one bf16 ulp where both round float32 sums to either side of a rounding
    boundary, plus a share of the tensor's rms for what the sums differ by
    before the rounding."""
    rms = float(np.sqrt(np.mean(np.square(want, dtype=np.float64))))
    excess = np.abs(got - want) - 2.0 ** -7 * np.abs(want)
    assert excess.max() <= rms_share * rms, (name, float(excess.max()), rms)


def test_plain_versions_match_jax_interpret_bf16():
    shape = (1, 2, 256, 64)
    q, k, v, do = _inputs(shape, seed=1)
    o_j, lse_j, grads_j = _jax_flash(q, k, v, do, jnp.bfloat16)
    o, lse, *grads = _port_plain(q, k, v, do, torch.bfloat16)
    np.testing.assert_allclose(lse, lse_j, rtol=0, atol=1e-5, err_msg="lse")
    # the same blocks and rounding points: the sums differ by order only
    for name, got, want in zip(("o", "dq", "dk", "dv"), (o, *grads), (o_j, *grads_j)):
        _assert_bf16_close(got, want, 2.0 ** -8, name)


@pytest.mark.parametrize("shape", [(2, 2, 128, 64), (1, 3, 256, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_autograd_function_force_mode_vs_dense(shape):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(shape, seed=2))
    qs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    qd = [x.clone().requires_grad_(True) for x in (q, k, v)]
    old = tk.pallas_mode()
    tk.set_pallas_mode("force")
    try:
        tk.reset_launches()
        o = tra.ring_attention(*qs)
        (o * do).sum().backward()
        # the CPU path runs the plain versions, which count no launch
        assert set(tk.LAUNCHES.values()) == {0}
    finally:
        tk.set_pallas_mode(old)
    o_ref = tra.dense_causal_attention(*qd)
    (o_ref * do).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), o_ref.detach().numpy(), rtol=0, atol=1e-5)
    for a, b, name in zip(qs, qd, "qkv"):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=0, atol=1e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("mode", ["auto", "force"])
def test_gqa_ring_attention_vs_jax(mode):
    rng = np.random.default_rng(3)
    q = (0.5 * rng.standard_normal((2, 4, 128, 64))).astype(np.float32)
    k, v = ((0.5 * rng.standard_normal((2, 2, 128, 64))).astype(np.float32) for _ in range(2))
    do = rng.standard_normal(q.shape).astype(np.float32)

    def f(a, b, c):
        return jnp.sum(jra.ring_attention(a, b, c) * jnp.asarray(do))

    o_j = np.asarray(jra.ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    g_j = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    old = tk.pallas_mode()
    tk.set_pallas_mode(mode)
    try:
        o = tra.ring_attention(*ts)
        (o * torch.from_numpy(do)).sum().backward()
    finally:
        tk.set_pallas_mode(old)
    np.testing.assert_allclose(o.detach().numpy(), o_j, rtol=0, atol=1e-5)
    for t, g, name in zip(ts, g_j, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0, atol=1e-5,
                                   err_msg=f"d{name}")


def test_gqa_repeat_is_interleaved():
    # jnp.repeat(k, rep, axis=1): KV head j serves query heads j*rep .. j*rep+rep-1
    k = torch.arange(2 * 3 * 4 * 2, dtype=torch.float32).reshape(2, 3, 4, 2)
    got, _ = tra._repeat_kv(torch.zeros(2, 6, 4, 2), k, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.repeat(jnp.asarray(k.numpy()),
                                                                      2, axis=1)))


def test_dispatch_gate():
    old = tk.pallas_mode()
    try:
        for mode, dev, shape, want in (
                ("auto", "cpu", (1, 2, 128, 64), False),
                ("auto", "cuda", (1, 2, 128, 64), True),
                ("auto", "cuda", (1, 32, 8192, 128), True),   # no VMEM residency bound
                ("auto", "cuda", (1, 32, 16384, 128), True),
                ("auto", "cuda", (1, 2, 192, 64), False),     # T % 128
                ("auto", "cuda", (1, 2, 128, 32), False),     # D
                ("auto", "cuda", (1, 2, 64, 64), False),
                ("auto", "cuda", (1, 65536, 128, 64), False),  # B*H, a grid dimension
                ("force", "cpu", (1, 2, 128, 64), True),
                ("force", "cpu", (1, 2, 128, 16), False),
                ("off", "cuda", (1, 2, 128, 64), False)):
            tk.set_pallas_mode(mode)
            assert tra.use_fused_attention(shape, shape, torch.bfloat16, dev) is want, \
                (mode, dev, shape)
        tk.set_pallas_mode("auto")
        shape = (1, 2, 128, 64)
        assert tra.use_fused_attention(shape, shape, torch.float32, "cuda")
        assert not tra.use_fused_attention(shape, shape, torch.float16, "cuda")
        assert not tra.use_fused_attention(shape, (1, 2, 256, 64), torch.float32, "cuda")
    finally:
        tk.set_pallas_mode(old)
    assert tfa.check_kernel_shape((1, 2, 128, 64), torch.bfloat16) is None
    assert tfa.check_kernel_shape((1, 2, 64, 128), torch.float32) is None
    assert "dtype" in tfa.check_kernel_shape((1, 2, 128, 64), torch.float16)
    assert "shape" in tfa.check_kernel_shape((1, 2, 100, 64), torch.float32)
    assert "shape" in tfa.check_kernel_shape((2, 100, 64), torch.float32)
    assert tfa.pick_blocks(8192) == (256, 256) == jfa._pick_blocks(8192)
    for t in (128, 384, 1024, 1536):
        assert tfa.pick_blocks(t) == jfa._pick_blocks(t)


def test_sequence_ring_raises_and_wrapper_refuses_other_devices():
    q = torch.zeros(1, 2, 128, 64)
    with pytest.raises(NotImplementedError, match="item 11"):
        tra.ring_attention(q, q, q, axis_name="seq")
    m = torch.zeros(1, 2, 128, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfa.flash_fwd(m, m, m, 0.125)
