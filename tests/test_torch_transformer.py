"""The port's Llama model against the JAX package's.

Both packages hold the same parameters: the JAX ``init_llama`` tree, carried
into the port by ``load_jax_params``, at ``tiny_llama`` dims in float32.
Tolerances, and why: logits, losses and gradients to rtol 1e-4 / atol 1e-5
(with 1e-6-scale absolute slack for the smallest gradients) -- the two
frameworks sum matmuls and reductions in different orders.  For this model
JAX's float32 CPU gradients agree with its own float64 ones to ~1e-7, so
unlike ResNet-9 they serve as the reference directly.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tpu_compressed_dp.models import transformer as jtf
from tpu_compressed_dp.train import lm_step as jlm

import torch

from tpu_compressed_dp_torch.models import transformer as ttf

CFG_J = dataclasses.replace(jtf.tiny_llama(), dtype=jnp.float32)
CFG_T = dataclasses.replace(ttf.tiny_llama(), dtype=torch.float32)


@pytest.fixture(scope="module")
def pair():
    params = jax.tree.map(np.asarray, jtf.init_llama(CFG_J, jax.random.key(0)))
    return params, ttf.load_jax_params(CFG_T, params)


def _tokens(seed=0, shape=(2, 64)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG_J.vocab_size, shape).astype(np.int32),
            rng.integers(0, CFG_J.vocab_size, shape).astype(np.int32))


def _path_names(tree):
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out.append(".".join(parts))
    return out


def test_leaf_order_and_sharding_match_jax(pair):
    params, model = pair
    leaves = ttf.param_leaves(model)
    assert list(leaves) == _path_names(params)
    for p, a in zip(leaves.values(), jax.tree.leaves(params)):
        assert tuple(p.shape) == a.shape and p.dtype == torch.float32
        np.testing.assert_array_equal(p.detach().numpy(), a)
    assert ttf.is_sharded(CFG_T) == jlm._lm_is_sharded(CFG_J)
    big = ttf.llama3_8b()
    assert ttf.is_sharded(dataclasses.replace(big, n_layers=2)) == jlm._lm_is_sharded(
        dataclasses.replace(jtf.llama3_8b(), n_layers=2))
    # the same widths and derived sizes as the JAX presets
    for name in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "ffn", "head_dim",
                 "rope_theta", "norm_eps"):
        assert getattr(big, name) == getattr(jtf.llama3_8b(), name)
        assert getattr(CFG_T, name) == getattr(CFG_J, name)
    specs = jax.tree.leaves(jtf.param_specs(CFG_J), is_leaf=lambda x: isinstance(x, P))
    assert len(specs) == len(leaves)


def test_rope_and_rms_norm_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
    pos = np.arange(40)
    got = ttf._rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0).numpy()
    want = np.asarray(jtf._rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    h = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    got = ttf._rms_norm(torch.from_numpy(h), torch.from_numpy(w), 1e-5).numpy()
    want = np.asarray(jtf._rms_norm(jnp.asarray(h), jnp.asarray(w), 1e-5))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_logits_loss_and_grads_match_jax(pair):
    params, model = pair
    x, y = _tokens()
    logits_j = np.asarray(jtf.apply_llama(CFG_J, params, jnp.asarray(x)))
    logits_t = model(torch.from_numpy(x))
    np.testing.assert_allclose(logits_t.detach().numpy(), logits_j, rtol=1e-4, atol=1e-5)
    hidden_j = np.asarray(jtf.apply_llama(CFG_J, params, jnp.asarray(x), return_hidden=True))
    np.testing.assert_allclose(model(torch.from_numpy(x), return_hidden=True).detach().numpy(),
                               hidden_j, rtol=1e-4, atol=1e-5)

    def loss_j(p):
        return jtf.vocab_parallel_xent(jtf.apply_llama(CFG_J, p, jnp.asarray(x)), jnp.asarray(y))

    lj, gj = jax.value_and_grad(loss_j)(params)
    leaves = ttf.param_leaves(model)
    lt = ttf.vocab_parallel_xent(model(torch.from_numpy(x)), torch.from_numpy(y))
    gt = torch.autograd.grad(lt, list(leaves.values()))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for name, a, b in zip(leaves, gt, jax.tree.leaves(gj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6, err_msg=name)


def test_vocab_parallel_xent_matches_jax():
    rng = np.random.default_rng(2)
    z = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    t = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want, g_want = jax.value_and_grad(lambda a: jtf.vocab_parallel_xent(a, jnp.asarray(t)))(
        jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    got = ttf.vocab_parallel_xent(zt, torch.from_numpy(t))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(g_want), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("chunk", [64, 2048])
def test_fused_head_xent_matches_jax(chunk):
    # vocab 2500 pads the last chunk at both chunk sizes (40 x 64, 2 x 2048)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((4, 12, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 2500)) / np.sqrt(32)).astype(np.float32)
    t = rng.integers(0, 2500, (4, 12)).astype(np.int32)

    def f(a, b):
        return jtf.fused_head_xent(a, b, jnp.asarray(t), None, chunk)

    want, (gh_j, gw_j) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    ht, wt = (torch.from_numpy(a).requires_grad_(True) for a in (h, w))
    got = ttf.fused_head_xent(ht, wt, torch.from_numpy(t), chunk)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh_j), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), rtol=1e-5, atol=1e-8)
    # and the unfused loss of the same logits
    hu, wu = (torch.from_numpy(a).requires_grad_(True) for a in (h, w))
    ref = ttf.vocab_parallel_xent(hu @ wu, torch.from_numpy(t))
    ref.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), wu.grad.numpy(), rtol=1e-5, atol=1e-8)


def test_fused_head_xent_bf16_matches_jax():
    rng = np.random.default_rng(4)
    h = rng.standard_normal((64, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 300)) / np.sqrt(32)).astype(np.float32)
    t = rng.integers(0, 300, (64,)).astype(np.int32)

    def f(a, b):
        return jtf.fused_head_xent(a, b, jnp.asarray(t), None, 128)

    want, (gh_j, gw_j) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    ht, wt = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in (h, w))
    got = ttf.fused_head_xent(ht, wt, torch.from_numpy(t), 128)
    got.backward()
    # float32 logits from bf16 operands in both; the gradients come back in
    # bf16, a rounding apart
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for g_t, g_j in ((ht.grad, gh_j), (wt.grad, gw_j)):
        g_j = np.asarray(jnp.asarray(g_j, jnp.float32))
        np.testing.assert_allclose(g_t.float().numpy(), g_j, rtol=0,
                                   atol=2.0 ** -7 * np.abs(g_j).max())


def test_fused_xent_auto_rule_matches_jax():
    for n, v, itemsize in ((8192, 128256, 2), (1024, 32000, 2), (8192, 32000, 4),
                           (4096, 65536, 4), (0, 0, 2)):
        assert ttf.use_fused_head_xent(n, v, itemsize) == (
            n * v * itemsize > jtf._FUSED_XENT_AUTO_BYTES)
    assert ttf.use_fused_head_xent(8192, 128256, 2)


def test_unported_options_raise(pair):
    # mixture-of-experts layers are ported (tests/test_torch_moe.py): a model
    # builds with the JAX layout, every second layer's FFN an expert stack
    moe = ttf.Llama(dataclasses.replace(CFG_T, n_experts=4))
    leaves = ttf.param_leaves(moe)
    assert tuple(leaves["layers.1.w_gate"].shape) == (4, CFG_T.dim, CFG_T.ffn)
    assert tuple(leaves["layers.1.router"].shape) == (CFG_T.dim, 4)
    assert "layers.0.router" not in leaves
    # remat is ported: each layer recomputed in the backward pass, the same
    # bits as without
    params, model = pair
    remat = ttf.load_jax_params(dataclasses.replace(CFG_T, remat=True), params)
    x, y = (torch.from_numpy(a) for a in _tokens())
    grads = []
    for m in (model, remat):
        loss = ttf.vocab_parallel_xent(m(x), y)
        grads.append([loss] + list(torch.autograd.grad(loss, list(ttf.param_leaves(m).values()))))
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    with pytest.raises(ValueError):
        ttf.load_jax_params(dataclasses.replace(CFG_T, n_layers=3),
                            jax.tree.map(np.asarray, jtf.init_llama(CFG_J, jax.random.key(1))))
