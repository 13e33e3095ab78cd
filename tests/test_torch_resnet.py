"""The port's ImageNet ResNets against the JAX package's, on the CPU.

Both sides take the same numpy-seeded inputs; the port's modules get the
JAX modules' initialised ``params`` and ``batch_stats`` through
``models/common.load_flax_params`` (conv kernels HWIO -> OIHW, the fc kernel
``(in, out)`` -> ``(out, in)``).  Width 8, 10 classes, 32 px, batch 4.
Tolerances, and why:

  * fp32 eval forward: within 1e-5 of the largest |logit| of the JAX fp32
    forward -- the two frameworks sum convolutions and reductions in
    different orders;
  * fp32 training forward and the BatchNorm running statistics after it:
    against the JAX forward in float64, within 1e-3 of the largest |entry|.
    At 32 px the last stage's maps are 1x1, so its batch statistics are over
    4 values and amplify rounding: ResNet-50's logits read 3.9e-4 (the
    port) and 1.2e-3 (JAX's own fp32) off the float64 ones;
  * gradients: the port's module at ``dtype=torch.float64`` against the JAX
    module at ``jnp.float64`` (``jax.enable_x64``), both from the same fp32
    weights and both rounding the logits to fp32 as the modules do, within
    1e-6 of each leaf's largest |entry| (the port's gradients land on fp32
    parameters).  Float32 gradients are no reference here: the same last
    stage makes them ill-conditioned, and JAX's own fp32 CPU gradients of
    ResNet-50 read up to 1.3e-2 of a leaf's largest entry off its float64
    ones (the port's 3.7e-3);
  * bf16 forward: ``|port - jax| <= 2^-7 |jax| + 0.05 rms(jax)`` (the share
    rule of ``tests/test_torch_models.py``: one bf16 ulp of each logit plus a
    share of the rms for the ulps each layer's bf16 activations may differ
    by);
  * the port's own init (its draws are torch's, not JAX's): each conv's
    standard deviation within 5 % of sqrt(2 / fan_out) and no entry past
    two of them, the fc lecun-normal or N(0, 0.01) under ``bn0``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_compressed_dp.models import resnet as jres
from tpu_compressed_dp.models.common import init_model

import torch

from tpu_compressed_dp_torch.models import common as tcommon
from tpu_compressed_dp_torch.models import resnet as tres


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's in-process torch work: under
    the tier-1 run's parallel workers, a thread per core in every worker
    oversubscribes the machine, and small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WIDTH, CLASSES, HW, BS = 8, 10, 32, 4
FWD_REL = 1e-5
TRAIN_FWD_REL = 1e-3
GRAD_REL = 1e-6
BF16_RMS_SHARE = 0.05


def _jdtype(dtype):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]


def _input(seed=0):
    return np.random.default_rng(seed).standard_normal((BS, HW, HW, 3)).astype(np.float32)


def _init(arch, bn0=False, dtype=jnp.float32):
    module = getattr(jres, arch)(num_classes=CLASSES, bn0=bn0, dtype=dtype, width=WIDTH)
    params, stats = init_model(module, jax.random.key(0), jnp.zeros((1, HW, HW, 3)))
    return module, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)


def _port(arch, params, stats, bn0=False, dtype=torch.float32):
    model = getattr(tres, arch)(num_classes=CLASSES, bn0=bn0, dtype=dtype, width=WIDTH)
    tcommon.load_flax_params(model, params, stats)
    return model


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_apply(module, params, stats, x, train):
    out = module.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=train,
                       mutable=["batch_stats"] if train else False)
    logits, new_stats = out if train else (out, {"batch_stats": None})
    return np.asarray(logits, np.float64), new_stats["batch_stats"]


def _x64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("arch,bn0", [("resnet18", False), ("resnet50", False),
                                      ("resnet18", True)])
def test_forward_grads_and_running_stats_match(arch, bn0):
    module, params, stats = _init(arch, bn0)
    x = _input()
    y = np.array([3, 7, 0, 9])
    model = _port(arch, params, stats, bn0)
    want, _ = _jax_apply(module, params, stats, x, False)
    got = model(torch.from_numpy(x), train=False).detach().double().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_REL * np.abs(want).max())
    with jax.enable_x64(True):
        m64 = getattr(jres, arch)(num_classes=CLASSES, bn0=bn0, dtype=jnp.float64, width=WIDTH)
        p64, s64 = _x64(params), _x64(stats)
        want, new_stats = _jax_apply(m64, p64, s64, x.astype(np.float64), True)
        got = model(torch.from_numpy(x), train=True).detach().double().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TRAIN_FWD_REL * np.abs(want).max())
        buffers = {k.replace(".", "/"): b.numpy() for k, b in model.named_buffers()}
        for k, v in _flat(new_stats).items():
            np.testing.assert_allclose(buffers[k], v, rtol=0,
                                       atol=TRAIN_FWD_REL * max(np.abs(v).max(), 1.0), err_msg=k)

        def loss(p):
            logits, _ = m64.apply({"params": p, "batch_stats": s64},
                                  jnp.asarray(x, jnp.float64), train=True,
                                  mutable=["batch_stats"])
            logits = logits.astype(jnp.float64)
            return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                                 jnp.asarray(y)[:, None], 1))

        grads_j = _flat(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(p64)))
    model = _port(arch, params, stats, bn0, dtype=torch.float64)
    leaves = tcommon.param_leaves(model)
    logits = model(torch.from_numpy(x).double(), train=True).double()
    loss_t = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    grads_t = torch.autograd.grad(loss_t, list(leaves.values()))
    got = _flat(tcommon.leaves_to_flax(dict(zip(leaves, grads_t))))
    assert list(got) == list(grads_j)
    for k, want in grads_j.items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=GRAD_REL * np.abs(want).max(),
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_bf16_forward_matches(arch):
    module, params, stats = _init(arch, dtype=jnp.bfloat16)
    model = _port(arch, params, stats, dtype=torch.bfloat16)
    x = _input(1)
    for train in (False, True):
        want, _ = _jax_apply(module, params, stats, x, train)
        got = model(torch.from_numpy(x), train=train).detach()
        assert got.dtype == torch.float32  # fp32 logits, as the JAX module's
        got = got.double().numpy()
        rms = float(np.sqrt(np.mean(want ** 2)))
        excess = np.abs(got - want) - 2.0 ** -7 * np.abs(want)
        assert excess.max() <= BF16_RMS_SHARE * rms, (arch, train, excess.max(), rms)
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("arch", ["resnet50", "resnet101"])
def test_leaf_order_and_shapes_are_flax(arch):
    """``param_leaves`` is ``jax.tree.flatten``'s order (resnet101's 23-block
    stage puts ``layer3_10`` before ``layer3_2``), every kernel carries over
    by rank, and the BatchNorm buffers are the flax ``batch_stats``."""
    module = getattr(jres, arch)(num_classes=CLASSES, width=WIDTH)
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.zeros((1, HW, HW, 3))))
    want = {k: tuple(s.shape) for k, s in _flat(jax.tree.map(
        lambda s: np.zeros(s.shape, np.int8), shapes["params"])).items()}
    model = getattr(tres, arch)(num_classes=CLASSES, width=WIDTH)
    leaves = tcommon.param_leaves(model)
    assert list(leaves) == list(want)
    if arch == "resnet101":
        names = [k.split("/")[0] for k in leaves]
        assert names.index("layer3_10") < names.index("layer3_2")
    got = {k: tuple(tcommon.to_flax_layout(k, np.zeros(tuple(p.shape), np.int8)).shape)
           for k, p in leaves.items()}
    assert got == want
    stats = {k for k in _flat(jax.tree.map(lambda s: np.zeros(0), shapes["batch_stats"]))}
    assert {k.replace(".", "/") for k, _ in model.named_buffers()} == stats


def test_resnet50_full_size():
    leaves = tcommon.param_leaves(tres.resnet50())
    assert len(leaves) == 161
    assert sum(p.numel() for p in leaves.values()) == 25_557_032


@pytest.mark.parametrize("bn0", [False, True])
def test_own_init(bn0):
    model = tres.resnet50(num_classes=CLASSES, bn0=bn0, width=16, seed=3)
    leaves = {k: p.detach() for k, p in tcommon.param_leaves(model).items()}
    for k, p in leaves.items():
        if k.endswith("kernel") and p.ndim == 4:
            std = np.sqrt(2.0 / (p.shape[0] * p.shape[2] * p.shape[3]))
            assert abs(float(p.std()) / std - 1.0) < 0.05, k
            # truncated at two of the underlying normal's std (std / 0.8796)
            assert float(p.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6, k
    fc = leaves["fc/kernel"]
    want = 0.01 if bn0 else np.sqrt(1.0 / fc.shape[1])
    assert abs(float(fc.std()) / want - 1.0) < 0.1
    for name in model.blocks:
        assert torch.all(getattr(model, name).bn3.scale == (0.0 if bn0 else 1.0))
        assert torch.all(getattr(model, name).bn1.scale == 1.0)
    again = tcommon.param_leaves(tres.resnet50(num_classes=CLASSES, bn0=bn0, width=16, seed=3))
    assert all(torch.equal(leaves[k], again[k]) for k in leaves)
