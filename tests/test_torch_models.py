"""The port's CIFAR networks against the JAX package's, on the CPU.

Both sides take the same numpy-seeded inputs; the port's modules get the
JAX modules' initialised ``params`` and ``batch_stats`` through
``models/common.load_flax_params``, and the dropout keep masks the JAX
forward drew (read off ``nn.Dropout``'s outputs by a flax interceptor).
Tolerances, and why:

  * fp32 forward: logits within 1e-5 of the largest |logit| -- the two
    frameworks sum convolutions and reductions in different orders;
  * fp32 gradients: against the JAX gradients in float64
    (``jax.enable_x64``; its float32 CPU gradients are off by up to ~5 % in
    the first layers, see ``tests/test_torch_resnet9_step.py``), within 1e-4
    of each leaf's largest |entry| plus 1e-7 absolute (a conv bias ahead of
    BatchNorm has a zero gradient, which the float32 side reads as the
    rounding of a cancellation, ~1e-8 at these losses);
  * bf16 forward: ``|port - jax| <= 2^-7 |jax| + 0.05 rms(jax)`` -- one
    bf16 ulp of each logit where the two sides round a float32 sum to
    either side of a rounding boundary, plus a share of the logits' rms for
    the ulps every layer's bf16 activations may differ by before it;
  * ``GraphNet(resnet9_spec)`` and ``ResNet9`` from the same seed run the
    same operations in the same order: bitwise.

Whole VGG16 and AlexNet (module) parity runs under ``-m slow``.
"""

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp

from tpu_compressed_dp.models import alexnet as jalex
from tpu_compressed_dp.models import graph as jgraph
from tpu_compressed_dp.models import resnet9 as jres
from tpu_compressed_dp.models import vgg as jvgg
from tpu_compressed_dp.models.common import init_model

import torch

from tpu_compressed_dp_torch.models import alexnet as talex
from tpu_compressed_dp_torch.models import common as tcommon
from tpu_compressed_dp_torch.models import graph as tgraph
from tpu_compressed_dp_torch.models import resnet9 as tres
from tpu_compressed_dp_torch.models import vgg as tvgg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's in-process torch work: under
    the tier-1 run's parallel workers, a thread per core in every worker
    oversubscribes the machine, and small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCALE = 0.125
BS = 2
SMALL_VGG = [8, "M", 16, "M"]  # 32x32 -> 8x8, pooled to 7x7 in overlapping bins
FWD_REL = 1e-5
GRAD_REL = 1e-4
GRAD_ABS = 1e-7
BF16_RMS_SHARE = 0.05  # these nets read up to 0.0195 on the CPU


def _jdtype(dtype):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]


# network -> (JAX module at a dtype, port module at a dtype); the fixed-width
# nets take no dtype
NETS = {
    "resnet9": (lambda d: jres.ResNet9(channels=tres.scaled_channels(SCALE), dtype=d),
                lambda d: tres.ResNet9(channels=tres.scaled_channels(SCALE), dtype=d)),
    "alexnet": (lambda d: jres.AlexNetGraph(channels=tres.alexnet_channels(SCALE), dtype=d),
                lambda d: tres.AlexNetGraph(channels=tres.alexnet_channels(SCALE), dtype=d)),
    "resnet9_graph": (
        lambda d: jgraph.GraphNet(jgraph.resnet9_spec(channels=tres.scaled_channels(SCALE),
                                                      dtype=d)),
        lambda d: tgraph.GraphNet(tgraph.resnet9_spec(channels=tres.scaled_channels(SCALE),
                                                      dtype=d))),
    "alexnet_graph": (
        lambda d: jgraph.GraphNet(jgraph.alexnet_spec(channels=tres.alexnet_channels(SCALE),
                                                      dtype=d)),
        lambda d: tgraph.GraphNet(tgraph.alexnet_spec(channels=tres.alexnet_channels(SCALE),
                                                      dtype=d))),
    "vgg_small": (lambda d: jvgg.VGG(cfg=SMALL_VGG), lambda d: tvgg.VGG(cfg=SMALL_VGG)),
    "vgg_small_bn": (lambda d: jvgg.VGG(cfg=SMALL_VGG, batch_norm=True),
                     lambda d: tvgg.VGG(cfg=SMALL_VGG, batch_norm=True)),
    "alexnet_module": (lambda d: jalex.AlexNet(), lambda d: talex.AlexNet()),
    "vgg16": (lambda d: jvgg.vgg16(), lambda d: tvgg.vgg16()),
}
WHOLE = ("alexnet_module", "vgg16")  # full width only: -m slow
GRAPH_FAMILY = ("resnet9", "alexnet", "resnet9_graph", "alexnet_graph")


def _input(seed=0, n=BS):
    return np.random.default_rng(seed).standard_normal((n, 32, 32, 3)).astype(np.float32)


def _init(name, dtype=torch.float32):
    module = NETS[name][0](_jdtype(dtype))
    params, stats = init_model(module, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    return module, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)


def _port(name, params, stats, dtype=torch.float32):
    model = NETS[name][1](dtype)
    tcommon.load_flax_params(model, params, stats)
    return model


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_apply(module, params, stats, x, train, rng):
    """The JAX forward, and the keep masks its dropout layers drew."""
    masks = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            masks.append(np.asarray(out) != 0)
        return out

    variables = {"params": params, **({"batch_stats": stats} if stats else {})}

    def apply(variables, x):
        out = module.apply(variables, x, train=train,
                           mutable=["batch_stats"] if train and stats else False,
                           rngs={"dropout": rng} if train and rng is not None else {})
        return out[0] if isinstance(out, tuple) else out

    if isinstance(module, (jvgg.VGG, jalex.AlexNet)):
        with fnn.intercept_methods(record):  # eager: the masks are concrete
            logits = apply(variables, jnp.asarray(x))
    else:
        logits = jax.jit(apply)(variables, jnp.asarray(x))
    return np.asarray(logits, np.float64), [torch.from_numpy(m) for m in masks]


def _port_apply(model, x, train, masks=None):
    kw = {"dropout": masks} if getattr(model, "dropout_rate", 0.0) > 0.0 else {}
    return model(torch.from_numpy(x), train=train, **kw)


def _loss_j(module, stats, x, y, rng):
    def loss(p):
        variables = {"params": p, **({"batch_stats": stats} if stats else {})}
        out = module.apply(variables, x, train=True,
                           mutable=["batch_stats"] if stats else False, rngs={"dropout": rng})
        logits = out[0] if isinstance(out, tuple) else out
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], 1))
    return loss


def _check_forward_and_grads(name):
    module, params, stats = _init(name)
    model = _port(name, params, stats)
    x = _input()
    y = np.array([3, 7])
    rng = jax.random.key(5)
    for train in (False, True):
        want, masks = _jax_apply(module, params, stats, x, train, rng)
        got = _port_apply(model, x, train, masks).detach().double().numpy()
        tol = FWD_REL * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"{name} train={train}")
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        s64 = jax.tree.map(lambda a: np.asarray(a, np.float64), stats)
        m64 = NETS[name][0](jnp.float64) if name in GRAPH_FAMILY else module
        _, masks64 = _jax_apply(m64, p64, s64, x.astype(np.float64), True, rng)
        grads_j = jax.jit(jax.grad(_loss_j(m64, s64, jnp.asarray(x, jnp.float64),
                                           jnp.asarray(y), rng)))(p64)
        grads_j = _flat(jax.tree.map(np.asarray, grads_j))
    model = _port(name, params, stats)  # fresh BatchNorm statistics
    leaves = tcommon.param_leaves(model)
    logits = _port_apply(model, x, True, masks64)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    grads_t = torch.autograd.grad(loss, list(leaves.values()))
    got = _flat(tcommon.leaves_to_flax(dict(zip(leaves, grads_t))))
    assert list(got) == list(grads_j)
    for k, want in grads_j.items():
        np.testing.assert_allclose(got[k], want, rtol=0,
                                   atol=GRAD_REL * np.abs(want).max() + GRAD_ABS, err_msg=k)


@pytest.mark.parametrize("name", [n for n in NETS if n not in WHOLE])
def test_forward_and_grads_match(name):
    _check_forward_and_grads(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", WHOLE)
def test_whole_fixed_width_nets_match(name):
    _check_forward_and_grads(name)


@pytest.mark.parametrize("name", GRAPH_FAMILY)
def test_bf16_forward_matches(name):
    module, params, stats = _init(name, torch.bfloat16)
    model = _port(name, params, stats, torch.bfloat16)
    x = _input(1)
    for train in (False, True):
        want, _ = _jax_apply(module, params, stats, x, train, None)
        got = _port_apply(model, x, train).detach()
        assert got.dtype == torch.float32  # fp32 logits, as the JAX modules
        got = got.double().numpy()
        rms = float(np.sqrt(np.mean(want ** 2)))
        excess = np.abs(got - want) - 2.0 ** -7 * np.abs(want)
        assert excess.max() <= BF16_RMS_SHARE * rms, (name, train, excess.max(), rms)
    # parameters stay fp32 masters
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _random_tree(shapes, seed):
    """A tree of the given ``jax.eval_shape`` leaves filled with seeded
    normals (every entry distinct, so a transposed carry-over shows)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("name", [n for n in NETS if n != "vgg16"]
                         + [pytest.param("vgg16", marks=pytest.mark.slow)])
def test_layout_round_trip(name):
    """flax tree -> port module -> flax tree is the identity, keys in
    ``jax.tree.flatten`` order, batch_stats included, and the port's own
    init has the loaded leaves' shapes."""
    module = NETS[name][0](jnp.float32)
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    params = _random_tree(shapes["params"], 1)
    stats = _random_tree(shapes.get("batch_stats", {}), 2)
    model = _port(name, params, stats)
    leaves = tcommon.param_leaves(model)
    assert list(leaves) == list(_flat(params))
    back = _flat(tcommon.leaves_to_flax(leaves))
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    port_stats = {k.replace(".", "/"): b.numpy() for k, b in model.named_buffers()}
    assert set(port_stats) == set(_flat(stats))
    for k, v in _flat(stats).items():
        np.testing.assert_array_equal(port_stats[k], v, err_msg=k)
    fresh = tcommon.param_leaves(NETS[name][1](torch.float32))
    assert {k: tuple(p.shape) for k, p in fresh.items()} == \
        {k: tuple(p.shape) for k, p in leaves.items()}


def test_vgg16_and_alexnet_leaves_without_init():
    """The fixed-width nets' flax leaf paths, order and shapes (from
    ``jax.eval_shape``, no weights drawn) are the port's, and the kernels
    carry over by rank (VGG's ``Conv_<i>`` and AlexNet's ``conv<i>`` are
    4-D, every ``fc`` 2-D)."""
    for name, total in (("vgg16", 134_301_514), ("alexnet_module", 23_272_266)):
        module = NETS[name][0](jnp.float32)
        shapes = jax.eval_shape(lambda: module.init(jax.random.key(0),
                                                    jnp.zeros((1, 32, 32, 3))))["params"]
        flat = _flat(jax.tree.map(lambda s: np.zeros((0,)), shapes))
        want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.shape)
                for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        leaves = tcommon.param_leaves(NETS[name][1](torch.float32))
        assert list(leaves) == list(flat) == list(want)
        got = {k: tuple(tcommon.to_flax_layout(k, np.zeros(tuple(p.shape), np.float32)).shape)
               for k, p in leaves.items()}
        assert got == want
        assert sum(p.numel() for p in leaves.values()) == total


def test_graph_resnet9_equals_resnet9_bitwise():
    """The spec-built ResNet-9 from one seed is the module ResNet-9 from it:
    same weights, same operations, bitwise outputs and gradients, in fp32
    and bf16."""
    x = torch.from_numpy(_input(2, 4))
    for dtype in (torch.float32, torch.bfloat16):
        ch = tres.scaled_channels(SCALE)
        a = tres.ResNet9(channels=ch, seed=3, dtype=dtype)
        b = tgraph.GraphNet(tgraph.resnet9_spec(channels=ch, dtype=dtype, seed=3))
        la, lb = tcommon.param_leaves(a), tcommon.param_leaves(b)
        assert [p.shape for p in la.values()] == [p.shape for p in lb.values()]
        for p, q in zip(la.values(), lb.values()):
            assert torch.equal(p, q)
        for train in (True, False):
            oa, ob = a(x, train), b(x, train)
            assert torch.equal(oa, ob), (dtype, train)
        ga = torch.autograd.grad(a(x, True).square().sum(), list(la.values()))
        gb = torch.autograd.grad(b(x, True).square().sum(), list(lb.values()))
        assert all(torch.equal(u, v) for u, v in zip(ga, gb))


@pytest.mark.parametrize("hw", [1, 2, 8, 14])
def test_adaptive_avg_pool(hw):
    x = np.random.default_rng(hw).standard_normal((2, hw, hw, 5)).astype(np.float32)
    want = np.asarray(jvgg.adaptive_avg_pool(jnp.asarray(x), 7))
    got = tvgg.adaptive_avg_pool(torch.from_numpy(x), 7).numpy()
    assert got.shape == want.shape == (2, 7, 7, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_graph_wiring():
    """``build_graph``'s sequential wiring, ``./`` and ``../`` edges, and
    unknown inputs; ``Concat`` joins channels and ``Flatten`` flattens NHWC,
    as the JAX nodes do on NHWC arrays."""
    def spec_of(m):
        return {"a": m.Identity(), "blk": {"b": m.Mul(2.0), "c": (m.Add(), ["../a", "./b"])},
                "d": (m.Concat(), ["a", "blk/c"]), "e": m.Flatten()}

    g, jg = tgraph.build_graph(spec_of(tgraph)), jgraph.build_graph(spec_of(jgraph))
    assert {k: v[1] for k, v in g.items()} == {k: v[1] for k, v in jg.items()}
    with pytest.raises(ValueError, match="unknown input"):
        tgraph.build_graph({"a": tgraph.Identity(), "b": (tgraph.Add(), ["a", "nope"])})
    x = _input(3)
    out = tgraph.GraphNet(spec_of(tgraph), outputs=("d", "e"))(torch.from_numpy(x))
    want = jgraph.GraphNet(spec_of(jgraph), outputs=("d", "e")).apply({}, jnp.asarray(x))
    np.testing.assert_array_equal(out["d"].permute(0, 2, 3, 1).numpy(), np.asarray(want["d"]))
    np.testing.assert_array_equal(out["e"].numpy(), np.asarray(want["e"]))


def test_dropout_is_flax():
    """``where(keep, x / keep_prob, 0)`` with the given masks; a generator
    draws the same masks from the same seed; eval mode and rate 0 skip it."""
    x = torch.from_numpy(_input(4)).reshape(BS, -1)
    keep = torch.from_numpy(np.random.default_rng(0).random(x.shape) < 0.5)
    y = tcommon.flax_dropout(x, 0.5, [keep], 0)
    assert torch.equal(y, torch.where(keep, x * 2.0, torch.zeros(())))
    a = tcommon.flax_dropout(x, 0.5, torch.Generator().manual_seed(9), 0)
    b = tcommon.flax_dropout(x, 0.5, torch.Generator().manual_seed(9), 0)
    assert torch.equal(a, b) and 0.3 < float((a != 0).float().mean()) < 0.7
    assert tcommon.flax_dropout(x, 0.0, None, 0) is x
    with pytest.raises(ValueError, match="dropout"):
        tcommon.flax_dropout(x, 0.5, None, 0)
    model = talex.AlexNet()
    xin = torch.from_numpy(_input(5))
    assert torch.equal(model(xin), model(xin, train=False))
