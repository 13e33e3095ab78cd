"""The port's ImageNet data pipeline against the JAX package's, on the CPU.

Every comparison is bitwise (``np.array_equal``): the port's loaders hand out
the JAX loaders' uint8 NHWC batches and labels for the same
``(seed, epoch, process_index)``, on the native backend on both sides (the
port's copy of ``image_ops.cpp`` built into ``build/native/``) and on the PIL
backend; the port's ``crop_resize`` equals the JAX one on the same boxes.
Also here: rect-val shapes, the ``DistValSampler`` padding with empty
batches at world 2 and 3, ``val_batch_size``, ``bn_wd_mask`` and the phase
schedules (to one float32 ulp: the JAX interpolation runs jitted, where
XLA may fuse the final multiply-add).
"""

import os

import numpy as np
import pytest

from tpu_compressed_dp.data import imagenet as jdata
from tpu_compressed_dp.data import native as jnative
from tpu_compressed_dp.harness import imagenet as jharness
from tpu_compressed_dp.train import optim as joptim
from tpu_compressed_dp.train import schedules as jsched

from tpu_compressed_dp_torch.data import imagenet as tdata
from tpu_compressed_dp_torch.data import native as tnative
from tpu_compressed_dp_torch.harness import imagenet as tharness
from tpu_compressed_dp_torch.train import optim as toptim
from tpu_compressed_dp_torch.train import schedules as tsched

N_TRAIN, N_VAL, CLASSES = 37, 23, 5


@pytest.fixture(scope="module")
def datasets():
    return ((jdata.SyntheticImages(N_TRAIN, CLASSES, seed=0),
             tdata.SyntheticImages(N_TRAIN, CLASSES, seed=0)),
            (jdata.SyntheticImages(N_VAL, CLASSES, seed=7),
             tdata.SyntheticImages(N_VAL, CLASSES, seed=7)))


def _same(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
    return b


def test_synthetic_images_are_the_jax_pixels(datasets):
    (jd, td), _ = datasets
    for i in range(N_TRAIN):
        arr = td.load(i)
        assert arr.dtype == np.uint8 and arr.shape == (td.size(i)[1], td.size(i)[0], 3)
        assert np.array_equal(arr, np.asarray(jd.load(i)))
        assert td.label(i) == jd.label(i)


@pytest.mark.parametrize("backend", ["native", "pil"])
@pytest.mark.parametrize("world", [1, 2, 3])
def test_train_loader_bitwise(datasets, backend, world):
    (jd, td), _ = datasets
    for rank in range(world):
        for epoch in (0, 3):
            kw = dict(seed=11, min_scale=0.35, workers=2, process_index=rank,
                      process_count=world, backend=backend)
            a, b = jdata.TrainLoader(jd, 4, 24, **kw), tdata.TrainLoader(td, 4, 24, **kw)
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            got = _same(a, b)
            assert len(got) == (N_TRAIN // world) // 4
            # the same epoch replays bitwise
            _same(got, b)


@pytest.mark.parametrize("backend", ["native", "pil"])
@pytest.mark.parametrize("rect", [False, True])
def test_val_loader_bitwise_and_padding(datasets, backend, rect):
    _, (jd, td) = datasets
    for world in (1, 2, 3):
        counts = []
        for rank in range(world):
            kw = dict(rect_val=rect, ar_buckets=3, workers=2, process_index=rank,
                      process_count=world, backend=backend)
            a, b = jdata.ValLoader(jd, 5, 24, **kw), tdata.ValLoader(td, 5, 24, **kw)
            got = _same(a, b)
            assert len(got) == b.expected_num_batches == -(-N_VAL // (5 * world))
            counts.append([len(x["target"]) for x in got])
            if rect:
                shapes = {x["input"].shape[1:3] for x in got}
                assert len(shapes) <= 3 and all(24 in s for s in shapes)
                ars = [w / h for h, w in (x["input"].shape[1:3] for x in got)]
                assert ars == sorted(ars)  # aspect ratios ascend batch by batch
            else:
                assert all(x["input"].shape[1:3] == (24, 24) for x in got)
        # every process runs the same batch count; trailing batches are short
        # or empty, and their union is every image once
        assert sum(map(sum, counts)) == N_VAL
        if world == 3:
            assert 0 in counts[-1]  # an empty batch pads the last process


def test_val_batch_size_rule():
    for sz, bs in ((64, 8), (128, 4096), (160, 600), (224, 1792), (288, 1024), (320, 64)):
        assert tdata.val_batch_size(sz, bs) == jdata.val_batch_size(sz, bs)


def test_rrc_box_is_the_jax_draw():
    for seed in range(20):
        rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
        w, h = 20 + seed * 7, 90 - seed * 3
        for min_scale in (0.08, 0.5, 1.0):
            assert tdata._rrc_box(w, h, min_scale, rng_b) == jdata._rrc_box(w, h, min_scale,
                                                                          rng_a)


@pytest.mark.parametrize("box,out,flip", [
    ((10, 20, 150, 110), (64, 64), False),
    ((0, 0, 170, 130), (32, 48), True),
    ((5.5, 7.25, 100.5, 90.75), (224, 224), False),
    ((0, 0, 170, 130), (130, 170), False),
])
def test_native_crop_resize_bitwise(box, out, flip):
    img = np.random.default_rng(0).integers(0, 256, size=(130, 170, 3)).astype(np.uint8)
    got = tnative.crop_resize(img, box, out[0], out[1], flip)
    assert np.array_equal(got, jnative.crop_resize(img, box, out[0], out[1], flip))


def test_native_builds_under_build_dir():
    path = tnative.build()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(path) == os.path.join(repo, "build", "native")
    with pytest.raises(ValueError, match="HWC"):
        tnative.crop_resize(np.zeros((8, 8), np.uint8), (0, 0, 8, 8), 8, 8)
    with pytest.raises(ValueError, match="backend"):
        tdata.TrainLoader(tdata.SyntheticImages(4, 2), 2, 8, backend="auto")


def test_imagefolder_decodes_to_arrays(tmp_path):
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(1)
    for c in ("b_cls", "a_cls"):
        os.makedirs(tmp_path / c)
        for i in range(3):
            arr = rng.integers(0, 256, size=(10 + i, 14, 3)).astype(np.uint8)
            pil.fromarray(arr).save(tmp_path / c / f"{i}.png")
    jd, td = jdata.ImageFolder(str(tmp_path)), tdata.ImageFolder(str(tmp_path))
    assert len(td) == 6 and td.classes == ["a_cls", "b_cls"]
    np.testing.assert_array_equal(td.sizes_bulk(), jd.sizes_bulk())
    for i in range(len(td)):
        assert td.label(i) == jd.label(i) and td.size(i) == jd.size(i)
        assert np.array_equal(td.load(i), np.asarray(jd.load(i)))
    _same(jdata.ValLoader(jd, 4, 12, rect_val=True, backend="native"),
          tdata.ValLoader(td, 4, 12, rect_val=True, backend="native"))


def test_phases_and_schedules_match():
    assert tharness.one_machine_phases() == jharness.one_machine_phases()
    assert tharness.smoke_phases(48) == jharness.smoke_phases(48)
    for phases in (tharness.one_machine_phases(), tharness.smoke_phases()):
        assert tharness.total_epochs(phases) == jharness.total_epochs(phases)
        assert tharness.data_phases(phases) == jharness.data_phases(phases)
        eb = [37, 40, 12, 5, 9, 100, 3] * 6
        pairs = [(jsched.phase_lr_schedule_variable_bs(phases, eb),
                  tsched.phase_lr_schedule_variable_bs(phases, eb)),
                 (jsched.phase_lr_schedule(phases, 17), tsched.phase_lr_schedule(phases, 17)),
                 (jsched.epoch_from_steps(eb), tsched.epoch_from_steps(eb))]
        for j, t in pairs:
            for s in range(0, 1300, 7):
                want, got = np.float32(j(s)), t(s)
                assert got == want or abs(got - want) <= np.spacing(want), (s, got, want)


def test_bn_wd_mask_matches():
    import jax

    from tpu_compressed_dp.models import resnet as jres

    from tpu_compressed_dp_torch.models import common as tcommon
    from tpu_compressed_dp_torch.models import resnet as tres

    module = jres.resnet18(num_classes=4, width=8)
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0),
                                                jax.numpy.zeros((1, 32, 32, 3))))["params"]
    want = jax.tree_util.tree_flatten_with_path(joptim.bn_wd_mask(shapes))[0]
    leaves = tcommon.param_leaves(tres.resnet18(num_classes=4, width=8))
    got = toptim.bn_wd_mask(leaves)
    assert list(got.items()) == [("/".join(str(k.key) for k in p), v) for p, v in want]
    assert not got["bn1/scale"] and got["conv1/kernel"] and not got["layer1_0/bn2/bias"]
