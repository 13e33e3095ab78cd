"""CIFAR-10 in-RAM pipeline: load, preprocess, augment, batch (numpy only).

The port's own copy of :mod:`tpu_compressed_dp.data.cifar10` (the port
imports nothing of the JAX package): the reference's numpy-side
preprocessing (`CIFAR10/core.py:43-56`: normalise / reflect-pad 4) and
per-epoch-sampled Crop(32,32) + FlipLR + Cutout(8,8) augmentation
(`core.py:62-114`), vectorised over the whole epoch, in NHWC.  Batches stay
uint8; the train step normalises on the device.

Loading uses torchvision files when present; the deterministic synthetic
sets keep tests and zero-egress environments working.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = [
    "CIFAR10_MEAN",
    "CIFAR10_STD",
    "load_cifar10",
    "synthetic_cifar10",
    "normalise",
    "pad",
    "augment_epoch",
    "Batches",
]

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)  # core.py:43
CIFAR10_STD = (0.2471, 0.2435, 0.2616)  # core.py:44


def normalise(x: np.ndarray, mean=CIFAR10_MEAN, std=CIFAR10_STD) -> np.ndarray:
    """(x - 255*mean) / (255*std) on uint8 NHWC input (`core.py:46-50`)."""
    x = np.asarray(x, np.float32)
    x -= np.asarray(mean, np.float32) * 255.0
    x *= 1.0 / (255.0 * np.asarray(std, np.float32))
    return x


def pad(x: np.ndarray, border: int = 4) -> np.ndarray:
    """Reflect-pad H and W of NHWC (`core.py:52-53`)."""
    return np.pad(x, [(0, 0), (border, border), (border, border), (0, 0)], mode="reflect")


def load_cifar10(data_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Raw uint8 NHWC CIFAR-10 from torchvision files (`torch_backend.py:36-42`).

    Raises FileNotFoundError (with a pointer to ``synthetic_cifar10``) when the
    dataset is absent and cannot be downloaded.
    """
    try:
        import torchvision

        train = torchvision.datasets.CIFAR10(root=data_dir, train=True, download=False)
        test = torchvision.datasets.CIFAR10(root=data_dir, train=False, download=False)
    except (ImportError, RuntimeError) as e:
        raise FileNotFoundError(
            f"CIFAR-10 not found under {data_dir!r} ({e}); download it there or use "
            "synthetic_cifar10() for smoke runs"
        ) from e
    return {
        "train": {"data": np.asarray(train.data), "labels": np.asarray(train.targets, np.int32)},
        "test": {"data": np.asarray(test.data), "labels": np.asarray(test.targets, np.int32)},
    }


def synthetic_cifar10(
    n_train: int = 2048, n_test: int = 512, num_classes: int = 10, seed: int = 0
) -> Dict[str, Dict[str, np.ndarray]]:
    """Deterministic learnable stand-in: class-dependent colour blobs + noise."""
    rng = np.random.RandomState(seed)

    def make(n):
        labels = rng.randint(0, num_classes, n).astype(np.int32)
        protos = np.random.RandomState(1234).randint(0, 255, (num_classes, 4, 4, 3))
        imgs = protos[labels]
        imgs = np.repeat(np.repeat(imgs, 8, axis=1), 8, axis=2).astype(np.float32)
        imgs += rng.randn(n, 32, 32, 3) * 25.0
        return {"data": np.clip(imgs, 0, 255).astype(np.uint8), "labels": labels}

    return {"train": make(n_train), "test": make(n_test)}


def synthetic_cifar10_hard(
    n_train: int = 16384,
    n_test: int = 4096,
    num_classes: int = 10,
    seed: int = 0,
    protos_per_class: int = 8,
    noise: float = 80.0,
    label_noise: float = 0.04,
    max_shift: int = 8,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Non-saturating synthetic benchmark (VERDICT r1 #2).

    The plain :func:`synthetic_cifar10` blobs saturate at 100% accuracy, which
    cannot separate good compressors from bad ones.  This variant is tuned so
    the 24-epoch DAWNBench protocol lands dense test accuracy ~0.9 (the
    regime of the reference's real-CIFAR claims, `CIFAR10/README.md:3`), with
    headroom for the method x ratio grid to order the way AAAI'20 Fig. 3
    does:

      * several low-frequency texture prototypes per class (intra-class
        variability — a linear classifier can't memorise one template);
      * random per-image contrast and circular shifts (needs the conv net's
        translation handling and the Crop augmentation to matter);
      * heavy pixel noise (optimisation quality shows in the margin);
      * irreducible label noise capping attainable accuracy below 1.
    """
    rng = np.random.RandomState(seed)
    prng = np.random.RandomState(4321)
    # smooth textures: 8x8 gaussian fields, bilinear-ish upsample x4 via repeat
    # + two box-blur passes
    protos = prng.randn(num_classes * protos_per_class, 8, 8, 3).astype(np.float32)
    up = np.repeat(np.repeat(protos, 4, axis=1), 4, axis=2)
    k = np.ones(5, np.float32) / 5.0
    for axis in (1, 2):
        up = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), axis, up)
    up /= up.std(axis=(1, 2, 3), keepdims=True) + 1e-8
    up = up.reshape(num_classes, protos_per_class, 32, 32, 3)

    def make(n):
        labels = rng.randint(0, num_classes, n).astype(np.int32)
        pidx = rng.randint(0, protos_per_class, n)
        base = up[labels, pidx]
        contrast = rng.uniform(0.6, 1.4, (n, 1, 1, 1)).astype(np.float32)
        img = base * contrast * 42.0 + 128.0
        # per-image circular shift (translation nuisance)
        sy = rng.randint(-max_shift, max_shift + 1, n)
        sx = rng.randint(-max_shift, max_shift + 1, n)
        row = (np.arange(32)[None, :] - sy[:, None]) % 32     # [n, 32]
        col = (np.arange(32)[None, :] - sx[:, None]) % 32
        img = img[np.arange(n)[:, None, None], row[:, :, None], col[:, None, :]]
        img += rng.randn(n, 32, 32, 3).astype(np.float32) * noise
        flip = rng.rand(n) < label_noise
        labels[flip] = rng.randint(0, num_classes, int(flip.sum()))
        return {"data": np.clip(img, 0, 255).astype(np.uint8), "labels": labels}

    return {"train": make(n_train), "test": make(n_test)}


def draw_augment_choices(
    n: int,
    shape: Tuple[int, int],
    rng: np.random.RandomState,
    crop: Tuple[int, int] = (32, 32),
    cutout: Optional[Tuple[int, int]] = (8, 8),
    flip: bool = True,
) -> dict:
    """Pre-sample one epoch's augmentation choices for all ``n`` images
    (``Transform.set_random_choices``, `core.py:107-114`).  Drawing is split
    from application so multi-process ranks can keep an identical RNG stream
    while transforming only their own shard (choices are a few ints per
    image; the pixel work is the expensive part)."""
    h, w = shape
    ch, cw = crop
    out = {"crop": crop, "cutout": cutout,
           "y0": rng.randint(0, h - ch + 1, n), "x0": rng.randint(0, w - cw + 1, n)}
    out["flip"] = rng.rand(n) < 0.5 if flip else None
    if cutout is not None:
        kh, kw = cutout
        out["cy"] = rng.randint(0, ch - kh + 1, n)
        out["cx"] = rng.randint(0, cw - kw + 1, n)
    return out


def apply_augment(x: np.ndarray, choices: dict,
                  rows: Optional[np.ndarray] = None) -> np.ndarray:
    """Apply pre-drawn Crop + FlipLR + Cutout, vectorised; ``rows`` selects a
    subset of images (output in ``rows`` order).  uint8 stays uint8 —
    normalisation belongs on device."""
    ch, cw = choices["crop"]
    y0, x0, f = choices["y0"], choices["x0"], choices["flip"]
    if rows is not None:
        x = x[rows]
        y0, x0 = y0[rows], x0[rows]
        f = f[rows] if f is not None else None
    n = x.shape[0]
    windows = np.lib.stride_tricks.sliding_window_view(x, (ch, cw), axis=(1, 2))
    out = windows[np.arange(n), y0, x0]  # (N, C, ch, cw)
    out = np.ascontiguousarray(out.transpose(0, 2, 3, 1))  # back to NHWC

    if f is not None:
        out[f] = out[f, :, ::-1, :]

    if choices["cutout"] is not None:
        kh, kw = choices["cutout"]
        cy, cx = choices["cy"], choices["cx"]
        if rows is not None:
            cy, cx = cy[rows], cx[rows]
        rr = np.arange(ch)[None, :]
        cc = np.arange(cw)[None, :]
        rmask = (rr >= cy[:, None]) & (rr < (cy + kh)[:, None])  # (N, H)
        cmask = (cc >= cx[:, None]) & (cc < (cx + kw)[:, None])  # (N, W)
        mask = rmask[:, :, None] & cmask[:, None, :]  # (N, H, W)
        out *= ~mask[..., None]
    return out


def augment_epoch(
    x: np.ndarray,
    rng: np.random.RandomState,
    crop: Tuple[int, int] = (32, 32),
    cutout: Optional[Tuple[int, int]] = (8, 8),
    flip: bool = True,
) -> np.ndarray:
    """One epoch's worth of Crop + FlipLR + Cutout over every image (the
    single-process path: draw + apply in one call)."""
    choices = draw_augment_choices(x.shape[0], x.shape[1:3], rng, crop, cutout, flip)
    return apply_augment(x, choices)


class Batches:
    """Epoch iterator yielding ``{'input', 'target'}`` numpy batches
    (`torch_backend.py:48-63` equivalent; augmentation happens per epoch when
    ``augment=True``, mirroring ``set_random_choices=True``)."""

    def __init__(
        self,
        data: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        *,
        shuffle: bool,
        augment: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        shard: Optional[Tuple[int, int]] = None,
    ):
        """``shard=(rank, procs)`` makes iteration yield this rank's
        ``batch_size/procs``-row slice of every global batch, with the RNG
        stream (augmentation choices + shuffle) identical to the unsharded
        iterator's — but the pixel-level augmentation work done only for the
        rank's own rows (the multi-host ``DistributedSampler`` role,
        `dataloader.py:33`, without P-fold redundant host work)."""
        self.data = data
        self.labels = np.asarray(labels, np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.augment = augment
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        if shard is not None:
            rank, procs = shard
            if batch_size % procs:
                raise ValueError(f"batch_size {batch_size} not divisible by "
                                 f"{procs} processes")
            if not drop_last:
                raise ValueError("sharded iteration requires drop_last=True "
                                 "(pad + slice short batches at the caller)")
        self.shard = shard
        self.rows = batch_size

    def trim(self, rows: int) -> None:
        """From the next epoch on, cut every global batch to its first
        ``rows`` rows (a shorter final batch passes as it is): the elastic
        remesh's batch of ``(bs // W') * W'`` rows, as
        ``train/elastic.TrimBatches`` trims it.  The RNG stream carries
        on."""
        rows = int(rows)
        if not 0 < rows <= self.batch_size:
            raise ValueError(f"cannot trim batches of {self.batch_size} rows to {rows}")
        self.rows = rows

    def reshard(self, rank: int, procs: int, rows: Optional[int] = None) -> None:
        """From the next epoch on, yield ``rank``'s ``rows/procs``-row slice
        of every global batch trimmed to ``rows`` rows (default: all; see
        :meth:`trim`): the elastic remesh's new world."""
        rows = self.batch_size if rows is None else int(rows)
        if rows % procs or not self.drop_last:
            raise ValueError(f"cannot shard {rows} of {self.batch_size} rows over {procs} "
                             "processes")
        self.trim(rows)
        self.shard = (int(rank), int(procs))

    def __len__(self) -> int:
        n = len(self.labels)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.labels)
        choices = (draw_augment_choices(n, self.data.shape[1:3], self.rng)
                   if self.augment else None)
        idx = self.rng.permutation(n) if self.shuffle else np.arange(n)
        if self.shard is None:
            x = apply_augment(self.data, choices) if self.augment else self.data
            stop = len(self) * self.batch_size if self.drop_last else n
            for lo in range(0, stop, self.batch_size):
                sel = idx[lo : lo + self.batch_size][:self.rows]
                yield {"input": x[sel], "target": self.labels[sel]}
            return
        rank, procs = self.shard
        per = self.rows // procs
        nb = len(self)
        # this rank's rows of every batch, in batch order
        sel = idx[: nb * self.batch_size].reshape(nb, self.batch_size)[:, :self.rows]
        sel = sel.reshape(nb, procs, per)[:, rank, :]
        sel = sel.reshape(-1)
        x = (apply_augment(self.data, choices, rows=sel)
             if self.augment else self.data[sel])
        y = self.labels[sel]
        for b in range(nb):
            lo = b * per
            yield {"input": x[lo:lo + per], "target": y[lo:lo + per]}
