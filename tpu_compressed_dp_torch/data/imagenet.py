"""ImageNet-style data pipeline: datasets, train/val loaders, rect-val.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.data.imagenet`, with
the same batches byte for byte:

  * ``TrainLoader``: RandomResizedCrop + horizontal flip + ``fast_collate``;
    batches are raw uint8 NHWC, normalised on the device by the step
    (``models/common.make_normalizing_apply_fn``);
  * ``ValLoader``: ``DistValSampler`` semantics: every process yields
    ``expected_num_batches`` batches, padding with *empty* batches when it
    runs out of images, so the eval step's world reduction never waits on a
    missing peer and every image is seen once;
  * ``rect_val=True``: aspect-ratio-sorted rectangular validation with the
    batch shapes quantised into ``ar_buckets`` distinct ones;
  * sharding across processes: a per-epoch seeded global permutation, split
    by stride.

Determinism contract: a train batch is a pure function of ``(seed, epoch,
process_index)``.

Datasets expose ``__len__`` / ``size(i) -> (w, h)`` / ``label(i)`` /
``load(i)``, which returns a uint8 HWC RGB numpy array (the JAX datasets
return PIL images).  Resizing runs through the native kernel
(``data/native.py``, built with ``g++`` at first use; a failed build
raises) unless the loader is built with ``backend="pil"``.  PIL is imported
only where it is used: ``ImageFolder`` decoding files and the PIL backend.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "SyntheticImages", "ImageFolder", "TrainLoader",
           "ValLoader", "val_batch_size"]

# 0-255 scale: loaders produce uint8, the step normalises on the device
IMAGENET_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def _pil():
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError("decoding image files and backend='pil' need Pillow (PIL), "
                          "which is not installed") from err
    return Image


class SyntheticImages:
    """Deterministic fake ImageFolder: varied sizes and aspect ratios (so the
    rect-val paths run), a colour per class (so smoke models learn)."""

    def __init__(self, n: int, num_classes: int = 1000, seed: int = 0, base_size: int = 48):
        self.n = int(n)
        self.num_classes = int(num_classes)
        self.seed = int(seed)
        self.base_size = int(base_size)
        rng = np.random.default_rng([seed, 0x5E7])
        self._labels = rng.integers(0, num_classes, size=self.n).astype(np.int64)
        # per-image (w, h): aspect ratios in [1/2, 2]
        ar = np.exp(rng.uniform(-math.log(2), math.log(2), size=self.n))
        scale = rng.uniform(0.8, 1.6, size=self.n)
        self._w = np.maximum((base_size * scale * np.sqrt(ar)).astype(int), 8)
        self._h = np.maximum((base_size * scale / np.sqrt(ar)).astype(int), 8)
        crng = np.random.default_rng([seed, 0xC01])
        self._colors = crng.integers(32, 224, size=(num_classes, 3))

    def __len__(self) -> int:
        return self.n

    def size(self, i: int) -> Tuple[int, int]:
        return int(self._w[i]), int(self._h[i])

    def label(self, i: int) -> int:
        return int(self._labels[i])

    def load(self, i: int) -> np.ndarray:
        w, h = self.size(i)
        rng = np.random.default_rng([self.seed, 0x1A6, i])
        noise = rng.integers(-32, 32, size=(h, w, 3))
        return np.clip(self._colors[self._labels[i]] + noise, 0, 255).astype(np.uint8)


class ImageFolder:
    """torchvision-layout tree ``root/<class>/<image>``; labels are the sorted
    class directory's index.  Image sizes (the rect-val aspect-ratio index)
    are read from the file headers by a thread pool and kept in
    ``root/.tpu_cdp_sizes.npz`` (the JAX loader's cache format) where the
    tree is writable."""

    SIZE_CACHE = ".tpu_cdp_sizes.npz"

    def __init__(self, root: str, *, size_cache: bool = True, scan_workers: int = 16):
        self.root = root
        classes = sorted(e.name for e in os.scandir(root) if e.is_dir())
        if not classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.classes = classes
        self.samples: List[Tuple[str, int]] = []
        for ci, cname in enumerate(classes):
            for e in sorted(os.scandir(os.path.join(root, cname)), key=lambda e: e.name):
                if os.path.splitext(e.name)[1].lower() in _IMG_EXTS:
                    self.samples.append((e.path, ci))
        self._bulk: Optional[np.ndarray] = None
        self._use_cache = bool(size_cache)
        self._scan_workers = max(int(scan_workers), 1)

    def __len__(self) -> int:
        return len(self.samples)

    def _rel_paths(self) -> np.ndarray:
        return np.asarray([os.path.relpath(p, self.root) for p, _ in self.samples])

    def _file_bytes(self) -> np.ndarray:
        # an image re-encoded in place almost surely changes its byte size
        return np.asarray([os.path.getsize(p) for p, _ in self.samples], np.int64)

    def _load_size_cache(self) -> Optional[np.ndarray]:
        path = os.path.join(self.root, self.SIZE_CACHE)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                paths, wh, nbytes = z["paths"], z["wh"], z["bytes"]
        except (OSError, KeyError, ValueError):
            return None  # a corrupt or old-format cache: rescan
        if (paths.shape[0] == len(self.samples) and np.array_equal(paths, self._rel_paths())
                and np.array_equal(nbytes, self._file_bytes())):
            return wh.astype(np.int64)
        return None

    def _save_size_cache(self, wh: np.ndarray) -> None:
        path = os.path.join(self.root, self.SIZE_CACHE)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        try:
            np.savez_compressed(tmp, paths=self._rel_paths(), wh=wh, bytes=self._file_bytes())
            os.replace(tmp, path)
        except OSError:
            # a read-only dataset: scan again next run
            if os.path.exists(tmp):
                os.unlink(tmp)

    def sizes_bulk(self) -> np.ndarray:
        """All image sizes as ``[n, 2] (w, h)``."""
        if self._bulk is None:
            cached = self._load_size_cache() if self._use_cache else None
            if cached is None:
                image = _pil()

                def header_size(sample: Tuple[str, int]) -> Tuple[int, int]:
                    with image.open(sample[0]) as im:  # reads the header only
                        return im.size

                with ThreadPoolExecutor(max_workers=self._scan_workers) as pool:
                    cached = np.asarray(list(pool.map(header_size, self.samples)), np.int64)
                if self._use_cache:
                    self._save_size_cache(cached)
            self._bulk = cached
        return self._bulk

    def size(self, i: int) -> Tuple[int, int]:
        wh = self.sizes_bulk()
        return int(wh[i, 0]), int(wh[i, 1])

    def label(self, i: int) -> int:
        return self.samples[i][1]

    def load(self, i: int) -> np.ndarray:
        with _pil().open(self.samples[i][0]) as im:
            return np.asarray(im.convert("RGB"), np.uint8)


def val_batch_size(sz: int, bs: int) -> int:
    """Validation batch floor per image size: small images leave memory
    headroom for bigger eval batches."""
    floor = 512 if sz <= 128 else (256 if sz <= 224 else 128)
    return max(bs, floor)


def _rrc_box(w: int, h: int, min_scale: float, rng: np.random.Generator):
    """torchvision ``RandomResizedCrop(scale=(min_scale, 1.0))`` box
    sampling; returns (x0, y0, x1, y1)."""
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(min_scale, 1.0)
        log_ratio = (math.log(3 / 4), math.log(4 / 3))
        ar = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * ar)))
        ch = int(round(math.sqrt(target_area / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return (x0, y0, x0 + cw, y0 + ch)
    # fallback: center crop of the largest square
    side = min(w, h)
    x0, y0 = (w - side) // 2, (h - side) // 2
    return (x0, y0, x0 + side, y0 + side)


def _check_backend(backend: str) -> bool:
    """True for the native kernel (built now, so that a failure shows at
    construction), False for PIL."""
    if backend not in ("native", "pil"):
        raise ValueError(f"backend must be native|pil, got {backend!r}")
    if backend == "native":
        from tpu_compressed_dp_torch.data import native

        native.build()
        return True
    _pil()
    return False


def _center_crop_resize(arr: np.ndarray, out_w: int, out_h: int,
                        enlarge: float = 1.0) -> np.ndarray:
    """PIL path: proportional resize (the shorter relative side scaled by
    ``enlarge``), then a center crop to exactly (out_h, out_w)."""
    image = _pil()
    img = image.fromarray(arr, "RGB")
    w, h = img.size
    scale = max(out_w * enlarge / w, out_h * enlarge / h)
    rw, rh = max(int(round(w * scale)), out_w), max(int(round(h * scale)), out_h)
    img = img.resize((rw, rh), image.BILINEAR)
    x0, y0 = (rw - out_w) // 2, (rh - out_h) // 2
    return np.asarray(img.crop((x0, y0, x0 + out_w, y0 + out_h)), np.uint8)


def _collate(arrays: Sequence[np.ndarray], labels: Sequence[int],
             h: int, w: int) -> Dict[str, np.ndarray]:
    """``fast_collate``: stack to uint8 NHWC."""
    x = np.zeros((len(arrays), h, w, 3), np.uint8)
    for i, a in enumerate(arrays):
        x[i] = a
    return {"input": x, "target": np.asarray(labels, np.int64)}


class TrainLoader:
    """Sharded, seeded, augmenting train loader: iterating twice without
    ``set_epoch`` replays the identical epoch, augmentation included."""

    def __init__(self, dataset, batch_size: int, sz: int, *, min_scale: float = 0.08,
                 seed: int = 0, workers: int = 4, process_index: int = 0,
                 process_count: int = 1, backend: str = "native"):
        self.ds = dataset
        self.batch_size = int(batch_size)
        self.sz = int(sz)
        self.min_scale = float(min_scale)
        self.seed = int(seed)
        self.workers = max(int(workers), 1)
        self.pi, self.pc = int(process_index), int(process_count)
        self.epoch = 0
        self.native = _check_backend(backend)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return (len(self.ds) // self.pc) // self.batch_size

    def _decode(self, job: Tuple[int, int]) -> np.ndarray:
        idx, aug_seed = job
        rng = np.random.default_rng([self.seed, self.epoch, aug_seed])
        arr = self.ds.load(idx)
        h, w = arr.shape[:2]
        box = _rrc_box(w, h, self.min_scale, rng)
        flip = rng.random() < 0.5  # RandomHorizontalFlip
        if self.native:
            from tpu_compressed_dp_torch.data import native

            return native.crop_resize(arr, box, self.sz, self.sz, flip)
        image = _pil()
        out = np.asarray(image.fromarray(arr, "RGB").resize(
            (self.sz, self.sz), image.BILINEAR, box=box), np.uint8)
        return out[:, ::-1] if flip else out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng([self.seed, self.epoch, 0xE90C])
        order = rng.permutation(len(self.ds))[self.pi::self.pc]
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            for b in range(len(self)):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                # the augmentation seed is the sample's global index, so the
                # worker count and the process layout never change the pixels
                arrays = list(pool.map(self._decode, [(int(i), int(i)) for i in idxs]))
                yield _collate(arrays, [self.ds.label(int(i)) for i in idxs], self.sz, self.sz)


class ValLoader:
    """Equal-batch-count validation loader: batch ``j`` of process ``i``
    holds global images ``[j*B*P + i*B, j*B*P + (i+1)*B)`` clipped to the
    dataset; trailing batches may be short or empty, but every process
    yields ``expected_num_batches`` batches and their union covers each image
    once."""

    def __init__(self, dataset, batch_size: int, sz: int, *, rect_val: bool = False,
                 ar_buckets: int = 8, workers: int = 4, process_index: int = 0,
                 process_count: int = 1, backend: str = "native"):
        self.ds = dataset
        self.batch_size = int(batch_size)
        self.sz = int(sz)
        self.rect_val = bool(rect_val)
        self.ar_buckets = max(int(ar_buckets), 1)
        self.workers = max(int(workers), 1)
        self.pi, self.pc = int(process_index), int(process_count)
        self.native = _check_backend(backend)
        self.expected_num_batches = max(-(-len(dataset) // (self.batch_size * self.pc)), 1)
        self._shapes: Optional[List[Tuple[int, int]]] = None
        self._order: Optional[np.ndarray] = None

    def _plan_rect(self) -> None:
        """Aspect-ratio-ascending order and one quantised (h, w) per batch,
        at most ``ar_buckets`` distinct shapes."""
        n = len(self.ds)
        if hasattr(self.ds, "sizes_bulk"):
            wh = np.asarray(self.ds.sizes_bulk(), np.float64)
            ars = wh[:, 0] / wh[:, 1]
        else:
            ars = np.asarray([self.ds.size(i)[0] / self.ds.size(i)[1] for i in range(n)])
        self._order = np.argsort(ars, kind="stable")
        gb = self.batch_size * self.pc
        nb = self.expected_num_batches
        shapes: List[Tuple[int, int]] = []
        prev_ar = 0.0
        for b in range(nb):
            bucket = b * self.ar_buckets // nb
            # every batch of a bucket takes the median aspect ratio of the
            # bucket's member images
            b_lo = -(-bucket * nb // self.ar_buckets)
            b_hi = -(-(bucket + 1) * nb // self.ar_buckets)
            members = self._order[b_lo * gb:min(b_hi * gb, n)]
            ar = float(np.median(ars[members])) if len(members) else 1.0
            ar = min(max(ar, 0.5), 2.0)
            if ar >= 1.0:
                h, w = self.sz, int(round(self.sz * ar))
            else:
                h, w = int(round(self.sz / ar)), self.sz
            # monotone non-decreasing w/h, so batch order follows the sort
            if shapes and w / h < prev_ar:
                h, w = shapes[-1]
            prev_ar = w / h
            shapes.append((h, w))
        self._shapes = shapes

    def _decode(self, job: Tuple[int, int, int]) -> np.ndarray:
        idx, h, w = job
        arr = self.ds.load(idx)
        enlarge = 1.14 if not self.rect_val else 1.0  # Resize(int(sz * 1.14))
        if not self.native:
            return _center_crop_resize(arr, w, h, enlarge)
        from tpu_compressed_dp_torch.data import native

        # the two-step resize + integer crop as one source box: the crop
        # rectangle in resized coordinates maps back through the exact
        # (rounded) resize dimensions
        sh, sw = arr.shape[:2]
        scale = max(w * enlarge / sw, h * enlarge / sh)
        rw = max(int(round(sw * scale)), w)
        rh = max(int(round(sh * scale)), h)
        cx0, cy0 = (rw - w) // 2, (rh - h) // 2
        box = (cx0 * sw / rw, cy0 * sh / rh, (cx0 + w) * sw / rw, (cy0 + h) * sh / rh)
        return native.crop_resize(arr, box, h, w)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.ds)
        if self.rect_val and self._shapes is None:
            self._plan_rect()
        order = self._order if self.rect_val else np.arange(n)
        gb = self.batch_size * self.pc
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            for b in range(self.expected_num_batches):
                h, w = self._shapes[b] if self.rect_val else (self.sz, self.sz)
                lo = b * gb + self.pi * self.batch_size
                idxs = [int(order[i]) for i in range(lo, min(lo + self.batch_size, n))]
                arrays = list(pool.map(self._decode, [(i, h, w) for i in idxs]))
                yield _collate(arrays, [self.ds.label(i) for i in idxs], h, w)
