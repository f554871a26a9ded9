"""Host-side numpy input pipelines: the datasets and their batches.

Counterpart of ``tinyedm_tpu/data/datamodules.py``, copied: datasets load
once into host memory as numpy (MNIST IDX files, the CIFAR-10 python pickle
batches, ImageNet VAE latents as ``.npy`` files), per-epoch shuffling and
horizontal flips are vectorized numpy seeded with ``np.random.default_rng``,
so one seed gives the same batches bit for bit in both packages. Batches are
NHWC, normalized to "std 0.5" ((x/255 - 0.5) / 0.5); ``to_device`` turns one
into the port's NCHW tensors. A split of ImageNet latents may be one packed
``*.latpack`` store (``data/latpack.py``) in place of the ``.npy``
directories; it is read whole, on ``num_workers`` gather threads. MNIST and
CIFAR-10 at another ``image_size`` are resized with PIL's antialiased
BILINEAR filter, repeated bit for bit by ``data/resample.py`` (the machine
with the card has no PIL).

Over several ranks every rank draws the same global batches (the shared
seed) and the trainer takes its data rank's rows of each (``shard_batch``;
the ranks of a model group share theirs), as the JAX trainer does.
"""

from __future__ import annotations

import gzip
import pickle
import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from tinyedm_tpu_torch.data.resample import BILINEAR, resize_batch


class AbstractDataModule:
    """In-memory numpy datasets and their batch iterators."""

    def __init__(self, batch_size: int, num_workers: int = 0, seed: int = 0):
        self.batch_size = batch_size
        self.num_workers = num_workers  # accepted for config parity
        self.seed = seed
        self.train_images: Optional[np.ndarray] = None  # NHWC uint8 or f32
        self.train_labels: Optional[np.ndarray] = None
        self.val_images: Optional[np.ndarray] = None
        self.val_labels: Optional[np.ndarray] = None

    def prepare_data(self) -> None: ...

    def setup(self, stage: str = "fit") -> None: ...

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @property
    def num_classes(self) -> Optional[int]:
        if self.train_labels is None:
            return None
        return int(self.train_labels.max()) + 1

    # uint8 [0, 255] sources support the raw path: the host ships uint8 and
    # flip flags and the trainer normalizes and flips on the card
    raw_uint8 = False
    raw_flip = False  # whether the raw path carries flip flags

    def _flip_flags(self, n: int, rng: np.random.Generator) -> Optional[np.ndarray]:
        """Per-sample horizontal-flip decisions, None for no flips: drawn the
        same way by the host (``_augment``) and raw paths, so both consume
        the same rng stream."""
        return None

    def _augment(self, images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        flip = self._flip_flags(len(images), rng)
        if flip is None:
            return images
        out = images.copy()
        out[flip] = out[flip, :, ::-1]
        return out

    def _normalize(self, images: np.ndarray) -> np.ndarray:
        x = images.astype(np.float32) / 255.0
        return (x - 0.5) / 0.5

    def steps_per_epoch(self, drop_last: bool = True) -> int:
        n = len(self.train_images)
        return n // self.batch_size if drop_last else -(-n // self.batch_size)

    def _require(self, array: Optional[np.ndarray]) -> None:
        if array is None:
            raise RuntimeError(f"{type(self).__name__}: call setup() first")

    def train_batches(
        self, epoch: int, drop_last: bool = True, skip: int = 0
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Shuffled, augmented, normalized train batches of one epoch.

        ``skip`` passes over the first batches without gathering them (a
        mid-epoch resume), but still advances the augment rng by each, so
        the rest equal an uninterrupted epoch's bit for bit."""
        self._require(self.train_images)
        rng = np.random.default_rng((self.seed, epoch))
        n = len(self.train_images)
        order = rng.permutation(n)
        stop = n - n % self.batch_size if drop_last else n
        for bi, start in enumerate(range(0, stop, self.batch_size)):
            idx = order[start : start + self.batch_size]
            if bi < skip:
                self._flip_flags(len(idx), rng)
                continue
            images = self._augment(self.train_images[idx], rng)
            yield self._normalize(images), self.train_labels[idx].astype(np.int32)

    def train_batches_raw(
        self, epoch: int, drop_last: bool = True, skip: int = 0
    ) -> Iterator[tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
        """(uint8 images, flip flags or None, labels) batches: the raw twin
        of ``train_batches``, same order and rng stream, augmentation left to
        the caller. Only for ``raw_uint8`` modules."""
        if not self.raw_uint8:
            raise TypeError(f"{type(self).__name__} has no uint8 source for train_batches_raw")
        self._require(self.train_images)
        if self.train_images.dtype != np.uint8:
            raise TypeError(f"train_batches_raw needs uint8 images, got {self.train_images.dtype}")
        rng = np.random.default_rng((self.seed, epoch))
        n = len(self.train_images)
        order = rng.permutation(n)
        stop = n - n % self.batch_size if drop_last else n
        for bi, start in enumerate(range(0, stop, self.batch_size)):
            idx = order[start : start + self.batch_size]
            flags = self._flip_flags(len(idx), rng)
            if bi < skip:
                continue
            yield self.train_images[idx], flags, self.train_labels[idx].astype(np.int32)

    def val_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Full batches plus the tail, so every sample counts."""
        self._require(self.val_images)
        n = len(self.val_images)
        for start in range(0, n, self.batch_size):
            sl = slice(start, min(start + self.batch_size, n))
            yield self._normalize(self.val_images[sl]), self.val_labels[sl].astype(np.int32)


def _load_idx(path: Path) -> np.ndarray:
    """Parse an (optionally gzipped) uint8 IDX file (the MNIST format)."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        _, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        if dtype_code != 0x08:
            raise ValueError(f"{path}: only uint8 IDX files are read (type code {dtype_code:#x})")
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _resize_batch(images: np.ndarray, size: int) -> np.ndarray:
    """NHWC uint8 images at ``size`` x ``size``: PIL's antialiased BILINEAR
    resize, bit for bit (``data/resample.py``), as the JAX package resizes
    with PIL; the identity when they already are that size."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    return resize_batch(images, size, BILINEAR)


class MNISTDataModule(AbstractDataModule):
    """MNIST from raw IDX files under ``data_dir`` or ``data_dir/MNIST/raw``."""

    FILES = {
        "train_images": "train-images-idx3-ubyte",
        "train_labels": "train-labels-idx1-ubyte",
        "val_images": "t10k-images-idx3-ubyte",
        "val_labels": "t10k-labels-idx1-ubyte",
    }
    raw_uint8 = True

    def __init__(self, batch_size: int, num_workers: int = 0, image_size: int = 28,
                 data_dir: str = "datasets/mnist", seed: int = 0):
        super().__init__(batch_size, num_workers, seed)
        self.image_size = image_size
        self.data_dir = Path(data_dir)

    def _find(self, name: str) -> Path:
        for base in (self.data_dir, self.data_dir / "MNIST" / "raw"):
            for suffix in ("", ".gz"):
                p = base / (name + suffix)
                if p.exists():
                    return p
        raise FileNotFoundError(f"MNIST file {name} not found under {self.data_dir} (place raw idx files there)")

    def setup(self, stage: str = "fit") -> None:
        tri = _load_idx(self._find(self.FILES["train_images"]))[..., None]
        self.train_images = _resize_batch(tri, self.image_size)
        self.train_labels = _load_idx(self._find(self.FILES["train_labels"]))
        vi = _load_idx(self._find(self.FILES["val_images"]))[..., None]
        self.val_images = _resize_batch(vi, self.image_size)
        self.val_labels = _load_idx(self._find(self.FILES["val_labels"]))

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x) * 127.5 + 128).clip(0, 255).astype(np.uint8)


class CIFAR10DataModule(AbstractDataModule):
    """CIFAR-10 from the python pickle batches, with train-time horizontal
    flips; the validation set is the test split."""

    raw_uint8 = True
    raw_flip = True

    def __init__(self, batch_size: int, num_workers: int = 0, image_size: int = 32,
                 data_dir: str = "datasets/cifar10", seed: int = 0):
        super().__init__(batch_size, num_workers, seed)
        self.image_size = image_size
        self.data_dir = Path(data_dir)
        self.classes = (
            "airplane", "automobile", "bird", "cat", "deer",
            "dog", "frog", "horse", "ship", "truck",
        )

    def _batches_dir(self) -> Path:
        for base in (self.data_dir / "cifar-10-batches-py", self.data_dir):
            if (base / "data_batch_1").exists():
                return base
        raise FileNotFoundError(f"CIFAR-10 batches not found under {self.data_dir} (expects cifar-10-batches-py/)")

    @staticmethod
    def _load_batch(path: Path) -> tuple[np.ndarray, np.ndarray]:
        # the dataset's own pickle format; read only files the user placed
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC
        return images, np.asarray(d[b"labels"], np.int64)

    def setup(self, stage: str = "fit") -> None:
        base = self._batches_dir()
        imgs, labels = [], []
        for i in range(1, 6):
            im, lb = self._load_batch(base / f"data_batch_{i}")
            imgs.append(im)
            labels.append(lb)
        self.train_images = _resize_batch(np.concatenate(imgs), self.image_size)
        self.train_labels = np.concatenate(labels)
        vi, vl = self._load_batch(base / "test_batch")
        self.val_images = _resize_batch(vi, self.image_size)
        self.val_labels = vl

    def _flip_flags(self, n: int, rng: np.random.Generator) -> np.ndarray:
        return rng.random(n) < 0.5

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x) * 127.5 + 128).clip(0, 255).astype(np.uint8)


class ImageNetLatentsDataModule(AbstractDataModule):
    """Pre-extracted VAE latents: per-sample ``{idx}.npy`` under ``latents/``
    and ``labels/``, stored CHW and served NHWC, already normalized. Either
    ``train/`` and ``val/`` split directories, or one directory whose last
    ``val_fraction`` becomes the validation set."""

    def __init__(self, batch_size: int, num_workers: int = 0, image_size: int = 64,
                 data_dir: str = "datasets/imagenet/latents", val_fraction: float = 0.01, seed: int = 0):
        super().__init__(batch_size, num_workers, seed)
        self.image_size = image_size
        self.data_dir = Path(data_dir)
        self.val_fraction = val_fraction
        self._num_classes = 1000

    @property
    def num_classes(self) -> int:
        return self._num_classes

    @staticmethod
    def _load_split(root: Path, num_workers: int = 16) -> tuple[np.ndarray, np.ndarray]:
        packs = sorted(root.glob("*.latpack"))
        if len(packs) > 1:
            raise ValueError(
                f"multiple .latpack files under {root}: {[p.name for p in packs]} - keep exactly one per split "
                "(repack with data/latpack.py, or point data_dir at the one you mean)"
            )
        if packs:
            from tinyedm_tpu_torch.data.latpack import PackedLatents

            store = PackedLatents(packs[0], gather_threads=max(1, num_workers))
            try:
                lats, labs = store.gather(np.arange(store.n))
            finally:
                store.close()
            return lats, labs.astype(np.int64)
        lat_dir = root / "latents"
        lab_dir = root / "labels"
        files = sorted(lat_dir.glob("*.npy"), key=lambda p: int(p.stem))
        if not files:
            raise FileNotFoundError(f"no latents under {lat_dir}")

        def load_one(p: Path):
            lat = np.load(p)
            if lat.ndim == 3 and lat.shape[0] in (3, 4):  # CHW -> HWC
                lat = lat.transpose(1, 2, 0)
            return lat.astype(np.float32), int(np.load(lab_dir / p.name))

        with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
            pairs = list(pool.map(load_one, files, chunksize=256))
        return np.stack([p[0] for p in pairs]), np.asarray([p[1] for p in pairs], np.int64)

    @staticmethod
    def _is_split_dir(root: Path) -> bool:
        return (root / "latents").is_dir() or any(root.glob("*.latpack"))

    def setup(self, stage: str = "fit") -> None:
        workers = max(4, self.num_workers)
        if self._is_split_dir(self.data_dir / "train"):
            if not self._is_split_dir(self.data_dir / "val"):
                raise FileNotFoundError(
                    f"{self.data_dir}/train looks like a split dir but {self.data_dir}/val does not: "
                    "the train/ + val/ layout needs both splits, or point data_dir at one extraction "
                    f"dir to carve a val fraction ({self.val_fraction}) off its tail."
                )
            self.train_images, self.train_labels = self._load_split(self.data_dir / "train", workers)
            self.val_images, self.val_labels = self._load_split(self.data_dir / "val", workers)
            return
        images, labels = self._load_split(self.data_dir, workers)
        n_val = max(1, int(len(images) * self.val_fraction))
        self.train_images, self.train_labels = images[:-n_val], labels[:-n_val]
        self.val_images, self.val_labels = images[-n_val:], labels[-n_val:]

    def _normalize(self, images: np.ndarray) -> np.ndarray:
        return images.astype(np.float32)  # normalized at extraction

    def _augment(self, images: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        return images

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x)


class SyntheticDataModule(AbstractDataModule):
    """Random uint8 "images" for benchmarks and tests; no dataset needed.
    The validation set is the first max(batch_size, 64) train samples."""

    raw_uint8 = True

    def __init__(
        self,
        batch_size: int,
        image_size: int = 32,
        num_channels: int = 3,
        num_samples: int = 4096,
        num_classes_: int = 10,
        seed: int = 0,
    ):
        super().__init__(batch_size, 0, seed)
        rng = np.random.default_rng(seed)
        shape = (num_samples, image_size, image_size, num_channels)
        self.train_images = rng.integers(0, 256, size=shape, dtype=np.uint8)
        self.train_labels = rng.integers(0, num_classes_, size=(num_samples,))
        self.val_images = self.train_images[: max(batch_size, 64)]
        self.val_labels = self.train_labels[: max(batch_size, 64)]

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x) * 127.5 + 128).clip(0, 255).astype(np.uint8)


def to_device(
    images: np.ndarray, labels: Optional[np.ndarray], device: torch.device | str
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """An NHWC numpy batch as the port's (NCHW fp32, int64 labels) tensors."""
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32)).to(device)
    y = None if labels is None else torch.from_numpy(np.asarray(labels, np.int64)).to(device)
    return x.permute(0, 3, 1, 2).contiguous(), y


class RandomNoiseDataModule:
    """Seeded standard-normal noise (and labels) for generation."""

    def __init__(
        self,
        batch_size: int,
        num_workers: int = 0,
        image_size: int = 32,
        num_samples: int = 50000,
        num_classes: Optional[int] = None,
        num_channels: int = 3,
        seed: int = 0,
    ):
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.image_size = image_size
        self.num_samples = num_samples
        self.num_classes = None if num_classes in (None, -1, 0) else num_classes
        self.num_channels = num_channels
        self.seed = seed

    def predict_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yields (noise NHWC fp32, labels int32, global_indices)."""
        rng = np.random.default_rng(self.seed)
        for start in range(0, self.num_samples, self.batch_size):
            n = min(self.batch_size, self.num_samples - start)
            noise = rng.standard_normal(
                (n, self.image_size, self.image_size, self.num_channels),
                dtype=np.float32,
            )
            if self.num_classes:
                labels = rng.integers(0, self.num_classes, size=(n,), dtype=np.int32)
            else:
                labels = np.zeros((n,), np.int32)
            yield noise, labels, np.arange(start, start + n)
