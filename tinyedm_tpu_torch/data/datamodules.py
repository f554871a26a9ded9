"""Host-side numpy feeds: synthetic train images and generation noise.

Counterparts of ``tinyedm_tpu/data/datamodules.py``'s ``AbstractDataModule``
(train batches, normalization), ``SyntheticDataModule`` and
``RandomNoiseDataModule``, copied: numpy only, NHWC, seeded with
``np.random.default_rng``, so one seed gives the same batches bit for bit in
both packages. ``to_device`` turns a batch into the port's NCHW tensors.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch


class AbstractDataModule:
    """In-memory numpy datasets and their shuffled, normalized train batches."""

    def __init__(self, batch_size: int, seed: int = 0):
        self.batch_size = batch_size
        self.seed = seed
        self.train_images: Optional[np.ndarray] = None  # NHWC uint8 or f32
        self.train_labels: Optional[np.ndarray] = None

    def _normalize(self, images: np.ndarray) -> np.ndarray:
        x = images.astype(np.float32) / 255.0
        return (x - 0.5) / 0.5

    def train_batches(
        self, epoch: int, drop_last: bool = True, skip: int = 0
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Shuffled, normalized (NHWC fp32, int32 labels) batches of one
        epoch, past the first ``skip``. The JAX package's horizontal-flip
        augmentation belongs to its CIFAR-10 module, not ported yet."""
        if self.train_images is None:
            raise RuntimeError("the data module holds no train images")
        rng = np.random.default_rng((self.seed, epoch))
        n = len(self.train_images)
        order = rng.permutation(n)
        stop = n - n % self.batch_size if drop_last else n
        for start in range(skip * self.batch_size, stop, self.batch_size):
            idx = order[start : start + self.batch_size]
            yield self._normalize(self.train_images[idx]), self.train_labels[idx].astype(np.int32)


class SyntheticDataModule(AbstractDataModule):
    """Random uint8 "images" for benchmarks and tests; no dataset needed."""

    def __init__(
        self,
        batch_size: int,
        image_size: int = 32,
        num_channels: int = 3,
        num_samples: int = 4096,
        num_classes_: int = 10,
        seed: int = 0,
    ):
        super().__init__(batch_size, seed)
        rng = np.random.default_rng(seed)
        shape = (num_samples, image_size, image_size, num_channels)
        self.train_images = rng.integers(0, 256, size=shape, dtype=np.uint8)
        self.train_labels = rng.integers(0, num_classes_, size=(num_samples,))


def to_device(
    images: np.ndarray, labels: Optional[np.ndarray], device: torch.device | str
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """An NHWC numpy batch as the port's (NCHW fp32, int64 labels) tensors."""
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32)).to(device)
    y = None if labels is None else torch.from_numpy(np.asarray(labels, np.int64)).to(device)
    return x.permute(0, 3, 1, 2).contiguous(), y


class RandomNoiseDataModule:
    def __init__(
        self,
        batch_size: int,
        image_size: int = 32,
        num_samples: int = 50000,
        num_classes: Optional[int] = None,
        num_channels: int = 3,
        seed: int = 0,
    ):
        self.batch_size = batch_size
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
