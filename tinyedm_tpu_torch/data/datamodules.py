"""Synthetic standard-normal feed for generation.

Counterpart of ``tinyedm_tpu/data/datamodules.py::RandomNoiseDataModule``:
numpy noise from ``np.random.default_rng(seed)``, NHWC, so one seed gives the
same noise in both packages.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class RandomNoiseDataModule:
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
