"""Cached latents and text embeddings for a text-to-image fine-tune (FLUX).

A FLUX fine-tune does not run its text encoders or its VAE encoder a step:
each image's VAE latents, its T5 tokens and its pooled CLIP vector are
computed once and stored. ``TextLatentsDataModule`` reads three ``.npy``
files of ``data_dir``, memory-mapped, one row a sample:

- ``latents.npy``: (N, C, H, W), the normalized latents, any float dtype;
- ``txt.npy``: (N, L, context_dim), the text encoder's tokens;
- ``pooled.npy``: (N, vec_dim), the pooled text vector.

The last ``val_fraction`` of the rows is the validation set. A batch is
``(latents NHWC fp32, conditioning)``, the conditioning one structured row
a sample (fields ``txt``, ``y``, ``guidance``; ``guidance`` the module's
value for every sample), so that the trainer slices, pads and shards it as
it does labels; ``to_device`` makes it the model's ``TextConditioning``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from tinyedm_tpu_torch.diffusion.protocols import TextConditioning

FILES = ("latents.npy", "txt.npy", "pooled.npy")


class TextLatentsDataModule:
    def __init__(self, batch_size: int, data_dir: str, num_workers: int = 0, seed: int = 0,
                 val_fraction: float = 0.01, guidance: float = 1.0):
        self.batch_size = batch_size
        self.data_dir = Path(data_dir)
        self.num_workers = num_workers  # accepted for config parity
        self.seed = seed
        self.val_fraction = val_fraction
        self.guidance = guidance
        self.arrays = None
        self.n_train = 0

    def prepare_data(self) -> None:
        missing = [f for f in FILES if not (self.data_dir / f).is_file()]
        if missing:
            raise FileNotFoundError(f"{self.data_dir}: no {', '.join(missing)} (cached latents and text embeddings)")

    def setup(self, stage: str = "fit") -> None:
        self.prepare_data()
        self.arrays = [np.load(self.data_dir / f, mmap_mode="r") for f in FILES]
        n = len(self.arrays[0])
        if any(len(a) != n for a in self.arrays):
            raise ValueError(f"{self.data_dir}: {FILES} hold {[len(a) for a in self.arrays]} rows, not one count")
        self.n_train = n - int(round(n * self.val_fraction))

    def _require(self) -> None:
        if self.arrays is None:
            raise RuntimeError("TextLatentsDataModule: call setup() first")

    def steps_per_epoch(self) -> int:
        self._require()
        return self.n_train // self.batch_size

    def _batch(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        latents, txt, pooled = self.arrays
        cond = np.empty(len(idx), [("txt", np.float32, txt.shape[1:]), ("y", np.float32, pooled.shape[1:]),
                                   ("guidance", np.float32)])
        cond["txt"], cond["y"], cond["guidance"] = txt[idx], pooled[idx], self.guidance
        return np.ascontiguousarray(latents[idx].transpose(0, 2, 3, 1), np.float32), cond

    def train_batches(self, epoch: int, skip: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Shuffled full batches of one epoch; ``skip`` passes over the first ones."""
        self._require()
        order = np.random.default_rng((self.seed, epoch)).permutation(self.n_train)
        for i in range(skip, self.steps_per_epoch()):
            yield self._batch(np.sort(order[i * self.batch_size:(i + 1) * self.batch_size]))

    def val_batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        self._require()
        n = len(self.arrays[0])
        for start in range(self.n_train, n, self.batch_size):
            yield self._batch(np.arange(start, min(start + self.batch_size, n)))

    @staticmethod
    def to_device(images: np.ndarray, cond: np.ndarray, device: torch.device | str
                  ) -> tuple[torch.Tensor, TextConditioning]:
        """A host batch as (NCHW fp32 latents, ``TextConditioning``) on the device."""
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device).permute(0, 3, 1, 2).contiguous()
        txt, y, g = (torch.from_numpy(np.ascontiguousarray(cond[f])).to(device) for f in ("txt", "y", "guidance"))
        return x, TextConditioning(txt, y, g)
