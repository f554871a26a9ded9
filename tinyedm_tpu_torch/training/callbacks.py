"""PNG writer for generated batches.

Counterpart of ``tinyedm_tpu/training/callbacks.py::PreditionWriter`` (the
reference's spelling kept). PNGs are encoded with the standard library
(zlib + struct): the machine with the card has no Pillow.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Sequence

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def encode_png(image: np.ndarray) -> bytes:
    """8-bit PNG of a (H, W) grey, (H, W, 1) grey, (H, W, 3) RGB or
    (H, W, 4) RGBA uint8 image: the color types PIL writes for those shapes
    (0, 2 and 6), so a 4-channel latent sample is written as RGBA, as the
    JAX package's PreditionWriter writes it."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {image.dtype}")
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    color_types = {3: 2, 4: 6}
    if image.ndim == 2:
        color_type = 0
    elif image.ndim == 3 and image.shape[-1] in color_types:
        color_type = color_types[image.shape[-1]]
    else:
        raise ValueError(
            f"encode_png takes (H, W), (H, W, 1), (H, W, 3) or (H, W, 4), got {image.shape}"
        )
    h, w = image.shape[:2]
    rows = np.ascontiguousarray(image).reshape(h, -1)
    # filter type 0 (none) in front of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw))
        + _chunk(b"IEND", b"")
    )


class PreditionWriter:
    """Writes generated NHWC batches as PNGs named by global sample index:
    pred * std * 2 + mean, clamp [0, 1], * 255, uint8 (a uint8 batch is taken
    as already mapped)."""

    def __init__(self, output_dir: str, write_interval: str, mean: Sequence[float], std: Sequence[float]):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.write_interval = write_interval
        self.mean = np.asarray(mean, np.float32).reshape(1, 1, 1, -1)
        self.std = np.asarray(std, np.float32).reshape(1, 1, 1, -1)

    def write_batch(self, prediction: np.ndarray, batch_indices: Sequence[int]) -> None:
        prediction = np.asarray(prediction)
        if prediction.dtype == np.uint8:
            images = prediction
        else:
            images = prediction.astype(np.float32) * self.std * 2.0 + self.mean
            images = (np.clip(images, 0.0, 1.0) * 255.0).astype(np.uint8)
        for index, image in zip(batch_indices, images):
            (self.output_dir / f"{index}.png").write_bytes(encode_png(image))
