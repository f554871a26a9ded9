"""PIL's 8-bit image resize, bit for bit, in numpy.

The JAX package resizes with Pillow (the ADM center crop of
``tinyedm_tpu/data/extract_latents.py:32-50`` with BOX and BICUBIC, the data
modules' ``_resize_batch`` with BILINEAR); the machine with the card has no
Pillow, so this module repeats ``Image.resize`` on 8-bit data:

- ``ImagingResample`` (Pillow's ``Resample.c``): two separable passes,
  horizontal first, each only where that side changes; the filter's support
  widened by the scale when reducing; each output's coefficients normalized
  in double, then rounded to fixed point with 22 fractional bits; a rounding
  bias of half a unit; a clip to uint8 after each pass. BOX, BILINEAR and
  BICUBIC (a = -0.5).
- ``Image.resize``'s mode rules: the same size is a copy; modes ``P`` and
  ``1`` take NEAREST whatever the filter (``ImagingScaleAffine``, whose
  source positions are a running double sum); ``RGBA`` and ``LA`` are
  premultiplied (``RGBa``, ``La``), resized and unpremultiplied with
  Pillow's integer rounding.

Arrays are HW (``L``, ``P``: the palette indices) or HWC (``LA``, ``RGB``,
``RGBA``) uint8. Any other mode raises, naming it. Vectorized over the output
pixels: a loop runs only over the filter's taps.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

NEAREST, BOX, BILINEAR, BICUBIC = "nearest", "box", "bilinear", "bicubic"
CHANNELS = {"L": 1, "P": 1, "LA": 2, "RGB": 3, "RGBA": 4}
_PRECISION_BITS = 32 - 8 - 2
BATCH_CHUNK = 4096  # images per vectorized pass of resize_batch: bounds its int32 temporaries


def _box(x: np.ndarray) -> np.ndarray:
    return ((x > -0.5) & (x <= 0.5)).astype(np.float64)


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    # Resample.c's bicubic_filter with a = -0.5, in its order of operations
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {BOX: (_box, 0.5), BILINEAR: (_bilinear, 1.0), BICUBIC: (_bicubic, 2.0)}


def _coefficients(in_size: int, out_size: int, filter: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``precompute_coeffs`` and ``normalize_coeffs_8bpc`` of Resample.c for
    the whole axis: the first source index and the count of taps of each
    output, and the (out_size, ksize) int32 fixed-point coefficients (zero
    past each output's count)."""
    fn, support = _FILTERS[filter]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64)
    count = xmax - xmin
    taps = np.arange(ksize)
    inside = taps[None, :] < count[:, None]
    w = np.where(inside, fn(((xmin[:, None] + taps[None, :]) - center[:, None] + 0.5) * ss), 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # C's sequential sum, not numpy's pairwise one
        ww = ww + w[:, j]
    k = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = k * (1 << _PRECISION_BITS)
    fixed = np.trunc(np.where(k < 0, -0.5 + scaled, 0.5 + scaled)).astype(np.int32)
    return xmin, count, fixed


def _pass(a: np.ndarray, axis: int, xmin: np.ndarray, k: np.ndarray) -> np.ndarray:
    """One separable pass of ``ImagingResample{Horizontal,Vertical}_8bpc``
    along ``axis`` of a uint8 array."""
    in_size = a.shape[axis]
    shape = [1] * a.ndim
    shape[axis] = len(xmin)
    acc = np.full(a.shape[:axis] + (len(xmin),) + a.shape[axis + 1:], 1 << (_PRECISION_BITS - 1), np.int32)
    for j in range(k.shape[1]):
        kj = k[:, j]
        if not kj.any():
            continue
        idx = np.minimum(xmin + j, in_size - 1)  # taps past the count carry a zero coefficient
        acc += np.take(a, idx, axis=axis).astype(np.int32) * kj.reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resample(a: np.ndarray, size: tuple[int, int], filter: str, lead: int = 0) -> np.ndarray:
    """``ImagingResampleInner`` on uint8 data whose height and width are
    axes ``lead`` and ``lead + 1``; ``size`` is (width, height)."""
    out_w, out_h = size
    in_h, in_w = a.shape[lead : lead + 2]
    ymin, ycount, ky = _coefficients(in_h, out_h, filter)
    if out_w != in_w:
        # the horizontal pass covers only the rows the vertical one reads
        first, last = int(ymin[0]), int(ymin[-1] + ycount[-1])
        xmin, _, kx = _coefficients(in_w, out_w, filter)
        a = _pass(a[(slice(None),) * lead + (slice(first, last),)], lead + 1, xmin, kx)
        ymin = ymin - first
    if out_h != in_h:
        a = _pass(a, lead, ymin, ky)
    return a


def _nearest(a: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``ImagingScaleAffine``: source positions as a running double sum from
    half a step, out-of-range positions filled with 0."""
    out_w, out_h = size
    in_h, in_w = a.shape[:2]

    def positions(in_size: int, out_size: int) -> np.ndarray:
        step = in_size / out_size
        o = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
        return np.where(o < 0.0, -1, np.trunc(o)).astype(np.int64)

    ys, xs = positions(in_h, out_h), positions(in_w, out_w)
    ok = (ys >= 0) & (ys < in_h)
    ok = ok[:, None] & ((xs >= 0) & (xs < in_w))[None, :]
    out = a[np.clip(ys, 0, in_h - 1)][:, np.clip(xs, 0, in_w - 1)]
    out[~ok] = 0
    return out


def _muldiv255(v: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    tmp = v.astype(np.uint32) * alpha + 128
    return (((tmp >> 8) + tmp) >> 8).astype(np.uint8)


def premultiply(a: np.ndarray) -> np.ndarray:
    """``RGBA`` -> ``RGBa`` (or ``LA`` -> ``La``): colour times alpha / 255
    with Pillow's MULDIV255 rounding."""
    alpha = a[..., -1:].astype(np.uint32)
    return np.concatenate([_muldiv255(a[..., :-1], alpha), a[..., -1:]], axis=-1)


def unpremultiply(a: np.ndarray) -> np.ndarray:
    """``RGBa`` -> ``RGBA``: colour * 255 // alpha clipped to 255, unchanged
    where alpha is 0 or 255."""
    alpha = a[..., -1:].astype(np.uint32)
    scaled = np.minimum(255 * a[..., :-1].astype(np.uint32) // np.maximum(alpha, 1), 255)
    color = np.where((alpha == 0) | (alpha == 255), a[..., :-1], scaled).astype(np.uint8)
    return np.concatenate([color, a[..., -1:]], axis=-1)


def _check(pixels: np.ndarray, mode: str) -> None:
    if mode not in CHANNELS:
        raise ValueError(f"image mode {mode!r} is not resized (only 8-bit {', '.join(CHANNELS)})")
    want = 2 if CHANNELS[mode] == 1 else 3
    if pixels.dtype != np.uint8 or pixels.ndim != want or (want == 3 and pixels.shape[-1] != CHANNELS[mode]):
        raise ValueError(f"mode {mode} takes {'HW' if want == 2 else 'HWC'} uint8 pixels with "
                         f"{CHANNELS[mode]} channel(s), got {pixels.dtype} {pixels.shape}")


def resize(pixels: np.ndarray, mode: str, size: tuple[int, int], filter: str) -> np.ndarray:
    """``Image.resize(size, filter)`` of 8-bit ``pixels`` in PIL ``mode``;
    ``size`` is (width, height), as PIL takes it. Returns the pixels in the
    same mode (``P``: the palette indices)."""
    _check(pixels, mode)
    if filter not in (NEAREST, *_FILTERS):
        raise ValueError(f"unknown filter {filter!r}")
    size = (int(size[0]), int(size[1]))
    if min(size) < 1:
        raise ValueError(f"size {size} must be positive")
    if size == (pixels.shape[1], pixels.shape[0]):
        return pixels.copy()
    if mode == "P" or filter == NEAREST:
        return _nearest(pixels, size)
    if mode in ("LA", "RGBA"):
        return unpremultiply(_resample(premultiply(pixels), size, filter))
    return _resample(pixels, size, filter)


def resize_batch(images: np.ndarray, size: int, filter: str) -> np.ndarray:
    """``resize`` of every image of an NHWC uint8 batch of 1 (``L``) or 3
    (``RGB``) channels to ``size`` x ``size``, the images ``BATCH_CHUNK`` at
    a time (the same arithmetic, vectorized over the batch)."""
    mode = {1: "L", 3: "RGB"}.get(images.shape[-1]) if images.ndim == 4 else None
    if mode is None or images.dtype != np.uint8:
        raise ValueError(f"resize_batch takes NHWC uint8 with 1 or 3 channels, got {images.dtype} {images.shape}")
    if filter not in _FILTERS:
        raise ValueError(f"unknown filter {filter!r}")
    if images.shape[1:3] == (size, size):
        return images.copy()
    step = BATCH_CHUNK
    parts = [_resample(images[i : i + step], (size, size), filter, lead=1) for i in range(0, len(images), step)]
    return np.concatenate(parts) if parts else np.empty((0, size, size, images.shape[-1]), np.uint8)


def to_rgb(pixels: np.ndarray, mode: str, palette: Optional[np.ndarray] = None) -> np.ndarray:
    """PIL's ``convert("RGB")``: grey repeated, alpha dropped, palette
    indices looked up in ``palette`` ((entries, 3) uint8)."""
    _check(pixels, mode)
    if mode == "P":
        if palette is None:
            raise ValueError("mode P needs its palette")
        if int(pixels.max(initial=0)) >= len(palette):
            raise ValueError(f"palette index past the {len(palette)}-entry palette")
        return palette[pixels]
    if mode in ("L", "LA"):
        grey = pixels if mode == "L" else pixels[..., 0]
        return np.repeat(grey[..., None], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])
