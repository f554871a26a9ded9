"""The port's PIL resampler (``tinyedm_tpu_torch/data/resample.py``) and the
ADM center crop (``data/images.py``) against Pillow and the JAX package.

Tolerance: none. Every case is bit-exact against ``Image.resize`` (BOX,
BILINEAR, BICUBIC; up, down, odd sizes; modes L, LA, RGB, RGBA and P, whose
filter is NEAREST), against ``convert`` for the premultiplication and RGB,
and against ``tinyedm_tpu/data/extract_latents.py::center_crop_arr`` on the
same PNG files.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from tinyedm_tpu.data.extract_latents import center_crop_arr as jax_center_crop
from tinyedm_tpu_torch.data.images import center_crop_arr, read_image, read_png_native
from tinyedm_tpu_torch.data.resample import (
    BICUBIC,
    BILINEAR,
    BOX,
    premultiply,
    resize,
    resize_batch,
    to_rgb,
    unpremultiply,
)

PIL_FILTERS = {BOX: Image.Resampling.BOX, BILINEAR: Image.Resampling.BILINEAR, BICUBIC: Image.Resampling.BICUBIC}
MODES = ("L", "LA", "RGB", "RGBA", "P")
SIZES = [((17, 23), (8, 11)), ((31, 29), (64, 45)), ((40, 40), (40, 13)), ((9, 50), (27, 50)),
         ((128, 96), (1, 1)), ((5, 3), (200, 7))]


def _pixels(mode: str, w: int, h: int, seed: int) -> np.ndarray:
    """Structured content (gradients, a disc) plus noise; alpha with runs of
    0 and 255 beside the rest, for the premultiplied modes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    n = {"L": 1, "P": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    base = (7 * yy + 3 * xx + 90 * ((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(w, h) / 3) ** 2))[..., None]
    img = ((base + 50 * np.arange(n) + rng.integers(0, 40, (h, w, n))) % 256).astype(np.uint8)
    if mode in ("LA", "RGBA"):
        alpha = img[..., -1]
        alpha[rng.random((h, w)) < 0.2] = 0
        alpha[rng.random((h, w)) < 0.2] = 255
    return img[..., 0] if n == 1 else img


def _pil(pixels: np.ndarray, mode: str) -> Image.Image:
    if mode == "P":
        im = Image.frombytes("P", (pixels.shape[1], pixels.shape[0]), pixels.tobytes())
        im.putpalette(np.random.default_rng(0).integers(0, 256, 768, dtype=np.uint8).tobytes())
        return im
    return Image.fromarray(pixels, mode)


@pytest.mark.parametrize("filter", [BOX, BILINEAR, BICUBIC])
@pytest.mark.parametrize("mode", MODES)
def test_resize_equals_pil(mode, filter):
    for i, ((w, h), size) in enumerate(SIZES):
        pixels = _pixels(mode, w, h, seed=i)
        want = np.asarray(_pil(pixels, mode).resize(size, PIL_FILTERS[filter]))
        got = resize(pixels, mode, size, filter)
        assert got.dtype == np.uint8 and got.shape == want.shape, (mode, filter, (w, h), size)
        np.testing.assert_array_equal(got, want, err_msg=f"{mode} {filter} {(w, h)} -> {size}")


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(mode=st.sampled_from(MODES), filter=st.sampled_from([BOX, BILINEAR, BICUBIC]),
       w=st.integers(1, 70), h=st.integers(1, 70), ow=st.integers(1, 90), oh=st.integers(1, 90),
       seed=st.integers(0, 2**16))
def test_resize_equals_pil_property(mode, filter, w, h, ow, oh, seed):
    pixels = _pixels(mode, w, h, seed)
    want = np.asarray(_pil(pixels, mode).resize((ow, oh), PIL_FILTERS[filter]))
    np.testing.assert_array_equal(resize(pixels, mode, (ow, oh), filter), want)


@pytest.mark.parametrize("size", [(550, 650), (512, 605), (1100, 1300)])
def test_large_reductions_equal_pil(size):
    """The center crop's sizes: a BOX halving of 1100x1300, its BICUBIC to
    512 (the filter's support widened to 4 taps a side), and the identity."""
    pixels = _pixels("RGB", 1300, 1100, seed=3)
    for filter in (BOX, BICUBIC):
        want = np.asarray(Image.fromarray(pixels).resize(size[::-1], PIL_FILTERS[filter]))
        np.testing.assert_array_equal(resize(pixels, "RGB", size[::-1], filter), want)


@pytest.mark.parametrize("mode", ["RGBA", "LA"])
def test_premultiply_round_trip_equals_pil(mode):
    pixels = _pixels(mode, 37, 29, seed=4)
    pre = {"RGBA": "RGBa", "LA": "La"}[mode]
    im = Image.fromarray(pixels, mode).convert(pre)
    want_pre = np.asarray(im)
    if mode == "LA":  # PIL stores La as L, L, L, A; its array shows L and A
        want_pre = want_pre[..., [0, -1]] if want_pre.shape[-1] == 4 else want_pre
    np.testing.assert_array_equal(premultiply(pixels), want_pre)
    np.testing.assert_array_equal(unpremultiply(premultiply(pixels)), np.asarray(im.convert(mode)))


def test_resize_batch_equals_pil(monkeypatch):
    import tinyedm_tpu_torch.data.resample as rs

    monkeypatch.setattr(rs, "BATCH_CHUNK", 4)  # 6 images: two chunks
    rng = np.random.default_rng(5)
    for c, mode in ((1, "L"), (3, "RGB")):
        batch = rng.integers(0, 256, (6, 28, 28, c), dtype=np.uint8)
        for size in (32, 17):
            got = resize_batch(batch, size, BILINEAR)
            for img, out in zip(batch, got):
                src = img[..., 0] if c == 1 else img
                want = np.asarray(Image.fromarray(src, mode).resize((size, size), Image.Resampling.BILINEAR))
                np.testing.assert_array_equal(out[..., 0] if c == 1 else out, want)


@pytest.mark.parametrize("mode", MODES)
def test_to_rgb_equals_pil(mode):
    pixels = _pixels(mode, 13, 9, seed=6)
    im = _pil(pixels, mode)
    palette = np.asarray(im.getpalette()[:768], np.uint8).reshape(-1, 3) if mode == "P" else None
    np.testing.assert_array_equal(to_rgb(pixels, mode, palette), np.asarray(im.convert("RGB")))


def test_unread_modes_raise_naming_the_mode():
    for mode in ("I;16", "1", "CMYK", "F"):
        with pytest.raises(ValueError, match=mode.replace(";", ";")):
            resize(np.zeros((4, 4), np.uint8), mode, (2, 2), BICUBIC)
    with pytest.raises(ValueError, match="uint8"):
        resize(np.zeros((4, 4), np.uint16), "L", (2, 2), BICUBIC)
    with pytest.raises(ValueError, match="palette"):
        to_rgb(np.zeros((2, 2), np.uint8), "P")


# (mode, width, height, image_size): the BOX halvings (short side >= 2x),
# plain bicubic up and down, odd sizes
CROPS = [("RGB", 300, 140, 64), ("L", 90, 133, 64), ("RGBA", 71, 64, 64), ("LA", 257, 260, 64),
         ("P", 301, 150, 72), ("RGB", 40, 50, 64), ("RGBA", 520, 390, 96)]


@pytest.mark.parametrize("mode,w,h,image_size", CROPS)
def test_center_crop_equals_jax(mode, w, h, image_size, tmp_path):
    """The same PNG through JAX's center_crop_arr (PIL) and the port's
    (its own PNG reader in the image's mode, then resample.py)."""
    path = tmp_path / "img.png"
    pixels = _pixels("RGB" if mode == "P" else mode, w, h, seed=w)
    im = Image.fromarray(pixels).quantize(200) if mode == "P" else Image.fromarray(pixels, mode)
    im.save(path)
    with Image.open(path) as pil:
        assert pil.mode == mode
        want = jax_center_crop(pil, image_size)
    image = read_image(path)
    assert image.mode == mode
    got = center_crop_arr(image.pixels, image.mode, image_size, image.palette)
    assert got.shape == (image_size, image_size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_native_png_reader_keeps_the_mode(mode, tmp_path):
    pixels = _pixels("RGB" if mode == "P" else mode, 23, 17, seed=7)
    im = Image.fromarray(pixels).quantize(100) if mode == "P" else Image.fromarray(pixels, mode)
    im.save(tmp_path / "x.png")
    got = read_png_native(tmp_path / "x.png")
    with Image.open(tmp_path / "x.png") as pil:
        assert got.mode == pil.mode == mode
        np.testing.assert_array_equal(got.pixels, np.asarray(pil))
        if mode == "P":
            np.testing.assert_array_equal(got.palette, np.asarray(pil.getpalette(), np.uint8).reshape(-1, 3))
