"""The CMYK and YCCK conversion of the port's JPEG reader
(``tinyedm_tpu_torch/data/images.py``) against PIL and libjpeg, exactly.

- ``cmyk_to_rgb`` equals Pillow's ``Image.fromarray(a, "CMYK").convert("RGB")``
  (``cmyk2rgb``) on every (C, K) pair and on seeded random arrays; with
  ``adobe_inverted`` it turns the stored components of the committed CMYK
  fixture (PIL's ``CMYK;I`` reading, inverted back) into PIL's RGB decode,
  ``tests/torch_fixtures/cmyk.npy``, bit for bit.
- ``ycck_to_cmyk`` equals a line-by-line numpy transcription of libjpeg's
  ``ycck_cmyk_convert`` (its fixed-point tables) on seeded arrays: PIL
  cannot write a YCCK file, so no YCCK file is decoded here.
- ``adobe_transform`` reads the APP14 transform byte (0 in the fixture, none
  in the YCbCr fixtures, 2 in a YCCK header built here).
On the card, ``tests/test_torch_jpeg.py`` (``cuda``) and ``chip_smoke.py``
phase 30 hold nvJPEG's decode of the fixture within a mean of 1 level.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from tinyedm_tpu_torch.data.images import adobe_transform, cmyk_to_rgb, ycck_to_cmyk

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"


def _planes(a: np.ndarray):
    return [torch.from_numpy(a[..., i].astype(np.int32)) for i in range(a.shape[-1])]


def test_cmyk_to_rgb_equals_pillow_on_every_c_k_pair():
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    zero = np.zeros_like(c)
    for planes in ((c, zero, zero, k), (zero, c, zero, k), (zero, zero, c, k)):
        a = np.stack(planes, -1).astype(np.uint8)
        want = np.asarray(Image.fromarray(a, "CMYK").convert("RGB"))
        np.testing.assert_array_equal(cmyk_to_rgb(*_planes(a), adobe_inverted=False).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cmyk_to_rgb_equals_pillow_on_random_arrays(seed):
    a = np.random.default_rng(seed).integers(0, 256, (37, 53, 4)).astype(np.uint8)
    want = np.asarray(Image.fromarray(a, "CMYK").convert("RGB"))
    np.testing.assert_array_equal(cmyk_to_rgb(*_planes(a), adobe_inverted=False).numpy(), want)
    # the Adobe convention: the stored components are the inverted ones
    np.testing.assert_array_equal(cmyk_to_rgb(*_planes(255 - a), adobe_inverted=True).numpy(), want)


def test_cmyk_fixture_conversion_equals_pil_decode():
    data = (FIXTURES / "cmyk.jpg").read_bytes()
    assert adobe_transform(data) == 0
    with Image.open(FIXTURES / "cmyk.jpg") as im:
        assert im.mode == "CMYK" and im.info.get("adobe_transform") == 0
        stored = 255 - np.asarray(im)  # PIL reads 4-component JPEGs as CMYK;I
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(np.load(FIXTURES / "cmyk.npy"), want)
    np.testing.assert_array_equal(cmyk_to_rgb(*_planes(stored), adobe_inverted=True).numpy(), want)


def _libjpeg_ycck_cmyk(y, cb, cr, k):
    """libjpeg's jdcolor.c ``build_ycc_rgb_table`` and ``ycck_cmyk_convert``."""
    scalebits, one_half = 16, 1 << 15

    def fix(x):
        return int(x * (1 << scalebits) + 0.5)

    x = np.arange(256) - 128
    cr_r = (fix(1.40200) * x + one_half) >> scalebits
    cb_b = (fix(1.77200) * x + one_half) >> scalebits
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    out = np.empty(y.shape + (4,), np.int64)
    out[..., 0] = np.clip(255 - (y + cr_r[cr]), 0, 255)
    out[..., 1] = np.clip(255 - (y + ((cb_g[cb] + cr_g[cr]) >> scalebits)), 0, 255)
    out[..., 2] = np.clip(255 - (y + cb_b[cb]), 0, 255)
    out[..., 3] = k
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_ycck_to_cmyk_equals_libjpeg(seed):
    a = np.random.default_rng(seed).integers(0, 256, (41, 29, 4))
    want = _libjpeg_ycck_cmyk(*(a[..., i] for i in range(4)))
    got = np.stack([p.numpy() for p in ycck_to_cmyk(*_planes(a))], -1)
    np.testing.assert_array_equal(got, want)
    # and through PIL's CMYK conversion, as a YCCK JPEG reaches RGB in PIL
    rgb = cmyk_to_rgb(*ycck_to_cmyk(*_planes(a)), adobe_inverted=True).numpy()
    pil = Image.fromarray((255 - want).astype(np.uint8), "CMYK").convert("RGB")
    np.testing.assert_array_equal(rgb, np.asarray(pil))


def test_adobe_transform_markers():
    for name in ("rgb420", "grey", "progressive"):
        assert adobe_transform((FIXTURES / f"{name}.jpg").read_bytes()) is None
    app14 = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 2])
    header = b"\xff\xd8" + b"\xff\xee" + (len(app14) + 2).to_bytes(2, "big") + app14 + b"\xff\xda\x00\x02"
    assert adobe_transform(header) == 2
