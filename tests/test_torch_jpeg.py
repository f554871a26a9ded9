"""The JPEG reader's arithmetic beside nvJPEG (``tinyedm_tpu_torch/data/images.py``):
libjpeg's chroma upsampling and YCbCr conversion, which turn nvJPEG's
planes into the RGB that PIL gives.

- ``ycbcr_to_rgb`` equals PIL exactly on the committed fixtures: PIL's own
  YCbCr output (``draft("YCbCr")``, libjpeg's upsampled planes) converted by
  the port equals PIL's RGB decode bit for bit.
- ``upsample_chroma`` (vectorized torch) equals a line-by-line transcription
  of libjpeg-turbo's ``jdsample.c`` loops (h2v1 and h2v2 "fancy", h1v2,
  repetition for other factors and for planes 2 samples wide), exactly.
- On the card (``cuda`` marker; ``chip_smoke.py`` phase 30 runs the same
  check there): nvJPEG's decode of each fixture within a mean of 1 level of
  PIL's (``tests/torch_fixtures/*.npy``, from
  ``experiments/make_torch_jpeg_fixtures.py``), the CMYK one through
  nvJPEG's four stored components and PIL's conversion
  (``tests/test_torch_cmyk.py`` holds the conversion exactly on the CPU); a
  JPEG whose SOF says 2 components raises naming the file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from tinyedm_tpu_torch.data.images import read_image, upsample_chroma, ycbcr_to_rgb

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"


def two_component_jpeg(data: bytes) -> bytes:
    """``data`` with the component count of its SOF segment set to 2."""
    i = 2
    while data[i + 1] not in (0xC0, 0xC1, 0xC2):
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    nf = i + 9  # marker (2), length (2), precision (1), height (2), width (2)
    return data[:nf] + bytes([2]) + data[nf + 1:]
READ = ("rgb420", "rgb422", "rgb444", "grey", "progressive", "cmyk")


@pytest.mark.parametrize("name", ["rgb420", "rgb422", "rgb444", "progressive"])
def test_ycbcr_to_rgb_equals_pil(name):
    with Image.open(FIXTURES / f"{name}.jpg") as im:
        im.draft("YCbCr", im.size)
        assert im.mode == "YCbCr"
        ycc = torch.from_numpy(np.asarray(im).astype(np.int32))
    with Image.open(FIXTURES / f"{name}.jpg") as im:
        want = np.asarray(im.convert("RGB"))
    got = ycbcr_to_rgb(ycc[..., 0], ycc[..., 1], ycc[..., 2]).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(np.load(FIXTURES / f"{name}.npy"), want)  # the committed reference is PIL's decode


def _libjpeg(c: np.ndarray, fh: int, fv: int, height: int, width: int) -> np.ndarray:
    """jdsample.c's loops, one sample at a time (libjpeg-turbo): context
    rows above the first and below the last row repeat them."""
    ch, cw = c.shape
    c = c.astype(np.int64)
    rows = []
    if fh == 2 and fv == 1 and cw > 2:  # h2v1_fancy_upsample
        for r in range(ch):
            row, out = c[r], [int(c[r, 0]), int((c[r, 0] * 3 + c[r, 1] + 2) >> 2)]
            for j in range(1, cw - 1):
                v = row[j] * 3
                out += [int((v + row[j - 1] + 1) >> 2), int((v + row[j + 1] + 2) >> 2)]
            out += [int((row[cw - 1] * 3 + row[cw - 2] + 1) >> 2), int(row[cw - 1])]
            rows.append(out)
    elif fh == 2 and fv == 2 and cw > 2:  # h2v2_fancy_upsample
        for r in range(ch):
            for v in (0, 1):
                near, far = c[r], c[max(r - 1, 0)] if v == 0 else c[min(r + 1, ch - 1)]
                this, nxt = near[0] * 3 + far[0], near[1] * 3 + far[1]
                out = [int((this * 4 + 8) >> 4), int((this * 3 + nxt + 7) >> 4)]
                last, this = this, nxt
                for j in range(2, cw):
                    nxt = near[j] * 3 + far[j]
                    out += [int((this * 3 + last + 8) >> 4), int((this * 3 + nxt + 7) >> 4)]
                    last, this = this, nxt
                out += [int((this * 3 + last + 8) >> 4), int((this * 4 + 7) >> 4)]
                rows.append(out)
    elif fh == 1 and fv == 2:  # h1v2_fancy_upsample
        for r in range(ch):
            for v, bias in ((0, 1), (1, 2)):
                far = c[max(r - 1, 0)] if v == 0 else c[min(r + 1, ch - 1)]
                rows.append([int((c[r, j] * 3 + far[j] + bias) >> 2) for j in range(cw)])
    else:  # int_upsample, h2v1_upsample, h2v2_upsample: repetition
        for r in range(ch):
            out = [int(c[r, j]) for j in range(cw) for _ in range(fh)]
            rows += [out] * fv
    return np.asarray(rows)[:height, :width]


@pytest.mark.parametrize("fh,fv", [(2, 1), (2, 2), (1, 2), (4, 1), (4, 2), (1, 1)])
def test_upsample_chroma_equals_libjpeg_loops(fh, fv):
    rng = np.random.default_rng(fh * 10 + fv)
    for ch, cw in ((1, 1), (2, 2), (3, 3), (9, 17), (23, 34), (5, 2)):
        c = rng.integers(0, 256, (ch, cw))
        height, width = ch * fv - (ch > 1 and fv > 1), cw * fh - (cw > 1 and fh > 1)  # odd image sides too
        got = upsample_chroma(torch.from_numpy(c.astype(np.int32)), fh, fv, height, width).numpy()
        np.testing.assert_array_equal(got, _libjpeg(c, fh, fv, height, width), err_msg=f"{(ch, cw)}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", READ)
def test_nvjpeg_matches_pil(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: nvJPEG decodes on the card")
    from tinyedm_tpu_torch.data.images import JpegDecoder

    dec = JpegDecoder("cuda")
    try:
        got = read_image(FIXTURES / f"{name}.jpg", dec).pixels
        bad = tmp_path / "two_components.jpg"
        bad.write_bytes(two_component_jpeg((FIXTURES / "rgb444.jpg").read_bytes()))
        with pytest.raises(ValueError, match="two_components.jpg"):
            read_image(bad, dec)
    finally:
        dec.close()
    want = np.load(FIXTURES / f"{name}.npy")
    assert got.shape == want.shape and np.abs(got.astype(int) - want).mean() <= 1.0
