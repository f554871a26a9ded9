"""Reading an image folder for latent extraction.

Counterpart of the host side of ``tinyedm_tpu/data/extract_latents.py``:
``list_image_folder`` (torchvision ImageFolder semantics, ``:53-65``) and
``center_crop_arr`` (the ADM center crop, ``:32-50``) on ``resample.py``,
PIL's resampler repeated in numpy. The machine with the card has no PIL, so
the files are decoded here:

- PNG with zlib (``read_png_native``): 8-bit, non-interlaced grey, grey +
  alpha, RGB, RGBA or palette, in the image's own mode (``L``, ``LA``,
  ``RGB``, ``RGBA``, ``P`` with its palette), since the crop resizes before
  it converts to RGB, as PIL does;
- JPEG with nvJPEG on the card (``JpegDecoder``, ``csrc/nvjpeg_decode.cu``,
  built at the first JPEG): nvJPEG's Y, Cb and Cr planes, then libjpeg's
  chroma upsampling and YCbCr conversion in torch on the card, so that only
  the IDCT's rounding differs from PIL; grey JPEGs come back as RGB. A
  4-component JPEG comes back as nvJPEG's four stored components, which
  PIL's conversion turns into RGB (``cmyk_to_rgb``, after ``ycck_to_cmyk``
  for an Adobe YCCK file). A JPEG of another component count, or one nvJPEG
  rejects, raises naming the file; on the CPU a JPEG raises, with no
  fallback decoder.

The format is read from the file's first bytes, not its suffix. Any other
file raises naming it: none is skipped silently.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tinyedm_tpu_torch.data.resample import BICUBIC, BOX, resize, to_rgb

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
_PNG_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}  # PNG color type -> PIL mode
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG color type -> samples per pixel
# nvjpegStatus_t (nvjpeg.h)
_NVJPEG_STATUS = {1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG", 4: "JPEG_NOT_SUPPORTED",
                  5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED", 7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR",
                  9: "IMPLEMENTATION_NOT_SUPPORTED", 10: "INCOMPLETE_BITSTREAM"}


@dataclasses.dataclass
class Decoded:
    """An image's samples in its own mode: HW (``L``, ``P``) or HWC uint8,
    and the (entries, 3) palette of a ``P`` image."""

    pixels: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth), with uint8
    wrap-around; returns (h, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zero row above the image
    for y in range(h):
        ftype, line, prev = rows[y, 0], rows[y, 1:], out[y]
        if ftype == 0:
            out[y + 1] = line
        elif ftype == 1:
            out[y + 1] = line.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            out[y + 1] = line + prev
        elif ftype in (3, 4):
            cur, up = bytearray(line.tobytes()), prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            out[y + 1] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG row filter {ftype}")
    return out[1:]


def read_png_native(path: str | Path) -> Decoded:
    """The samples of an 8-bit, non-interlaced PNG (grey, grey + alpha, RGB,
    RGBA or palette) in the mode PIL opens it in. Any other file raises
    ``ValueError`` naming it."""
    path = Path(path)
    data = path.read_bytes()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _CHANNELS or (color == 3 and palette is None):
        raise ValueError(
            f"{path}: only 8-bit, non-interlaced grey, grey+alpha, RGB, RGBA and palette PNGs are read "
            f"(bit depth {depth}, color type {color}, interlace {interlace})"
        )
    ch = _CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    if len(raw) != h * (w * ch + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, expected {h * (w * ch + 1)}")
    try:
        pixels = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if color == 3 and int(pixels.max(initial=0)) >= len(palette):
        raise ValueError(f"{path}: palette index past the {len(palette)}-entry palette")
    return Decoded(pixels[..., 0] if ch == 1 else pixels, _PNG_MODES[color], palette if color == 3 else None)


# nvjpegChromaSubsampling_t -> the chroma planes' (horizontal, vertical)
# subsampling factors
_CSS_FACTORS = {0: (1, 1), 1: (2, 1), 2: (2, 2), 3: (1, 2), 4: (4, 1), 5: (4, 2)}


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)  # libjpeg's FIX() at SCALEBITS 16


def upsample_chroma(c: torch.Tensor, fh: int, fv: int, height: int, width: int) -> torch.Tensor:
    """libjpeg(-turbo)'s ``jdsample.c`` on one chroma plane (int32, any
    device): "fancy" triangle upsampling for 2x horizontal (planes wider than
    2 samples), 2x vertical and both (3/4 of the nearer sample, 1/4 of the
    next, edges repeated, libjpeg's rounding biases), sample repetition for
    the other integer factors; cropped to (height, width)."""
    h2 = fh == 2 and c.shape[1] > 2  # libjpeg's fancy cases: h2v1 and h2v2 wider than 2 samples, h1v2
    v2 = fv == 2 and (fh == 1 or h2)
    if v2:  # the nearer row thrice plus the next one: upper then lower output row
        above, below = torch.cat([c[:1], c[:-1]]), torch.cat([c[1:], c[-1:]])
        rows = torch.stack([3 * c + above, 3 * c + below], 1).reshape(-1, c.shape[1])
        if not h2:  # h1v2: biases 1 (upper) and 2 (lower), / 4
            bias = torch.tensor([1, 2], dtype=c.dtype, device=c.device).repeat(c.shape[0])[:, None]
            return ((rows + bias) >> 2)[:height, :width]
        c = rows
    if h2:
        left, right = torch.cat([c[:, :1], c[:, :-1]], 1), torch.cat([c[:, 1:], c[:, -1:]], 1)
        if v2:  # h2v2 on the column sums: (3 this + other + 8 or 7) / 16
            out = torch.stack([(3 * c + left + 8) >> 4, (3 * c + right + 7) >> 4], 2)
        else:  # h2v1: (3 this + other + 1 or 2) / 4
            out = torch.stack([(3 * c + left + 1) >> 2, (3 * c + right + 2) >> 2], 2)
        return out.reshape(c.shape[0], -1)[:height, :width]
    return c.repeat_interleave(fv, 0).repeat_interleave(fh, 1)[:height, :width]


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """libjpeg's ``ycc_rgb_convert`` (JFIF YCbCr, 16-bit fixed-point tables)
    on int32 planes of one size; returns (H, W, 3) uint8."""
    cb, cr = cb - 128, cr - 128
    r = y + ((_fix(1.40200) * cr + 32768) >> 16)
    g = y + ((-_fix(0.34414) * cb - _fix(0.71414) * cr + 32768) >> 16)
    b = y + ((_fix(1.77200) * cb + 32768) >> 16)
    return torch.stack([r, g, b], -1).clamp_(0, 255).to(torch.uint8)


def cmyk_to_rgb(c: torch.Tensor, m: torch.Tensor, y: torch.Tensor, k: torch.Tensor,
                adobe_inverted: bool) -> torch.Tensor:
    """PIL's CMYK -> RGB on int planes of one size (any device): Pillow's
    ``cmyk2rgb`` (``libImaging/Convert.c``, as in Pillow 12),
    ``R = MULDIV255(255 - C, 255 - K)`` with its rounding. ``adobe_inverted``
    takes the planes as a JPEG stores them under the Adobe convention,
    which PIL's JPEG reader assumes for every 4-component JPEG (raw mode
    ``CMYK;I``: each component inverted first). Returns (H, W, 3) uint8."""
    planes = [p.int() for p in (c, m, y, k)]
    if adobe_inverted:
        planes = [255 - p for p in planes]
    nk = 255 - planes[3]
    out = []
    for p in planes[:3]:
        t = (255 - p) * nk + 128
        out.append((t + (t >> 8)) >> 8)
    return torch.stack(out, -1).to(torch.uint8)


def ycck_to_cmyk(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                 k: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """libjpeg's ``ycck_cmyk_convert`` on int planes of one size: R, G and
    B from Y, Cb and Cr with the YCbCr tables (``ycbcr_to_rgb``), inverted;
    K kept. Returns the four planes as a CMYK JPEG would store them, for
    ``cmyk_to_rgb(..., adobe_inverted=True)``."""
    rgb = ycbcr_to_rgb(y.int(), cb.int(), cr.int()).int()
    return (*(255 - rgb).unbind(-1), k.int())


def adobe_transform(data: bytes) -> Optional[int]:
    """The transform byte of a JPEG's Adobe APP14 segment (0: CMYK or RGB
    stored as is, 1: YCbCr, 2: YCCK), or None without one; the markers
    before the first scan are read."""
    i = 2
    while i + 4 <= len(data) and data[i] == 0xFF:
        marker = data[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if marker == 0xDA:  # start of scan
            break
        length = struct.unpack(">H", data[i + 2:i + 4])[0]
        segment = data[i + 4:i + 2 + length]
        if marker == 0xEE and segment.startswith(b"Adobe") and len(segment) >= 12:
            return segment[11]
        i += 2 + length
    return None


class JpegDecoder:
    """nvJPEG on one CUDA device, on a stream of its own (so that decoding
    overlaps the work on the current stream): the planes from nvJPEG, the
    chroma upsampling and RGB conversion as libjpeg does them
    (``upsample_chroma``, ``ycbcr_to_rgb``), and for a 4-component JPEG
    PIL's conversion of its stored components (``ycck_to_cmyk`` where the
    Adobe transform is 2, then ``cmyk_to_rgb``). Thread-safe: one lock around
    each decode, whose Huffman stage runs on the host. ``close`` frees the
    decoder."""

    def __init__(self, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"nvJPEG decodes on a CUDA device, not {self.device}")
        from tinyedm_tpu_torch.ops._build import load_library

        lib = load_library("nvjpeg_decode")
        lib.tinyedm_jpeg_create.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        lib.tinyedm_jpeg_destroy.argtypes = [ctypes.c_void_p]
        lib.tinyedm_jpeg_destroy.restype = None
        lib.tinyedm_jpeg_info.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t] + [
            ctypes.POINTER(ctypes.c_int)] * 4
        lib.tinyedm_jpeg_decode_planes.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t] + [
            ctypes.c_void_p, ctypes.c_int] * 4 + [ctypes.c_void_p]
        self._lib = lib
        handle = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            self._check(lib.tinyedm_jpeg_create(ctypes.byref(handle)), "nvJPEG", "create a decoder for")
        self._handle = handle
        self._lock = threading.Lock()
        self._stream = torch.cuda.Stream(device=self.device)

    def close(self) -> None:
        with self._lock:
            if self._handle:
                self._lib.tinyedm_jpeg_destroy(self._handle)
                self._handle = None

    def _check(self, err: int, path, what: str) -> None:
        if err < 0:
            status = _NVJPEG_STATUS.get(-err, str(-err))
            raise ValueError(f"{path}: nvJPEG cannot {what} this JPEG (NVJPEG_STATUS_{status})")
        if err > 0:
            raise RuntimeError(f"{path}: JPEG decode failed: {self._lib.tinyedm_error_string(err).decode()} ({err})")

    def decode(self, data: bytes, path: Path) -> np.ndarray:
        """(H, W, 3) uint8 RGB of the JPEG ``data`` (read from ``path``)."""
        comps, css = ctypes.c_int(), ctypes.c_int()
        widths, heights = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
        with self._lock, torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            if not self._handle:
                raise ValueError("the JPEG decoder is closed")
            self._check(self._lib.tinyedm_jpeg_info(self._handle, data, len(data), ctypes.byref(comps),
                                                    ctypes.byref(css), widths, heights), path, "read")
            n = comps.value
            if n not in (1, 3, 4) or (n == 3 and css.value not in _CSS_FACTORS):
                raise ValueError(f"{path}: a JPEG of {n} components (subsampling {css.value}) is not decoded; "
                                 "grey, YCbCr, CMYK and YCCK JPEGs are")
            planes = [torch.empty((max(heights[i], 1), max(widths[i], 1)), dtype=torch.uint8, device=self.device)
                      for i in range(max(n, 3))]
            args = [a for p in planes for a in (p.data_ptr(), p.shape[1])] + [None, 0] * (4 - len(planes))
            self._check(self._lib.tinyedm_jpeg_decode_planes(self._handle, data, len(data), *args,
                                                             self._stream.cuda_stream), path, "decode")
            y = planes[0].int()
            if n == 1:
                rgb = planes[0][..., None].expand(-1, -1, 3)
            elif n == 3:
                fh, fv = _CSS_FACTORS[css.value]
                cb, cr = (upsample_chroma(p.int(), fh, fv, *y.shape) for p in planes[1:])
                rgb = ycbcr_to_rgb(y, cb, cr)
            else:
                full = [y] + [self._upsampled(p, *y.shape) for p in planes[1:]]
                if adobe_transform(data) == 2:
                    full = ycck_to_cmyk(*full)
                rgb = cmyk_to_rgb(*full, adobe_inverted=True)
            pixels = rgb.cpu().numpy()  # on this stream: waits for this decode alone
        return np.ascontiguousarray(pixels)

    @staticmethod
    def _upsampled(plane: torch.Tensor, height: int, width: int) -> torch.Tensor:
        """A component of a 4-component JPEG at full size: its sampling
        factors from its size against the first component's."""
        fh, fv = round(width / plane.shape[1]), round(height / plane.shape[0])
        if (fh, fv) == (1, 1):
            return plane.int()
        return upsample_chroma(plane.int(), fh, fv, height, width)


def read_image(path: str | Path, jpeg: Optional[JpegDecoder] = None) -> Decoded:
    """A PNG in its own mode, or a JPEG as RGB through ``jpeg`` (nvJPEG on
    the card). A JPEG without a decoder, or any other format, raises
    ``ValueError`` naming the file."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        return read_png_native(path)
    if head.startswith(JPEG_SIGNATURE):
        if jpeg is None:
            raise ValueError(f"{path}: a JPEG, and this run has no JPEG decoder (JPEGs are decoded with nvJPEG "
                             "on a CUDA device; there is no CPU decoder)")
        return Decoded(jpeg.decode(path.read_bytes(), path), "RGB")
    raise ValueError(f"{path}: not a PNG or JPEG file (only those two are read)")


def list_image_folder(data_dir: str | Path) -> tuple[list[Path], list[int], list[str]]:
    """torchvision ImageFolder semantics: one class per subdirectory, both
    sorted; the files with an image suffix, recursively."""
    data_dir = Path(data_dir)
    classes = sorted(d.name for d in data_dir.iterdir() if d.is_dir() and not d.name.startswith("."))
    files: list[Path] = []
    labels: list[int] = []
    for ci, cls in enumerate(classes):
        for p in sorted((data_dir / cls).rglob("*")):
            if p.suffix.lower() in IMG_EXTENSIONS:
                files.append(p)
                labels.append(ci)
    return files, labels, classes


def center_crop_arr(pixels: np.ndarray, mode: str, image_size: int,
                    palette: Optional[np.ndarray] = None) -> np.ndarray:
    """The ADM center crop: halve with BOX (``x // 2`` sides) while the short
    side is at least twice ``image_size``, resize with BICUBIC so that it
    equals ``image_size`` (sides ``round(x * scale)``), convert to RGB, crop
    the center. Returns (image_size, image_size, 3) uint8."""
    h, w = pixels.shape[:2]
    while min(w, h) >= 2 * image_size:
        w, h = w // 2, h // 2
        pixels = resize(pixels, mode, (w, h), BOX)
    scale = image_size / min(w, h)
    w, h = round(w * scale), round(h * scale)
    arr = to_rgb(resize(pixels, mode, (w, h), BICUBIC), mode, palette)
    y0, x0 = (h - image_size) // 2, (w - image_size) // 2
    return arr[y0 : y0 + image_size, x0 : x0 + image_size]
