"""The ``.safetensors`` format, read and written by hand (the machine with
the card has no ``safetensors`` package).

A file is an 8-byte little-endian header length N, N bytes of JSON that map
each tensor's name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets into the data that follows; an optional ``__metadata__`` entry maps
strings to strings), then the tensors' raw little-endian bytes, back to back
(read as the host's byte order: little-endian hosts only).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Mapping, Optional

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 2**20


def load_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU. A malformed file
    raises ``ValueError`` naming it."""
    path = Path(path)
    data = bytearray(path.stat().st_size)  # writable, as torch.frombuffer wants
    with open(path, "rb") as f:
        f.readinto(data)
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", data[:8])
    if n > _MAX_HEADER or 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} does not fit the {len(data)}-byte file")
    try:
        header = json.loads(data[8 : 8 + n])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: bad safetensors header ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the safetensors header is not a JSON object")
    buf = memoryview(data)[8 + n :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = DTYPES[info["dtype"]]
            shape = [int(s) for s in info["shape"]]
            begin, end = (int(o) for o in info["data_offsets"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: bad entry for {name!r} ({e!r})") from None
        count = 1
        for s in shape:
            count *= s
        if not 0 <= begin <= end <= len(buf) or end - begin != count * dtype.itemsize:
            raise ValueError(f"{path}: {name!r} spans bytes [{begin}, {end}) of {len(buf)}, "
                             f"expected {count} x {dtype.itemsize}")
        flat = torch.frombuffer(buf[begin:end], dtype=dtype) if count else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(shape).clone()
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str | Path,
                     metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (any device; stored contiguous, in name order) as a
    ``.safetensors`` file, the header padded with spaces to 8 bytes."""
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)
