"""Winograd F(2x2, 3x3) convolution: a stride-1 SAME 3x3 conv, NHWC.

Counterpart of ``tinyedm_tpu/ops/winograd.py`` (Lavin & Gray 2015):
    Y_tile(2x2) = A^T [ (G g G^T) o (B^T d B) ] A
with the channel contraction done as 16 component products
``M[a,b] = V[a,b] @ U[a,b]``. The public functions keep the JAX layouts: x
(B, H, W, Ci) with H and W even, w (3, 3, Ci, Co) HWIO, y (B, H, W, Co).

``transform_weights`` computes ``U = G g G^T`` in fp32 outside the kernel,
as the JAX package does. On a CUDA tensor ``winograd_conv3x3`` launches the
hand-written kernel in ``csrc/winograd_fwd.cu`` or raises; on a CPU tensor
it runs ``winograd_conv3x3_plain``, the kernel's math with its rounding
sites: U and each V[a][b] rounded to x's dtype, the B^T combinations in
fp32 (rows first, then columns), fp32 sums, the +-1 A^T folds into four fp32
planes in the JAX kernel's order, the output rounded to x's dtype. No model
calls it; it is an op of its own.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from tinyedm_tpu_torch.ops._build import load_library, raise_on_error
from tinyedm_tpu_torch.ops.mp import acc_dtype

# F(2x2, 3x3) transform matrices (exact in binary floating point)
_G = np.array([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]], dtype=np.float64)
_AT = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], dtype=np.float64)

# Kernel calls by ("winograd", H, W, Ci, Co): the wrapper adds one where it
# launches the kernel and nowhere else; chip_smoke.py reads them.
launch_counts: Counter = Counter()

_DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=None)
def _g_matrix(device: torch.device) -> torch.Tensor:
    """G on ``device``, made once: a copy from pageable host memory on every
    call would synchronize the card's stream."""
    return torch.as_tensor(_G, dtype=torch.float32, device=device)


def transform_weights(w: torch.Tensor) -> torch.Tensor:
    """U = G g G^T per channel pair: (3, 3, Ci, Co) -> (4, 4, Ci, Co) fp32."""
    g = w.to(torch.float32)
    G = _g_matrix(w.device)
    u = torch.einsum("ai,ijco->ajco", G, g)
    return torch.einsum("bj,ajco->abco", G, u)


def _bt_combos(p):
    """B^T = [[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]] along a
    4-list: 4 combinations of the inputs."""
    return [p[0] - p[2], p[1] + p[2], p[2] - p[1], p[1] - p[3]]


def _check(x: torch.Tensor, w: torch.Tensor) -> tuple[int, int, int, int, int]:
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, Ci), got {tuple(x.shape)}")
    b, h, wd, ci = x.shape
    if h % 2 or wd % 2:
        raise ValueError(f"F(2x2,3x3) needs even H and W, got {h}x{wd}")
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, ci):
        raise ValueError(f"w must be (3, 3, {ci}, Co), got {tuple(w.shape)}")
    return b, h, wd, ci, w.shape[-1]


def winograd_conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's math in plain PyTorch: (B, H, W, Ci) -> (B, H, W, Co)."""
    b, h, wd, ci, co = _check(x, w)
    dt, acc = x.dtype, acc_dtype(x.dtype)
    u = transform_weights(w).to(dt).reshape(16, ci, co).to(acc)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    th, tw = h // 2, wd // 2

    def plane(i, j):  # P[i][j][r, s] = xp[2r + i, 2s + j]
        return xp[:, i:i + 2 * th - 1:2, j:j + 2 * tw - 1:2, :].to(acc)

    # rows first: t[a][j] = sum_i B^T[a, i] P[i][j]
    t = [[None] * 4 for _ in range(4)]
    for j in range(4):
        for a, combo in enumerate(_bt_combos([plane(i, j) for i in range(4)])):
            t[a][j] = combo
    planes = [torch.zeros((b, th, tw, co), dtype=acc, device=x.device) for _ in range(4)]
    for a in range(4):
        for bb, v in enumerate(_bt_combos(t[a])):
            v = v.to(dt).to(acc).reshape(-1, ci)
            m = torch.matmul(v, u[a * 4 + bb]).reshape(b, th, tw, co)
            for p in range(2):
                for q in range(2):
                    coef = _AT[p, a] * _AT[q, bb]
                    if coef == 1.0:
                        planes[p * 2 + q] += m
                    elif coef == -1.0:
                        planes[p * 2 + q] -= m
    y = torch.empty((b, h, wd, co), dtype=dt, device=x.device)
    for p in range(2):
        for q in range(2):
            y[:, p::2, q::2, :] = planes[p * 2 + q].to(dt)
    return y


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("winograd_fwd")
    lib.winograd_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.winograd_fwd.restype = ctypes.c_int
    return lib


def winograd_conv3x3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on ``torch.cuda.current_stream()``; U is transformed
    here, in plain PyTorch, as the JAX package does outside its kernel:
    (16, Ci, Co), rounded to x's dtype, contiguous."""
    b, h, wd, ci, co = _check(x, w)
    if not x.is_cuda or w.device != x.device:
        raise ValueError(f"the CUDA kernel needs x and w on one CUDA device, got {x.device}, {w.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernel takes bf16 or fp32, got {x.dtype}")
    x = x.contiguous()
    u = transform_weights(w).to(x.dtype).reshape(16, ci, co).contiguous()
    lib = _library()
    y = torch.empty((b, h, wd, co), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.winograd_fwd(x.data_ptr(), u.data_ptr(), y.data_ptr(), b, h, wd, ci, co,
                               int(x.dtype == torch.bfloat16), stream)
    raise_on_error(lib, err, "winograd_fwd")
    launch_counts["winograd", h, wd, ci, co] += 1
    return y


def winograd_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv by Winograd F(2x2,3x3): x (B, H, W, Ci) with H
    and W even, w (3, 3, Ci, Co) -> (B, H, W, Co) in x's dtype. A CPU tensor
    takes the plain version; any other device launches the CUDA kernel or
    raises."""
    if x.device.type == "cpu":
        return winograd_conv3x3_plain(x, w)
    return winograd_conv3x3_cuda(x, w)
