"""Fused pixel-norm + cosine attention on a ``(b, tokens, 3C)`` qkv tensor.

Counterpart of ``tinyedm_tpu/ops/fused_attention.py::cosine_attention_qkv``
(forward only). On a CUDA tensor it launches the hand-written kernel in
``csrc/cosine_attention_fwd.cu`` or raises; on a CPU tensor it runs
``cosine_attention_qkv_plain``, the same math in plain PyTorch, which the
tests hold against the JAX package and ``chip_smoke.py`` holds the kernel
against on the card.

The math (``_attn_fwd_kernel`` in the JAX package), per head: pixel-norm q, k
and v over the head dim (fp32 norm, divisor cast to the input dtype), fp32
logits ``q^ k^T / sqrt(hd)``, ``E = exp(logits)`` with no max subtraction
(cosine logits are bounded by ``1/sqrt(hd)``), and deferred normalization
``(dtype(E) @ v^) / rowsum(E)``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter

import numpy as np
import torch

from tinyedm_tpu_torch.ops._build import load_library
from tinyedm_tpu_torch.ops.mp import pixel_norm

# Largest token count the fused path takes (the JAX package's bound). The
# CUDA kernel has no such limit of its own; above it the model runs the
# unfused path, as in the JAX package.
MAX_FUSED_TOKENS = 512
MAX_HEAD_DIM = 256

# Kernel launches by token count n. The wrapper adds one where it launches
# the kernel and nowhere else; chip_smoke.py reads these counts to show the
# main path went through the kernel.
launch_counts: Counter = Counter()

_KERNEL = "cosine_attention_fwd"
_DTYPES = (torch.bfloat16, torch.float32)


def _split_heads(qkv: torch.Tensor, num_heads: int) -> tuple[int, int, int, int]:
    if qkv.ndim != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (b, n, 3C), got {tuple(qkv.shape)}")
    b, n, c3 = qkv.shape
    c = c3 // 3
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"channels {c} not divisible by num_heads {num_heads}")
    return b, n, c, c // num_heads


def cosine_logits(qkv: torch.Tensor, num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(b, n, 3C) -> (v^, logits): the pixel-normed values (b, heads, n, hd)
    in the input dtype and the fp32 logits ``q^ k^T / sqrt(hd)``, (b, heads, n, n)."""
    b, n, c, hd = _split_heads(qkv, num_heads)
    x = pixel_norm(qkv.reshape(b, n, 3, num_heads, hd), dim=-1)
    q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    return v, logits


def cosine_attention_qkv_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The kernel's math in plain PyTorch: (b, n, 3C) -> (b, n, C)."""
    b, n, c3 = qkv.shape
    v, logits = cosine_logits(qkv, num_heads)
    e = torch.exp(logits)
    s = e.sum(dim=-1, keepdim=True)
    out = torch.matmul(e.to(qkv.dtype).float(), v.float()) / s
    return out.to(qkv.dtype).transpose(1, 2).reshape(b, n, c3 // 3)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    fn = lib.cosine_attention_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.cosine_attention_error_string.argtypes = [ctypes.c_int]
    lib.cosine_attention_error_string.restype = ctypes.c_char_p
    return lib


def cosine_attention_qkv_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``."""
    b, n, c, hd = _split_heads(qkv, num_heads)
    if not qkv.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on {qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernel takes bf16 or fp32, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("the CUDA kernel needs a contiguous qkv tensor")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    lib = _library()
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    scale = float(np.float32(1.0 / math.sqrt(hd)))
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = lib.cosine_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), b, n, num_heads, hd,
            int(qkv.dtype == torch.bfloat16), scale, stream,
        )
    if err:
        msg = lib.cosine_attention_error_string(err).decode()
        raise RuntimeError(f"cosine_attention_fwd launch failed: {msg} ({err})")
    launch_counts[n] += 1
    return out


def cosine_attention_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Fused pixel-norm + cosine attention: (b, n, 3C) -> (b, n, C), qkv
    channels ordered (3, heads, hd), output channels (heads, hd).

    A CPU tensor takes the plain version; any other device launches the
    CUDA kernel or raises."""
    if qkv.device.type == "cpu":
        return cosine_attention_qkv_plain(qkv, num_heads)
    return cosine_attention_qkv_cuda(qkv, num_heads)
