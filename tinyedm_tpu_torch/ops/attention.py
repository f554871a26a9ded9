"""Flash attention on pixel-normed q, k, v: the ``use_pallas_attention`` route.

Counterpart of ``tinyedm_tpu/ops/attention.py``. ``flash_attention(q, k, v)``
takes ``(b, n, heads, hd)`` and dispatches by token count as the JAX package
does: below ``FLASH_MIN_TOKENS`` the plain softmax path ``xla_attention``, at
or above it a ``torch.autograd.Function`` whose forward and backward launch
the hand-written kernels in ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu`` on a CUDA tensor, or raise; on a CPU tensor
they run ``flash_attention_plain`` and ``flash_attention_bwd_plain``, the
kernels' math in plain PyTorch, which the tests hold against the JAX
package and ``chip_smoke.py`` holds the kernels against on the card.

The forward (``_attn_kernel``): fp32 logits ``q k^T`` times ``1/sqrt(hd)``,
the row max subtracted, ``exp``, the weights ``e / rowsum(e)`` rounded to the
input dtype, then the PV product summed in fp32 and cast.

The backward (``_attn_bwd_kernel``): p recomputed in fp32 and not rounded,
``dp = g v^T``, ``delta = rowsum(dp * p)``, ``ds = p (dp - delta) / sqrt(hd)``,
``dq = ds k`` cast to the input dtype, ``dk = ds^T q`` and ``dv = p^T g``
summed in fp32 and cast once at the end.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter

import numpy as np
import torch

from tinyedm_tpu_torch.ops._build import load_library
from tinyedm_tpu_torch.ops.mp import acc_dtype

# below this token count the plain path runs (the JAX package's
# MIN_PALLAS_TOKENS, tinyedm_tpu/ops/attention.py:128)
FLASH_MIN_TOKENS = 1024
MAX_HEAD_DIM = 256

# Kernel calls by direction and token count: ("flash_fwd", n) and
# ("flash_bwd", n). A wrapper adds one where it launches its kernel and
# nowhere else (the backward is two launches per call, counted once);
# chip_smoke.py reads these counts to show a path went through the kernels.
launch_counts: Counter = Counter()

_DTYPES = (torch.bfloat16, torch.float32)


def _scale(hd: int) -> float:
    return float(np.float32(1.0 / math.sqrt(hd)))


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The JAX package's small-n path (``_xla_attention``): fp32 logits,
    softmax, weights rounded to the input dtype, then the PV product in the
    input dtype. (b, n, heads, hd) -> (b, n, heads, hd)."""
    acc = acc_dtype(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc))
    weights = torch.softmax(logits * (1.0 / math.sqrt(q.shape[-1])), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _probabilities(q: torch.Tensor, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(e, rowsum(e)) of the forward kernel, fp32: e = exp(L - rowmax(L)),
    L = (q k^T) * scale, shape (b, heads, n, n). In place where it can be:
    at n = 4096 each (b, heads, n, n) fp32 tensor is 2 GiB per sample-head
    group."""
    acc = acc_dtype(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc))
    logits.mul_(1.0 / math.sqrt(q.shape[-1]))
    logits.sub_(logits.amax(dim=-1, keepdim=True)).exp_()
    return logits, logits.sum(dim=-1, keepdim=True)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The forward kernel's math in plain PyTorch: (b, n, heads, hd) ->
    (b, n, heads, hd)."""
    acc = acc_dtype(q.dtype)
    e, s = _probabilities(q, k)
    w = e.div_(s).to(q.dtype).to(acc)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.to(acc)).to(q.dtype)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's math in plain PyTorch: (q, k, v, g), each
    (b, n, heads, hd) -> (dq, dk, dv) in the input dtype."""
    acc = acc_dtype(q.dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qa, ka, va, ga = (t.to(acc) for t in (q, k, v, g))
    e, s = _probabilities(q, k)
    p = e.div_(s)
    dp = torch.einsum("bqhd,bkhd->bhqk", ga, va)
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = dp.sub_(delta).mul_(p).mul_(scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, ka)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qa)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, ga)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = load_library(name)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "flash_attention_fwd":
        lib.flash_attention_fwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i64, i64, i32, ctypes.c_float, ptr,
        ]
        lib.flash_attention_fwd.restype = i32
    else:
        lib.flash_attention_bwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i64, i64, i32, ctypes.c_float, ptr,
        ]
        lib.flash_attention_bwd.restype = i32
    lib.cosine_attention_error_string.argtypes = [i32]
    lib.cosine_attention_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Checks what the kernels take and returns (q, k, v, sample stride,
    token stride): the three share one layout with (heads, hd) packed, as
    contiguous tensors or the views of one (b, n, 3, heads, hd) tensor do;
    other layouts are made contiguous."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (b, n, heads, hd) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {name} on {t.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"the CUDA kernel takes q, k, v of one dtype (bf16 or fp32) on one "
                             f"device, got {name} {t.dtype} on {t.device}")
    hd = q.shape[-1]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    st = q.stride()
    if k.stride() != st or v.stride() != st or st[3] != 1 or st[2] != hd:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        st = q.stride()
    return q, k, v, st[0], st[1]


def _raise_on(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err:
        msg = lib.cosine_attention_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def flash_attention_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on ``torch.cuda.current_stream()``:
    (o (b, n, heads, hd) contiguous, fp32 row statistics (2, b, heads, n))."""
    q, k, v, sb, sn = _kernel_layout(q, k, v)
    b, n, heads, hd = q.shape
    lib = _library("flash_attention_fwd")
    out = torch.empty((b, n, heads, hd), dtype=q.dtype, device=q.device)
    stats = torch.empty((2, b, heads, n), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), stats.data_ptr(),
            b, n, heads, hd, sb, sn, int(q.dtype == torch.bfloat16), _scale(hd), stream,
        )
    _raise_on(lib, err, "flash_attention_fwd")
    launch_counts["flash_fwd", n] += 1
    return out, stats


def flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, stats: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel's two passes on
    ``torch.cuda.current_stream()``, with the forward's row statistics:
    (dq, dk, dv), each (b, n, heads, hd) contiguous."""
    q, k, v, sb, sn = _kernel_layout(q, k, v)
    b, n, heads, hd = q.shape
    if g.device != q.device or g.dtype != q.dtype or g.shape != q.shape:
        raise ValueError(f"g must be {tuple(q.shape)} {q.dtype} on {q.device}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    if stats.dtype != torch.float32 or tuple(stats.shape) != (2, b, heads, n) or \
            stats.device != q.device:
        raise ValueError(f"stats must be fp32 {(2, b, heads, n)} on {q.device}")
    g, stats = g.contiguous(), stats.contiguous()
    lib = _library("flash_attention_bwd")
    dq, dk, dv = (torch.empty((b, n, heads, hd), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), stats.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, n, heads, hd, sb, sn, int(q.dtype == torch.bfloat16), _scale(hd), stream,
        )
    _raise_on(lib, err, "flash_attention_bwd")
    launch_counts["flash_bwd", n] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``jax.custom_vjp`` of the JAX package's ``_flash_attention_kernel_path``:
    saves q, k, v and, on the card, the forward's row statistics."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if q.device.type == "cpu":
            o, stats = flash_attention_plain(q, k, v), None
        else:
            o, stats = flash_attention_fwd_cuda(q, k, v)
        ctx.save_for_backward(q, k, v, stats)
        return o

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        q, k, v, stats = ctx.saved_tensors
        if q.device.type == "cpu":
            return flash_attention_bwd_plain(q, k, v, g)
        return flash_attention_bwd_cuda(q, k, v, g, stats)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention on (b, n, heads, hd) q, k, v, scale ``1/sqrt(hd)``;
    differentiable. n < FLASH_MIN_TOKENS takes ``xla_attention``; at or
    above it a CPU tensor takes the plain versions and any other device
    launches the CUDA kernels or raises."""
    if q.shape[1] < FLASH_MIN_TOKENS:
        return xla_attention(q, k, v)
    return _FlashAttention.apply(q, k, v)
