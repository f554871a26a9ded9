"""Fused pixel-norm + cosine attention on a ``(b, tokens, 3C)`` qkv tensor.

Counterpart of ``tinyedm_tpu/ops/fused_attention.py::cosine_attention_qkv``
and its custom VJP. On a CUDA tensor the forward launches the hand-written
kernel in ``csrc/cosine_attention_fwd.cu`` and the backward the one in
``csrc/cosine_attention_bwd.cu``, or they raise; on a CPU tensor they run
``cosine_attention_qkv_plain`` and ``cosine_attention_qkv_bwd_plain``, the
same math in plain PyTorch, which the tests hold against the JAX package and
``chip_smoke.py`` holds the kernels against on the card.

The forward (``_attn_fwd_kernel`` in the JAX package), per head: pixel-norm
q, k and v over the head dim (fp32 norm, divisor cast to the input dtype),
fp32 logits ``q^ k^T / sqrt(hd)``, ``E = exp(logits)`` with no max
subtraction (cosine logits are bounded by ``1/sqrt(hd)``), and deferred
normalization ``(dtype(E) @ v^) / rowsum(E)``.

The backward (``_attn_bwd_kernel``) recomputes E and, with
``rc = (1/sqrt(hd)) / rowsum(E)`` and ``delta = rowsum(g * o)`` from the
forward's own rounded output o, takes the deferred-normalization VJP
    dV^ = dtype(E)^T dtype(g * rc * sqrt(hd))
    dQ^ = (ds k^) * rc,   dK^ = ds^T dtype(q^ * rc),
    ds  = dtype(E * (g v^T - delta))
(fp32 sums) and then the pixel-norm VJP of each of q, k and v in fp32, with
the fp32 divisor UNROUNDED (unlike ``ops/mp.py``'s VJP, which uses the
divisor rounded to the input dtype).

In fp64 (the gradient check) both directions compute in fp64 and every
rounding site is exact.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter

import numpy as np
import torch

from tinyedm_tpu_torch.ops._build import load_library
from tinyedm_tpu_torch.ops.mp import acc_dtype, pixel_norm

# Largest token count the fused path takes (the JAX package's bound). The
# CUDA kernels have no such limit of their own; above it the model runs the
# unfused path, as in the JAX package.
MAX_FUSED_TOKENS = 512
MAX_HEAD_DIM = 256
EPS = 1e-4  # pixel-norm epsilon

# Kernel calls by direction and token count: ("fwd", n) and ("bwd", n). A
# wrapper adds one where it launches its kernel and nowhere else (the
# backward is two launches per call, counted once); chip_smoke.py reads these
# counts to show the main path went through the kernels.
launch_counts: Counter = Counter()

_DTYPES = (torch.bfloat16, torch.float32)


def _split_heads(qkv: torch.Tensor, num_heads: int) -> tuple[int, int, int, int]:
    if qkv.ndim != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (b, n, 3C), got {tuple(qkv.shape)}")
    b, n, c3 = qkv.shape
    c = c3 // 3
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"channels {c} not divisible by num_heads {num_heads}")
    return b, n, c, c // num_heads


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(b, n, heads * hd) -> (b, heads, n, hd)."""
    b, n, c = t.shape
    return t.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def cosine_logits(qkv: torch.Tensor, num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(b, n, 3C) -> (v^, logits): the pixel-normed values (b, heads, n, hd)
    in the input dtype and the fp32 logits ``q^ k^T / sqrt(hd)``, (b, heads, n, n)."""
    b, n, c, hd = _split_heads(qkv, num_heads)
    acc = acc_dtype(qkv.dtype)
    x = pixel_norm(qkv.reshape(b, n, 3, num_heads, hd), dim=-1)
    q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    return v, logits


def cosine_attention_qkv_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The forward kernel's math in plain PyTorch: (b, n, 3C) -> (b, n, C)."""
    b, n, c3 = qkv.shape
    acc = acc_dtype(qkv.dtype)
    v, logits = cosine_logits(qkv, num_heads)
    e = torch.exp(logits)
    s = e.sum(dim=-1, keepdim=True)
    out = torch.matmul(e.to(qkv.dtype).to(acc), v.to(acc)) / s
    return out.to(qkv.dtype).transpose(1, 2).reshape(b, n, c3 // 3)


def _norm_head(x: torch.Tensor, hd: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pixel norm over the last dim, as the kernels take it: (normalized in
    x.dtype, fp32 norm s, fp32 divisor D = eps + s / sqrt(hd))."""
    xa = x.to(acc_dtype(x.dtype))
    s = torch.sqrt(torch.sum(xa * xa, dim=-1, keepdim=True))
    d = EPS + s * (1.0 / math.sqrt(hd))
    return x / d.to(x.dtype), s, d


def _pixel_norm_vjp(x: torch.Tensor, s: torch.Tensor, d: torch.Tensor, gy: torch.Tensor,
                    hd: int) -> torch.Tensor:
    """``tinyedm_tpu/ops/fused_attention.py::_pixel_norm_bwd``: the VJP of
    ``x / dtype(D)`` in fp32 with the UNROUNDED divisor D."""
    xa = x.to(d.dtype)
    inner = torch.sum(gy * xa, dim=-1, keepdim=True)
    return gy / d - xa * (inner / (d * d * torch.clamp(s, min=1e-30) / (1.0 / math.sqrt(hd))))


def cosine_attention_qkv_bwd_plain(qkv: torch.Tensor, g: torch.Tensor, o: torch.Tensor,
                                   num_heads: int) -> torch.Tensor:
    """The backward kernel's math in plain PyTorch, step by step with its
    rounding sites: (qkv (b, n, 3C), g (b, n, C), o (b, n, C)) -> d(qkv)."""
    b, n, c, hd = _split_heads(qkv, num_heads)
    dt, acc = qkv.dtype, acc_dtype(qkv.dtype)
    scale = 1.0 / math.sqrt(hd)
    q, k, v = (_heads(t, num_heads) for t in qkv.split(c, dim=-1))
    g, o = _heads(g, num_heads), _heads(o, num_heads)
    qn, sq, dq_ = _norm_head(q, hd)
    kn, sk, dk_ = _norm_head(k, hd)
    vn, sv, dv_ = _norm_head(v, hd)
    qa, ka, va = qn.to(acc), kn.to(acc), vn.to(acc)
    e = torch.exp(torch.matmul(qa, ka.transpose(-1, -2)) * scale)
    rc = scale / e.sum(dim=-1, keepdim=True)
    eb = e.to(dt).to(acc)
    ga = g.to(acc)
    gr = (ga * (rc * math.sqrt(hd))).to(dt).to(acc)
    dvn = torch.matmul(eb.transpose(-1, -2), gr)
    dp = torch.matmul(ga, va.transpose(-1, -2))
    delta = torch.sum(ga * o.to(acc), dim=-1, keepdim=True)
    ds = (e * (dp - delta)).to(dt).to(acc)
    qs = (qa * rc).to(dt).to(acc)
    dqn = torch.matmul(ds, ka) * rc
    dkn = torch.matmul(ds.transpose(-1, -2), qs)
    parts = [
        _pixel_norm_vjp(x, s, d, gy, hd).to(dt).transpose(1, 2).reshape(b, n, c)
        for x, s, d, gy in ((q, sq, dq_, dqn), (k, sk, dk_, dkn), (v, sv, dv_, dvn))
    ]
    return torch.cat(parts, dim=-1)


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = load_library(name)
    if name == "cosine_attention_fwd":
        lib.cosine_attention_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p,
        ]
        lib.cosine_attention_fwd.restype = ctypes.c_int
    else:
        lib.cosine_attention_bwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.cosine_attention_bwd.restype = ctypes.c_int
    lib.cosine_attention_error_string.argtypes = [ctypes.c_int]
    lib.cosine_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_launchable(qkv: torch.Tensor, num_heads: int) -> tuple[int, int, int, int]:
    b, n, c, hd = _split_heads(qkv, num_heads)
    if not qkv.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on {qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernel takes bf16 or fp32, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("the CUDA kernel needs a contiguous qkv tensor")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    return b, n, c, hd


def _raise_on(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err:
        msg = lib.cosine_attention_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def cosine_attention_qkv_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Launch the forward kernel on ``torch.cuda.current_stream()``."""
    b, n, c, hd = _check_launchable(qkv, num_heads)
    lib = _library("cosine_attention_fwd")
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    scale = float(np.float32(1.0 / math.sqrt(hd)))
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = lib.cosine_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), b, n, num_heads, hd,
            int(qkv.dtype == torch.bfloat16), scale, stream,
        )
    _raise_on(lib, err, "cosine_attention_fwd")
    launch_counts["fwd", n] += 1
    return out


def cosine_attention_qkv_bwd_cuda(qkv: torch.Tensor, g: torch.Tensor, o: torch.Tensor,
                                  num_heads: int) -> torch.Tensor:
    """Launch the backward kernel's two passes on ``torch.cuda.current_stream()``.
    ``g`` may arrive non-contiguous (the out-projection's transpose)."""
    b, n, c, hd = _check_launchable(qkv, num_heads)
    for name, t in (("g", g), ("o", o)):
        if t.device != qkv.device or t.dtype != qkv.dtype or tuple(t.shape) != (b, n, c):
            raise ValueError(
                f"{name} must be {(b, n, c)} {qkv.dtype} on {qkv.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    g, o = g.contiguous(), o.contiguous()
    lib = _library("cosine_attention_bwd")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((2, b, num_heads, n), dtype=torch.float32, device=qkv.device)
    scale = float(np.float32(1.0 / math.sqrt(hd)))
    sqrt_hd = float(np.float32(math.sqrt(hd)))
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        err = lib.cosine_attention_bwd(
            qkv.data_ptr(), g.data_ptr(), o.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            b, n, num_heads, hd, int(qkv.dtype == torch.bfloat16), scale, sqrt_hd, stream,
        )
    _raise_on(lib, err, "cosine_attention_bwd")
    launch_counts["bwd", n] += 1
    return dqkv


class _CosineAttentionQKV(torch.autograd.Function):
    """``jax.custom_vjp`` of the JAX package's ``cosine_attention_qkv``: saves
    ``(qkv, o)``, o being the forward's own rounded output."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        if qkv.device.type == "cpu":
            o = cosine_attention_qkv_plain(qkv, num_heads)
        else:
            o = cosine_attention_qkv_cuda(qkv, num_heads)
        ctx.save_for_backward(qkv, o)
        ctx.num_heads = num_heads
        return o

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        qkv, o = ctx.saved_tensors
        if qkv.device.type == "cpu":
            return cosine_attention_qkv_bwd_plain(qkv, g, o, ctx.num_heads), None
        return cosine_attention_qkv_bwd_cuda(qkv, g, o, ctx.num_heads), None


def cosine_attention_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Fused pixel-norm + cosine attention: (b, n, 3C) -> (b, n, C), qkv
    channels ordered (3, heads, hd), output channels (heads, hd);
    differentiable.

    A CPU tensor takes the plain versions; any other device launches the
    CUDA kernels or raises."""
    return _CosineAttentionQKV.apply(qkv, num_heads)
