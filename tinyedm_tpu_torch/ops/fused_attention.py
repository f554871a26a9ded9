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

The whole block (``attention_block``, the counterpart of the JAX package's
``attention_block`` and of its kernels ``_attn_block_fwd_kernel`` and
``_attn_block_bwd_kernel``) wraps that core in the block's two 1x1 convs as
GEMMs and the ``mp_add(x, ., 0.5)`` residual: ``csrc/attention_block_fwd.cu``
and ``csrc/attention_block_bwd.cu`` on the card, ``attention_block_plain``
and ``attention_block_bwd_plain`` on the CPU. ``block_kernel_fits`` is the
JAX package's VMEM byte model, copied so that a layer takes the same route
in both packages; the CUDA kernels take any shape the wrappers accept.

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

from tinyedm_tpu_torch.ops._build import load_library, raise_on_error
from tinyedm_tpu_torch.ops.mp import acc_dtype, in_dtype, mp_add, pixel_norm

# Largest token count the fused path takes (the JAX package's bound). The
# CUDA kernels have no such limit of their own; above it the model runs the
# unfused path, as in the JAX package.
MAX_FUSED_TOKENS = 512
MAX_HEAD_DIM = 256
EPS = 1e-4  # pixel-norm epsilon

# Kernel calls by kernel and token count: ("fwd", n) and ("bwd", n) for the
# attention core, ("block_fwd", n) and ("block_bwd", n) for the whole block. A
# wrapper adds one where it launches its kernel and nowhere else (a call of
# several launches counts once); chip_smoke.py reads these counts to show the
# main path went through the kernels.
launch_counts: Counter = Counter()

_DTYPES = (torch.bfloat16, torch.float32)
# the devices the forward ops are called on: the plain version's and the kernels'
_OP_DEVICES = ("cpu", "cuda")


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
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "attention_block_fwd":
        lib.attention_block_fwd.argtypes = [ptr] * 6 + [i32] * 5 + [f32] * 3 + [ptr]
        lib.attention_block_fwd.restype = i32
    elif name == "attention_block_bwd":
        lib.attention_block_bwd.argtypes = [ptr] * 13 + [i32] * 6 + [f32] * 3 + [ptr]
        lib.attention_block_bwd.restype = i32
    elif name == "cosine_attention_fwd":
        lib.cosine_attention_fwd.argtypes = [ptr] * 2 + [i32] * 5 + [f32, ptr]
        lib.cosine_attention_fwd.restype = i32
    else:
        lib.cosine_attention_bwd.argtypes = [ptr] * 5 + [i32] * 5 + [f32] * 2 + [ptr]
        lib.cosine_attention_bwd.restype = i32
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
        raise ValueError(f"head dim {hd} > MAX_HEAD_DIM ({MAX_HEAD_DIM}) of the CUDA kernels")
    return b, n, c, hd


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
    raise_on_error(lib, err, "cosine_attention_fwd")
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
    raise_on_error(lib, err, "cosine_attention_bwd")
    launch_counts["bwd", n] += 1
    return dqkv


@torch.library.custom_op("tinyedm::cosine_attention_fwd", mutates_args=())
def _cosine_attention_fwd(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The forward as one dispatcher op (the plain version on a CPU tensor,
    the kernel on any other), so that a selective-checkpoint policy can
    keep its output (``models/unet.py::SAVED_BY_CONVS``)."""
    if qkv.device.type == "cpu":
        return cosine_attention_qkv_plain(qkv, num_heads)
    return cosine_attention_qkv_cuda(qkv, num_heads)


cosine_attention_fwd_op = torch.ops.tinyedm.cosine_attention_fwd.default


class _CosineAttentionQKV(torch.autograd.Function):
    """``jax.custom_vjp`` of the JAX package's ``cosine_attention_qkv``: saves
    ``(qkv, o)``, o being the forward's own rounded output."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        if qkv.device.type not in _OP_DEVICES:
            _check_launchable(qkv, num_heads)  # raises: no kernel there
        o = cosine_attention_fwd_op(qkv, num_heads)
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


# ---------------------------------------------------------------------------
# The whole block: qkv GEMM -> cosine attention -> out GEMM -> mp_add residual
# ---------------------------------------------------------------------------

RES_T = 0.5  # CosineAttention's residual factor
_BUDGET = 14 * 1024 * 1024  # the JAX package's VMEM budget of its block kernels


def use_pair(heads: int, n: int) -> bool:
    """The JAX package's choice of its head-pair kernels (small, aligned n)."""
    return heads % 2 == 0 and n <= 128 and n % 8 == 0


def _block_sample_bytes(n: int, channels: int, heads: int, bwd: bool, pair: bool) -> int:
    """VMEM bytes of one sample in the JAX block kernels: IO, the qkv/y (and
    gat/dqkv) scratches and the attention core's intermediates of all heads."""
    c = channels
    io = (4 if bwd else 2) * n * c * 2 * 2
    scr = (2 * n * 4 * c + (2 * n * 4 * c if bwd else 0)) * 2
    if pair:
        iters = max(heads // 2, 1)
        core = iters * ((4 if bwd else 2) * n * 2 * n * 4 + 2 * n * 2 * n * 2)
    else:
        core = heads * ((3 if bwd else 2) * n * n * 4 + (12 if bwd else 6) * n * (c // heads) * 4)
    return io + scr + core


def _block_fixed_bytes(c: int, bwd: bool) -> int:
    """VMEM bytes resident across the JAX kernels' grid: the weights, and in
    the backward the fp32 weight-gradient accumulators."""
    fixed = 2 * c * 4 * c
    if bwd:
        fixed += 4 * (3 * c * c + c * c)
    return fixed


def _block_pair_scratch_bytes(bb: int, n: int, hd: int, pair: bool) -> int:
    return 2 * bb * 2 * n * 2 * hd * 2 if pair else 0


def block_kernel_fits(n: int, channels: int, heads: int) -> bool:
    """The JAX package's ``block_kernel_fits``: whether its block kernels
    (forward and backward) fit the TPU's VMEM budget at one sample. It picks
    the route of ``CosineAttention(fused="block")`` in both packages; the
    CUDA kernels have no such limit."""
    pair = use_pair(heads, n)
    hd = channels // heads
    for bwd in (False, True):
        per = _block_sample_bytes(n, channels, heads, bwd, pair)
        scratch = _block_pair_scratch_bytes(1, n, hd, pair)
        if per + scratch + _block_fixed_bytes(channels, bwd) > _BUDGET:
            return False
    return True


def _residual_constants(dtype: torch.dtype) -> tuple[float, float, float]:
    """(t, s, t * s) rounded to ``dtype``: mp_add's factor, its scale
    ``1/sqrt((1-t)^2 + t^2)`` and the gradient of the output by ``out``."""
    s = 1.0 / math.sqrt((1.0 - RES_T) ** 2 + RES_T**2)
    return in_dtype(RES_T, dtype), in_dtype(s, dtype), in_dtype(RES_T * s, dtype)


def _block_qkv_y(x: torch.Tensor, wqkv: torch.Tensor, num_heads: int):
    acc = acc_dtype(x.dtype)
    qkv = torch.matmul(x.to(acc), wqkv.to(acc)).to(x.dtype)
    return qkv, cosine_attention_qkv_plain(qkv, num_heads)


def attention_block_plain(x: torch.Tensor, wqkv: torch.Tensor, wout: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """The block forward kernel's math in plain PyTorch: x (b, n, C),
    effective weights wqkv (C, 3C) and wout (C, C) in x's dtype ->
    ``mp_add(x, dtype(y @ wout), 0.5)`` with ``y`` the fused attention of
    ``dtype(x @ wqkv)``, fp32 sums, the residual in x's dtype."""
    _, y = _block_qkv_y(x, wqkv, num_heads)
    acc = acc_dtype(x.dtype)
    out = torch.matmul(y.to(acc), wout.to(acc)).to(x.dtype)
    return mp_add(x, out, RES_T)


def attention_block_bwd_plain(x: torch.Tensor, wqkv: torch.Tensor, wout: torch.Tensor,
                              g: torch.Tensor, num_heads: int):
    """The block backward kernel's math in plain PyTorch, with its rounding
    sites: -> (dx in x's dtype, dwqkv and dwout in fp32, fp64 for fp64)."""
    b, n, c = x.shape
    dt, acc = x.dtype, acc_dtype(x.dtype)
    qkv, y = _block_qkv_y(x, wqkv, num_heads)
    gout = g * _residual_constants(dt)[2]
    dwout = torch.matmul(y.reshape(b * n, c).to(acc).t(), gout.reshape(b * n, c).to(acc))
    dy = torch.matmul(gout.to(acc), wout.to(acc).t()).to(dt)
    dqkv = cosine_attention_qkv_bwd_plain(qkv, dy, y, num_heads)
    dwqkv = torch.matmul(x.reshape(b * n, c).to(acc).t(), dqkv.reshape(b * n, 3 * c).to(acc))
    dx = torch.matmul(dqkv.to(acc), wqkv.to(acc).t()).to(dt) + gout
    return dx, dwqkv, dwout


def _check_block(x: torch.Tensor, wqkv: torch.Tensor, wout: torch.Tensor,
                 num_heads: int) -> tuple[int, int, int, int]:
    if x.ndim != 3:
        raise ValueError(f"x must be (b, n, C), got {tuple(x.shape)}")
    b, n, c = x.shape
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"channels {c} not divisible by num_heads {num_heads}")
    if not x.is_cuda:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernel takes bf16 or fp32, got {x.dtype}")
    for name, w, shape in (("wqkv", wqkv, (c, 3 * c)), ("wout", wout, (c, c))):
        if w.device != x.device or w.dtype != x.dtype or tuple(w.shape) != shape:
            raise ValueError(f"{name} must be {shape} {x.dtype} on {x.device}, "
                             f"got {tuple(w.shape)} {w.dtype} on {w.device}")
    hd = c // num_heads
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > MAX_HEAD_DIM ({MAX_HEAD_DIM}) of the CUDA kernels")
    return b, n, c, hd


def attention_block_cuda(x: torch.Tensor, wqkv: torch.Tensor, wout: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """Launch the block forward's three kernels on the current stream."""
    b, n, c, hd = _check_block(x, wqkv, wout, num_heads)
    x, wqkv, wout = x.contiguous(), wqkv.contiguous(), wout.contiguous()
    lib = _library("attention_block_fwd")
    qkv = torch.empty((b, n, 3 * c), dtype=x.dtype, device=x.device)
    y = torch.empty((b, n, c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    t, s, _ = _residual_constants(x.dtype)
    scale = float(np.float32(1.0 / math.sqrt(hd)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.attention_block_fwd(
            x.data_ptr(), wqkv.data_ptr(), wout.data_ptr(), qkv.data_ptr(), y.data_ptr(),
            out.data_ptr(), b, n, num_heads, hd, int(x.dtype == torch.bfloat16), scale, t, s,
            stream,
        )
    raise_on_error(lib, err, "attention_block_fwd")
    launch_counts["block_fwd", n] += 1
    return out


def attention_block_bwd_cuda(x: torch.Tensor, wqkv: torch.Tensor, wout: torch.Tensor,
                             g: torch.Tensor, num_heads: int):
    """Launch the block backward's kernels on the current stream: -> (dx,
    dwqkv fp32, dwout fp32)."""
    b, n, c, hd = _check_block(x, wqkv, wout, num_heads)
    if g.device != x.device or g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(f"g must be {tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    x, wqkv, wout, g = x.contiguous(), wqkv.contiguous(), wout.contiguous(), g.contiguous()
    lib = _library("attention_block_bwd")
    # the weight gradients' split reduction: one fp32 partial per 1024 of the
    # b * n rows, at most 64 (other counts gain nothing on an H100:
    # experiments/torch_block_gemm_sweep.py --splits)
    splits = min(64, -(-b * n // 1024))
    dev = x.device
    dx = torch.empty_like(x)
    dwqkv = torch.empty((c, 3 * c), dtype=torch.float32, device=dev)
    dwout = torch.empty((c, c), dtype=torch.float32, device=dev)
    qkv, dqkv = (torch.empty((b, n, 3 * c), dtype=x.dtype, device=dev) for _ in range(2))
    y, dy = (torch.empty_like(x) for _ in range(2))
    stats = torch.empty((2, b, num_heads, n), dtype=torch.float32, device=dev)
    partials = torch.empty((splits, c, 3 * c), dtype=torch.float32, device=dev)
    ts = _residual_constants(x.dtype)[2]
    scale = float(np.float32(1.0 / math.sqrt(hd)))
    sqrt_hd = float(np.float32(math.sqrt(hd)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.attention_block_bwd(
            *(t.data_ptr() for t in (x, wqkv, wout, g, dx, dwqkv, dwout, qkv, y, dy, dqkv,
                                     stats, partials)),
            splits, b, n, num_heads, hd, int(x.dtype == torch.bfloat16), scale, sqrt_hd, ts,
            stream,
        )
    raise_on_error(lib, err, "attention_block_bwd")
    launch_counts["block_bwd", n] += 1
    return dx, dwqkv, dwout


@torch.library.custom_op("tinyedm::attention_block_fwd", mutates_args=())
def _attention_block_fwd(x: torch.Tensor, wqkv: torch.Tensor, wout: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """The block forward as one dispatcher op, as ``_cosine_attention_fwd``."""
    fwd = attention_block_plain if x.device.type == "cpu" else attention_block_cuda
    return fwd(x, wqkv, wout, num_heads)


attention_block_fwd_op = torch.ops.tinyedm.attention_block_fwd.default


class _AttentionBlock(torch.autograd.Function):
    """``jax.custom_vjp`` of the JAX package's ``attention_block``: saves
    ``(x, wqkv, wout)`` and recomputes the forward in the backward; the
    weight gradients come back in the weights' dtype (``_ab_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x, wqkv, wout, num_heads: int):
        if x.device.type not in _OP_DEVICES:
            _check_block(x, wqkv, wout, num_heads)  # raises: no kernel there
        ctx.save_for_backward(x, wqkv, wout)
        ctx.num_heads = num_heads
        return attention_block_fwd_op(x, wqkv, wout, num_heads)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, wqkv, wout = ctx.saved_tensors
        bwd = attention_block_bwd_plain if x.device.type == "cpu" else attention_block_bwd_cuda
        dx, dwqkv, dwout = bwd(x, wqkv, wout, g, ctx.num_heads)
        return dx, dwqkv.to(wqkv.dtype), dwout.to(wout.dtype), None


def attention_block(x: torch.Tensor, wqkv: torch.Tensor, wout: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """The whole CosineAttention block ``mp_add(x, attn(x @ wqkv) @ wout,
    0.5)`` on tokens x (b, n, C) with the effective weights wqkv (C, 3C) and
    wout (C, C) in x's dtype; differentiable in all three.

    A CPU tensor takes the plain versions; any other device launches the
    CUDA kernels or raises."""
    return _AttentionBlock.apply(x, wqkv, wout, num_heads)
