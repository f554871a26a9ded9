"""Magnitude-preserving primitives (EDM2, Karras et al. 2023).

Counterpart of ``tinyedm_tpu/ops/mp.py``. Every norm that decides a
magnitude is taken in fp32 whatever the input dtype (fp64 stays fp64); the
denominator is cast to the input dtype before the divide, so a bf16 tensor is
divided by a bf16 number exactly as in the JAX package. ``pixel_norm``
differentiates through the JAX package's custom VJP: it saves the
input-dtype tensor and the reduced norms, not an fp32 copy of the input.

``weight_norm_cast`` is a layer's effective weight in its compute dtype
where no gradient is wanted: on the card one launch of the hand-written
kernel in ``csrc/weight_norm.cu``, on the CPU the composite it replaces.
``_WeightNormCast`` is the same weight where a gradient is wanted, an
autograd Function: on the card one launch of that kernel forward and one of
its backward kernel, on the CPU the composite's forward and its gradient,
bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from tinyedm_tpu_torch.ops._build import load_library, raise_on_error

# silu(x)/0.596 preserves unit variance for unit-variance input
_MP_SILU_SCALE = 1.0 / 0.596


@functools.lru_cache(maxsize=None)
def in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: a constant the JAX package builds with
    ``jnp.asarray(value, dtype)`` before it multiplies."""
    return torch.tensor(value, dtype=dtype).item()


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type norms and sums are taken in: fp32, or fp64 for fp64 input."""
    return torch.promote_types(dtype, torch.float32)


def _pixel_norm(x: torch.Tensor, dims: tuple[int, ...], eps: float):
    """(x / dtype(D), fp32 norm, fp32 divisor D)."""
    xa = x.to(acc_dtype(x.dtype))
    norm = torch.sqrt(torch.sum(xa * xa, dim=dims, keepdim=True))
    denom = eps + norm * (1.0 / math.sqrt(math.prod(x.shape[d] for d in dims)))
    return x / denom.to(x.dtype), norm, denom


class _PixelNorm(torch.autograd.Function):
    """``tinyedm_tpu/ops/mp.py::_pixel_norm_cvjp``: the exact quotient-rule
    VJP, evaluated in fp32, with the divisor rounded to the input dtype as
    the forward used it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dims: tuple[int, ...], eps: float) -> torch.Tensor:
        y, norm, denom = _pixel_norm(x, dims, eps)
        ctx.save_for_backward(x, norm, denom)
        ctx.dims = dims
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, norm, denom = ctx.saved_tensors
        acc = norm.dtype
        xa, ga = x.to(acc), g.to(acc)
        d_cast = denom.to(x.dtype).to(acc)  # the rounded divisor
        c = 1.0 / math.sqrt(math.prod(x.shape[d] for d in ctx.dims))
        inner = torch.sum(ga * xa, dim=ctx.dims, keepdim=True)
        dx = ga / d_cast - xa * (inner * c / (d_cast * d_cast * torch.clamp(norm, min=1e-30)))
        return dx.to(x.dtype), None, None


def pixel_norm(x: torch.Tensor, dim: int | Sequence[int] = -1, eps: float = 1e-4) -> torch.Tensor:
    """Normalize ``x`` to unit RMS over ``dim``: fp32 L2 norm, scaled by
    ``1/sqrt(prod(reduced dims))``, offset by ``eps``, cast to ``x.dtype``,
    then ``x`` divided by it in ``x.dtype``. The autograd Function, whose
    call costs host time on every use, is taken only when a gradient is
    wanted; the forward is the same either way."""
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    dims = tuple(d % x.ndim for d in dims)
    if torch.is_grad_enabled() and x.requires_grad:
        return _PixelNorm.apply(x, dims, eps)
    return _pixel_norm(x, dims, eps)[0]


def normalize(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """pixel_norm over all non-leading dims (axis 0 indexes output units)."""
    return pixel_norm(x, dim=tuple(range(1, x.ndim)), eps=eps)


def weight_normalize(w: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Per-output-unit unit-RMS normalization of a stored weight.

    2-D ``(out, in)`` linear weights reduce over dim 1; 4-D OIHW conv weights
    over dims (1, 2, 3) (the JAX package's HWIO layout reduces over (0, 1, 2)).
    """
    if w.ndim == 2:
        return pixel_norm(w, dim=(1,), eps=eps)
    if w.ndim == 4:
        return pixel_norm(w, dim=(1, 2, 3), eps=eps)
    raise ValueError(f"weight_normalize expects 2D or 4D weight, got shape {tuple(w.shape)}")


def weight_norm_cast_plain(w: torch.Tensor, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """The composite: ``weight_normalize(w) * scale`` cast to ``dtype``."""
    return (weight_normalize(w) * scale).to(dtype)


@functools.lru_cache(maxsize=None)
def _weight_norm_library() -> ctypes.CDLL:
    lib = load_library("weight_norm")
    lib.weight_norm_cast.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.weight_norm_cast.restype = ctypes.c_int
    lib.weight_norm_cast_bwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.weight_norm_cast_bwd.restype = ctypes.c_int
    return lib


def weight_norm_cast_cuda(w: torch.Tensor, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """One launch of the kernel on the current stream: a stored fp32
    weight, 2-D or 4-D on a CUDA device, to bf16 or fp32. It runs once a
    layer a forward, so its host time counts: the raw stream handle, and a
    device guard only where the weight is not on the current device."""
    if w.ndim not in (2, 4):
        raise ValueError(f"weight_norm_cast expects 2D or 4D weight, got shape {tuple(w.shape)}")
    if not w.is_cuda or w.dtype != torch.float32 or dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernel takes an fp32 weight on a CUDA device to bf16 or fp32, "
                         f"got {w.dtype} on {w.device} to {dtype}")
    device = w.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return weight_norm_cast_cuda(w, scale, dtype)
    if not w.is_contiguous():
        w = w.contiguous()
    y = torch.empty(w.shape, dtype=dtype, device=w.device)
    if y.numel() == 0:
        return y
    rows = w.shape[0]
    lib = _weight_norm_library()
    err = lib.weight_norm_cast(w.data_ptr(), y.data_ptr(), rows, w.numel() // rows, scale,
                               dtype == torch.bfloat16, torch._C._cuda_getCurrentRawStream(device))
    raise_on_error(lib, err, "weight_norm_cast")
    weight_norm_cast.launches += 1
    return y


def weight_norm_cast(w: torch.Tensor, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``weight_normalize(w) * scale`` in ``dtype``, for a weight no gradient
    flows to. A CPU tensor takes the plain composite; any other device
    launches the CUDA kernel or raises. The kernel takes the composite's fp32
    steps in its order, with the constants rounded to fp32 as the composite
    rounds them, so only the order of the sum of squares differs.
    ``weight_norm_cast.launches`` counts the kernel's launches."""
    if w.device.type == "cpu":
        return weight_norm_cast_plain(w, scale, dtype)
    return weight_norm_cast_cuda(w, scale, dtype)


weight_norm_cast.launches = 0
weight_norm_cast.bwd_launches = 0


def weight_norm_cast_bwd_plain(w: torch.Tensor, g: torch.Tensor, scale: float) -> torch.Tensor:
    """The gradient of ``w`` that autograd takes through the composite from
    ``g``, the gradient of its output: the cast's node, the scale's, then
    ``_PixelNorm.backward`` with the divisor recomputed, op for op."""
    dims = tuple(range(1, w.ndim))
    ga = g.to(w.dtype) * scale
    norm = torch.sqrt(torch.sum(w * w, dim=dims, keepdim=True))
    c = 1.0 / math.sqrt(math.prod(w.shape[1:]))
    denom = 1e-4 + norm * c
    inner = torch.sum(ga * w, dim=dims, keepdim=True)
    return ga / denom - w * (inner * c / (denom * denom * torch.clamp(norm, min=1e-30)))


def weight_norm_cast_bwd_cuda(w: torch.Tensor, g: torch.Tensor, scale: float) -> torch.Tensor:
    """One launch of the backward kernel on the current stream: the fp32
    gradient of a stored fp32 weight, 2-D or 4-D on a CUDA device, from the
    bf16 or fp32 gradient ``g`` of its effective weight. It runs once a
    layer a backward: the host path is ``weight_norm_cast_cuda``'s."""
    if w.ndim not in (2, 4) or g.shape != w.shape:
        raise ValueError(f"weight_norm_cast_bwd expects a 2D or 4D weight and a gradient of its shape, got "
                         f"{tuple(w.shape)} and {tuple(g.shape)}")
    if not w.is_cuda or w.dtype != torch.float32 or g.device != w.device \
            or g.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernel takes an fp32 weight on a CUDA device and a bf16 or fp32 gradient on "
                         f"the same device, got {w.dtype} on {w.device} and {g.dtype} on {g.device}")
    device = w.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return weight_norm_cast_bwd_cuda(w, g, scale)
    if not w.is_contiguous():
        w = w.contiguous()
    if not g.is_contiguous():
        g = g.contiguous()
    dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    if dw.numel() == 0:
        return dw
    rows = w.shape[0]
    lib = _weight_norm_library()
    err = lib.weight_norm_cast_bwd(w.data_ptr(), g.data_ptr(), dw.data_ptr(), rows, w.numel() // rows, scale,
                                   g.dtype == torch.bfloat16, torch._C._cuda_getCurrentRawStream(device))
    raise_on_error(lib, err, "weight_norm_cast_bwd")
    weight_norm_cast.bwd_launches += 1
    return dw


def weight_norm_cast_bwd(w: torch.Tensor, g: torch.Tensor, scale: float) -> torch.Tensor:
    """The gradient of the stored weight from ``g``: the plain version for a
    CPU tensor, else the CUDA kernel or a raise. The kernel takes the
    plain version's fp32 steps in its order, so only the order of its two
    sums differs. ``weight_norm_cast.bwd_launches`` counts its launches."""
    if w.device.type == "cpu":
        return weight_norm_cast_bwd_plain(w, g, scale)
    return weight_norm_cast_bwd_cuda(w, g, scale)


class _WeightNormCast(torch.autograd.Function):
    """``weight_norm_cast`` with a backward: ``T((w / denom) * s)`` forward,
    ``weight_norm_cast_bwd`` backward, each one launch on the card and the
    plain version on the CPU (the composite's output and gradient, bit for
    bit). It saves only ``w``, the parameter itself; the backward recomputes
    the divisor."""

    @staticmethod
    def forward(ctx, w: torch.Tensor, scale: float, dtype: torch.dtype) -> torch.Tensor:
        ctx.save_for_backward(w)
        ctx.scale = scale
        return weight_norm_cast(w, scale, dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (w,) = ctx.saved_tensors
        return weight_norm_cast_bwd(w, g, ctx.scale), None, None


def mp_silu(x: torch.Tensor) -> torch.Tensor:
    """Magnitude-preserving SiLU."""
    return F.silu(x) * in_dtype(_MP_SILU_SCALE, x.dtype)


def mp_add(a: torch.Tensor, b: torch.Tensor, t: float = 0.5) -> torch.Tensor:
    """Magnitude-preserving interpolation ``lerp(a, b, t) / sqrt((1-t)^2 + t^2)``,
    with ``t`` and the scale rounded to ``a.dtype``."""
    scale = 1.0 / math.sqrt((1.0 - t) ** 2 + t**2)
    return (a + (b - a) * in_dtype(t, a.dtype)) * in_dtype(scale, a.dtype)


def mp_cat(a: torch.Tensor, b: torch.Tensor, dim: int = -1, t: float = 0.5) -> torch.Tensor:
    """Magnitude-preserving concatenation along ``dim`` (EDM2 paper eq. 103),
    each operand scaled by its weight rounded to its own dtype. ``dim``
    defaults to the last axis, as the JAX package's ``axis`` does (its
    images are NHWC): NCHW callers concatenating channels pass ``dim=1``."""
    na, nb = a.shape[dim], b.shape[dim]
    scale = math.sqrt((na + nb) / ((1.0 - t) ** 2 + t**2))
    wa = scale * (1.0 - t) / math.sqrt(na)
    wb = scale * t / math.sqrt(nb)
    return torch.cat([a * in_dtype(wa, a.dtype), b * in_dtype(wb, b.dtype)], dim=dim)
