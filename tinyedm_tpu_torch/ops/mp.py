"""Magnitude-preserving primitives (EDM2, Karras et al. 2023).

Counterpart of ``tinyedm_tpu/ops/mp.py``. Every norm that decides a
magnitude is taken in fp32 whatever the input dtype (fp64 stays fp64); the
denominator is cast to the input dtype before the divide, so a bf16 tensor is
divided by a bf16 number exactly as in the JAX package. ``pixel_norm``
differentiates through the JAX package's custom VJP: it saves the
input-dtype tensor and the reduced norms, not an fp32 copy of the input.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F

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


def mp_silu(x: torch.Tensor) -> torch.Tensor:
    """Magnitude-preserving SiLU."""
    return F.silu(x) * in_dtype(_MP_SILU_SCALE, x.dtype)


def mp_add(a: torch.Tensor, b: torch.Tensor, t: float = 0.5) -> torch.Tensor:
    """Magnitude-preserving interpolation ``lerp(a, b, t) / sqrt((1-t)^2 + t^2)``,
    with ``t`` and the scale rounded to ``a.dtype``."""
    scale = 1.0 / math.sqrt((1.0 - t) ** 2 + t**2)
    return (a + (b - a) * in_dtype(t, a.dtype)) * in_dtype(scale, a.dtype)
