"""Magnitude-preserving primitives (EDM2, Karras et al. 2023), forward only.

Counterpart of ``tinyedm_tpu/ops/mp.py``. Every norm that decides a
magnitude is taken in fp32 whatever the input dtype; the denominator is cast
to the input dtype before the divide, so a bf16 tensor is divided by a bf16
number exactly as in the JAX package.
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
def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: a constant the JAX package builds with
    ``jnp.asarray(value, dtype)`` before it multiplies."""
    return torch.tensor(value, dtype=dtype).item()


def pixel_norm(x: torch.Tensor, dim: int | Sequence[int] = -1, eps: float = 1e-4) -> torch.Tensor:
    """Normalize ``x`` to unit RMS over ``dim``: fp32 L2 norm, scaled by
    ``1/sqrt(prod(reduced dims))``, offset by ``eps``, cast to ``x.dtype``,
    then ``x`` divided by it in ``x.dtype``."""
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    dims = tuple(d % x.ndim for d in dims)
    x32 = x.float()
    norm = torch.sqrt(torch.sum(x32 * x32, dim=dims, keepdim=True))
    reduced = math.prod(x.shape[d] for d in dims)
    denom = eps + norm * (1.0 / math.sqrt(reduced))
    return x / denom.to(x.dtype)


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
    return F.silu(x) * _in_dtype(_MP_SILU_SCALE, x.dtype)


def mp_add(a: torch.Tensor, b: torch.Tensor, t: float = 0.5) -> torch.Tensor:
    """Magnitude-preserving interpolation ``lerp(a, b, t) / sqrt((1-t)^2 + t^2)``,
    with ``t`` and the scale rounded to ``a.dtype``."""
    scale = 1.0 / math.sqrt((1.0 - t) ** 2 + t**2)
    return (a + (b - a) * _in_dtype(t, a.dtype)) * _in_dtype(scale, a.dtype)
