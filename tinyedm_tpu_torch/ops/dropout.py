"""Dropout with a 16-bit integer keep threshold.

Counterpart of ``tinyedm_tpu/ops/dropout.py``: a sample is kept where its
16-bit random number is below ``round((1 - rate) * 65536)``, so the keep
probability is quantized to 1/65536, and survivors are scaled by the EXACT
``1/(1 - rate)`` rounded to ``x.dtype``.

The JAX package draws uint16 bits. CUDA's ``randint`` has no uint16 form, so
the port draws int32 numbers in ``[0, 65536)`` from an explicit generator:
the same 16-bit uniform law and the same threshold compare, hence the same
semantics, at twice the bytes per saved mask. Given the same bits, both
packages give the same result (``tests/test_torch_training_ops.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from tinyedm_tpu_torch.ops.mp import in_dtype


def dropout_threshold(rate: float) -> int:
    """16-bit keep threshold for ``rate``; 65536 means 'keep everything'."""
    return int(round((1.0 - rate) * 65536.0))


def dropout_bits(
    shape: tuple[int, ...], generator: Optional[torch.Generator], device: torch.device
) -> torch.Tensor:
    """int32 random numbers in ``[0, 65536)`` backing a dropout mask, drawn
    apart from the mask's use so that they can be saved across a recompute."""
    return torch.randint(0, 65536, shape, generator=generator, device=device, dtype=torch.int32)


def apply_dropout_bits(bits: torch.Tensor, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Apply the mask of ``bits`` (any integer type holding 0..65535):
    ``nn.Dropout(rate)`` semantics with the keep probability quantized."""
    threshold = dropout_threshold(rate)
    if threshold >= 65536:  # rate too small to represent: keep everything
        return x
    keep = bits < threshold
    scale = in_dtype(1.0 / (1.0 - rate), x.dtype)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))
