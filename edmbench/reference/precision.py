"""How the reference rounds the operands of its products.

The configurations state bf16 compute for the U-Net's convolutions and
attention products. The reference computes them in fp32 (``FP32``: nothing
rounded). The control of ``correct`` is the reference one precision lower
than the configuration states: fp8 (``FP8``), each operand scaled per
tensor to e4m3's range and rounded there in the forward, and each gradient
that flows back through it to e5m2's, as fp8 training does.
"""

from __future__ import annotations

import torch

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2


def round_scaled(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` after scaling its largest magnitude to the
    type's largest finite value, then scaled back, in ``t``'s own type."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        return round_scaled(t, E4M3)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return round_scaled(g, E5M2)


class Precision:
    """``op(t)``: a product's operand as this precision holds it."""

    name = "fp32"

    def op(self, t: torch.Tensor) -> torch.Tensor:
        return t


class Fp8(Precision):
    name = "fp8"

    def op(self, t: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(t)


FP32 = Precision()
FP8 = Fp8()
PRECISIONS = {"fp32": FP32, "fp8": FP8}
