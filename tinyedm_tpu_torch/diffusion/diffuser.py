"""Forward-noising diffuser.

Counterpart of ``tinyedm_tpu/diffusion/diffuser.py``: per-sample noise
levels ``ln(sigma) ~ N(P_mean, P_std)`` and ``noisy = clean + sigma * n``,
all in fp32, with the draws taken from an explicit generator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Diffuser:
    P_mean: float = -1.2
    P_std: float = 1.2

    def __call__(
        self, clean_image: torch.Tensor, generator: Optional[torch.Generator]
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """clean_image (B, C, H, W) -> (noisy fp32, sigma (B,) fp32): draws the
        (B,) standard normals of sigma, then the image noise."""
        kw = dict(generator=generator, device=clean_image.device, dtype=torch.float32)
        eps = torch.randn((clean_image.shape[0],), **kw)
        noise = torch.randn(clean_image.shape, **kw)
        return self.apply(clean_image, eps, noise)

    def apply(
        self, clean_image: torch.Tensor, eps: torch.Tensor, noise: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The diffuser on given draws: ``eps`` (B,) and ``noise`` like the image."""
        sigma = torch.exp(self.P_mean + eps.float() * self.P_std)
        noisy = clean_image.float() + noise.float() * sigma.reshape(-1, 1, 1, 1)
        return noisy, sigma
