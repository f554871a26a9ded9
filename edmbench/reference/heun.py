"""The plain reference of EDM's deterministic sampler (Karras et al. 2022,
Algorithm 1: Heun's second-order method on the probability-flow ODE with
sigma(t) = t) and of the uint8 mapping of a sample, in fp32 PyTorch."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from edmbench.reference.model import denoise
from edmbench.reference.precision import FP32, Precision


def sigma_steps(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
                rho: float = 7.0) -> list[float]:
    """(sigma_max^(1/rho) + i/(n-1) (sigma_min^(1/rho) - sigma_max^(1/rho)))^rho,
    then 0, in fp64."""
    i = np.arange(num_steps, dtype=np.float64)
    t = (sigma_max ** (1 / rho) + i / (num_steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return [float(v) for v in t] + [0.0]


@torch.no_grad()
def heun(P: dict, cfg: dict, noise: torch.Tensor, labels: Optional[torch.Tensor], num_steps: int,
         prec: Precision = FP32) -> torch.Tensor:
    """x_0 = sigma_0 noise, then per step an Euler prediction to the next
    sigma and, except on the last step to 0, the trapezoidal correction: 2 n - 1
    denoiser evaluations. Returns the sample, fp32."""
    t = [float(np.float32(v)) for v in sigma_steps(num_steps)]
    b = noise.shape[0]
    x = noise.float() * t[0]

    def slope(x: torch.Tensor, sigma: float) -> torch.Tensor:
        s = torch.full((b,), sigma, dtype=torch.float32, device=x.device)
        return (x - denoise(P, cfg, x, s, labels, None, prec)[0]) / sigma

    for i in range(num_steps):
        h = t[i + 1] - t[i]
        d = slope(x, t[i])
        x_next = x + h * d
        if t[i + 1] > 0:
            x_next = x + h * 0.5 * (d + slope(x_next, t[i + 1]))
        x = x_next
    return x


def to_uint8(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """x std 2 + mean per channel, clamped to [0, 1], times 255, truncated."""
    m = torch.tensor(mean, dtype=torch.float32, device=x.device).reshape(1, -1, 1, 1)
    s = torch.tensor(std, dtype=torch.float32, device=x.device).reshape(1, -1, 1, 1)
    return ((x.float() * s * 2.0 + m).clamp(0.0, 1.0) * 255.0).to(torch.uint8)
