"""EDM preconditioning coefficients (Karras et al. 2022, Table 1), in fp32.

Counterpart of ``tinyedm_tpu/ops/precond.py``. sigma arrives per sample as
``(B,)``; the coefficients broadcast over NCHW images as ``(B, 1, 1, 1)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PrecondCoeffs(NamedTuple):
    c_skip: torch.Tensor
    c_out: torch.Tensor
    c_in: torch.Tensor
    c_noise: torch.Tensor


def edm_precond(sigma: torch.Tensor, sigma_data: float) -> PrecondCoeffs:
    """c_skip/c_out/c_in/c_noise for D(x; sigma) = c_skip*x + c_out*F(c_in*x).

    Returns coefficients shaped (B, 1, 1, 1), except c_noise, which stays (B,)."""
    sigma = sigma.float()
    sd = np.float32(sigma_data)
    sd2 = float(sd * sd)  # rounded to fp32, as the JAX package squares it
    sd = float(sd)
    s2 = sigma**2
    c_skip = sd2 / (s2 + sd2)
    c_out = sigma * sd / torch.sqrt(s2 + sd2)
    c_in = 1.0 / torch.sqrt(sd2 + s2)
    c_noise = torch.log(sigma) / 4.0
    bcast = lambda c: c.reshape(c.shape + (1, 1, 1))  # noqa: E731
    return PrecondCoeffs(bcast(c_skip), bcast(c_out), bcast(c_in), c_noise)
