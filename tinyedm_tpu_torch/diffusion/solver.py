"""Deterministic 2nd-order Heun ODE sampler (EDM Algorithm 1 with
sigma(t)=t, s(t)=1).

Counterpart of ``tinyedm_tpu/diffusion/solver.py``: the schedule is built in
fp64 on the host and cast to the solver dtype, and the solve walks the same
half-step tables (an Euler prediction, then a Heun correction, with a final
Euler step to sigma = 0) as a Python loop: 2*num_steps - 1 model forwards.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]

_DTYPES = {
    None: torch.float32,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
    "float16": torch.float16,
}


def karras_sigma_schedule(
    num_steps: int, sigma_min: float, sigma_max: float, rho: float
) -> np.ndarray:
    """t_i = (sigma_max^(1/rho) + i/(n-1) * (sigma_min^(1/rho) - sigma_max^(1/rho)))^rho,
    with a trailing 0, in fp64. One step is ``[sigma_max, 0]``."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    if num_steps == 1:
        return np.asarray([sigma_max, 0.0], np.float64)
    i = np.arange(num_steps, dtype=np.float64)
    t = (
        sigma_max ** (1.0 / rho)
        + i / (num_steps - 1) * (sigma_min ** (1.0 / rho) - sigma_max ** (1.0 / rho))
    ) ** rho
    return np.concatenate([t, np.zeros(1)]).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class DeterministicSolver:
    """Heun sampler. ``dtype`` is the precision of the ODE state and its
    arithmetic (the model keeps its own compute dtype); sigma reaches the
    model as fp32 per sample."""

    num_steps: int = 18
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    dtype: Optional[str] = None  # None | "float32" | "bfloat16" | "float64" | "float16"

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown solver dtype {self.dtype!r}")
        return _DTYPES[self.dtype]

    @property
    def t_steps(self) -> np.ndarray:
        return karras_sigma_schedule(self.num_steps, self.sigma_min, self.sigma_max, self.rho)

    def solve(
        self,
        denoise_fn: DenoiseFn,
        x0: torch.Tensor,
        class_labels: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Integrate the probability-flow ODE from sigma_max down to 0.

        denoise_fn(x, sigma_batch, class_labels) -> D(x; sigma). x0: standard
        normal noise. Returns the final sample in the solver dtype."""
        dtype = self.torch_dtype
        b = x0.shape[0]
        t = self.t_steps  # host fp64

        def scalar(v: float) -> torch.Tensor:
            return torch.tensor(v, dtype=dtype)

        x = x0.to(dtype) * scalar(t[0]).to(x0.device)
        x_base = x
        dx_base = torch.zeros_like(x)
        for i in range(self.num_steps):
            # predict evaluates D at t[i]; the correction (all but the last
            # step) at t[i+1]
            half_steps = [(t[i], True)] + ([(t[i + 1], False)] if i < self.num_steps - 1 else [])
            h = (scalar(t[i + 1]) - scalar(t[i])).item()  # fp32 difference of fp32 values
            for sigma_t, is_predict in half_steps:
                sigma_d = scalar(sigma_t)
                sigma = torch.full((b,), sigma_d.item(), dtype=torch.float32, device=x.device)
                d = denoise_fn(x, sigma, class_labels).to(dtype)
                dx = (x - d) / sigma_d.item()
                if is_predict:
                    x_base, x = x, x + h * dx
                else:
                    x = x_base + (h * 0.5) * (dx_base + dx)
                    x_base = x
                dx_base = dx
        return x
