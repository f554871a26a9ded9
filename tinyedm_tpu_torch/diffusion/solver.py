"""ODE and SDE samplers for EDM (sigma(t) = t, s(t) = 1).

Counterpart of ``tinyedm_tpu/diffusion/solver.py``: the schedule is built in
fp64 on the host and every per-step coefficient is cast to the solver dtype
before any arithmetic, as the JAX package casts its scanned tables. Each
solve is a Python loop over those host values, so no step reads the card:

- ``DeterministicSolver``: Heun (EDM Algorithm 1), an Euler prediction then a
  Heun correction per step, a final Euler step to sigma = 0:
  2*num_steps - 1 model forwards;
- ``MultistepSolver``: DPM-Solver++(2M), one forward per step;
- ``StochasticSolver``: EDM Algorithm 2, Heun with churn noise injected
  before each prediction, drawn from an explicit generator.

A ``denoise_fn`` that is a ``guidance.IntervalGate`` is asked for its branch
with the half-step's sigma on the host, so a guided solve never waits for
the card to decide whether guidance is on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tinyedm_tpu_torch.diffusion.guidance import IntervalGate
from tinyedm_tpu_torch.diffusion.protocols import Conditioning
from tinyedm_tpu_torch.utils.profiling import span

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Optional[Conditioning]], torch.Tensor]

_DTYPES = {
    None: torch.float32,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
    "float16": torch.float16,
}
# a config's solver dtype reaches the solver as a torch dtype (the registry
# turns every ``dtype`` string into one, as the JAX registry does)
_DTYPES.update({d: d for d in (torch.float32, torch.bfloat16, torch.float64, torch.float16)})


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
    dtype: Optional[str] = None  # None | "float32" | "bfloat16" | "float64" | "float16" (or that torch dtype)

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
        class_labels: Optional[Conditioning] = None,
    ) -> torch.Tensor:
        """Integrate the probability-flow ODE from sigma_max down to 0.

        denoise_fn(x, sigma_batch, class_labels) -> D(x; sigma), the
        conditioning (labels or a ``TextConditioning``) handed to every
        forward as given. x0: standard normal noise. Returns the final sample
        in the solver dtype."""
        t = self.t_steps
        with span("tinyedm.solve"):
            return _heun(denoise_fn, x0, class_labels, self.torch_dtype, t, t[:-1], None, None)


def _scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float (exact in fp64)."""
    return torch.tensor(v, dtype=dtype).item()


def _branch(denoise_fn: DenoiseFn, sigma: float) -> DenoiseFn:
    """The function to run at a half-step whose sigma the host knows: an
    interval gate's branch, else ``denoise_fn`` itself."""
    return denoise_fn.branch(sigma) if isinstance(denoise_fn, IntervalGate) else denoise_fn


def _sigma_batch(sigma: float, b: int, device: torch.device) -> torch.Tensor:
    return torch.full((b,), sigma, dtype=torch.float32, device=device)


def churn_noise(
    shape: torch.Size, dtype: torch.dtype, generator: torch.Generator, device: torch.device
) -> torch.Tensor:
    """Standard normal churn noise in the solver dtype: the only draw of a
    stochastic solve (one per prediction half-step)."""
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)


def _heun(
    denoise_fn: DenoiseFn,
    x0: torch.Tensor,
    class_labels: Optional[Conditioning],
    dtype: torch.dtype,
    t: np.ndarray,
    t_hat: Sequence[float],
    churn: Optional[Sequence[float]],
    generator: Optional[torch.Generator],
    rows: Optional[tuple[int, int]] = None,
) -> torch.Tensor:
    """Heun steps from ``t_hat[i]`` to ``t[i+1]``: with ``churn``, first
    ``x += churn[i] * eps`` (EDM Algorithm 2), else ``t_hat = t[:-1]``
    (Algorithm 1). Every table value is rounded to ``dtype`` first; step
    widths are differences of those rounded values, taken in ``dtype``.
    ``rows`` = (first row, global batch): ``x0`` is those rows of a global
    batch, and ``eps`` those rows of the global batch's draw."""
    b = x0.shape[0]
    n = len(t) - 1
    x = x0.to(dtype) * _scalar(t[0], dtype)
    x_base = x
    dx_base = torch.zeros_like(x)
    for i in range(n):
        t0 = torch.tensor(t_hat[i], dtype=dtype)
        h = (torch.tensor(t[i + 1], dtype=dtype) - t0).item()
        if churn is not None:
            shape = x.shape if rows is None else torch.Size((rows[1], *x.shape[1:]))
            eps = churn_noise(shape, dtype, generator, x.device)
            if rows is not None:
                eps = eps[rows[0] : rows[0] + b]
            x = x + _scalar(churn[i], dtype) * eps
        # predict evaluates D at t_hat[i]; the correction (all but the last
        # step) at t[i+1]
        half_steps = [(t0.item(), True)]
        if i < n - 1:
            half_steps.append((_scalar(t[i + 1], dtype), False))
        for sigma, is_predict in half_steps:
            with span("tinyedm.solve.denoise"):
                d = _branch(denoise_fn, sigma)(x, _sigma_batch(sigma, b, x.device), class_labels).to(dtype)
            dx = (x - d) / sigma
            if is_predict:
                x_base, x = x, x + h * dx
            else:
                x = x_base + (h * 0.5) * (dx_base + dx)
                x_base = x
            dx_base = dx
    return x


@dataclasses.dataclass(frozen=True)
class MultistepSolver:
    """DPM-Solver++(2M) (Lu et al. 2022) in EDM's parameterization: one model
    forward per step. In log-sigma time (lambda = -ln sigma, h_i =
    lambda_{i+1} - lambda_i, r_i = h_{i-1} / h_i):

        D_hat_i = (1 + 1/(2 r_i)) D_i - 1/(2 r_i) D_{i-1}
        x_{i+1} = (sigma_{i+1} / sigma_i) x_i - expm1(-h_i) D_hat_i

    first order (D_hat = D) at step 0 and at the final step to sigma = 0,
    where ratio 0 and phi 1 make x = D exactly."""

    num_steps: int = 18
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    dtype: Optional[str] = None

    @property
    def torch_dtype(self) -> torch.dtype:
        return DeterministicSolver(dtype=self.dtype).torch_dtype

    @property
    def t_steps(self) -> np.ndarray:
        return karras_sigma_schedule(self.num_steps, self.sigma_min, self.sigma_max, self.rho)

    def tables(self) -> list[tuple[float, float, float, float, float]]:
        """Per step (sigma, ratio, phi, c1, c2), fp64, as the JAX solver
        builds them."""
        t = self.t_steps
        lam = -np.log(t[:-1])
        rows = []
        for i in range(self.num_steps):
            s_cur, s_next = t[i], t[i + 1]
            if s_next == 0.0:
                rows.append((s_cur, 0.0, 1.0, 1.0, 0.0))
                continue
            h = -np.log(s_next) - lam[i]
            c1, c2 = 1.0, 0.0
            if i > 0:
                r = (lam[i] - lam[i - 1]) / h
                c1, c2 = 1.0 + 1.0 / (2.0 * r), -1.0 / (2.0 * r)
            rows.append((s_cur, s_next / s_cur, -np.expm1(-h), c1, c2))
        return rows

    def solve(
        self,
        denoise_fn: DenoiseFn,
        x0: torch.Tensor,
        class_labels: Optional[Conditioning] = None,
    ) -> torch.Tensor:
        dtype = self.torch_dtype
        b = x0.shape[0]
        with span("tinyedm.solve"):
            x = x0.to(dtype) * _scalar(self.t_steps[0], dtype)
            d_prev = None
            for row in self.tables():
                sigma, ratio, phi, c1, c2 = (_scalar(v, dtype) for v in row)
                with span("tinyedm.solve.denoise"):
                    d = _branch(denoise_fn, sigma)(x, _sigma_batch(sigma, b, x.device), class_labels).to(dtype)
                d_hat = d if c2 == 0.0 else c1 * d + c2 * d_prev
                x = ratio * x + phi * d_hat
                d_prev = d
            return x


@dataclasses.dataclass(frozen=True)
class StochasticSolver:
    """EDM stochastic sampler (Karras et al. 2022, Algorithm 2): before each
    Heun step, t_hat = (1 + gamma) t_i with gamma = min(S_churn / N,
    sqrt(2) - 1) where S_min <= t_i <= S_max (else 0), and x += sqrt(t_hat^2 -
    t_i^2) * S_noise * eps. The noise comes from the generator given to
    ``solve``, one draw per prediction half-step; with S_churn = 0 it is
    ``DeterministicSolver`` exactly and draws nothing."""

    num_steps: int = 18
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    S_churn: float = 0.0
    S_min: float = 0.0
    S_max: float = float("inf")
    S_noise: float = 1.0
    dtype: Optional[str] = None

    @property
    def torch_dtype(self) -> torch.dtype:
        return DeterministicSolver(dtype=self.dtype).torch_dtype

    @property
    def t_steps(self) -> np.ndarray:
        return karras_sigma_schedule(self.num_steps, self.sigma_min, self.sigma_max, self.rho)

    @property
    def gamma(self) -> float:
        return min(self.S_churn / self.num_steps, math.sqrt(2.0) - 1.0) if self.S_churn > 0 else 0.0

    def tables(self) -> tuple[list[float], list[float]]:
        """(t_hat, churn) per step, fp64: the raised noise level and the
        scale of the noise that lifts x from t_i to it."""
        t_hat, churn = [], []
        for t_i in self.t_steps[:-1]:
            t_i = float(t_i)
            g = self.gamma if (self.S_min <= t_i <= self.S_max and t_i > 0) else 0.0
            t_hat.append(t_i * (1.0 + g))
            churn.append(math.sqrt(max(t_hat[-1] ** 2 - t_i**2, 0.0)) * self.S_noise)
        return t_hat, churn

    def solve(
        self,
        denoise_fn: DenoiseFn,
        x0: torch.Tensor,
        class_labels: Optional[Conditioning] = None,
        generator: Optional[torch.Generator] = None,
        rows: Optional[tuple[int, int]] = None,
    ) -> torch.Tensor:
        """As ``DeterministicSolver.solve``; ``generator`` (on the sample's
        device) draws the churn noise and is required when S_churn > 0.
        ``rows`` = (first row, global batch): ``x0`` is a rank's rows of a
        global batch, and each draw is the global batch's, of which it takes
        those rows, so that the samples do not depend on the world size."""
        if self.S_churn > 0 and generator is None:
            # a silent default generator would give every call and every
            # batch the same churn noise
            raise ValueError(
                "StochasticSolver with S_churn > 0 needs an explicit generator "
                "(solve(..., generator=torch.Generator(device).manual_seed(...)))"
            )
        with span("tinyedm.solve"):
            t_hat, churn = self.tables()
            return _heun(denoise_fn, x0, class_labels, self.torch_dtype, self.t_steps, t_hat,
                         churn if self.S_churn > 0 else None, generator, rows)
