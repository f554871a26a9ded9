"""Power-function EMA (Karras et al. 2023).

Counterpart of the tracking half of ``tinyedm_tpu/training/ema.py``:
  * sigma_rel -> gamma by the max real root of
    g^3 + 7g^2 + (16 - sr^-2) g + (12 - sr^-2) = 0
  * decay_t = (1 - 1/(t+1))^(gamma+1), in fp32
  * ema <- decay * ema + (1 - decay) * theta
  * updated every ``every_n_steps``, checked on the pre-increment step, so
    step 0 gives decay 0 and the EMA starts at theta.
EMA trees are dicts of tensors, updated in place. Post-hoc reconstruction
is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MAX_SIGMA_REL = 0.2886  # the reference's validation bound


def sigma_rel_to_gamma(sigma_rel: float) -> float:
    """Max real root of the cubic relating sigma_rel to the power-EMA exponent."""
    if not (0.0 < sigma_rel <= MAX_SIGMA_REL):
        raise ValueError(
            f"EMA length (sigma_rel) must be within (0, {MAX_SIGMA_REL}], got {sigma_rel}"
        )
    t = sigma_rel**-2
    roots = np.roots([1.0, 7.0, 16.0 - t, 12.0 - t])
    return float(roots.real.max())


def gamma_to_sigma_rel(gamma: float) -> float:
    """Inverse of sigma_rel_to_gamma: t = (g^3 + 7g^2 + 16g + 12) / (g + 1)."""
    g = float(gamma)
    t = (g**3 + 7 * g**2 + 16 * g + 12) / (g + 1)
    return float(1.0 / np.sqrt(t))


def power_ema_decay(step: int, gamma: float) -> float:
    """decay = (1 - 1/(step+1))^(gamma+1) in fp32; step is the pre-increment counter."""
    one = np.float32(1.0)
    s = np.float32(step)
    return float((one - one / (s + one)) ** (np.float32(gamma) + one))


@torch.no_grad()
def ema_update(ema_params: dict[str, torch.Tensor], params: dict[str, torch.Tensor],
               decay: float) -> None:
    """ema <- ema * decay + params * (1 - decay), in place, (1 - decay) in fp32."""
    keys = list(ema_params)
    ema = [ema_params[k] for k in keys]
    one_minus = float(np.float32(1.0) - np.float32(decay))
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul([params[k].to(ema_params[k].dtype) for k in keys],
                                                one_minus))


def maybe_ema_update(ema_params: dict[str, torch.Tensor], params: dict[str, torch.Tensor],
                     step: int, gamma: float, every_n_steps: int = 1) -> None:
    """The power-EMA update when ``step % every_n_steps == 0``, else nothing."""
    if every_n_steps <= 1 or step % every_n_steps == 0:
        ema_update(ema_params, params, power_ema_decay(step, gamma))


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    """One or more tracked EMA profiles."""

    sigma_rels: tuple[float, ...] = (0.13,)
    every_n_steps: int = 1

    @property
    def gammas(self) -> tuple[float, ...]:
        return tuple(sigma_rel_to_gamma(sr) for sr in self.sigma_rels)
